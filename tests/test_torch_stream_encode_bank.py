"""A conference bridge's feeds on the CPU: ``StreamingEncoderBank`` fed
ticks of ragged pushes, at the geometry of the benchmark's
``aad-b4-s128-mono`` configuration (1 channel, 4 bits, 128-byte blocks of
224 samples, 2 trials) and at a small mid/side stereo one, so that the bank
is not mono-only.

Each tick below gives each slot a length (0, under a block, over two
blocks) and may finish its feed: feeds join and finish in one tick, a slot
starts a new feed after a finish, a feed ends shorter than a block, a finish
comes with no new samples; a tick may be written into the bank's own
upload (``buffer``). Every feed's bytes, tick by tick, must equal
those of a ``StreamingEncoder`` fed the same pushes; each finished feed,
under its file header, those of ``aad_tpu``'s scan ``encode`` of its
samples and, block by block from the state the stream carries in, of the
benchmark's plain reference encoder (``bench_torch/reference/aad.py``,
imported from its path). Under a CPU ``torch.profiler`` a tick records its
documented spans and counters; with no profiler nothing is recorded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import aad_tpu
import aad_tpu_torch
from aad_tpu.codec.encoder import EncodeConfig as JaxEncodeConfig
from aad_tpu_torch.utils import trace
from test_torch_stream_encode_gpu import _reference
from test_torch_trace import parent_of, program_spans, recorded

R = _reference()
MONO = aad_tpu_torch.EncodeConfig(num_channels=1, sampling_rate=16000, bits_per_sample=4, max_block_size=128,
                                  ch_process_method=0, num_encode_trials=2)
MS = aad_tpu_torch.EncodeConfig(num_channels=2, sampling_rate=48000, bits_per_sample=4, max_block_size=64,
                                ch_process_method=1, num_encode_trials=2)

# a tick: (samples, finish) a slot
TICKS = {
    "mono": (MONO, [
        [(0, False), (100, False), (150, True), (500, False)],  # no feed yet; under a block; joins and ends; > 2 blocks
        [(230, False), (60, True), (300, False), (0, False)],   # joins; a feed shorter than a block; a new feed; 0
        [(500, False), (0, False), (224, False), (10, True)],   # ...; no feed; a whole block; ends on a tail
        [(0, True), (224, False), (100, True), (300, False)],   # ends with nothing new; a new feed; ends; a new feed
        [(0, False), (0, True), (0, False), (0, True)],         # ends on a block boundary: nothing left; ends
    ]),
    "ms": (MS, [
        [(7, False), (40, True), (0, False)],
        [(90, False), (30, False), (3, True)],
        [(0, True), (45, True), (0, False)],
    ]),
}


def _pcm(n: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    common = 20_000 * np.sin(t / rng.uniform(4.0, 40.0))
    chans = [common + rng.normal(0, 3_000, n), 0.7 * common + 4_000 * np.sin(t / 7.0) + rng.normal(0, 3_000, n)]
    return np.clip(np.stack(chans[:channels]), -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module", params=sorted(TICKS))
def bridge(request):
    """The case's ticks through one bank with no profiler, every span made
    noted: (config, each tick's (pcm, lengths, finish), each tick's bytes a
    slot, each finished feed as (slot, PCM, header), the spans made, the
    counters changed)."""
    cfg, ticks = TICKS[request.param]
    C = cfg.num_channels
    S = len(ticks[0])
    width = max(n for tick in ticks for n, _ in tick) or 1
    inputs = []
    for k, tick in enumerate(ticks):
        pcm = np.stack([_pcm(width, C, seed=2**31 + 101 * k + s) for s in range(S)])
        inputs.append((pcm, np.array([n for n, _ in tick]), np.array([f for _, f in tick])))
    made, before = [], dict(trace.counts)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(trace, "_RecordFunctionFast", lambda name: made.append(name))
        outs, feeds = _run(cfg, inputs)
    changed = {k for k in set(trace.counts) | set(before) if trace.counts.get(k) != before.get(k)}
    return cfg, inputs, outs, feeds, made, changed


def _run(cfg, inputs):
    """(each tick's bytes a slot, each finished feed as (slot, PCM, header))."""
    S = inputs[0][0].shape[0]
    bank = aad_tpu_torch.StreamingEncoderBank(cfg, S, device="cpu")
    fed = [[] for _ in range(S)]
    outs, feeds = [], []
    for pcm, lengths, finish in inputs:
        data, offsets = bank.push(pcm, lengths, finish)
        assert offsets.shape == (S + 1,) and offsets[0] == 0 and offsets[-1] == len(data)
        outs.append([data[offsets[s]: offsets[s + 1]].tobytes() for s in range(S)])
        for s in range(S):
            fed[s].append(pcm[s, :, : lengths[s]])
            if finish[s]:
                feeds.append((s, np.concatenate(fed[s], axis=1), bank.header(s)))
                fed[s] = []
    return outs, feeds


def test_feeds_equal_one_streaming_encoder_each(bridge):
    cfg, inputs, outs, *_ = bridge
    S = inputs[0][0].shape[0]
    encs = [aad_tpu_torch.StreamingEncoder(cfg, device="cpu") for _ in range(S)]
    for (pcm, lengths, finish), got in zip(inputs, outs):
        want = []
        for s in range(S):
            data = encs[s].push(pcm[s, :, : lengths[s]]) if lengths[s] else b""
            if finish[s]:
                data += encs[s].finish()
                encs[s] = aad_tpu_torch.StreamingEncoder(cfg, device="cpu")
            want.append(data)
        assert got == want


def _finished(inputs, outs, feeds) -> list[tuple[np.ndarray, bytes]]:
    """Each finished feed's (PCM, file header + bytes): its slot's bytes
    from the tick after its previous finish to its own."""
    since = {}
    for (_, _, finish), tick in zip(inputs, outs):
        for s, data in enumerate(tick):
            since.setdefault(s, [b""])[-1] += data
            if finish[s]:
                since[s].append(b"")
    taken = {s: 0 for s in since}
    out = []
    for s, pcm, header in feeds:
        out.append((pcm, header + since[s][taken[s]]))
        taken[s] += 1
    return out


def test_finished_feeds_equal_the_scan_encode(bridge):
    cfg, inputs, outs, feeds, *_ = bridge
    jcfg = JaxEncodeConfig(**dataclasses.asdict(cfg))
    done = _finished(inputs, outs, feeds)
    assert len(done) == sum(int(f.sum()) for _, _, f in inputs)
    for pcm, data in done:
        assert data == aad_tpu.encode(pcm.astype(np.int32), jcfg, engine="scan")


def test_finished_feeds_pass_the_plain_reference(bridge):
    cfg, inputs, outs, feeds, *_ = bridge
    done = _finished(inputs, outs, feeds)
    items = [dict(pcm=torch.from_numpy(pcm), data=data, rate=cfg.sampling_rate) for pcm, data in done]
    geo = R.Geometry(cfg.num_channels, cfg.bits_per_sample, cfg.max_block_size)
    got = R.check_encoded(items, geo, cfg.ch_process_method == 1, cfg.num_encode_trials, "cpu")
    assert got == {"bad_blocks": 0, "blocks": sum(geo.blocks(pcm.shape[1]) for pcm, _ in done)}


def test_each_tick_returns_its_whole_blocks(bridge):
    """A slot's bytes of a tick are the blocks its samples complete; a
    finish adds its feed's tail, cut to the units its samples fill."""
    cfg, inputs, outs, *_ = bridge
    geo = cfg.geometry()
    nspb = geo.num_samples_per_block
    rest = np.zeros(len(outs[0]), dtype=np.int64)
    for (_, lengths, finish), got in zip(inputs, outs):
        total = rest + lengths
        whole = total // nspb
        tail = np.where(finish, total - whole * nspb, 0)
        ref = R.Geometry(cfg.num_channels, cfg.bits_per_sample, cfg.max_block_size)
        want = [int(whole[s]) * geo.block_size + (ref.wire_bytes(int(tail[s])) if tail[s] else 0)
                for s in range(len(got))]
        assert [len(g) for g in got] == want
        rest = np.where(finish, 0, total - whole * nspb)


def test_a_slot_starts_a_new_feed_after_a_finish(bridge):
    """A slot's next feed starts from no carry: its first tick's bytes equal
    a new bank's for the same samples."""
    cfg, inputs, outs, *_ = bridge
    S = inputs[0][0].shape[0]
    for k in range(1, len(inputs)):
        for s in np.flatnonzero(inputs[k - 1][2] & (inputs[k][1] > 0)):
            pcm, lengths, finish = inputs[k]
            fresh = aad_tpu_torch.StreamingEncoderBank(cfg, S, device="cpu")
            only = np.where(np.arange(S) == s, lengths, 0)
            data, offsets = fresh.push(pcm, only, finish & (np.arange(S) == s))
            assert data[offsets[s]: offsets[s + 1]].tobytes() == outs[k][s]


def _expected(cfg, inputs) -> dict:
    """What the ticks should count: blocks, feeds started with no carry,
    idle pushes, and the ticks that encode a block (and so copy)."""
    nspb = cfg.geometry().num_samples_per_block
    S = inputs[0][0].shape[0]
    rest, done = np.zeros(S, dtype=np.int64), np.zeros(S, dtype=np.int64)
    out = dict(blocks=0, started=0, idle=0, copying=0)
    for _, n, f in inputs:
        total = rest + n
        blocks = np.where(f, -(-total // nspb), total // nspb)
        out["blocks"] += int(blocks.sum())
        out["started"] += int(((blocks > 0) & (done == 0)).sum())
        out["idle"] += int((((n > 0) | f) & (blocks == 0)).sum())
        out["copying"] += int((blocks > 0).any())
        done = np.where(f, 0, done + blocks)
        rest = np.where(f, 0, total - blocks * nspb)
    return out


def test_a_tick_records_its_spans_and_counters(bridge):
    cfg, inputs, outs, *_ = bridge
    (got, _), prof, gained = recorded(lambda: _run(cfg, inputs))
    assert got == outs
    spans = program_spans(prof)
    named = [(e.name(), parent_of(e, spans)) for e in spans]
    want = _expected(cfg, inputs)
    ticks = len(inputs)
    for span, times in (("aad.bank.stage", ticks), ("aad.h2d", want["copying"]), ("aad.bank.blocks", want["copying"]),
                        ("aad.d2h", want["copying"]), ("aad.bank.split", ticks)):
        assert named.count((span, "aad.stream_encode.bank")) == times, span
    assert named.count(("aad.stream_encode.bank", None)) == ticks
    assert len(named) == 3 * ticks + 3 * want["copying"]
    assert gained["bank_feeds"] == sum(int(((n > 0) | f).sum()) for _, n, f in inputs)
    assert gained["bank_finished"] == sum(int(f.sum()) for _, _, f in inputs)
    assert gained["bank_blocks"] == want["blocks"]
    assert gained["bank_started"] == want["started"]
    assert gained.get("bank_idle_feeds", 0) == want["idle"]
    assert gained["d2h_bytes"] == sum(len(b"".join(tick)) for tick in outs)  # the payloads alone come down
    assert not {"k3_rows_written", "k3_rows_ms"} & set(gained)  # kernel 3 counts them where it launches


def test_nothing_records_without_a_profiler(bridge):
    *_, made, changed = bridge
    assert made == [] and changed == set()


def test_ticks_of_other_widths_keep_the_remainders():
    """A tick wider or narrower than the one before (the bank's upload is
    made anew) carries every slot's remainder over."""
    cfg = dataclasses.replace(MONO, max_block_size=48)  # 64 samples a block
    bank = aad_tpu_torch.StreamingEncoderBank(cfg, 3, device="cpu")
    encs = [aad_tpu_torch.StreamingEncoder(cfg, device="cpu") for _ in range(3)]
    for k, (width, lengths) in enumerate([(50, [50, 20, 0]), (130, [130, 0, 70]), (20, [20, 20, 20])]):
        pcm = np.stack([_pcm(width, 1, seed=2**31 + 7 * k + s) for s in range(3)])
        data, offsets = bank.push(pcm, lengths)
        want = [encs[s].push(pcm[s, :, : lengths[s]]) if lengths[s] else b"" for s in range(3)]
        assert [data[offsets[s]: offsets[s + 1]].tobytes() for s in range(3)] == want


def test_a_tick_written_into_the_bank_s_buffer_is_pushed_without_a_copy(bridge):
    """Ticks written into :meth:`buffer` and pushed give the bytes of the
    same ticks pushed as arrays of their own; a buffer asked for at another
    width and then not pushed changes nothing."""
    cfg, inputs, outs, *_ = bridge
    S = inputs[0][0].shape[0]
    bank = aad_tpu_torch.StreamingEncoderBank(cfg, S, device="cpu")
    for k, ((pcm, lengths, finish), want) in enumerate(zip(inputs, outs)):
        if k % 2:
            bank.buffer(pcm.shape[2] + 3)[...] = 1
            data, offsets = bank.push(pcm, lengths, finish)
        else:
            buf = bank.buffer(pcm.shape[2])
            assert buf.shape == pcm.shape and buf.dtype == np.int16
            buf[...] = pcm
            data, offsets = bank.push(buf, lengths, finish)
        assert [data[offsets[s]: offsets[s + 1]].tobytes() for s in range(S)] == want


def test_a_bank_refuses_what_it_cannot_encode():
    bank = aad_tpu_torch.StreamingEncoderBank(MONO, 3, device="cpu")
    pcm = np.zeros((3, 1, 50), dtype=np.int16)
    with pytest.raises(aad_tpu_torch.InvalidArgumentError):
        bank.push(pcm[:2], [1, 1])
    with pytest.raises(aad_tpu_torch.InvalidArgumentError):
        bank.push(pcm, [1, 51, 0])
    with pytest.raises(aad_tpu_torch.InvalidArgumentError):
        bank.push(pcm, [1, 1])
    with pytest.raises(aad_tpu_torch.InvalidArgumentError):
        bank.header(0)  # no feed finished yet
    with pytest.raises(aad_tpu_torch.InvalidFormatError):
        bank.push(np.full((3, 1, 5), 40_000, dtype=np.int32), [5, 5, 5])
    with pytest.raises(aad_tpu_torch.InvalidArgumentError):
        aad_tpu_torch.StreamingEncoderBank(MONO, 0, device="cpu")
