"""A conference bridge's live feeds on the card (needs a GPU):
``StreamingEncoderBank`` at the benchmark's ``aad-b4-s128-mono`` geometry
(1 channel, 4 bits, 128-byte blocks of 224 samples, 2 trials), ticks of
1,024 slots with ragged lengths (0, under a block, one to three blocks),
feeds that start and finish in one tick, and slots reused after a finish.

Each tick's bytes and offsets on the card must equal those of
``device="cpu"`` (the bank kernels' plain version), and every slot's feed
those of a ``StreamingEncoder`` on the card fed the same pushes. A tick is
one launch of kernel 3 (its bank mode) and one of kernel 4 (its bank
instance), whatever the number of feeds, and four operations on the card:
the upload, the two kernels, the copy down. Also a 2-channel mid/side bank,
and the card's refusal of a configuration without trials (the bank has the
paired schedule only). Imports no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_stream_encode_bank_gpu.py -q

Without a card every test here skips.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

import aad_tpu_torch
from aad_tpu_torch.ops import encode_pass, fused_encode
from test_torch_trace import program_spans, recorded

pytestmark = pytest.mark.gpu

MONO = aad_tpu_torch.EncodeConfig(num_channels=1, sampling_rate=16000, bits_per_sample=4, max_block_size=128,
                                  ch_process_method=0, num_encode_trials=2)
MS = aad_tpu_torch.EncodeConfig(num_channels=2, sampling_rate=48000, bits_per_sample=4, max_block_size=128,
                                ch_process_method=1, num_encode_trials=2)
PUSH = 320  # 20 ms at 16 kHz


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def ragged_ticks(slots: int, channels: int, ticks: int, nspb: int, seed: int):
    """``ticks`` ticks of ``slots`` slots: each slot's length drawn from 0,
    1 to nspb - 1, and 1 to 3 blocks' worth (up to 3 nspb + 17 samples), a
    sixth of the slots that push samples finishing each tick; noise under a
    slow tone."""
    rng = np.random.default_rng(seed)
    n = 3 * nspb + 17
    for _ in range(ticks):
        kind = rng.integers(0, 3, slots)
        lengths = np.where(kind == 0, 0, np.where(kind == 1, rng.integers(1, nspb, slots), rng.integers(nspb, n + 1,
                                                                                                        slots)))
        t = np.arange(n)
        tone = 9000 * np.sin(2 * np.pi * t / rng.integers(20, 400, (slots, channels, 1)))
        pcm = np.clip(tone + rng.normal(0, 1000, (slots, channels, n)), -32768, 32767).astype(np.int16)
        yield pcm, lengths, (rng.random(slots) < 1 / 6) & (lengths > 0)


def run_bank(cfg, device, ticks, written=False):
    """Each tick's (data, offsets) and the headers of the feeds it finished;
    ``written``, each tick's samples written into the bank's ``buffer``
    and that pushed, as the benchmark's bridge does."""
    bank = aad_tpu_torch.StreamingEncoderBank(cfg, ticks[0][0].shape[0], device=device)
    out = []
    for pcm, lengths, finish in ticks:
        if written:
            given, pcm = pcm, bank.buffer(pcm.shape[2])
            pcm[...] = given
        data, offsets = bank.push(pcm, lengths, finish)
        out.append((data.tobytes(), offsets.tolist(), [bank.header(s) for s in np.flatnonzero(finish)]))
    return out


def run_encoders(cfg, device, ticks):
    """The same ticks through a ``StreamingEncoder`` a slot: each tick's
    bytes a slot, and the headers of the feeds it finished."""
    S = ticks[0][0].shape[0]
    encs = [aad_tpu_torch.StreamingEncoder(cfg, device=device) for _ in range(S)]
    out = []
    for pcm, lengths, finish in ticks:
        parts, heads = [], []
        for s in range(S):
            data = encs[s].push(pcm[s, :, : lengths[s]]) if lengths[s] else b""
            if finish[s]:
                data += encs[s].finish()
                heads.append(encs[s].header())
                encs[s] = aad_tpu_torch.StreamingEncoder(cfg, device=device)
            parts.append(data)
        out.append((parts, heads))
    return out


@pytest.mark.parametrize("cfg", [MONO, MS], ids=["mono-1024", "ms-64"])
def test_bank_ticks_match_the_plain_version_and_the_encoders(cuda, cfg):
    S = 1024 if cfg is MONO else 64
    nspb = cfg.geometry().num_samples_per_block
    ticks = list(ragged_ticks(S, cfg.num_channels, 4, nspb, seed=2**31 + S))
    fused_encode.reset_launches()
    encode_pass.reset_launches()
    got = run_bank(cfg, cuda, ticks)
    assert fused_encode.launches[fused_encode.STREAM_KERNEL] == len(ticks)
    assert encode_pass.launches[encode_pass.PASS_KERNEL] == len(ticks)
    assert got == run_bank(cfg, "cpu", ticks)
    for (data, offsets, heads), (parts, want_heads) in zip(got, run_encoders(cfg, cuda, ticks)):
        assert [data[offsets[s]: offsets[s + 1]] for s in range(S)] == parts
        assert heads == want_heads


def test_bridge_ticks_one_launch_each(cuda):
    """The bridge's own ticks: 1,024 feeds of 1-3 s joining over the first
    ticks, 320 samples a tick, each finished and restarted at its end; each
    tick written into the bank's buffer, one launch of each kernel, and
    the feeds equal their encoders'."""
    rng = np.random.default_rng(2**31 + 5)
    S = 1024
    clips = [np.clip(rng.normal(0, 3000, (1, int(n))), -32768, 32767).astype(np.int16)
             for n in rng.integers(16000, 48000, S)]
    join = rng.integers(0, 50, S)
    pos = np.zeros(S, dtype=np.int64)
    ticks = []
    for t in range(60):
        pcm = np.zeros((S, 1, PUSH), dtype=np.int16)
        lengths, finish = np.zeros(S, dtype=np.int64), np.zeros(S, dtype=bool)
        for s in np.flatnonzero(join <= t):
            end = min(pos[s] + PUSH, clips[s].shape[1])
            lengths[s] = end - pos[s]
            pcm[s, :, : lengths[s]] = clips[s][:, pos[s]: end]
            finish[s] = end == clips[s].shape[1]
            pos[s] = 0 if finish[s] else end
        ticks.append((pcm, lengths, finish))
    fused_encode.reset_launches()
    encode_pass.reset_launches()
    got = run_bank(MONO, cuda, ticks, written=True)
    assert fused_encode.launches[fused_encode.STREAM_KERNEL] == len(ticks)
    assert encode_pass.launches[encode_pass.PASS_KERNEL] == len(ticks)
    for (data, offsets, _), (parts, _) in zip(got, run_encoders(MONO, cuda, ticks)):
        assert [data[offsets[s]: offsets[s + 1]] for s in range(S)] == parts


def test_a_tick_is_four_operations_on_the_card(cuda):
    nspb = MONO.geometry().num_samples_per_block
    ticks = list(ragged_ticks(256, 1, 3, nspb, seed=2**31 + 77))
    bank = aad_tpu_torch.StreamingEncoderBank(MONO, 256, device=cuda)
    bank.push(*ticks[0])
    torch.cuda.synchronize()
    _, prof, gained = recorded(lambda: [bank.push(*t) for t in ticks[1:]],
                               (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    on_card = [e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.name().startswith("aad.")]
    assert len(on_card) == 4 * 2, on_card
    assert sum("encode_stream_paired_kernel" in n for n in on_card) == 2
    assert sum("bank_encode_pass_kernel" in n for n in on_card) == 2
    names = [e.name() for e in program_spans(prof)]
    for span in ("aad.stream_encode.bank", "aad.bank.stage", "aad.h2d", "aad.bank.blocks", "aad.d2h",
                 "aad.bank.split"):
        assert names.count(span) == 2, (span, names)
    assert gained["k3_rows_written"] == gained["bank_blocks"] > 0
    assert gained["bank_feeds"] == sum(int(((n > 0) | f).sum()) for _, n, f in ticks[1:])
    assert gained["bank_finished"] == sum(int(f.sum()) for _, _, f in ticks[1:])


def test_the_card_refuses_a_bank_without_trials(cuda):
    cfg = aad_tpu_torch.EncodeConfig(num_channels=1, sampling_rate=16000, bits_per_sample=4, max_block_size=128,
                                     ch_process_method=0, num_encode_trials=0)
    bank = aad_tpu_torch.StreamingEncoderBank(cfg, 4, device=cuda)
    with pytest.raises(ValueError, match="paired schedule"):
        bank.push(np.zeros((4, 1, 300), dtype=np.int16), [300] * 4)
