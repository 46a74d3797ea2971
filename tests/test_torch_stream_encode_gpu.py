"""A live stereo sender on the card (needs a GPU): ``StreamingEncoder`` fed
20-ms pushes at the benchmark's ``aad-b4-s128-ms-stereo`` geometry (2
channels, 4 bits, 128-byte blocks of 96 samples a channel, mid/side, 2
trials; 960 samples a channel a push, 10 blocks), three feeds pushed in
turn, as the cell ``b4s128ms-live-encode`` pushes them.

Each feed's bytes on the card must equal those of ``device="cpu"`` (the
kernels' plain versions) and, block by block from the state the stream
carries in, the benchmark's plain reference encoder
(``bench_torch/reference/aad.py``, imported from its path). Each whole
push makes one launch of kernel 3 (``aad_encode_stream``, its wire mode)
and one of kernel 4 (``aad_encode_pass``, the carry), both inside
``aad.stream_encode.blocks``, and puts four operations on the card: the
upload, the two kernels, the copy down.

Kernel 3's wire mode (``ops.fused_encode.encode_wire``) is also held
against its plain version over every configuration ``StreamingEncoder``
takes, at small blocks (``WIRE_GRID``: mono, L/R and mid/side; 2, 3 and 4
bits; trials 0, 1 and 2, and 8; PCM at the int16 limits in both channels;
pushes shorter than a block and of whole blocks, a first push without a
carry, then carried ones, finishes of a 1- and an (nspb - 1)-sample tail);
and, where a block is too long for the paired schedule's staged or any
paired CTA, against kernel 3's other mode composed as before the wire mode
(``_pad_to_blocks``, ``lr_to_ms``, ``encode_stream``, ``_block_bytes`` on
the card). Imports no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_stream_encode_gpu.py -q

Without a card every test here skips.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

import aad_tpu_torch
from aad_tpu_torch.codec.encoder import payload_size
from aad_tpu_torch.constants import block_header_size
from aad_tpu_torch.ops import encode_pass, fused_encode
from aad_tpu_torch.ops.encode import lr_to_ms
from test_torch_trace import parent_of, program_spans, recorded

pytestmark = pytest.mark.gpu

REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "bench_torch" / "reference" / "aad.py"
CFG = aad_tpu_torch.EncodeConfig(num_channels=2, sampling_rate=48000, bits_per_sample=4, max_block_size=128,
                                 ch_process_method=1, num_encode_trials=2)
NSPB = CFG.geometry().num_samples_per_block
PUSH = 960
LENGTHS = [2 * PUSH + 2 * NSPB + 58, PUSH + 50, PUSH]  # ends mid-block; an idle last push; ends on a push

# Every configuration StreamingEncoder takes, at blocks of 16 data bytes (20-68 samples a channel):
# (channels, mid/side) by name, bits, trials.
MODES = {"mono": (1, 0), "lr": (2, 0), "ms": (2, 1)}
WIRE_GRID = [(m, b, t) for m in MODES for b in (2, 3, 4) for t in (0, 1, 2)] + [("ms", 4, 8), ("mono", 2, 8)]
TAILS = {"tail 1": lambda nspb: 1, "tail nspb - 1": lambda nspb: nspb - 1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _reference():
    spec = importlib.util.spec_from_file_location("aad_reference", REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pcm(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    common = 26_000 * np.sin(t / rng.uniform(4.0, 40.0))
    left = common + rng.normal(0, 3_000, n)
    right = 0.8 * common + 4_000 * np.sin(t / 7.0) + rng.normal(0, 3_000, n)
    return np.clip(np.stack([left, right]), -32768, 32767).astype(np.int16)


def expected_trace(n: int, card: bool = False):
    """The spans (name, parent's name) and counters of pushing n samples a
    channel 960 at a time at CFG's geometry, then finishing; with ``card``,
    kernel 3's counters too (it counts only where it launches)."""
    push, finish = "aad.stream_encode.push", "aad.stream_encode.finish"
    spans, counts = [], {"stream_encode_blocks": -(-n // NSPB), "h2d_bytes": 2 * 2 * n}
    done = carried = idle = out = 0
    for off in range(0, n, PUSH):
        spans += [(push, None), ("aad.push.buffer", push)]
        whole = min(off + PUSH, n) // NSPB
        if whole == done:
            idle += 1
            continue
        spans += [("aad.h2d", push), ("aad.stream_encode.blocks", push), ("aad.d2h", push)]
        carried += 1
        out += (whole - done) * 128
        done = whole
    spans += [(finish, None), ("aad.push.buffer", finish)]
    if n > done * NSPB:
        spans += [("aad.h2d", finish), ("aad.stream_encode.blocks", finish), ("aad.d2h", finish)]
        carried += 1
        out += _wire_bytes(n - done * NSPB)
    counts.update(stream_encode_carried=carried, stream_encode_idle_pushes=idle, d2h_bytes=out)
    if card:  # CFG is mid/side: every block written is combined
        counts.update(k3_rows_written=counts["stream_encode_blocks"], k3_rows_ms=counts["stream_encode_blocks"])
    return spans, {k: v for k, v in counts.items() if v}


def _wire_bytes(tail: int) -> int:
    """Bytes of a last block of ``tail`` samples a channel at CFG's geometry."""
    return payload_size(CFG.geometry(), tail)


def wire_config(mode: str, bits: int, trials: int, data_bytes: int = 16) -> aad_tpu_torch.EncodeConfig:
    C, ms = MODES[mode]
    return aad_tpu_torch.EncodeConfig(num_channels=C, sampling_rate=16000, bits_per_sample=bits,
                                      max_block_size=block_header_size(C) + data_bytes, ch_process_method=ms,
                                      num_encode_trials=trials)


def wire_pcm(C: int, n: int, seed: int) -> np.ndarray:
    """(C, n) int16 of ``_pcm``'s kind, with runs at the int16 limits: both
    channels at 32767, both at -32768, and each against the other, so that
    L + R and L - R leave the int16 range before the halving."""
    pcm = _pcm(n, seed)[:C].copy()
    runs = [(32767, 32767), (-32768, -32768), (32767, -32768), (-32768, 32767)]
    for k, (a, b) in enumerate(runs):
        at = (7 + 11 * k) % max(n - 6, 1)
        pcm[0, at: at + 6] = a
        if C == 2:
            pcm[1, at: at + 6] = b
    return pcm


def wire_pushes(nspb: int, tail: int) -> list[int]:
    """Samples a channel of each push of a stream of 3 blocks and ``tail``
    samples: shorter than a block (nothing encoded), up to 2 whole blocks (the
    first blocks, no carry), a block and the tail (one block, carried); then
    the finish encodes the tail."""
    return [nspb // 2, 2 * nspb - nspb // 2, nspb + tail]


def wire_pushed(cfg, pcm: np.ndarray, pushes: list[int], device) -> tuple[list[bytes], bytes, list]:
    """Push ``pcm`` in ``pushes``, then finish: (each call's bytes, the
    header, the launches (kernel 3, kernel 4) of each call that encoded)."""
    enc = aad_tpu_torch.StreamingEncoder(cfg, device=device)
    outs, made, off = [], [], 0
    for n in pushes + [None]:
        before = _launches()
        outs.append(enc.push(pcm[:, off: off + n]) if n is not None else enc.finish())
        off += n or 0
        if outs[-1]:
            made.append(tuple(a - b for a, b in zip(_launches(), before)))
    return outs, enc.header(), made


def composed(cfg, pcm: torch.Tensor, carry=None, blocks_before: int = 0):
    """Blocks of ``pcm`` as kernel 3's other mode made them before the wire
    mode: padded, mid/side, encoded with ``encode_stream``, framed; (the
    payload bytes, the carry)."""
    geo = cfg.geometry()
    n = pcm.shape[1]
    blocks, valid = fused_encode._pad_to_blocks(pcm, geo, 0, -(-n // geo.num_samples_per_block))
    if cfg.ch_process_method == 1:
        blocks = lr_to_ms(blocks).to(torch.int16)
    headers, data, carry = fused_encode.encode_stream(blocks, valid, cfg.bits_per_sample, cfg.num_encode_trials,
                                                     carry=carry, blocks_before=blocks_before, pack=geo)
    rows = fused_encode._block_bytes(headers, data, geo)
    return rows.reshape(-1)[: payload_size(geo, n)].cpu().numpy().tobytes(), carry


def _launches() -> tuple[int, int]:
    return fused_encode.launches[fused_encode.STREAM_KERNEL], encode_pass.launches[encode_pass.PASS_KERNEL]


def _in_turns(feeds: list, device):
    """Push the feeds 960 samples at a time, in turn, each finished after its
    last push: (each feed's file, the launches (kernel 3, kernel 4) of each
    whole push)."""
    encs = [aad_tpu_torch.StreamingEncoder(CFG, device=device) for _ in feeds]
    outs = [[] for _ in feeds]
    whole = []
    for off in range(0, max(f.shape[1] for f in feeds), PUSH):
        for k, f in enumerate(feeds):
            if off >= f.shape[1]:
                continue
            before = _launches()
            outs[k].append(encs[k].push(f[:, off: off + PUSH]))
            if off + PUSH <= f.shape[1]:
                whole.append(tuple(a - b for a, b in zip(_launches(), before)))
            if off + PUSH >= f.shape[1]:
                outs[k].append(encs[k].finish())
    return [e.header() + b"".join(o) for e, o in zip(encs, outs)], whole


def test_pushes_on_the_card_equal_the_cpu_and_the_reference(cuda):
    feeds = [_pcm(n, seed=2**31 + n) for n in LENGTHS]
    got, whole = _in_turns(feeds, cuda)
    want, _ = _in_turns(feeds, "cpu")  # the plain versions launch nothing
    assert got == want
    R = _reference()
    items = [dict(pcm=torch.from_numpy(f), data=d, rate=48000) for f, d in zip(feeds, got)]
    assert R.check_encoded(items, R.Geometry(2, 4, 128), True, 2, cuda)["bad_blocks"] == 0
    assert len(whole) == sum(n // PUSH for n in LENGTHS) and set(whole) == {(1, 1)}


def test_a_push_marks_its_launches_inside_its_blocks(cuda):
    pcm = _pcm(2 * PUSH, seed=7)
    enc = aad_tpu_torch.StreamingEncoder(CFG, device=cuda)
    enc.push(pcm[:, :PUSH])  # builds and warms; the carry for the next push
    torch.cuda.synchronize()
    data, prof, gained = recorded(lambda: enc.push(pcm[:, PUSH:]), (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    spans = program_spans(prof)
    push, blocks = "aad.stream_encode.push", "aad.stream_encode.blocks"
    assert [(e.name(), parent_of(e, spans)) for e in spans] == [
        (push, None), ("aad.push.buffer", push), ("aad.h2d", push), (blocks, push),
        ("aad.launch.encode_stream", blocks), ("aad.launch.encode_pass", blocks), ("aad.d2h", push)]
    assert gained == {"stream_encode_blocks": 10, "stream_encode_carried": 1, "h2d_bytes": 2 * 2 * PUSH,
                      "d2h_bytes": 10 * 128, "k3_rows_written": 10, "k3_rows_ms": 10}
    assert len(data) == 10 * 128
    # the upload, kernel 3, kernel 4, the copy down
    on_card = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.name().startswith("aad.")]
    assert len(on_card) == 4, [e.name() for e in on_card]
    assert sum("encode_stream_paired_kernel" in e.name() for e in on_card) == 1


@pytest.mark.parametrize("n", LENGTHS)
def test_a_feed_on_the_card_records_its_spans_and_counters(cuda, n):
    """The live test's spans (less the launches, which only a card makes)
    and counters, kernel 3's among them."""
    pcm = _pcm(n, seed=2**31 + n)

    def feed():
        enc = aad_tpu_torch.StreamingEncoder(CFG, device=cuda)
        return [enc.push(pcm[:, off: off + PUSH]) for off in range(0, n, PUSH)] + [enc.finish()]

    want = feed()  # builds and warms
    got, prof, gained = recorded(feed)
    spans = program_spans(prof)
    assert got == want
    want_spans, want_counts = expected_trace(n, card=True)
    assert [(e.name(), parent_of(e, spans)) for e in spans if not e.name().startswith("aad.launch.")] == want_spans
    assert gained == want_counts


@pytest.mark.parametrize("tail", sorted(TAILS))
@pytest.mark.parametrize("mode,bits,trials", WIRE_GRID)
def test_wire_pushes_equal_the_plain_version(cuda, mode, bits, trials, tail):
    """Every call's bytes on the card equal the CPU's, one launch of each
    kernel a call that encodes."""
    cfg = wire_config(mode, bits, trials)
    nspb = cfg.geometry().num_samples_per_block
    pushes = wire_pushes(nspb, TAILS[tail](nspb))
    pcm = wire_pcm(cfg.num_channels, sum(pushes), seed=bits * 100 + trials)
    got = wire_pushed(cfg, pcm, pushes, cuda)
    want = wire_pushed(cfg, pcm, pushes, "cpu")
    assert got[:2] == want[:2]
    assert got[2] == [(1, 1)] * 3


@pytest.mark.parametrize("mode,bits,trials", WIRE_GRID)
def test_wire_blocks_with_a_short_last_block_equal_the_plain_version(cuda, mode, bits, trials):
    """encode_wire's own contract, beyond StreamingEncoder's calls: two
    calls, the second of 2 blocks and 5 samples, carried; rows and carry
    against the plain version."""
    cfg = wire_config(mode, bits, trials)
    geo = cfg.geometry()
    nspb = geo.num_samples_per_block
    pcm = torch.from_numpy(wire_pcm(cfg.num_channels, 3 * nspb + 5, seed=17))
    ms = bool(cfg.ch_process_method)

    def two_calls(device):
        x = pcm.to(device)
        first, carry = fused_encode.encode_wire(x[:, :nspb].contiguous(), geo, trials, mid_side=ms)
        rest, _ = fused_encode.encode_wire(x[:, nspb:].contiguous(), geo, trials, mid_side=ms, carry=carry,
                                           blocks_before=1)
        return torch.cat([first, rest]).cpu()

    assert torch.equal(two_calls(cuda), two_calls("cpu"))


@pytest.mark.parametrize("data_bytes", [5000, 23600], ids=["paired-unstaged", "serial"])
def test_wire_blocks_too_long_to_stage_equal_the_other_mode(cuda, data_bytes):
    """Mid/side 4-bit blocks of 5,004 samples (the paired schedule, its
    samples read from device memory) and of 23,604 (too long for a paired
    CTA: the serial schedule, warming on the previous block): a first push
    of a block and a half, a carried one, the finish; each call's bytes
    against the composition of kernel 3's other mode on the card."""
    cfg = wire_config("ms", 4, 2, data_bytes)
    nspb = cfg.geometry().num_samples_per_block
    pushes = [nspb + nspb // 2, nspb, nspb // 3]
    pcm = wire_pcm(2, sum(pushes), seed=data_bytes)
    got, _, made = wire_pushed(cfg, pcm, pushes, cuda)
    x = torch.from_numpy(pcm).to(cuda)
    first, carry = composed(cfg, x[:, :nspb])
    second, carry = composed(cfg, x[:, nspb: 2 * nspb], carry, 1)
    tail, _ = composed(cfg, x[:, 2 * nspb:], carry, 2)
    assert got == [first, second, b"", tail]  # the third push completes no block
    assert made == [(1, 1)] * 3

