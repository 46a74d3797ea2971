"""The CUDA kernels against their plain torch versions, bit for bit, and the
entry points that drive them on the card against the CPU (needs a GPU).

Imports no jax, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py -q

(``--noconftest`` because ``tests/conftest.py`` imports jax). Without a
card every test here skips.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import aad_tpu_torch
from aad_tpu_torch.format.framing import BlockStates, assemble_stream, build_block_headers
from aad_tpu_torch.format.geometry import compute_block_geometry, num_blocks_for
from aad_tpu_torch.ops import encode_pass, fused_decode, fused_encode, lms
from aad_tpu_torch.ops.decode import compute_qdiffs_prefix
from aad_tpu_torch.ops.transitions import CodecState
from aad_tpu_torch.tables import STEPSIZE_TABLE

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


# Shapes around the kernels' staging: 64-lane CTAs and 64-position row tiles
# (csrc/codec.cuh). T + 4 odd (2-byte rows) and not a multiple of 8, T not a
# multiple of 64 and T = 1, lane counts that are not multiples of 64.
EDGE_SHAPES = [(1, 1, 1), (33, 2, 1), (70, 1, 21), (65, 2, 61), (129, 1, 124), (31, 2, 125), (64, 1, 128)]


def _int32_wide(rng, L):
    """(L, 4) int32 over all of int32 on half the rows, else as the benchmark draws them."""
    a = rng.integers(-(2**31), 2**31 - 1, (L, 4), endpoint=True).astype(np.int32)
    a[::2] = rng.integers(-32768, 32768, a[::2].shape)
    return a


def _lanes(seed, B, C, T, bps):
    """(B * C, T) codes one a byte and channel-major lane states: step
    indices 0, 4080 and 4081-4095 (the parse clamp), histories and weights
    over int32."""
    rng = np.random.default_rng(seed)
    L = B * C
    codes = rng.integers(0, 2**bps, (L, T), dtype=np.uint8)
    si = rng.integers(0, 4096, (L,)).astype(np.int32)
    si[: min(17, L)] = [0, 4080, *range(4081, 4096)][: min(17, L)]
    hi = _int32_wide(rng, L)
    wt = _int32_wide(rng, L)
    wt[1::4] = rng.integers(-20000, 20000, wt[1::4].shape)
    return [torch.from_numpy(a) for a in (codes, si, hi, wt)]


def _rows_geometry(C, T, bps):
    """The geometry of blocks of C channels with at least T codes, whole units."""
    geo = compute_block_geometry(1024, C, bps)
    units = -(-T // geo.samples_per_unit)
    return compute_block_geometry(geo.header_bytes + units * geo.unit_bytes, C, bps)


LAYOUTS = {"mono": (1, False), "lr": (2, False), "ms": (2, True)}  # channels, mid/side


def _random_rows(seed, B, geo, skew=0, device="cpu"):
    """(B, block_size) random bytes on ``device``, as a view ``skew`` bytes
    past a 4-byte boundary: random block headers (wire step indices 0-4095,
    the malformed 4081-4095 among them, any weight shift) and codes."""
    raw = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, B * geo.block_size + skew, dtype=np.uint8))
    rows = raw[skew:].view(B, geo.block_size)
    for i, idx in enumerate(range(4080, 4096)):  # the first lanes' tags: the table's top and the parse clamp
        b, c = divmod(i, geo.num_channels)
        if b < B:
            rows[b, 18 * c : 18 * c + 2] = torch.tensor([idx >> 4, ((idx & 0xF) << 4) | (i & 0xF)])
    return raw.to(device)[skew:].view(B, geo.block_size)


def test_stepsize_probe_equals_table(cuda):
    got = fused_decode.stepsize_probe(cuda)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), STEPSIZE_TABLE)
    assert fused_decode.stepsize_corrections(cuda) == ()


def _rows_equal_plain(rows, geo, ms, n_codes=None):
    """One launch of kernel 1 on ``rows`` (on the card), equal to the plain
    version on the same bytes."""
    want = fused_decode.decode_rows_reference(rows.cpu(), geo, ms)
    before = fused_decode.launches[fused_decode.DECODE_KERNEL]
    got = fused_decode.decode_rows(rows, geo, ms)
    torch.cuda.synchronize()
    assert fused_decode.launches[fused_decode.DECODE_KERNEL] == before + 1
    assert got.dtype == torch.int16 and got.shape == (rows.shape[0] * geo.num_channels, geo.codes_per_block + 4)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("B,C,T", [(500, 2, 300), (257, 1, 988), *EDGE_SHAPES])
def test_decode_lanes_kernel_matches_plain(cuda, bps, B, C, T):
    """Block rows, the codes packed in their data regions (B blocks of C
    channels, the fewest whole units that hold T codes), the states parsed
    from their headers, as L/R and, in stereo, as mid/side; and (B * C, T)
    codes one a byte with the states given: one launch each, equal to the
    plain version."""
    codes, si, hi, wt = _lanes(bps * 7 + B * C + T, B, C, T, bps)
    geo = _rows_geometry(C, T, bps)
    rows = _random_rows(bps + B + T, B, geo, device=cuda)
    for ms in (False, True) if C == 2 else (False,):
        _rows_equal_plain(rows, geo, ms)
    want = fused_decode.decode_lanes_reference(codes, si, hi, wt, bps)
    before = fused_decode.launches[fused_decode.DECODE_KERNEL]
    got = fused_decode.decode_lanes(codes.to(cuda), si.to(cuda), hi.to(cuda), wt.to(cuda), bps)
    torch.cuda.synchronize()
    assert fused_decode.launches[fused_decode.DECODE_KERNEL] == before + 1
    assert got.dtype == torch.int16 and got.shape == (B * C, T + 4)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("skew", [1, 2, 3])
@pytest.mark.parametrize("C", [1, 2])
def test_decode_lanes_kernel_takes_unaligned_codes(cuda, skew, C):
    """Block rows whose first byte is off a 4-byte boundary, at 4 bits: a mono
    data region starts 18 bytes into its block, off a boundary itself, and a
    3-bit mono block is 1,023 bytes, so block after block lies off one."""
    for bps in (4, 3):
        geo = compute_block_geometry(1024, C, bps)
        rows = _random_rows(skew, 67, geo, skew, cuda)
        assert rows.data_ptr() % 4 == skew
        for ms in (False, True) if C == 2 else (False,):
            _rows_equal_plain(rows, geo, ms)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("B", [1, 7, 8, 31, 32, 33, 65])
def test_decode_rows_kernel_matches_plain(cuda, B, bps, layout):
    """Kernel 1 on block rows at the live cell's 128-byte blocks (126 at 3
    bits): B around a CTA's 32 stereo or 64 mono blocks, rows 1-3 bytes off
    a 4-byte boundary, headers with malformed step indices: the header
    parse, the recurrence and the mid/side flush equal the plain version."""
    C, ms = LAYOUTS[layout]
    geo = compute_block_geometry(128, C, bps)
    skew = 1 + B % 3
    rows = _random_rows(B * 10 + bps, B, geo, skew, cuda)
    assert rows.data_ptr() % 4 == skew
    _rows_equal_plain(rows, geo, ms)


def test_streaming_push_is_one_launch_on_the_card(cuda):
    """A live cell's stream (3 bits, 128-byte blocks, mid/side) pushed in
    975-byte pieces: every push that decodes is one launch of kernel 1,
    whose header parse counts the push's blocks, and the PCM equals
    ``device="cpu"``'s."""
    from torch.profiler import profile

    from aad_tpu_torch.utils import trace

    geo = compute_block_geometry(128, 2, 3)
    data = _stream(2, True, 3, block=128)
    cpu, card = aad_tpu_torch.StreamingDecoder(device="cpu"), aad_tpu_torch.StreamingDecoder(device=cuda)
    got, want, blocks_before = [], [], 0
    for k in range(0, len(data), 975):
        piece = data[k : k + 975]
        want.append(cpu.push(piece))
        before = fused_decode.launches[fused_decode.DECODE_KERNEL]
        counted = dict(trace.counts)
        with profile():
            out = card.push(piece)
        launched = fused_decode.launches[fused_decode.DECODE_KERNEL] - before
        parsed = trace.counts.get("k1_rows_parsed", 0) - counted.get("k1_rows_parsed", 0)
        combined = trace.counts.get("k1_rows_ms", 0) - counted.get("k1_rows_ms", 0)
        blocks = -(-(card._samples_out) // geo.num_samples_per_block) - blocks_before
        blocks_before += blocks
        assert (launched, parsed, combined) == ((1, blocks, blocks) if out.shape[1] else (0, 0, 0))
        got.append(out)
    np.testing.assert_array_equal(np.concatenate(got, axis=1), np.concatenate(want, axis=1))
    assert sum(g.shape[1] for g in got) == aad_tpu_torch.decode_header(data).num_samples


def _stream(nch, ms, bps, block=1024):
    """A 40-block stream with a ragged tail, as the benchmark draws its stream."""
    geo = compute_block_geometry(block, nch, bps)
    n = 40 * geo.num_samples_per_block - 123
    nb = num_blocks_for(n, geo.num_samples_per_block)
    rng = np.random.default_rng(nch * 10 + bps)
    states = BlockStates.from_numpy((
        rng.integers(0, 4081, (nb, nch)),
        rng.integers(-20000, 20000, (nb, nch, 4)),
        rng.integers(-32768, 32768, (nb, nch, 4)),
    ))
    codes = torch.from_numpy(rng.integers(0, 2**bps, (nb, nch, geo.codes_per_block), dtype=np.uint8))
    hdr = build_block_headers(states, torch.zeros((nb, nch), dtype=torch.int32), geo)
    header = aad_tpu_torch.HeaderInfo(
        num_channels=nch, num_samples=n, sampling_rate=48000, bits_per_sample=bps,
        block_size=geo.block_size, num_samples_per_block=geo.num_samples_per_block,
        ch_process_method=int(ms),
    )
    return aad_tpu_torch.encode_header(header) + assemble_stream(hdr, codes, geo, n).numpy().tobytes()


@pytest.mark.parametrize("nch,ms,bps", [(2, False, 4), (2, True, 4), (1, False, 3)])
def test_cuda_decode_matches_cpu(cuda, nch, ms, bps):
    data = _stream(nch, ms, bps)
    _, want = aad_tpu_torch.decode(data, device="cpu")
    _, got = aad_tpu_torch.decode(data, device="cuda")
    np.testing.assert_array_equal(got, want)
    _, want = aad_tpu_torch.decode(data[:-1500], device="cpu", strict=False)
    _, got = aad_tpu_torch.decode(data[:-1500], device="cuda", strict=False)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("engine", ["fused", "pallas"])
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_cuda_transfer_decode_matches_cpu(cuda, monkeypatch, engine, chunk):
    """decode()'s pinned, streamed path in chunks of 1, 7 (a ragged last
    chunk) and 64 blocks (one pass), against device="cpu" and against the
    resident decode, strict and lenient; then the same calls again in turns
    with another stream, so that memory the allocator hands out again after
    a call is seen to hold no stale data."""
    from aad_tpu_torch.codec import decoder

    monkeypatch.setattr(decoder, "_TRANSFER_CHUNK_BLOCKS", chunk)
    streams = [_stream(2, False, 4), _stream(2, True, 4), _stream(1, False, 3)]
    for data in streams + streams[::-1]:
        h, got = aad_tpu_torch.decode(data, device="cuda", engine=engine)
        _, want = aad_tpu_torch.decode(data, device="cpu", engine=engine)
        assert got.dtype == np.int32 and got.shape == (h.num_channels, h.num_samples)
        np.testing.assert_array_equal(got, want)
        dec = aad_tpu_torch.Decoder.from_header(h, device="cuda", engine=engine)
        resident = dec.decode_payload_ondevice(np.frombuffer(data, np.uint8)[aad_tpu_torch.FILE_HEADER_SIZE:])
        np.testing.assert_array_equal(got, resident.cpu().numpy())
        cut = data[:-1500]
        _, got = aad_tpu_torch.decode(cut, device="cuda", engine=engine, strict=False)
        np.testing.assert_array_equal(got, aad_tpu_torch.decode(cut, device="cpu", engine=engine, strict=False)[1])


@pytest.mark.parametrize("parallel", [False, True])
def test_cuda_transfer_encode_matches_cpu(cuda, monkeypatch, parallel):
    """encode()'s pinned, streamed path: the sequential mode in 5 chunks of
    2 blocks (uploads beside kernel 3, bytes down chunk by chunk) and the
    parallel mode in one pass, against device="cpu" and the resident encode,
    twice in turns with another signal."""
    from aad_tpu_torch.codec import encoder

    monkeypatch.setattr(encoder, "_OVERLAP_MIN_BLOCKS", 3)
    monkeypatch.setattr(encoder, "_OVERLAP_CHUNK_BLOCKS", 2)
    cfg = aad_tpu_torch.EncodeConfig(2, 16000, 4, 96, 1, 2)
    n = 10 * cfg.geometry().num_samples_per_block - 7
    rng = np.random.default_rng(5)
    signals = [rng.integers(-20000, 20000, (2, n)).astype(np.int32) for _ in range(2)]
    kw = dict(parallel_blocks=parallel, parallel_chunk_blocks=2 if parallel else 1)
    for pcm in signals + signals[::-1]:
        got = aad_tpu_torch.encode(pcm, cfg, device="cuda", **kw)
        assert got == aad_tpu_torch.encode(pcm, cfg, device="cpu", **kw)
        enc = aad_tpu_torch.Encoder.from_config(cfg, device="cuda", **kw)
        resident = enc.encode_payload_ondevice(torch.from_numpy(pcm.astype(np.int16)).to(cuda))
        assert got[aad_tpu_torch.FILE_HEADER_SIZE:] == resident.cpu().numpy().tobytes()


def test_native_engine_matches_the_card(cuda):
    cfg = aad_tpu_torch.EncodeConfig(2, 48000, 4, 1024, 0, 2)
    pcm = np.random.default_rng(3).integers(-20000, 20000, (2, 9 * 992 - 3)).astype(np.int32)
    data = aad_tpu_torch.encode(pcm, cfg, device="cuda")
    assert data == aad_tpu_torch.encode(pcm, cfg, engine="native")
    assert aad_tpu_torch.encode(pcm, cfg, device="cuda", parallel_blocks=True) == aad_tpu_torch.encode(
        pcm, cfg, engine="native", parallel_blocks=True)
    np.testing.assert_array_equal(aad_tpu_torch.decode(data, engine="native")[1],
                                  aad_tpu_torch.decode(data, device="cuda")[1])


@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("L,T", [(1000, 300), (257, 988), *((B * C, T) for B, C, T in EDGE_SHAPES)])
def test_lms_lanes_kernel_matches_plain(cuda, bps, L, T):
    """qdiffs from the prefix scan (half the lanes at the top step), weights
    over all of int32 on a quarter of the lanes and int32-wide histories on
    half: the sums wrap."""
    rng = np.random.default_rng(bps * 5 + L + T)
    codes = torch.from_numpy(rng.integers(0, 2**bps, (T, L), dtype=np.uint8))
    init = torch.from_numpy(np.where(np.arange(L) < L // 2, 4080, rng.integers(0, 4081, L)).astype(np.int32))
    qdiffs = compute_qdiffs_prefix(codes, init, bps, dim=0)
    history = rng.integers(-(2**31), 2**31 - 1, (L, 4), endpoint=True).astype(np.int32)
    history[::2] = rng.integers(-32768, 32768, history[::2].shape)
    weight = rng.integers(-(2**31), 2**31 - 1, (L, 4), endpoint=True).astype(np.int32)
    weight[1::2] = rng.integers(-20000, 20000, weight[1::2].shape)
    weight[::4] = rng.integers(-20000, 20000, weight[::4].shape)  # as the benchmark draws them
    args = (qdiffs, torch.from_numpy(history), torch.from_numpy(weight))
    want = lms.lms_lanes_reference(*args)
    before = lms.launches[lms.LMS_KERNEL]
    got = lms.lms_lanes(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert lms.launches[lms.LMS_KERNEL] == before + 1
    assert got.dtype == torch.int16 and got.shape == (L, T + 4)
    assert torch.equal(got.cpu(), want)
    # phase A on the card equals phase A on the CPU
    assert torch.equal(compute_qdiffs_prefix(codes.to(cuda), init.to(cuda), bps, dim=0).cpu(), qdiffs)


@pytest.mark.parametrize("nch,ms,bps", [(2, False, 4), (2, True, 4), (1, False, 3)])
def test_cuda_pallas_decode_matches_cpu(cuda, nch, ms, bps):
    """engine="pallas": one aad_lms_lanes launch and no aad_decode_lanes launch."""
    data = _stream(nch, ms, bps)
    _, want = aad_tpu_torch.decode(data, device="cpu")
    before = dict(lms.launches), dict(fused_decode.launches)
    _, got = aad_tpu_torch.decode(data, device="cuda", engine="pallas")
    np.testing.assert_array_equal(got, want)
    assert lms.launches[lms.LMS_KERNEL] == before[0][lms.LMS_KERNEL] + 1
    assert fused_decode.launches[fused_decode.DECODE_KERNEL] == before[1][fused_decode.DECODE_KERNEL]


def _same(got, want) -> bool:
    if isinstance(want, tuple):
        return all(_same(g, w) for g, w in zip(got, want))
    return torch.equal(got.cpu().to(torch.int64), want.cpu().to(torch.int64))


def _encode_lanes(seed, B, L, nspb):
    """int16 blocks at full scale (half at the rails, so squared errors wrap),
    ragged valid counts including 0-3, and a carry with weights over all of
    int32 and step indices outside [0, 4080]."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, (B, L, nspb))
    x = np.where(rng.random(x.shape) < 0.5, rng.choice([-32768, 32767], x.shape), x).astype(np.int16)
    valid = rng.integers(0, nspb + 1, (B, L)).astype(np.int32)
    valid[:, :5] = [0, 1, 3, 4, nspb][: min(L, 5)]
    state = CodecState.from_numpy((
        rng.integers(-32768, 32768, (L, 4)),
        rng.integers(-(2**31), 2**31 - 1, (L, 4), endpoint=True),
        rng.choice([0, 4080, 4095, 5000, -7, 1000], L),
    ))
    prev = torch.from_numpy(rng.integers(-32768, 32768, (L, nspb)).astype(np.int16))
    return torch.from_numpy(x), torch.from_numpy(valid), (state, prev)


# (trials, warm_on_prev, blocks_before, emit_block_states, lanes, samples a block):
# the paired schedule (trials > 0 with the warm-up) at trials 1-3, its
# samples staged at up to 4,096 lanes (CTAs of 16 lanes at 30-sample
# blocks, 8 at 992, 2 at 2948 and 3104) and read from device memory at
# 4,099 (a wider launch, its last CTA ragged); the serial one at trials 0
# and without the warm-up.
STREAM_CASES = [
    (0, True, 0, False, 333, 30), (1, True, 0, True, 333, 30), (2, True, 3, False, 333, 30),
    (3, True, 1, True, 333, 30), (1, True, 1, False, 37, 2948), (2, True, 0, True, 45, 3104),
    (1, True, 2, False, 2, 992),
    (2, True, 2, True, 4099, 30), (3, True, 0, False, 4099, 30),
    (2, False, 0, True, 333, 30), (3, False, 0, False, 333, 30),
]


@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("trials,warm,blocks_before,emit,L,nspb", STREAM_CASES)
def test_encode_stream_kernel_matches_plain(cuda, bps, trials, warm, blocks_before, emit, L, nspb):
    """Valid counts 0-3, ragged and full on every block, and forged carries."""
    blocks, valid, carry = _encode_lanes(bps * 31 + trials + L, 3, L, nspb)
    kw = dict(carry=carry, blocks_before=blocks_before, warm_on_prev=warm, emit_block_states=emit)
    want = fused_encode.encode_stream_reference(blocks, valid, bps, trials, **kw)
    before = dict(fused_encode.launches), dict(encode_pass.launches)
    kw["carry"] = (carry[0].to(cuda), carry[1].to(cuda))
    got = fused_encode.encode_stream(blocks.to(cuda), valid.to(cuda), bps, trials, **kw)
    torch.cuda.synchronize()
    assert fused_encode.launches[fused_encode.STREAM_KERNEL] == before[0][fused_encode.STREAM_KERNEL] + 1
    # the carry comes from one aad_encode_pass over the last block
    assert encode_pass.launches[encode_pass.PASS_KERNEL] == before[1][encode_pass.PASS_KERNEL] + (not emit)
    assert _same(tuple(got[0]), tuple(want[0])) and _same(got[1], want[1])
    assert _same(tuple(got[2]), tuple(want[2])) if emit else _same(tuple(got[2][0]), tuple(want[2][0]))


# (channels, trials, warm_on_prev, blocks_before, rows, max block size):
# the serial schedule at trials 0 and without the warm-up (its emit staged
# per warp); the paired one staged (333 and 334 lanes), not staged (4,098
# lanes, past the gate), and at a full block's length, the sequential path's
# 2 lanes.
PACKED_CASES = [
    (1, 0, True, 0, 333, 64), (2, 2, False, 0, 167, 96), (2, 1, True, 1, 167, 96), (1, 2, True, 3, 333, 64),
    (2, 2, True, 2, 2049, 64), (2, 2, True, 1, 1, 1024), (1, 3, True, 0, 2, 1024),
]


@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("C,trials,warm,blocks_before,rows,block", PACKED_CASES)
def test_encode_stream_kernel_packs_like_plain(cuda, bps, C, trials, warm, blocks_before, rows, block):
    """encode_stream(..., pack=geo): each block's data region, the channels
    of a row interleaved unit by unit, equal to the plain version's codes
    packed by bitpack.pack_codes; valid counts 0-3, ragged (at 3 bits a
    last unit partly past them) and full, and forged carries."""
    _packs_like_plain(cuda, bps, C, trials, warm, blocks_before, rows, block, num_blocks=3)


def test_encode_stream_kernel_packs_like_plain_at_the_mono_cell_lanes(cuda):
    """The lanes of the benchmark's mono 2-bit cell (aad-b2-s1024-mono):
    1 channel, 2 bits, 1,024-byte blocks (4,028 samples), trials 2 with the
    warm-up, 256 rows: the paired schedule staged, at 2 lanes a CTA (a lane
    takes 2 * 1,006 + 4 * 4,028 = 18,124 bytes of the CTA's 47,104). Two
    blocks, so that the plain version stays quick."""
    _packs_like_plain(cuda, 2, 1, 2, True, 0, 256, 1024, num_blocks=2)


def _packs_like_plain(cuda, bps, C, trials, warm, blocks_before, rows, block, num_blocks):
    geo = compute_block_geometry(block, C, bps)
    nspb = geo.num_samples_per_block
    blocks, valid, (state, prev) = _encode_lanes(bps * 13 + C + rows, num_blocks, rows * C, nspb)
    blocks, valid = blocks.reshape(num_blocks, rows, C, nspb), valid.reshape(num_blocks, rows, C)
    carry = (state.map(lambda a: a.reshape(rows, C, *a.shape[1:])), prev.reshape(rows, C, nspb))
    kw = dict(carry=carry, blocks_before=blocks_before, warm_on_prev=warm, need_carry=False, pack=geo)
    want = fused_encode.encode_stream_reference(blocks, valid, bps, trials, **kw)
    before = dict(fused_encode.launches), dict(encode_pass.launches)
    kw["carry"] = (carry[0].to(cuda), carry[1].to(cuda))
    got = fused_encode.encode_stream(blocks.to(cuda), valid.to(cuda), bps, trials, **kw)
    torch.cuda.synchronize()
    assert fused_encode.launches[fused_encode.STREAM_KERNEL] == before[0][fused_encode.STREAM_KERNEL] + 1
    assert encode_pass.launches == before[1]
    assert got[1].dtype == torch.uint8 and got[1].shape == (num_blocks, rows, geo.data_bytes)
    assert _same(tuple(got[0]), tuple(want[0])) and _same(got[1], want[1])


def test_encode_stream_serial_warm_up_matches_plain(cuda):
    """A block whose speculative codes do not fit a CTA (more than 47,104
    slots) takes the serial schedule with the warm-up; its valid counts are
    short (a live head, and fewer than 4 samples), the warm-up full."""
    nspb = 47_112
    blocks, _, carry = _encode_lanes(5, 1, 2, nspb)
    valid = torch.tensor([[10, 3]], dtype=torch.int32)
    kw = dict(carry=carry, blocks_before=1, warm_on_prev=True, emit_block_states=True)
    want = fused_encode.encode_stream_reference(blocks, valid, 4, 1, **kw)
    kw["carry"] = (carry[0].to(cuda), carry[1].to(cuda))
    got = fused_encode.encode_stream(blocks.to(cuda), valid.to(cuda), 4, 1, **kw)
    torch.cuda.synchronize()
    assert _same(tuple(got[0]), tuple(want[0])) and _same(got[1], want[1]) and _same(tuple(got[2]), tuple(want[2]))


@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("T", [44, 988])
def test_encode_pass_kernel_matches_plain(cuda, bps, emit, T):
    blocks, valid, (state, _) = _encode_lanes(bps + 7 * emit + T, 1, 1001, T)
    samples = blocks[0].t().contiguous()
    lane_valid = valid[0].clone()  # 0..T with the four head samples: 0..T-4 live slots of T
    lane_valid[5:9] = torch.tensor([T + 4, T + 5, T + 56, -3])  # every slot live, and a negative count
    want = encode_pass.encode_pass_reference(samples, state, lane_valid, bps, emit)
    got = encode_pass.encode_pass(samples.to(cuda), state.to(cuda), lane_valid.to(cuda), bps, emit)
    torch.cuda.synchronize()
    assert _same(tuple(got[0]), tuple(want[0])) and _same(got[2], want[2])
    assert (got[1] is None) == (not emit) and (not emit or _same(got[1], want[1]))
    assert (want[2] < 0).any()


@pytest.mark.parametrize("nch,bps,ms,parallel", [(2, 4, False, False), (2, 4, True, True), (1, 3, False, True)])
def test_cuda_encode_matches_cpu(cuda, nch, bps, ms, parallel):
    cfg = aad_tpu_torch.EncodeConfig(nch, 48000, bps, 1024, int(ms), 2)
    n = 9 * cfg.geometry().num_samples_per_block - 3
    pcm = np.random.default_rng(nch + bps).integers(-20000, 20000, (nch, n)).astype(np.int32)
    kw = dict(parallel_blocks=parallel, parallel_chunk_blocks=2 if parallel else 1)
    assert aad_tpu_torch.encode(pcm, cfg, device="cuda", **kw) == aad_tpu_torch.encode(pcm, cfg, device="cpu", **kw)


@pytest.mark.parametrize("streams", [1, 2049])  # 2 lanes; 4,098 lanes, past kernel 3's staging gate (4,096)
@pytest.mark.parametrize("chunked", [False, True])
def test_cuda_encode_batch_matches_cpu(cuda, monkeypatch, streams, chunked):
    """A pile of ragged stereo streams, cuda against cpu; chunked: constants
    shrunk so that the pile runs in 3 chunks of 2 blocks, the carry rebuilt
    by kernel 4 between them, and a stream ending in chunk 0."""
    from aad_tpu_torch.codec import encoder

    if chunked:
        monkeypatch.setattr(encoder, "_OVERLAP_MIN_BLOCKS", 3)
        monkeypatch.setattr(encoder, "_OVERLAP_CHUNK_BLOCKS", 2)
    cfg = aad_tpu_torch.EncodeConfig(2, 16000, 4, 96, 0, 2)
    nspb = cfg.geometry().num_samples_per_block
    rng = np.random.default_rng(streams)
    lengths = rng.integers(1, 6 * nspb, streams)
    lengths[0] = 6 * nspb - 5
    if streams > 1:
        lengths[1] = nspb + 3
    pile = [rng.integers(-20000, 20000, (2, n)).astype(np.int16) for n in lengths]
    fused_encode.reset_launches()
    encode_pass.reset_launches()
    got = aad_tpu_torch.encode_batch(pile, cfg, device="cuda")
    chunks = 3 if chunked else 1
    assert fused_encode.launches == {fused_encode.STREAM_KERNEL: chunks}
    assert encode_pass.launches == {encode_pass.PASS_KERNEL: chunks - 1}
    assert got == aad_tpu_torch.encode_batch(pile, cfg, device="cpu")
    assert got[-1] == aad_tpu_torch.encode(pile[-1], cfg, device="cuda")


def test_no_unpack_or_pack_on_the_card(cuda, monkeypatch):
    """With the fused engine on the card, no entry point that starts or ends
    in .aad bytes runs bitpack.unpack_codes or pack_codes: kernel 1 reads
    the codes packed and kernel 3 writes them so. Each output equals
    device="cpu" (computed first: the plain versions unpack and pack)."""
    from aad_tpu_torch.codec import encoder
    from aad_tpu_torch.ops import bitpack

    streams = [_stream(2, False, 4), _stream(2, True, 4), _stream(1, False, 3)]
    cfg = aad_tpu_torch.EncodeConfig(2, 16000, 4, 96, 1, 2)
    mono = aad_tpu_torch.EncodeConfig(1, 16000, 3, 128, 0, 1)
    rng = np.random.default_rng(11)
    pcm = rng.integers(-20000, 20000, (2, 10 * cfg.geometry().num_samples_per_block - 7)).astype(np.int16)
    pcm1 = rng.integers(-20000, 20000, (1, 5 * mono.geometry().num_samples_per_block - 3)).astype(np.int16)
    pile = [pcm[:, :n] for n in (pcm.shape[1], 500, 77)]

    def decode_streamed(data, device):
        sd = aad_tpu_torch.StreamingDecoder(device=device, engine="fused")
        return np.concatenate([sd.push(data[i : i + 3001]) for i in range(0, len(data), 3001)], axis=1)

    def encode_streamed(x, c, device):
        se = aad_tpu_torch.StreamingEncoder(c, device=device)
        body = b"".join(se.push(x[:, i : i + 700]) for i in range(0, x.shape[1], 700)) + se.finish()
        return se.header() + body

    def run(device):
        out = []
        for data in streams:
            h = aad_tpu_torch.decode_header(data)
            payload = np.frombuffer(data, np.uint8)[aad_tpu_torch.FILE_HEADER_SIZE:]
            dec = aad_tpu_torch.Decoder.from_header(h, device=device, engine="fused")
            out += [aad_tpu_torch.decode(data, device=device, engine="fused")[1],
                    aad_tpu_torch.decode(data[:-1500], device=device, engine="fused", strict=False)[1],
                    dec.decode_payload_ondevice(payload).cpu().numpy(),
                    dec.decode_payload(payload).cpu().numpy(),
                    dec.decode_block_range(payload, 3, 5).cpu().numpy(),
                    dec.decode_time_range(payload, 0.05, 0.2).cpu().numpy(),
                    decode_streamed(data, device)]
        out += [pcm for _, pcm in aad_tpu_torch.decode_batch(streams, device=device, engine="fused")]
        for c, x in ((cfg, pcm), (mono, pcm1)):
            out += [aad_tpu_torch.encode(x, c, device=device),
                    aad_tpu_torch.encode(x, c, device=device, parallel_blocks=True),
                    aad_tpu_torch.encode(x, c, device=device, parallel_blocks=True, parallel_chunk_blocks=3,
                                         parallel_warm_passes=1),
                    encode_streamed(x, c, device)]
        enc = aad_tpu_torch.Encoder.from_config(cfg, device=device)
        out += [enc.encode_payload_ondevice(torch.from_numpy(pcm).to(device)).cpu().numpy().tobytes()]
        out += aad_tpu_torch.encode_batch(pile, cfg, device=device)
        return out

    monkeypatch.setattr(encoder, "_OVERLAP_MIN_BLOCKS", 3)  # the sequential encode in chunks of 2 blocks
    monkeypatch.setattr(encoder, "_OVERLAP_CHUNK_BLOCKS", 2)
    want = run("cpu")

    def forbidden(*args, **kwargs):
        raise AssertionError("a code tensor of one byte a code was made on the card")

    monkeypatch.setattr(bitpack, "unpack_codes", forbidden)
    monkeypatch.setattr(bitpack, "pack_codes", forbidden)
    got = run("cuda")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, bytes):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)


def test_self_check_on_the_card(cuda):
    report = aad_tpu_torch.self_check(device=cuda)
    assert report["device"] == torch.cuda.get_device_name(cuda)
    assert len(report["checks"]) == 5 and all(c["ok"] for c in report["checks"])


def test_measure_throughput_on_the_card(cuda):
    from aad_tpu_torch.utils.profiling import measure_throughput

    x = torch.arange(1 << 20, dtype=torch.int32, device=cuda)
    report = measure_throughput(lambda t: t * 3 + 1, x, x.numel(), iters=5)
    assert report.iters == 5 and report.total_samples == 5 * x.numel()
    assert 0 < report.seconds_per_iter < 1 and report.samples_per_sec > 0
