"""The CUDA kernels against their plain torch versions, bit for bit (needs a GPU).

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
from aad_tpu_torch.ops import encode_pass, fused_decode, fused_encode
from aad_tpu_torch.ops.transitions import CodecState
from aad_tpu_torch.tables import STEPSIZE_TABLE

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _lanes(seed, L, T, bps):
    rng = np.random.default_rng(seed)
    codes_tm = rng.integers(0, 2**bps, (T, L), dtype=np.uint8)
    si = rng.integers(0, 4096, (L,)).astype(np.int32)
    si[:17] = [0, 4080, *range(4081, 4096)]
    hi = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    wt = rng.integers(-20000, 20000, (L, 4)).astype(np.int32)
    return [torch.from_numpy(a) for a in (codes_tm, si, hi, wt)]


def test_stepsize_probe_equals_table(cuda):
    got = fused_decode.stepsize_probe(cuda)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), STEPSIZE_TABLE)
    assert fused_decode.stepsize_corrections(cuda) == ()


@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("L,T", [(1000, 300), (257, 988)])
def test_decode_lanes_kernel_matches_plain(cuda, bps, L, T):
    args = _lanes(bps * 7 + L, L, T, bps)
    want = fused_decode.decode_lanes_reference(*args, bps)
    before = fused_decode.launches[fused_decode.DECODE_KERNEL]
    got = fused_decode.decode_lanes(*(a.to(cuda) for a in args), bps)
    torch.cuda.synchronize()
    assert fused_decode.launches[fused_decode.DECODE_KERNEL] == before + 1
    assert got.dtype == torch.int16 and got.shape == (L, T + 4)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("nch,ms,bps", [(2, False, 4), (2, True, 4), (1, False, 3)])
def test_cuda_decode_matches_cpu(cuda, nch, ms, bps):
    geo = compute_block_geometry(1024, nch, bps)
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
    data = aad_tpu_torch.encode_header(header) + assemble_stream(hdr, codes, geo, n).numpy().tobytes()
    _, want = aad_tpu_torch.decode(data, device="cpu")
    _, got = aad_tpu_torch.decode(data, device="cuda")
    np.testing.assert_array_equal(got, want)
    _, want = aad_tpu_torch.decode(data[:-1500], device="cpu", strict=False)
    _, got = aad_tpu_torch.decode(data[:-1500], device="cuda", strict=False)
    np.testing.assert_array_equal(got, want)


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
    valid[:, :5] = [0, 1, 3, 4, nspb]
    state = CodecState.from_numpy((
        rng.integers(-32768, 32768, (L, 4)),
        rng.integers(-(2**31), 2**31 - 1, (L, 4), endpoint=True),
        rng.choice([0, 4080, 4095, 5000, -7, 1000], L),
    ))
    prev = torch.from_numpy(rng.integers(-32768, 32768, (L, nspb)).astype(np.int16))
    return torch.from_numpy(x), torch.from_numpy(valid), (state, prev)


@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("trials,warm,blocks_before,emit", [
    (0, True, 0, False), (1, True, 0, True), (2, True, 3, False), (2, False, 0, True), (3, False, 0, False),
])
def test_encode_stream_kernel_matches_plain(cuda, bps, trials, warm, blocks_before, emit):
    blocks, valid, carry = _encode_lanes(bps * 31 + trials, 3, 333, 30)
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


@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("emit", [False, True])
def test_encode_pass_kernel_matches_plain(cuda, bps, emit):
    blocks, valid, (state, _) = _encode_lanes(bps + 7 * emit, 1, 1001, 44)
    samples = blocks[0].t().contiguous()
    lane_valid = valid[0].clone()  # 0..44 with the four head samples: 0..40 live slots of 44
    lane_valid[5:9] = torch.tensor([48, 49, 100, -3])  # every slot live, and a negative count
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
