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
from aad_tpu_torch.ops import fused_decode
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
