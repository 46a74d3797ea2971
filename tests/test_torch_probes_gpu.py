"""The decode probes' CUDA kernels against their plain torch versions, bit for
bit (needs a GPU).

Kernels 6-8 of the port's kernel table (``aad_tpu_torch/probes``): the
transpose, the five forms of the phase-A probe and every built instance of
the decode-layout probe, at the CPU tests' sizes and at lane counts that are
not a multiple of the CTA, word counts that are not a multiple of
``two_loop``'s chunk or of the lane-major row tile, and shapes that take the
transpose's 4-byte path. Imports no jax, so it runs on a machine with a card
and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_probes_gpu.py -q

Without a card every test here skips.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from aad_tpu_torch.probes import decode_layout, phase_a_decode, transpose

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)


@pytest.mark.parametrize("shape,offset", [
    ((8, 4, 8, 128), 0), ((512, 3, 8, 128), 0),  # 16-byte path, whole tiles and not
    ((37, 3, 5, 11), 0), ((64, 66), 0), ((68, 64), 1),  # 4-byte path: odd extents, a view off 16 bytes
])
def test_transpose_kernel_matches_plain(cuda, shape, offset):
    n = int(np.prod(shape))
    flat = np.random.default_rng(n).integers(-(2**31), 2**31, n + offset, dtype=np.int64).astype(np.int32)
    x = torch.from_numpy(flat).to(cuda)[offset:].view(shape)
    before = transpose.launches[transpose.KERNEL]
    got = transpose.transpose(x)
    torch.cuda.synchronize()
    assert transpose.launches[transpose.KERNEL] == before + 1
    assert torch.equal(got.cpu(), transpose.transpose_reference(x.cpu()))


@pytest.mark.parametrize("variant", phase_a_decode.VARIANTS)
@pytest.mark.parametrize("W,L,cta_lanes", [(16, 1024, 64), (13, 1000, 64), (40, 333, 128), (1, 70, 32), (37, 96, 32)])
def test_phase_a_kernel_matches_plain(cuda, variant, W, L, cta_lanes):
    words = _u32((W, L), W * L + cta_lanes)
    want = phase_a_decode.decode(words, variant, device="cpu")
    before = phase_a_decode.launches[f"{phase_a_decode.KERNEL}[{variant}]"]
    got = phase_a_decode.decode(words, variant, cta_lanes=cta_lanes)
    torch.cuda.synchronize()
    assert phase_a_decode.launches[f"{phase_a_decode.KERNEL}[{variant}]"] == before + 1
    assert torch.equal(got.cpu(), want)


def _layout_inputs(L, W, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, (W, L), dtype=np.uint32), rng.integers(0, 4081, L).astype(np.int32),
            rng.integers(-30000, 30000, (4, L)).astype(np.int32), rng.integers(-20000, 20000, (4, L)).astype(np.int32))


@pytest.mark.parametrize("layout,r,mode", decode_layout.INSTANCES)
@pytest.mark.parametrize("L,W", [(1024, 16), (2048, 16), (1000, 13), (70, 9), (4159, 3)])
def test_decode_layout_kernel_matches_plain(cuda, layout, r, mode, L, W):
    args = _layout_inputs(L, W, L + W)
    want = decode_layout.decode(*args, layout=layout, r=r, mode=mode, device="cpu")
    name = decode_layout.instance(layout, r, mode)
    before = decode_layout.launches[name]
    got = decode_layout.decode(*args, layout=layout, r=r, mode=mode)
    torch.cuda.synchronize()
    assert decode_layout.launches[name] == before + 1
    assert torch.equal(got.cpu(), want)
