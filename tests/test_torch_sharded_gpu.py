"""aad_tpu_torch.parallel.sharded on the card (needs a GPU).

Each sharded function runs on a mesh of 4 shards on one card (and over every
card where there are several) against its unsharded counterpart on the card
and against the same mesh of CPU shards, at a few blocks. Imports no jax, so
it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_sharded_gpu.py -q

Without a card every test here skips.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from aad_tpu_torch.ops import decode as td
from aad_tpu_torch.ops import encode as te
from aad_tpu_torch.ops import fused_decode, fused_encode, lms
from aad_tpu_torch.parallel import sharded as ts

pytestmark = pytest.mark.gpu

CPU = torch.device("cpu")
# |cuda - cpu| of the float32 RMSE statistic: both sum the same float32
# squares, in another order
STAT_TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _meshes(cuda):
    """4 shards on one card; every card, where there are several."""
    meshes = [ts.make_mesh(4, devices=[cuda] * 4)]
    if torch.cuda.device_count() > 1:
        meshes.append(ts.make_mesh())
    return meshes


def _cpu_mesh():
    return ts.make_mesh(4, devices=[CPU] * 4)


def _on_mesh(shards, mesh):
    assert [s.device for s in shards] == mesh.shard_devices


def _nonempty(n, mesh):
    return sum(b > a for a, b in ts._pieces(n, mesh.size))


@pytest.mark.parametrize("engine,module,kernel", [
    ("fused", fused_decode, fused_decode.DECODE_KERNEL), ("pallas", lms, lms.LMS_KERNEL)])
def test_decode_sharded_on_card(cuda, engine, module, kernel):
    rng = np.random.default_rng(3)
    L, T = 1001, 236
    args = [torch.from_numpy(a) for a in (
        rng.integers(0, 16, (L, T), dtype=np.uint8), rng.integers(0, 4096, L).astype(np.int32),
        rng.integers(-20000, 20000, (L, 4)).astype(np.int32), rng.integers(-32768, 32768, (L, 4)).astype(np.int32))]
    on_card = [a.to(cuda) for a in args]
    want = td.decode_blocks(*on_card, bits_per_sample=4, engine=engine).cpu()
    assert torch.equal(want, ts.gather(ts.decode_blocks_sharded(*args, bits_per_sample=4, mesh=_cpu_mesh(),
                                                                engine=engine), CPU))
    for mesh in _meshes(cuda):
        current = torch.cuda.current_device()
        before = module.launches[kernel]
        out = ts.decode_blocks_sharded(*on_card, bits_per_sample=4, mesh=mesh, engine=engine)
        assert torch.cuda.current_device() == current
        assert module.launches[kernel] - before == _nonempty(L, mesh)
        _on_mesh(out, mesh)
        assert torch.equal(ts.gather(out, CPU), want)


def _streams(seed, S, B, nspb=60, short=41):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(-20000, 20000, (S, B, 2, nspb)).astype(np.int16)
    valid = np.full((S, B), nspb, dtype=np.int32)
    valid[:, -1] = short
    blocks[:, -1, :, short:] = 0
    return torch.from_numpy(blocks), torch.from_numpy(valid)


@pytest.mark.parametrize("S", [3, 7])  # S = 3: an empty shard of four
def test_encode_streams_sharded_on_card(cuda, S):
    blocks, valid = _streams(S, S, 3)
    kw = dict(bits_per_sample=4, num_trials=2, stat=True)
    cpu_h, cpu_c, cpu_rmse = ts.encode_streams_sharded(blocks, valid, mesh=_cpu_mesh(), **kw)
    # the unsharded kernel-3 launch on the same lanes: (B, S, C)
    uh, uc, _ = fused_encode.encode_stream(blocks.to(cuda).transpose(0, 1), valid.to(cuda).t()[..., None], 4, 2,
                                           need_carry=False)
    assert torch.equal(uc.transpose(0, 1).cpu(), ts.gather(cpu_c, CPU))
    for mesh in _meshes(cuda):
        before = fused_encode.launches[fused_encode.STREAM_KERNEL]
        h, c, rmse = ts.encode_streams_sharded(blocks.to(cuda), valid.to(cuda), mesh=mesh, **kw)
        assert fused_encode.launches[fused_encode.STREAM_KERNEL] - before == _nonempty(S, mesh)
        _on_mesh(c, mesh)
        assert torch.equal(ts.gather(c, CPU), ts.gather(cpu_c, CPU))
        for got, want, unsharded in zip(ts.gather(h, CPU), ts.gather(cpu_h, CPU), uh):
            assert torch.equal(got, want) and torch.equal(got, unsharded.transpose(0, 1).cpu())
        assert rmse.device == mesh.shard_devices[0]
        assert abs(float(rmse) - float(cpu_rmse)) < STAT_TOL


@pytest.mark.parametrize("c,wp", [(1, 0), (2, 1), (2, 2)])
def test_encode_blocks_parallel_sharded_on_card(cuda, c, wp):
    rng = np.random.default_rng(10 * c + wp)
    B, nspb = 4 * c * 2 + 3, 60
    blocks = torch.from_numpy(rng.integers(-20000, 20000, (B, 2, nspb)).astype(np.int16))
    valid = torch.full((B,), nspb, dtype=torch.int32)
    valid[-1] = nspb - 13
    blocks[-1, :, nspb - 13:] = 0
    kw = dict(bits_per_sample=4, num_trials=1, chunk_blocks=c, warm_passes=wp)
    cpu_h, cpu_c = ts.encode_blocks_parallel_sharded(blocks, valid, mesh=_cpu_mesh(), **kw)
    uh, uc = te.encode_blocks_parallel(blocks.to(cuda), valid.to(cuda), 4, 1, chunk_blocks=c, warm_passes=wp,
                                       stream=fused_encode.encode_stream)
    assert torch.equal(uc.cpu(), ts.gather(cpu_c, CPU))
    for mesh in _meshes(cuda):
        before = fused_encode.launches[fused_encode.STREAM_KERNEL]
        h, codes = ts.encode_blocks_parallel_sharded(blocks.to(cuda), valid.to(cuda), mesh=mesh, **kw)
        assert fused_encode.launches[fused_encode.STREAM_KERNEL] - before == (wp + 1) * _nonempty(-(-B // c), mesh)
        _on_mesh(codes, mesh)
        assert torch.equal(ts.gather(codes, CPU), uc.cpu())
        for got, want, unsharded in zip(ts.gather(h, CPU), ts.gather(cpu_h, CPU), uh):
            assert torch.equal(got, want) and torch.equal(got, unsharded.cpu())


def test_make_mesh_takes_the_cards(cuda):
    mesh = ts.make_mesh()
    assert mesh.shard_devices == [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    assert ts.make_mesh(4, devices=["cuda"] * 4).shard_devices == [cuda] * 4
