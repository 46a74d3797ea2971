"""aad_tpu_torch.parallel.sharded on meshes of CPU shards against aad_tpu.

The port's mesh is 8 x ``torch.device("cpu")`` in the shapes (8, 1), (4,
2), (2, 4) and (1, 8); a CPU shard runs the kernels' plain versions. The
oracle is ``aad_tpu``'s unsharded function (``decode_blocks`` and
``encode_blocks_parallel`` under ``engine="scan"``, ``encode_stream_blocks``),
which avoids a ``shard_map`` compile per case; at one mesh shape the port
is also held against ``aad_tpu.parallel.sharded`` on the 8-device virtual
CPU mesh of ``tests/conftest.py``. Cases follow ``tests/test_sharding.py``
at its sizes: lane and stream counts that leave shards short or empty, and
a short last block. Inputs come from numpy seeds. The sequence-parallel
encode and the whole slice are in ``tests/test_torch_sharded_encode.py``.

The quality statistic is a float32 sum taken in another order than
aad_tpu's (per shard, then across shards), so it is held within 1e-6 of
aad_tpu's and of a float64 host RMSE, as ``tests/test_sharding.py`` holds
aad_tpu's own; everything else is integer and must be equal.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aad_tpu.ops import decode as jd
from aad_tpu.ops import encode as je
from aad_tpu.parallel import sharded as js

from aad_tpu_torch import InvalidArgumentError, InvalidFormatError
from aad_tpu_torch.parallel import sharded as ts

CPU = torch.device("cpu")
MESH_SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
# |port - aad_tpu| and |port - float64 host| of the float32 RMSE statistic
STAT_TOL = 1e-6


def _mesh(shape):
    return ts.make_mesh(8, shape=shape, devices=[CPU] * 8)


def _on_mesh(shards, mesh):
    """Shard k of a result lies on mesh device k, in mesh order."""
    assert [s.device for s in shards] == mesh.shard_devices


# ---------------------------------------------------------------- make_mesh


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shapes_match_aad_tpu(n):
    want = js.make_mesh(n)
    got = ts.make_mesh(n, devices=[CPU] * 8)
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == tuple(want.axis_names) and got.size == n
    assert got.shard_devices == [CPU] * n


def test_make_mesh_default_factorisation_and_errors(monkeypatch):
    assert [ts.make_mesh(n, devices=[CPU] * 16).devices.shape for n in (4, 8, 16)] == [(2, 2), (4, 2), (4, 4)]
    assert ts.make_mesh(devices=[CPU] * 6).devices.shape == (3, 2)
    assert ts.make_mesh(8, shape=(2, 4), devices=[CPU] * 8).devices.shape == (2, 4)
    for mod, kw in ((js, {}), (ts, {"devices": [CPU] * 8})):
        with pytest.raises(ValueError, match="does not cover"):
            mod.make_mesh(8, shape=(3, 2), **kw)
        with pytest.raises(ValueError, match="only 8 available"):
            mod.make_mesh(9, **kw)
        with pytest.raises(ValueError, match="only 8 available"):
            mod.make_mesh(shape=(4, 4), **kw)
    # the default is the CUDA cards; without one it raises, never a CPU mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA device"):
        ts.make_mesh()


def test_pieces_are_jax_placement_without_padding():
    """Shard k holds the k-th piece of ceil(n / size): short or empty last pieces."""
    assert [b - a for a, b in ts._pieces(13, 8)] == [2, 2, 2, 2, 2, 2, 1, 0]
    assert [b - a for a, b in ts._pieces(5, 8)] == [1, 1, 1, 1, 1, 0, 0, 0]
    assert ts._pieces(0, 4) == [(0, 0)] * 4
    assert ts._pieces(16, 8) == [(2 * k, 2 * k + 2) for k in range(8)]


# ------------------------------------------------------------------- decode


@functools.cache
def _decode_case(L, T=236):
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 16, (L, T)).astype(np.int32)
    si = rng.integers(0, 4096, L).astype(np.int32)  # 4081-4095: the parse clamp
    w = rng.integers(-20000, 20000, (L, 4)).astype(np.int32)
    h = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    want = np.asarray(jd.decode_blocks(codes, si, w, h, bits_per_sample=4, engine="scan"))
    return (codes, si, w, h), want


@pytest.mark.parametrize("engine", ["auto", "pallas"])
@pytest.mark.parametrize("L", [13, 100])
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_decode_sharded_matches_unsharded(shape, L, engine):
    args, want = _decode_case(L)
    mesh = _mesh(shape)
    out = ts.decode_blocks_sharded(*map(torch.from_numpy, args), bits_per_sample=4, mesh=mesh, engine=engine)
    _on_mesh(out, mesh)
    assert [s.shape[0] for s in out] == [b - a for a, b in ts._pieces(L, 8)]
    got = ts.gather(out, CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_sharded_matches_aad_tpu_sharded():
    """At (4, 2): the port's shards against aad_tpu's sharded decode on the virtual mesh."""
    args, _ = _decode_case(100)
    want = js.decode_blocks_sharded(*map(jnp.asarray, args), bits_per_sample=4, mesh=js.make_mesh(8), engine="scan")
    got = ts.decode_blocks_sharded(*map(torch.from_numpy, args), bits_per_sample=4, mesh=_mesh((4, 2)))
    np.testing.assert_array_equal(ts.gather(got, CPU).numpy(), np.asarray(want))


def test_decode_sharded_rejects_unknown_engine():
    args, _ = _decode_case(13)
    with pytest.raises(ValueError, match="unknown decode engine"):
        ts.decode_blocks_sharded(*map(torch.from_numpy, args), bits_per_sample=4, mesh=_mesh((4, 2)), engine="scan")


# ------------------------------------------------------------ stream encode


@functools.partial(jax.jit, static_argnums=2)
def _encode_streams_jit(blocks, valid, trials):
    """aad_tpu's unsharded sequential encode of every stream, one compile a case."""
    return jax.vmap(lambda b, v: je.encode_stream_blocks(b, v, 4, trials))(blocks, valid)


@functools.cache
def _streams_case(S, B, trials, nspb=60, short=41):
    rng = np.random.default_rng(100 * S + 10 * B + trials)
    blocks = rng.integers(-20000, 20000, (S, B, 2, nspb)).astype(np.int32)
    valid = np.full((S, B), nspb, dtype=np.int32)
    valid[:, -1] = short
    blocks[:, -1, :, short:] = 0  # zero-padded past the last block's valid samples
    h, c = _encode_streams_jit(jnp.asarray(blocks), jnp.asarray(valid), trials)
    headers = je.BlockHeaderFields(*map(np.asarray, h))
    codes = np.asarray(c).astype(np.uint8)
    recon = np.asarray(jd.decode_blocks(codes, headers.step_index, headers.weight, headers.history,
                                        bits_per_sample=4, engine="scan")).astype(np.float64)
    live = np.arange(nspb)[None, None, None, :] < valid[..., None, None]
    err = np.where(live, (recon - blocks) / 32768.0, 0.0)
    rmse = float(np.sqrt((err**2).sum() / np.broadcast_to(live, err.shape).sum()))
    return (blocks, valid), (headers, codes), rmse


STREAM_CASES = [(5, 3, 1), (7, 2, 2), (5, 2, 0)]  # S = 5 leaves three of 8 shards empty


@pytest.mark.parametrize("S,B,trials", STREAM_CASES)
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_encode_streams_sharded_matches_unsharded(shape, S, B, trials):
    (blocks, valid), (want_h, want_c), want_rmse = _streams_case(S, B, trials)
    mesh = _mesh(shape)
    headers, codes, rmse = ts.encode_streams_sharded(
        torch.from_numpy(blocks), torch.from_numpy(valid), bits_per_sample=4, num_trials=trials, mesh=mesh,
        stat=True,
    )
    _on_mesh(codes, mesh)
    for field in headers:
        _on_mesh(field, mesh)
    assert [c.shape[0] for c in codes] == [b - a for a, b in ts._pieces(S, 8)]
    got_c = ts.gather(codes, CPU)
    assert got_c.dtype == torch.uint8
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    for got, want in zip(ts.gather(headers, CPU), want_h):
        np.testing.assert_array_equal(got.numpy(), want)
    assert rmse.dtype == torch.float32 and rmse.device == mesh.shard_devices[0]
    assert abs(float(rmse) - want_rmse) < STAT_TOL
    assert 0.0 < float(rmse) < 0.3


def test_encode_streams_sharded_stat_matches_aad_tpu_and_is_opt_in():
    (blocks, valid), (want_h, want_c), _ = _streams_case(7, 2, 2)
    jh, jc, jstat = js.encode_streams_sharded(jnp.asarray(blocks), jnp.asarray(valid), bits_per_sample=4,
                                              num_trials=2, mesh=js.make_mesh(8), stat=True)
    # gather takes a whole result: headers, codes and the statistic
    headers, codes, rmse = ts.gather(ts.encode_streams_sharded(
        torch.from_numpy(blocks), torch.from_numpy(valid), bits_per_sample=4, num_trials=2, mesh=_mesh((4, 2)),
        stat=True,
    ), CPU)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    for got, want in zip(headers, jh):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert abs(float(rmse) - float(jstat)) < STAT_TOL
    _, _, off = ts.gather(ts.encode_streams_sharded(torch.from_numpy(blocks[:2]), torch.from_numpy(valid[:2]),
                                                    bits_per_sample=4, num_trials=0, mesh=_mesh((4, 2))), CPU)
    assert off is None


def test_encode_streams_sharded_takes_int16_and_rejects_out_of_range():
    (blocks, valid), (_, want_c), _ = _streams_case(5, 2, 0)
    mesh = _mesh((2, 4))
    _, codes, _ = ts.encode_streams_sharded(torch.from_numpy(blocks.astype(np.int16)), torch.from_numpy(valid),
                                            bits_per_sample=4, num_trials=0, mesh=mesh)
    np.testing.assert_array_equal(ts.gather(codes, CPU).numpy(), want_c)
    loud = blocks.copy()
    loud[4, 1, 1, 7] = 32768
    with pytest.raises(InvalidFormatError):
        ts.encode_streams_sharded(torch.from_numpy(loud), torch.from_numpy(valid), bits_per_sample=4,
                                  num_trials=0, mesh=mesh)
    with pytest.raises(InvalidArgumentError):
        ts.encode_streams_sharded(torch.from_numpy(blocks.astype(np.float32)), torch.from_numpy(valid),
                                  bits_per_sample=4, num_trials=0, mesh=mesh)
