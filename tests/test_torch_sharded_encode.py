"""aad_tpu_torch.parallel.sharded's sequence-parallel encode, and the whole
slice, on meshes of CPU shards against aad_tpu.

The counterpart of ``tests/test_torch_sharded.py`` (whose helpers it uses)
for ``encode_blocks_parallel_sharded``: every (chunk_blocks, warm_passes)
pair of ``tests/test_sharding.py``'s ring tests at its sizes, on the mesh
shapes (8, 1), (4, 2), (2, 4) and (1, 8) of 8 CPU shards, against
``aad_tpu.ops.encode.encode_blocks_parallel(engine="scan")`` unsharded and,
at (4, 2), against ``aad_tpu.parallel.sharded`` on the virtual CPU mesh;
then ``__graft_entry__``'s multi-chip dry run on the port. A file of its
own, so that each of the two runs well inside a worker's share of the
suite.
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

from aad_tpu_torch import EncodeConfig, InvalidArgumentError, InvalidFormatError
from aad_tpu_torch.parallel import sharded as ts

from test_torch_sharded import CPU, MESH_SHAPES, _encode_streams_jit, _mesh, _on_mesh


def _unpack_words(words, T):
    """aad_tpu's u32 kernel words (8 LSB-first 4-bit slots) -> (..., T) codes."""
    w = np.asarray(words, dtype=np.uint32)
    codes = (w[..., None] >> (4 * np.arange(8, dtype=np.uint32))) & 0xF
    return codes.reshape(*w.shape[:-1], -1)[..., :T].astype(np.uint8)


# -------------------------------------------------- sequence-parallel encode

# (chunk_blocks, warm_passes) -> (B, trials), as tests/test_sharding.py sizes them
PARALLEL_CASES = {(1, 0): (13, 2), (2, 0): (21, 1), (1, 1): (19, 1), (2, 1): (35, 1), (2, 2): (35, 1)}


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _encode_parallel_jit(blocks, valid, trials, c, wp):
    """aad_tpu's unsharded block-parallel encode (scan engine), one compile a case."""
    return je.encode_blocks_parallel(blocks, valid, 4, trials, engine="scan", chunk_blocks=c, warm_passes=wp)


@functools.cache
def _parallel_case(c, wp, nspb=60):
    B, trials = PARALLEL_CASES[c, wp]
    rng = np.random.default_rng(10 * c + wp)
    blocks = rng.integers(-20000, 20000, (B, 2, nspb)).astype(np.int32)
    valid = np.full(B, nspb, dtype=np.int32)
    valid[-1] = nspb - 13
    blocks[-1, :, valid[-1]:] = 0
    h, words = _encode_parallel_jit(jnp.asarray(blocks), jnp.asarray(valid), trials, c, wp)
    return (blocks, valid, trials), ([np.asarray(f) for f in h], _unpack_words(words, nspb - 4))


@pytest.mark.parametrize("c,wp", list(PARALLEL_CASES))
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_encode_blocks_parallel_sharded_matches_unsharded(shape, c, wp):
    (blocks, valid, trials), (want_h, want_c) = _parallel_case(c, wp)
    mesh = _mesh(shape)
    headers, codes = ts.encode_blocks_parallel_sharded(
        torch.from_numpy(blocks), torch.from_numpy(valid), bits_per_sample=4, num_trials=trials, mesh=mesh,
        chunk_blocks=c, warm_passes=wp,
    )
    _on_mesh(codes, mesh)
    B = blocks.shape[0]
    assert [x.shape[0] for x in codes] == [min(b * c, B) - min(a * c, B) for a, b in ts._pieces(-(-B // c), 8)]
    np.testing.assert_array_equal(ts.gather(codes, CPU).numpy(), want_c)
    for got, want in zip(ts.gather(headers, CPU), want_h):
        np.testing.assert_array_equal(got.numpy(), want)


def test_encode_blocks_parallel_sharded_matches_aad_tpu_sharded():
    """At (4, 2), with the warm ring: against aad_tpu's sharded encode on the virtual mesh."""
    (blocks, valid, trials), _ = _parallel_case(2, 1)
    jh, jw = js.encode_blocks_parallel_sharded(jnp.asarray(blocks), jnp.asarray(valid), bits_per_sample=4,
                                               num_trials=trials, mesh=js.make_mesh(8), chunk_blocks=2,
                                               warm_passes=1)
    headers, codes = ts.encode_blocks_parallel_sharded(
        torch.from_numpy(blocks), torch.from_numpy(valid), bits_per_sample=4, num_trials=trials,
        mesh=_mesh((4, 2)), chunk_blocks=2, warm_passes=1,
    )
    np.testing.assert_array_equal(ts.gather(codes, CPU).numpy(), _unpack_words(jw, blocks.shape[-1] - 4))
    for got, want in zip(ts.gather(headers, CPU), jh):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encode_blocks_parallel_sharded_rejects_other_engines_and_range():
    (blocks, valid, _), _ = _parallel_case(1, 0)
    kw = dict(bits_per_sample=4, num_trials=0, mesh=_mesh((4, 2)))
    for engine in ("scan", "pallas"):
        with pytest.raises(InvalidArgumentError):
            ts.encode_blocks_parallel_sharded(torch.from_numpy(blocks), torch.from_numpy(valid), engine=engine, **kw)
    loud = blocks.copy()
    loud[0, 0, 0] = -32769
    with pytest.raises(InvalidFormatError):
        ts.encode_blocks_parallel_sharded(torch.from_numpy(loud), torch.from_numpy(valid), **kw)


# ---------------------------------------------------------- the whole slice


def test_slice_as_in_graft_dryrun():
    """__graft_entry__._dryrun_multichip_impl's sequence at its sizes on an
    8-shard mesh: encode streams sharded (with the stat), decode their codes
    back with lanes S * B * C sharded, then the sequence-parallel encode of
    one stream with a warm pass; every step equal to aad_tpu unsharded."""
    n = 8
    cfg = EncodeConfig(num_channels=2, sampling_rate=16000, max_block_size=64, num_encode_trials=1)
    geo = cfg.geometry()
    nspb, T = geo.num_samples_per_block, geo.codes_per_block
    mesh = ts.make_mesh(n, devices=[CPU] * n)
    S, B = 2 * n, 3
    ns = B * nspb - 5
    rng = np.random.default_rng(0)
    pcm = rng.integers(-20000, 20000, (S, 2, B * nspb)).astype(np.int32)
    pcm[:, :, ns:] = 0
    blocks = np.ascontiguousarray(np.swapaxes(pcm.reshape(S, 2, B, nspb), 1, 2))
    valid = np.full((S, B), nspb, dtype=np.int32)
    valid[:, -1] = ns - (B - 1) * nspb

    headers, codes, stat = ts.encode_streams_sharded(
        torch.from_numpy(blocks), torch.from_numpy(valid), bits_per_sample=4, num_trials=1, mesh=mesh, stat=True,
    )
    assert np.isfinite(float(stat))
    headers, codes = ts.gather(headers, CPU), ts.gather(codes, CPU)
    h_ref, c_ref = _encode_streams_jit(jnp.asarray(blocks), jnp.asarray(valid), 1)  # every stream unsharded
    np.testing.assert_array_equal(codes.numpy(), np.asarray(c_ref))
    for got, want in zip(headers, h_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    L = S * B * 2
    lanes = (codes.reshape(L, T), headers.step_index.reshape(L), headers.weight.reshape(L, 4),
             headers.history.reshape(L, 4))
    out = ts.gather(ts.decode_blocks_sharded(*lanes, bits_per_sample=4, mesh=mesh), CPU)
    assert out.shape == (L, T + 4)
    want = jd.decode_blocks(*(jnp.asarray(x.numpy()) for x in lanes), bits_per_sample=4, engine="scan")
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))

    one = rng.integers(-20000, 20000, (2 * n, 2, nspb)).astype(np.int32)
    valid1 = np.full(2 * n, nspb, dtype=np.int32)
    h_p, c_p = ts.encode_blocks_parallel_sharded(
        torch.from_numpy(one), torch.from_numpy(valid1), bits_per_sample=4, num_trials=1, mesh=mesh,
        chunk_blocks=1, warm_passes=1,
    )
    h_u, w_u = je.encode_blocks_parallel(jnp.asarray(one), jnp.asarray(valid1), 4, 1, engine="scan", warm_passes=1)
    np.testing.assert_array_equal(ts.gather(c_p, CPU).numpy(), _unpack_words(w_u, T))
    for got, want in zip(ts.gather(h_p, CPU), h_u):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
