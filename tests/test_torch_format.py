"""aad_tpu_torch's host layer and framing against aad_tpu, on the same inputs.

Geometry, the file header, code packing, block-header parsing and stream
assembly are integer functions, so the port must agree exactly. Inputs come
from numpy with fixed seeds; both packages get the same arrays.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import aad_tpu
from aad_tpu.format import framing as jf
from aad_tpu.format import geometry as jg
from aad_tpu.ops import bitpack as jb

import aad_tpu_torch
from aad_tpu_torch.format import framing as tf
from aad_tpu_torch.format import geometry as tg
from aad_tpu_torch.ops import bitpack as tb

REPO = pathlib.Path(__file__).resolve().parents[1]
GRID = [
    (bps, nch, block)
    for bps in (2, 3, 4)
    for nch in (1, 2)
    for block in (96, 250, 1024)
]


def _random_states(rng, nb, nch):
    """States as the bench stream draws them, with wire indices up to 4095."""
    return jf.BlockStates(
        step_index=rng.integers(0, 4096, (nb, nch)).astype(np.int32),
        weight=rng.integers(-20000, 20000, (nb, nch, 4)).astype(np.int32),
        history=rng.integers(-32768, 32768, (nb, nch, 4)).astype(np.int32),
    )


def _header(mod, geo, num_samples, ms=False):
    return mod.HeaderInfo(
        num_channels=geo.num_channels,
        num_samples=num_samples,
        sampling_rate=44100,
        bits_per_sample=geo.bits_per_sample,
        block_size=geo.block_size,
        num_samples_per_block=geo.num_samples_per_block,
        ch_process_method=int(ms),
    )


@pytest.mark.parametrize("bps,nch,block", GRID)
def test_geometry_matches(bps, nch, block):
    want = jg.compute_block_geometry(block, nch, bps)
    got = tg.compute_block_geometry(block, nch, bps)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tg.calculate_block_size(block, nch, bps) == jg.calculate_block_size(block, nch, bps)
    assert dataclasses.asdict(
        tg.geometry_from_header(nch, bps, got.block_size)
    ) == dataclasses.asdict(jg.geometry_from_header(nch, bps, want.block_size))
    nspb = want.num_samples_per_block
    for n in (1, 4, 5, nspb - 1, nspb, nspb + 1, 7 * nspb - 3):
        assert tg.encoded_stream_size(got, n) == jg.encoded_stream_size(want, n)
        assert tg.num_blocks_for(n, nspb) == jg.num_blocks_for(n, nspb)
        size = jg.encoded_stream_size(want, n)
        for cut in (0, 1, want.header_bytes - 1, want.header_bytes, size // 2, size - 1, size):
            assert tg.lenient_prefix(got, n, cut) == jg.lenient_prefix(want, n, cut)


@pytest.mark.parametrize("bps,nch,block", GRID)
def test_bitpack_matches(bps, nch, block):
    geo = jg.compute_block_geometry(block, nch, bps)
    tgeo = tg.compute_block_geometry(block, nch, bps)
    rng = np.random.default_rng(bps * 100 + nch * 10 + block)
    data = rng.integers(0, 256, (3, geo.data_bytes), dtype=np.uint8)
    want = jb.unpack_codes(data, geo)
    got_np = tb.unpack_codes(data, tgeo)
    got_t = tb.unpack_codes(torch.from_numpy(data), tgeo)
    assert isinstance(got_np, np.ndarray) and isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert got_t.dtype == torch.uint8

    codes = rng.integers(0, 2**bps, (3, nch, geo.codes_per_block), dtype=np.uint8)
    want_bytes = jb.pack_codes(codes, geo)
    np.testing.assert_array_equal(tb.pack_codes(codes, tgeo), want_bytes)
    np.testing.assert_array_equal(tb.pack_codes(torch.from_numpy(codes), tgeo).numpy(), want_bytes)
    np.testing.assert_array_equal(tb.unpack_codes(want_bytes, tgeo), codes)


@pytest.mark.parametrize("bps,nch,block", GRID)
def test_framing_matches(bps, nch, block):
    """build_block_headers / assemble_stream / split / parse / frame == aad_tpu."""
    geo = jg.compute_block_geometry(block, nch, bps)
    tgeo = tg.compute_block_geometry(block, nch, bps)
    rng = np.random.default_rng(bps * 1000 + nch * 100 + block)
    nb = 5
    ns = nb * geo.num_samples_per_block - 3  # ragged final block
    states = _random_states(rng, nb, nch)
    shifts = rng.integers(0, 3, (nb, nch)).astype(np.int32)
    # weights pre-rounded to their shift, as the encoder leaves them
    states = states._replace(weight=(states.weight >> shifts[..., None]) << shifts[..., None])
    codes = rng.integers(0, 2**bps, (nb, nch, geo.codes_per_block), dtype=np.uint8)

    want_hdr = jf.build_block_headers(states, shifts, geo)
    got_hdr = tf.build_block_headers(tf.BlockStates.from_numpy(states), shifts, tgeo)
    np.testing.assert_array_equal(got_hdr.numpy(), want_hdr)
    want_payload = jf.assemble_stream(want_hdr, codes, geo, ns)
    got_payload = tf.assemble_stream(got_hdr, codes, tgeo, ns)
    np.testing.assert_array_equal(got_payload.numpy(), want_payload)

    header = _header(aad_tpu, geo, ns)
    want = jf.frame_stream(want_payload, header, geo)
    got = tf.frame_stream(torch.from_numpy(want_payload), _header(aad_tpu_torch, tgeo, ns), tgeo)
    assert (got.num_blocks, got.valid_last) == (want.num_blocks, want.valid_last)
    np.testing.assert_array_equal(got.codes.numpy(), want.codes)
    for g, w in zip(got.states, want.states):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    # the parse clamp: wire indices 4081-4095 load as 4080
    assert int(got.states.step_index.max()) <= 4080

    with pytest.raises(aad_tpu_torch.InsufficientDataError):
        tf.split_blocks(torch.from_numpy(want_payload[:-1]), _header(aad_tpu_torch, tgeo, ns), tgeo)


@pytest.mark.parametrize("nch", [1, 2])
def test_parse_block_headers_clamps_wire_indices(nch):
    """Raw header bytes with 12-bit indices 4081-4095 parse as aad_tpu does."""
    geo = jg.compute_block_geometry(256, nch, 4)
    rng = np.random.default_rng(11 + nch)
    blocks = rng.integers(0, 256, (64, geo.block_size), dtype=np.uint8)
    for ch in range(nch):  # force the top 8 bits of each tag to 0xFF
        blocks[:, 18 * ch] = 0xFF
    want = jf.parse_block_headers(blocks, geo)
    got = tf.parse_block_headers(torch.from_numpy(blocks), tg.compute_block_geometry(256, nch, 4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert set(np.unique(got.step_index.numpy())) == {4080}


def test_block_states_roundtrip():
    rng = np.random.default_rng(5)
    states = _random_states(rng, 4, 2)
    got = tf.BlockStates.from_numpy(states).to("cpu")
    for g, w in zip(got, states):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("ms", [False, True])
def test_header_roundtrip_matches(ms):
    geo = jg.compute_block_geometry(1024, 2, 4)
    want = _header(aad_tpu, geo, 123456, ms)
    data = aad_tpu.encode_header(want)
    assert aad_tpu_torch.encode_header(_header(aad_tpu_torch, geo, 123456, ms)) == data
    got = aad_tpu_torch.decode_header(data)
    assert dataclasses.asdict(got) == dataclasses.asdict(aad_tpu.decode_header(data))
    aad_tpu_torch.validate_header(got)


@pytest.mark.parametrize(
    "field,value,error",
    [
        ("num_channels", 3, "InvalidFormatError"),
        ("bits_per_sample", 5, "InvalidFormatError"),
        ("block_size", 30, "InvalidFormatError"),
        ("ch_process_method", 2, "InvalidFormatError"),
        ("codec_version", 17, "InvalidFormatError"),
    ],
)
def test_header_validation_matches(field, value, error):
    geo = jg.compute_block_geometry(1024, 2, 4)
    for mod in (aad_tpu, aad_tpu_torch):
        h = dataclasses.replace(_header(mod, geo, 1000), **{field: value})
        with pytest.raises(getattr(mod, error)):
            mod.validate_header(h)
    with pytest.raises(aad_tpu_torch.InsufficientDataError):
        aad_tpu_torch.decode_header(b"AAD\x00" + bytes(10))
    with pytest.raises(aad_tpu_torch.InvalidFormatError):
        aad_tpu_torch.decode_header(b"XAD\x00" + bytes(27))


def test_import_pulls_in_no_jax():
    """The port imports torch and numpy only: never jax, never aad_tpu. Every
    module of the package is imported, found by walking it, with jax and
    aad_tpu blocked (an import of either raises); ``__main__``, which runs
    the CLI, is only listed."""
    code = (
        "import importlib, pkgutil, sys;"
        "sys.modules.update(dict.fromkeys(('jax', 'jaxlib', 'aad_tpu'), None));"
        "import aad_tpu_torch;"
        "mods = [m.name for m in pkgutil.walk_packages(aad_tpu_torch.__path__, 'aad_tpu_torch.')];"
        "[importlib.import_module(m) for m in mods if m != 'aad_tpu_torch.__main__'];"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'aad_tpu')"
        " and sys.modules[m] is not None);"
        "need = {'aad_tpu_torch.ops.lms', 'aad_tpu_torch.ops.fused_encode', 'aad_tpu_torch.codec.streaming',"
        " 'aad_tpu_torch.io', 'aad_tpu_torch.format.wav', 'aad_tpu_torch.codec.batch_encode',"
        " 'aad_tpu_torch.utils.quality', 'aad_tpu_torch.utils.debug', 'aad_tpu_torch.utils.profiling',"
        " 'aad_tpu_torch.utils.time_encode', 'aad_tpu_torch.cli', 'aad_tpu_torch.cliparse',"
        " 'aad_tpu_torch.__main__', 'aad_tpu_torch.native', 'aad_tpu_torch.codec.transfer'};"
        "print(len(mods), bad, sorted(need - set(mods))); sys.exit(1 if bad or need - set(mods) else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
