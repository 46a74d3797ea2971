"""The port's native host engine against aad_tpu.native and the port's CPU path.

``aad_tpu_torch.native`` builds its own copy of ``aad_tpu``'s ``aadx.cc``
with the host compiler into ``build/``. Its outputs must equal
``aad_tpu.native``'s and the port's ``device="cpu"`` path (the plain torch
versions of the kernels): decodes strict and lenient, whole-block spans,
sequential and block-parallel encodes with their chunk and warm knobs, the
streaming carry of ``encode_chunk``, both batches, the error types, step
indices 4081-4095 and the AVX-512 path against the scalar one
(``AADX_FORCE_SCALAR``). One difference is pinned, not merged: a forged
encode carry's step index, which the native engine clamps to [0, 4080] and
the port (like ``aad_tpu``'s scan engine) keeps, clipping the table slot.
Every ``engine="native"`` entry point of the port is held against
``aad_tpu``'s. PCM comes from numpy seeds; the streams the plain torch
engine encodes are a few blocks of small geometries.
"""

from __future__ import annotations

import functools
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aad_tpu
from aad_tpu import native as jax_native
from aad_tpu.codec.encoder import EncodeConfig as JaxEncodeConfig
from aad_tpu.format.wav import WavFormat, write_wav

import aad_tpu_torch
from aad_tpu_torch import EncodeConfig, FILE_HEADER_SIZE, native
from aad_tpu_torch.codec.result import InsufficientDataError, InvalidArgumentError, InvalidFormatError
from aad_tpu_torch.format.framing import BlockStates, assemble_stream, build_block_headers
from aad_tpu_torch.format.geometry import num_blocks_for

REPO = pathlib.Path(__file__).resolve().parents[1]

# (channels, bps, max block size, mid/side, trials): small geometries, a
# block size of 387 (an odd interleave), mono
GEOMETRIES = [(2, 4, 96, False, 2), (2, 3, 128, True, 1), (1, 2, 96, False, 0), (2, 4, 387, False, 2)]


def _configs(nch, bps, bsize, ms=False, trials=2):
    args = dict(num_channels=nch, sampling_rate=16000, bits_per_sample=bps, max_block_size=bsize,
                ch_process_method=int(ms), num_encode_trials=trials)
    return JaxEncodeConfig(**args), EncodeConfig(**args)


def _pcm(seed, nch, n):
    rng = np.random.default_rng(seed)
    tone = 9000 * np.sin(np.arange(n) / (5.0 + 4 * rng.random((nch, 1))))
    return (tone + rng.normal(0, 900, (nch, n))).astype(np.int32)


def _random_stream(seed, nch, bps, ms, bsize, n, step_high=4096):
    """A valid stream of random codes and block states, step indices up to
    ``step_high`` - 1 (past 4080 only on a malformed stream)."""
    geo = aad_tpu_torch.compute_block_geometry(bsize, nch, bps)
    header = aad_tpu_torch.HeaderInfo(
        num_channels=nch, num_samples=n, sampling_rate=16000, bits_per_sample=bps, block_size=geo.block_size,
        num_samples_per_block=geo.num_samples_per_block, ch_process_method=int(ms),
    )
    nb = num_blocks_for(n, geo.num_samples_per_block)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**bps, (nb, nch, geo.codes_per_block), dtype=np.uint8)
    states = BlockStates.from_numpy((
        rng.integers(0, step_high, (nb, nch)), rng.integers(-20000, 20000, (nb, nch, 4)),
        rng.integers(-32768, 32768, (nb, nch, 4)),
    ))
    payload = assemble_stream(build_block_headers(states, np.zeros((nb, nch), np.int32), geo), codes, geo, n)
    return aad_tpu_torch.encode_header(header) + payload.numpy().tobytes()


@pytest.mark.parametrize("name", ["aadx.cc", "aadx.h"])
def test_sources_are_aad_tpus_below_the_note(name):
    """The copy is aad_tpu's source with a note after its first two lines
    (the lines naming aad_tpu_torch, then one empty comment line)."""
    ours = (REPO / "aad_tpu_torch" / "native" / name).read_text().splitlines()
    theirs = (REPO / "aad_tpu" / "native" / name).read_text().splitlines()
    note = [i for i, line in enumerate(ours) if "aad_tpu_torch" in line]
    assert note and note[0] == 2
    assert ours[:2] + ours[note[-1] + 2 :] == theirs


def test_the_library_lands_under_build():
    path = native.build()
    assert path.name == "libaadx.so" and (REPO / "build" / "aad_tpu_torch") in path.parents
    assert native.available() and native.resolve("native") is native and native.resolve("auto") is None


# --- decode ------------------------------------------------------------------


@pytest.mark.parametrize("nch,bps,bsize,ms,trials", GEOMETRIES)
def test_decode_matches_aad_tpu_native_and_the_port(nch, bps, bsize, ms, trials):
    jcfg, tcfg = _configs(nch, bps, bsize, ms, trials)
    nspb = tcfg.geometry().num_samples_per_block
    for data in (native.encode(_pcm(bps, nch, 5 * nspb - 3), tcfg),
                 _random_stream(nch * bps, nch, bps, ms, bsize, 6 * nspb + 2)):
        h, got = native.decode(data)
        jh, want = jax_native.decode(data)
        _, port = aad_tpu_torch.decode(data, device="cpu")
        assert got.dtype == np.int32 and got.shape == (nch, h.num_samples)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, port)
        assert vars(h) == vars(jh)
        _, entry = aad_tpu_torch.decode(data, engine="native")
        np.testing.assert_array_equal(entry, got)


@pytest.mark.parametrize("cut", [1, 40, 96 - 10, 96, 96 + 17, 2 * 96 + 5])
def test_lenient_decode_matches_aad_tpu_and_the_port(cut):
    """A stream cut inside a block, inside a block header, on a block
    boundary: strict raises, lenient decodes the blocks that hold their
    header with the missing bytes as zero codes."""
    _, tcfg = _configs(2, 4, 96)
    data = native.encode(_pcm(7, 2, 9 * tcfg.geometry().num_samples_per_block + 5), tcfg)[:-cut]
    with pytest.raises(InsufficientDataError):
        aad_tpu_torch.decode(data, engine="native")
    _, got = aad_tpu_torch.decode(data, engine="native", strict=False)
    _, want = aad_tpu.decode(data, engine="native", strict=False)
    _, port = aad_tpu_torch.decode(data, device="cpu", strict=False)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, port)


def test_decode_payload_blocks_matches_aad_tpu_and_the_port():
    _, tcfg = _configs(2, 3, 128, True)
    nspb = tcfg.geometry().num_samples_per_block
    data = _random_stream(5, 2, 3, True, 128, 7 * nspb - 9)
    h = aad_tpu_torch.decode_header(data[:FILE_HEADER_SIZE])
    payload = np.frombuffer(data[FILE_HEADER_SIZE:], np.uint8)
    for nblocks in (1, 3, 7):
        span = np.zeros(nblocks * h.block_size + 4, np.uint8)
        take = min(payload.size, nblocks * h.block_size)
        span[:take] = payload[:take]
        n = min(nblocks * nspb, h.num_samples)
        got = native.decode_payload_blocks(span, h, n)
        want = jax_native.decode_payload_blocks(span, aad_tpu.decode_header(data[:FILE_HEADER_SIZE]), n)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, aad_tpu_torch.decode(data, device="cpu")[1][:, :n])


def test_step_indices_4081_to_4095_clamp_to_4080_in_every_path(monkeypatch):
    """The parse clamp at 4080, which every engine of both packages shares:
    a stream whose block headers carry 4081-4095 decodes as with 4080."""
    _, tcfg = _configs(1, 4, 128)
    nspb = tcfg.geometry().num_samples_per_block
    data = bytearray(native.encode(_pcm(3, 1, 16 * nspb), tcfg))
    clamped = bytearray(data)
    for b, idx in enumerate(range(4081, 4096)):
        at = FILE_HEADER_SIZE + b * 128
        shift = data[at + 1] & 0xF
        data[at : at + 2] = ((idx << 4) | shift).to_bytes(2, "big")
        clamped[at : at + 2] = ((4080 << 4) | shift).to_bytes(2, "big")
    _, want = aad_tpu_torch.decode(bytes(clamped), device="cpu")
    np.testing.assert_array_equal(aad_tpu_torch.decode(bytes(data), device="cpu")[1], want)
    np.testing.assert_array_equal(jax_native.decode(bytes(data))[1], want)
    for scalar in ("0", "1"):
        monkeypatch.setenv("AADX_FORCE_SCALAR", scalar)
        np.testing.assert_array_equal(native.decode(bytes(data))[1], want)


# --- encode ------------------------------------------------------------------


@pytest.mark.parametrize("nch,bps,bsize,ms,trials", GEOMETRIES)
def test_encode_matches_aad_tpu_native_and_the_port(nch, bps, bsize, ms, trials):
    jcfg, tcfg = _configs(nch, bps, bsize, ms, trials)
    nspb = tcfg.geometry().num_samples_per_block
    pcm = _pcm(nch * 10 + bps, nch, 3 * nspb + 2)  # a last block of 2 samples
    got = native.encode(pcm, tcfg)
    assert got == jax_native.encode(pcm, jcfg)
    assert got == aad_tpu_torch.encode(pcm, tcfg, device="cpu")
    assert got == aad_tpu_torch.encode(pcm, tcfg, engine="native")
    assert got == aad_tpu_torch.Encoder.from_config(tcfg, device="cpu").encode(pcm, engine="native")


@pytest.mark.parametrize("chunk_blocks,warm_passes", [(1, 0), (2, 1), (3, 0), (4, 2)])
def test_encode_parallel_matches_aad_tpu_native_and_the_port(chunk_blocks, warm_passes):
    jcfg, tcfg = _configs(2, 4, 96, ms=warm_passes % 2 == 1)
    nspb = tcfg.geometry().num_samples_per_block
    pcm = _pcm(chunk_blocks + 10 * warm_passes, 2, 7 * nspb - 11)
    kw = dict(parallel_blocks=True, parallel_chunk_blocks=chunk_blocks, parallel_warm_passes=warm_passes)
    got = native.encode_parallel(pcm, tcfg, chunk_blocks, warm_passes)
    assert got == jax_native.encode_parallel(pcm, jcfg, chunk_blocks=chunk_blocks, warm_passes=warm_passes)
    assert got == aad_tpu_torch.encode(pcm, tcfg, device="cpu", **kw)
    assert got == aad_tpu_torch.encode(pcm, tcfg, engine="native", **kw)
    enc = aad_tpu_torch.Encoder.from_config(tcfg, device="cpu", **kw)
    assert got == enc.encode(pcm, engine="native")


@pytest.mark.parametrize("ms,trials", [(False, 2), (True, 1)])
def test_encode_chunk_chain_matches_streaming_encoder(ms, trials):
    """The native carry across uneven pushes equals the port's
    StreamingEncoder on the CPU, aad_tpu's native engine, and the one-shot
    encode."""
    jcfg, tcfg = _configs(2, 4, 96, ms, trials)
    nspb = tcfg.geometry().num_samples_per_block
    pcm = _pcm(11, 2, 5 * nspb + 7)
    cuts = [0, nspb - 5, nspb + 3, 4 * nspb, pcm.shape[1]]
    ours = aad_tpu_torch.StreamingEncoder(tcfg, engine="native")
    port = aad_tpu_torch.StreamingEncoder(tcfg, device="cpu")
    theirs = aad_tpu.StreamingEncoder(jcfg, engine="native")
    got = [ours.push(pcm[:, a:b]) for a, b in zip(cuts, cuts[1:])] + [ours.finish()]
    assert got == [port.push(pcm[:, a:b]) for a, b in zip(cuts, cuts[1:])] + [port.finish()]
    assert got == [theirs.push(pcm[:, a:b]) for a, b in zip(cuts, cuts[1:])] + [theirs.finish()]
    assert ours.header() + b"".join(got) == native.encode(pcm, tcfg)
    # by hand: whole blocks, then the tail
    state, prev = native.stream_state(tcfg)
    whole = 4 * nspb
    by_hand = native.encode_chunk(pcm[:, :whole], tcfg, state, prev, 0)
    by_hand += native.encode_chunk(pcm[:, whole:], tcfg, state, prev, 4)
    assert by_hand == b"".join(got)


def test_forged_carry_difference_is_pinned():
    """A carry state that no encoder writes: step index 5000. The native
    engine clamps it to [0, 4080] on load (aadx.cc: the carry load), so it
    encodes as 4080; the port keeps it and clips the step table's slot, as
    aad_tpu's scan engine does, and writes other bytes. Both stay as they
    are: this test holds the difference."""
    jcfg, tcfg = _configs(1, 4, 96, trials=0)
    nspb = tcfg.geometry().num_samples_per_block
    pcm = _pcm(21, 1, 4 * nspb)
    first, rest = pcm[:, : 2 * nspb], pcm[:, 2 * nspb :]

    def native_bytes(idx):
        state, prev = native.stream_state(tcfg)
        native.encode_chunk(first, tcfg, state, prev, 0)
        state[:, 8] = idx
        return native.encode_chunk(rest, tcfg, state, prev, 2)

    port = aad_tpu_torch.StreamingEncoder(tcfg, device="cpu")
    scan = aad_tpu.StreamingEncoder(jcfg, engine="scan")
    assert port.push(first) == scan.push(first)
    port._carry = (port._carry[0]._replace(step_index=torch.full((1,), 5000, dtype=torch.int32)), port._carry[1])
    scan._carry = (scan._carry[0]._replace(step_index=jnp.full((1,), 5000, jnp.int32)), scan._carry[1])
    forged = port.push(rest)
    assert forged == scan.push(rest)  # the port follows the scan engine
    assert native_bytes(5000) == native_bytes(4080) == native_bytes(2**31 - 1)
    assert native_bytes(-4096) == native_bytes(0)
    assert forged != native_bytes(5000)  # the pinned difference


# --- batches -------------------------------------------------------------------


def test_decode_batch_matches_aad_tpu_and_the_port():
    streams = [_random_stream(s, nch, bps, ms, bsize, n)
               for s, (nch, bps, ms, bsize, n) in enumerate([(2, 4, False, 96, 700), (1, 3, False, 128, 333),
                                                             (2, 2, True, 96, 1000), (2, 4, False, 96, 51)])]
    got = aad_tpu_torch.decode_batch(streams, engine="native")
    want = aad_tpu.decode_batch(streams, engine="native")
    port = aad_tpu_torch.decode_batch(streams, device="cpu")
    assert [vars(h) for h, _ in got] == [vars(h) for h, _ in want]
    for (_, g), (_, w), (_, p) in zip(got, want, port):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    assert [h for h, _ in native.decode_batch(streams, max_workers=3)] == [h for h, _ in got]


@pytest.mark.parametrize("parallel", [False, True])
def test_encode_batch_matches_aad_tpu_and_the_port(parallel):
    jcfg, tcfg = _configs(2, 4, 96, ms=parallel)
    nspb = tcfg.geometry().num_samples_per_block
    pile = [_pcm(s, 2, n) for s, n in enumerate([nspb - 9, 3 * nspb + 2, 2 * nspb, 40])]
    kw = dict(parallel_blocks=parallel, parallel_chunk_blocks=2 if parallel else 1,
              parallel_warm_passes=1 if parallel else 0)
    got = aad_tpu_torch.encode_batch(pile, tcfg, engine="native", **kw)
    assert got == aad_tpu.encode_batch(pile, jcfg, engine="native", **kw)
    assert got == aad_tpu_torch.encode_batch(pile, tcfg, device="cpu", **kw)


# --- errors --------------------------------------------------------------------


def test_error_types_match_aad_tpu_and_the_port():
    jcfg, tcfg = _configs(2, 4, 96)
    data = native.encode(_pcm(1, 2, 500), tcfg)
    cases = [data[:-3], b"XAD\x00" + data[4:], data[:20]]
    for bad, exc in zip(cases, (InsufficientDataError, InvalidFormatError, InsufficientDataError)):
        with pytest.raises(exc):
            native.decode(bad)
        with pytest.raises(exc):
            aad_tpu_torch.decode(bad, engine="native")
        with pytest.raises(exc):
            aad_tpu_torch.decode(bad, device="cpu")
        with pytest.raises(Exception) as theirs:
            jax_native.decode(bad)
        assert type(theirs.value).__name__ == exc.__name__
    bad_bps = EncodeConfig(2, 16000, 5, 96)
    with pytest.raises(InvalidFormatError):
        native.encode(_pcm(1, 2, 500), bad_bps)
    with pytest.raises(InvalidFormatError):
        aad_tpu_torch.encode(_pcm(1, 2, 500), bad_bps, engine="native")
    with pytest.raises(InvalidArgumentError):
        native.encode(_pcm(1, 1, 500), tcfg)  # channels != config
    with pytest.raises(InvalidArgumentError):
        native.encode_parallel(_pcm(1, 2, 500), tcfg, chunk_blocks=0)
    with pytest.raises(InvalidArgumentError):
        native.encode_chunk(_pcm(1, 2, 500), tcfg, np.zeros((2, 8), np.int32), np.zeros((2, 92), np.int32), 0)
    with pytest.raises(InvalidArgumentError):
        aad_tpu_torch.encode(_pcm(1, 2, 500), tcfg, engine="scan")
    with pytest.raises(InvalidFormatError):  # outside int16: the port's contract on every engine
        aad_tpu_torch.encode(_pcm(1, 2, 500) * 8, tcfg, engine="native")


def test_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    """No silent failure: a build that fails raises NativeBuildError, from
    the bindings and from every engine="native" entry point."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.delenv("AAD_TPU_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native, "build", functools.partial(native.build, tmp_path / "build"))
    native.library.cache_clear()
    try:
        with pytest.raises(native.NativeBuildError, match="failed"):
            native.library()
        assert not native.available()
        _, tcfg = _configs(1, 4, 96)
        with pytest.raises(native.NativeBuildError):
            aad_tpu_torch.encode(_pcm(1, 1, 300), tcfg, engine="native")
        with pytest.raises(native.NativeBuildError):
            aad_tpu_torch.StreamingDecoder(engine="native")
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        with pytest.raises(native.NativeBuildError, match="not found"):
            native.library()
    finally:
        native.library.cache_clear()


def test_native_lib_override(monkeypatch, tmp_path):
    """AAD_TPU_NATIVE_LIB names a prebuilt library; a path that does not
    exist raises."""
    built = native.build()
    native.library.cache_clear()
    try:
        monkeypatch.setenv("AAD_TPU_NATIVE_LIB", str(tmp_path / "missing.so"))
        with pytest.raises(FileNotFoundError):
            native.library()
        native.library.cache_clear()
        monkeypatch.setenv("AAD_TPU_NATIVE_LIB", str(built))
        _, tcfg = _configs(1, 4, 96)
        assert native.decode(native.encode(_pcm(2, 1, 300), tcfg))[1].shape == (1, 300)
    finally:
        native.library.cache_clear()


# --- SIMD and scalar -------------------------------------------------------------


@pytest.mark.parametrize("nch,bps,ms,bsize,chunk,warm", [
    (2, 4, False, 1024, 1, 0), (2, 4, True, 1024, 3, 1), (1, 2, False, 256, 1, 0), (2, 3, False, 387, 1, 0),
])
def test_scalar_matches_simd(monkeypatch, nch, bps, ms, bsize, chunk, warm):
    """AADX_FORCE_SCALAR=1 forces the scalar path at every dispatch gate;
    the bytes and samples equal the AVX-512 path's (where the host has it)
    and aad_tpu's native engine."""
    jcfg, tcfg = _configs(nch, bps, bsize, ms)
    nspb = tcfg.geometry().num_samples_per_block
    pcm = _pcm(bps * 10 + nch, nch, 37 * nspb + 11)
    runs = {}
    for scalar in ("0", "1"):
        monkeypatch.setenv("AADX_FORCE_SCALAR", scalar)
        seq = native.encode(pcm, tcfg)
        par = native.encode_parallel(pcm, tcfg, chunk, warm)
        runs[scalar] = (seq, par, native.decode(seq)[1], native.decode(par)[1])
        assert seq == jax_native.encode(pcm, jcfg)
        assert par == jax_native.encode_parallel(pcm, jcfg, chunk_blocks=chunk, warm_passes=warm)
    assert runs["0"][:2] == runs["1"][:2]
    for a, b in zip(runs["0"][2:], runs["1"][2:]):
        np.testing.assert_array_equal(a, b)


# --- the other entry points ----------------------------------------------------


def test_streaming_decoder_matches_aad_tpu_and_the_port():
    data = _random_stream(9, 2, 4, False, 96, 1234)
    pushes = [0, 10, 31, 200, 201, 700, len(data)]
    ours = aad_tpu_torch.StreamingDecoder(engine="native")
    port = aad_tpu_torch.StreamingDecoder(device="cpu")
    theirs = aad_tpu.StreamingDecoder(engine="native")
    for a, b in zip(pushes, pushes[1:]):
        got = ours.push(data[a:b])
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, port.push(data[a:b]))
        np.testing.assert_array_equal(got, theirs.push(data[a:b]))


def test_transcode_and_files_match_aad_tpu(tmp_path):
    _, tcfg = _configs(2, 4, 96)
    data = native.encode(_pcm(4, 2, 900), tcfg)
    kw = dict(bits_per_sample=2, max_block_size=128, ch_process_method=1)
    got = aad_tpu_torch.transcode(data, engine="native", **kw)
    assert got == aad_tpu.transcode(data, engine="native", **kw)
    assert got == aad_tpu_torch.transcode(data, device="cpu", **kw)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), WavFormat(2, 16000, 16, 900), _pcm(4, 2, 900).astype(np.int32) << 16)
    h = aad_tpu_torch.encode_file(str(wav), str(tmp_path / "t.aad"), max_block_size=96, ms=True, engine="native")
    aad_tpu.encode_file(str(wav), str(tmp_path / "j.aad"), max_block_size=96, ms=True, engine="native")
    assert (tmp_path / "t.aad").read_bytes() == (tmp_path / "j.aad").read_bytes()
    assert h.num_samples == 900
    aad_tpu_torch.decode_file(str(tmp_path / "t.aad"), str(tmp_path / "t.wav"), engine="native")
    aad_tpu.decode_file(str(tmp_path / "t.aad"), str(tmp_path / "j.wav"), engine="native")
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
