"""aad_tpu_torch's random-access, batch, streaming, transcode and file entry
points against aad_tpu, on the CPU.

Each is held against the ``aad_tpu`` function of the same name under
``engine="scan"`` (which avoids aad_tpu's native dispatch), with the error
types pinned too: ``Decoder.decode_block_range`` / ``decode_time_range``,
``decode_batch`` over a pile of geometries, ``StreamingDecoder`` over byte
dribbles and uneven pushes, ``StreamingEncoder`` (chunking invisible,
mid/side with trials, a declared total), ``transcode`` and
``encode_file`` / ``decode_file``. The decode entry points run under both of
the port's engines. Encode streams stay a few blocks of small geometries:
the plain encode engine is slow.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import aad_tpu
import aad_tpu.io
from aad_tpu.codec.batch import decode_batch as jax_decode_batch
from aad_tpu.codec.encoder import EncodeConfig as JaxEncodeConfig
from aad_tpu.codec.streaming import StreamingDecoder as JaxStreamingDecoder
from aad_tpu.codec.streaming import StreamingEncoder as JaxStreamingEncoder
from aad_tpu.format import wav as jax_wav

import aad_tpu_torch
from aad_tpu_torch.codec.streaming import _ByteFIFO
from aad_tpu_torch.format import wav as torch_wav

from util import noise, sine

ENGINES = ["fused", "pallas"]


def _stream(pcm, rate=16000, **kw):
    """An .aad stream of ``pcm`` (aad_tpu's default engine: any conforming
    encoder serves) and the port's config of it."""
    args = dict(num_channels=pcm.shape[0], sampling_rate=rate, **kw)
    return aad_tpu.encode(pcm, JaxEncodeConfig(**args)), aad_tpu_torch.EncodeConfig(**args)


@pytest.fixture(scope="module")
def stereo():
    """A 17-block stereo stream with a ragged last block, its payload and
    aad_tpu's scan decoder of it."""
    data, _ = _stream(noise(1600, 2, seed=7), max_block_size=128)
    payload = np.frombuffer(data, np.uint8)[aad_tpu.FILE_HEADER_SIZE :]
    header = aad_tpu.decode_header(data)
    return data, payload, aad_tpu.Decoder.from_header(header, engine="scan")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("start,count", [(0, 1), (3, 4), (16, 1), (14, 10), (0, 17)])
def test_decode_block_range_matches_aad_tpu(stereo, engine, start, count):
    """Ranges inside the stream, the last block alone (cut to its valid
    samples), a range running past the end, and the whole stream."""
    data, payload, jax_dec = stereo
    dec = aad_tpu_torch.Decoder.from_header(aad_tpu_torch.decode_header(data), device="cpu", engine=engine)
    want = np.asarray(jax_dec.decode_block_range(payload, start, count))
    got = dec.decode_block_range(payload, start, count)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # bytes and a uint8 tensor serve as well as a numpy array
    np.testing.assert_array_equal(dec.decode_block_range(data[aad_tpu.FILE_HEADER_SIZE :], start, count).numpy(), want)
    np.testing.assert_array_equal(dec.decode_block_range(torch.from_numpy(payload.copy()), start, count).numpy(), want)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("start,end", [(0.0, 0.001), (0.0123, 0.0456), (0.05, 0.1), (0.09, 5.0), (-1.0, 1.0)])
def test_decode_time_range_matches_aad_tpu(stereo, engine, start, end):
    data, payload, jax_dec = stereo
    dec = aad_tpu_torch.Decoder.from_header(aad_tpu_torch.decode_header(data), device="cpu", engine=engine)
    want = np.asarray(jax_dec.decode_time_range(payload, start, end))
    np.testing.assert_array_equal(dec.decode_time_range(payload, start, end).numpy(), want)


def test_range_errors_match_aad_tpu(stereo):
    data, payload, jax_dec = stereo
    dec = aad_tpu_torch.Decoder.from_header(aad_tpu_torch.decode_header(data), device="cpu")
    for start, count in ((-1, 2), (17, 1), (5, 0), (40, 3)):
        with pytest.raises(aad_tpu.InvalidArgumentError) as want:
            jax_dec.decode_block_range(payload, start, count)
        with pytest.raises(aad_tpu_torch.InvalidArgumentError) as got:
            dec.decode_block_range(payload, start, count)
        assert str(got.value) == str(want.value)
    for start, end in ((0.05, 0.05), (0.2, 0.1), (2.0, 3.0)):
        with pytest.raises(aad_tpu.InvalidArgumentError):
            jax_dec.decode_time_range(payload, start, end)
        with pytest.raises(aad_tpu_torch.InvalidArgumentError, match="empty time range"):
            dec.decode_time_range(payload, start, end)
    with pytest.raises(aad_tpu.InsufficientDataError) as want:
        jax_dec.decode_block_range(payload[:-1], 0, 1)
    with pytest.raises(aad_tpu_torch.InsufficientDataError) as got:
        dec.decode_block_range(payload[:-1], 0, 1)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def pile():
    """The heterogeneous pile of aad_tpu's batch test, plus a second stream
    of the first geometry so that one group holds two streams."""
    specs = [
        (noise(1500, 1, seed=1), dict(max_block_size=128, bits_per_sample=4)),
        (noise(2300, 2, seed=2), dict(max_block_size=256, bits_per_sample=3)),
        (sine(900, 2), dict(max_block_size=64, bits_per_sample=2, ch_process_method=1)),
        (sine(512, 1), dict(max_block_size=1024, bits_per_sample=4)),
        (noise(700, 1, seed=3), dict(max_block_size=128, bits_per_sample=4)),
    ]
    streams = [_stream(pcm, **kw)[0] for pcm, kw in specs]
    return streams, jax_decode_batch(streams, engine="scan")


@pytest.mark.parametrize("engine", ENGINES)
def test_decode_batch_matches_aad_tpu(pile, engine):
    streams, want = pile
    got = aad_tpu_torch.decode_batch(streams, device="cpu", engine=engine)
    assert len(got) == len(want)
    for (h, pcm), (wh, wpcm), data in zip(got, want, streams):
        assert vars(h) == vars(wh)
        assert pcm.dtype == np.int16 and pcm.shape == (h.num_channels, h.num_samples)
        np.testing.assert_array_equal(pcm, np.asarray(wpcm))
        np.testing.assert_array_equal(pcm, aad_tpu_torch.decode(data, device="cpu", engine=engine)[1])


def test_decode_batch_errors_and_empty():
    assert aad_tpu_torch.decode_batch([], device="cpu") == []
    data, _ = _stream(noise(300, 1, seed=4), max_block_size=128)
    bad = b"XAD" + data[3:]
    for mod, call in ((aad_tpu, lambda: jax_decode_batch([data, bad], engine="scan")),
                      (aad_tpu_torch, lambda: aad_tpu_torch.decode_batch([data, bad], device="cpu"))):
        with pytest.raises(mod.InvalidFormatError):
            call()
    # a payload cut short decodes with the missing bytes as zeros, as in aad_tpu
    cut = [data[:-20], np.frombuffer(data[:-90], np.uint8)]
    for (_, got), (_, want) in zip(aad_tpu_torch.decode_batch(cut, device="cpu"), jax_decode_batch(cut, engine="scan")):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("feed", [1, 7, 64, 100000])
def test_streaming_decoder_byte_dribble(stereo, engine, feed):
    data = stereo[0]
    _, whole = aad_tpu.decode(data, engine="scan")
    dec = aad_tpu_torch.StreamingDecoder(device="cpu", engine=engine)
    assert dec.header is None and dec.push(b"").shape == (0, 0)
    outs = [dec.push(data[off : off + feed]) for off in range(0, len(data), feed)]
    assert all(o.dtype == np.int16 and o.shape[0] == (2 if i * feed + feed >= 31 else 0)
               for i, o in enumerate(outs))
    np.testing.assert_array_equal(np.concatenate([o for o in outs if o.size], axis=1), whole)
    assert dec.header.num_samples == 1600
    assert dec.push(b"trailing bytes are ignored").shape == (2, 0)


def test_streaming_decoder_uneven_pushes_match_aad_tpu(stereo):
    data = stereo[0]
    cuts = np.cumsum(np.random.default_rng(11).integers(1, 400, 40))
    cuts = [0, *(int(c) for c in cuts if c < len(data)), len(data)]
    pieces = [data[a:b] for a, b in zip(cuts, cuts[1:])]
    jax_dec = JaxStreamingDecoder(engine="scan")
    want = [jax_dec.push(p) for p in pieces]
    for engine in ENGINES:
        dec = aad_tpu_torch.StreamingDecoder(device="cpu", engine=engine)
        for p, w in zip(pieces, want):
            np.testing.assert_array_equal(dec.push(p), np.asarray(w))


@pytest.mark.parametrize("engine", ENGINES)
def test_streaming_decoder_header_only_tail_block(engine):
    """A 2-sample last block: on the wire it is its block header alone."""
    nspb = aad_tpu_torch.compute_block_geometry(256, 1, 4).num_samples_per_block
    data, _ = _stream(sine(nspb + 2, 1), max_block_size=256)
    _, whole = aad_tpu.decode(data, engine="scan")
    dec = aad_tpu_torch.StreamingDecoder(device="cpu", engine=engine)
    np.testing.assert_array_equal(dec.push(data), whole)


def test_byte_fifo_split_pops():
    fifo = _ByteFIFO()
    blob = bytes(range(256)) * 40
    for i in range(0, len(blob), 17):
        fifo.append(blob[i : i + 17])
    got = b"".join(fifo.pop(13) for _ in range(len(blob) // 13))
    assert got == blob[: len(got)] and len(fifo) == len(blob) - len(got)
    with pytest.raises(ValueError):
        fifo.pop(len(fifo) + 1)


def _push_all(enc, pcm, chunks):
    payload, off = b"", 0
    for n in chunks:
        payload += enc.push(pcm[:, off : off + n])
        off += n
    return payload + enc.push(pcm[:, off:]) + enc.finish()


@pytest.mark.parametrize("chunks", [[700, 700, 700, 400], [100] * 25, [1, 2499], [2499, 1]])
def test_streaming_encoder_chunking_is_invisible(chunks):
    pcm = noise(2500, 1, seed=5)
    whole, cfg = _stream(pcm, max_block_size=256)
    assert whole == aad_tpu.encode(pcm, JaxEncodeConfig(1, 16000, max_block_size=256), engine="scan")
    enc = aad_tpu_torch.StreamingEncoder(cfg, device="cpu")
    payload = _push_all(enc, pcm, chunks)
    assert enc.header() + payload == whole and enc.num_samples == 2500
    if chunks[0] == 700:
        jax_enc = JaxStreamingEncoder(JaxEncodeConfig(1, 16000, max_block_size=256), engine="scan")
        assert _push_all(jax_enc, pcm, chunks) == payload


def test_streaming_encoder_stereo_ms_with_trials():
    pcm = noise(1400, 2, seed=6)
    pcm[1] = sine(1400, 1)[0]
    whole, cfg = _stream(pcm, max_block_size=128, ch_process_method=1, num_encode_trials=2)
    enc = aad_tpu_torch.StreamingEncoder(cfg, device="cpu")
    payload = _push_all(enc, pcm, [500, 601])
    assert enc.header() + payload == whole


def test_streaming_with_declared_total():
    """Progressive transmission: the header is valid before any data, and a
    StreamingDecoder fed the encoder's output as it comes matches the
    one-shot decode."""
    pcm = noise(1500, 1, seed=21)
    whole, cfg = _stream(pcm, max_block_size=256)
    enc = aad_tpu_torch.StreamingEncoder(cfg, device="cpu", total_samples=1500)
    dec = aad_tpu_torch.StreamingDecoder(device="cpu", engine="pallas")
    stream = enc.header()
    outs = [dec.push(stream)]
    for off in range(0, 1500, 700):
        b = enc.push(pcm[:, off : off + 700])
        stream += b
        outs.append(dec.push(b))
    b = enc.finish()
    stream += b
    outs.append(dec.push(b))
    assert stream == whole and enc.finish() == b""
    _, want = aad_tpu.decode(whole, engine="scan")
    np.testing.assert_array_equal(np.concatenate([o for o in outs if o.size], axis=1), want)


def test_streaming_encoder_errors():
    cfg = aad_tpu_torch.EncodeConfig(num_channels=1, sampling_rate=8000, max_block_size=128)
    jax_cfg = JaxEncodeConfig(num_channels=1, sampling_rate=8000, max_block_size=128)
    for mod, enc in ((aad_tpu, JaxStreamingEncoder(jax_cfg, engine="scan")),
                     (aad_tpu_torch, aad_tpu_torch.StreamingEncoder(cfg, device="cpu"))):
        with pytest.raises(mod.InvalidArgumentError):
            enc.push(np.zeros((2, 10), np.int32))
        with pytest.raises(mod.InvalidArgumentError):
            enc.push(np.zeros(10, np.int32))
        enc.finish()
        with pytest.raises(mod.InvalidArgumentError):
            enc.push(np.zeros((1, 10), np.int32))
    with pytest.raises(aad_tpu_torch.InvalidFormatError, match="int16"):
        aad_tpu_torch.StreamingEncoder(cfg, device="cpu").push(np.full((1, 5), -40000, np.int32))
    with pytest.raises(aad_tpu_torch.InvalidFormatError):
        aad_tpu_torch.StreamingEncoder(aad_tpu_torch.EncodeConfig(1, 8000, 5), device="cpu")


@pytest.fixture(scope="module")
def transcode_source():
    rng = np.random.default_rng(0)
    t = np.arange(1500, dtype=np.float64)
    pcm = np.clip(9000 * np.sin(t / 13.0)[None, :] + rng.integers(-400, 400, (2, 1500)), -32768, 32767)
    return _stream(pcm.astype(np.int32), max_block_size=256)[0]


@pytest.mark.parametrize("kw", [
    dict(bits_per_sample=2),
    dict(bits_per_sample=3, num_encode_trials=1),
    dict(max_block_size=128, ch_process_method=1),
    dict(parallel_blocks=True, parallel_chunk_blocks=2),
])
def test_transcode_matches_aad_tpu(transcode_source, kw):
    want = aad_tpu.transcode(transcode_source, engine="scan", **kw)
    got = aad_tpu_torch.transcode(transcode_source, device="cpu", **kw)
    assert got == want
    if kw.get("bits_per_sample") == 2:
        assert aad_tpu_torch.transcode(transcode_source, device="cpu", engine="pallas", **kw) == want


def test_wav_copy_matches_aad_tpu(tmp_path):
    rng = np.random.default_rng(2)
    for depth in (8, 16, 24, 32):
        canonical = (rng.integers(-(2**31), 2**31, (2, 301)) >> (32 - depth) << (32 - depth)).astype(np.int32)
        fmt = torch_wav.WavFormat(2, 22050, depth, 301)
        torch_wav.write_wav(str(tmp_path / "t.wav"), fmt, canonical)
        jax_wav.write_wav(str(tmp_path / "j.wav"), jax_wav.WavFormat(2, 22050, depth, 301), canonical)
        assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
        got_fmt, got = torch_wav.read_wav(str(tmp_path / "j.wav"))
        assert vars(got_fmt) == vars(fmt)
        np.testing.assert_array_equal(got, canonical)
    (tmp_path / "bad.wav").write_bytes(b"RIFX" + bytes(40))
    with pytest.raises(aad_tpu_torch.InvalidFormatError):
        torch_wav.read_wav(str(tmp_path / "bad.wav"))


@pytest.mark.parametrize("ms,engine", [(False, "fused"), (True, "pallas")])
def test_encode_file_and_decode_file_match_aad_tpu(tmp_path, ms, engine):
    pcm = noise(900, 2, seed=8)
    fmt = jax_wav.WavFormat(2, 16000, 16, 900)
    jax_wav.write_wav(str(tmp_path / "in.wav"), fmt, pcm << 16)
    kw = dict(bits_per_sample=4, max_block_size=128, ms=ms, num_encode_trials=1)
    want = aad_tpu.io.encode_file(str(tmp_path / "in.wav"), str(tmp_path / "j.aad"), engine="scan", **kw)
    got = aad_tpu_torch.encode_file(str(tmp_path / "in.wav"), str(tmp_path / "t.aad"), device="cpu", **kw)
    assert vars(got) == vars(want)
    assert (tmp_path / "t.aad").read_bytes() == (tmp_path / "j.aad").read_bytes()
    want = aad_tpu.io.decode_file(str(tmp_path / "j.aad"), str(tmp_path / "j.wav"), engine="scan")
    got = aad_tpu_torch.decode_file(str(tmp_path / "t.aad"), str(tmp_path / "t.wav"), device="cpu", engine=engine)
    assert vars(got) == vars(want)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
