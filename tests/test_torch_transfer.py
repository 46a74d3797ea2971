"""The transfer path of the port's one-shot decode() and encode(), on the CPU.

``decode()`` runs its blocks in chunks of ``_TRANSFER_CHUNK_BLOCKS`` through
``codec.transfer.Transfer`` (pinned buffers and CUDA streams on a card, the
same chunk loop in order on the CPU); ``encode()`` stages its PCM as host
blocks and runs the carry-chained chunks of the sequential mode through it.
With the chunk constants shrunk by monkeypatch, the chunked results must
equal ``aad_tpu`` (``engine="scan"``) and the port's unchunked resident
paths: one chunk, several, a ragged tail, mid/side, a lenient truncated
stream, both decode engines, both encode modes. ``"auto"`` must never reach
the native engine at any entry point. Streams are a few blocks of small
geometries; PCM comes from numpy seeds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import aad_tpu
from aad_tpu.codec.encoder import EncodeConfig as JaxEncodeConfig
from aad_tpu.format.wav import WavFormat, write_wav

import aad_tpu_torch
import aad_tpu_torch.cli as torch_cli
import aad_tpu_torch.codec.decoder as dec_mod
import aad_tpu_torch.codec.encoder as enc_mod
from aad_tpu_torch import EncodeConfig, FILE_HEADER_SIZE, native
from aad_tpu_torch.codec.transfer import Transfer, host_parallel
from aad_tpu_torch.format.framing import BlockStates, assemble_stream, build_block_headers


def _random_stream(seed, nch, bps, ms, bsize, nblocks, tail):
    """A valid stream of random codes and states: ``nblocks`` blocks, the
    last one ``tail`` samples short of whole."""
    geo = aad_tpu_torch.compute_block_geometry(bsize, nch, bps)
    n = nblocks * geo.num_samples_per_block - tail
    header = aad_tpu_torch.HeaderInfo(
        num_channels=nch, num_samples=n, sampling_rate=16000, bits_per_sample=bps, block_size=geo.block_size,
        num_samples_per_block=geo.num_samples_per_block, ch_process_method=int(ms),
    )
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**bps, (nblocks, nch, geo.codes_per_block), dtype=np.uint8)
    states = BlockStates.from_numpy((
        rng.integers(0, 4096, (nblocks, nch)), rng.integers(-20000, 20000, (nblocks, nch, 4)),
        rng.integers(-32768, 32768, (nblocks, nch, 4)),
    ))
    payload = assemble_stream(build_block_headers(states, np.zeros((nblocks, nch), np.int32), geo), codes, geo, n)
    return aad_tpu_torch.encode_header(header) + payload.numpy().tobytes()


def _resident(data, engine, strict=True):
    """The unchunked path: the whole payload on the device at once."""
    header = aad_tpu_torch.decode_header(data[:FILE_HEADER_SIZE])
    dec = aad_tpu_torch.Decoder.from_header(header, device="cpu", engine=engine)
    return dec.decode_payload_ondevice(np.frombuffer(data[FILE_HEADER_SIZE:], np.uint8), strict=strict)


# --- decode ------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 3, 4, 64])  # every block its own chunk; a ragged last chunk; even; one chunk
@pytest.mark.parametrize("engine", ["fused", "pallas"])
@pytest.mark.parametrize("nch,bps,ms", [(2, 4, False), (2, 3, True), (1, 2, False)])
def test_chunked_decode_matches_aad_tpu_and_the_resident_path(monkeypatch, chunk, engine, nch, bps, ms):
    monkeypatch.setattr(dec_mod, "_TRANSFER_CHUNK_BLOCKS", chunk)
    data = _random_stream(chunk + nch * bps, nch, bps, ms, 96, 12, 37)
    h, got = aad_tpu_torch.decode(data, device="cpu", engine=engine)
    assert got.dtype == np.int32 and got.shape == (nch, h.num_samples) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, np.asarray(aad_tpu.decode(data, engine="scan")[1]))
    np.testing.assert_array_equal(got, _resident(data, engine).numpy())


@pytest.mark.parametrize("cut", [1, 60, 96, 5 * 96 + 11])
@pytest.mark.parametrize("engine", ["fused", "pallas"])
def test_chunked_lenient_decode_matches_aad_tpu_and_the_resident_path(monkeypatch, cut, engine):
    """A stream cut inside a block, inside a block header and on a block
    boundary, decoded leniently in chunks of 3 blocks: the chunk that holds
    the cut reads its missing bytes as zero codes, the tail is zero."""
    monkeypatch.setattr(dec_mod, "_TRANSFER_CHUNK_BLOCKS", 3)
    data = _random_stream(cut, 2, 4, False, 96, 11, 5)[:-cut]
    with pytest.raises(aad_tpu_torch.InsufficientDataError):
        aad_tpu_torch.decode(data, device="cpu", engine=engine)
    _, got = aad_tpu_torch.decode(data, device="cpu", engine=engine, strict=False)
    np.testing.assert_array_equal(got, np.asarray(aad_tpu.decode(data, engine="scan", strict=False)[1]))
    np.testing.assert_array_equal(got, _resident(data, engine, strict=False).numpy())


def test_lenient_decode_of_a_stream_with_no_whole_block_header(monkeypatch):
    monkeypatch.setattr(dec_mod, "_TRANSFER_CHUNK_BLOCKS", 2)
    data = _random_stream(4, 2, 4, False, 96, 3, 0)
    cut = data[: FILE_HEADER_SIZE + 10]
    h, got = aad_tpu_torch.decode(cut, device="cpu", strict=False)
    assert got.shape == (2, h.num_samples) and not got.any()
    np.testing.assert_array_equal(got, np.asarray(aad_tpu.decode(cut, engine="scan", strict=False)[1]))


# --- encode ------------------------------------------------------------------


def _configs(nch, bps, bsize, ms=False, trials=2):
    args = dict(num_channels=nch, sampling_rate=16000, bits_per_sample=bps, max_block_size=bsize,
                ch_process_method=int(ms), num_encode_trials=trials)
    return JaxEncodeConfig(**args), EncodeConfig(**args)


def _pcm(seed, nch, n):
    rng = np.random.default_rng(seed)
    tone = 9000 * np.sin(np.arange(n) / (5.0 + 4 * rng.random((nch, 1))))
    return (tone + rng.normal(0, 900, (nch, n))).astype(np.int32)


@pytest.mark.parametrize("chunk,min_blocks", [(2, 3), (3, 3), (64, 128)])  # chunks with a ragged last; one launch
@pytest.mark.parametrize("nch,ms,trials", [(2, False, 2), (2, True, 1), (1, False, 0)])
def test_chunked_encode_matches_aad_tpu_and_the_resident_path(monkeypatch, chunk, min_blocks, nch, ms, trials):
    """The sequential encode from host blocks: each chunk goes up and its
    bytes come down through the transfer path, the carry chained between."""
    monkeypatch.setattr(enc_mod, "_OVERLAP_CHUNK_BLOCKS", chunk)
    monkeypatch.setattr(enc_mod, "_OVERLAP_MIN_BLOCKS", min_blocks)
    jcfg, tcfg = _configs(nch, 4, 96, ms, trials)
    nspb = tcfg.geometry().num_samples_per_block
    pcm = _pcm(chunk * 10 + nch, nch, 7 * nspb + 2)  # 8 blocks, the last of 2 samples
    got = aad_tpu_torch.encode(pcm, tcfg, device="cpu")
    assert got == aad_tpu.encode(pcm, jcfg, engine="scan")
    enc = aad_tpu_torch.Encoder.from_config(tcfg, device="cpu")
    resident = enc.encode_payload_ondevice(torch.from_numpy(pcm.astype(np.int16)))
    assert got[FILE_HEADER_SIZE:] == resident.numpy().tobytes()


@pytest.mark.parametrize("chunk_blocks,warm_passes", [(1, 0), (3, 1)])
def test_parallel_encode_from_host_blocks_matches_aad_tpu(chunk_blocks, warm_passes):
    jcfg, tcfg = _configs(2, 3, 128, ms=True)
    nspb = tcfg.geometry().num_samples_per_block
    pcm = _pcm(5, 2, 5 * nspb - 13).astype(np.float64)  # a float input: truncated toward zero, as astype does
    kw = dict(parallel_blocks=True, parallel_chunk_blocks=chunk_blocks, parallel_warm_passes=warm_passes)
    got = aad_tpu_torch.encode(pcm + 0.5 * np.sign(pcm), tcfg, device="cpu", **kw)
    assert got == aad_tpu.encode(pcm.astype(np.int32), jcfg, engine="scan", **kw)


def test_stage_blocks_writes_int16_blocks_and_checks_the_range():
    pcm = np.arange(2 * 23, dtype=np.int32).reshape(2, 23) - 20
    blocks = np.full((3, 2, 10), 7, np.int16)
    enc_mod._stage_blocks(pcm, blocks)
    want = np.zeros((2, 30), np.int16)
    want[:, :23] = pcm
    np.testing.assert_array_equal(blocks, want.reshape(2, 3, 10).transpose(1, 0, 2))
    with pytest.raises(aad_tpu_torch.InvalidFormatError):
        enc_mod._stage_blocks(pcm * 2000, blocks)


def test_host_parallel_covers_the_range_once_and_raises_from_a_slice(monkeypatch):
    monkeypatch.setattr("os.cpu_count", lambda: 4)
    seen = []
    host_parallel(lambda lo, hi: seen.append((lo, hi)), 1001, 1 << 20)  # 4 threads
    assert len(seen) == 4 and sorted(seen)[0][0] == 0 and sorted(seen)[-1][1] == 1001
    assert sum(hi - lo for lo, hi in seen) == 1001 and len({lo for lo, _ in seen}) == 4
    seen.clear()
    host_parallel(lambda lo, hi: seen.append((lo, hi)), 1001, 1)  # too small to split
    assert seen == [(0, 1001)]

    def part(lo, hi):
        if lo > 0:
            raise aad_tpu_torch.InvalidFormatError("slice")

    with pytest.raises(aad_tpu_torch.InvalidFormatError):
        host_parallel(part, 1001, 1 << 20)


def test_stage_blocks_over_threads_matches_one_thread(monkeypatch):
    """A signal large enough for several threads: the same blocks as one
    thread's copy, and a sample out of range in a later slice raises."""
    monkeypatch.setattr("os.cpu_count", lambda: 4)
    nspb = 992
    pcm = np.random.default_rng(7).integers(-32768, 32768, (2, 1100 * nspb + 5)).astype(np.int32)
    blocks = np.empty((1101, 2, nspb), np.int16)
    enc_mod._stage_blocks(pcm, blocks)
    want = np.zeros((2, 1101 * nspb), np.int16)
    want[:, : pcm.shape[1]] = pcm
    np.testing.assert_array_equal(blocks, want.reshape(2, 1101, nspb).transpose(1, 0, 2))
    pcm[1, 900 * nspb] = 40000
    with pytest.raises(aad_tpu_torch.InvalidFormatError):
        enc_mod._stage_blocks(pcm, blocks)


def test_transfer_on_the_cpu_copies_rows_into_a_strided_host_view():
    xfer = Transfer(torch.device("cpu"))
    host = xfer.host((2, 10), torch.int32)
    host.zero_()
    src = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    assert xfer.upload(src) is src
    xfer.download(src, host[:, 3:7])
    xfer.finish()
    want = np.zeros((2, 10), np.int32)
    want[:, 3:7] = src.numpy()
    np.testing.assert_array_equal(host.numpy(), want)
    assert not host.is_pinned()


# --- auto never reaches the native engine --------------------------------------


@pytest.fixture
def native_forbidden(monkeypatch):
    """Every function of aad_tpu_torch.native that runs the engine raises."""

    def forbidden(*args, **kwargs):
        raise AssertionError("engine='auto' reached the native engine")

    for name in ("library", "build", "available", "decode", "encode", "encode_parallel", "stream_state",
                 "encode_chunk", "decode_payload_blocks", "decode_batch", "encode_batch"):
        monkeypatch.setattr(native, name, forbidden)


def test_auto_never_reaches_the_native_engine(native_forbidden, tmp_path, monkeypatch, capsys):
    _, tcfg = _configs(2, 4, 96)
    pcm = _pcm(1, 2, 300)
    data = aad_tpu_torch.encode(pcm, tcfg, device="cpu")
    assert data == aad_tpu_torch.encode(pcm, tcfg, device="cpu", engine="auto")
    aad_tpu_torch.encode(pcm, tcfg, device="cpu", parallel_blocks=True)
    aad_tpu_torch.decode(data, device="cpu")
    aad_tpu_torch.decode(data[:-20], device="cpu", strict=False)
    aad_tpu_torch.decode_batch([data, data], device="cpu")
    aad_tpu_torch.encode_batch([pcm, pcm], tcfg, device="cpu")
    enc = aad_tpu_torch.StreamingEncoder(tcfg, device="cpu")
    assert enc.push(pcm) + enc.finish() == data[FILE_HEADER_SIZE:]
    aad_tpu_torch.StreamingDecoder(device="cpu").push(data)
    aad_tpu_torch.transcode(data, device="cpu", bits_per_sample=2)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), WavFormat(2, 16000, 16, 300), pcm << 16)
    aad_tpu_torch.encode_file(str(wav), str(tmp_path / "o.aad"), max_block_size=96, device="cpu")
    aad_tpu_torch.decode_file(str(tmp_path / "o.aad"), str(tmp_path / "o.wav"), device="cpu")
    for key in ("AAD_TPU_ENGINE", "AAD_TPU_STRICT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("AAD_TPU_PLATFORM", "cpu")
    assert torch_cli.main(["-r", "-s", "96", str(wav), str(tmp_path / "r.wav")]) == 0
    capsys.readouterr()
