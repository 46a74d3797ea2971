"""aad_tpu_torch.encode(..., device="cpu") against aad_tpu.encode(..., engine="scan").

The port's encoder must write the same .aad bytes as aad_tpu's scan engine
(and so as the C reference) for every configuration: stereo and mono, bps
2/3/4, mid/side, trials 0-2, ragged tails, the block-parallel modes and the
chunked sequential path that chains the predictor carry. PCM comes from
numpy seeds; streams are a few blocks of small geometries.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import aad_tpu
from aad_tpu.codec.encoder import EncodeConfig as JaxEncodeConfig

import aad_tpu_torch
import aad_tpu_torch.codec.encoder as enc_mod
from aad_tpu_torch import EncodeConfig, Encoder
from aad_tpu_torch.ops import encode_pass, fused_encode


def _pcm(seed, nch, n, loud=False):
    rng = np.random.default_rng(seed)
    if loud:
        return rng.integers(-32768, 32768, (nch, n)).astype(np.int32)
    t = np.arange(n)
    tone = 9000 * np.sin(t / (7.0 + 3 * np.arange(nch))[:, None])
    return (tone + rng.normal(0, 900, (nch, n))).astype(np.int32)


def _configs(nch, bps, bsize, ms=False, trials=2):
    args = dict(num_channels=nch, sampling_rate=44100, bits_per_sample=bps, max_block_size=bsize,
                ch_process_method=int(ms), num_encode_trials=trials)
    return JaxEncodeConfig(**args), EncodeConfig(**args)


def _both(pcm, nch, bps, bsize, ms=False, trials=2, **kw):
    jcfg, tcfg = _configs(nch, bps, bsize, ms, trials)
    want = aad_tpu.encode(pcm, jcfg, engine="scan", **kw)
    got = aad_tpu_torch.encode(pcm, tcfg, device="cpu", **kw)
    return got, want


@pytest.mark.parametrize(
    "nch,bps,ms,trials,bsize,tail,loud",
    [
        (2, 4, False, 2, 128, 37, False),
        (1, 4, False, 2, 96, 0, True),
        (2, 3, False, 1, 160, 5, False),
        (1, 3, False, 2, 96, 1, False),
        (2, 2, False, 2, 96, 3, True),
        (1, 2, False, 0, 96, 11, False),
        (2, 4, True, 2, 96, 2, True),
        (2, 3, True, 1, 128, 0, False),
        (2, 4, False, 0, 320, 41, False),
    ],
)
def test_sequential_bytes_match_scan_engine(nch, bps, ms, trials, bsize, tail, loud):
    """``tail`` samples short of whole blocks: 1-3 leaves a last block with
    fewer than four valid samples (the reference's early return)."""
    nspb = _configs(nch, bps, bsize)[1].geometry().num_samples_per_block
    n = 4 * nspb - tail if tail else 3 * nspb
    got, want = _both(_pcm(nch * 100 + bps, nch, n, loud), nch, bps, bsize, ms, trials)
    assert got == want


@pytest.mark.parametrize(
    "chunk_blocks,warm_passes,ms,trials",
    [(1, 0, False, 2), (1, 0, True, 1), (3, 0, False, 2), (2, 2, False, 2), (1, 1, True, 2), (8, 0, False, 1)],
)
def test_parallel_bytes_match_scan_engine(chunk_blocks, warm_passes, ms, trials):
    nch, bps, bsize = 2, 4, 96
    nspb = _configs(nch, bps, bsize)[1].geometry().num_samples_per_block
    got, want = _both(
        _pcm(chunk_blocks * 10 + warm_passes, nch, 7 * nspb - 9), nch, bps, bsize, ms, trials,
        parallel_blocks=True, parallel_chunk_blocks=chunk_blocks, parallel_warm_passes=warm_passes,
    )
    assert got == want


def test_parallel_equals_concatenated_single_block_encodes():
    """chunk_blocks=1: each block is a stream head, so block i's bytes are
    those of a one-block encode of its samples; chunk_blocks >= num_blocks
    gives the sequential bytes."""
    _, cfg = _configs(1, 4, 96)
    nspb = cfg.geometry().num_samples_per_block
    pcm = _pcm(5, 1, 3 * nspb)
    par = aad_tpu_torch.encode(pcm, cfg, device="cpu", parallel_blocks=True)
    singles = [aad_tpu_torch.encode(pcm[:, i * nspb : (i + 1) * nspb], cfg, device="cpu") for i in range(3)]
    header = aad_tpu_torch.FILE_HEADER_SIZE
    assert par[header:] == b"".join(s[header:] for s in singles)
    seq = aad_tpu_torch.encode(pcm, cfg, device="cpu")
    assert aad_tpu_torch.encode(pcm, cfg, device="cpu", parallel_blocks=True, parallel_chunk_blocks=3) == seq


@pytest.mark.parametrize("nch,ms,trials", [(2, False, 2), (2, True, 1), (1, False, 0)])
def test_chunked_sequential_encode_equals_one_shot(monkeypatch, nch, ms, trials):
    """Chunks chain the carry, so the chunked bytes equal the one-shot
    encode; constants shrunk so that the stream crosses several chunks,
    with a ragged final block in a ragged final chunk."""
    _, cfg = _configs(nch, 4, 96, ms, trials)
    nspb = cfg.geometry().num_samples_per_block
    pcm = _pcm(nch + trials, nch, 11 * nspb - 37)
    one_shot = aad_tpu_torch.encode(pcm, cfg, device="cpu")
    monkeypatch.setattr(enc_mod, "_OVERLAP_CHUNK_BLOCKS", 4)
    monkeypatch.setattr(enc_mod, "_OVERLAP_MIN_BLOCKS", 6)
    before = encode_pass.launches[encode_pass.PASS_KERNEL]
    chunked = aad_tpu_torch.encode(pcm, cfg, device="cpu")
    assert chunked == one_shot
    assert chunked == aad_tpu.encode(pcm, _configs(nch, 4, 96, ms, trials)[0], engine="scan")
    assert encode_pass.launches[encode_pass.PASS_KERNEL] == before  # the CPU launches nothing


@pytest.mark.parametrize("nch,bps,ms", [(2, 4, False), (2, 3, True), (1, 2, False)])
def test_round_trip_through_the_port_decoder(nch, bps, ms):
    _, cfg = _configs(nch, bps, 128, ms)
    nspb = cfg.geometry().num_samples_per_block
    pcm = _pcm(7, nch, 5 * nspb - 17)
    data = aad_tpu_torch.encode(pcm, cfg, device="cpu")
    header, got = aad_tpu_torch.decode(data, device="cpu")
    _, want = aad_tpu.decode(data)
    assert header.num_samples == pcm.shape[1]
    np.testing.assert_array_equal(got, want)
    err = got.astype(np.float64) - pcm
    snr = 10 * np.log10((pcm.astype(np.float64) ** 2).sum() / (err**2).sum())
    assert snr > 5.0


def test_encode_payload_ondevice_is_the_payload():
    _, cfg = _configs(2, 4, 96)
    pcm = _pcm(8, 2, 500)
    data = aad_tpu_torch.encode(pcm, cfg, device="cpu")
    enc = Encoder.from_config(cfg, device="cpu", parallel_blocks=False)
    payload = enc.encode_payload_ondevice(torch.from_numpy(pcm.astype(np.int16)))
    assert payload.dtype == torch.uint8 and payload.device.type == "cpu"
    assert payload.numpy().tobytes() == data[aad_tpu_torch.FILE_HEADER_SIZE :]
    assert enc.encode(pcm.astype(np.int16)) == data  # int16 input skips the range check


@pytest.mark.parametrize(
    "bad",
    [
        dict(bits_per_sample=0),
        dict(bits_per_sample=5),
        dict(bits_per_sample=1),  # passes validate, fails at header encode
        dict(max_block_size=20),
        dict(ch_process_method=2),
        dict(num_channels=3),
        dict(num_channels=0),
    ],
)
def test_config_errors_match_aad_tpu(bad):
    args = dict(num_channels=2, sampling_rate=8000, bits_per_sample=4, max_block_size=128)
    args.update(bad)
    pcm = np.zeros((max(args["num_channels"], 1), 300), dtype=np.int32)
    with pytest.raises(aad_tpu.AadError) as want:
        aad_tpu.encode(pcm, JaxEncodeConfig(**args), engine="scan")
    with pytest.raises(aad_tpu_torch.AadError) as got:
        aad_tpu_torch.encode(pcm, EncodeConfig(**args), device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    assert got.value.result.value == want.value.result.value


def test_pcm_errors():
    _, cfg = _configs(2, 4, 96)
    with pytest.raises(aad_tpu_torch.InvalidArgumentError):
        aad_tpu_torch.encode(np.zeros((1, 50), np.int32), cfg, device="cpu")
    with pytest.raises(aad_tpu_torch.InvalidFormatError):
        aad_tpu_torch.encode(np.zeros((2, 0), np.int32), cfg, device="cpu")
    with pytest.raises(aad_tpu_torch.InvalidFormatError, match="int16"):
        aad_tpu_torch.encode(np.full((2, 50), 40000, np.int32), cfg, device="cpu")
    with pytest.raises(aad_tpu_torch.InvalidArgumentError):
        Encoder.from_config(cfg, device="cpu").encode_payload_ondevice(torch.zeros((2, 50), dtype=torch.int32))


def test_cuda_encode_without_a_gpu_raises(monkeypatch):
    """device="cuda" with no card raises; it does not encode on the CPU."""
    _, cfg = _configs(1, 4, 96)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = dict(fused_encode.launches)
    with pytest.raises(RuntimeError, match="cuda"):
        aad_tpu_torch.encode(np.zeros((1, 100), np.int32), cfg, device="cuda")
    assert fused_encode.launches == before
