"""The port's decode slice as a whole against aad_tpu, on the CPU.

``aad_tpu_torch.decode(data, device="cpu")`` must return exactly what
``aad_tpu.decode(data, engine="scan")`` returns, for the same .aad bytes:
streams encoded by aad_tpu (a sine and noise) and random-code streams built
as the benchmark builds its stream, across bit depths, channel counts,
mid/side and ragged tails, in strict and lenient mode. Sizes are a few
blocks per geometry.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import aad_tpu
from aad_tpu.format.framing import BlockStates, assemble_stream, build_block_headers
from aad_tpu.format.geometry import compute_block_geometry, num_blocks_for

import aad_tpu_torch
from aad_tpu_torch.ops import fused_decode


def random_code_stream(seed, nch, bps, ms, max_block_size, num_samples):
    """A valid .aad stream with random codes and states, as bench.py builds one."""
    geo = compute_block_geometry(max_block_size, nch, bps)
    header = aad_tpu.HeaderInfo(
        num_channels=nch, num_samples=num_samples, sampling_rate=48000,
        bits_per_sample=bps, block_size=geo.block_size,
        num_samples_per_block=geo.num_samples_per_block, ch_process_method=int(ms),
    )
    nb = num_blocks_for(num_samples, geo.num_samples_per_block)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**bps, (nb, nch, geo.codes_per_block), dtype=np.uint8)
    states = BlockStates(
        step_index=rng.integers(0, 4096, (nb, nch)).astype(np.int32),
        weight=rng.integers(-20000, 20000, (nb, nch, 4)).astype(np.int32),
        history=rng.integers(-32768, 32768, (nb, nch, 4)).astype(np.int32),
    )
    hdr = build_block_headers(states, np.zeros((nb, nch), np.int32), geo)
    payload = assemble_stream(hdr, codes, geo, num_samples)
    return aad_tpu.encode_header(header) + np.asarray(payload).tobytes()


def encoded_stream(kind, nch, bps, ms, max_block_size=256, n=2500):
    rng = np.random.default_rng(3)
    t = np.arange(n)
    if kind == "sine":
        sig = (12000 * np.sin(2 * np.pi * 440 * t / 8000)).astype(np.int32)
        pcm = np.stack([sig, np.roll(sig, 7)])[:nch]
    else:
        pcm = rng.integers(-32768, 32768, (nch, n)).astype(np.int32)
    cfg = aad_tpu.EncodeConfig(
        num_channels=nch, sampling_rate=8000, bits_per_sample=bps,
        max_block_size=max_block_size, ch_process_method=int(ms),
    )
    return aad_tpu.encode(pcm, cfg)


def assert_same_decode(data, strict=True):
    h_want, want = aad_tpu.decode(data, engine="scan", strict=strict)
    h_got, got = aad_tpu_torch.decode(data, device="cpu", strict=strict)
    assert vars(h_got) == vars(h_want)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


LAYOUTS = [(1, False), (2, False), (2, True)]  # (channels, mid/side)


@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("nch,ms", LAYOUTS)
def test_random_code_stream_matches(bps, nch, ms):
    """Random codes, wire indices up to 4095, ragged final block."""
    nspb = compute_block_geometry(128, nch, bps).num_samples_per_block
    data = random_code_stream(bps * 10 + nch + 3 * ms, nch, bps, ms, 128, 6 * nspb - 17)
    assert_same_decode(data)


@pytest.mark.parametrize("kind", ["sine", "noise"])
@pytest.mark.parametrize("nch,ms,bps", [(1, False, 3), (2, True, 4), (2, False, 2)])
def test_encoded_stream_matches(kind, nch, ms, bps):
    assert_same_decode(encoded_stream(kind, nch, bps, ms))


@pytest.mark.parametrize("cut", [1, 40, 300, -1])
def test_truncated_stream_strict_raises_lenient_matches(cut):
    data = random_code_stream(99, 2, 4, True, 128, 700)
    # cut > 0 keeps that many payload bytes; cut < 0 drops bytes from the end
    cut_data = data[: aad_tpu.FILE_HEADER_SIZE + cut] if cut > 0 else data[:cut]
    with pytest.raises(aad_tpu_torch.InsufficientDataError):
        aad_tpu_torch.decode(cut_data, device="cpu")
    with pytest.raises(aad_tpu.InsufficientDataError):
        aad_tpu.decode(cut_data, engine="scan")
    got = assert_same_decode(cut_data, strict=False)
    if cut < 0:  # only the last block is short: most of the stream decodes
        assert np.any(got[:, :100])


def test_decoder_api_matches():
    """Decoder.frame / decode_framed / decode_payload_ondevice on the CPU."""
    data = random_code_stream(5, 2, 4, False, 256, 1000)
    header = aad_tpu_torch.decode_header(data)
    payload = np.frombuffer(data, np.uint8)[aad_tpu_torch.FILE_HEADER_SIZE:]
    dec = aad_tpu_torch.Decoder.from_header(header, device="cpu")
    jdec = aad_tpu.Decoder.from_header(aad_tpu.decode_header(data), engine="scan")
    framed, jframed = dec.frame(payload), jdec.frame(payload)
    np.testing.assert_array_equal(framed.codes.numpy(), jframed.codes)
    for g, w in zip(framed.states, jframed.states):
        np.testing.assert_array_equal(g.numpy(), w)
    want = np.asarray(jdec.decode_framed(jframed))
    got = dec.decode_framed(framed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ondevice = dec.decode_payload_ondevice(torch.from_numpy(payload.copy()))
    assert ondevice.dtype == torch.int16 and ondevice.device.type == "cpu"
    np.testing.assert_array_equal(ondevice.numpy(), want)
    assert fused_decode.launches[fused_decode.DECODE_KERNEL] == 0
    with pytest.raises(aad_tpu_torch.InvalidArgumentError):
        dec.decode_payload_ondevice(torch.from_numpy(payload.astype(np.int32)))


def test_chip_smoke_stream_is_the_bench_stream():
    """chip_smoke.py builds bench.py's stream with the port's own framing."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    )
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    num_samples = 7 * 992 - 5
    got, header = chip_smoke.bench_stream(num_samples)
    # bench.py::build_synthetic_stream, line for line, through aad_tpu
    cfg = aad_tpu.EncodeConfig(num_channels=2, sampling_rate=48000)
    geo = cfg.geometry()
    nblocks = num_blocks_for(num_samples, geo.num_samples_per_block)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, (nblocks, 2, geo.codes_per_block), dtype=np.uint8)
    states = BlockStates(
        step_index=rng.integers(0, 4081, (nblocks, 2)).astype(np.int32),
        weight=rng.integers(-20000, 20000, (nblocks, 2, 4)).astype(np.int32),
        history=rng.integers(-32768, 32768, (nblocks, 2, 4)).astype(np.int32),
    )
    hdr = build_block_headers(states, np.zeros((nblocks, 2), np.int32), geo)
    payload = assemble_stream(hdr, codes, geo, num_samples)
    want = aad_tpu.encode_header(cfg.header_for(num_samples)) + np.asarray(payload).tobytes()
    assert got == want
    assert vars(header) == vars(cfg.header_for(num_samples))
    assert_same_decode(got)


def test_bad_streams_raise_like_aad_tpu():
    data = bytearray(random_code_stream(6, 1, 4, False, 128, 300))
    for mutate, error in (
        (lambda d: d.__setitem__(0, ord("X")), "InvalidFormatError"),  # magic
        (lambda d: d.__setitem__(11, 17), "InvalidFormatError"),  # codec version
        (lambda d: d.__setitem__(slice(12, 14), b"\x00\x03"), "InvalidFormatError"),  # channels
    ):
        bad = bytearray(data)
        mutate(bad)
        with pytest.raises(getattr(aad_tpu, error)):
            aad_tpu.decode(bytes(bad), engine="scan")
        with pytest.raises(getattr(aad_tpu_torch, error)):
            aad_tpu_torch.decode(bytes(bad), device="cpu")
    with pytest.raises(aad_tpu_torch.InsufficientDataError):
        aad_tpu_torch.decode(bytes(data[:20]), device="cpu")
