"""aad_tpu_torch.utils against aad_tpu.utils, on the CPU.

``quality_stats`` and ``roundtrip_stats`` use aad_tpu's numpy formula, so the
floats must be equal; the debug checks raise where aad_tpu's raise, with the
same error; ``Decoder.frame`` runs the framed-stream check in debug mode
only. The out-of-range PCM divergence is pinned on both sides: the port's
encoders raise always, aad_tpu raises the same error in debug mode. The
self-check and the profiling helpers need a card and raise without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import aad_tpu
from aad_tpu.codec.encoder import EncodeConfig as JaxEncodeConfig
from aad_tpu.format.framing import BlockStates as JaxBlockStates
from aad_tpu.format.geometry import compute_block_geometry as jax_geometry
from aad_tpu.utils import debug as jax_debug
from aad_tpu.utils import quality as jax_quality

import aad_tpu_torch
from aad_tpu_torch.format.framing import BlockStates
from aad_tpu_torch.utils import debug, profiling

from util import noise


def _configs(nch, bps=4, bsize=96, trials=2):
    args = dict(num_channels=nch, sampling_rate=16000, bits_per_sample=bps, max_block_size=bsize,
                num_encode_trials=trials)
    return JaxEncodeConfig(**args), aad_tpu_torch.EncodeConfig(**args)


@pytest.fixture
def debug_on():
    """Debug mode on in both packages, restored afterwards."""
    was = (jax_debug.enabled(), debug.enabled())
    jax_debug.enable()
    debug.enable()
    try:
        yield
    finally:
        jax_debug.enable(was[0])
        debug.enable(was[1])


@pytest.mark.parametrize("seed,shape", [(0, (2, 1000)), (1, (1, 7))])
def test_quality_stats_equals_aad_tpu(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.integers(-32768, 32768, shape).astype(np.int32)
    b = np.clip(a + rng.integers(-300, 300, shape), -32768, 32767).astype(np.int32)
    want = jax_quality.quality_stats(a, b)
    got = aad_tpu_torch.quality_stats(torch.from_numpy(a), b)
    assert (got.rmse, got.mean_abs, got.max_abs) == (want.rmse, want.mean_abs, want.max_abs)
    assert str(got) == str(want)


@pytest.mark.parametrize("nch,bps", [(2, 4), (1, 3)])
def test_roundtrip_stats_equals_aad_tpu(nch, bps):
    jcfg, tcfg = _configs(nch, bps)
    pcm = noise(300, nch, seed=nch + bps)
    got = aad_tpu_torch.roundtrip_stats(pcm, tcfg, device="cpu")
    want = jax_quality.roundtrip_stats(pcm, jcfg, engine="scan")
    assert got == aad_tpu_torch.QualityStats(want.rmse, want.mean_abs, want.max_abs)
    assert got.rmse > 0


def _states(nblocks=3, nch=2, step=100, hist=100):
    si = np.full((nblocks, nch), step, np.int32)
    wt = np.zeros((nblocks, nch, 4), np.int32)
    hi = np.full((nblocks, nch, 4), hist, np.int32)
    return (si, wt, hi)


@pytest.mark.parametrize(
    "step,hist,code,error",
    [(4080, -32768, 15, None), (0, 32767, 0, None), (4081, 0, 3, "step index"), (-1, 0, 3, "step index"),
     (100, 32768, 3, "history"), (100, -32769, 3, "history"), (100, 0, 16, "bit depth")],
)
def test_check_framed_stream_matches_aad_tpu(debug_on, step, hist, code, error):
    states = _states(step=step, hist=hist)
    codes = np.full((3, 2, 30), code, np.uint8)
    outcomes = []
    for check, framed, geo in (
        (jax_debug.check_framed_stream, JaxBlockStates(*states), jax_geometry(96, 2, 4)),
        (debug.check_framed_stream, BlockStates.from_numpy(states), aad_tpu_torch.compute_block_geometry(96, 2, 4)),
    ):
        try:
            check(framed, codes, geo)
            outcomes.append(None)
        except (aad_tpu.InvalidFormatError, aad_tpu_torch.InvalidFormatError) as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is None) == (error is None) and (error is None or error in outcomes[1])


def test_checks_do_nothing_when_debug_mode_is_off():
    was = debug.enabled()
    debug.enable(False)
    try:
        debug.check_framed_stream(BlockStates.from_numpy(_states(step=9999)), np.full((1,), 99, np.uint8),
                                  aad_tpu_torch.compute_block_geometry(96, 2, 4))
        debug.check_pcm_range(np.full((2, 5), 40000))
    finally:
        debug.enable(was)


@pytest.mark.parametrize("lo,hi", [(-32768, 32767), (-32769, 0), (0, 32768), (0, 0)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_check_pcm_range_matches_aad_tpu(debug_on, lo, hi, as_tensor):
    pcm = np.array([[lo, hi, 0]], np.int32)
    want = got = None
    try:
        jax_debug.check_pcm_range(pcm)
    except aad_tpu.InvalidFormatError as e:
        want = str(e)
    try:
        debug.check_pcm_range(torch.from_numpy(pcm) if as_tensor else pcm)
    except aad_tpu_torch.InvalidFormatError as e:
        got = str(e)
    assert got == want
    assert (got is None) == (lo >= -32768 and hi <= 32767)


def test_decoder_frame_checks_in_debug_mode_only(monkeypatch):
    _, tcfg = _configs(2)
    data = aad_tpu_torch.encode(noise(200, 2, seed=3), tcfg, device="cpu")
    header = aad_tpu_torch.decode_header(data)
    dec = aad_tpu_torch.Decoder.from_header(header, device="cpu")
    payload = np.frombuffer(data, np.uint8)[aad_tpu_torch.FILE_HEADER_SIZE :]
    seen = []
    monkeypatch.setattr(debug, "check_framed_stream", lambda states, codes, geo: seen.append(codes.shape))
    was = debug.enabled()
    try:
        for on in (False, True):
            debug.enable(on)
            framed = dec.frame(payload)
            assert len(seen) == int(on)
    finally:
        debug.enable(was)
    assert seen == [tuple(framed.codes.shape)]


def test_out_of_range_pcm_raises_in_both_packages():
    """PCM outside int16 is outside the contract of both packages. The
    port's encoders raise always; aad_tpu raises the same error in its debug
    mode (and encodes such input otherwise)."""
    rng = np.random.default_rng(0)
    pcm = rng.integers(-20000, 20000, (2, 3000)).astype(np.int32)
    pcm[0, 1234] = 40000
    pcm[1, 2345] = -40000
    jcfg, tcfg = _configs(2)
    errors = []
    for encode in (
        lambda: aad_tpu_torch.encode(pcm, tcfg, device="cpu"),
        lambda: aad_tpu_torch.encode_batch([pcm[:, :100], pcm], tcfg, device="cpu"),
        lambda: aad_tpu_torch.StreamingEncoder(tcfg, device="cpu").push(pcm),
    ):
        with pytest.raises(aad_tpu_torch.InvalidFormatError) as got:
            encode()
        errors.append((type(got.value).__name__, got.value.result.value, str(got.value)))
    was = jax_debug.enabled()
    jax_debug.enable()
    try:
        with pytest.raises(aad_tpu.InvalidFormatError) as want:
            aad_tpu.encode(pcm, jcfg, engine="scan")
    finally:
        jax_debug.enable(was)
    assert set(errors) == {(type(want.value).__name__, want.value.result.value, str(want.value))}


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf, 32768.0, -32769.0])
def test_float_pcm_outside_int16_or_not_finite_raises(bad):
    """Float PCM is truncated toward zero, as an int32 cast does: 32767.9
    encodes as 32767, and a value that is not finite, or outside int16 once
    truncated, raises in every encode entry point of the port. (aad_tpu's
    debug check lets NaN through: its comparisons with NaN are false.)"""
    _, tcfg = _configs(2)
    pcm = noise(300, 2, seed=4).astype(np.float64)
    pcm[0, 0], pcm[1, 1] = 32767.9, -32768.9
    want = aad_tpu_torch.encode(np.trunc(pcm).astype(np.int16), tcfg, device="cpu")
    assert aad_tpu_torch.encode(pcm, tcfg, device="cpu") == want
    pcm[1, 17] = bad
    for encode in (
        lambda: aad_tpu_torch.encode(pcm, tcfg, device="cpu"),
        lambda: aad_tpu_torch.encode_batch([pcm[:, :100], pcm], tcfg, device="cpu"),
        lambda: aad_tpu_torch.StreamingEncoder(tcfg, device="cpu").push(pcm),
    ):
        with pytest.raises(aad_tpu_torch.InvalidFormatError, match="int16"):
            encode()


def test_self_check_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        aad_tpu_torch.self_check()
    with pytest.raises(aad_tpu_torch.InvalidArgumentError):
        aad_tpu_torch.self_check(device="cpu")


def test_time_encode_needs_a_card(monkeypatch):
    from aad_tpu_torch.utils import time_encode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        time_encode.main(["--seconds", "1"])


def test_time_lanes_needs_a_card(monkeypatch):
    from aad_tpu_torch.utils import time_lanes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        time_lanes.main(["--lanes", "2"])


def test_profiling_needs_a_card(monkeypatch, tmp_path):
    calls = []
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.measure_throughput(calls.append, torch.zeros(4), 4)
    assert calls == []  # nothing was timed on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace(str(tmp_path)):
            pass
