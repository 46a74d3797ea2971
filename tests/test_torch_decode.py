"""aad_tpu_torch's decode ops and kernel wrappers against aad_tpu, on the CPU.

The plain torch recurrence is the CPU engine and the oracle of the CUDA
kernel, so it must equal aad_tpu's scan engine and its fused Pallas kernel
(run in interpret mode, as aad_tpu's own CPU tests run it) exactly: the
codec is integer throughout. Inputs come from numpy with fixed seeds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aad_tpu.ops import decode as jd
from aad_tpu.ops import transitions as jt

import aad_tpu_torch
from aad_tpu_torch.ops import _build, fused_decode
from aad_tpu_torch.ops import decode as td
from aad_tpu_torch.ops import transitions as tt
from aad_tpu_torch.tables import STEPSIZE_TABLE


def _lanes(seed, L, T, bps, lo_idx=0, hi_idx=4096):
    """Random lanes as the bench stream draws them (the int32 sum wraps)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**bps, (L, T), dtype=np.uint8)
    si = rng.integers(lo_idx, hi_idx, (L,)).astype(np.int32)
    si[:3] = [0, 4080, 4095][: min(3, L)]
    wt = rng.integers(-20000, 20000, (L, 4)).astype(np.int32)
    hi = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    return codes, si, wt, hi


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_stepsize_and_index_update_match_all_indices():
    idx = np.arange(4096, dtype=np.int32)
    np.testing.assert_array_equal(
        tt.stepsize_from_index(torch.from_numpy(idx)).numpy(),
        np.asarray(jt.stepsize_from_index(jnp.asarray(idx))),
    )
    for bps in (2, 3, 4):
        codes = np.resize(np.arange(2**bps, dtype=np.int32), idx.shape)
        np.testing.assert_array_equal(
            tt.update_step_index(torch.from_numpy(idx), torch.from_numpy(codes), bps).numpy(),
            np.asarray(jt.update_step_index(jnp.asarray(idx), jnp.asarray(codes), bps)),
        )
        step = tt.stepsize_from_index(torch.from_numpy(idx))
        np.testing.assert_array_equal(
            tt.quantized_diff(step, torch.from_numpy(codes), bps).numpy(),
            np.asarray(jt.quantized_diff(jnp.asarray(step.numpy()), jnp.asarray(codes), bps)),
        )


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_compute_qdiffs_and_lms_scan_match(bps):
    codes, si, wt, hi = _lanes(20 + bps, 40, 33, bps, hi_idx=4081)
    want_q = np.asarray(jd.compute_qdiffs(jnp.asarray(codes), jnp.asarray(si), bps))
    got_q = td.compute_qdiffs(*_t(codes, si), bps)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    want = np.asarray(jd.lms_scan(jnp.asarray(want_q), jnp.asarray(hi), jnp.asarray(wt)))
    np.testing.assert_array_equal(td.lms_scan(got_q, *_t(hi, wt)).numpy(), want)


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_decode_blocks_matches_scan_engine(bps):
    """Plain decode_blocks == aad_tpu decode_blocks(engine="scan"), (B, C) lanes."""
    codes, si, wt, hi = _lanes(bps, 3 * 2 * 5, 50, bps)
    codes = codes.reshape(3, 2, 5, 50)
    si, wt, hi = si.reshape(3, 2, 5), wt.reshape(3, 2, 5, 4), hi.reshape(3, 2, 5, 4)
    want = np.asarray(jd.decode_blocks(
        jnp.asarray(codes), jnp.asarray(si), jnp.asarray(wt), jnp.asarray(hi),
        bits_per_sample=bps, engine="scan",
    ))
    got = td.decode_blocks(*_t(codes, si, wt, hi), bits_per_sample=bps)
    assert got.dtype == torch.int32 and got.shape == (3, 2, 5, 54)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_decode_blocks_matches_fused_pallas_interpret(bps):
    """Plain decode_blocks == the fused Pallas kernel, interpret mode, one tile."""
    codes, si, wt, hi = _lanes(40 + bps, 1024, 24, bps)
    want = np.asarray(jd.decode_blocks(
        jnp.asarray(codes), jnp.asarray(si), jnp.asarray(wt), jnp.asarray(hi),
        bits_per_sample=bps, engine="fused",
    ))
    got = td.decode_blocks(*_t(codes, si, wt, hi), bits_per_sample=bps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ms_to_lr_matches_at_clip_limits():
    edge = np.array([-32768, -32767, -1, 0, 1, 32766, 32767], dtype=np.int32)
    mid, side = np.meshgrid(edge, edge)
    samples = np.stack([mid.ravel(), side.ravel()])[None]  # (1, 2, N)
    want = np.asarray(jd.ms_to_lr(jnp.asarray(samples)))
    got = td.ms_to_lr(torch.from_numpy(samples.astype(np.int16)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() == -32768 and want.max() == 32767


def test_plain_stepsize_probe_has_no_corrections():
    np.testing.assert_array_equal(fused_decode.stepsize_probe("cpu").numpy(), STEPSIZE_TABLE)
    assert fused_decode.stepsize_corrections("cpu") == ()


def _block_lanes(codes, si, wt, hi):
    """(B, C, ...) block-batch arrays -> the kernel's channel-major lanes."""
    B, C, T = codes.shape
    lanes = lambda a: torch.from_numpy(np.ascontiguousarray(a.swapaxes(0, 1).reshape(C * B, *a.shape[2:])))
    return torch.from_numpy(codes), lanes(si), lanes(hi), lanes(wt)


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("bps", [2, 3, 4])
def test_decode_lanes_block_order_matches_jax(bps, C, engine):
    """decode_lanes and decode_lanes_reference take framing.block_codes' (B, C, T)
    codes and return channel-major rows (lane c * B + b): equal to aad_tpu's
    scan engine and to its fused Pallas kernel in interpret mode."""
    B, T = 1024 // C, 21  # one 1024-lane tile; T + 4 odd
    codes, si, wt, hi = _lanes(80 + 2 * bps + C, B * C, T, bps)
    codes, si, wt, hi = codes.reshape(B, C, T), si.reshape(B, C), wt.reshape(B, C, 4), hi.reshape(B, C, 4)
    want = np.asarray(jd.decode_blocks(
        jnp.asarray(codes), jnp.asarray(si), jnp.asarray(wt), jnp.asarray(hi),
        bits_per_sample=bps, engine=engine,
    ))
    want = want.swapaxes(0, 1).reshape(C * B, T + 4)
    args = _block_lanes(codes, si, wt, hi)
    before = dict(fused_decode.launches)
    got = fused_decode.decode_lanes(*args, bps)
    assert fused_decode.launches == before
    assert got.dtype == torch.int16 and got.shape == (C * B, T + 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fused_decode.decode_lanes_reference(*args, bps).numpy(), want)


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_cpu_wrapper_runs_plain_version_without_launching(bps):
    codes, si, wt, hi = _lanes(60 + bps, 37 * 2, 21, bps)
    codes, si, wt, hi = codes.reshape(37, 2, 21), si.reshape(37, 2), wt.reshape(37, 2, 4), hi.reshape(37, 2, 4)
    before = dict(fused_decode.launches)
    got = fused_decode.decode_lanes(*_block_lanes(codes, si, wt, hi), bps)
    assert fused_decode.launches == before
    assert got.dtype == torch.int16 and got.shape == (74, 25)
    want = td.decode_blocks(*_t(codes, si, wt, hi), bits_per_sample=bps)  # (B, C, T + 4)
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 1).reshape(74, 25).numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    codes, si, wt, hi = _lanes(70, 8, 5, 4)
    c, s, h, w = _block_lanes(codes.reshape(4, 2, 5), si.reshape(4, 2), wt.reshape(4, 2, 4), hi.reshape(4, 2, 4))
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c.to(torch.int32), s, h, w, 4)
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c, s[:-1], h, w, 4)
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c, s, h.to(torch.int64), w, 4)
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c, s, h, w, 5)
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c.reshape(8, 5), s, h, w, 4)  # time-major or lane rows: not (B, C, T)
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c.to("meta"), s.to("meta"), h.to("meta"), w.to("meta"), 4)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing nvcc is an error, never a silent fall back to the plain version."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(_build.KernelBuildError):
        _build.build(tmp_path / "build")


def test_cuda_decode_without_a_gpu_raises(monkeypatch):
    """device="cuda" with no card raises; it does not decode on the CPU."""
    header = aad_tpu_torch.HeaderInfo(
        num_channels=1, num_samples=10, sampling_rate=8000, bits_per_sample=4,
        block_size=128, num_samples_per_block=224, ch_process_method=0,
    )
    data = aad_tpu_torch.encode_header(header) + bytes(128)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        aad_tpu_torch.decode(data, device="cuda")


def test_source_hash_covers_every_source():
    names = {p.name for p in _build._sources()}
    assert {"decode.cu", "cseman.cuh"} <= names
    assert len(_build.source_hash()) == 16
