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

import aad_tpu
from aad_tpu.format import framing as jf
from aad_tpu.format.geometry import compute_block_geometry as jgeometry
from aad_tpu.ops import bitpack as jb
from aad_tpu.ops import decode as jd
from aad_tpu.ops import transitions as jt

import aad_tpu_torch
from aad_tpu_torch.format.framing import block_codes, pad_to_blocks, parse_block_headers
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


@pytest.mark.parametrize("engine", ["auto", "fused", "pallas"])
@pytest.mark.parametrize("bps", [2, 3, 4])
def test_decode_blocks_engines_match_scan_engine(bps, engine):
    """decode_blocks by each engine (through the kernels' wrappers, plain on
    a CPU tensor) == decode_blocks_reference == aad_tpu's scan engine, on
    (B, C) lanes with int32 codes and step indices up to 4095 (the clamp)."""
    codes, si, wt, hi = _lanes(60 + bps, 3 * 2 * 5, 50, bps)
    codes = codes.astype(np.int32).reshape(3, 10, 50)
    si, wt, hi = si.reshape(3, 10), wt.reshape(3, 10, 4), hi.reshape(3, 10, 4)
    want = np.asarray(jd.decode_blocks(
        jnp.asarray(codes), jnp.asarray(si), jnp.asarray(wt), jnp.asarray(hi),
        bits_per_sample=bps, engine="scan",
    ))
    ref = td.decode_blocks_reference(*_t(codes, si, wt, hi), bits_per_sample=bps)
    got = td.decode_blocks(*_t(codes, si, wt, hi), bits_per_sample=bps, engine=engine)
    assert got.dtype == torch.int32 and got.shape == (3, 10, 54)
    np.testing.assert_array_equal(ref.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="unknown decode engine"):
        td.decode_blocks(*_t(codes, si, wt, hi), bits_per_sample=bps, engine="scan")


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


LAYOUTS = {"mono": (1, False), "lr": (2, False), "ms": (2, True)}  # channels, mid/side


def _wire_rows(seed, B, geo):
    """(B, block_size) uint8 block rows of random bytes: random headers, so
    every wire step index 0-4095 and every weight shift is possible, the
    first lanes' tags set to step indices 4080-4095 (4081 and up: the parse
    clamp), and random codes."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (B, geo.block_size), dtype=np.uint8)
    for i, idx in enumerate(range(4080, 4096)):
        b, c = divmod(i, geo.num_channels)
        if b < B:
            tag = (idx << 4) | int(rng.integers(0, 16))
            rows[b, 18 * c : 18 * c + 2] = [tag >> 8, tag & 0xFF]
    return rows


def _lanes_of(a: torch.Tensor) -> torch.Tensor:
    """(B, C, ...) -> (C * B, ...): lane c * B + b is channel c of block b."""
    return a.transpose(0, 1).reshape(a.shape[0] * a.shape[1], *a.shape[2:]).contiguous()


@pytest.mark.parametrize("engine", ["scan", "fused"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("bps", [2, 3, 4])
def test_decode_rows_matches_jax(bps, layout, engine):
    """decode_rows takes the (B, block_size) block rows of
    framing.pad_to_blocks, parses each block header, reads each lane's codes
    packed from its block's data region and, for mid/side, combines left and
    right; it returns channel-major rows (lane c * B + b): equal to aad_tpu's
    header parse and unpack, then its scan engine or its fused Pallas kernel
    in interpret mode, then its ms_to_lr."""
    C, ms = LAYOUTS[layout]
    B, T = 1024 // C, 24  # one 1024-lane tile; whole units at every bps
    full = jgeometry(1024, C, bps)
    geo = jgeometry(full.header_bytes + T // full.samples_per_unit * full.unit_bytes, C, bps)
    assert geo.codes_per_block == T
    rows = _wire_rows(80 + 2 * bps + C, B, geo)
    states = jf.parse_block_headers(rows, geo)
    codes = jb.unpack_codes(rows[:, geo.header_bytes : geo.header_bytes + geo.data_bytes], geo)
    samples = jd.decode_blocks(codes, states.step_index, states.weight, states.history,
                               bits_per_sample=bps, engine=engine)
    want = np.asarray(jd.ms_to_lr(samples) if ms else samples).swapaxes(0, 1).reshape(C * B, T + 4)
    tgeo = aad_tpu_torch.compute_block_geometry(geo.block_size, C, bps)
    before = dict(fused_decode.launches)
    got = fused_decode.decode_rows(torch.from_numpy(rows), tgeo, ms)
    assert fused_decode.launches == before
    assert got.dtype == torch.int16 and got.shape == (C * B, T + 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fused_decode.decode_rows_reference(torch.from_numpy(rows), tgeo, ms).numpy(),
                                  want)


@pytest.mark.parametrize("block", [128, 1024])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("bps", [2, 3, 4])
def test_decode_rows_plain_version_is_the_cpu_path(bps, layout, block):
    """decode_rows on CPU tensors (its plain version) == the header parse,
    decode_lanes_reference on the codes one a byte and the torch mid/side
    combine, and == aad_tpu's scan decode of the same bytes: four blocks,
    the last short on the wire (its missing bytes read as zero codes),
    step indices 4081-4095 among the headers."""
    C, ms = LAYOUTS[layout]
    geo = aad_tpu_torch.compute_block_geometry(block, C, bps)
    nspb = geo.num_samples_per_block
    B, n = 4, 3 * nspb + nspb // 3
    payload = _wire_rows(10 * bps + block + C + ms, B, geo).reshape(-1)[: aad_tpu_torch.encoded_stream_size(geo, n)]
    blocks = pad_to_blocks(torch.from_numpy(payload), B, geo)
    got = fused_decode.decode_rows(blocks, geo, ms)

    states = parse_block_headers(blocks, geo)
    assert int(states.step_index.max()) == 4080  # the clamp reached
    want = fused_decode.decode_lanes_reference(_lanes_of(block_codes(blocks, geo)), _lanes_of(states.step_index),
                                               _lanes_of(states.history), _lanes_of(states.weight), bps)
    if ms:
        mid, side = want[:B].to(torch.int32), want[B:].to(torch.int32)
        want = torch.cat([torch.clamp(mid + side, -32768, 32767), torch.clamp(mid - side, -32768, 32767)])
    assert got.dtype == torch.int16 and got.shape == (C * B, nspb)
    assert torch.equal(got, want.to(torch.int16))

    header = aad_tpu.HeaderInfo(
        num_channels=C, num_samples=n, sampling_rate=8000, bits_per_sample=bps, block_size=geo.block_size,
        num_samples_per_block=nspb, ch_process_method=int(ms),
    )
    data = aad_tpu.encode_header(header) + payload.tobytes()
    _, pcm = aad_tpu.decode(data, engine="scan")
    np.testing.assert_array_equal(got.view(C, -1)[:, :n].numpy(), pcm)
    np.testing.assert_array_equal(aad_tpu_torch.decode(data, device="cpu")[1], pcm)


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_cpu_wrapper_runs_plain_version_without_launching(bps):
    """The (L, T) codes one a byte of the codes-level API (T + 4 odd)."""
    codes, si, wt, hi = _lanes(60 + bps, 74, 21, bps)
    before = dict(fused_decode.launches)
    got = fused_decode.decode_lanes(*_t(codes, si, hi, wt), bps)
    assert fused_decode.launches == before
    assert got.dtype == torch.int16 and got.shape == (74, 25)
    want = td.decode_blocks(*_t(codes, si, wt, hi), bits_per_sample=bps)  # (L, T + 4)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    c, s, w, h = _t(*_lanes(70, 8, 8, 4))
    assert fused_decode.decode_lanes(c, s, h, w, 4).shape == (8, 12)
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c.to(torch.int32), s, h, w, 4)
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c, s[:-1], h, w, 4)
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c, s, h.to(torch.int64), w, 4)
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c, s, h, w, 5)
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c.reshape(4, 2, -1), s, h, w, 4)  # not rows
    with pytest.raises(ValueError):
        fused_decode.decode_lanes(c.to("meta"), s.to("meta"), h.to("meta"), w.to("meta"), 4)

    geo = aad_tpu_torch.compute_block_geometry(128, 2, 3)
    rows = torch.from_numpy(_wire_rows(71, 4, geo))
    assert fused_decode.decode_rows(rows, geo, True).shape == (8, geo.num_samples_per_block)
    with pytest.raises(ValueError):
        fused_decode.decode_rows(rows.to(torch.int32), geo)
    with pytest.raises(ValueError):
        fused_decode.decode_rows(rows[:, 1:], geo)  # rows narrower than a block
    with pytest.raises(ValueError):
        fused_decode.decode_rows(rows.reshape(-1), geo)  # not rows
    with pytest.raises(ValueError):
        fused_decode.decode_rows(rows[:, :18], aad_tpu_torch.compute_block_geometry(128, 1, 3), True)  # mono
    with pytest.raises(ValueError):
        fused_decode.decode_rows(rows.to("meta"), geo)


def test_decode_sample_matches_jax():
    """transitions.decode_sample, one step of every lane, as aad_tpu's."""
    for bps in (2, 3, 4):
        codes, si, wt, hi = _lanes(90 + bps, 257, 3, bps)
        jstate = jt.CodecState(jnp.asarray(hi), jnp.asarray(wt), jnp.asarray(np.minimum(si, 4080)))
        state = tt.CodecState(*_t(hi, wt, np.minimum(si, 4080)))
        for t in range(codes.shape[1]):
            jstate, jsample = jt.decode_sample(jstate, jnp.asarray(codes[:, t]), bps)
            state, sample = tt.decode_sample(state, torch.from_numpy(codes[:, t]), bps)
            np.testing.assert_array_equal(sample.numpy(), np.asarray(jsample))
            for g, w in zip(state, jstate):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


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
