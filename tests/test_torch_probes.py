"""The decode probes of ``aad_tpu_torch.probes`` on the CPU: each plain
version against the JAX probe it ports, bit for bit, at small sizes.

* phase A: the five forms against ``benchmarks/probe_phase_a_decode.py``'s
  ``launch`` in interpret mode (the script imported by path:
  ``benchmarks/`` is no package);
* the decode layouts: the bit-exact instances against
  ``aad_tpu.ops.pallas_decode.decode_words_timemajor(..., with_head=False)``
  (which launches ``_make_kernel``, the kernel of the probe's A, B2 and R
  variants), the K modes against a jnp transcription of the probe's
  ``word_step`` (``benchmarks/probe_decode_layout.py:273-313``, a closure
  inside its ``main()``);
* the transpose against ``np.transpose`` and ``jnp.transpose``;
* ``from_tiled``, the lane order the probes' tiles share;
* without a card or nvcc, the card's paths raise.

The kernels themselves run in ``tests/test_torch_probes_gpu.py`` (``gpu``).
"""

from __future__ import annotations

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from aad_tpu.ops import pallas_decode as PD

from aad_tpu_torch.ops import _build, fused_decode
from aad_tpu_torch.ops.decode import compute_qdiffs
from aad_tpu_torch import probes
from aad_tpu_torch.probes import decode_layout, phase_a_decode, transpose

REPO = pathlib.Path(__file__).resolve().parents[1]


@functools.cache
def _phase_a_probe():
    spec = importlib.util.spec_from_file_location("probe_phase_a_decode", REPO / "benchmarks" / "probe_phase_a_decode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)


def _pairs_to_time_major(words_u32: np.ndarray) -> np.ndarray:
    """(4W, L) u32 words of two int16 samples each (the earlier one low) ->
    (8W, L) int16."""
    rows, L = words_u32.shape
    return np.ascontiguousarray(words_u32).view(np.int16).reshape(rows, L, 2).transpose(0, 2, 1).reshape(2 * rows, L)


# ---------------------------------------------------------------------------
# phase A


@pytest.fixture(scope="module")
def phase_a_words():
    return _u32((16, 1, 8, 128), 7)  # two chunks of w_chunk 8: the state crosses a chunk


@pytest.mark.parametrize("variant", phase_a_decode.VARIANTS)
def test_phase_a_matches_jax_probe(phase_a_words, variant):
    mod = _phase_a_probe()
    want = np.asarray(mod.launch(variant, jnp.asarray(phase_a_words), PD.stepsize_corrections(), 8, 1))
    want = _pairs_to_time_major(want.reshape(want.shape[0], -1))
    before = dict(phase_a_decode.launches)
    got = phase_a_decode.decode(probes.from_tiled(phase_a_words), variant, device="cpu")
    assert got.dtype == torch.int16 and tuple(got.shape) == (128, 1024)
    np.testing.assert_array_equal(got.numpy(), want)
    assert phase_a_decode.launches == before  # the CPU ran the plain version
    if variant == "qdiff_only":  # the running sum leaves int16: the cut to its low 16 bits is held too
        codes = probes.unpack_words(probes.on_device(probes.from_tiled(phase_a_words), "cpu"))
        sums = compute_qdiffs(codes.t(), torch.zeros(1024, dtype=torch.int32), 4).cumsum(-1)
        assert sums.abs().max() > 32767


@pytest.mark.parametrize("variant", phase_a_decode.SAME_AS_FULL)
def test_phase_a_splits_equal_full(variant):
    words = _u32((13, 300), 11)
    full = phase_a_decode.decode(words, "full", device="cpu")
    assert torch.equal(phase_a_decode.decode(words, variant, device="cpu"), full)


# ---------------------------------------------------------------------------
# decode layouts


def _layout_inputs(L, W, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (W, L), dtype=np.uint32)
    si = rng.integers(0, 4081, L).astype(np.int32)
    h = rng.integers(-30000, 30000, (4, L)).astype(np.int32)
    wt = rng.integers(-20000, 20000, (4, L)).astype(np.int32)
    return words, si, h, wt


@functools.cache
def _jax_natural(L, W, seed):
    words, si, h, wt = _layout_inputs(L, W, seed)
    out = PD.decode_words_timemajor(jnp.asarray(words), jnp.asarray(si), jnp.asarray(h.T), jnp.asarray(wt.T),
                                    8 * W, bits_per_sample=4, with_head=False)
    return np.asarray(out).T  # (L, 8W) -> time-major (8W, L)


BIT_EXACT = [inst for inst in decode_layout.INSTANCES if inst[2] == "full"]


@pytest.mark.parametrize("L", [1024, 2048])
@pytest.mark.parametrize("layout,r,mode", BIT_EXACT)
def test_layout_matches_decode_words_timemajor(L, layout, r, mode):
    W = 16
    want = _jax_natural(L, W, L)
    got = decode_layout.decode(*_layout_inputs(L, W, L), layout=layout, r=r, mode=mode, device="cpu")
    if layout == "lane_major":
        want = want.T
    elif layout == "tile_major":
        want = want.reshape(8 * W, L // 64, 64).transpose(1, 0, 2)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


def test_tile_major_pads_the_last_tile_with_zeros():
    words, si, h, wt = _layout_inputs(70, 3, 5)
    got = decode_layout.decode(words, si, h, wt, layout="tile_major", device="cpu")
    natural = decode_layout.decode(words, si, h, wt, device="cpu")
    assert tuple(got.shape) == (2, 24, 64)
    assert torch.equal(got[1, :, 6:], torch.zeros(24, 58, dtype=torch.int16))
    assert torch.equal(got.permute(1, 0, 2).reshape(24, 128)[:, :70], natural)


def _k_oracle(words, si, h, wt, mode):
    """The probe's K-mode step (benchmarks/probe_decode_layout.py:273-313)
    in jnp, over time-major words; its step size through
    ``pallas_decode._stepsize_f32`` and the correction set (:283-287), its
    index delta through ``_delta_select`` (:293-295). Returns (8W, L) int16."""
    corrections = PD.stepsize_corrections()
    bps = 4
    half = jnp.int32(1 << 14)
    lo16 = jnp.int32(-32768)
    hi16 = jnp.int32(32767)

    def word_step(carry, word):
        h0, h1, h2, h3, w0, w1, w2, w3, idx = carry
        outs = []
        for k in range(8):
            code = (word >> (4 * k)) & 0xF
            mag = code & 0x7
            if mode == "no_stepsize":
                stepsize = jnp.int32(1024) + idx  # cheap stand-in
            else:
                slot = (idx + 8) >> 4
                stepsize = PD._stepsize_f32(slot).astype(jnp.int32)
                for ss, d in corrections:
                    stepsize = stepsize + jnp.where(slot == ss, jnp.int32(d), jnp.int32(0))
            qmag = (stepsize * ((mag << 1) + 1)) >> 3
            qdiff = jnp.where((code & 8) != 0, -qmag, qmag)
            if mode == "no_delta":
                idx = jnp.minimum(jnp.int32(4080), idx + mag)
            else:
                idx = jnp.maximum(jnp.int32(0), jnp.minimum(jnp.int32(4080), idx + PD._delta_select(mag, bps)))
            pred = (half + h0 * w0 + h1 * w1 + h2 * w2 + h3 * w3) >> 15
            sm = jnp.maximum(lo16, jnp.minimum(hi16, qdiff + pred))
            if mode != "no_weights":
                w0 = w0 + ((qdiff * h0 + half) >> 18)
                w1 = w1 + ((qdiff * h1 + half) >> 18)
                w2 = w2 + ((qdiff * h2 + half) >> 18)
                w3 = w3 + ((qdiff * h3 + half) >> 18)
            h3, h2, h1, h0 = h2, h1, h0, sm
            outs.append(sm)
        packed = jnp.stack([PD._pack_pair(outs[2 * j], outs[2 * j + 1]) for j in range(4)])
        return (h0, h1, h2, h3, w0, w1, w2, w3, idx), packed.astype(jnp.uint32)

    carry = (*jnp.asarray(h), *jnp.asarray(wt), jnp.asarray(si))
    _, packed = jax.jit(lambda c, x: lax.scan(word_step, c, x))(carry, jnp.asarray(words))
    packed = np.asarray(packed)  # (W, 4, L)
    return _pairs_to_time_major(packed.reshape(-1, packed.shape[-1]))


@pytest.mark.parametrize("mode", decode_layout.MODES)
def test_k_modes_match_the_probe_step(mode):
    L, W = 1024, 16
    words, si, h, wt = _layout_inputs(L, W, 21)
    got = decode_layout.decode(words, si, h, wt, mode=mode, device="cpu")
    np.testing.assert_array_equal(got.numpy(), _k_oracle(words, si, h, wt, mode))
    if mode == "full":  # the transcription is the decode where nothing is taken out
        np.testing.assert_array_equal(got.numpy(), _jax_natural(L, W, 21))


def test_k_modes_differ_from_full():
    """The ablations are not the decode, by design."""
    args = _layout_inputs(256, 4, 2)
    full = decode_layout.decode(*args, device="cpu")
    for mode in decode_layout.MODES[1:]:
        assert not torch.equal(decode_layout.decode(*args, mode=mode, device="cpu"), full)


def test_layout_rejects_what_the_kernel_does_not_take():
    args = _layout_inputs(64, 2, 1)
    with pytest.raises(ValueError):
        decode_layout.decode(*args, layout="lane_major", r=2, device="cpu")  # not built
    with pytest.raises(ValueError):
        decode_layout.decode(*args, mode="no_delta", r=4, device="cpu")
    with pytest.raises(ValueError):
        decode_layout.decode(args[0], args[1], args[2].T.copy(), args[3], device="cpu")  # history (L, 4)


# ---------------------------------------------------------------------------
# transpose


@pytest.mark.parametrize("shape", [(8, 4, 8, 128), (37, 3, 5, 11)])
def test_transpose_matches_numpy_and_jax(shape):
    x = np.random.default_rng(len(shape) + shape[0]).integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)
    before = dict(transpose.launches)
    got = transpose.transpose(x, device="cpu")
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.transpose(x, (1, 2, 3, 0)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.transpose(jnp.asarray(x), (1, 2, 3, 0))))
    assert transpose.launches == before


# ---------------------------------------------------------------------------
# lane order, and what runs without a card


def test_from_tiled_keeps_each_lanes_index():
    W, nt, S = 3, 4, 16  # an R-fold of 2: (W, n_tiles, 8 r, 128)
    tiles = np.arange(W * nt * S * 128, dtype=np.int64).reshape(W, nt, S, 128)
    flat = probes.from_tiled(tiles)
    lane = np.arange(nt * S * 128)
    assert flat.shape == (W, nt * S * 128)
    np.testing.assert_array_equal(flat[2], tiles[2, lane // (S * 128), lane // 128 % S, lane % 128])
    np.testing.assert_array_equal(flat, probes.from_tiled(tiles.reshape(W, 2 * nt, S // 2, 128)))
    state = np.arange(nt * 4 * 8 * 128).reshape(nt, 4, 8, 128)  # the layout probe's (n_tiles, 4, 8, 128)
    np.testing.assert_array_equal(probes.from_tiled(state, 0)[3], state[:, 3].reshape(-1))
    np.testing.assert_array_equal(probes.from_tiled(torch.from_numpy(state), 0).numpy(), probes.from_tiled(state, 0))


def test_probe_inputs_are_the_probe_draws():
    """The layout probe's inputs, as its script draws them (:62-74)."""
    words, si, h, wt = decode_layout.probe_inputs(tiles=2, num_words=3)
    rng = np.random.default_rng(0)
    want = [rng.integers(0, 2**32, (3, 2, 8, 128), dtype=np.uint32),
            rng.integers(0, 4081, (2, 1, 8, 128), dtype=np.int32),
            rng.integers(-30000, 30000, (2, 4, 8, 128), dtype=np.int32),
            rng.integers(-20000, 20000, (2, 4, 8, 128), dtype=np.int32)]
    np.testing.assert_array_equal(words, want[0].reshape(3, -1))
    np.testing.assert_array_equal(si, want[1].reshape(-1))
    np.testing.assert_array_equal(h[1], want[2][:, 1].reshape(-1))
    np.testing.assert_array_equal(wt[3], want[3][:, 3].reshape(-1))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_stepsize_corrections_defaults_to_the_card(no_card):
    """With no argument the probe asks the card, as aad_tpu's asks its
    default backend: without a card that raises, never ``()``."""
    with pytest.raises(RuntimeError, match="cuda"):
        fused_decode.stepsize_corrections()
    assert fused_decode.stepsize_corrections("cpu") == ()


@pytest.mark.parametrize("call", [
    lambda: transpose.transpose(np.zeros((4, 8), np.int32)),
    lambda: phase_a_decode.decode(np.zeros((2, 32), np.uint32)),
    lambda: decode_layout.decode(*_layout_inputs(64, 2, 0)),
    transpose.main, phase_a_decode.main, decode_layout.main,
])
def test_card_paths_raise_without_a_card(no_card, call):
    with pytest.raises(RuntimeError, match="cuda"):
        call()


def test_probe_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        probes.build(tmp_path / "build")
    assert not list(tmp_path.rglob("*.so"))
