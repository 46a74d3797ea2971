"""Per-sample codec transitions on torch int32 tensors.

The torch counterparts of ``aad_tpu.ops.transitions``: pure functions over a
leading lane shape ``(...,)``, bit-exact with the reference decode step
(reference: src/aad_decoder.c:269-318) and encode step
(src/aad_encoder.c:343-410). The tables live on the device of the tensor
they are applied to.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..constants import (
    FILTER_ORDER,
    FIXEDPOINT_0_5,
    FIXEDPOINT_DIGITS,
    LMSFILTER_SHIFT,
    STEP_INDEX_MAX,
    STEPSIZE_TABLE_SIZE,
    TABLES_FLOAT_0_5,
    TABLES_FLOAT_DIGITS,
)
from ..tables import INDEX_TABLES, STEPSIZE_TABLE
from . import cseman as cs


class CodecState(NamedTuple):
    """Adaptive-predictor state of a lane shape ``(...,)``; the same for
    encoder and decoder (as ``aad_tpu.ops.transitions.CodecState``)."""

    history: torch.Tensor     # (..., 4) int32, [0] = newest sample
    weight: torch.Tensor      # (..., 4) int32, Q15 filter weights
    step_index: torch.Tensor  # (...)    int32, Q4 step-size index

    @classmethod
    def zeros(cls, lane_shape=(), device="cpu") -> "CodecState":
        z = functools.partial(torch.zeros, dtype=torch.int32, device=device)
        return cls(z((*lane_shape, FILTER_ORDER)), z((*lane_shape, FILTER_ORDER)), z(tuple(lane_shape)))

    @classmethod
    def from_numpy(cls, state, device="cpu") -> "CodecState":
        """Any (history, weight, step_index) triple of arrays -> int32 tensors."""
        return cls(*(torch.as_tensor(np.asarray(a), dtype=torch.int32).to(device) for a in state))

    def numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(history, weight, step_index) as int32 numpy arrays."""
        return tuple(a.cpu().numpy().astype(np.int32) for a in self)

    def to(self, device) -> "CodecState":
        return CodecState(*(a.to(device) for a in self))

    def map(self, fn) -> "CodecState":
        """Apply ``fn`` to every leaf."""
        return CodecState(*(fn(a) for a in self))


@functools.cache
def stepsize_table(device: torch.device) -> torch.Tensor:
    """The 256-entry step-size table as an int32 tensor on ``device``."""
    return torch.as_tensor(STEPSIZE_TABLE, dtype=torch.int32).to(device)


@functools.cache
def index_table(bits_per_sample: int, device: torch.device) -> torch.Tensor:
    """The ``2**bits_per_sample``-entry index-delta table on ``device``."""
    return torch.as_tensor(INDEX_TABLES[bits_per_sample], dtype=torch.int32).to(device)


def stepsize_from_index(step_index: torch.Tensor) -> torch.Tensor:
    """Step size lookup (reference: src/aad_tables.h:15,28).

    The slot is clamped to 255, as in every ``aad_tpu`` engine: a malformed
    block header can carry a wire index in (4080, 4095] whose slot is 256,
    one past the table (undefined in the reference). Valid streams never
    reach the clamp.
    """
    slot = cs.asr(step_index + TABLES_FLOAT_0_5, TABLES_FLOAT_DIGITS)
    slot = torch.clamp(slot, 0, STEPSIZE_TABLE_SIZE - 1).to(torch.int64)
    return stepsize_table(step_index.device)[slot]


def update_step_index(step_index: torch.Tensor, code: torch.Tensor, bits_per_sample: int) -> torch.Tensor:
    """Clipped-add index adaptation (reference: src/aad_tables.h:31-43)."""
    delta = index_table(bits_per_sample, step_index.device)[code.to(torch.int64)]
    return cs.clip(step_index + delta, 0, STEP_INDEX_MAX)


def quantized_diff(stepsize: torch.Tensor, code: torch.Tensor, bits_per_sample: int) -> torch.Tensor:
    """Reconstruct the quantised difference from a code.

    qdiff = +/- (stepsize * (2*delta + 1)) >> (bps - 1)
    (reference: src/aad_decoder.c:284-288)
    """
    signbit = 1 << (bits_per_sample - 1)
    code = code.to(torch.int32)
    mag = cs.asr(stepsize * (((code & (signbit - 1)) << 1) + 1), bits_per_sample - 1)
    return torch.where((code & signbit) != 0, -mag, mag)


def predict(history: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Q15 4-tap prediction (reference: src/aad_decoder.c:291-295).

    The sum is written as int32 adds so that it wraps as in C (``torch.sum``
    would promote to int64).
    """
    acc = history[..., 0] * weight[..., 0] + FIXEDPOINT_0_5
    for k in range(1, FILTER_ORDER):
        acc = acc + history[..., k] * weight[..., k]
    return cs.asr(acc, FIXEDPOINT_DIGITS)


def _apply_qdiff(state: CodecState, qdiff: torch.Tensor, pred: torch.Tensor) -> tuple[CodecState, torch.Tensor]:
    """Shared tail of both transitions: reconstruct, adapt weights, shift history.

    (reference: src/aad_decoder.c:297-315 == src/aad_encoder.c:391-406)
    """
    sample = cs.clip16(qdiff + pred)
    wdelta = cs.asr(qdiff[..., None] * state.history + FIXEDPOINT_0_5, FIXEDPOINT_DIGITS + LMSFILTER_SHIFT)
    history = torch.cat([sample[..., None], state.history[..., : FILTER_ORDER - 1]], dim=-1)
    return CodecState(history, state.weight + wdelta, state.step_index), sample


def encode_sample(
    state: CodecState, sample: torch.Tensor, bits_per_sample: int
) -> tuple[CodecState, torch.Tensor, torch.Tensor]:
    """One encode step; returns (state', code, qdiff).

    The residual is quantised, then the decoder's own state update runs on
    the quantised value, which keeps encoder and decoder in lockstep
    (reference: src/aad_encoder.c:343-410). ``qdiff`` is the quantisation
    error the trial search accumulates (src/aad_encoder.c:389, 461).
    """
    signbit = 1 << (bits_per_sample - 1)
    stepsize = stepsize_from_index(state.step_index)
    pred = predict(state.history, state.weight)
    diff = sample.to(torch.int32) - pred
    neg = diff < 0
    diffabs = torch.where(neg, -diff, diff)
    # code = min(|diff| * 2**(bps-2) / stepsize, absmask), C division
    # (reference: src/aad_encoder.c:372)
    scaled = cs.shl(diffabs, bits_per_sample - 2)
    code = torch.clamp(cs.trunc_div(scaled, stepsize), max=signbit - 1)
    code = torch.where(neg, code | signbit, code)
    qdiff = quantized_diff(stepsize, code, bits_per_sample)
    state = state._replace(step_index=update_step_index(state.step_index, code, bits_per_sample))
    state, _ = _apply_qdiff(state, qdiff, pred)
    return state, code, qdiff


def _clip_between(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """max(lo, min(hi, x)) with tensor bounds (``cs.clip`` takes ints)."""
    return torch.maximum(lo, torch.minimum(hi, x))


def step_index_prefix(codes: torch.Tensor, init_index: torch.Tensor, bits_per_sample: int, dim: int = -1) -> torch.Tensor:
    """Step index *used by* each decode step, for a whole code sequence.

    ``idx_t = clip(idx_{t-1} + d_t, 0, 4080)`` is a chain of saturating-add
    maps ``x -> clip(x + a, lo, hi)``, which are closed under composition:
    ``(a1, l1, h1)`` then ``(a2, l2, h2)`` is ``(a1 + a2, clip(l1 + a2, l2,
    h2), clip(h1 + a2, l2, h2))``. Composition is associative, so every
    prefix comes out of a log-depth (Hillis-Steele) scan: ``ceil(log2 T)``
    rounds over shifted slices of the time axis, as
    ``aad_tpu.ops.transitions.step_index_prefix`` does with
    ``lax.associative_scan``.

    Args:
      codes: int codes with time on axis ``dim`` (``(..., T)`` by default;
        ``dim=0`` takes the decoder's time-major ``(T, L)`` codes).
      init_index: the initial Q4 index, ``codes``' shape without ``dim``.
    Returns:
      int32, ``codes``' shape: the index consumed by step t (before t's update).

    The scan updates its three int32 state tensors in place, round by round,
    to hold one copy of each at full width.
    """
    dim = dim % codes.dim()
    T = codes.shape[dim]
    a = index_table(bits_per_sample, codes.device)[codes.to(torch.int64)]
    lo = torch.zeros_like(a)
    hi = torch.full_like(a, STEP_INDEX_MAX)
    d = 1
    while d < T:
        # f = the prefix ending at t - d (earlier), g = the one ending at t (later)
        fa, flo, fhi = (x.narrow(dim, 0, T - d) for x in (a, lo, hi))
        ga, glo, ghi = (x.narrow(dim, d, T - d) for x in (a, lo, hi))
        new_lo = _clip_between(flo + ga, glo, ghi)
        new_hi = _clip_between(fhi + ga, glo, ghi)
        new_a = fa + ga
        ga.copy_(new_a)
        glo.copy_(new_lo)
        ghi.copy_(new_hi)
        del fa, flo, fhi, ga, glo, ghi, new_a, new_lo, new_hi
        d *= 2
    init = init_index.to(torch.int32).unsqueeze(dim)
    # Prefix t applied to init gives the index AFTER step t; step t uses the
    # index after step t - 1.
    after = _clip_between(init + a, lo, hi)
    del a, lo, hi
    return torch.cat([init.expand_as(after.narrow(dim, 0, 1)), after.narrow(dim, 0, T - 1)], dim=dim)


def seed_history(state: CodecState, first_samples: torch.Tensor, valid) -> CodecState:
    """Load the first FILTER_ORDER samples into history, newest last-in.

    ``first_samples`` is (..., 4) = samples 0..3 of the block; entries at
    positions >= ``valid`` are zeroed, as the encoder's seed loop does for
    short blocks (reference: src/aad_encoder.c:606-616). history[k] receives
    sample[3-k].
    """
    pos = torch.arange(FILTER_ORDER, device=first_samples.device)
    valid = torch.as_tensor(valid, device=first_samples.device)
    samples = torch.where(pos < valid[..., None], first_samples.to(torch.int32), 0)
    return state._replace(history=samples.flip(-1))
