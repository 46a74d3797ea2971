"""Plain torch block decode: the CPU engine and the CUDA kernel's oracle.

Decode of one block factors into two recurrences over time (design:
``aad_tpu.ops.decode``):

* **phase A**, the step-index recurrence, gives every step size and so every
  quantised difference;
* **phase B**, the 4-tap LMS recurrence (predict -> clip -> weight update ->
  history shift), turns those into samples.

Both are written here as Python loops over time whose body is vectorised over
every block x channel lane: the straightforward reading of
``aad_tpu.ops.decode.compute_qdiffs`` / ``lms_scan``. ``aad_tpu`` computes
phase A with an associative scan, which is :func:`compute_qdiffs_prefix`
here, the phase A of the two-phase ``pallas`` engine; the loop
:func:`compute_qdiffs` is its plain version. Bit-exact with the reference
decoder (reference: src/aad_decoder.c:269-318, 321-475).

:func:`decode_blocks_reference` is the plain block decode, the oracle of
kernel 1; :func:`decode_blocks` decodes the same lanes by an engine, through
the kernels' wrappers (the codes-level API of ``aad_tpu.ops.decode``).
"""

from __future__ import annotations

import math

import torch

from ..constants import (
    FILTER_ORDER,
    FIXEDPOINT_0_5,
    FIXEDPOINT_DIGITS,
    LMSFILTER_SHIFT,
    STEP_INDEX_MAX,
)
from . import cseman as cs
from .transitions import quantized_diff, step_index_prefix, stepsize_from_index, update_step_index


def compute_qdiffs(codes: torch.Tensor, init_index: torch.Tensor, bits_per_sample: int) -> torch.Tensor:
    """Phase A: codes (..., T) + initial index (...) -> qdiff (..., T) int32."""
    idx = init_index.to(torch.int32)
    qdiffs = []
    for t in range(codes.shape[-1]):
        code = codes[..., t]
        qdiffs.append(quantized_diff(stepsize_from_index(idx), code, bits_per_sample))
        idx = update_step_index(idx, code, bits_per_sample)
    return torch.stack(qdiffs, dim=-1) if qdiffs else codes.to(torch.int32)


def compute_qdiffs_prefix(
    codes: torch.Tensor, init_index: torch.Tensor, bits_per_sample: int, dim: int = -1
) -> torch.Tensor:
    """Phase A by the log-depth step-index scan: equal to :func:`compute_qdiffs`.

    Time runs along ``dim`` (``dim=0``: time-major ``(T, L)`` codes give
    time-major qdiffs, the LMS kernel's input layout). Returns int32 qdiffs
    of ``codes``' shape.
    """
    step = stepsize_from_index(step_index_prefix(codes, init_index, bits_per_sample, dim))
    return quantized_diff(step, codes, bits_per_sample)


def lms_scan(qdiffs: torch.Tensor, history0: torch.Tensor, weight0: torch.Tensor) -> torch.Tensor:
    """Phase B: sequential LMS reconstruction.

    Args:
      qdiffs:   (..., T) int32 quantised differences.
      history0: (..., 4) int32 initial history (newest first).
      weight0:  (..., 4) int32 initial weights.
    Returns:
      samples (..., T) int32.
    """
    h = list(history0.to(torch.int32).unbind(-1))
    w = list(weight0.to(torch.int32).unbind(-1))
    wshift = FIXEDPOINT_DIGITS + LMSFILTER_SHIFT
    samples = []
    for t in range(qdiffs.shape[-1]):
        qdiff = qdiffs[..., t]
        # int32 adds, not torch.sum: the sum must wrap as in C (it exceeds
        # 2**31 whenever the weights have grown large).
        acc = h[0] * w[0] + FIXEDPOINT_0_5
        for k in range(1, FILTER_ORDER):
            acc = acc + h[k] * w[k]
        sample = cs.clip16(qdiff + cs.asr(acc, FIXEDPOINT_DIGITS))
        w = [w[k] + cs.asr(qdiff * h[k] + FIXEDPOINT_0_5, wshift) for k in range(FILTER_ORDER)]
        h = [sample] + h[:-1]
        samples.append(sample)
    return torch.stack(samples, dim=-1) if samples else qdiffs.to(torch.int32)


ENGINES = ("auto", "fused", "pallas")


def decode_blocks(
    codes: torch.Tensor,
    step_index: torch.Tensor,
    weight: torch.Tensor,
    history: torch.Tensor,
    *,
    bits_per_sample: int,
    engine: str = "auto",
) -> torch.Tensor:
    """Decode a dense batch of independent block tasks by ``engine``, as
    ``aad_tpu.ops.decode.decode_blocks`` does.

    ``"auto"``/``"fused"`` run the lanes through kernel 1
    (``ops.fused_decode.decode_lanes``) as (L, T) codes one a byte;
    ``"pallas"`` runs phase A (:func:`compute_qdiffs_prefix`) on
    time-major codes and phase B through the LMS kernel (``ops.lms``). The
    wrappers run their plain versions on a CPU tensor and launch the kernel
    on a CUDA tensor. Shapes and output as :func:`decode_blocks_reference`;
    an engine outside :data:`ENGINES` raises ValueError.
    """
    # the wrappers' plain versions live in this module
    from .fused_decode import decode_lanes, stepsize_corrections
    from .lms import lms_lanes

    if engine not in ENGINES:
        raise ValueError(f"unknown decode engine {engine!r}; expected one of {ENGINES}")
    *lanes, T = codes.shape
    L = math.prod(lanes)
    step_index = cs.clip(step_index, 0, STEP_INDEX_MAX).reshape(L).to(torch.int32).contiguous()
    history = history.reshape(L, FILTER_ORDER).to(torch.int32).contiguous()
    weight = weight.reshape(L, FILTER_ORDER).to(torch.int32).contiguous()
    codes = codes.reshape(L, T)
    if engine == "pallas":
        qdiffs = compute_qdiffs_prefix(codes.t().contiguous(), step_index, bits_per_sample, dim=0)
        rows = lms_lanes(qdiffs, history, weight)
    else:
        stepsize_corrections(codes.device)  # probes the kernel's table once per process and card
        rows = decode_lanes(codes.to(torch.uint8).reshape(L, T).contiguous(), step_index, history, weight,
                            bits_per_sample)
    return rows.to(torch.int32).reshape(*lanes, T + FILTER_ORDER)


def decode_blocks_reference(
    codes: torch.Tensor,
    step_index: torch.Tensor,
    weight: torch.Tensor,
    history: torch.Tensor,
    *,
    bits_per_sample: int,
) -> torch.Tensor:
    """Decode a dense batch of independent block tasks: the plain version, on
    any device.

    Args:
      codes:      (..., T) uint8/int codes (lane shape = blocks x channels ...).
      step_index: (...) int32 initial Q4 step index per lane.
      weight:     (..., 4) int32 initial weights per lane.
      history:    (..., 4) int32 initial history per lane (newest first).
    Returns:
      (..., T + FILTER_ORDER) int32 samples: the four header samples
      (history reversed, reference: src/aad_decoder.c:386-391) followed by the
      T decoded samples.
    """
    # Parse-clamp semantics for the codes-level API, as in aad_tpu: wire
    # indices in (4080, 4095] pin to the table maximum.
    step_index = cs.clip(step_index, 0, STEP_INDEX_MAX)
    qdiffs = compute_qdiffs(codes, step_index, bits_per_sample)
    body = lms_scan(qdiffs, history, weight)
    head = history.to(torch.int32).flip(-1)
    return torch.cat([head, body], dim=-1)


def ms_to_lr(samples: torch.Tensor) -> torch.Tensor:
    """Mid/side -> left/right with int16 clips, computed in int32.

    samples: (..., 2, N) with mid on channel 0, side on channel 1
    (reference: src/aad_decoder.c:458-470).
    """
    mid = samples[..., 0, :].to(torch.int32)
    side = samples[..., 1, :].to(torch.int32)
    return torch.stack([cs.clip16(mid + side), cs.clip16(mid - side)], dim=-2)
