"""Wrapper of the CUDA LMS kernel, beside its plain torch version.

:func:`lms_lanes` -> ``aad_lms_lanes`` (``csrc/lms.cu``), the port of the
Pallas kernel ``aad_tpu/ops/pallas_lms.py::_lms_kernel`` (driven by
``lms_pallas``): decode phase B of the two-phase ``pallas`` engine, the 4-tap
LMS recurrence over the qdiffs that phase A
(``ops.decode.compute_qdiffs_prefix``) computed, for every block x channel
lane in one launch. Its output is that of ``aad_decode_lanes``: (L, T + 4)
int16 rows, the four header samples first.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. Nothing falls back. :data:`launches` counts kernel launches.

Not carried over from the TPU wrapper, because they exist only for the TPU:
the padding of lanes to 1024 and of T to 256 and the (8, 128) tile
transposes around the call (the kernel reads (T, L) qdiffs as they come out
of phase A), and the int32 output with its head concatenated afterwards.
"""

from __future__ import annotations

import torch

from ..constants import FILTER_ORDER
from . import _build
from .decode import lms_scan

LMS_KERNEL = "aad_lms_lanes"

# Launch counts; the wrapper adds one where it launches, and nowhere else.
launches: dict[str, int] = {LMS_KERNEL: 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"lms_lanes: {what}")


def lms_lanes_reference(qdiffs_tm: torch.Tensor, history: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain version of ``aad_lms_lanes``, on any device: ``ops.decode.lms_scan``
    in the kernel's layout, (T, L) qdiffs in, (L, T + 4) int16 rows out."""
    body = lms_scan(qdiffs_tm.t(), history, weight)
    return torch.cat([history.to(torch.int32).flip(-1), body], dim=-1).to(torch.int16)


def lms_lanes(qdiffs_tm: torch.Tensor, history: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """LMS reconstruction of L independent lanes of T steps each.

    Args:
      qdiffs_tm: (T, L) int32 quantised differences, time-major.
      history:   (L, 4) int32 initial history, newest first.
      weight:    (L, 4) int32 initial weights.
    Returns:
      (L, T + 4) int16: per lane the four header samples (history reversed)
      followed by the T decoded samples.
    """
    _require(qdiffs_tm.dim() == 2, f"qdiffs must be (T, L), got {tuple(qdiffs_tm.shape)}")
    _require(qdiffs_tm.dtype == torch.int32, f"qdiffs must be int32, got {qdiffs_tm.dtype}")
    T, L = qdiffs_tm.shape
    for name, t in (("history", history), ("weight", weight)):
        _require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
        _require(tuple(t.shape) == (L, FILTER_ORDER), f"{name} must be {(L, FILTER_ORDER)}, got {tuple(t.shape)}")
        _require(t.device == qdiffs_tm.device, f"{name} is on {t.device}, qdiffs on {qdiffs_tm.device}")

    device = qdiffs_tm.device
    if device.type == "cpu":
        return lms_lanes_reference(qdiffs_tm, history, weight)
    _require(device.type == "cuda", f"no kernel for device {device}")
    for name, t in (("qdiffs", qdiffs_tm), ("history", history), ("weight", weight)):
        _require(t.is_contiguous(), f"{name} must be contiguous")

    out = torch.empty((L, T + FILTER_ORDER), dtype=torch.int16, device=device)
    if L == 0:
        return out
    lib = _build.library()
    err = lib.aad_lms_lanes(
        qdiffs_tm.data_ptr(), history.data_ptr(), weight.data_ptr(), out.data_ptr(),
        L, T, *_build.launch_target(device),
    )
    _build.check(lib, LMS_KERNEL, err)
    launches[LMS_KERNEL] += 1
    return out
