"""Wrappers of the CUDA decode kernels, each beside its plain torch version.

* :func:`decode_lanes` -> ``aad_decode_lanes`` (``csrc/decode.cu``), the
  port of the fused Pallas kernel ``aad_tpu/ops/pallas_decode.py::_make_kernel``:
  the whole decode recurrence of every block x channel lane in one launch.
* :func:`stepsize_corrections` -> ``aad_stepsize_probe``, the port of the
  Pallas probe ``aad_tpu/ops/pallas_decode.py::stepsize_corrections``.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises. Nothing falls back. Each wrapper counts its
kernel launches in :data:`launches`.

Not carried over from the TPU kernel, because they exist only for the TPU:

* the f32 step-size formula and its correction set: the kernel reads the
  exact 256-entry int table, so the probe's correction set must be empty;
* the u32 code words and the (8, 128) lane tiles: a thread is a lane here,
  and the kernel takes the (B, C, T) code bytes of ``framing.block_codes``
  as they are, staging each lane's next 64 codes in shared memory;
* the R-fold lane interleave, which gave the TPU's scheduler independent
  chains; on the GPU the warp scheduler interleaves warps instead;
* the packed sample-pair output: the kernel writes int16 rows directly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import FILTER_ORDER, STEPSIZE_TABLE_SIZE, TABLES_FLOAT_DIGITS
from ..tables import STEPSIZE_TABLE
from . import _build
from .decode import decode_blocks
from .transitions import index_table, stepsize_from_index, stepsize_table

DECODE_KERNEL = "aad_decode_lanes"
PROBE_KERNEL = "aad_stepsize_probe"

# Launch counts per kernel; a wrapper adds one where it launches, and nowhere else.
launches: dict[str, int] = {DECODE_KERNEL: 0, PROBE_KERNEL: 0}


def reset_launches() -> None:
    """Zero the launch counts and forget the probe's result, as in a new process."""
    for name in launches:
        launches[name] = 0
    _probe_corrections.cache_clear()


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"decode_lanes: {what}")


def decode_lanes_reference(
    codes: torch.Tensor,
    step_index: torch.Tensor,
    history: torch.Tensor,
    weight: torch.Tensor,
    bits_per_sample: int,
) -> torch.Tensor:
    """Plain version of ``aad_decode_lanes``, on any device.

    The recurrence of ``ops.decode`` (phase A then phase B, vectorised over
    lanes, looping over time), in the kernel's layout: (B, C, T) codes in,
    (C * B, T + 4) int16 rows out, head samples first.
    """
    B, C, T = codes.shape
    lanes = codes.transpose(0, 1).reshape(C * B, T)  # lane c * B + b: channel c of block b
    samples = decode_blocks(lanes, step_index, weight, history, bits_per_sample=bits_per_sample)
    return samples.to(torch.int16)


def decode_lanes(
    codes: torch.Tensor,
    step_index: torch.Tensor,
    history: torch.Tensor,
    weight: torch.Tensor,
    bits_per_sample: int,
) -> torch.Tensor:
    """Decode the L = C * B independent lanes of a block batch, T codes each.

    Lanes are channel-major: lane ``c * B + b`` is channel ``c`` of block
    ``b``, so the rows of one channel come out consecutive.

    Args:
      codes:      (B, C, T) uint8 codes, as ``framing.block_codes`` gives
                  them, each below 2**bits_per_sample.
      step_index: (L,) int32 initial Q4 step index (clamped to [0, 4080]).
      history:    (L, 4) int32 initial history, newest first.
      weight:     (L, 4) int32 initial weights.
    Returns:
      (L, T + 4) int16: per lane the four header samples (history reversed)
      followed by the T decoded samples.
    """
    _require(bits_per_sample in (2, 3, 4), f"bits_per_sample {bits_per_sample}")
    _require(codes.dim() == 3, f"codes must be (B, C, T), got {tuple(codes.shape)}")
    B, C, T = codes.shape
    L = B * C
    _require(codes.dtype == torch.uint8, f"codes must be uint8, got {codes.dtype}")
    for name, t, shape in (
        ("step_index", step_index, (L,)),
        ("history", history, (L, FILTER_ORDER)),
        ("weight", weight, (L, FILTER_ORDER)),
    ):
        _require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
        _require(tuple(t.shape) == shape, f"{name} must be {shape}, got {tuple(t.shape)}")
        _require(t.device == codes.device, f"{name} is on {t.device}, codes on {codes.device}")

    device = codes.device
    if device.type == "cpu":
        return decode_lanes_reference(codes, step_index, history, weight, bits_per_sample)
    _require(device.type == "cuda", f"no kernel for device {device}")
    for name, t in (("codes", codes), ("step_index", step_index),
                    ("history", history), ("weight", weight)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
    if codes.data_ptr() % 4:
        codes = codes.clone()  # the kernel copies 4-byte words from 4-byte boundaries

    out = torch.empty((L, T + FILTER_ORDER), dtype=torch.int16, device=device)
    if L == 0:
        return out
    lib = _build.library()
    err = lib.aad_decode_lanes(
        codes.data_ptr(), step_index.data_ptr(), history.data_ptr(),
        weight.data_ptr(), stepsize_table(device).data_ptr(),
        index_table(bits_per_sample, device).data_ptr(), out.data_ptr(),
        B, C, T, bits_per_sample, *_build.launch_target(device),
    )
    _build.check(lib, DECODE_KERNEL, err)
    launches[DECODE_KERNEL] += 1
    return out


def stepsize_probe_reference(device) -> torch.Tensor:
    """Plain version of ``aad_stepsize_probe``: the step size of every slot."""
    idx = torch.arange(STEPSIZE_TABLE_SIZE, dtype=torch.int32, device=device) << TABLES_FLOAT_DIGITS
    return stepsize_from_index(idx)


def stepsize_probe(device) -> torch.Tensor:
    """(256,) int32: every slot's step size as the decode kernel reads it."""
    device = torch.device(device)
    if device.type == "cpu":
        return stepsize_probe_reference(device)
    if device.type != "cuda":
        raise ValueError(f"stepsize_probe: no kernel for device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty(STEPSIZE_TABLE_SIZE, dtype=torch.int32, device=device)
    lib = _build.library()
    err = lib.aad_stepsize_probe(
        stepsize_table(device).data_ptr(), out.data_ptr(), *_build.launch_target(device),
    )
    _build.check(lib, PROBE_KERNEL, err)
    launches[PROBE_KERNEL] += 1
    return out


@functools.cache
def _probe_corrections(device: torch.device) -> tuple[tuple[int, int], ...]:
    """Diff of the probe against the table, as aad_tpu's stepsize_corrections."""
    got = stepsize_probe(device).cpu().numpy()
    want = np.asarray(STEPSIZE_TABLE)
    return tuple((int(s), int(want[s] - got[s])) for s in np.nonzero(got != want)[0])


def stepsize_corrections(device="cpu") -> tuple[tuple[int, int], ...]:
    """(slot, delta) pairs where the kernel's step sizes differ from the table.

    The probe runs once per process and device, at the first CUDA decode.
    The kernel reads the exact table, so any correction means a broken
    table upload: that raises. Returns ``()``.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    corrections = _probe_corrections(device)
    if corrections:
        raise RuntimeError(f"step-size table on {device} differs from STEPSIZE_TABLE: {corrections}")
    return corrections
