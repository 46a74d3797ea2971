"""Wrappers of the CUDA decode kernels, each beside its plain torch version.

* :func:`decode_lanes` -> ``aad_decode_lanes`` (``csrc/decode.cu``), the
  port of the fused Pallas kernel ``aad_tpu/ops/pallas_decode.py::_make_kernel``:
  the whole decode recurrence of every block x channel lane in one launch,
  reading the codes packed from each block's data region, as the TPU kernel
  reads its packed code words (or one a byte, for the codes-level API).
* :func:`stepsize_corrections` -> ``aad_stepsize_probe``, the port of the
  Pallas probe ``aad_tpu/ops/pallas_decode.py::stepsize_corrections``.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises. Nothing falls back. Each wrapper counts its
kernel launches in :data:`launches`.

Not carried over from the TPU kernel, because they exist only for the TPU:

* the f32 step-size formula and its correction set: the kernel reads the
  exact 256-entry int table, so the probe's correction set must be empty;
* the u32 view of the code words and the (8, 128) lane tiles: a thread is a
  lane here, and the kernel reads the wire's bytes as they are, staging the
  bytes of each block's next 64 steps in shared memory;
* the R-fold lane interleave, which gave the TPU's scheduler independent
  chains; on the GPU the warp scheduler interleaves warps instead;
* the packed sample-pair output: the kernel writes int16 rows directly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..codec.device import resolve_device
from ..constants import FILTER_ORDER, STEPSIZE_TABLE_SIZE, TABLES_FLOAT_DIGITS
from ..format.geometry import BlockGeometry
from ..tables import STEPSIZE_TABLE
from ..utils.trace import span
from . import _build, bitpack
from .decode import decode_blocks_reference
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
    rows: torch.Tensor,
    step_index: torch.Tensor,
    history: torch.Tensor,
    weight: torch.Tensor,
    bits_per_sample: int,
    geo: BlockGeometry | None = None,
) -> torch.Tensor:
    """Plain version of ``aad_decode_lanes``, on any device: the codes
    unpacked (``bitpack.unpack_codes``), then the recurrence of ``ops.decode``
    (phase A then phase B, vectorised over lanes, looping over time); inputs
    and output as :func:`decode_lanes`.
    """
    if geo is None:
        codes = rows[:, None, :]  # (L, 1, T)
    else:
        codes = bitpack.unpack_codes(rows[:, geo.header_bytes : geo.header_bytes + geo.data_bytes], geo)
    B, C, T = codes.shape
    lanes = codes.transpose(0, 1).reshape(C * B, T)  # lane c * B + b: channel c of block b
    samples = decode_blocks_reference(lanes, step_index, weight, history, bits_per_sample=bits_per_sample)
    return samples.to(torch.int16)


def decode_lanes(
    rows: torch.Tensor,
    step_index: torch.Tensor,
    history: torch.Tensor,
    weight: torch.Tensor,
    bits_per_sample: int,
    geo: BlockGeometry | None = None,
) -> torch.Tensor:
    """Decode the L independent lanes of a batch of blocks, T codes each.

    With ``geo``, ``rows`` is (B, geo.block_size) uint8 block rows, as
    ``framing.split_blocks`` gives them, and the codes are read packed from
    each row's data region (at ``geo.header_bytes``, the channels' units
    interleaved, as on the wire): L = C * B lanes, lane ``c * B + b`` channel
    ``c`` of block ``b`` (channel-major, so the rows of one channel come out
    consecutive), T = ``geo.codes_per_block``. Without, ``rows`` is (L, T)
    uint8 codes one a byte, lane ``l`` row ``l``, each below
    2**bits_per_sample: the codes-level API (``ops.decode.decode_blocks``).

    Args:
      step_index: (L,) int32 initial Q4 step index (clamped to [0, 4080]).
      history:    (L, 4) int32 initial history, newest first.
      weight:     (L, 4) int32 initial weights.
    Returns:
      (L, T + 4) int16: per lane the four header samples (history reversed)
      followed by the T decoded samples.
    """
    _require(bits_per_sample in (2, 3, 4), f"bits_per_sample {bits_per_sample}")
    _require(rows.dim() == 2, f"rows must be 2-D, got {tuple(rows.shape)}")
    _require(rows.dtype == torch.uint8, f"rows must be uint8, got {rows.dtype}")
    if geo is None:
        (L, T), C = rows.shape, 1
        B, block_bytes, data_offset = L, T, 0
    else:
        _require(geo.bits_per_sample == bits_per_sample, f"geometry of {geo.bits_per_sample} bits")
        _require(rows.shape[1] == geo.block_size, f"rows must be (B, {geo.block_size}), got {tuple(rows.shape)}")
        B, C, T = rows.shape[0], geo.num_channels, geo.codes_per_block
        L, block_bytes, data_offset = B * C, geo.block_size, geo.header_bytes
    for name, t, shape in (
        ("step_index", step_index, (L,)),
        ("history", history, (L, FILTER_ORDER)),
        ("weight", weight, (L, FILTER_ORDER)),
    ):
        _require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
        _require(tuple(t.shape) == shape, f"{name} must be {shape}, got {tuple(t.shape)}")
        _require(t.device == rows.device, f"{name} is on {t.device}, rows on {rows.device}")

    device = rows.device
    if device.type == "cpu":
        return decode_lanes_reference(rows, step_index, history, weight, bits_per_sample, geo)
    _require(device.type == "cuda", f"no kernel for device {device}")
    for name, t in (("rows", rows), ("step_index", step_index),
                    ("history", history), ("weight", weight)):
        _require(t.is_contiguous(), f"{name} must be contiguous")

    out = torch.empty((L, T + FILTER_ORDER), dtype=torch.int16, device=device)
    if L == 0:
        return out
    # the kernel copies 4-byte words from 4-byte boundaries: it takes the
    # rows from the boundary at or before them, and how far before
    skew = rows.data_ptr() % 4
    with span("aad.launch.decode_lanes"):
        lib = _build.library()
        err = lib.aad_decode_lanes(
            rows.data_ptr() - skew, skew, step_index.data_ptr(), history.data_ptr(),
            weight.data_ptr(), stepsize_table(device).data_ptr(),
            index_table(bits_per_sample, device).data_ptr(), out.data_ptr(),
            B, C, T, block_bytes, data_offset, bits_per_sample, int(geo is not None),
            *_build.launch_target(device),
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
    with span("aad.launch.stepsize_probe"):
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


def stepsize_corrections(device="cuda") -> tuple[tuple[int, int], ...]:
    """(slot, delta) pairs where the kernel's step sizes differ from the table.

    The probe runs once per process and device, at the first CUDA decode; by
    default on the card, as ``aad_tpu``'s probes its default backend, and
    without a card that raises (``device="cpu"`` asks the plain version).
    The kernel reads the exact table, so any correction means a broken
    table upload: that raises. Returns ``()``.
    """
    device = resolve_device(device)
    corrections = _probe_corrections(device)
    if corrections:
        raise RuntimeError(f"step-size table on {device} differs from STEPSIZE_TABLE: {corrections}")
    return corrections
