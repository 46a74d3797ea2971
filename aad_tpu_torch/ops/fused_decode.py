"""Wrappers of the CUDA decode kernels, each beside its plain torch version.

* :func:`decode_rows` -> ``aad_decode_lanes`` (``csrc/decode.cu``), the port
  of the fused Pallas kernel ``aad_tpu/ops/pallas_decode.py::_make_kernel``
  and of the device framing around it: the whole decode of every block x
  channel lane of a batch of block rows in one launch. The kernel parses
  each lane's block header, reads its codes packed from the block's data
  region, as the TPU kernel reads its packed code words, and writes a
  mid/side stream's rows as left and right.
* :func:`decode_lanes` -> the same kernel on (L, T) codes one a byte, the
  lanes' states from the caller: the codes-level API.
* :func:`stepsize_corrections` -> ``aad_stepsize_probe``, the port of the
  Pallas probe ``aad_tpu/ops/pallas_decode.py::stepsize_corrections``.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises. Nothing falls back. Each wrapper counts its
kernel launches in :data:`launches`; :func:`decode_rows` also counts, while
a profiler records (``utils.trace``), the blocks whose headers the kernel
parsed (``k1_rows_parsed``) and, of them, those whose left/right it
combined (``k1_rows_ms``).

Not carried over from the TPU kernel, because they exist only for the TPU:

* the f32 step-size formula and its correction set: the kernel reads the
  exact 256-entry int table, so the probe's correction set must be empty;
* the u32 view of the code words and the (8, 128) lane tiles: a thread is a
  lane here, and the kernel reads the wire's bytes as they are, staging the
  bytes of each block's next 64 steps in shared memory;
* the R-fold lane interleave, which gave the TPU's scheduler independent
  chains; on the GPU the warp scheduler interleaves warps instead;
* the packed sample-pair output and its mid/side combine in word space: the
  kernel writes int16 rows directly, left and right already combined.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..codec.device import resolve_device
from ..constants import FILTER_ORDER, STEPSIZE_TABLE_SIZE, TABLES_FLOAT_DIGITS
from ..format.framing import parse_block_headers
from ..format.geometry import BlockGeometry
from ..tables import STEPSIZE_TABLE
from ..utils.trace import count, span
from . import _build, bitpack
from .decode import decode_blocks_reference, ms_to_lr
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
    """Plain version of ``aad_decode_lanes`` on codes one a byte, on any
    device: the recurrence of ``ops.decode`` (phase A then phase B,
    vectorised over lanes, looping over time); inputs and output as
    :func:`decode_lanes`.
    """
    samples = decode_blocks_reference(codes, step_index, weight, history, bits_per_sample=bits_per_sample)
    return samples.to(torch.int16)


def decode_rows_reference(rows: torch.Tensor, geo: BlockGeometry, mid_side: bool = False) -> torch.Tensor:
    """Plain version of ``aad_decode_lanes`` on block rows, on any device,
    and the CPU's decode path: the block headers parsed
    (``framing.parse_block_headers``), the codes unpacked
    (``bitpack.unpack_codes``), the lanes decoded by
    :func:`decode_lanes_reference`, then, for ``mid_side``, left = mid +
    side and right = mid - side in int32, clipped to int16; inputs and
    output as :func:`decode_rows`.
    """
    states = parse_block_headers(rows, geo)
    codes = bitpack.unpack_codes(rows[:, geo.header_bytes : geo.header_bytes + geo.data_bytes], geo)
    B, C = codes.shape[:2]

    def lanes(a):  # (B, C, ...) -> (C * B, ...): lane c * B + b is channel c of block b
        return a.transpose(0, 1).reshape(C * B, *a.shape[2:]).contiguous()

    rows = decode_lanes_reference(lanes(codes), lanes(states.step_index), lanes(states.history),
                                  lanes(states.weight), geo.bits_per_sample)
    if mid_side:  # rows [0, B) mid, [B, 2B) side
        rows = ms_to_lr(rows.view(2, -1)).to(torch.int16).view(rows.shape)
    return rows


def decode_lanes(
    codes: torch.Tensor,
    step_index: torch.Tensor,
    history: torch.Tensor,
    weight: torch.Tensor,
    bits_per_sample: int,
) -> torch.Tensor:
    """Decode L independent lanes of T codes each, one a byte: the
    codes-level API (``ops.decode.decode_blocks``).

    Args:
      codes:      (L, T) uint8, lane ``l`` row ``l``, each below 2**bits_per_sample.
      step_index: (L,) int32 initial Q4 step index (clamped to [0, 4080]).
      history:    (L, 4) int32 initial history, newest first.
      weight:     (L, 4) int32 initial weights.
    Returns:
      (L, T + 4) int16: per lane the four header samples (history reversed)
      followed by the T decoded samples.
    """
    _require(bits_per_sample in (2, 3, 4), f"bits_per_sample {bits_per_sample}")
    _require(codes.dim() == 2, f"codes must be 2-D, got {tuple(codes.shape)}")
    _require(codes.dtype == torch.uint8, f"codes must be uint8, got {codes.dtype}")
    L, T = codes.shape
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
    for name, t in (("codes", codes), ("step_index", step_index), ("history", history), ("weight", weight)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
    out = torch.empty((L, T + FILTER_ORDER), dtype=torch.int16, device=device)
    if L:
        _launch(codes, (step_index, history, weight), out, bits_per_sample, L, 1, T, T, 0, False)
    return out


def decode_rows(rows: torch.Tensor, geo: BlockGeometry, mid_side: bool = False) -> torch.Tensor:
    """Decode a batch of whole blocks, as they lie on the wire.

    ``rows`` is (B, geo.block_size) uint8 block rows, as
    ``framing.pad_to_blocks`` gives them. Each block x channel lane starts
    from the state in its block header and decodes the T =
    ``geo.codes_per_block`` codes packed in the block's data region (the
    channels' units interleaved, as on the wire). ``mid_side`` (a stream
    whose ``ch_process_method`` is mid/side; two channels) turns each
    block's mid and side into left and right.

    Returns:
      (C * B, T + 4) int16, lane ``c * B + b`` channel ``c`` of block ``b``
      (channel-major, so the rows of one channel come out consecutive): the
      four header samples (history reversed), then the T decoded samples;
      left and right for ``mid_side``.
    """
    _require(rows.dim() == 2, f"rows must be 2-D, got {tuple(rows.shape)}")
    _require(rows.dtype == torch.uint8, f"rows must be uint8, got {rows.dtype}")
    _require(rows.shape[1] == geo.block_size, f"rows must be (B, {geo.block_size}), got {tuple(rows.shape)}")
    _require(not mid_side or geo.num_channels == 2, f"mid/side of {geo.num_channels} channel(s)")
    device = rows.device
    if device.type == "cpu":
        return decode_rows_reference(rows, geo, mid_side)
    _require(device.type == "cuda", f"no kernel for device {device}")
    _require(rows.is_contiguous(), "rows must be contiguous")
    B, C, T = rows.shape[0], geo.num_channels, geo.codes_per_block
    out = torch.empty((C * B, T + FILTER_ORDER), dtype=torch.int16, device=device)
    if B:
        _launch(rows, None, out, geo.bits_per_sample, B, C, T, geo.block_size, geo.header_bytes, mid_side)
        count("k1_rows_parsed", B)
        if mid_side:
            count("k1_rows_ms", B)
    return out


def _launch(src: torch.Tensor, states, out: torch.Tensor, bits_per_sample: int, num_blocks: int,
            num_channels: int, num_codes: int, block_bytes: int, data_offset: int, mid_side: bool) -> None:
    """One launch of ``aad_decode_lanes``: on block rows where ``states`` is
    None (the kernel parses their headers), else on codes one a byte with
    ``states`` = (step_index, history, weight)."""
    device = src.device
    si, hi, wt = (0, 0, 0) if states is None else (t.data_ptr() for t in states)
    # the kernel copies 4-byte words from 4-byte boundaries: it takes the
    # bytes from the boundary at or before them, and how far before
    skew = src.data_ptr() % 4
    with span("aad.launch.decode_lanes"):
        lib = _build.library()
        err = lib.aad_decode_lanes(
            src.data_ptr() - skew, skew, si, hi, wt, stepsize_table(device).data_ptr(),
            index_table(bits_per_sample, device).data_ptr(), out.data_ptr(),
            num_blocks, num_channels, num_codes, block_bytes, data_offset, bits_per_sample,
            int(states is None), int(mid_side), *_build.launch_target(device),
        )
        _build.check(lib, DECODE_KERNEL, err)
    launches[DECODE_KERNEL] += 1


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
