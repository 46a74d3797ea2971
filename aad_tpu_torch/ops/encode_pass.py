"""Wrapper of the CUDA per-pass encode kernel, beside its plain torch version.

:func:`encode_pass` -> ``aad_encode_pass`` (``csrc/encode.cu``), the port of
the Pallas kernel ``aad_tpu/ops/pallas_encode.py::_make_kernel`` (entry
``encode_scan_tiles``): one measure or emit pass of the encode recurrence
over one block per lane. A per-lane ``valid`` freezes the state and the
error sum past the valid samples.

On the encode main path it runs where ``aad_tpu`` runs its TPU counterpart:
after the whole-stream kernel, to rebuild the predictor carry of a chunk's
last block (``aad_tpu/ops/pallas_encode_fused.py:1145-1166``; see
``ops.fused_encode.encode_stream``).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. Nothing falls back. :data:`launches` counts kernel launches.

Not carried over from the TPU kernel: the u32 sample-pair words and the
(8, 128) lane tiles of ``to_timemajor`` (samples go in as int16, time-major,
which coalesces across a warp), the packed code words (codes come out as
uint8), the f32 step-size formula with its correction set, and the two-limb
error sum (int64 here).
"""

from __future__ import annotations

import torch

from ..constants import FILTER_ORDER
from ..utils.trace import span
from . import _build
from .encode import _encode_span
from .transitions import CodecState, index_table, stepsize_table

PASS_KERNEL = "aad_encode_pass"

# Launch counts; the wrapper adds one where it launches, and nowhere else.
launches: dict[str, int] = {PASS_KERNEL: 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"encode_pass: {what}")


def encode_pass_reference(
    samples_tm: torch.Tensor, state: CodecState, valid: torch.Tensor, bits_per_sample: int,
    emit_codes: bool = False,
):
    """Plain version of ``aad_encode_pass``, on any device: the scan
    engine's recurrence (``ops.encode._encode_span``) in the kernel's layout."""
    final, codes, sse = _encode_span(
        state, samples_tm.t(), valid.to(torch.int32) - FILTER_ORDER, bits_per_sample
    )
    return final, codes.t() if emit_codes else None, sse


def encode_pass(
    samples_tm: torch.Tensor,
    state: CodecState,
    valid: torch.Tensor,
    bits_per_sample: int,
    emit_codes: bool = False,
    out: tuple[CodecState, torch.Tensor] | None = None,
):
    """One encode pass over one block of each of L lanes.

    Args:
      samples_tm: (T, L) int16, time-major: each lane's samples after its
        block's four head samples.
      state: the lanes' state, leaves (L, 4) / (L,) int32, history already
        seeded by the caller.
      valid: (L,) int32 valid samples of each block, the four head samples
        included: slot t advances the state and the error iff
        t < valid - 4.
      emit_codes: also return the codes of all T slots (past ``valid`` each
        comes from the frozen state), else only measure.
      out: on a card, (state, sse) buffers, shaped and typed as the result's,
        that the kernel writes in place of new ones; the result is them.
    Returns:
      (final CodecState, codes (T, L) uint8 or None, sse (L,) int64: the sum
      of the live slots' wrapped squared errors).
    """
    _require(bits_per_sample in (2, 3, 4), f"bits_per_sample {bits_per_sample}")
    _require(samples_tm.dim() == 2, f"samples must be (T, L), got {tuple(samples_tm.shape)}")
    _require(samples_tm.dtype == torch.int16, f"samples must be int16, got {samples_tm.dtype}")
    T, L = samples_tm.shape
    for name, t, shape in (
        ("history", state.history, (L, FILTER_ORDER)),
        ("weight", state.weight, (L, FILTER_ORDER)),
        ("step_index", state.step_index, (L,)),
        ("valid", valid, (L,)),
    ):
        _require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
        _require(tuple(t.shape) == shape, f"{name} must be {shape}, got {tuple(t.shape)}")
        _require(t.device == samples_tm.device, f"{name} is on {t.device}, samples on {samples_tm.device}")

    device = samples_tm.device
    if device.type == "cpu":
        return encode_pass_reference(samples_tm, state, valid, bits_per_sample, emit_codes)
    _require(device.type == "cuda", f"no kernel for device {device}")
    for name, t in (("samples", samples_tm), ("valid", valid), *zip(CodecState._fields, state)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
    return _launch(samples_tm, state, valid, bits_per_sample, emit_codes, out)


def _launch(samples_tm, state, valid, bits_per_sample, emit_codes, given=None):
    T, L = samples_tm.shape
    device = samples_tm.device
    if given is None:
        out = CodecState(
            history=torch.empty((L, FILTER_ORDER), dtype=torch.int32, device=device),
            weight=torch.empty((L, FILTER_ORDER), dtype=torch.int32, device=device),
            step_index=torch.empty((L,), dtype=torch.int32, device=device),
        )
        sse = torch.empty((L,), dtype=torch.int64, device=device)
    else:
        out, sse = given
        want = ((torch.int32, (L, FILTER_ORDER)), (torch.int32, (L, FILTER_ORDER)), (torch.int32, (L,)),
                (torch.int64, (L,)))
        for t, (dtype, shape) in zip((*out, sse), want):
            _require(t.dtype == dtype and tuple(t.shape) == shape and t.device == device and t.is_contiguous(),
                     f"out must be contiguous {dtype} {shape} on {device}")
    codes = torch.empty((T, L), dtype=torch.uint8, device=device) if emit_codes else None
    if L == 0:
        return out, codes, sse
    with span("aad.launch.encode_pass"):
        lib = _build.library()
        err = lib.aad_encode_pass(
            samples_tm.data_ptr(), state.step_index.data_ptr(), state.history.data_ptr(),
            state.weight.data_ptr(), valid.data_ptr(), stepsize_table(device).data_ptr(),
            index_table(bits_per_sample, device).data_ptr(),
            codes.data_ptr() if emit_codes else None, out.step_index.data_ptr(),
            out.history.data_ptr(), out.weight.data_ptr(), sse.data_ptr(),
            L, T, bits_per_sample, *_build.launch_target(device),
        )
        _build.check(lib, PASS_KERNEL, err)
    launches[PASS_KERNEL] += 1
    return out, codes, sse


def encode_pass_bank(feeds, ms, seeded: CodecState, end: CodecState, num_channels: int, nspb: int,
                     bits_per_sample: int) -> None:
    """Kernel 4's bank instance (CUDA only): for each of the L = F * C lanes
    of a tick's feeds (``feeds`` (F, 5) int32, as kernel 3's bank mode takes
    them), one measure pass over its feed's last block (``ms`` (blocks + 1,
    nspb, L) int16, as kernel 3 staged it) from that block's header state
    (``seeded``, leaves (L, 4) / (L,)), its end state written to its slot's
    lanes of ``end`` (leaves (S * C, 4) / (S * C,)). Its plain version is
    part of ``fused_encode.encode_bank_reference``."""
    L = ms.shape[-1]
    device = ms.device
    _require(device.type == "cuda", f"encode_pass_bank needs CUDA tensors, got {device}")
    _require(L == feeds.shape[0] * num_channels, f"{L} lanes for {feeds.shape[0]} feeds of {num_channels}")
    if L == 0:
        return
    with span("aad.launch.encode_pass"):
        lib = _build.library()
        err = lib.aad_encode_pass_bank(
            feeds.data_ptr(), ms.data_ptr(), seeded.step_index.data_ptr(), seeded.history.data_ptr(),
            seeded.weight.data_ptr(), stepsize_table(device).data_ptr(),
            index_table(bits_per_sample, device).data_ptr(), end.step_index.data_ptr(), end.history.data_ptr(),
            end.weight.data_ptr(), L, nspb, num_channels, bits_per_sample, *_build.launch_target(device),
        )
        _build.check(lib, PASS_KERNEL, err)
    launches[PASS_KERNEL] += 1
