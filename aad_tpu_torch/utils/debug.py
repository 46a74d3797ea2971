"""Debug-mode invariant checking.

The reference's hot loops carry asserts that compile in only under
``-DDEBUG`` (reference: src/aad_internal.h:51-56, e.g. the bounds asserts at
src/aad_decoder.c:402-403). Here: a validation pass over a framed stream's
state snapshot and codes, which ``Decoder.frame`` runs when debug mode is
on, and a PCM range check. Both take numpy arrays or torch tensors on any
device, and do nothing when debug mode is off.

Enable with ``aad_tpu_torch.utils.debug.enable()`` or ``AAD_TPU_DEBUG=1``,
the variable ``aad_tpu`` reads. The encoders check the int16 range always
(``codec.encoder.as_int16``), debug mode or not.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..codec.result import InvalidFormatError
from ..constants import INT16_MAX, INT16_MIN, STEP_INDEX_MAX
from ..format.geometry import BlockGeometry

_enabled = bool(int(os.environ.get("AAD_TPU_DEBUG", "0")))


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def _bounds(a) -> tuple[int, int]:
    """(min, max) of an array or tensor, widened to include 0 (so an empty
    one passes every check, as numpy's ``initial=0``)."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        return int(a.min(initial=0)), int(a.max(initial=0))
    if a.numel() == 0:
        return 0, 0
    return min(int(a.min()), 0), max(int(a.max()), 0)


def check_framed_stream(states, codes, geo: BlockGeometry) -> None:
    """Validate a framed stream's invariants (debug mode only).

    Mirrors the reference's in-loop asserts: codes within the bit depth are
    structural here (the unpack masks), so the checks cover the ranges of
    the state snapshot loaded from the block headers.
    """
    if not _enabled:
        return
    lo, hi = _bounds(states.step_index)
    if lo < 0 or hi > STEP_INDEX_MAX:
        raise InvalidFormatError(f"block header step index out of range [0, {STEP_INDEX_MAX}]")
    lo, hi = _bounds(states.history)
    if lo < INT16_MIN or hi > INT16_MAX:
        raise InvalidFormatError("block header history outside int16 range")
    if _bounds(codes)[1] > (1 << geo.bits_per_sample) - 1:
        raise InvalidFormatError("code exceeds bit depth")


def check_pcm_range(pcm) -> None:
    """Encoder input must be int16-valued (the reference asserts this when
    seeding history, src/aad_encoder.c:612)."""
    if not _enabled:
        return
    lo, hi = _bounds(pcm)
    if lo < INT16_MIN or hi > INT16_MAX:
        raise InvalidFormatError("encoder input exceeds int16 range")
