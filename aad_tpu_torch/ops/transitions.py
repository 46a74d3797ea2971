"""Per-sample decode transitions on torch int32 tensors (decode subset).

The torch counterparts of ``aad_tpu.ops.transitions``: pure functions over a
leading lane shape ``(...,)``, bit-exact with the reference decode step
(reference: src/aad_decoder.c:269-318). The tables live on the device of
the tensor they are applied to.
"""

from __future__ import annotations

import functools

import torch

from ..constants import STEP_INDEX_MAX, STEPSIZE_TABLE_SIZE, TABLES_FLOAT_0_5, TABLES_FLOAT_DIGITS
from ..tables import INDEX_TABLES, STEPSIZE_TABLE
from . import cseman as cs


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
