"""Adaptation tables for the AAD codec.

Two families of tables drive step-size adaptation (reference: src/aad_tables.c):

* **Index-delta tables** (per bit depth): Q4 fixed-point deltas added to the
  step-size index after each code. Entries are ``(int16)(f * 16)`` of the
  float specs in the format definition (reference: src/aad_tables.c:5-45).
  The top half of each table mirrors the bottom half because the code's sign
  bit does not affect the delta.

* **Step-size table**: 256 quantizer step sizes generated by
  ``round(x**1.1 + 2**(log2(32767 - 255**1.1) / 255 * x))`` for x in [0, 255]
  (formula documented at reference: src/aad_tables.c:57). The table spans
  [1, 32767] and is strictly increasing.

The tables are materialised as numpy int32 arrays at import time. Torch code
copies them to the device it decodes on; the CUDA kernels receive them as
pointers and stage them in shared memory.
"""

from __future__ import annotations

import math

import numpy as np

from .constants import (
    MAX_BITS_PER_SAMPLE,
    MIN_BITS_PER_SAMPLE,
    STEPSIZE_TABLE_SIZE,
    TABLES_FLOAT_DIGITS,
    TABLES_FLOAT_0_5,
    STEP_INDEX_MAX,
)

__all__ = [
    "INDEX_TABLES",
    "STEPSIZE_TABLE",
    "index_table_for",
    "generate_stepsize_table",
]


def _q4(values: list[float]) -> np.ndarray:
    """Quantise float deltas to Q4 with C-cast (truncate-toward-zero) rounding."""
    scaled = [int(v * (1 << TABLES_FLOAT_DIGITS)) for v in values]
    # Mirror: sign bit of the code does not change the delta.
    return np.asarray(scaled + scaled, dtype=np.int32)


# Float specs per bit depth (reference: src/aad_tables.c:8-45).
_INDEX_TABLE_SPECS: dict[int, list[float]] = {
    4: [-1.17, -1.07, -0.9, 1, 2, 4, 8, 16],
    3: [-1.06, -0.95, 2, 8],
    2: [-0.9, 2.5],
}

INDEX_TABLES: dict[int, np.ndarray] = {
    bps: _q4(spec) for bps, spec in _INDEX_TABLE_SPECS.items()
}


def index_table_for(bits_per_sample: int) -> np.ndarray:
    """Index-delta table (length ``2**bits_per_sample``) for a bit depth."""
    if not MIN_BITS_PER_SAMPLE <= bits_per_sample <= MAX_BITS_PER_SAMPLE:
        raise ValueError(f"unsupported bits_per_sample: {bits_per_sample}")
    return INDEX_TABLES[bits_per_sample]


def generate_stepsize_table() -> np.ndarray:
    """Generate the 256-entry step-size table from its defining formula."""
    exponent = math.log2(32767 - 255**1.1) / 255
    x = np.arange(STEPSIZE_TABLE_SIZE, dtype=np.float64)
    values = x**1.1 + np.exp2(exponent * x)
    table = np.round(values).astype(np.int32)
    assert table[0] == 1 and table[-1] == 32767
    assert np.all(np.diff(table) > 0)
    return table


STEPSIZE_TABLE: np.ndarray = generate_stepsize_table()


def stepsize_for_index(step_index: np.ndarray) -> np.ndarray:
    """Step size for a Q4 step index (reference: src/aad_tables.h:15,28)."""
    return STEPSIZE_TABLE[(step_index + TABLES_FLOAT_0_5) >> TABLES_FLOAT_DIGITS]


def clip_step_index(step_index: np.ndarray) -> np.ndarray:
    """Clip a Q4 step index into its legal range [0, 4080]."""
    return np.clip(step_index, 0, STEP_INDEX_MAX)
