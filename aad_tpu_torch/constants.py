"""Codec-wide constants for the AAD bitstream format.

These mirror the on-the-wire format constants of the reference implementation
(reference: src/aad.h:7-22, src/aad_internal.h:10-45). They are format
invariants — any change breaks bitstream compatibility.
"""

from __future__ import annotations

# --- Versioning (reference: src/aad.h:7-10) -------------------------------
# The decoder hard-rejects any other version (reference: src/aad_decoder.c:178-187),
# so the encoder must write exactly these.
CODEC_VERSION = 18
FORMAT_VERSION = 4

# --- Channel / bit-depth limits (reference: src/aad.h:13-19) ---------------
MAX_NUM_CHANNELS = 2
MIN_BITS_PER_SAMPLE = 2
MAX_BITS_PER_SAMPLE = 4

# --- Layout (reference: src/aad.h:22, src/aad_internal.h:37) ---------------
FILE_HEADER_SIZE = 31          # bytes; fixed-offset big-endian fields

# Per-channel block header: u16 (step index<<4 | weight shift) followed by
# FILTER_ORDER x (u16 weight, u16 history) = 2 + 4*4 = 18 bytes.
def block_header_size(num_channels: int) -> int:
    """Byte size of a block header (reference: src/aad_internal.h:37)."""
    return (4 * FILTER_ORDER + 2) * num_channels


# --- Fixed-point codec parameters (reference: src/aad_internal.h:10-13) ----
FILTER_ORDER = 4               # adaptive predictor taps
FIXEDPOINT_DIGITS = 15         # Q15 weights
FIXEDPOINT_0_5 = 1 << (FIXEDPOINT_DIGITS - 1)   # rounding constant 16384
LMSFILTER_SHIFT = 3            # extra shift in the sign-LMS weight update

# --- Step-size table parameters (reference: src/aad_tables.h:9-17) ---------
STEPSIZE_TABLE_SIZE = 256
TABLES_FLOAT_DIGITS = 4        # Q4 fixed point for the step index
TABLES_FLOAT_0_5 = 1 << (TABLES_FLOAT_DIGITS - 1)
STEP_INDEX_MAX = (STEPSIZE_TABLE_SIZE - 1) << TABLES_FLOAT_DIGITS  # 4080

# --- Sample-domain limits --------------------------------------------------
INT16_MIN = -32768
INT16_MAX = 32767

# --- Channel processing methods (reference: src/aad.h:36-40) ---------------
CH_PROCESS_NONE = 0
CH_PROCESS_MS = 1
CH_PROCESS_INVALID = 2         # first invalid enum value


def samples_per_interleave_unit(bits_per_sample: int) -> int:
    """Samples per channel carried by one interleave unit.

    The pack unit is lcm(8, bps) bits per channel (reference:
    src/aad_encoder.c:111-112): 2 samples for 4-bit, 8 for 3-bit, 4 for 2-bit.
    """
    import math

    lcm = 8 * bits_per_sample // math.gcd(8, bits_per_sample)
    return lcm // bits_per_sample


def interleave_unit_bytes(num_channels: int, bits_per_sample: int) -> int:
    """Bytes of one channel-interleaved pack unit (all channels)."""
    import math

    lcm = 8 * bits_per_sample // math.gcd(8, bits_per_sample)
    return num_channels * (lcm // 8)
