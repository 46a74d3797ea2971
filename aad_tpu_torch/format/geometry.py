"""Block geometry: block size and samples-per-block arithmetic.

A block is ``block_header || channel-interleaved pack units``. The data
region is truncated down to a whole number of interleave units, and the four
history samples carried in the block header count toward samples-per-block
(reference: src/aad_encoder.c:85-131, src/aad_internal.h:40-45).
"""

from __future__ import annotations

import dataclasses
import math

from ..codec.result import InvalidArgumentError, InvalidFormatError
from ..constants import (
    FILTER_ORDER,
    MAX_BITS_PER_SAMPLE,
    MAX_NUM_CHANNELS,
    block_header_size,
)


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    """Static layout facts for one codec configuration.

    Everything the device pipeline needs to lay out code/byte tensors:
    derived once on the host from the stream header.
    """

    num_channels: int
    bits_per_sample: int
    block_size: int               # bytes, including the block header
    num_samples_per_block: int    # per channel, including 4 header samples
    header_bytes: int             # block header bytes (all channels)
    data_bytes: int               # data region bytes (all channels)
    unit_bytes: int               # one interleave unit, all channels
    samples_per_unit: int         # samples per channel per interleave unit
    num_units: int                # units in a full block

    @property
    def codes_per_block(self) -> int:
        """Code slots per channel in a full block (excludes header samples)."""
        return self.num_samples_per_block - FILTER_ORDER


def compute_block_geometry(
    max_block_size: int, num_channels: int, bits_per_sample: int
) -> BlockGeometry:
    """Derive block layout from a maximum block size.

    Mirrors the reference's block-size derivation exactly, including the
    truncation to whole interleave units (reference: src/aad_encoder.c:110-129).
    Raises :class:`InvalidFormatError` on out-of-range parameters, matching
    the reference validation order.
    """
    if max_block_size is None:
        raise InvalidArgumentError("max_block_size is required")
    if (
        num_channels == 0
        or num_channels > MAX_NUM_CHANNELS
        or bits_per_sample == 0
        or bits_per_sample > MAX_BITS_PER_SAMPLE
    ):
        raise InvalidFormatError(
            f"unsupported geometry: {num_channels=} {bits_per_sample=}"
        )
    header_bytes = block_header_size(num_channels)
    if max_block_size < header_bytes:
        raise InvalidFormatError("max_block_size cannot fit the block header")

    lcm = 8 * bits_per_sample // math.gcd(8, bits_per_sample)
    unit_bytes = num_channels * (lcm // 8)
    samples_per_unit = (unit_bytes * 8) // (num_channels * bits_per_sample)

    data_bytes = max_block_size - header_bytes
    num_units = data_bytes // unit_bytes
    data_bytes = unit_bytes * num_units

    return BlockGeometry(
        num_channels=num_channels,
        bits_per_sample=bits_per_sample,
        block_size=header_bytes + data_bytes,
        num_samples_per_block=samples_per_unit * num_units + FILTER_ORDER,
        header_bytes=header_bytes,
        data_bytes=data_bytes,
        unit_bytes=unit_bytes,
        samples_per_unit=samples_per_unit,
        num_units=num_units,
    )


def calculate_block_size(
    max_block_size: int, num_channels: int, bits_per_sample: int
) -> tuple[int, int]:
    """(block_size, num_samples_per_block) — reference-compatible signature."""
    geo = compute_block_geometry(max_block_size, num_channels, bits_per_sample)
    return geo.block_size, geo.num_samples_per_block


def geometry_from_header(num_channels: int, bits_per_sample: int, block_size: int) -> BlockGeometry:
    """Reconstruct block layout from decoded header fields.

    The stream header stores the final ``block_size`` (already truncated to
    whole units by the encoder), so the derivation is exact. Raises
    :class:`InvalidFormatError` if the stored size is not unit-aligned —
    such a stream cannot have been produced by a conforming encoder.
    """
    if (
        num_channels == 0
        or num_channels > MAX_NUM_CHANNELS
        or bits_per_sample == 0
        or bits_per_sample > MAX_BITS_PER_SAMPLE
    ):
        raise InvalidFormatError(
            f"unsupported geometry: {num_channels=} {bits_per_sample=}"
        )
    geo = compute_block_geometry(block_size, num_channels, bits_per_sample)
    if geo.block_size != block_size:
        raise InvalidFormatError(
            f"block_size {block_size} is not aligned to "
            f"{geo.unit_bytes}-byte interleave units"
        )
    return geo


def num_blocks_for(num_samples: int, num_samples_per_block: int) -> int:
    """Blocks needed to carry ``num_samples`` samples per channel."""
    if num_samples <= 0:
        return 0
    return -(-num_samples // num_samples_per_block)


def last_block_valid_samples(num_samples: int, num_samples_per_block: int) -> int:
    """Valid samples in the final block."""
    rem = num_samples % num_samples_per_block
    return rem if rem else num_samples_per_block


def lenient_prefix(
    geo: BlockGeometry, num_samples: int, payload_bytes: int
) -> tuple[int, int]:
    """Decodable (blocks, samples) of a truncated payload, lenient mode.

    The lenient (decode-what's-there) contract: a block chunk counts iff
    its block header is fully present — the last, partial one decodes with
    the missing trailing bytes as zero codes (reference loop exit:
    src/aad_decoder.c:514-538). Used by
    ``Decoder.decode_payload_ondevice(strict=False)``; identical to
    ``aad_tpu.format.geometry.lenient_prefix``.
    """
    nblocks = num_blocks_for(num_samples, geo.num_samples_per_block)
    full_b, rem = divmod(int(payload_bytes), geo.block_size)
    nb_avail = min(nblocks, full_b + (1 if rem >= geo.header_bytes else 0))
    decoded_n = min(num_samples, nb_avail * geo.num_samples_per_block)
    return nb_avail, decoded_n


def encoded_block_bytes(geo: BlockGeometry, valid_samples: int) -> int:
    """On-the-wire size of a block holding ``valid_samples`` samples.

    The encoder writes whole interleave units and stops at the unit containing
    the last valid sample; a block with <= FILTER_ORDER samples is header-only
    (reference: src/aad_encoder.c:661-726 loop bounds).
    """
    coded = max(0, valid_samples - FILTER_ORDER)
    units = -(-coded // geo.samples_per_unit)
    return geo.header_bytes + units * geo.unit_bytes


def encoded_stream_size(geo: BlockGeometry, num_samples: int) -> int:
    """Total .aad payload size (excluding the 31-byte file header)."""
    nblocks = num_blocks_for(num_samples, geo.num_samples_per_block)
    if nblocks == 0:
        return 0
    full = (nblocks - 1) * geo.block_size
    tail = encoded_block_bytes(
        geo, last_block_valid_samples(num_samples, geo.num_samples_per_block)
    )
    return full + tail
