"""File-header codec: the 31-byte big-endian .aad header.

Byte map (reference: src/aad_encoder.c:188-217 writer,
src/aad_decoder.c:119-165 reader; offsets pinned by the reference's
header-fuzz tests, test/test_aad_decoder.c:95-185):

    off size field
      0    4 magic "AAD\\0"
      4    4 format_version (must be 4)
      8    4 codec_version  (must be 18)
     12    2 num_channels
     14    4 num_samples (per channel)
     18    4 sampling_rate
     22    2 bits_per_sample
     24    2 block_size (bytes)
     26    4 num_samples_per_block
     30    1 ch_process_method (0 = none, 1 = mid/side)
"""

from __future__ import annotations

import dataclasses
import struct

from ..codec.result import (
    InsufficientDataError,
    InvalidFormatError,
)
from ..constants import (
    CH_PROCESS_INVALID,
    CH_PROCESS_MS,
    CODEC_VERSION,
    FILE_HEADER_SIZE,
    FORMAT_VERSION,
    MAX_BITS_PER_SAMPLE,
    MAX_NUM_CHANNELS,
    MIN_BITS_PER_SAMPLE,
    block_header_size,
)

_MAGIC = b"AAD\x00"
_STRUCT = struct.Struct(">4sIIHIIHHIB")
assert _STRUCT.size == FILE_HEADER_SIZE


@dataclasses.dataclass
class HeaderInfo:
    """Decoded .aad stream header (reference: src/aad.h:43-53)."""

    num_channels: int
    num_samples: int
    sampling_rate: int
    bits_per_sample: int
    block_size: int
    num_samples_per_block: int
    ch_process_method: int
    format_version: int = FORMAT_VERSION
    codec_version: int = CODEC_VERSION


def _check_common(h: HeaderInfo) -> None:
    """Field checks shared by encode and decode validation.

    Ordering mirrors the reference so the first failing field matches
    (reference: src/aad_decoder.c:173-225, src/aad_encoder.c:149-185).
    """
    if h.num_channels == 0 or h.num_channels > MAX_NUM_CHANNELS:
        raise InvalidFormatError(f"bad num_channels: {h.num_channels}")
    if h.num_samples == 0:
        raise InvalidFormatError("num_samples must be > 0")
    if h.sampling_rate == 0:
        raise InvalidFormatError("sampling_rate must be > 0")
    if not MIN_BITS_PER_SAMPLE <= h.bits_per_sample <= MAX_BITS_PER_SAMPLE:
        raise InvalidFormatError(f"bad bits_per_sample: {h.bits_per_sample}")
    if h.block_size <= block_header_size(h.num_channels):
        raise InvalidFormatError(f"block_size too small: {h.block_size}")
    if h.num_samples_per_block == 0:
        raise InvalidFormatError("num_samples_per_block must be > 0")
    if h.ch_process_method >= CH_PROCESS_INVALID:
        raise InvalidFormatError(f"bad ch_process_method: {h.ch_process_method}")
    if h.ch_process_method == CH_PROCESS_MS and h.num_channels == 1:
        raise InvalidFormatError("mid/side needs 2 channels")


def decode_header(data: bytes) -> HeaderInfo:
    """Parse and return the stream header without validating versions."""
    if len(data) < FILE_HEADER_SIZE:
        raise InsufficientDataError(
            f"need {FILE_HEADER_SIZE} header bytes, got {len(data)}"
        )
    (
        magic,
        format_version,
        codec_version,
        num_channels,
        num_samples,
        sampling_rate,
        bits_per_sample,
        block_size,
        num_samples_per_block,
        ch_process_method,
    ) = _STRUCT.unpack_from(data)
    if magic != _MAGIC:
        raise InvalidFormatError("bad magic")
    return HeaderInfo(
        format_version=format_version,
        codec_version=codec_version,
        num_channels=num_channels,
        num_samples=num_samples,
        sampling_rate=sampling_rate,
        bits_per_sample=bits_per_sample,
        block_size=block_size,
        num_samples_per_block=num_samples_per_block,
        ch_process_method=ch_process_method,
    )


def validate_header(h: HeaderInfo) -> None:
    """Full decode-side validation, including the strict version pin."""
    if h.format_version != FORMAT_VERSION:
        raise InvalidFormatError(f"unsupported format_version: {h.format_version}")
    if h.codec_version != CODEC_VERSION:
        raise InvalidFormatError(f"unsupported codec_version: {h.codec_version}")
    _check_common(h)


def encode_header(h: HeaderInfo) -> bytes:
    """Serialise a stream header.

    Version fields are ignored and the pinned constants written, matching the
    reference writer (reference: src/aad_encoder.c:195-200).
    """
    _check_common(h)
    return _STRUCT.pack(
        _MAGIC,
        FORMAT_VERSION,
        CODEC_VERSION,
        h.num_channels,
        h.num_samples,
        h.sampling_rate,
        h.bits_per_sample,
        h.block_size,
        h.num_samples_per_block,
        h.ch_process_method,
    )
