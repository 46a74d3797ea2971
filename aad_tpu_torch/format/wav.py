"""Minimal RIFF/WAVE reader & writer (PCM only), numpy-vectorised.

Matches the reference's WAV subset (reference: src/wav.c): linear PCM only
(format tag 1), unknown chunks skipped, fmt-extension bytes skipped, sample
count derived from the data-chunk byte size. The in-memory canonical form is
**left-justified int32** per sample regardless of file depth (reference:
src/wav.h:7, converters src/wav.c:391-436):

    8-bit:  (raw - 128) << 24        (unsigned with 128 offset)
    16-bit: raw << 16
    24-bit: raw << 8
    32-bit: raw

PCM arrays are (num_channels, num_samples) int32.

Host numpy only: the port's own copy of ``aad_tpu.format.wav``, which it
may not import.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..codec.result import InvalidFormatError


@dataclasses.dataclass
class WavFormat:
    num_channels: int
    sampling_rate: int
    bits_per_sample: int
    num_samples: int


def _decode_pcm(raw: np.ndarray, depth: int, nch: int) -> np.ndarray:
    """Interleaved little-endian sample bytes -> canonical (C, N) int32."""
    if depth == 8:
        samples = raw.astype(np.int32) - 128
        samples <<= 24
    elif depth == 16:
        samples = raw.view("<i2").astype(np.int32) << 16
    elif depth == 24:
        b = raw.reshape(-1, 3).astype(np.uint32)
        u = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        signed = u.astype(np.int32)
        signed = np.where(signed >= 1 << 23, signed - (1 << 24), signed)
        samples = signed << 8
    elif depth == 32:
        samples = raw.view("<i4").astype(np.int32)
    else:
        raise InvalidFormatError(f"unsupported bits_per_sample: {depth}")
    return samples.reshape(-1, nch).T.copy()


def _encode_pcm(pcm: np.ndarray, depth: int) -> bytes:
    """Canonical (C, N) int32 -> interleaved little-endian sample bytes."""
    inter = pcm.T.reshape(-1).astype(np.int32)
    if depth == 8:
        return (((inter >> 24) + 128) & 0xFF).astype(np.uint8).tobytes()
    if depth == 16:
        return (inter >> 16).astype("<i2").tobytes()
    if depth == 24:
        v = (inter >> 8).astype(np.uint32)
        out = np.empty((v.size, 3), dtype=np.uint8)
        out[:, 0] = v & 0xFF
        out[:, 1] = (v >> 8) & 0xFF
        out[:, 2] = (v >> 16) & 0xFF
        return out.tobytes()
    if depth == 32:
        return inter.astype("<i4").tobytes()
    raise InvalidFormatError(f"unsupported bits_per_sample: {depth}")


def read_wav(path: str) -> tuple[WavFormat, np.ndarray]:
    """Read a PCM WAV file; returns (format, pcm[C, N] int32 canonical)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise InvalidFormatError("not a RIFF/WAVE file")

    fmt = None
    pcm_bytes = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + csize]
        if cid == b"fmt ":
            try:
                tag, nch, rate, _, _, depth = struct.unpack_from("<HHIIHH", body, 0)
            except struct.error as e:
                raise InvalidFormatError(f"truncated fmt chunk: {e}") from None
            if tag != 1:  # linear PCM only (reference: src/wav.c:144-148)
                raise InvalidFormatError(f"unsupported WAVE format tag: {tag}")
            if nch < 1:
                raise InvalidFormatError(f"invalid channel count: {nch}")
            if depth not in (8, 16, 24, 32):
                # early: a sub-byte depth would make the frame size 0 below
                raise InvalidFormatError(f"unsupported bits_per_sample: {depth}")
            fmt = (nch, rate, depth)
        elif cid == b"data":
            pcm_bytes = body
        # all other chunks skipped (reference: src/wav.c:176-193)
        pos += 8 + csize + (csize & 1)  # chunks are word-aligned

    if fmt is None or pcm_bytes is None:
        raise InvalidFormatError("missing fmt or data chunk")
    nch, rate, depth = fmt
    frame = nch * depth // 8
    num_samples = len(pcm_bytes) // frame
    raw = np.frombuffer(pcm_bytes[: num_samples * frame], dtype=np.uint8)
    pcm = _decode_pcm(raw, depth, nch)
    return WavFormat(nch, rate, depth, num_samples), pcm


class WavWriteError(OSError):
    """A WAV output failed *after* the file opened (e.g. disk full mid-write).

    Distinct from the plain OSError an ``open()`` failure raises so callers
    (the CLI) can report open vs write failures accurately."""


def write_wav(path: str, fmt: WavFormat, pcm: np.ndarray) -> None:
    """Write canonical (C, N) int32 PCM to a WAV file at ``fmt.bits_per_sample``.

    Open failures propagate as plain OSError; failures after a successful
    open raise WavWriteError.
    """
    nch = fmt.num_channels
    depth = fmt.bits_per_sample
    payload = _encode_pcm(np.asarray(pcm, dtype=np.int32), depth)
    byte_rate = fmt.sampling_rate * nch * depth // 8
    block_align = nch * depth // 8
    fmt_chunk = struct.pack(
        "<HHIIHH", 1, nch, fmt.sampling_rate, byte_rate, block_align, depth
    )
    size = 4 + (8 + len(fmt_chunk)) + (8 + len(payload))
    f = open(path, "wb")  # open failures stay plain OSError
    try:
        with f:
            f.write(b"RIFF" + struct.pack("<I", size) + b"WAVE")
            f.write(b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk)
            f.write(b"data" + struct.pack("<I", len(payload)) + payload)
    except OSError as e:
        raise WavWriteError(e.errno or 0, e.strerror or str(e), path) from None
