"""Stream framing: .aad payload bytes <-> dense per-block tensors.

Every block header carries the complete decoder state (reference:
src/aad_decoder.c:363-380), so a stream factors into a *dense batch of
independent block-decode tasks*:

    payload bytes --split--> blocks[B, block_size] u8
                  --parse--> BlockStates (step_index/weights/history [B, C, ...])
                  +          codes[B, C, T] u8

All parsing is vectorised integer tensor arithmetic (no per-block Python
loops) and runs on the device the payload lies on. Functions take torch
tensors; numpy arrays are accepted and converted (on the CPU). The final
(possibly short) block is zero-padded into the dense batch; the caller
slices the tail away.

Layout facts (reference: writer src/aad_encoder.c:618-655, reader
src/aad_decoder.c:363-380): per channel the block header is u16BE
``(step_index << 4) | weight_shift`` then 4 x {u16BE weight >> shift, u16BE
history}; history[0] is the newest sample and the decoder emits history[3-i]
as output samples 0..3.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..codec.result import InsufficientDataError
from ..constants import FILTER_ORDER, STEP_INDEX_MAX, TABLES_FLOAT_DIGITS
from ..format.geometry import (
    BlockGeometry,
    encoded_block_bytes,
    encoded_stream_size,
    last_block_valid_samples,
    num_blocks_for,
)
from ..format.header import HeaderInfo
from ..ops.bitpack import pack_codes, unpack_codes
from ..ops.cseman import sign_extend16


class BlockStates(NamedTuple):
    """Decoder-visible state snapshot carried by each block header."""

    step_index: torch.Tensor  # (B, C) int32, Q4 in [0, 4080]
    weight: torch.Tensor      # (B, C, 4) int32 (shift already re-applied)
    history: torch.Tensor     # (B, C, 4) int32 (int16-valued)

    @classmethod
    def from_numpy(cls, states) -> "BlockStates":
        """Any (step_index, weight, history) triple of arrays -> int32 tensors."""
        return cls(*(torch.as_tensor(np.asarray(a), dtype=torch.int32) for a in states))

    def to(self, device) -> "BlockStates":
        return BlockStates(*(a.to(device) for a in self))


class FramedStream(NamedTuple):
    """A stream exploded into dense device-ready tensors."""

    states: BlockStates
    codes: torch.Tensor        # (B, C, T) uint8
    num_blocks: int
    valid_last: int            # valid samples in the final block


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a


def pad_to_blocks(payload, num_blocks: int, geo: BlockGeometry) -> torch.Tensor:
    """The first ``num_blocks`` blocks of ``payload`` as (B, block_size) u8.

    Bytes missing from the end read as zero, and bytes past the blocks are
    ignored.
    """
    payload = _tensor(payload)
    total = num_blocks * geo.block_size
    n = min(payload.shape[-1], total)
    if n == total:
        return payload[:total].reshape(num_blocks, geo.block_size)
    padded = torch.zeros(total, dtype=torch.uint8, device=payload.device)
    padded[:n] = payload[:n]
    return padded.reshape(num_blocks, geo.block_size)


def split_blocks(payload, header: HeaderInfo, geo: BlockGeometry):
    """Split the post-header payload into a dense (B, block_size) u8 batch.

    The final block is zero-padded to ``block_size``. Returns
    (blocks, num_blocks, valid_last).
    """
    payload = _tensor(payload)
    nspb = header.num_samples_per_block
    nblocks = num_blocks_for(header.num_samples, nspb)
    valid_last = last_block_valid_samples(header.num_samples, nspb)
    # Strict: the full wire size declared by the header must be present
    # (trailing garbage beyond it is tolerated — the stream is
    # self-delimiting by num_samples), as in aad_tpu.format.framing.
    need = encoded_stream_size(geo, header.num_samples)
    if payload.shape[-1] < need:
        raise InsufficientDataError(
            f"payload holds {payload.shape[-1]} bytes; "
            f"{need} required for {nblocks} blocks"
        )
    return pad_to_blocks(payload, nblocks, geo), nblocks, valid_last


def parse_block_headers(blocks, geo: BlockGeometry) -> BlockStates:
    """Vectorised block-header state load (reference: src/aad_decoder.c:363-380).

    Each channel's 18 header bytes are nine big-endian u16 fields: the
    step-index tag, then weight and history for each of the four taps.
    All fields of all channels are read at once, a handful of device ops
    whatever the channel count.
    """
    blocks = _tensor(blocks)
    per_ch = 2 + 4 * FILTER_ORDER  # 18 bytes
    fields = blocks[..., : geo.num_channels * per_ch].reshape(
        *blocks.shape[:-1], geo.num_channels, per_ch // 2, 2
    ).to(torch.int32)
    u16 = (fields[..., 0] << 8) | fields[..., 1]  # (..., C, 9)
    tag = u16[..., 0]
    taps = sign_extend16(u16[..., 1:])  # (..., C, 8): w0, h0, w1, h1, ...
    # Parse-clamp: the 12-bit wire field reaches (4080, 4095] only on
    # malformed streams (slot 256, out of the step table — UB in the
    # reference, src/aad_tables.h:28); every engine pins those to 4080 at
    # header parse so adversarial input cannot diverge them.
    return BlockStates(
        step_index=torch.clamp(tag >> TABLES_FLOAT_DIGITS, max=STEP_INDEX_MAX),
        # Weights were stored >> shift; re-apply the shift on load
        # (reference: src/aad_decoder.c:375-376).
        weight=taps[..., 0::2] << (tag & 0xF)[..., None],
        history=taps[..., 1::2].contiguous(),
    )


def block_codes(blocks: torch.Tensor, geo: BlockGeometry) -> torch.Tensor:
    """(B, block_size) u8 blocks -> (B, C, T) u8 codes."""
    return unpack_codes(blocks[:, geo.header_bytes : geo.header_bytes + geo.data_bytes], geo)


def frame_stream(payload, header: HeaderInfo, geo: BlockGeometry) -> FramedStream:
    """payload bytes -> (states, codes) dense batch."""
    blocks, nblocks, valid_last = split_blocks(payload, header, geo)
    states = parse_block_headers(blocks, geo)
    return FramedStream(states, block_codes(blocks, geo), nblocks, valid_last)


def build_block_headers(states: BlockStates, shifts, geo: BlockGeometry) -> torch.Tensor:
    """Serialise per-block header bytes from states + per-channel weight shifts.

    ``states.weight`` must already be rounded (low ``shift`` bits cleared) by
    the encoder (reference: src/aad_encoder.c:637-641). Returns
    (B, header_bytes) uint8.
    """
    states = BlockStates(*(_tensor(a).to(torch.int32) for a in states))
    shifts = _tensor(shifts).to(torch.int32)
    parts = []
    for ch in range(geo.num_channels):
        shift = shifts[..., ch]
        tag = (states.step_index[..., ch] << TABLES_FLOAT_DIGITS) | (shift & 0xF)
        fields = [tag]
        for k in range(FILTER_ORDER):
            fields.append((states.weight[..., ch, k] >> shift) & 0xFFFF)
            fields.append(states.history[..., ch, k] & 0xFFFF)
        u16s = torch.stack(fields, dim=-1)  # (B, 1+8), 16 bits used
        b = torch.stack([(u16s >> 8) & 0xFF, u16s & 0xFF], dim=-1)
        parts.append(b.reshape(*b.shape[:-2], -1))
    return torch.cat(parts, dim=-1).to(torch.uint8)


def assemble_stream(header_bytes_arr, codes, geo: BlockGeometry, num_samples: int) -> torch.Tensor:
    """(B, header_bytes) + (B, C, T) codes -> contiguous payload bytes.

    The final block is truncated to whole interleave units covering its valid
    samples (reference: src/aad_encoder.c:661-726 loop bounds + EncodeWhole's
    write_size accounting).
    """
    data = pack_codes(_tensor(codes), geo)  # (B, data_bytes)
    full = torch.cat([_tensor(header_bytes_arr), data], dim=-1)  # (B, block_size)
    nblocks = full.shape[0]
    valid_last = last_block_valid_samples(num_samples, geo.num_samples_per_block)
    tail_bytes = encoded_block_bytes(geo, valid_last)
    return torch.cat([full[: nblocks - 1].reshape(-1), full[nblocks - 1, :tail_bytes]])
