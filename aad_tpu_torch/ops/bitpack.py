"""Vectorised 2/3/4-bit code <-> byte packing.

The data region of a block is a sequence of channel-interleaved pack units
(reference: src/aad_encoder.c:661-722, src/aad_decoder.c:394-455):

* 4-bit: per unit, per channel, 1 byte  = 2 codes, high nibble first
* 3-bit: per unit, per channel, 3 bytes = 8 codes, MSB-first 24-bit word
* 2-bit: per unit, per channel, 1 byte  = 4 codes, MSB-first pairs

Pure reshape / shift / mask tensor ops that vectorise over any batch of
blocks and run on whatever device the input lies on. Both functions take a
torch tensor or a numpy array and return the same kind. The 3-bit word is
held as int32 (24 bits): ``torch.uint32`` has no CPU ``>>``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..format.geometry import BlockGeometry

__all__ = ["unpack_codes", "pack_codes"]


def _as_tensor(a):
    """(tensor, was_numpy): numpy arrays go through torch and come back."""
    if isinstance(a, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(a)), True
    return a, False


def _shifts_3bit(device) -> torch.Tensor:
    return torch.arange(21, -1, -3, dtype=torch.int32, device=device)  # 21..0


def unpack_codes(data, geo: BlockGeometry):
    """Data-region bytes -> codes.

    Args:
      data: (..., data_bytes) uint8 block data regions.
    Returns:
      (..., num_channels, codes_per_block) uint8 codes in decode order.
    """
    data, was_numpy = _as_tensor(data)
    nch, bps = geo.num_channels, geo.bits_per_sample
    units = data.reshape(*data.shape[:-1], geo.num_units, nch, geo.unit_bytes // nch)

    if bps == 4:
        b = units[..., 0].to(torch.uint8)
        codes = torch.stack([(b >> 4) & 0xF, b & 0xF], dim=-1)
    elif bps == 2:
        b = units[..., 0].to(torch.uint8)
        codes = torch.stack(
            [(b >> 6) & 0x3, (b >> 4) & 0x3, (b >> 2) & 0x3, b & 0x3], dim=-1
        )
    elif bps == 3:
        u = units.to(torch.int32)
        word = (u[..., 0] << 16) | (u[..., 1] << 8) | u[..., 2]
        codes = ((word[..., None] >> _shifts_3bit(data.device)) & 0x7).to(torch.uint8)
    else:  # pragma: no cover - geometry construction rejects this
        raise ValueError(f"unsupported bits_per_sample: {bps}")

    # (..., units, nch, samples_per_unit) -> (..., nch, units*samples_per_unit)
    codes = codes.transpose(-2, -3)
    codes = codes.reshape(*codes.shape[:-2], geo.num_units * geo.samples_per_unit)
    return codes.numpy() if was_numpy else codes


def pack_codes(codes, geo: BlockGeometry):
    """Codes -> data-region bytes (inverse of :func:`unpack_codes`).

    Args:
      codes: (..., num_channels, codes_per_block) integer codes.
    Returns:
      (..., data_bytes) uint8.
    """
    codes, was_numpy = _as_tensor(codes)
    bps = geo.bits_per_sample
    spu = geo.samples_per_unit
    # (..., nch, units, spu) -> (..., units, nch, spu)
    c = codes.reshape(*codes.shape[:-1], geo.num_units, spu)
    c = c.transpose(-2, -3).to(torch.int32)

    if bps == 4:
        data = ((c[..., 0] << 4) | c[..., 1]).to(torch.uint8)[..., None]
    elif bps == 2:
        data = (
            (c[..., 0] << 6) | (c[..., 1] << 4) | (c[..., 2] << 2) | c[..., 3]
        ).to(torch.uint8)[..., None]
    else:  # bps == 3
        word = (c << _shifts_3bit(c.device)).sum(dim=-1)  # int64, 24 bits used
        data = torch.stack(
            [(word >> 16) & 0xFF, (word >> 8) & 0xFF, word & 0xFF], dim=-1
        ).to(torch.uint8)

    data = data.reshape(*data.shape[:-3], geo.data_bytes)
    return data.numpy() if was_numpy else data
