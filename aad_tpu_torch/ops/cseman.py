"""C-integer semantics on torch int32 tensors (decode subset).

The wire format is defined by a C89 implementation compiled on a
two's-complement machine, so bit-exactness requires reproducing C's integer
behaviour precisely (reference hot loop: src/aad_decoder.c:269-318). The
rules this module pins down, mirrored for the CUDA kernels by
``csrc/cseman.cuh``:

* all arithmetic is int32 with two's-complement wraparound — torch's int32
  ``+``, ``-`` and ``*`` wrap on the CPU and on CUDA;
* reductions do NOT: ``torch.sum`` promotes int32 to int64, so a sum that
  must wrap is written as explicit int32 adds;
* ``>>`` on signed values is an *arithmetic* shift (torch's ``>>`` on int32);
* clips use the MAX(min, MIN(max, v)) composition (reference:
  src/aad_internal.h:28).

``torch.uint32`` has no CPU ``>>``, so unsigned words are held as int32 or
int64 throughout the package.
"""

from __future__ import annotations

import torch

from ..constants import INT16_MAX, INT16_MIN

I32 = torch.int32


def asr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Arithmetic shift right (C ``>>`` on int32)."""
    return x.to(I32) >> n


def clip(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """AAD_INNER_VAL: max(lo, min(hi, x))."""
    return torch.clamp(x.to(I32), min=lo, max=hi)


def clip16(x: torch.Tensor) -> torch.Tensor:
    """Clip to the int16 sample range (reference: src/aad_internal.h:28)."""
    return clip(x, INT16_MIN, INT16_MAX)


def sign_extend16(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret the low 16 bits as an int16, result int32.

    Mirrors the C ``(int16_t)u16`` casts used when loading block headers
    (reference: src/aad_decoder.c:370-378).
    """
    x = x.to(I32) & 0xFFFF
    return torch.where(x >= 0x8000, x - 0x10000, x)
