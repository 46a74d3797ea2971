"""C-integer semantics on torch int32 tensors.

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
* ``/`` truncates toward zero (``rounding_mode="trunc"``), unlike Python's
  floor division;
* clips use the MAX(min, MIN(max, v)) composition (reference:
  src/aad_internal.h:28).

``torch.uint32`` has no CPU ``>>``, so unsigned words are held as int32 or
int64 throughout the package.

The trial search's squared-error sum is an int64 sum of *wrapped* int32
squares (reference: src/aad_encoder.c:459-461; see :func:`sse_better`).
``aad_tpu`` carries it as two uint32 limbs (``s64_add_i32``, ``u64_*``)
because the TPU's lanes are 32 bits wide; torch and CUDA have int64, so
those are not carried over.
"""

from __future__ import annotations

import torch

from ..constants import INT16_MAX, INT16_MIN

I32 = torch.int32


def asr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Arithmetic shift right (C ``>>`` on int32)."""
    return x.to(I32) >> n


def shl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Left shift with int32 wraparound (C ``<<`` on int32)."""
    return x.to(I32) << n


def trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C integer division: truncates toward zero."""
    return torch.div(a.to(I32), b.to(I32), rounding_mode="trunc")


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


def wrapped_square(x: torch.Tensor) -> torch.Tensor:
    """(int32)(x * x): the reference's wrapping product, as int32."""
    x = x.to(I32)
    return x * x


def sse_better(cand: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """The reference's ``min_rmse > tmp_rmse`` in exact integer form.

    ``cand`` and ``best`` are int64 sums of wrapped int32 squares. The
    reference compares sqrt(sum / n) in IEEE double (src/aad_encoder.c:465,
    552): every term is below 2**31 in magnitude, so the double sums are
    exact, and a negative sum gives sqrt(NaN), which compares false. So
    the candidate is better iff both sums are non-negative and it is
    strictly smaller.
    """
    return (cand >= 0) & (best >= 0) & (cand < best)
