"""Kernel 6: the decode output's detile transpose, hand-written for the card.

A port of ``benchmarks/probe_transpose.py``: it asks whether a hand-written
transpose beats the library's on the relayout that the TPU decode ran after
its kernel, (W4, nt, 8, 128) int32 -> (nt, 8, 128, W4), the 2-D transpose of
the (W4, nt * 8 * 128) view. :func:`transpose` moves the first axis of any
int32 tensor last, through ``aad_probe_transpose`` (``csrc/transpose.cu``)
on the card and its plain version, :func:`transpose_reference`
(``x.permute(1, ..., 0).contiguous()``), on the CPU. The plain version is
also the library's time in :func:`main`: one PyTorch call of the same
function.

    python -m aad_tpu_torch.probes.transpose    # on the card

Not carried over from the probe script:

* the Mosaic block specs ((TC, 1, 8, 128) blocks, a (nt, W4 / TC) grid):
  a CTA takes a 64 x 64 tile of the 2-D view and masks the edges itself;
* T1 (one block transpose) and T2 (eight row-wise 2-D transposes), two ways
  to lay the work onto the TPU's (8, 128) vector registers, which have no
  counterpart on this card: one kernel;
* ``interpret_mode``: the CPU runs the plain version instead;
* the perturbed source and token carried through a ``fori_loop``, which kept
  XLA from hoisting a pure transpose out of the timed loop: CUDA events
  around eager launches time each launch as it is made.
"""

from __future__ import annotations

import numpy as np
import torch

from . import HBM_BYTES_PER_S, card, emit, launch, on_device, require_card, time_ms

KERNEL = "aad_probe_transpose"
SHAPE = (512, 64, 8, 128)  # the probe's (W4, nt, 8, 128)
SEED = 0
ITERS = 200

# Launch counts; the wrapper adds one where it launches, and nowhere else.
launches: dict[str, int] = {KERNEL: 0}


def transpose_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``aad_probe_transpose``: the first axis moved last."""
    return x.permute(*range(1, x.dim()), 0).contiguous()


def transpose(x, device="cuda") -> torch.Tensor:
    """``x`` (int32, at least 2-D) with its first axis moved last, on
    ``device``: (A, *rest) -> (*rest, A). The kernel on the card, the plain
    version on the CPU."""
    x = on_device(x, device)
    if x.dim() < 2:
        raise ValueError(f"transpose: need at least 2 axes, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return transpose_reference(x)
    rows, cols = x.shape[0], x.numel() // max(x.shape[0], 1)
    out = torch.empty((*x.shape[1:], rows), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    if x.numel() >= 2**31:
        raise ValueError(f"transpose: {x.numel()} elements, the kernel takes fewer than 2**31")
    launch(KERNEL, x, out, rows, cols)
    launches[KERNEL] += 1
    return out


def moved_bytes(numel: int) -> int:
    """The bytes a call must move: each int32 read once and written once."""
    return 2 * 4 * numel


def bound_ms(numel: int) -> float:
    """The bytes' least time on an H100."""
    return moved_bytes(numel) / HBM_BYTES_PER_S * 1e3


def main(iters: int = ITERS) -> dict:
    """Time the kernel and the library's call at the probe's size, seed 0;
    print and return the result. Raises without a card."""
    dev = require_card()
    x = torch.from_numpy(
        np.random.default_rng(SEED).integers(-(2**31), 2**31, SHAPE, dtype=np.int64).astype(np.int32)
    ).to(dev)
    got = transpose(x)
    want = transpose_reference(x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("aad_probe_transpose != permute().contiguous()")
    del got, want
    # 134 MB in and out: past the 50 MB L2 whatever the order, so one input
    ms = time_ms(transpose, [(x,)], iters)
    library_ms = time_ms(transpose_reference, [(x,)], iters)
    bound = bound_ms(x.numel())
    return emit({
        "probe": "transpose", "shape": list(SHAPE), "ms": ms, "gbps_rw": 2 * 4 * x.numel() / ms / 1e6,
        "library_ms": library_ms, "library_gbps_rw": 2 * 4 * x.numel() / library_ms / 1e6,
        "bound_ms": bound, "share_of_bound": bound / ms, "card": card(),
    })


if __name__ == "__main__":
    main()
