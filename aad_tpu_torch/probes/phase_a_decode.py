"""Kernel 7: the decode chain split five ways, hand-written for the card.

A port of ``benchmarks/probe_phase_a_decode.py``: it asks what each half of
the decode step costs, and whether computing the qdiffs apart from the LMS
(phase A, then phase B) beats the combined loop of kernel 1 on this card.
:func:`decode` runs one form, ``aad_probe_phase_a`` (``csrc/phase_a_decode.cu``)
on the card or its plain version, :func:`decode_reference`, on the CPU, on
time-major (W, L) 32-bit code words (code k of a word at bits 4k, 4-bit),
every lane from the zero state, and returns time-major (8W, L) int16:

* ``full``: the decode step;
* ``lms_only``: the LMS on the fake qdiff ``((word >> 2k) & 0x3FF) - 512``;
* ``qdiff_only``: the index chain and the qdiffs, no LMS; the running sum
  ``h0 + q`` of the qdiffs, cut to int16 (phase A as a kernel);
* ``two_loop``: a chunk's qdiffs into shared memory, then the LMS over them;
* ``pipelined``: one loop, word i + 1's qdiffs beside word i's LMS.

``two_loop`` and ``pipelined`` compute what ``full`` computes.

    python -m aad_tpu_torch.probes.phase_a_decode    # on the card

Not carried over from the probe script:

* the Mosaic block specs ((w_chunk, 1, 8 r, 128) word blocks, a (tiles / r,
  W / w_chunk) grid, the state in VMEM scratch across grid steps): a thread
  is a lane and walks all its words with the state in registers;
* the sublane fold ``r``, which has no meaning here: the CTA's lane count
  (``cta_lanes``) takes its place as the knob, and ``two_loop``'s chunk
  (``w_chunk``) is sized from it to fit a CTA's shared memory;
* the u32 output words of packed sample pairs: the kernel writes int16 (the
  same bytes, two samples a word, little-endian);
* the f32 step-size formula and its correction set: the kernel reads the
  exact int table (``ops/fused_decode.py`` says why);
* ``interpret_mode``: the CPU runs the plain version instead;
* the donated, perturbed words carried through a ``fori_loop``, which kept
  XLA from hoisting the launch out of the timed loop: CUDA events around
  eager launches, over input copies rotated past the L2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.decode import compute_qdiffs_prefix, lms_scan
from ..ops.transitions import index_table, stepsize_table
from . import (
    BPS, CODES_PER_WORD, CTA_LANES, HBM_BYTES_PER_S, card, check_words, copies, emit, launch, on_device,
    require_card, time_ms, unpack_words,
)

KERNEL = "aad_probe_phase_a"
VARIANTS = ("full", "lms_only", "qdiff_only", "two_loop", "pipelined")
SAME_AS_FULL = ("two_loop", "pipelined")
SCRATCH_BYTES = 32 * 1024  # two_loop's qdiffs a CTA: 16 words a lane at 64 lanes
LANES = 28 * 1024  # the probe's 28 lane tiles of 1,024
WORDS = 256
SEED = 0
ITERS = 50
ROTATE = 4  # input copies timed in turn: 4 x 29.4 MB of words, past the 50 MB L2

# Launch counts, one a variant; the wrapper adds one where it launches, and nowhere else.
launches: dict[str, int] = {f"{KERNEL}[{v}]": 0 for v in VARIANTS}


def chunk_words(cta_lanes: int) -> int:
    """two_loop's chunk: the words whose qdiffs fill SCRATCH_BYTES at ``cta_lanes`` lanes a CTA."""
    return max(1, SCRATCH_BYTES // (4 * CODES_PER_WORD * cta_lanes))


def _check(variant: str, cta_lanes: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"phase_a_decode: variant {variant!r} not in {VARIANTS}")
    if cta_lanes % 32 or not 32 <= cta_lanes <= 1024:
        raise ValueError(f"phase_a_decode: cta_lanes {cta_lanes} must be a multiple of 32 in [32, 1024]")


def decode_reference(words: torch.Tensor, variant: str) -> torch.Tensor:
    """Plain version of ``aad_probe_phase_a``, on any device: (W, L) int32
    code words -> (8W, L) int16, what the probe's kernel computes (:108-237)
    from the port's plain phases: the qdiffs of phase A
    (``ops.decode.compute_qdiffs_prefix``), or the fake ones of
    ``lms_only``; their running sum for ``qdiff_only``; else the LMS of
    phase B (``ops.decode.lms_scan``) from the zero state."""
    _check(variant, CTA_LANES)
    W, L = check_words(words, "decode_reference")
    zero = torch.zeros(L, dtype=torch.int32, device=words.device)
    if variant == "lms_only":
        shifts = 2 * torch.arange(CODES_PER_WORD, dtype=torch.int32, device=words.device)
        q = (((words[:, None, :] >> shifts[None, :, None]) & 0x3FF) - 512).reshape(-1, L)
    else:
        q = compute_qdiffs_prefix(unpack_words(words), zero, BPS, dim=0)
    if variant == "qdiff_only":
        # int64 sums: their low 16 bits are those of the wrapping int32 sum
        return (((q.cumsum(0) + 32768) & 0xFFFF) - 32768).to(torch.int16)
    state = torch.zeros((L, 4), dtype=torch.int32, device=words.device)
    return lms_scan(q.t(), state, state).t().to(torch.int16).contiguous()


def decode(words, variant: str = "full", *, cta_lanes: int = CTA_LANES, device="cuda") -> torch.Tensor:
    """The decode chain in form ``variant`` over (W, L) 32-bit code words
    (array or tensor, uint32 or int32) on ``device``, each lane from the zero
    state; returns time-major (8W, L) int16. ``cta_lanes``: threads a CTA of
    the kernel (a multiple of 32), which also sizes ``two_loop``'s chunk."""
    _check(variant, cta_lanes)
    words = on_device(words, device)
    W, L = check_words(words, "decode")
    if words.device.type == "cpu":
        return decode_reference(words, variant)
    out = torch.empty((CODES_PER_WORD * W, L), dtype=torch.int16, device=words.device)
    if out.numel() == 0:
        return out
    launch(KERNEL, words, stepsize_table(words.device), index_table(BPS, words.device), out, W, L,
           VARIANTS.index(variant), cta_lanes, chunk_words(cta_lanes))
    launches[f"{KERNEL}[{variant}]"] += 1
    return out


def moved_bytes(num_words: int, num_lanes: int) -> int:
    """The bytes a call must move: the words read once, the samples written once."""
    return (4 + 2 * CODES_PER_WORD) * num_words * num_lanes


def bound_ms(num_words: int, num_lanes: int) -> float:
    """The bytes' least time on an H100."""
    return moved_bytes(num_words, num_lanes) / HBM_BYTES_PER_S * 1e3


def probe_words(num_words: int = WORDS, num_lanes: int = LANES, seed: int = SEED) -> np.ndarray:
    """(W, L) uint32 words as the probe draws them (``measure``: (W, tiles / r,
    8 r, 128) from ``default_rng(seed)``, the same numbers in lane order)."""
    return np.random.default_rng(seed).integers(0, 2**32, (num_words, num_lanes), dtype=np.uint32)


def main(iters: int = ITERS) -> list[dict]:
    """Time every form at the probe's size (28,672 lanes x 256 words, seed 0)
    and two_loop and full at 32 and 128 lanes a CTA; check two_loop and
    pipelined against full; print and return one record a timing. Raises
    without a card."""
    dev = require_card()
    words = on_device(probe_words(), dev)
    W, L = words.shape
    full = decode(words, "full")
    for v in SAME_AS_FULL:
        if not torch.equal(decode(words, v), full):
            raise RuntimeError(f"aad_probe_phase_a {v} != full")
    del full
    inputs = copies(ROTATE, words)
    bound = bound_ms(W, L)
    smi = card()
    times = {}
    records = []
    for variant, lanes in [*((v, CTA_LANES) for v in VARIANTS), ("full", 32), ("two_loop", 32),
                           ("full", 128), ("two_loop", 128)]:
        ms = time_ms(lambda x, v=variant, n=lanes: decode(x, v, cta_lanes=n), inputs, iters)
        times[variant, lanes] = ms
        records.append(emit({
            "probe": "phase_a_decode", "variant": variant, "cta_lanes": lanes,
            "chunk_words": chunk_words(lanes) if variant == "two_loop" else None, "lanes": L, "words": W,
            "ms": ms, "samples_per_s": CODES_PER_WORD * W * L / (ms / 1e3), "bound_ms": bound,
            "bound_by": "bytes", "share_of_bound": bound / ms, "vs_full": ms / times["full", lanes],
            "inputs": f"{ROTATE} copies of the words in turn", "card": smi,
        }))
    return records


if __name__ == "__main__":
    main()
