"""Kernel 8: the fused decode in three layouts, R lanes a thread and with a
stage taken out, hand-written for the card.

A port of ``benchmarks/probe_decode_layout.py``: it asks what the output's
layout costs the fused decode, whether R independent chains in one thread
help a latency-bound recurrence, and what share of the step each stage
takes. :func:`decode` runs one instance of ``aad_probe_decode_layout``
(``csrc/decode_layout.cu``) on the card or its plain version,
:func:`decode_reference`, on the CPU: the 4-bit decode of (W, L) 32-bit
code words (code k of a word at bits 4k) from a given state (step index
(L,), history (4, L) newest first, weights (4, L)), written as

* ``natural``: time-major (8W, L), the probe's A;
* ``lane_major``: (L, 8W), staged through shared memory as kernel 1 stages
  its rows, the probe's C (which crashed the TPU's compiler, ``:195-198``);
* ``tile_major``: (ceil(L / 64), 8W, 64), a CTA's 64 lanes the tile, the
  probe's B2; lanes past L are 0;

with ``r`` lanes a thread (the R-interleave, ``:338-345``), and in ``mode``
``full``, ``no_stepsize`` (step size ``1024 + idx``), ``no_delta`` (``idx =
min(4080, idx + mag)``) or ``no_weights`` (no weight update), as the K probes
(``:273-313``); those three are not the decode, by design. Only the probe's
combinations are built (:data:`INSTANCES`).

    python -m aad_tpu_torch.probes.decode_layout    # on the card

Not carried over from the probe script:

* the Mosaic block specs ((w_chunk, 1, 8, 128) blocks, the state in VMEM
  scratch across a (tiles, W / w_chunk) grid): a thread is a lane (or R
  lanes) and walks all its words with the state in registers;
* the u32 output words of packed sample pairs: the kernel writes int16;
* the f32 step-size formula and its correction set: the kernel reads the
  exact int table (``ops/fused_decode.py`` says why);
* B3, the same permutation as one 2-D transpose: on this card the same call
  as B (``natural`` then ``.t().contiguous()``), so it is not timed twice;
* D and E, the XLA permutations of the TPU's u32 wire words
  (``:387-408``): the port reads the wire's bytes as they are (kernel 1);
* ``interpret_mode``: the CPU runs the plain version instead;
* the token carried through a ``fori_loop``, which kept XLA from hoisting
  the launch out of the timed loop: CUDA events around eager launches, over
  input copies rotated past the L2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import FILTER_ORDER, FIXEDPOINT_0_5, FIXEDPOINT_DIGITS, LMSFILTER_SHIFT, STEP_INDEX_MAX
from ..ops import cseman as cs
from ..ops.transitions import index_table, quantized_diff, stepsize_from_index, stepsize_table, update_step_index
from . import (
    BPS, CODES_PER_WORD, CTA_LANES, HBM_BYTES_PER_S, card, check_words, copies, emit, from_tiled, launch, on_device,
    require_card, time_ms, unpack_words,
)

KERNEL = "aad_probe_decode_layout"
LAYOUTS = ("natural", "lane_major", "tile_major")
MODES = ("full", "no_stepsize", "no_delta", "no_weights")
# (layout, r, mode): the three layouts, the R-interleave, the three ablations
INSTANCES = (
    ("natural", 1, "full"), ("lane_major", 1, "full"), ("tile_major", 1, "full"),
    ("natural", 2, "full"), ("natural", 4, "full"), ("natural", 8, "full"),
    ("natural", 1, "no_stepsize"), ("natural", 1, "no_delta"), ("natural", 1, "no_weights"),
)
TILES = 64  # the probe's 64 lane tiles of 1,024: 65,536 lanes
WORDS = 128
SEED = 0
ITERS = 50
ROTATE = 4  # input copies timed in turn: 4 x 36 MB, past the 50 MB L2

# Launch counts, one an instance; the wrapper adds one where it launches, and nowhere else.
launches: dict[str, int] = {f"{KERNEL}[{lay},r{r},{mode}]": 0 for lay, r, mode in INSTANCES}


def instance(layout: str, r: int, mode: str) -> str:
    """The name of an instance, as in :data:`launches`."""
    return f"{KERNEL}[{layout},r{r},{mode}]"


def _check(layout: str, r: int, mode: str) -> None:
    if (layout, r, mode) not in INSTANCES:
        raise ValueError(f"decode_layout: ({layout!r}, {r}, {mode!r}) is not one of {INSTANCES}")


def relayout(natural: torch.Tensor, layout: str, tile: int = CTA_LANES) -> torch.Tensor:
    """(8W, L) time-major samples in ``layout``."""
    if layout == "natural":
        return natural
    if layout == "lane_major":
        return natural.t().contiguous()
    T, L = natural.shape
    tiles = -(-L // tile)
    padded = torch.nn.functional.pad(natural, (0, tiles * tile - L))
    return padded.reshape(T, tiles, tile).permute(1, 0, 2).contiguous()


def _lms_step(qd: torch.Tensor, h: list, w: list, update: bool) -> tuple[torch.Tensor, list, list]:
    """One LMS sample from its qdiff (reference: src/aad_decoder.c:291-315),
    history ``h`` newest first; without ``update`` the weights stay. The
    int32 products and sums wrap as in C (``ops/cseman.py``)."""
    acc = h[0] * w[0] + FIXEDPOINT_0_5
    for k in range(1, FILTER_ORDER):
        acc = acc + h[k] * w[k]
    s = cs.clip16(qd + cs.asr(acc, FIXEDPOINT_DIGITS))
    if update:
        w = [w[k] + cs.asr(qd * h[k] + FIXEDPOINT_0_5, FIXEDPOINT_DIGITS + LMSFILTER_SHIFT) for k in range(FILTER_ORDER)]
    return s, [s, *h[:-1]], w


def decode_reference(words, step_index, history, weight, *, layout="natural", r=1, mode="full") -> torch.Tensor:
    """Plain version of ``aad_probe_decode_layout``, on any device: the
    probe's step (``:273-308``) step by step, vectorised over lanes, then
    :func:`relayout`. ``r`` changes nothing but the kernel's schedule."""
    _check(layout, r, mode)
    check_words(words, "decode_reference")
    codes = unpack_words(words)
    idx = cs.clip(step_index, 0, STEP_INDEX_MAX)
    h, w = list(history.unbind(0)), list(weight.unbind(0))
    out = torch.empty(codes.shape, dtype=torch.int16, device=words.device)
    for t, code in enumerate(codes):
        step = 1024 + idx if mode == "no_stepsize" else stepsize_from_index(idx)
        q = quantized_diff(step, code, BPS)
        idx = torch.clamp(idx + (code & 7), max=STEP_INDEX_MAX) if mode == "no_delta" else update_step_index(idx, code, BPS)
        out[t], h, w = _lms_step(q, h, w, update=mode != "no_weights")
    return relayout(out, layout)


def decode(words, step_index, history, weight, *, layout="natural", r=1, mode="full", device="cuda") -> torch.Tensor:
    """Decode (W, L) 32-bit code words (uint32 or int32) from the state
    ``step_index`` (L,), ``history`` (4, L) newest first and ``weight``
    (4, L), int32, on ``device``; the samples in ``layout``."""
    _check(layout, r, mode)
    words = on_device(words, device)
    step_index, history, weight = (on_device(t, words.device) for t in (step_index, history, weight))
    W, L = check_words(words, "decode")
    for name, t, shape in (("step_index", step_index, (L,)), ("history", history, (4, L)),
                           ("weight", weight, (4, L))):
        if tuple(t.shape) != shape:
            raise ValueError(f"decode_layout: {name} must be {shape}, got {tuple(t.shape)}")
    if words.device.type == "cpu":
        return decode_reference(words, step_index, history, weight, layout=layout, r=r, mode=mode)
    T = CODES_PER_WORD * W
    shape = {"natural": (T, L), "lane_major": (L, T), "tile_major": (-(-L // CTA_LANES), T, CTA_LANES)}[layout]
    out = torch.empty(shape, dtype=torch.int16, device=words.device)
    if out.numel() == 0:
        return out
    launch(KERNEL, words, step_index, history, weight, stepsize_table(words.device),
           index_table(BPS, words.device), out, W, L, LAYOUTS.index(layout), r, MODES.index(mode))
    launches[instance(layout, r, mode)] += 1
    return out


def moved_bytes(num_words: int, num_lanes: int) -> int:
    """The bytes a call must move: the words and the 9 state words of each
    lane read once, the samples written once."""
    return ((4 + 2 * CODES_PER_WORD) * num_words + 4 * 9) * num_lanes


def bound_ms(num_words: int, num_lanes: int) -> float:
    """The bytes' least time on an H100."""
    return moved_bytes(num_words, num_lanes) / HBM_BYTES_PER_S * 1e3


def probe_inputs(tiles: int = TILES, num_words: int = WORDS, seed: int = SEED) -> tuple[np.ndarray, ...]:
    """(words (W, L) uint32, step index (L,), history (4, L), weights (4, L))
    as the probe draws them (``:62-74``: its (W, tiles, 8, 128) words, then
    the state a tile, from ``default_rng(seed)``), in lane order."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (num_words, tiles, 8, 128), dtype=np.uint32)
    ii = rng.integers(0, 4081, (tiles, 1, 8, 128), dtype=np.int32)
    h = rng.integers(-30000, 30000, (tiles, 4, 8, 128), dtype=np.int32)
    wt = rng.integers(-20000, 20000, (tiles, 4, 8, 128), dtype=np.int32)
    return from_tiled(words), from_tiled(ii, 0)[0], from_tiled(h, 0), from_tiled(wt, 0)


def main(iters: int = ITERS) -> list[dict]:
    """Time every instance at the probe's size (65,536 lanes x 128 words,
    seed 0), and B: natural, then ``.t().contiguous()`` to lane-major; check
    the bit-exact instances against each other; print and return one record
    a timing, each ablation with its time saved against full as a share of
    full. Raises without a card."""
    dev = require_card()
    args = [on_device(a, dev) for a in probe_inputs()]
    W, L = args[0].shape
    natural = decode(*args)
    for lay, r, mode in INSTANCES:
        if mode == "full" and (lay, r) != ("natural", 1):
            got = decode(*args, layout=lay, r=r)
            if not torch.equal(got, relayout(natural, lay)):
                raise RuntimeError(f"{instance(lay, r, mode)} != natural, relaid")
    del natural
    inputs = copies(ROTATE, *args)
    bound = bound_ms(W, L)
    smi = card()
    runs = [(instance(*inst), lambda *a, i=inst: decode(*a, layout=i[0], r=i[1], mode=i[2])) for inst in INSTANCES]
    runs.append(("B: natural + .t().contiguous()", lambda *a: decode(*a).t().contiguous()))
    records = []
    full_ms = None
    for name, fn in runs:
        ms = time_ms(fn, inputs, iters)
        full_ms = full_ms or ms  # the first instance is natural, r1, full
        rec = {"probe": "decode_layout", "instance": name, "lanes": L, "words": W, "ms": ms,
               "samples_per_s": CODES_PER_WORD * W * L / (ms / 1e3), "bound_ms": bound, "bound_by": "bytes",
               "share_of_bound": bound / ms, "vs_natural_full": ms / full_ms,
               "inputs": f"{ROTATE} copies of the words and states in turn", "card": smi}
        if name.endswith(("no_stepsize]", "no_delta]", "no_weights]")):
            rec["stage_share_of_step"] = (full_ms - ms) / full_ms
        records.append(emit(rec))
    return records


if __name__ == "__main__":
    main()
