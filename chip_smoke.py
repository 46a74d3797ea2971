#!/usr/bin/env python3
"""Smoke run of aad_tpu_torch's decode and encode paths on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --sharding   # phases 1, 2 and 16 only, for a host with several cards
    python3 chip_smoke.py --probes     # phases 1, 2 and 17 only: the decode probes
    python3 chip_smoke.py --live-encode  # phases 1, 2 and 18 only: a live stereo sender
    python3 chip_smoke.py --bridge-encode  # phases 1, 2 and 19 only: a conference bridge's feeds

Run from the repository root on a machine with a CUDA card (written for an
H100), nvcc and PyTorch. It imports nothing of JAX or ``aad_tpu``. Phases, in
order (after each, the seconds since the start); nothing is caught, so any
failure exits non-zero:

1. device: name, power limit and toolchain;
2. build: the CUDA kernels, from ``aad_tpu_torch/csrc``, and beside them
   the native host engine, from ``aad_tpu_torch/native``, and the decode
   probes' kernels, from ``aad_tpu_torch/probes/csrc`` (timed);
3. probe: the step-size probe kernel reads exactly ``STEPSIZE_TABLE``; and
   the launch floor, a one-element torch op timed by CUDA events over 1,000
   launches, against which phase 6 holds the probe;
4. each decode kernel against its plain torch version, bit for bit: kernel 1
   on block rows, its codes packed in their data regions, at bps 2/3/4 with
   C = 1 and 2, block sizes 256 and 1024 (the 3-bit ones 255, 252, 1023 and
   1020 bytes), small blocks of a few units, a mono data region (18 bytes
   into its block) and rows off a 4-byte boundary, block counts that are not
   multiples of a CTA's; and on (L, T) codes one a byte (the codes-level
   unit), lane counts that are not multiples of the 64-lane CTA, T = 1, T + 4
   odd or not a multiple of 8, T not a multiple of the 64-position row tile;
   step indices 0, 4080 and 4081-4095, weights and histories over all of
   int32 (the sums wrap);
5. the decode main path at full size: the benchmark's 10-minute stereo 4-bit
   stream (58,066 lanes of 988 codes) through ``aad_tpu_torch.decode(...,
   device="cuda")`` (its transfer path: chunks of blocks through pinned
   memory and CUDA streams), counting kernel launches, then its mid/side variant,
   a short mono 3-bit stream with a ragged tail and a lenient decode of a
   truncated stream, each bit-exact against ``device="cpu"``;
6. decode times, with CUDA events after warm-up: each kernel beside its
   bound (and its share of it) and its plain version on the card at the
   main path's shapes, kernel 1's bound from its step loop's instructions
   by pipe (``cuobjdump -sass``), how its CTAs spread over the SMs, the
   device-resident decode and the transfer-inclusive ``decode()``, and the
   resident decode's device time by kernel under ``torch.profiler``, beside
   that of the design that took the codes one a byte, which must show no
   time-major copy of the codes and no operation on a tensor of the codes
   (an unpack);
7. each encode kernel against its plain torch version, bit for bit: bps
   2/3/4, trials 0/1/2, the previous-block warm-up on and off (the serial
   and the paired schedule, its samples staged or not), per-block
   states, a carry in with blocks_before 0 and > 0, ragged valid counts
   below 4, lane counts that are not multiples of 32, forged states whose
   sums wrap, codes one a byte and packed (against ``pack_codes`` of the
   plain version's codes; mono and stereo, 3-bit with a ragged tail, 4,098
   lanes past the staging gate, full 1024-byte blocks), and
   ``aad_encode_pass`` measuring and emitting;
8. the encode main path at full width: the 10-minute stereo 4-bit signal
   (58,066 lanes) through ``aad_tpu_torch.encode(..., device="cuda",
   parallel_blocks=True)`` with trials 2, and with chunks of 4 and a warm
   pass, each against the native host engine (``aad_tpu_torch.native``) at
   full width and the plain version on the CPU over its first 8 blocks
   (whole chunks, which encode independently); a 60-second stream through the sequential, chunked
   ``encode(..., device="cuda")`` (2,904 blocks, 46 chunks, one
   ``aad_encode_pass`` between two), against the one-shot encode and the
   plain encode of an 8-block prefix; the mid/side variant and a mono 3-bit
   stream with a ragged tail, bit-exact against ``device="cpu"``; launch
   counts; and a round trip of the parallel stream through the CUDA
   decoder, its SNR beside the native stream's through the CPU decoder;
9. encode times: each encode kernel and its plain version on the card at
   the main path's shapes, kernel 3 also at the sequential path's (2 lanes
   x 64 blocks a launch, its first 8 blocks held against the plain version
   on the host), kernels 3 (there) and 4 beside a latency bound:
   the loop-carried path of their compiled loop (``cuobjdump -sass``, at
   the per-instruction latencies it prints) times the sample-passes that
   depend on each other; kernel 3 with the previous-block warm-up over
   2 to 58,066 lanes (the lane sweep, each count with the schedule the
   kernel takes); the device-resident and transfer-inclusive parallel
   encode, and the sequential 60-second encode; the device time by kernel
   of the resident parallel and the sequential encode under
   ``torch.profiler``, the parallel one beside that of the design that
   wrote the codes one a byte;
10. the LMS kernel of the two-phase decode engine against its plain torch
   version, bit for bit: bps 2/3/4, qdiffs from ``compute_qdiffs_prefix``
   of random codes (half the lanes at the top step), the shapes of phase 4
   and T = 988, weights and histories over all of int32 (the sums wrap);
   and ``compute_qdiffs_prefix`` against the loop
   ``compute_qdiffs`` on the card;
11. the slice's paths at full width: the benchmark stream and its mid/side
   variant through ``decode(..., device="cuda", engine="pallas")`` against
   the fused engine and the CPU path, with launch counts; block- and
   time-range windows (the last block included) against slices of the full
   decode; ``decode_batch`` of four geometries against per-stream decodes
   under both engines; ``StreamingDecoder`` over the benchmark stream in
   pushes of 1,000,003 bytes; ``StreamingEncoder`` over the 60-second
   signal in uneven chunks against the sequential ``encode()``; and a
   4-bit to 2-bit ``transcode``, cuda against cpu;
12. the slice's times: the LMS kernel beside its bound (and its share of
   it, its step loop counted as kernel 1's), its grid and its plain
   version at 58,066 x 988,
   phase A (``compute_qdiffs_prefix``) and its peak memory, the resident
   two-phase decode beside the fused one (in turns), ``decode_batch`` of
   the pile and the streaming decode and encode in samples/s, and the
   device time by kernel of both resident decodes under ``torch.profiler``,
   with their time-major copies of the codes (the two-phase decode's phase A
   needs one; the fused decode none);
13. ``encode_batch`` at full width: 2,048 stereo 4-bit streams of 1 to 4 s
   cut from the encode signal (4,096 lanes, the chunked carry), 16 of them
   held against their solo ``encode(..., device="cuda")``, with launch
   counts; the pile's chunked launches against their plain versions at its
   shapes: ``aad_encode_pass`` over chunk 0's last block at 4,096 lanes
   (the carry), and ``aad_encode_stream`` on chunk 1 from that carry, its
   first 8 blocks; against ``device="cpu"`` at a few blocks a stream: the 2,048-
   stream pile, 2,049 streams (4,098 lanes, past kernel 3's staging gate),
   mid/side, mono 3-bit and the parallel mode with chunks of 4 and a warm
   pass; the host-clock rate of piles of 1, 32, 512 and 2,048 two-second
   streams beside one stream's sequential ``encode()``, and the device time
   by kernel of the 2,048-stream call under ``torch.profiler``;
14. ``python -m aad_tpu_torch.cli`` in its six modes (``-d`` also under
   ``AAD_TPU_ENGINE=pallas``, ``-e`` and ``-d`` also under
   ``AAD_TPU_ENGINE=native``) as subprocesses on a 10-second stereo WAV,
   against ``encode``/``decode(..., device="cuda")``; ``self_check()`` on
   the card; ``measure_throughput`` of the resident fused decode beside
   phase 6's CUDA-event time of the same call;
15. the transfer paths: ``decode(..., device="cuda")`` of the bench
   stream, its mid/side variant and a lenient cut stream under both engines
   against ``device="cpu"`` and the resident decode, bit for bit; kernels 1
   and 5 at the shape of decode()'s chunk against their plain versions;
   decode()'s chunk sweep; decode() and the parallel and sequential
   encode() against the expressions they replace (the resident paths with
   pageable copies), bit for bit and in turns by the host clock, and under
   ``torch.profiler`` (device time by kernel and copy, the card's idle
   share); every ``engine="native"`` entry point (decode strict and
   lenient, mid/side, mono 3-bit, both encodes, both streaming classes,
   both batches) against the card's output, with the native engine's rates
   on the card's host beside the card's;
16. ``parallel/sharded.py`` on meshes of 4 shards, (2, 2), and 8, (4, 2),
   on one card (and of every card, where there are several): the sharded
   decode of the bench stream's lanes under both engines against the
   unsharded ``ops.decode.decode_blocks`` and the resident ``Decoder``
   decode; the sharded stream encode of phase 13's timed pile (2,048 stereo
   streams of 2 s), with and without its RMSE statistic, against the
   unsharded kernel-3 call on its 4,096 lanes, the statistic against a
   float64 host RMSE and the sharded decode of its codes against the
   unsharded one; the sequence-parallel encode of the 10-minute signal
   (chunks of 1 and no warm pass, chunks of 4 and one) against the
   unsharded ``encode_blocks_parallel`` and, assembled, the bytes of
   ``encode(..., parallel_blocks=True)``; for each, the launches (one a
   non-empty shard), the host syncs inside a call under ``torch.profiler``
   (none allowed) and the time beside the unsharded call's, in turns;
17. the decode probes (``aad_tpu_torch.probes``, kernels 6-8, on no main
   path): each kernel and every built variant against its plain version,
   bit for bit, at the probes' full sizes (the transpose's (512, 64, 8,
   128) int32; phase A's five forms at 28,672 lanes x 256 words; the nine
   layout, R and ablation instances at 65,536 lanes x 128 words; the plain
   versions on the card, timed) and at odd sizes (lanes not a multiple of
   the CTA, words not a multiple of the chunk or the row tile, the
   transpose's 4-byte path); then each module's ``main()``, which prints
   its times beside its bytes bound and the card; each record's bound also
   from its compiled loop by pipe (``cuobjdump -sass`` of the probes'
   library);
18. a live stereo sender: ``StreamingEncoder`` at the benchmark's
   ``aad-b4-s128-ms-stereo`` geometry (2 channels, 4 bits, 128-byte blocks
   of 96 samples, mid/side, 2 trials) fed 20-ms pushes (960 samples a
   channel, 10 blocks), three feeds in turn, each finished after its last
   push, bit for bit against ``device="cpu"``; a 10-block push before the
   wire mode (kernel 3's other mode with the host's framing around it) and
   after (kernel 3's wire mode), bit for bit, with the device operations a
   push, kernels 3 and 4's device time and a push's time by the host's
   clock; then one 10-s feed on the card, its pushes timed by the host's
   clock (median and p95 a push) with the launches of kernels 3 and 4 a
   push;
19. a conference bridge: ``StreamingEncoderBank`` at the benchmark's
   ``aad-b4-s128-mono`` geometry (1 channel, 4 bits, 128-byte blocks of 224
   samples, 2 trials), 1,024 slots of 1-16 s feeds joining over the first
   50 ticks, 320 samples (20 ms at 16 kHz) a tick, each finished and
   restarted at its end: BRIDGE_WIDE_TICKS ticks of every slot, feeds of
   200-32,000 samples (most carried, about a fifth finishing and
   restarting a tick), written into the bank's buffer, and the bridge's first ticks, bit
   for bit against ``device="cpu"``; every feed of the first 60 ticks against a
   ``StreamingEncoder`` a slot on the card; then BRIDGE_TICKS ticks timed
   by the host's clock (median and p95) with the launches of kernels 3 and
   4 a tick, 50 under the profiler (device operations and kernels 3 and
   4's device time a tick), and the same ticks as 1,024
   ``StreamingEncoder`` pushes each.

Before the last line it prints one JSON object with a record per kernel
(its launches on the main path, its time beside its plain version's and
its bound), and the card's name and power limit. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import cProfile
import functools
import importlib.util
import io
import json
import os
import pathlib
import pstats
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SECONDS = 600  # the benchmark stream: 10 minutes of 48 kHz stereo
RATE = 48000
SEED = 0
KERNEL_ITERS = 50
PLAIN_ITERS = 20
DECODE_ITERS = 20
ENCODE_ITERS = 10
SEQ_SECONDS = 60  # the sequential encode's stream: its first minute
PREFIX_BLOCKS = 8
SEQ_CHECK_BLOCKS = 8  # blocks of kernel 3's sequential-shape launch held against the plain version
STREAM_PUSH = 1_000_003  # bytes a StreamingDecoder push
STREAM_CHUNKS = (123_457, 50_000, 991, 200_003)  # samples/ch a StreamingEncoder push, in turn
LIVE_PUSH = 960  # samples/ch a live sender's push: 20 ms at 48 kHz
# samples/ch of the feeds checked against the CPU: ending mid-block (96 samples a block), in an idle push, on a push
LIVE_FEEDS = (2 * LIVE_PUSH + 2 * 96 + 58, LIVE_PUSH + 50, 3 * LIVE_PUSH)
LIVE_SECONDS = 10  # the timed feed
BRIDGE_SLOTS = 1024  # a conference bridge's feeds
BRIDGE_PUSH = 320  # samples a tick: 20 ms at 16 kHz
BRIDGE_TICKS = 500  # the timed ticks: 10 s of a bridge
BRIDGE_WIDE_TICKS = 12  # the full-width ticks held against the CPU
FLOOR_ITERS = 1000  # launches of a one-element op, the launch floor
PILE_STREAMS = 2048  # encode_batch's full-width pile: 4,096 lanes, kernel 3's staging gate
PILE_SECONDS = (1, 4)  # its streams' lengths, drawn from the seed
PILE_CHECKS = 12  # its streams drawn by seed held against their solo encode, beside 4 chosen
PILE_SIZES = (1, 32, 512, 2048)  # streams a timed pile
PILE_TIME_SECONDS = 2  # each timed stream's length
CLI_SECONDS = 10  # the CLI's WAV
TRANSFER_CHUNKS = (512, 1024, 2048, 4096, 8192, 16384, 32768)  # blocks a chunk of decode()'s sweep; 32,768: one pass
TRANSFER_ITERS = 5
NATIVE_PILE = 256  # streams of encode_batch(engine="native") against the card's
ROOT = pathlib.Path(__file__).resolve().parent

# The least time the card could take (H100 SXM, NVIDIA's data sheet and the
# Hopper white paper): HBM at 3.35 TB/s, and instructions on 132 SMs at the
# 1.98 GHz boost clock, each pipe at its own rate.
HBM_BYTES_PER_S = 3.35e12
NUM_SMS = 132
SM_CLOCK_HZ = 1.98e9
# Thread-instructions an SM retires a clock, by pipe: its 4 schedulers issue
# one warp instruction each ("issue": every instruction); the integer ALU
# (adds, logic, shifts, min/max, compares) and the FMA pipe that runs IMAD
# have 16 lanes a scheduler; shared memory serves 32 4-byte words.
PIPE_RATE = {"issue": 128, "alu": 64, "fma": 64, "shared": 32}
INT32_OPS_PER_S = NUM_SMS * PIPE_RATE["alu"] * SM_CLOCK_HZ
# Kernels 1, 3, 4 and 5 are counted from their compiled loop (sass_per_sample,
# sass_loop). The probe is counted from its source, an integer operation
# each for its table read.
PROBE_OPS_PER_SLOT = 5
# The latency bound (chain_cycles) takes these cycles from the issue of an
# instruction to the issue of one that reads its result. They are estimates,
# not measured on the card: 4 for the fixed-latency integer and predicate
# pipes (IMAD included), 23 for a shared-memory load and 33 for a global
# load that hits L1. Every other opcode takes FIXED_LATENCY. The step loop of
# kernel 3 runs about twice the path they give (PERF.md), so the bound they
# make is a floor, not a forecast.
FIXED_LATENCY = 4
LATENCY = {"LDS": 23, "LDG": 33}
# SASS opcodes (before the first '.') that run on the integer ALU. IMAD*
# runs on the FMA pipe, LDS and STS on shared memory. Any other opcode,
# VIADD among them (its pipe is not documented), counts for issue only.
ALU_OPCODES = {"IADD3", "LOP3", "SHF", "LEA", "ISETP", "IMNMX", "VIMNMX", "VIADDMNMX", "SEL", "PRMT",
               "MOV", "IABS", "SGXT", "BMSK", "PLOP3", "FSEL"}
DECODE_SYMBOL = "decode_lanes_kernelILi4ELb1ELi2ELb0E"  # aad_decode_lanes at 4 bits, block rows, L/R: the main path
# kernel 1 on the bench stream's rows with the lane states given (PERF.md kernel table, row 1; H100 80GB HBM3, 700 W)
K1_STATES_GIVEN_MS = 0.2114
LMS_SYMBOL = "lms_lanes_kernel"
SERIAL_SYMBOL = "encode_stream_kernelILi4ELb1ELb0EE"  # aad_encode_stream's serial schedule, 4 bits, packed
# its paired schedule, staged, packed (the sequential shape's); not the wire mode
PAIRED_SYMBOL = "encode_stream_paired_kernelILi4ELb1ELb1ELb0EE"
# Device time a call of the resident fused decode of the bench stream and of
# the resident parallel encode of the 10-minute signal took when kernel 1
# read the codes one a byte, unpacked by torch ops, and kernel 3 wrote them
# so, packed by torch ops (PERF.md section 5: NVIDIA H100 80GB HBM3, 700 W);
# the profiles print theirs beside.
BYTE_CODES_DECODE_MS = 0.7098
BYTE_CODES_PARALLEL_ENCODE_MS = 2.4646
PASS_SYMBOL = "encode_pass_kernelILi4E"
# Lane counts of kernel 3's sweep: the sequential path's 2 (its channels), the
# widest launch that stages its samples (csrc/encode.cu: kStageMaxLanes),
# the chunked parallel mode's 14,518 (chunks of 4), the parallel mode's 58,066.
SWEEP_LANES = (2, 64, 1024, 4096, 14518, 58066)
SASS_INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
SASS_REG = re.compile(r"\b(U?R|U?P)(\d+)(\.64)?\b")


def bound(num_bytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    """(least ms, what bounds it): bytes over HBM rate vs ops over their rate."""
    t_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.cache
def sass_text(lib=None) -> str:
    """``cuobjdump -sass`` of a built library, by default the codec kernels'."""
    from aad_tpu_torch.ops import _build

    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib or _build.build())],
                          capture_output=True, text=True, check=True).stdout


def sass_loop(symbol: str, marker: str, without: tuple[str, ...] = (), lib=None) -> list[tuple[str, str, str]]:
    """The instructions (guard, opcode, operands) of the longest innermost
    loop (a backward branch) that holds an instruction of opcode ``marker``
    and none of the opcodes ``without``, in the kernel whose mangled name
    contains ``symbol`` (in library ``lib``, by default the codec kernels')."""
    funcs = [f for f in sass_text(lib).split("Function : ")[1:] if symbol in f.split("\n", 1)[0]]
    check(len(funcs) == 1, f"{len(funcs)} functions named like {symbol} in the SASS")
    insns = [(int(m[1], 16), (m[2] or "").strip(), m[3], m[4]) for m in SASS_INSN.finditer(funcs[0])]
    loops = [(int(args.split()[-1], 16), addr) for addr, _, op, args in insns
             if op == "BRA" and args.split() and args.split()[-1].startswith("0x") and int(args.split()[-1], 16) <= addr]
    innermost = [(a, b) for a, b in loops if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    bodies = [[(g, op, args) for addr, g, op, args in insns if a <= addr <= b] for a, b in innermost]
    opcodes = [{op.split(".")[0] for _, op, _ in body} for body in bodies]
    return max((body for body, ops in zip(bodies, opcodes) if marker in ops and not ops & set(without)), key=len)


def sample_loads(loop: list[tuple[str, str, str]]) -> int:
    """The samples one pass of an encode kernel's step loop steps over: its
    2-byte loads, from device memory or from a staged tile."""
    return sum(op.split(".")[0] in ("LDG", "LDS") and (".U16" in op or ".S16" in op) for _, op, _ in loop)


def pipe_counts(ops: list[str], samples: int) -> dict:
    """Instructions a sample by pipe (the keys of ``PIPE_RATE``), with
    ``insns`` and ``samples`` of one pass of the loop."""
    count = {
        "issue": len(ops),
        "alu": sum(op.split(".")[0] in ALU_OPCODES for op in ops),
        "fma": sum(op.startswith("IMAD") for op in ops),
        "shared": sum(op.split(".")[0] in ("LDS", "STS") for op in ops),
    }
    return {**{p: n / samples for p, n in count.items()}, "insns": len(ops), "samples": samples}


def sass_per_sample(symbol: str) -> dict:
    """Instructions a sample of a staged-row kernel's step loop, by pipe.

    The step loop is the longest innermost loop that stores to shared
    memory (the table copies are the others): each of its STS is one pair
    of samples into the staged output tile (``codec.cuh::run_rows``).
    """
    ops = [op for _, op, _ in sass_loop(symbol, "STS")]
    return pipe_counts(ops, 2 * sum(op.split(".")[0] == "STS" for op in ops))


def chain_cycles(body: list[tuple[str, str, str]], iters: int = 32) -> float:
    """Cycles a pass of a loop takes when only its dependences through
    registers and predicates hold it back (issue unlimited), each
    instruction taking its ``LATENCY``: how far the latest result moves
    each time the body runs, over the second half of ``iters`` runs."""
    ready: dict[str, float] = {}
    latest = []

    def regs(text, wide=False):
        out = []
        for kind, num, pair in SASS_REG.findall(text):
            out.append(f"{kind}{num}")
            if kind.endswith("R") and (pair or wide):
                out.append(f"{kind}{int(num) + 1}")
        return out

    for _ in range(iters):
        for guard, op, args in body:
            base = op.split(".")[0]
            if base in ("BRA", "NOP", "BSSY", "BSYNC", "WARPSYNC"):
                continue
            operands = [o.strip() for o in args.split(",")]
            dests = []
            if not (base.startswith("ST") or base in ("RED", "ATOM")) and operands[0]:
                dests = regs(operands[0], wide=".64" in op or ".WIDE" in op)
                if len(operands) > 1 and re.fullmatch(r"!?U?P[0-6T]", operands[1]):
                    dests += regs(operands[1])  # a predicate or carry out
                    operands = operands[1:]
                operands = operands[1:]
            start = max((ready.get(r, 0.0) for r in regs(",".join([*operands, guard]))), default=0.0)
            for r in dests:
                ready[r] = start + LATENCY.get(base, FIXED_LATENCY)
        latest.append(max(ready.values(), default=0.0))
    half = iters // 2
    return (latest[-1] - latest[half - 1]) / (iters - half)


def latency_line(body: list[tuple[str, str, str]], samples: int) -> tuple[float, str]:
    """(cycles a sample on the loop-carried chain, a line that says how)."""
    cycles = chain_cycles(body) / samples
    assumed = ", ".join(f"{k} {v}" for k, v in LATENCY.items())
    return cycles, (f"loop of {len(body)} instructions for {samples} samples: {cycles:.2f} cycles a sample on its "
                    f"loop-carried chain, taking {assumed} and every other opcode {FIXED_LATENCY} cycles")


def loop_bound(num_bytes: float, samples: int, per_sample: dict) -> tuple[tuple[float, str], str]:
    """``bound`` for a kernel counted by ``sass_per_sample``: its operations
    are the busiest pipe's, at that pipe's rate. Returns (bound, the pipe)."""
    pipe = max(PIPE_RATE, key=lambda p: per_sample[p] / PIPE_RATE[p])
    return bound(num_bytes, samples * per_sample[pipe], NUM_SMS * PIPE_RATE[pipe] * SM_CLOCK_HZ), pipe


def sass_line(per_sample: dict, pipe: str) -> str:
    return (f"step loop of {per_sample['insns']} instructions for {per_sample['samples']} samples: "
            + ", ".join(f"{p} {per_sample[p]:.3f}" for p in PIPE_RATE)
            + f" a sample; the busiest pipe against its rate: {pipe}")


T_START = time.perf_counter()


def stamp(phase: str) -> None:
    """The seconds since the script started, at the end of a phase."""
    print(f"[phase] {phase} done at {time.perf_counter() - T_START:.1f} s")


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_stream(num_samples, nch=2, bps=4, ms=False, seed=SEED, max_block_size=1024):
    """A valid .aad stream with random codes and states, as bench.py builds its
    stream (bench.py::build_synthetic_stream: same draws from the same seed),
    built with the port's own framing. Returns (bytes, header)."""
    import aad_tpu_torch as at
    from aad_tpu_torch.format.framing import BlockStates, assemble_stream, build_block_headers
    from aad_tpu_torch.format.geometry import num_blocks_for

    geo = at.compute_block_geometry(max_block_size, nch, bps)
    header = at.HeaderInfo(
        num_channels=nch, num_samples=num_samples, sampling_rate=RATE,
        bits_per_sample=bps, block_size=geo.block_size,
        num_samples_per_block=geo.num_samples_per_block, ch_process_method=int(ms),
    )
    nblocks = num_blocks_for(num_samples, geo.num_samples_per_block)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**bps, (nblocks, nch, geo.codes_per_block), dtype=np.uint8)
    states = BlockStates.from_numpy((
        rng.integers(0, 4081, (nblocks, nch)),
        rng.integers(-20000, 20000, (nblocks, nch, 4)),
        rng.integers(-32768, 32768, (nblocks, nch, 4)),
    ))
    shifts = np.zeros((nblocks, nch), dtype=np.int32)
    payload = assemble_stream(build_block_headers(states, shifts, geo), codes, geo, num_samples)
    return at.encode_header(header) + payload.numpy().tobytes(), header


def profile(label, fn, iters, time_major=None, host_rows=0, codes=()):
    """Print the device time by kernel of ``fn`` under torch.profiler, per
    call, beside its CUDA-event time without the profiler; with
    ``host_rows``, also that many host operations by their own host time.

    With ``time_major=(T, L)`` it also counts, per call, the copies that
    make a (T, ...) tensor of T * L elements: the time-major relayout of the
    codes that phase A takes. With ``codes``, sizes in elements, it counts
    the operations that take a tensor of one of them: a tensor of the codes
    one a byte (L * T) or of the data regions (B * data_bytes), which only
    an unpack or a pack of the codes makes. Returns {"device_ms": the device
    time a call, "copies": the first count, "code_ops": the second}, each
    count None where it was not asked for.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    window_ms = cuda_ms(fn, iters, warmup=1)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=time_major is not None or bool(codes)) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3 / iters, e.count / iters, e.key)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    print(f"[profile] {label}: {window_ms:.4f} ms a call by CUDA events without the profiler; "
          f"{busy:.4f} ms a call of device time under it, {len(rows)} kernels")
    for ms, count, name in rows[:10]:
        print(f"[profile]   {ms:.4f} ms x{count:g} {name[:100]}")
    host = sorted(
        ((e.self_cpu_time_total / 1e3 / iters, e.count / iters, e.key)
         for e in prof.key_averages() if e.device_type == DeviceType.CPU),
        reverse=True,
    )
    if host_rows:
        print(f"[profile]   host: {sum(r[0] for r in host):.4f} ms a call of host time in operations under it")
    for ms, count, name in host[:host_rows]:
        print(f"[profile]   host {ms:.4f} ms x{count:g} {name[:100]}")
    out = {"device_ms": busy, "copies": None, "code_ops": None}
    by_shape = prof.key_averages(group_by_input_shape=True) if time_major is not None or codes else []
    if time_major is not None:
        T, L = time_major
        out["copies"] = sum(
            e.count for e in by_shape
            if e.device_type == DeviceType.CPU and e.key in ("aten::clone", "aten::contiguous")
            and any(len(s) > 1 and s[0] == T and int(np.prod(s)) == T * L for s in e.input_shapes)
        ) / iters
        print(f"[profile]   time-major copies of the {T} x {L} codes: {out['copies']:g} a call")
    if codes:
        ops = [e for e in by_shape if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
               and any(s and int(np.prod(s)) in codes for s in e.input_shapes)]
        out["code_ops"] = sum(e.count for e in ops) / iters
        names = sorted({e.key for e in ops})
        print(f"[profile]   operations on a tensor of the codes ({' or '.join(map(str, codes))} elements): "
              f"{out['code_ops']:g} a call{' (' + ', '.join(names) + ')' if names else ''}")
    return out


def grid_line(symbol: str, L: int, cuda) -> str:
    """How a staged-row kernel spreads L lanes over the SMs. The CTAs an SM
    holds at once follow from the kernel's registers and shared memory, as
    ``-Xptxas -v`` logs them at the build, under Hopper's limits: 65,536
    registers an SM, allocated 256 a warp at a time; 228 KiB of shared
    memory under the largest carveout, which the kernels ask for, 1 KiB of
    it kept for each CTA; 32 CTAs and 64 warps."""
    import torch
    from aad_tpu_torch.ops import _build

    per_cta = int(re.search(r"kLanesPerBlock = (\d+)", (_build.CSRC / "codec.cuh").read_text())[1])
    log = (_build.build().parent / "build.log").read_text()
    used = re.search(r"Compiling entry function '[^']*" + re.escape(symbol)
                     + r"[^']*'.*?Used (\d+) registers[^\n]*?(\d+) bytes smem", log, re.S)
    regs, smem = int(used[1]), int(used[2])
    warps = per_cta // 32
    per_sm = min(65536 // (-(-regs * 32 // 256) * 256 * warps), 228 * 1024 // (smem + 1024), 32, 64 // warps)
    ctas = -(-L // per_cta)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    check(per_sm * sms >= ctas, f"{ctas} CTAs do not all fit at once ({per_sm} a SM on {sms} SMs)")
    return (f"{L} lanes in {ctas} CTAs of {per_cta}; {regs} registers and {smem} bytes of shared memory "
            f"a CTA, so up to {per_sm} resident a SM on {sms} SMs, all at once: the busiest SM holds "
            f"{-(-ctas // sms)} CTAs against a mean of {ctas / sms:.2f}")


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# Shapes around the staging of kernels 1 and 5 (64-lane CTAs, 64-position
# row tiles, csrc/codec.cuh): (blocks, channels, codes). T + 4 odd and not a
# multiple of 8, T not a multiple of 64, T = 1, lane counts that are not
# multiples of 64.
EDGE_SHAPES = ((1, 1, 1), (33, 2, 1), (70, 1, 21), (65, 2, 61), (129, 1, 124), (31, 2, 125), (64, 1, 128))
# Kernel 1 on block rows: (max block size, or 0 for a block of 3 units;
# blocks, not a multiple of a CTA's 64 / C; bytes the rows start past a
# 4-byte boundary).
ROW_CASES = ((1024, 1025, 0), (256, 333, 2), (0, 70, 1), (1024, 67, 3))


def int32_wide(rng, L) -> np.ndarray:
    """(L, 4) int32: half the rows over all of int32 (the sums wrap at once),
    half as the benchmark draws histories."""
    a = rng.integers(-(2**31), 2**31 - 1, (L, 4), endpoint=True).astype(np.int32)
    a[::2] = rng.integers(-32768, 32768, a[::2].shape)
    return a


def lane_inputs(rng, L, T, bps):
    """(L, T) codes one a byte and lane states for aad_decode_lanes."""
    import torch

    codes = rng.integers(0, 2**bps, (L, T), dtype=np.uint8)
    si = rng.integers(0, 4096, (L,)).astype(np.int32)
    si[: min(17, L)] = [0, 4080, *range(4081, 4096)][: min(17, L)]  # wire values, before the parse clamp
    hist = int32_wide(rng, L)
    wt = int32_wide(rng, L)
    wt[1::4] = rng.integers(-20000, 20000, wt[1::4].shape)  # as the benchmark draws them
    return [torch.from_numpy(a) for a in (codes, si, hist, wt)]


def loud_int16(rng, shape) -> np.ndarray:
    """int16 samples at full scale, half of them at the rails: the step size
    climbs to the table's top, where the squared errors wrap negative."""
    x = rng.integers(-32768, 32768, shape)
    return np.where(rng.random(shape) < 0.5, rng.choice([-32768, 32767], shape), x).astype(np.int16)


def forged_state(rng, L):
    """A carry only a forger writes: weights over all of int32 (the 4-tap
    sum wraps) and step indices outside [0, 4080]."""
    from aad_tpu_torch.ops.transitions import CodecState

    return CodecState.from_numpy((
        rng.integers(-32768, 32768, (L, 4)),
        rng.integers(-(2**31), 2**31 - 1, (L, 4), endpoint=True),
        rng.choice([0, 4080, 4095, 5000, -7, 1000, 2000], L),
    ))


def max_err(got, want) -> int:
    """Largest |got - want| over the leaves of two trees of integer tensors."""
    import torch

    if isinstance(want, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    diff = got.cpu().to(torch.int64) - want.cpu().to(torch.int64)
    return int(diff.abs().max()) if diff.numel() else 0


def bench_pcm(num_samples, nch=2, seed=SEED) -> np.ndarray:
    """The encode signal: bench.py's tone (9000 sin(t / 17), bench.py:404)
    plus Gaussian noise of sd 1000 drawn from ``seed``, as int16."""
    rng = np.random.default_rng(seed)
    tone = 9000 * np.sin(np.arange(num_samples) / 17.0)
    return np.clip(tone + rng.normal(0, 1000, (nch, num_samples)), -32768, 32767).astype(np.int16)


def snr_db(pcm, decoded) -> float:
    ref = pcm.astype(np.float64)
    return float(10 * np.log10((ref**2).sum() / ((decoded - ref) ** 2).sum()))


def encode_kernel_checks(cuda) -> tuple[int, int]:
    """Phase 7: both encode kernels against their plain versions, bit for bit."""
    import torch
    from aad_tpu_torch.ops import encode_pass as ep, fused_encode as fe

    rng = np.random.default_rng(SEED + 2)
    stream_err = 0
    cases = [(bps, trials, warm, 3, 1061, 36)
             for bps in (2, 3, 4) for trials in (0, 1, 2) for warm in (True, False)]
    # the full 1024-byte geometries: stereo 4-bit, mono 3-bit (2684 samples a
    # block); and a launch too wide to stage its samples
    cases += [(4, 2, True, 2, 67, 992), (3, 2, False, 2, 33, 2684), (4, 1, True, 2, 4101, 36)]
    for i, (bps, trials, warm, B, L, nspb) in enumerate(cases):
        x = torch.from_numpy(loud_int16(rng, (B, L, nspb)))
        valid = rng.integers(0, nspb + 1, (B, L)).astype(np.int32)
        valid[:, :5] = [0, 1, 3, 4, nspb]
        valid = torch.from_numpy(valid)
        carry = None if i % 4 == 0 else (forged_state(rng, L), torch.from_numpy(loud_int16(rng, (L, nspb))))
        emit = i % 2 == 1
        kw = dict(carry=carry, blocks_before=i % 3, warm_on_prev=warm, emit_block_states=emit)
        want = fe.encode_stream_reference(x, valid, bps, trials, **kw)
        if carry is not None:
            kw["carry"] = (carry[0].to(cuda), carry[1].to(cuda))
        got = fe.encode_stream(x.to(cuda), valid.to(cuda), bps, trials, **kw)
        torch.cuda.synchronize()
        tail = (tuple(got[2]), tuple(want[2])) if emit else (tuple(got[2][0]), tuple(want[2][0]))
        err = max(max_err(tuple(got[0]), tuple(want[0])), max_err(got[1], want[1]), max_err(*tail))
        what = (f"bps={bps} trials={trials} warm_on_prev={warm} blocks={B} lanes={L} nspb={nspb} "
                f"carry={'forged' if carry else 'none'} blocks_before={i % 3} emit_state={emit}")
        check(err == 0, f"aad_encode_stream != plain at {what}: max |err| {err}")
        stream_err = max(stream_err, err)
        print(f"[kernel-vs-plain] aad_encode_stream {what}: bit-exact")

    # packed: each block's data region against pack_codes of the plain
    # version's codes; (trials, warm-up, lanes, max block size, blocks): the
    # serial schedule (trials 0; no warm-up), the paired one staged and, at
    # 4,098 lanes, not; full 1024-byte blocks only where a main path runs
    # them (the plain version takes seconds a block): the sequential path's
    # 2 lanes, stereo 4-bit, and the mono 2-bit cell's 256 lanes, staged at
    # 2 lanes a CTA
    import aad_tpu_torch as at

    packed = [(0, True, 531, 64, 3), (2, False, 531, 96, 3), (1, True, 333, 64, 3), (2, True, 333, 96, 3),
              (2, True, 4098, 64, 2), (2, True, 2, 1024, 1), (2, True, 256, 1024, 2)]
    for bps in (2, 3, 4):
        for C in (1, 2):
            for j, (trials, warm, lanes, block, B) in enumerate(packed):
                if block == 1024 and (bps, C, lanes) not in ((4, 2, 2), (2, 1, 256)):
                    continue
                rows = lanes // C
                geo = at.compute_block_geometry(block, C, bps)
                nspb = geo.num_samples_per_block
                x = torch.from_numpy(loud_int16(rng, (B, rows, C, nspb)))
                valid = rng.integers(0, nspb + 1, (B, rows, C)).astype(np.int32)
                valid[:, :5] = np.array([0, 1, 3, 4, nspb])[: min(rows, 5), None]  # ragged: whole rows alike
                valid = torch.from_numpy(valid)
                st = forged_state(rng, rows * C)
                carry = (st.map(lambda a: a.reshape(rows, C, *a.shape[1:])),
                         torch.from_numpy(loud_int16(rng, (rows, C, nspb))))
                kw = dict(carry=carry, blocks_before=j % 3, warm_on_prev=warm, need_carry=False, pack=geo)
                want = fe.encode_stream_reference(x, valid, bps, trials, **kw)
                kw["carry"] = (carry[0].to(cuda), carry[1].to(cuda))
                got = fe.encode_stream(x.to(cuda), valid.to(cuda), bps, trials, **kw)
                torch.cuda.synchronize()
                check(got[1].shape == (B, rows, geo.data_bytes), f"packed codes {tuple(got[1].shape)}")
                err = max(max_err(tuple(got[0]), tuple(want[0])), max_err(got[1], want[1]))
                what = (f"packed, bps={bps} C={C} trials={trials} warm_on_prev={warm} blocks={B} lanes={rows * C} "
                        f"nspb={nspb} ({geo.data_bytes}-byte data regions) carry=forged blocks_before={j % 3}")
                check(err == 0, f"aad_encode_stream != plain at {what}: max |err| {err}")
                stream_err = max(stream_err, err)
                print(f"[kernel-vs-plain] aad_encode_stream {what}: == pack_codes of the plain codes, bit-exact")

    pass_err = 0
    T, L = 988, 1061
    for bps in (2, 3, 4):
        for emit in (False, True):
            samples = torch.from_numpy(loud_int16(rng, (T, L)))
            state = forged_state(rng, L)
            state.step_index[: L // 2] = 4080  # the top step: squares wrap at once
            valid = torch.from_numpy(rng.integers(-2, T + 9, L).astype(np.int32))
            want = ep.encode_pass_reference(samples, state, valid, bps, emit)
            got = ep.encode_pass(samples.to(cuda), state.to(cuda), valid.to(cuda), bps, emit)
            torch.cuda.synchronize()
            check((got[1] is None) != emit, "aad_encode_pass codes out")
            err = max(max_err(tuple(got[0]), tuple(want[0])), max_err(got[2], want[2]),
                      max_err(got[1], want[1]) if emit else 0)
            kind = "emit" if emit else "measure"
            check(err == 0, f"aad_encode_pass != plain at bps={bps} {kind}: max |err| {err}")
            pass_err = max(pass_err, err)
            print(f"[kernel-vs-plain] aad_encode_pass bps={bps} {kind} lanes={L} codes={T}, valid -2..{T + 8}: "
                  f"bit-exact ({int((want[2] < 0).sum())} lanes with a negative wrapped sum)")
    return stream_err, pass_err


@contextlib.contextmanager
def one_launch():
    """The sequential encode in one launch of kernel 3 at any length: the
    block count from which it runs in chunks set out of reach."""
    import aad_tpu_torch.codec.encoder as enc_mod

    was = enc_mod._OVERLAP_MIN_BLOCKS
    enc_mod._OVERLAP_MIN_BLOCKS = 1 << 62
    try:
        yield
    finally:
        enc_mod._OVERLAP_MIN_BLOCKS = was


def encode_main_path(cuda) -> dict:
    """Phase 8: the encode main path at full width, CUDA against CPU."""
    import torch
    import aad_tpu_torch as at
    import aad_tpu_torch.codec.encoder as enc_mod
    from aad_tpu_torch.ops import encode_pass as ep, fused_encode as fe

    def reset():
        fe.reset_launches()
        ep.reset_launches()

    def counts():
        return {**fe.launches, **ep.launches}

    cfg = at.EncodeConfig(2, RATE, 4, 1024, 0, 2)
    geo = cfg.geometry()
    nspb = geo.num_samples_per_block
    n = RATE * SECONDS
    nblocks = -(-n // nspb)
    pcm = bench_pcm(n)

    # (a) block-parallel, the whole 10-minute stream, against the native
    # engine (an independent implementation, held against the plain version
    # and aad_tpu's native engine on the CPU by the tests) at full width, and
    # against the plain version on the CPU over a prefix of whole chunks
    # (parallel chunks are independent, so a prefix is exact)
    head = at.FILE_HEADER_SIZE
    prefix = np.ascontiguousarray(pcm[:, : PREFIX_BLOCKS * nspb])
    reset()
    t0 = time.perf_counter()
    par = at.encode(pcm, cfg, device="cuda", parallel_blocks=True)
    par_s = time.perf_counter() - t0
    par_launches = counts()
    check(par_launches[fe.STREAM_KERNEL] == 1, f"parallel encode launches {par_launches}")
    t0 = time.perf_counter()
    ref = at.native.encode_parallel(pcm, cfg, 1, 0)
    native_s = time.perf_counter() - t0
    check(par == ref, "parallel encode: cuda != native")
    cpu_prefix = at.encode(prefix, cfg, device="cpu", parallel_blocks=True)
    check(par[head : head + PREFIX_BLOCKS * geo.block_size] == cpu_prefix[head:], "parallel prefix: cuda != cpu")
    print(f"[encode-main] parallel stereo 4-bit trials 2, {n} samples/ch, {nblocks} blocks, "
          f"{2 * nblocks} lanes: cuda == native engine, bit-exact ({len(par)} bytes); its first {PREFIX_BLOCKS} "
          f"blocks == cpu; launches {par_launches}; first call {par_s:.3f} s, native {native_s:.3f} s")
    kw = dict(parallel_blocks=True, parallel_chunk_blocks=4, parallel_warm_passes=1)
    reset()
    got = at.encode(pcm, cfg, device="cuda", **kw)
    warm_launches = counts()
    check(warm_launches[fe.STREAM_KERNEL] == 2, f"chunked parallel launches {warm_launches}")
    check(got == at.native.encode_parallel(pcm, cfg, 4, 1), "parallel c=4 k=1: cuda != native")
    check(got[head : head + PREFIX_BLOCKS * geo.block_size] == at.encode(prefix, cfg, device="cpu", **kw)[head:],
          "parallel c=4 k=1 prefix: cuda != cpu")
    print(f"[encode-main] parallel, chunks of 4 and 1 warm pass: cuda == native engine, bit-exact; its first "
          f"{PREFIX_BLOCKS} blocks == cpu; launches {warm_launches}")

    # (b) sequential, chunked with the carry: the first minute
    ns = RATE * SEQ_SECONDS
    seq_pcm = np.ascontiguousarray(pcm[:, :ns])
    seq_blocks = -(-ns // nspb)
    chunks = -(-seq_blocks // enc_mod._OVERLAP_CHUNK_BLOCKS)
    reset()
    t0 = time.perf_counter()
    seq = at.encode(seq_pcm, cfg, device="cuda")
    seq_s = time.perf_counter() - t0
    seq_launches = counts()
    check(seq_launches == {fe.STREAM_KERNEL: chunks, ep.PASS_KERNEL: chunks - 1},
          f"sequential launches {seq_launches}, want {chunks} and {chunks - 1}")
    with one_launch():
        one = at.Encoder.from_config(cfg, device="cuda").encode_payload_ondevice(torch.from_numpy(seq_pcm).to(cuda))
    check(one.cpu().numpy().tobytes() == seq[at.FILE_HEADER_SIZE:], "chunked sequential != one-shot")
    seq_prefix = at.encode(seq_pcm[:, : PREFIX_BLOCKS * nspb], cfg, device="cpu")
    check(seq_prefix[head:] == seq[head : head + PREFIX_BLOCKS * geo.block_size], "sequential prefix != plain")
    print(f"[encode-main] sequential stereo 4-bit trials 2, {ns} samples/ch, {seq_blocks} blocks in {chunks} "
          f"chunks: chunked == one-shot on the card; first {PREFIX_BLOCKS} blocks == plain encode of the "
          f"prefix (cpu); launches {seq_launches}; first call {seq_s:.3f} s")

    # (c) mid/side, and mono 3-bit with a last block of 2 samples
    ms_cfg = at.EncodeConfig(2, RATE, 4, 1024, 1, 2)
    ms_pcm = np.ascontiguousarray(pcm[:, : 6 * nspb - 301])
    check(at.encode(ms_pcm, ms_cfg, device="cuda") == at.encode(ms_pcm, ms_cfg, device="cpu"), "mid/side: cuda != cpu")
    print(f"[encode-main] mid/side sequential, {ms_pcm.shape[1]} samples/ch, ragged: cuda == cpu, bit-exact")
    mono_cfg = at.EncodeConfig(1, RATE, 3, 1024, 0, 1)
    mono = bench_pcm(2 * mono_cfg.geometry().num_samples_per_block + 2, nch=1, seed=SEED + 1)
    check(at.encode(mono, mono_cfg, device="cuda") == at.encode(mono, mono_cfg, device="cpu"), "mono 3-bit: cuda != cpu")
    print(f"[encode-main] mono 3-bit trials 1, {mono.shape[1]} samples, last block 2 samples: cuda == cpu, bit-exact")

    # (d) round trip of the parallel stream through the decoder
    _, dec_cuda = at.decode(par, device="cuda")
    _, dec_cpu = at.decode(ref, device="cpu")  # ref: the native engine's bytes
    snr_cuda, snr_cpu = snr_db(pcm, dec_cuda), snr_db(pcm, dec_cpu)
    check(np.array_equal(dec_cuda, dec_cpu) and snr_cuda == snr_cpu, "round trip: cuda != cpu")
    print(f"[encode-main] round trip of the parallel stream: SNR {snr_cuda:.4f} dB (cuda encode, cuda decode), "
          f"{snr_cpu:.4f} dB (native encode, cpu decode)")
    return dict(cfg=cfg, pcm=pcm, seq_pcm=seq_pcm, seq=seq, par=par, par_launches=par_launches,
                seq_launches=seq_launches)


def encode_times(cuda, card, main, stream_err, pass_err) -> list[dict]:
    """Phase 9: encode times at the main path's shapes; the encode kernels' records."""
    import torch
    import aad_tpu_torch as at
    from aad_tpu_torch.codec.encoder import _OVERLAP_CHUNK_BLOCKS, _pad_to_blocks
    from aad_tpu_torch.ops import encode_pass as ep, fused_encode as fe
    from aad_tpu_torch.ops.transitions import CodecState

    cfg, pcm, seq_pcm = main["cfg"], main["pcm"], main["seq_pcm"]
    geo = cfg.geometry()
    nspb, bps, trials = geo.num_samples_per_block, cfg.bits_per_sample, cfg.num_encode_trials
    T = nspb - 4
    n = pcm.shape[1]
    pcm_t = torch.from_numpy(pcm).to(cuda)

    # aad_encode_stream as the parallel main path launches it: one block per
    # lane, lanes = blocks x channels, trials 2, no previous-block warm-up
    blocks, valid = _pad_to_blocks(pcm_t, geo, 0, -(-n // nspb))
    lanes = blocks[None]  # (1, B, C, nspb): every block a lane of its row, its codes packed
    B = blocks.shape[0]
    L = B * geo.num_channels
    lane_valid = valid[:, None].expand(-1, geo.num_channels).reshape(1, L).contiguous()
    samples = lanes.reshape(1, L, nspb).transpose(1, 2).contiguous()
    args = (samples, lane_valid, CodecState.zeros((L,), cuda), None, bps, trials)
    codes, headers, _ = fe.encode_stream_tm(*args, warm_on_prev=False, pack=geo)
    plain_args = (lanes, lane_valid.reshape(1, B, geo.num_channels), bps, trials)
    want_h, want_c, _ = fe.encode_stream_reference(*plain_args, warm_on_prev=False, need_carry=False, pack=geo)
    full_err = max(max_err(codes, want_c), max_err(headers[0, 8], want_h.step_index.reshape(-1)),
                   max_err(headers[0, 9], want_h.shift.reshape(-1)),
                   max_err(headers[0, 4:8].t(), want_h.weight.reshape(L, 4)),
                   max_err(headers[0, 0:4].t(), want_h.history.reshape(L, 4)))
    check(full_err == 0, f"aad_encode_stream != plain on the card at the main-path shape: {full_err}")
    del codes, headers, want_h, want_c
    stream_ms = cuda_ms(lambda: fe.encode_stream_tm(*args, warm_on_prev=False, pack=geo), ENCODE_ITERS)
    stream_plain_ms = cuda_ms(
        lambda: fe.encode_stream_reference(*plain_args, warm_on_prev=False, need_carry=False, pack=geo),
        1, warmup=0,
    )
    n_live = torch.clamp(lane_valid - 4, 0, T)
    steps = int((trials * n_live * (lane_valid >= 4)).sum()) + L * T  # measures (data-dependent) + emit
    # each sample-pass at the serial schedule's measure loop, by pipe
    serial_loop = sass_loop(SERIAL_SYMBOL, "LDG", without=("STG", "STS"))  # the measure, not the staged emit
    serial_sass = pipe_counts([op for _, op, _ in serial_loop], sample_loads(serial_loop))
    # the bytes: samples, valid counts and states in, packed data regions and header fields out
    stream_bound, stream_pipe = loop_bound(L * nspb * 2 + L * 4 + L * 36 + B * geo.data_bytes + L * 40, steps,
                                           serial_sass)

    # aad_encode_pass as the sequential path launches it: the carry pass over
    # one chunk's last block, 2 lanes (the channels), every slot live
    s0 = (seq_pcm.shape[1] // nspb - 1) * nspb
    block = torch.from_numpy(seq_pcm[:, s0 : s0 + nspb]).to(cuda)
    pass_samples = block[:, 4:].t().contiguous()
    pass_state = CodecState.zeros((2,), cuda)._replace(history=block[:, :4].flip(-1).to(torch.int32).contiguous())
    full = torch.full((2,), nspb, dtype=torch.int32, device=cuda)
    pass_args = (pass_samples, pass_state, full, bps)
    check(max_err(tuple(ep.encode_pass(*pass_args)[0]), tuple(ep.encode_pass_reference(*pass_args)[0])) == 0,
          "aad_encode_pass != plain at the main-path shape")
    pass_ms = cuda_ms(lambda: ep.encode_pass(*pass_args), KERNEL_ITERS)
    pass_plain_ms = cuda_ms(lambda: ep.encode_pass_reference(*pass_args), 3, warmup=1)
    # its loop as the measure runs it: issue by pipe, and the loop-carried chain
    pass_loop = sass_loop(PASS_SYMBOL, "LDG", without=("STG",))
    loop_samples = sample_loads(pass_loop)
    pass_sass = pipe_counts([op for _, op, _ in pass_loop], loop_samples)
    pass_bound, pass_pipe = loop_bound(T * 2 * 2 + 2 * (36 + 4) + 2 * (36 + 8), 2 * T, pass_sass)
    pass_cycles, pass_chain = latency_line(pass_loop, loop_samples)
    pass_latency_ms = T * pass_cycles / SM_CLOCK_HZ * 1e3

    # aad_encode_stream as the sequential path launches it: one chunk of
    # _OVERLAP_CHUNK_BLOCKS blocks x 2 lanes (the channels), the trial
    # search warming up on each previous block, every slot live
    cb = _OVERLAP_CHUNK_BLOCKS
    seq_t = torch.from_numpy(seq_pcm).to(cuda)
    chunk, chunk_valid = _pad_to_blocks(seq_t, geo, cb, cb)  # the second chunk: blocks cb .. 2 cb - 1
    seq_args = (chunk.transpose(1, 2).contiguous(), chunk_valid[:, None].expand(-1, 2).contiguous(),
                CodecState.zeros((2,), cuda), _pad_to_blocks(seq_t, geo, cb - 1, 1)[0][0].t().contiguous(),
                bps, trials)
    seq_kw = dict(warm_on_prev=True, blocks_before=cb, pack=geo)
    seq_stream_ms = cuda_ms(lambda: fe.encode_stream_tm(*seq_args, **seq_kw), 3, warmup=1)
    # the timed launch's first SEQ_CHECK_BLOCKS blocks against the plain
    # version (on the host: it takes seconds a block) on the same carry
    got_c, got_h, _ = fe.encode_stream_tm(*seq_args, **seq_kw)
    k = SEQ_CHECK_BLOCKS
    want_h, want_c, _ = fe.encode_stream_reference(
        chunk[:k].cpu(), chunk_valid[:k].cpu(), bps, trials, carry=(CodecState.zeros((2,), "cpu"), seq_args[3].t().cpu()),
        blocks_before=cb, need_carry=False, pack=geo)
    seq_err = max(max_err(got_c[:k, 0], want_c), max_err(got_h[:k, 8], want_h.step_index),
                  max_err(got_h[:k, 9], want_h.shift), max_err(got_h[:k, 4:8].transpose(1, 2), want_h.weight),
                  max_err(got_h[:k, 0:4].transpose(1, 2), want_h.history))
    check(seq_err == 0, f"aad_encode_stream != plain at the sequential shape: {seq_err}")
    del got_c, got_h, want_h, want_c
    seq_live = torch.clamp(seq_args[1] - 4, 0, T)
    seq_steps = int((seq_live * (1 + trials)).sum()) + cb * 2 * T * (trials + 1)  # measures, warm-ups, emit
    # the paired schedule's loop, by pipe, and its latency bound: the chain
    # of 2N passes a block (3 at trials 1), each sample-pass the loop's
    # loop-carried path
    seq_loop = sass_loop(PAIRED_SYMBOL, "LDS")
    seq_samples = sample_loads(seq_loop)
    check(seq_samples > 0, "no sample loads in the paired schedule's step loop")
    seq_stream_bound, _ = loop_bound(cb * nspb * 2 * 2 + nspb * 2 * 2 + 2 * 36 + cb * (geo.data_bytes + 2 * 40), seq_steps,
                                     pipe_counts([op for _, op, _ in seq_loop], seq_samples))
    seq_cycles, seq_chain = latency_line(seq_loop, seq_samples)
    seq_chain_passes = cb * (3 if trials == 1 else 2 * trials) * T
    seq_latency_ms = seq_chain_passes * seq_cycles / SM_CLOCK_HZ * 1e3

    # the lane sweep of the warm-up schedule: 4 blocks of the signal, tiled
    sweep = []
    flat = pcm_t.reshape(-1)
    for lanes_n in SWEEP_LANES:
        need = 4 * lanes_n * nspb
        x = flat.repeat(-(-need // flat.numel()))[:need].reshape(4, nspb, lanes_n)
        sweep_args = (x, torch.full((4, lanes_n), nspb, dtype=torch.int32, device=cuda),
                      CodecState.zeros((lanes_n,), cuda), x[-1].flip(0).contiguous(), bps, trials)
        ms = cuda_ms(lambda: fe.encode_stream_tm(*sweep_args, warm_on_prev=True, blocks_before=4, pack=geo), 3,
                     warmup=1)
        sweep.append((lanes_n, ms))
        del x, sweep_args

    # rates
    total = pcm.size
    enc = at.Encoder.from_config(cfg, device="cuda", parallel_blocks=True)
    resident_ms = cuda_ms(lambda: enc.encode_payload_ondevice(pcm_t), ENCODE_ITERS)
    t0 = time.perf_counter()
    for _ in range(3):
        at.encode(pcm, cfg, device="cuda", parallel_blocks=True)
    e2e_s = (time.perf_counter() - t0) / 3
    t0 = time.perf_counter()
    for _ in range(2):
        at.encode(seq_pcm, cfg, device="cuda")
    seq_s = (time.perf_counter() - t0) / 2
    par_prof = profile("device-resident parallel encode, 10-minute stream", lambda: enc.encode_payload_ondevice(pcm_t),
                       10, codes=(L * T,))
    check(par_prof["code_ops"] == 0, f"the parallel encode makes a tensor of its codes one a byte "
                                     f"({par_prof['code_ops']} operations a call)")
    print(f"[profile]   resident parallel encode: {par_prof['device_ms']:.4f} ms of device time a call, beside "
          f"{BYTE_CODES_PARALLEL_ENCODE_MS:.4f} ms when kernel 3 wrote its codes one a byte and torch ops packed "
          f"them ({card})")
    profile(f"sequential encode() of {SEQ_SECONDS} s", lambda: at.encode(seq_pcm, cfg, device="cuda"), 1)

    print(f"[time] card: {card}")
    print(f"[time] aad_encode_stream {L} lanes x 1 block of {nspb}, 4-bit trials {trials}, parallel, packed: "
          f"kernel {stream_ms:.4f} ms, plain torch on the card {stream_plain_ms:.4f} ms, "
          f"bound {stream_bound[0]:.4f} ms ({stream_bound[1]}; {steps} sample-passes) ({card})")
    print(f"[sass] aad_encode_stream serial schedule, 4-bit, measure: {sass_line(serial_sass, stream_pipe)}")
    print(f"[time] aad_encode_stream 2 lanes x {cb} blocks of {nspb}, trials {trials}, warm-up on the previous "
          f"block (the sequential path, {main['seq_launches'][fe.STREAM_KERNEL]} launches in {SEQ_SECONDS} s): "
          f"{seq_stream_ms:.4f} ms a launch, bound {seq_stream_bound[0]:.6f} ms ({seq_stream_bound[1]}; "
          f"{seq_steps} sample-passes, {seq_stream_bound[0] / seq_stream_ms:.4%} of the bound; its first "
          f"{SEQ_CHECK_BLOCKS} blocks == plain, bit-exact); latency bound "
          f"{seq_latency_ms:.4f} ms (bound_by latency; {seq_chain_passes} sample-passes on the chain), "
          f"{seq_latency_ms / seq_stream_ms:.1%} of it ({card})")
    print(f"[sass] aad_encode_stream paired schedule, staged, 4-bit: {seq_chain}")
    print(f"[sass] aad_encode_pass 4-bit, measure: {sass_line(pass_sass, pass_pipe)}; {pass_chain}")
    print(f"[time] aad_encode_pass 2 lanes x {T} codes, measure: kernel {pass_ms:.4f} ms, "
          f"plain torch on the card {pass_plain_ms:.4f} ms, bound {pass_bound[0]:.6f} ms ({pass_bound[1]}); "
          f"latency bound {pass_latency_ms:.4f} ms (bound_by latency; {T} steps on the chain), "
          f"{pass_latency_ms / pass_ms:.1%} of it ({card})")
    for lanes_n, ms in sweep:
        print(f"[sweep] aad_encode_stream {lanes_n} lanes x 4 blocks of {nspb}, trials {trials}, warm-up on the "
              f"previous block (the paired schedule): {ms:.4f} ms a launch ({card})")
    print(f"[time] device-resident parallel encode_payload_ondevice: {resident_ms:.4f} ms, "
          f"{total / (resident_ms / 1e3):.6e} samples/s ({card})")
    print(f"[time] transfer-inclusive parallel encode(): {e2e_s * 1e3:.4f} ms, {total / e2e_s:.6e} samples/s ({card})")
    print(f"[time] sequential encode() of {SEQ_SECONDS} s stereo: {seq_s * 1e3:.4f} ms, "
          f"{seq_pcm.size / seq_s:.6e} samples/s ({card})")

    par, seq = main["par_launches"], main["seq_launches"]
    return [
        {"name": fe.STREAM_KERNEL, "route": "cuda", "source": "aad_tpu_torch/csrc/encode.cu",
         "replaces": "aad_tpu/ops/pallas_encode_fused.py:1102",
         "launches": par[fe.STREAM_KERNEL] + seq[fe.STREAM_KERNEL], "max_abs_err": max(stream_err, full_err, seq_err),
         "ms": stream_ms, "plain_ms": stream_plain_ms, "bound_ms": stream_bound[0], "bound_by": stream_bound[1],
         "library_ms": None},
        {"name": ep.PASS_KERNEL, "route": "cuda", "source": "aad_tpu_torch/csrc/encode.cu",
         "replaces": "aad_tpu/ops/pallas_encode.py:298", "launches": seq[ep.PASS_KERNEL],
         "max_abs_err": pass_err, "ms": pass_ms, "plain_ms": pass_plain_ms, "bound_ms": pass_bound[0],
         "bound_by": pass_bound[1], "library_ms": None},
    ]


def reset_all_launches() -> None:
    """Zero every kernel's launch count; the probe's cached result stays, as
    it does within one process."""
    from aad_tpu_torch.ops import encode_pass as ep, fused_decode as fd, fused_encode as fe, lms

    for mod in (fd, lms, fe, ep):
        mod.launches.update(dict.fromkeys(mod.launches, 0))


def all_launches() -> dict:
    from aad_tpu_torch.ops import encode_pass as ep, fused_decode as fd, fused_encode as fe, lms

    return {**fd.launches, **lms.launches, **fe.launches, **ep.launches}


def reset_probe_launches() -> None:
    from aad_tpu_torch.probes import decode_layout, phase_a_decode, transpose

    for mod in (transpose, phase_a_decode, decode_layout):
        mod.launches.update(dict.fromkeys(mod.launches, 0))


def probe_launches() -> dict:
    from aad_tpu_torch.probes import decode_layout, phase_a_decode, transpose

    return {**transpose.launches, **phase_a_decode.launches, **decode_layout.launches}


def lms_kernel_checks(cuda) -> int:
    """Phase 10: aad_lms_lanes against its plain version, bit for bit; and
    phase A by the prefix scan against the loop, on the card."""
    import torch
    from aad_tpu_torch.ops import lms
    from aad_tpu_torch.ops.decode import compute_qdiffs, compute_qdiffs_prefix

    rng = np.random.default_rng(SEED + 3)
    worst = 0
    for bps in (2, 3, 4):
        for L, T in ((4099, 988), (1061, 1), (333, 988), *((B * C, T) for B, C, T in EDGE_SHAPES)):
            codes = torch.from_numpy(rng.integers(0, 2**bps, (T, L), dtype=np.uint8)).to(cuda)
            init = rng.integers(0, 4081, L).astype(np.int32)
            init[: L // 2] = 4080  # the top step: |qdiff| up to about 61k
            init = torch.from_numpy(init).to(cuda)
            qdiffs = compute_qdiffs_prefix(codes, init, bps, dim=0)
            loop = compute_qdiffs(codes.t(), init, bps).t()
            check(torch.equal(qdiffs, loop), f"compute_qdiffs_prefix != compute_qdiffs on the card at bps={bps} L={L} T={T}")
            history = int32_wide(rng, L)
            weight = rng.integers(-(2**31), 2**31 - 1, (L, 4), endpoint=True).astype(np.int32)
            weight[1::2] = rng.integers(-20000, 20000, weight[1::2].shape)
            weight[::4] = rng.integers(-20000, 20000, weight[::4].shape)  # as the benchmark draws them
            wraps = int((np.abs((history.astype(np.int64) * weight).sum(-1) + 2**14) >= 2**31).sum())
            args = (qdiffs.cpu(), torch.from_numpy(history), torch.from_numpy(weight))
            want = lms.lms_lanes_reference(*args)
            got = lms.lms_lanes(*(a.to(cuda) for a in args))
            torch.cuda.synchronize()
            err = max_err(got, want)
            check(err == 0, f"aad_lms_lanes != plain at bps={bps} L={L} T={T}: max |err| {err}")
            worst = max(worst, err)
            print(f"[kernel-vs-plain] aad_lms_lanes bps={bps} lanes={L} steps={T}, max |qdiff| "
                  f"{int(qdiffs.abs().max())}, {wraps} lanes whose first 4-tap sum wraps: bit-exact; "
                  f"compute_qdiffs_prefix == compute_qdiffs on the card")
    return worst


def slice_main_path(cuda, bench) -> dict:
    """Phase 11: the two-phase engine, range decodes, batch, streaming and
    transcode at full width, each against its one-shot counterpart."""
    import torch
    import aad_tpu_torch as at
    import aad_tpu_torch.codec.decoder as dec_mod
    from aad_tpu_torch.ops import fused_decode as fd, lms

    data, h, ref, ms_data, ms_ref = bench["data"], bench["header"], bench["ref"], bench["ms_data"], bench["ms_ref"]
    counts = {}

    def drive(label, fn):
        reset_all_launches()
        out = fn()
        counts[label] = {k: v for k, v in all_launches().items() if v}
        return out

    # (a) the benchmark stream and its mid/side variant, both engines; one
    # launch a chunk of decode()'s transfer path
    chunks = -(-h.num_samples // h.num_samples_per_block // dec_mod._TRANSFER_CHUNK_BLOCKS)
    t0 = time.perf_counter()
    _, got = drive("decode pallas", lambda: at.decode(data, device="cuda", engine="pallas"))
    first_s = time.perf_counter() - t0
    check(counts["decode pallas"] == {lms.LMS_KERNEL: chunks}, f"pallas decode launches {counts['decode pallas']}")
    _, fused = drive("decode fused", lambda: at.decode(data, device="cuda", engine="fused"))
    check(counts["decode fused"] == {fd.DECODE_KERNEL: chunks}, f"fused decode launches {counts['decode fused']}")
    check(np.array_equal(got, fused) and np.array_equal(got, ref), "pallas decode != fused / cpu")
    print(f"[slice] decode(engine='pallas') of the bench stream: == engine='fused' on the card == cpu, bit-exact; "
          f"launches pallas {counts['decode pallas']}, fused {counts['decode fused']}; first call {first_s:.3f} s")
    del fused
    _, got = drive("decode pallas mid/side", lambda: at.decode(ms_data, device="cuda", engine="pallas"))
    _, fused = at.decode(ms_data, device="cuda", engine="fused")
    check(np.array_equal(got, fused) and np.array_equal(got, ms_ref), "pallas mid/side != fused / cpu")
    print("[slice] mid/side variant, engine='pallas': == fused on the card == cpu, bit-exact")
    del got, fused

    # (b) random access, against slices of the full decode
    nspb = h.num_samples_per_block
    nblocks = -(-h.num_samples // nspb)
    seconds = h.num_samples / RATE
    payload = np.frombuffer(data, np.uint8)[at.FILE_HEADER_SIZE:]
    for engine in ("pallas", "fused"):
        dec = at.Decoder.from_header(h, device="cuda", engine=engine)
        for b0, n in ((0, 5), (nblocks // 2 + 1, 37), (nblocks - 3, 10), (nblocks - 1, 1)):
            got = drive(f"block range {engine}", lambda: dec.decode_block_range(payload, b0, n))
            check(got.device == cuda and got.dtype == torch.int32, "block range output")
            want = ref[:, b0 * nspb : min(b0 + n, nblocks) * nspb]
            check(np.array_equal(got.cpu().numpy(), want), f"decode_block_range({b0}, {n}) {engine} != slice")
        for s0, s1 in ((seconds / 2 + 0.3456, seconds / 2 + 1.5), (0.0, 0.01), (seconds - 0.01, seconds + 100)):
            got = drive(f"time range {engine}", lambda: dec.decode_time_range(payload, s0, s1))
            want = ref[:, int(s0 * RATE) : min(h.num_samples, int(s1 * RATE))]
            check(np.array_equal(got.cpu().numpy(), want), f"decode_time_range({s0}, {s1}) {engine} != slice")
    print(f"[slice] decode_block_range (first, inner, last 3 and the last block alone) and decode_time_range "
          f"(inner, head, past the end) under both engines: == slices of the full decode; launches "
          f"{counts['block range pallas']} and {counts['block range fused']} a range")

    # (c) a pile of four geometries through decode_batch
    pile = [data, bench["mono"],
            bench_stream(RATE * 60, ms=True, seed=SEED + 3)[0],
            bench_stream(RATE * 30, bps=2, seed=SEED + 4, max_block_size=256)[0]]
    singles = [ref] + [at.decode(s, device="cuda")[1] for s in pile[1:]]
    for engine in ("pallas", "fused"):
        out = drive(f"batch {engine}", lambda: at.decode_batch(pile, device="cuda", engine=engine))
        for (bh, got), want in zip(out, singles):
            check(got.dtype == np.int16 and np.array_equal(got, want), f"decode_batch {engine} != decode")
    kernel = {"pallas": lms.LMS_KERNEL, "fused": fd.DECODE_KERNEL}
    for engine in kernel:
        check(counts[f"batch {engine}"] == {kernel[engine]: 4}, f"batch {engine} launches {counts[f'batch {engine}']}")
    print(f"[slice] decode_batch of 4 geometries (bench stream, mono 3-bit, mid/side, 2-bit 256-byte blocks), "
          f"{sum(p.size for _, p in out)} samples: == per-stream decode under both engines; launches "
          f"{counts['batch pallas']} / {counts['batch fused']}")
    del out

    # (d) streaming decode of the bench stream in uneven pushes
    def stream_decode(engine):
        sd = at.StreamingDecoder(device="cuda", engine=engine)
        return np.concatenate([sd.push(data[i : i + STREAM_PUSH]) for i in range(0, len(data), STREAM_PUSH)], axis=1)

    got = drive("streaming decode pallas", lambda: stream_decode("pallas"))
    check(np.array_equal(got, ref), "StreamingDecoder != one-shot decode")
    pushes = -(-len(data) // STREAM_PUSH)
    print(f"[slice] StreamingDecoder(engine='pallas'), {pushes} pushes of {STREAM_PUSH} bytes: == one-shot decode; "
          f"launches {counts['streaming decode pallas']}")
    del got

    # (e) streaming encode of the 60-second signal in uneven chunks
    enc_main = bench["encode"]
    cfg, seq_pcm = enc_main["cfg"], enc_main["seq_pcm"]

    def stream_encode():
        se = at.StreamingEncoder(cfg, device="cuda", total_samples=seq_pcm.shape[1])
        parts, off, i = [se.header()], 0, 0
        while off < seq_pcm.shape[1]:
            n = STREAM_CHUNKS[i % len(STREAM_CHUNKS)]
            parts.append(se.push(seq_pcm[:, off : off + n]))
            off, i = off + n, i + 1
        return b"".join(parts) + se.finish(), i

    (streamed, chunks) = drive("streaming encode", stream_encode)
    check(streamed == enc_main["seq"], "StreamingEncoder != sequential encode()")
    print(f"[slice] StreamingEncoder over the {SEQ_SECONDS}-s signal in {chunks} uneven chunks: == sequential "
          f"encode(device='cuda') bytes; launches {counts['streaming encode']}")

    # (f) transcode 4-bit -> 2-bit of a short stream
    short = at.encode(bench_pcm(4 * nspb - 100, seed=SEED + 5), cfg, device="cuda")
    got = drive("transcode", lambda: at.transcode(short, device="cuda", engine="pallas", bits_per_sample=2))
    check(got == at.transcode(short, device="cpu", bits_per_sample=2), "transcode: cuda != cpu")
    check(at.decode_header(got).bits_per_sample == 2, "transcode header")
    print(f"[slice] transcode 4-bit -> 2-bit, {4 * nspb - 100} samples/ch: cuda == cpu, bit-exact; "
          f"launches {counts['transcode']}")
    return dict(counts=counts, pile=pile)


def slice_times(cuda, card, bench, slice_run, lms_err) -> dict:
    """Phase 12: the slice's times; the LMS kernel's record."""
    import torch
    import aad_tpu_torch as at
    from aad_tpu_torch.format.framing import block_codes, pad_to_blocks, parse_block_headers
    from aad_tpu_torch.ops import lms
    from aad_tpu_torch.ops.decode import compute_qdiffs, compute_qdiffs_prefix

    data, h = bench["data"], bench["header"]
    geo = at.geometry_from_header(h.num_channels, h.bits_per_sample, h.block_size)
    nblocks = -(-h.num_samples // geo.num_samples_per_block)
    payload = torch.from_numpy(np.frombuffer(data, np.uint8)[at.FILE_HEADER_SIZE:].copy()).to(cuda)
    blocks = pad_to_blocks(payload, nblocks, geo)
    states = parse_block_headers(blocks, geo)
    codes = block_codes(blocks, geo)
    B, C, T = codes.shape
    L = B * C
    codes_tm = codes.permute(2, 1, 0).reshape(T, L).contiguous()
    init = states.step_index.t().reshape(L).contiguous()
    history = states.history.transpose(0, 1).reshape(L, 4).contiguous()
    weight = states.weight.transpose(0, 1).reshape(L, 4).contiguous()
    del blocks, codes

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    qdiffs = compute_qdiffs_prefix(codes_tm, init, 4, dim=0)
    torch.cuda.synchronize()
    phase_a_peak = torch.cuda.max_memory_allocated() - base
    check(torch.equal(qdiffs, compute_qdiffs(codes_tm.t(), init, 4).t()), "phase A prefix != loop at full width")
    phase_a_ms = cuda_ms(lambda: compute_qdiffs_prefix(codes_tm, init, 4, dim=0), DECODE_ITERS)
    phase_a_loop_ms = cuda_ms(lambda: compute_qdiffs(codes_tm.t(), init, 4), 1, warmup=0)

    got = lms.lms_lanes(qdiffs, history, weight)
    want = lms.lms_lanes_reference(qdiffs, history, weight)
    full_err = max_err(got, want)
    check(full_err == 0, f"aad_lms_lanes != plain on the card at the main-path shape: {full_err}")
    del got, want
    kernel_ms = cuda_ms(lambda: lms.lms_lanes(qdiffs, history, weight), KERNEL_ITERS)
    plain_ms = cuda_ms(lambda: lms.lms_lanes_reference(qdiffs, history, weight), 3, warmup=1)
    kernel_ms_2 = cuda_ms(lambda: lms.lms_lanes(qdiffs, history, weight), KERNEL_ITERS)
    lms_sass = sass_per_sample(LMS_SYMBOL)
    lms_bound, lms_pipe = loop_bound(L * T * 4 + L * 32 + L * (T + 4) * 2, L * T, lms_sass)
    del qdiffs

    total = h.num_samples * h.num_channels
    fused = at.Decoder.from_header(h, device="cuda", engine="fused")
    pallas = at.Decoder.from_header(h, device="cuda", engine="pallas")
    turns = [("fused", fused), ("pallas", pallas), ("pallas", pallas), ("fused", fused)]
    resident = {"fused": [], "pallas": []}
    for name, dec in turns:
        resident[name].append(cuda_ms(lambda: dec.decode_payload_ondevice(payload), DECODE_ITERS))

    def host_s(fn, iters):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters

    pile = slice_run["pile"]
    pile_samples = sum(at.decode_header(s).num_samples * at.decode_header(s).num_channels for s in pile)
    batch_s = {e: host_s(lambda: at.decode_batch(pile, device="cuda", engine=e), 3) for e in ("pallas", "fused")}

    def stream_decode():
        sd = at.StreamingDecoder(device="cuda", engine="pallas")
        for i in range(0, len(data), STREAM_PUSH):
            sd.push(data[i : i + STREAM_PUSH])

    stream_dec_s = host_s(stream_decode, 2)
    enc_main = bench["encode"]
    cfg, seq_pcm = enc_main["cfg"], enc_main["seq_pcm"]

    def stream_encode():
        se = at.StreamingEncoder(cfg, device="cuda")
        off, i = 0, 0
        while off < seq_pcm.shape[1]:
            n = STREAM_CHUNKS[i % len(STREAM_CHUNKS)]
            se.push(seq_pcm[:, off : off + n])
            off, i = off + n, i + 1
        se.finish()

    stream_enc_s = host_s(stream_encode, 1)
    code_numels = (L * T, B * geo.data_bytes)  # the codes one a byte; the data regions' unpack
    two = profile("device-resident two-phase (pallas) decode, bench stream",
                  lambda: pallas.decode_payload_ondevice(payload), 10, time_major=(T, L), codes=code_numels)
    check(two["copies"] >= 1, "the profile does not see the two-phase decode's time-major code copy")
    check(two["code_ops"] >= 1, "the profile does not see the two-phase decode's unpack of the codes")
    one = profile("device-resident fused decode, bench stream",
                  lambda: fused.decode_payload_ondevice(payload), 10, time_major=(T, L), codes=code_numels)
    check(one["copies"] == 0, f"the fused decode copies the codes time-major ({one['copies']} a call)")
    check(one["code_ops"] == 0, f"the fused decode unpacks the codes ({one['code_ops']} operations a call)")

    print(f"[time] card: {card}")
    print(f"[grid] aad_lms_lanes: {grid_line(LMS_SYMBOL, L, cuda)}")
    print(f"[sass] aad_lms_lanes: {sass_line(lms_sass, lms_pipe)}")
    print(f"[time] aad_lms_lanes {L} lanes x {T} steps: kernel {kernel_ms:.4f} / {kernel_ms_2:.4f} ms (two windows), "
          f"bound {lms_bound[0]:.4f} ms ({lms_bound[1]}), {lms_bound[0] / min(kernel_ms, kernel_ms_2):.1%} of the "
          f"bound; plain torch on the card {plain_ms:.4f} ms ({card})")
    print(f"[time] phase A compute_qdiffs_prefix {T} x {L}: {phase_a_ms:.4f} ms, peak {phase_a_peak / 2**20:.1f} MiB "
          f"above its inputs; the loop compute_qdiffs on the card {phase_a_loop_ms:.4f} ms ({card})")
    for name in ("fused", "pallas"):
        ms = resident[name]
        print(f"[time] device-resident decode_payload_ondevice engine={name}: "
              + " / ".join(f"{m:.4f} ms" for m in ms)
              + f" -> {total / (min(ms) / 1e3):.6e} samples/s at best ({card})")
    for e, s in batch_s.items():
        print(f"[time] decode_batch of the pile, engine={e}: {s * 1e3:.4f} ms, {pile_samples / s:.6e} samples/s ({card})")
    print(f"[time] StreamingDecoder(engine='pallas'), bench stream in {STREAM_PUSH}-byte pushes: "
          f"{stream_dec_s * 1e3:.4f} ms, {total / stream_dec_s:.6e} samples/s ({card})")
    print(f"[time] StreamingEncoder, {SEQ_SECONDS} s stereo in uneven chunks: {stream_enc_s * 1e3:.4f} ms, "
          f"{seq_pcm.size / stream_enc_s:.6e} samples/s ({card})")

    launches = sum(c.get(lms.LMS_KERNEL, 0) for c in slice_run["counts"].values())
    return {"name": lms.LMS_KERNEL, "route": "cuda", "source": "aad_tpu_torch/csrc/lms.cu",
            "replaces": "aad_tpu/ops/pallas_lms.py:113", "launches": launches,
            "max_abs_err": max(lms_err, full_err), "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": lms_bound[0], "bound_by": lms_bound[1], "library_ms": None}


@contextlib.contextmanager
def cpu_threads(n):
    """torch's CPU ops on ``n`` threads inside the block: the plain encode
    engine's ops on a few thousand lanes run faster on one thread than
    spread over several."""
    import torch

    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def pile_streams(pcm, lengths, seed) -> list[np.ndarray]:
    """Contiguous streams cut from the (C, N) encode signal, one a length,
    at offsets drawn from ``seed``: a pile of separate signals."""
    rng = np.random.default_rng(seed)
    offsets = rng.integers(0, pcm.shape[1] - max(lengths) + 1, len(lengths))
    return [np.ascontiguousarray(pcm[:, o : o + n]) for o, n in zip(offsets, lengths)]


def pile_blocks(pile, nspb: int) -> np.ndarray:
    """A pile of (C, n) streams as (B, S, C, nspb) int16 blocks, contiguous,
    zero past each stream's end."""
    nb = -(-max(p.shape[1] for p in pile) // nspb)
    out = np.zeros((len(pile), pile[0].shape[0], nb * nspb), np.int16)
    for s, p in enumerate(pile):
        out[s, :, : p.shape[1]] = p
    return np.ascontiguousarray(out.reshape(len(pile), -1, nb, nspb).transpose(2, 0, 1, 3))


def timeline(label, fn, iters) -> tuple[float, float]:
    """``fn`` under torch.profiler: the device time by kernel and copy a
    call, and how much of the call's host-clock time the card was busy,
    kernels and copies on every stream, overlaps counted once (the rest is
    its idle share). Returns (host-clock ms, busy ms) a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3 / iters
    rows = sorted(
        ((e.self_device_time_total / 1e3 / iters, e.count / iters, e.key)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    print(f"[profile] {label}: {wall_ms:.4f} ms a call by the host clock under the profiler; the card busy "
          f"{busy_ms:.4f} ms of it (kernels and copies on all streams, overlaps once), idle "
          f"{1 - busy_ms / wall_ms:.1%}; {sum(r[0] for r in rows):.4f} ms of device time summed")
    for ms, count, name in rows[:8]:
        print(f"[profile]   {ms:.4f} ms x{count:g} {name[:100]}")
    return wall_ms, busy_ms


def in_turns(label, fns: dict, calls: dict, card) -> dict:
    """Time each function of ``fns`` (name -> fn) by the host clock in turns
    a b b a (``calls[name]`` calls a turn, a warm-up call before the first
    turn); print and return the ms a call of each turn."""
    (a, fa), (b, fb) = fns.items()
    for fn in (fa, fb):
        fn()
    times = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        t0 = time.perf_counter()
        for _ in range(calls[name]):
            fn()
        times[name].append((time.perf_counter() - t0) * 1e3 / calls[name])
    print(f"[transfer] {label}, in turns {a} / {b} / {b} / {a}, ms a call by the host clock: "
          f"{a} {', '.join(f'{t:.4f}' for t in times[a])}; {b} {', '.join(f'{t:.4f}' for t in times[b])} ({card})")
    return times


def transfer_native_phase(cuda, card, bench, main, slice_run, first_decode_s) -> None:
    """Phase 15: the transfer paths of decode() and encode() against the
    resident paths and the CPU at full width, with decode()'s chunk sweep
    and their times beside the resident paths' in turns; kernels 1 and 5 at
    the shape of decode()'s chunk; every engine="native" entry point against
    the card's output, with the native engine's rates on the card's host."""
    import torch
    import aad_tpu_torch as at
    import aad_tpu_torch.codec.decoder as dec_mod
    from aad_tpu_torch.codec.decoder import stream_bytes
    from aad_tpu_torch.codec.encoder import as_int16
    from aad_tpu_torch.constants import STEP_INDEX_MAX
    from aad_tpu_torch.format.framing import block_codes, pad_to_blocks, parse_block_headers
    from aad_tpu_torch.ops import cseman as cs, fused_decode as fd, lms
    from aad_tpu_torch.ops.decode import compute_qdiffs_prefix

    data, h, ref = bench["data"], bench["header"], bench["ref"]
    geo = at.geometry_from_header(h.num_channels, h.bits_per_sample, h.block_size)
    total = h.num_samples * h.num_channels
    nblocks = -(-h.num_samples // h.num_samples_per_block)
    chunk = dec_mod._TRANSFER_CHUNK_BLOCKS

    def old_decode(stream, engine="fused", strict=True):
        """decode() before its transfer path: the resident decode of a
        pageable upload, brought back as int16 and widened on the host."""
        buf = stream_bytes(stream)
        header = at.decode_header(buf[: at.FILE_HEADER_SIZE].tobytes())
        dec = at.Decoder.from_header(header, device="cuda", engine=engine)
        return dec.decode_payload_ondevice(buf[at.FILE_HEADER_SIZE :], strict=strict).cpu().numpy().astype(np.int32)

    # (a) decode(): bit-exact against the resident path and the CPU, at full width
    cut = data[: len(data) - STREAM_PUSH]  # a lenient stream, cut inside a block
    _, cut_ref = at.decode(cut, device="cpu", strict=False)
    for engine in ("fused", "pallas"):
        for label, stream, want, strict in (("bench stream", data, ref, True),
                                            ("mid/side", bench["ms_data"], bench["ms_ref"], True),
                                            ("cut, lenient", cut, cut_ref, False)):
            _, got = at.decode(stream, device="cuda", engine=engine, strict=strict)
            check(got.dtype == np.int32 and np.array_equal(got, want), f"decode() {label} {engine} != cpu")
            check(np.array_equal(got, old_decode(stream, engine, strict)), f"decode() {label} {engine} != resident")
    del got
    print(f"[transfer] decode(device='cuda') in chunks of {chunk} blocks ({-(-nblocks // chunk)} for the bench "
          f"stream): the bench stream, its mid/side variant and a lenient stream cut {STREAM_PUSH} bytes short, "
          f"under both engines: == device='cpu' == the resident decode, bit-exact, int32")

    # kernels 1 and 5 at the shape decode() gives them: its first chunk
    blocks = pad_to_blocks(torch.from_numpy(np.frombuffer(data, np.uint8)[at.FILE_HEADER_SIZE:].copy()), chunk,
                           geo).to(cuda)
    states = parse_block_headers(blocks, geo)  # phase A's and kernel 5's inputs
    codes = block_codes(blocks, geo)
    B, C, T = codes.shape
    lanes = (states.step_index.t().reshape(-1).contiguous(), states.history.transpose(0, 1).reshape(-1, 4).contiguous(),
             states.weight.transpose(0, 1).reshape(-1, 4).contiguous())
    err1 = max_err(fd.decode_rows(blocks, geo), fd.decode_rows_reference(blocks, geo))
    qdiffs = compute_qdiffs_prefix(codes.permute(2, 1, 0).reshape(T, C * B).contiguous(),
                                   cs.clip(lanes[0], 0, STEP_INDEX_MAX), 4, dim=0)
    err5 = max_err(lms.lms_lanes(qdiffs, lanes[1], lanes[2]), lms.lms_lanes_reference(qdiffs, lanes[1], lanes[2]))
    check(err1 == 0 and err5 == 0, f"kernels at decode()'s chunk: max |err| {err1}, {err5}")
    k1_ms = cuda_ms(lambda: fd.decode_rows(blocks, geo), KERNEL_ITERS)
    k5_ms = cuda_ms(lambda: lms.lms_lanes(qdiffs, lanes[1], lanes[2]), KERNEL_ITERS)
    print(f"[time] at decode()'s chunk, {C * B} lanes x {T} codes (the bench stream's first chunk): "
          f"aad_decode_lanes {k1_ms:.4f} ms, aad_lms_lanes {k5_ms:.4f} ms a launch, both == plain, bit-exact ({card})")
    del blocks, states, codes, lanes, qdiffs

    # (b) decode()'s chunk sweep; (c) against the old expression in turns
    sweep = []
    try:
        for cb in TRANSFER_CHUNKS:
            dec_mod._TRANSFER_CHUNK_BLOCKS = cb
            check(np.array_equal(at.decode(data, device="cuda")[1], ref), f"decode() in chunks of {cb} != cpu")
            t0 = time.perf_counter()
            for _ in range(TRANSFER_ITERS):
                at.decode(data, device="cuda")
            sweep.append((cb, (time.perf_counter() - t0) * 1e3 / TRANSFER_ITERS))
    finally:
        dec_mod._TRANSFER_CHUNK_BLOCKS = chunk
    for cb, ms in sweep:
        print(f"[sweep] decode() of the bench stream in chunks of {cb} blocks ({-(-nblocks // cb)} chunks): "
              f"{ms:.4f} ms a call by the host clock, {total / (ms / 1e3):.6e} samples/s ({card})")
    turns = in_turns("decode() of the bench stream", {"old": lambda: old_decode(data),
                                                      "new": lambda: at.decode(data, device="cuda")},
                     {"old": 3, "new": TRANSFER_ITERS}, card)
    new_ms = min(turns["new"])
    print(f"[time] transfer-inclusive decode(): {new_ms:.4f} ms, {total / (new_ms / 1e3):.6e} samples/s; the old "
          f"expression {min(turns['old']):.4f} ms; the first call of the process (phase 5, pinned buffers "
          f"allocated) {first_decode_s * 1e3:.4f} ms ({card})")
    timeline("transfer-inclusive decode(), the bench stream", lambda: at.decode(data, device="cuda"), 3)
    timeline("the old decode() expression, the bench stream", lambda: old_decode(data), 2)

    # (d) encode(): against the resident path at full width, and in turns
    cfg, pcm, seq_pcm = main["cfg"], main["pcm"], main["seq_pcm"]

    def old_encode(x, parallel):
        """encode() before its transfer path: a pageable upload, the resident
        encode, a pageable download and a bytes copy."""
        enc = at.Encoder.from_config(cfg, device="cuda", parallel_blocks=parallel)
        x = torch.from_numpy(np.ascontiguousarray(as_int16(x))).to(cuda)
        return at.encode_header(cfg.header_for(x.shape[1])) + enc.encode_payload_ondevice(x).cpu().numpy().tobytes()

    check(old_encode(pcm, True) == main["par"], "parallel encode(): transfer path != resident")
    check(old_encode(seq_pcm, False) == main["seq"], "sequential encode(): transfer path != resident")
    print(f"[transfer] encode(device='cuda'), parallel (10 min) and sequential ({SEQ_SECONDS} s, "
          f"{-(-seq_pcm.shape[1] // geo.num_samples_per_block)} blocks in chunks of 64): == the resident encode, "
          f"bit-exact (and == the native engine and the plain version's prefix, phase 8)")
    par_turns = in_turns("parallel encode() of the 10-minute signal",
                         {"old": lambda: old_encode(pcm, True),
                          "new": lambda: at.encode(pcm, cfg, device="cuda", parallel_blocks=True)},
                         {"old": 3, "new": 3}, card)
    seq_turns = in_turns(f"sequential encode() of {SEQ_SECONDS} s",
                         {"old": lambda: old_encode(seq_pcm, False), "new": lambda: at.encode(seq_pcm, cfg, device="cuda")},
                         {"old": 1, "new": 1}, card)
    for label, times, n in (("parallel", par_turns, pcm.size), ("sequential", seq_turns, seq_pcm.size)):
        print(f"[time] transfer-inclusive {label} encode(): {min(times['new']):.4f} ms, "
              f"{n / (min(times['new']) / 1e3):.6e} samples/s; the old expression {min(times['old']):.4f} ms ({card})")
    timeline("transfer-inclusive parallel encode(), 10 minutes",
             lambda: at.encode(pcm, cfg, device="cuda", parallel_blocks=True), 2)
    timeline("the old parallel encode() expression", lambda: old_encode(pcm, True), 2)
    timeline(f"transfer-inclusive sequential encode(), {SEQ_SECONDS} s", lambda: at.encode(seq_pcm, cfg, device="cuda"), 1)

    # (e) every engine="native" entry point against the card's output, and
    # the native engine's rates on the card's host
    def host_ms(fn, calls=1):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn()
        return out, (time.perf_counter() - t0) * 1e3 / calls

    (_, got), nat_dec_ms = host_ms(lambda: at.decode(data, engine="native"), 2)
    check(got.dtype == np.int32 and np.array_equal(got, ref), "native decode != the card's")
    check(np.array_equal(at.decode(bench["ms_data"], engine="native")[1], bench["ms_ref"]), "native mid/side")
    check(np.array_equal(at.decode(bench["mono"], engine="native")[1], at.decode(bench["mono"], device="cuda")[1]),
          "native mono 3-bit")
    check(np.array_equal(at.decode(cut, engine="native", strict=False)[1], cut_ref), "native lenient")
    try:
        at.decode(cut, engine="native")
        raise AssertionError("strict native decode of a cut stream did not raise")
    except at.InsufficientDataError:
        pass
    seq_native, nat_seq_ms = host_ms(lambda: at.encode(seq_pcm, cfg, engine="native"))
    check(seq_native == main["seq"], "native sequential encode != the card's")
    par_native, nat_par_ms = host_ms(lambda: at.encode(pcm, cfg, engine="native", parallel_blocks=True))
    check(par_native == main["par"], "native parallel encode != the card's")
    se = at.StreamingEncoder(cfg, total_samples=seq_pcm.shape[1], engine="native")
    parts, off, i = [se.header()], 0, 0
    while off < seq_pcm.shape[1]:
        parts.append(se.push(seq_pcm[:, off : off + STREAM_CHUNKS[i % len(STREAM_CHUNKS)]]))
        off, i = off + STREAM_CHUNKS[i % len(STREAM_CHUNKS)], i + 1
    check(b"".join(parts) + se.finish() == main["seq"], "native StreamingEncoder != the card's encode()")
    sd = at.StreamingDecoder(engine="native")
    got = np.concatenate([sd.push(data[j : j + STREAM_PUSH]) for j in range(0, len(data), STREAM_PUSH)], axis=1)
    check(np.array_equal(got, ref), "native StreamingDecoder != the card's decode")
    del got
    pile = slice_run["pile"]
    nat_batch, nat_db_ms = host_ms(lambda: at.decode_batch(pile, engine="native"))
    card_batch, card_db_ms = host_ms(lambda: at.decode_batch(pile, device="cuda"), 2)
    check(all(np.array_equal(a[1], b[1]) and a[1].dtype == b[1].dtype for a, b in zip(nat_batch, card_batch)),
          "native decode_batch != the card's")
    pile_samples = sum(p.size for _, p in card_batch)
    del nat_batch, card_batch
    streams = pile_streams(pcm, [PILE_TIME_SECONDS * RATE] * NATIVE_PILE, SEED + 9)
    nat_eb, nat_eb_ms = host_ms(lambda: at.encode_batch(streams, cfg, engine="native"))
    card_eb, card_eb_ms = host_ms(lambda: at.encode_batch(streams, cfg, device="cuda"), 2)
    check(nat_eb == card_eb, "native encode_batch != the card's")
    eb_samples = sum(s.size for s in streams)
    print(f"[native] engine='native' on the card's host ({os.cpu_count()} cores): decode of the bench stream, its "
          f"mid/side variant, mono 3-bit, a lenient cut stream (strict raises); the {SEQ_SECONDS}-s sequential and "
          f"10-minute parallel encode; StreamingEncoder ({i} pushes) and StreamingDecoder; decode_batch of "
          f"phase 11's four geometries; encode_batch of {NATIVE_PILE} streams of {PILE_TIME_SECONDS} s: "
          f"== the card's output, bit-exact")
    for label, n, nat, dev in (("decode of the bench stream", total, nat_dec_ms, new_ms),
                               (f"sequential encode of {SEQ_SECONDS} s", seq_pcm.size, nat_seq_ms, min(seq_turns["new"])),
                               ("parallel encode of 10 minutes", pcm.size, nat_par_ms, min(par_turns["new"])),
                               ("decode_batch of 4 geometries", pile_samples, nat_db_ms, card_db_ms),
                               (f"encode_batch of {NATIVE_PILE} streams of {PILE_TIME_SECONDS} s", eb_samples,
                                nat_eb_ms, card_eb_ms)):
        print(f"[native] {label}: native {nat:.4f} ms, {n / (nat / 1e3):.6e} samples/s; the card "
              f"(transfer-inclusive) {dev:.4f} ms, {n / (dev / 1e3):.6e} samples/s ({card})")


def batch_encode_phase(cuda, card, main) -> dict:
    """Phase 13: encode_batch on the card: the full-width pile against solo
    encodes, exactness cases against the CPU, and times."""
    import torch
    import aad_tpu_torch as at
    from aad_tpu_torch.codec.encoder import _OVERLAP_CHUNK_BLOCKS, _OVERLAP_MIN_BLOCKS
    from aad_tpu_torch.ops import encode_pass as ep, fused_encode as fe
    from aad_tpu_torch.ops.transitions import CodecState

    cfg, pcm = main["cfg"], main["pcm"]
    geo = cfg.geometry()
    nspb = geo.num_samples_per_block
    T = nspb - 4
    rng = np.random.default_rng(SEED + 6)

    # (a) the full-width pile: 2,048 stereo streams of 1 to 4 s, sequential
    lengths = rng.integers(PILE_SECONDS[0] * RATE, PILE_SECONDS[1] * RATE + 1, PILE_STREAMS)
    lengths[[1, -2]] = PILE_SECONDS[1] * RATE, PILE_SECONDS[0] * RATE  # the chunked path; 16 distinct checks
    pile = pile_streams(pcm, lengths, SEED + 7)
    nblocks = -(-int(lengths.max()) // nspb)
    chunks = -(-nblocks // _OVERLAP_CHUNK_BLOCKS)
    check(nblocks >= _OVERLAP_MIN_BLOCKS, "the pile does not reach the chunked path")
    reset_all_launches()
    t0 = time.perf_counter()
    out = at.encode_batch(pile, cfg, device="cuda")
    first_s = time.perf_counter() - t0
    counts = {k: v for k, v in all_launches().items() if v}
    check(counts == {fe.STREAM_KERNEL: chunks, ep.PASS_KERNEL: chunks - 1}, f"pile launches {counts}")
    picks = {int(lengths.argmin()), int(lengths.argmax()), 0, PILE_STREAMS - 1}
    picks |= set(rng.choice(np.setdiff1d(np.arange(PILE_STREAMS), list(picks)), PILE_CHECKS, replace=False).tolist())
    check(len(picks) == PILE_CHECKS + 4, f"pile checks {sorted(picks)}")
    for i in sorted(picks):
        check(out[i] == at.encode(pile[i], cfg, device="cuda"), f"pile stream {i} != its solo encode")
    samples = int(lengths.sum()) * 2
    print(f"[batch] encode_batch of {PILE_STREAMS} stereo 4-bit streams of {PILE_SECONDS[0]}-{PILE_SECONDS[1]} s "
          f"({2 * PILE_STREAMS} lanes, {nblocks} blocks in {chunks} chunks, {samples} samples): streams "
          f"{sorted(picks)} == their solo encode(device='cuda'); launches {counts}; first call {first_s:.3f} s")
    del out

    # (a') the pile's chunked launches against their plain versions, at its
    # shapes: chunk 0 on the card gives the carry, kernel 4's pass over its
    # last block at 4,096 lanes; then kernel 3 on chunk 1 from that carry
    cb, L = _OVERLAP_CHUNK_BLOCKS, 2 * PILE_STREAMS
    bps, trials = cfg.bits_per_sample, cfg.num_encode_trials
    blocks = torch.from_numpy(pile_blocks(pile, nspb)).to(cuda)  # (B, S, C, nspb), as encode_batch sees it
    starts = torch.arange(nblocks, device=cuda)[:, None] * nspb
    valid = torch.clamp(torch.as_tensor(lengths, device=cuda)[None, :] - starts, 0, nspb).to(torch.int32)[..., None]
    head, _, carry = fe.encode_stream(blocks[:cb], valid[:cb], bps, trials, need_carry=True)
    seeded = CodecState(history=head.history[-1].reshape(L, 4).contiguous(),
                        weight=head.weight[-1].reshape(L, 4).contiguous(),
                        step_index=head.step_index[-1].reshape(L).contiguous())
    pass_args = (blocks[cb - 1].reshape(L, nspb)[:, 4:].t().contiguous(), seeded,
                 torch.full((L,), nspb, dtype=torch.int32, device=cuda), bps)
    got_pass, want_pass = ep.encode_pass(*pass_args), ep.encode_pass_reference(*pass_args)  # plain, on the card
    pass_err = max(max_err(tuple(got_pass[0]), tuple(want_pass[0])), max_err(got_pass[2], want_pass[2]))
    check(pass_err == 0, f"aad_encode_pass != plain at the pile's carry shape: {pass_err}")
    check(max_err(tuple(carry[0].map(lambda a: a.reshape(L, *a.shape[2:]))), tuple(want_pass[0])) == 0,
          "the pile's carry != the plain pass over chunk 0's last block")
    got_h, got_c, _ = fe.encode_stream(blocks[cb : 2 * cb], valid[cb : 2 * cb], bps, trials,
                                       carry=carry, blocks_before=cb, need_carry=False, pack=geo)
    k = SEQ_CHECK_BLOCKS
    with cpu_threads(1):
        want_h, want_c, _ = fe.encode_stream_reference(
            blocks[cb : cb + k].cpu(), valid[cb : cb + k].cpu(), bps, trials,
            carry=(carry[0].map(lambda a: a.cpu()), carry[1].cpu()), blocks_before=cb, need_carry=False, pack=geo)
    stream_err = max(max_err(got_c[:k], want_c), max_err(tuple(f[:k] for f in got_h), tuple(want_h)))
    check(stream_err == 0, f"aad_encode_stream != plain on the pile's chunk 1: {stream_err}")
    print(f"[kernel-vs-plain] the pile's chunked launches: aad_encode_pass {T} codes x {L} lanes over chunk 0's "
          f"last block == plain (on the card), and == the carry encode_stream built; aad_encode_stream on chunk 1 "
          f"({cb} blocks x {L} lanes, blocks_before {cb}, staged schedule), its first {k} blocks == plain: bit-exact")
    del blocks, valid, head, carry, got_h, got_c, want_h, want_c

    # (b) exactness against the plain versions on the CPU, at a few blocks
    ms_cfg = at.EncodeConfig(2, RATE, 4, 1024, 1, 2)
    mono_cfg = at.EncodeConfig(1, RATE, 3, 1024, 0, 1)
    mono_nspb = mono_cfg.geometry().num_samples_per_block
    cases = [
        (f"{PILE_STREAMS} streams of 1 sample to 3 blocks", cfg, PILE_STREAMS, 3 * nspb, {}),
        (f"{PILE_STREAMS + 1} streams (past the staging gate) of up to 2 blocks", cfg, PILE_STREAMS + 1, 2 * nspb, {}),
        ("mid/side, 64 streams of up to 2 blocks", ms_cfg, 64, 2 * nspb, {}),
        ("mono 3-bit trials 1, 64 streams of up to 2 blocks", mono_cfg, 64, 2 * mono_nspb, {}),
        ("parallel, chunks of 4 and 1 warm pass, 64 streams of up to 8 blocks", cfg, 64, 8 * nspb,
         dict(parallel_blocks=True, parallel_chunk_blocks=4, parallel_warm_passes=1)),
    ]
    for i, (label, c, count, longest, kw) in enumerate(cases):
        small = pile_streams(pcm[: c.num_channels], rng.integers(1, longest + 1, count), SEED + 8 + i)
        reset_all_launches()
        got = at.encode_batch(small, c, device="cuda", **kw)
        small_counts = {k: v for k, v in all_launches().items() if v}
        check(small_counts.get(fe.STREAM_KERNEL, 0) >= 1, f"{label}: kernel 3 never launched")
        with cpu_threads(1):
            check(got == at.encode_batch(small, c, device="cpu", **kw), f"encode_batch {label}: cuda != cpu")
        print(f"[batch] {label}, {count * c.num_channels} lanes: cuda == cpu, bit-exact; launches {small_counts}")

    # (c) times: piles of 2-s streams, beside one stream's sequential encode()
    def host_s(fn, iters=2):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters

    two = pile_streams(pcm, [PILE_TIME_SECONDS * RATE] * max(PILE_SIZES), SEED + 20)
    solo_s = host_s(lambda: at.encode(two[0], cfg, device="cuda"))
    solo_rate = two[0].size / solo_s
    rates = {}
    for size in PILE_SIZES:
        # the 2,048 pile runs three more times below, under the profilers
        s = host_s(lambda: at.encode_batch(two[:size], cfg, device="cuda"), 1 if size == max(PILE_SIZES) else 2)
        rates[size] = size * two[0].size / s
        print(f"[time] encode_batch of {size} stereo streams of {PILE_TIME_SECONDS} s: {s * 1e3:.4f} ms, "
              f"{rates[size]:.6e} samples/s, {rates[size] / solo_rate:.2f}x the one-stream sequential encode() "
              f"({solo_s * 1e3:.4f} ms, {solo_rate:.6e} samples/s) ({card})")
    profile(f"encode_batch of {max(PILE_SIZES)} stereo streams of {PILE_TIME_SECONDS} s (host clock around it above)",
            lambda: at.encode_batch(two, cfg, device="cuda"), 2, host_rows=10)
    # the host's share by Python function, own time (cProfile adds its cost to each call)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(at.encode_batch, two, cfg, device="cuda")
    wall_s = time.perf_counter() - t0
    top = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: kv[1][2], reverse=True)
    print(f"[profile] encode_batch of {max(PILE_SIZES)} streams under cProfile: {wall_s * 1e3:.4f} ms")
    for (file, line, name), (_, calls, own, _, _) in top[:8]:
        print(f"[profile]   host python {own * 1e3:.4f} ms x{calls} {pathlib.Path(file).name}:{line}({name[:80]})")
    return dict(counts=counts, rates=rates, solo_rate=solo_rate,
                errors={fe.STREAM_KERNEL: stream_err, ep.PASS_KERNEL: pass_err})


def cli_phase(cuda, card, main, bench, resident_ms) -> None:
    """Phase 14: the six CLI modes as subprocesses on the card, the
    self-check, and measure_throughput beside phase 6's CUDA-event time."""
    import torch
    import aad_tpu_torch as at
    import aad_tpu_torch.cli as cli
    from aad_tpu_torch.format.wav import WavFormat, read_wav, write_wav
    from aad_tpu_torch.utils.profiling import measure_throughput

    work = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    n = CLI_SECONDS * RATE
    pcm = np.ascontiguousarray(main["pcm"][:, :n])
    canonical = pcm.astype(np.int32) << 16
    write_wav(str(work / "in.wav"), WavFormat(2, RATE, 16, n), canonical)
    want_aad = at.encode(pcm, main["cfg"], device="cuda")  # the CLI's defaults: 4-bit, 1024 bytes, trials 2
    (work / "ref.aad").write_bytes(want_aad)
    _, want_pcm = at.decode(want_aad, device="cuda")
    wav_in, aad_in = str(work / "in.wav"), str(work / "ref.aad")
    runs = {
        "-e": ["-e", wav_in, str(work / "e.aad")],
        "-d": ["-d", aad_in, str(work / "d.wav")],
        "-d pallas": ["-d", aad_in, str(work / "dp.wav")],
        "-r": ["-r", wav_in, str(work / "r.wav")],
        "-g": ["-g", wav_in, str(work / "g.wav")],
        "-c": ["-c", wav_in],
        "-i": ["-i", aad_in],
        "-e native": ["-e", wav_in, str(work / "en.aad")],
        "-d native": ["-d", aad_in, str(work / "dn.wav")],
    }
    env = {k: v for k, v in os.environ.items() if k not in ("AAD_TPU_PLATFORM", "AAD_TPU_ENGINE", "AAD_TPU_STRICT")}
    engines = {"-d pallas": "pallas", "-e native": "native", "-d native": "native"}
    t0 = time.perf_counter()
    procs = {
        mode: subprocess.Popen([sys.executable, "-m", "aad_tpu_torch.cli", *argv], cwd=ROOT, text=True,
                               env={**env, "AAD_TPU_ENGINE": engines[mode]} if mode in engines else env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for mode, argv in runs.items()
    }
    try:
        results = {mode: (p.communicate(timeout=600), p.returncode) for mode, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    cli_s = time.perf_counter() - t0
    for mode, ((out, err), rc) in results.items():
        check(rc == 0 and err == "", f"python -m aad_tpu_torch.cli {mode}: rc {rc}, stderr {err!r}")
    check((work / "e.aad").read_bytes() == want_aad, "cli -e != encode(device='cuda')")
    check((work / "en.aad").read_bytes() == want_aad, "cli -e under AAD_TPU_ENGINE=native != encode(device='cuda')")
    for name in ("d", "dp", "r", "dn"):
        fmt, got = read_wav(str(work / f"{name}.wav"))
        check(fmt.bits_per_sample == 16 and np.array_equal(got >> 16, want_pcm), f"cli {name}.wav != decode()")
    _, gap = read_wav(str(work / "g.wav"))
    check(np.array_equal(gap, (canonical - (want_pcm.astype(np.int32) << 16)).astype(np.int32)), "cli -g residual")
    stats = io.StringIO()
    with contextlib.redirect_stdout(stats):
        check(cli.main(["-c", wav_in]) == 0, "in-process -c")
    check(results["-c"][0][0] == stats.getvalue() and stats.getvalue().startswith("RMSE:"), "cli -c statistics")
    info = results["-i"][0][0]
    check(re.search(rf"Number of Samples per Channel:\s+{n}\b", info) is not None, f"cli -i: {info!r}")
    shutil.rmtree(work)
    print(f"[cli] python -m aad_tpu_torch.cli -e/-d/-r/-g/-c/-i on a {CLI_SECONDS}-s stereo 16-bit WAV, -d "
          f"under AAD_TPU_ENGINE=pallas, -e and -d under AAD_TPU_ENGINE=native, as {len(runs)} processes at once "
          f"in {cli_s:.3f} s: -e (both) == encode(device='cuda'), -d (all three)/-r == decode(device='cuda'), "
          f"-g == the residual, -c == in-process; -c printed {results['-c'][0][0].strip()!r}")
    print("[cli] -i: " + " | ".join(" ".join(line.split()) for line in info.splitlines()))

    reset_all_launches()
    t0 = time.perf_counter()
    report = at.self_check(device=cuda)
    self_s = time.perf_counter() - t0
    counts = {k: v for k, v in all_launches().items() if v}
    check(report["device"] == torch.cuda.get_device_name(cuda) and all(c["ok"] for c in report["checks"]),
          f"self_check report {report}")
    check(len(counts) == 4, f"self_check launched {counts}")  # kernels 1, 3, 4, 5 (the probe ran once already)
    print(f"[utils] self_check(device='cuda') on {report['device']}: {len(report['checks'])} checks ok in "
          f"{self_s:.3f} s; launches {counts}")

    h = bench["header"]
    dec = at.Decoder.from_header(h, device="cuda")
    payload = torch.from_numpy(np.frombuffer(bench["data"], np.uint8)[at.FILE_HEADER_SIZE:].copy()).to(cuda)
    rep = measure_throughput(dec.decode_payload_ondevice, payload, h.num_samples * h.num_channels, DECODE_ITERS)
    print(f"[utils] measure_throughput of the device-resident fused decode: {rep}; {rep.samples_per_sec:.6e} "
          f"samples/s, {rep.seconds_per_iter * 1e3:.4f} ms a call against phase 6's {resident_ms:.4f} ms ({card})")


def all_devices_ms(fn, iters) -> float:
    """Mean host-clock ms of ``fn`` over ``iters`` calls, every card
    synchronised before and after: for work spread over several cards,
    which one card's CUDA events do not cover."""
    import torch

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def turns_ms(fns: dict, iters: int, timer) -> dict:
    """Each of two functions (name -> fn) timed by ``timer(fn, iters)`` in
    turns a b b a, after one warm-up call each; the ms a call of each turn."""
    (a, fa), (b, fb) = fns.items()
    for fn in (fa, fb):
        fn()
    times = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        times[name].append(timer(fn, iters))
    return times


def host_syncs(fn) -> tuple[int, int]:
    """(synchronising CUDA runtime calls, CUDA runtime calls) that
    torch.profiler sees inside one call of ``fn``, after a warm-up call:
    ``cuda*Synchronize`` and the synchronous ``cudaMemcpy``."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("sharded call"):
            fn()
    torch.cuda.synchronize()
    events = prof.events()
    window = next(e.time_range for e in events if e.name == "sharded call")
    runtime = [e.name for e in events if e.name.startswith("cuda")
               and window.start <= e.time_range.start <= window.end]
    syncs = [n for n in runtime if n.endswith("Synchronize") or n == "cudaMemcpy"]
    return len(syncs), len(runtime)


def sharding_phase(cuda, card, bench, main) -> dict:
    """Phase 16: ``parallel/sharded.py`` at full width on meshes of 4 and 8
    shards on one card (and of every card, where there are several): each
    sharded call against its unsharded counterpart on the card, its
    launches, the host syncs inside it and its time in turns. Returns the
    launches of the checked calls by kernel."""
    import torch
    import aad_tpu_torch as at
    from aad_tpu_torch.codec.encoder import _block_bytes, _pad_to_blocks, payload_size
    from aad_tpu_torch.ops import fused_decode as fd, fused_encode as fe, lms
    from aad_tpu_torch.ops.bitpack import pack_codes
    from aad_tpu_torch.ops.decode import decode_blocks
    from aad_tpu_torch.ops.encode import encode_blocks_parallel
    from aad_tpu_torch.parallel import sharded as ts

    meshes = {"4 shards (2, 2) on cuda:0": ts.make_mesh(4, devices=[cuda] * 4),
              "8 shards (4, 2) on cuda:0": ts.make_mesh(8, devices=[cuda] * 8)}
    check([m.devices.shape for m in meshes.values()] == [(2, 2), (4, 2)], "mesh shapes")
    cards = torch.cuda.device_count()
    if cards > 1:
        meshes[f"{cards} cards"] = ts.make_mesh()
    else:
        print("[shard] one card only: every mesh of this phase places its shards on cuda:0")
    counts = {}

    def counted(fn):
        """fn() with every launch count from 0: (its result, its launches)."""
        reset_all_launches()
        out = fn()
        for i in range(cards):
            torch.cuda.synchronize(i)
        got = {k: v for k, v in all_launches().items() if v}
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        return out, got

    def nonempty(n, mesh):
        return sum(b > a for a, b in ts._pieces(n, mesh.size))

    def on_mesh(shards, mesh):
        check([s.device for s in shards] == mesh.shard_devices, "a shard off its mesh device")

    def timer(mesh):
        return cuda_ms if set(mesh.shard_devices) == {cuda} else all_devices_ms

    def report(label, mesh_label, mesh, times, got, syncs):
        check(syncs[0] == 0, f"{label}, {mesh_label}: {syncs[0]} host syncs inside the sharded call")
        u, s = times["unsharded"], times["sharded"]
        print(f"[shard] {label}, {mesh_label}: unsharded {u[0]:.4f} / {u[1]:.4f} ms, sharded {s[0]:.4f} / "
              f"{s[1]:.4f} ms in turns ({'CUDA events' if timer(mesh) is cuda_ms else 'host clock, every card'}"
              f"), {min(s) / min(u):.2f}x; launches a call {got}; host syncs inside the call {syncs[0]} of "
              f"{syncs[1]} CUDA runtime calls ({card})")

    # (a) decode: the bench stream's 58,066 lanes x 988 codes, both engines
    h = bench["header"]
    dec = at.Decoder.from_header(h, device="cuda")
    framed = dec.frame(np.frombuffer(bench["data"], np.uint8)[at.FILE_HEADER_SIZE:].copy())
    resident = dec.decode_framed(framed)  # (C, N) int32
    B, C, T = framed.codes.shape
    L, nspb = B * C, T + 4
    lanes = (framed.codes.reshape(L, T), framed.states.step_index.reshape(L),
             framed.states.weight.reshape(L, 4), framed.states.history.reshape(L, 4))
    for engine, kernel in (("fused", fd.DECODE_KERNEL), ("pallas", lms.LMS_KERNEL)):
        unsharded = decode_blocks(*lanes, bits_per_sample=4, engine=engine)
        rows = unsharded.reshape(B, C, nspb).transpose(0, 1).reshape(C, B * nspb)[:, : h.num_samples]
        check(torch.equal(rows, resident), f"unsharded decode_blocks ({engine}) != the resident Decoder decode")
        for label, mesh in meshes.items():
            if engine == "fused" and mesh is meshes[next(iter(meshes))]:
                fd._probe_corrections.cache_clear()  # as in a new process: a card's first decode probes its table
            out, got = counted(lambda: ts.decode_blocks_sharded(*lanes, bits_per_sample=4, mesh=mesh, engine=engine))
            check(got.get(kernel) == nonempty(L, mesh), f"sharded decode ({engine}, {label}) launches {got}")
            on_mesh(out, mesh)
            check(torch.equal(ts.gather(out, cuda), unsharded), f"sharded decode ({engine}, {label}) != unsharded")
            del out
            print(f"[shard] decode_blocks_sharded engine={engine}, {L} lanes x {T} codes, {label}: == unsharded "
                  f"decode_blocks on the card == the resident Decoder decode, bit-exact; launches {got}")
            fn = functools.partial(ts.decode_blocks_sharded, *lanes, bits_per_sample=4, mesh=mesh, engine=engine)
            times = turns_ms({"unsharded": functools.partial(decode_blocks, *lanes, bits_per_sample=4, engine=engine),
                              "sharded": fn}, DECODE_ITERS if engine == "fused" else 2, timer(mesh))
            report(f"decode ({engine})", label, mesh, times, got, host_syncs(fn))
    del unsharded, rows, resident, framed, dec, lanes

    # (b) stream encode: phase 13's timed pile, 2,048 stereo streams of 2 s
    cfg, pcm = main["cfg"], main["pcm"]
    geo = cfg.geometry()
    nspb = geo.num_samples_per_block
    n = PILE_TIME_SECONDS * RATE
    two = pile_streams(pcm, [n] * max(PILE_SIZES), SEED + 20)
    S, nb = len(two), -(-n // nspb)
    pile = torch.from_numpy(pile_blocks(two, nspb)).to(cuda).transpose(0, 1)  # (S, B, C, nspb) int16
    valid = torch.clamp(n - torch.arange(nb, device=cuda) * nspb, 0, nspb).to(torch.int32).expand(S, nb)
    bps, trials = cfg.bits_per_sample, cfg.num_encode_trials
    uh, uc, _ = fe.encode_stream(pile.transpose(0, 1), valid.t()[..., None], bps, trials, need_carry=False)
    uh = type(uh)(*(f.transpose(0, 1) for f in uh))
    uc = uc.transpose(0, 1)  # (S, B, C, T)
    # the statistic's reference: integer squared errors summed exactly on the card, the RMSE in float64 on the host
    recon = decode_blocks(uc, uh.step_index, uh.weight, uh.history, bits_per_sample=bps)
    live = (torch.arange(nspb, device=cuda) < valid[..., None, None]).expand(recon.shape)
    sse = int(torch.where(live, (recon - pile).to(torch.int64) ** 2, 0).sum())
    want_rmse = float(np.sqrt(sse / 32768.0**2 / int(live.sum())))
    del live
    for label, mesh in meshes.items():
        for stat in (False, True):
            (hs, codes, rmse), got = counted(lambda: ts.encode_streams_sharded(
                pile, valid, bits_per_sample=bps, num_trials=trials, mesh=mesh, stat=stat))
            shards = nonempty(S, mesh)
            want = {fe.STREAM_KERNEL: shards, **({fd.DECODE_KERNEL: shards} if stat else {})}
            check(got == want, f"sharded stream encode ({label}, stat={stat}) launches {got}")
            on_mesh(codes, mesh)
            check(torch.equal(ts.gather(codes, cuda), uc), f"sharded stream encode ({label}) codes != unsharded")
            check(all(torch.equal(a, b) for a, b in zip(ts.gather(hs, cuda), uh)),
                  f"sharded stream encode ({label}) headers != unsharded")
            line = f"[shard] encode_streams_sharded stat={stat}, {S} stereo streams x {nb} blocks, {label}: " \
                   f"== the unsharded kernel-3 call on {2 * S} lanes, bit-exact"
            if stat:
                rel = abs(float(rmse) - want_rmse) / want_rmse
                check(rmse.device == mesh.shard_devices[0] and rel < 1e-5, f"stat {float(rmse)} != {want_rmse}")
                line += f"; RMSE {float(rmse):.9f} against the float64 host RMSE {want_rmse:.9f} (relative {rel:.2e})"
                # the round trip: the sharded decode of the codes, lanes S * B * C
                flat = ts.gather(codes, cuda).reshape(-1, nspb - 4)
                hdr = ts.gather(hs, cuda)
                out = ts.decode_blocks_sharded(flat, hdr.step_index.reshape(-1), hdr.weight.reshape(-1, 4),
                                               hdr.history.reshape(-1, 4), bits_per_sample=bps, mesh=mesh)
                check(torch.equal(ts.gather(out, cuda).reshape(recon.shape), recon),
                      f"round trip ({label}): the sharded decode of the codes != the unsharded decode")
                line += f"; round trip: the sharded decode of its {flat.shape[0]} lanes == unsharded"
                del flat, hdr, out
            print(line + f"; launches {got}")
            fn = functools.partial(ts.encode_streams_sharded, pile, valid, bits_per_sample=bps, num_trials=trials,
                                   mesh=mesh, stat=stat)
            unsharded_fn = functools.partial(fe.encode_stream, pile.transpose(0, 1), valid.t()[..., None], bps,
                                             trials, need_carry=False)
            times = turns_ms({"unsharded": unsharded_fn, "sharded": fn}, 1, timer(mesh))
            report(f"stream encode (stat={stat})", label, mesh, times, got, host_syncs(fn))
            del hs, codes, rmse
    del pile, valid, uh, uc, recon

    # (c) sequence-parallel encode: the 10-minute signal, one stream
    N = pcm.shape[1]
    blocks, valid = _pad_to_blocks(torch.from_numpy(pcm).to(cuda), geo, 0, -(-N // nspb))
    nblocks = blocks.shape[0]
    want_bytes = {(1, 0): main["par"],
                  (4, 1): at.encode(pcm, cfg, device="cuda", parallel_blocks=True, parallel_chunk_blocks=4,
                                    parallel_warm_passes=1)}
    for (c, wp), whole in want_bytes.items():
        kw = dict(chunk_blocks=c, warm_passes=wp)
        uh, uc = encode_blocks_parallel(blocks, valid, bps, trials, stream=fe.encode_stream, **kw)
        for label, mesh in meshes.items():
            (hs, codes), got = counted(lambda: ts.encode_blocks_parallel_sharded(
                blocks, valid, bits_per_sample=bps, num_trials=trials, mesh=mesh, **kw))
            check(got == {fe.STREAM_KERNEL: (wp + 1) * nonempty(-(-nblocks // c), mesh)},
                  f"sequence-parallel encode ({label}, {kw}) launches {got}")
            on_mesh(codes, mesh)
            gh, gc = ts.gather(hs, cuda), ts.gather(codes, cuda)
            check(torch.equal(gc, uc) and all(torch.equal(a, b) for a, b in zip(gh, uh)),
                  f"sequence-parallel encode ({label}, {kw}) != unsharded encode_blocks_parallel")
            # its codes one a byte, the codes-level contract, packed here to assemble the stream
            payload = _block_bytes(gh, pack_codes(gc, geo), geo).reshape(-1)[: payload_size(geo, N)]
            payload = payload.cpu().numpy().tobytes()
            check(whole == at.encode_header(cfg.header_for(N)) + payload,
                  f"sequence-parallel encode ({label}, {kw}) bytes != encode(parallel_blocks=True)")
            print(f"[shard] encode_blocks_parallel_sharded chunks of {c}, {wp} warm passes, {nblocks} blocks, "
                  f"{label}: == unsharded encode_blocks_parallel on the card, bit-exact; assembled, == encode("
                  f"device='cuda', parallel_blocks=True, parallel_chunk_blocks={c}, parallel_warm_passes={wp}) "
                  f"({len(whole)} bytes); launches {got}")
            fn = functools.partial(ts.encode_blocks_parallel_sharded, blocks, valid, bits_per_sample=bps,
                                   num_trials=trials, mesh=mesh, **kw)
            unsharded_fn = functools.partial(encode_blocks_parallel, blocks, valid, bps, trials,
                                             stream=fe.encode_stream, **kw)
            times = turns_ms({"unsharded": unsharded_fn, "sharded": fn}, ENCODE_ITERS, timer(mesh))
            report(f"sequence-parallel encode (chunks of {c}, {wp} warm passes)", label, mesh, times, got,
                   host_syncs(fn))
            del hs, codes, gh, gc
    return counts


# Phase 17: the decode probes. Each record's name, its TPU kernel and where to
# find its step loop in the SASS: (marker opcode, samples a marker, opcodes
# the loop must not hold) for each loop on a sample's path.
PROBE_WORD_LOOP = (("LDG", 8, ()),)  # one 32-bit word of 8 codes loaded a lane a pass
PROBE_PHASE_A = {
    "full": ("phase_a_kernelILi0E", ":246", PROBE_WORD_LOOP),
    "lms_only": ("phase_a_kernelILi1E", ":246", PROBE_WORD_LOOP),
    "qdiff_only": ("phase_a_kernelILi2E", ":246", PROBE_WORD_LOOP),
    # the qdiff loop (words in, qdiffs to shared memory), then the LMS loop (one qdiff out of it a sample)
    "two_loop": ("phase_a_kernelILi3E", ":246", (("LDG", 8, ()), ("LDS", 1, ("LDG",)))),
    "pipelined": ("phase_a_kernelILi4E", ":246", PROBE_WORD_LOOP),
}
PROBE_LAYOUT_LINE = {"natural": ":88", "lane_major": ":134", "tile_major": ":224"}
PROBE_ODD = {"phase_a": ((13, 1000, 64), (40, 333, 128), (37, 96, 32)), "layout": ((1000, 13), (4159, 3), (70, 9))}


def probe_per_sample(lib, symbol: str, loops) -> dict:
    """Instructions a sample by pipe on a probe kernel's path: each loop's
    count over the samples one pass of it takes, summed over the loops;
    with ``branches``, the data-dependent branch regions (``BSSY``) in them."""
    total = dict.fromkeys(PIPE_RATE, 0.0)
    insns, samples, branches = 0, 0, 0
    for marker, per, without in loops:
        loop = sass_loop(symbol, marker, without, lib=lib)
        ops = [op.split(".")[0] for _, op, _ in loop]
        n = per * ops.count(marker)
        counts = pipe_counts([op for _, op, _ in loop], n)
        for p in PIPE_RATE:
            total[p] += counts[p]
        insns, samples, branches = insns + counts["insns"], samples + n, branches + ops.count("BSSY")
    return {**total, "insns": insns, "samples": samples, "branches": branches}


def probes_phase(cuda, card, build_future, main_launches) -> list[dict]:
    """Phase 17: the decode probes (``aad_tpu_torch.probes``, kernels 6-8).
    Each kernel and every built variant against its plain version, bit for
    bit, at the probes' full sizes (the plain versions on the card) and at
    odd sizes (on the host); then the three ``main()``s, which print their
    times beside their bounds and the card; each record's bound from the
    bytes and the compiled loop by pipe. Returns the kernels' records."""
    import torch
    from aad_tpu_torch import probes
    from aad_tpu_torch.probes import decode_layout as dl, phase_a_decode as pa, transpose as tp

    t0 = time.perf_counter()
    lib, build_s = build_future.result()
    probes.library()
    print(f"[probes] {lib.relative_to(ROOT)} built in {build_s:.3f} s (beside phase 2's build)")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print(f"[probes] ptxas: {line.split('ptxas info    : ')[-1]}")

    def timed_plain(fn):
        """The plain version's result, and its time: one call after that one."""
        return fn(), cuda_ms(fn, 1, warmup=0)

    errors, plain_ms = {}, {}
    # kernel 6: the probe's (512, 64, 8, 128) on the card; the 4-byte path on the host
    x = torch.from_numpy(np.random.default_rng(SEED).integers(-(2**31), 2**31, tp.SHAPE, dtype=np.int64)
                         .astype(np.int32)).to(cuda)
    want, plain_ms[tp.KERNEL] = timed_plain(lambda: tp.transpose_reference(x))
    errors[tp.KERNEL] = max_err(tp.transpose(x), want)
    for shape, off in (((37, 3, 5, 11), 0), ((68, 64), 1)):
        flat = torch.from_numpy(np.random.default_rng(off).integers(-9, 9, int(np.prod(shape)) + off, dtype=np.int32))
        odd = flat.to(cuda)[off:].view(shape)
        errors[tp.KERNEL] = max(errors[tp.KERNEL], max_err(tp.transpose(odd), tp.transpose_reference(flat[off:].view(shape))))
    del x, want
    print(f"[probes] {tp.KERNEL} {tp.SHAPE} and {{(37, 3, 5, 11), (68, 64) 4 bytes off}}: max |err| {errors[tp.KERNEL]}")

    # kernel 7: the probe's 28,672 lanes x 256 words, each form on the card against its plain version on the card
    words = probes.on_device(pa.probe_words(), cuda)
    plain_of = {}
    for v in pa.VARIANTS:
        key = "full" if v in pa.SAME_AS_FULL else v  # the same function: one plain run
        if key not in plain_of:
            plain_of[key] = timed_plain(lambda: pa.decode_reference(words, key))
        name = f"{pa.KERNEL}[{v}]"
        errors[name], plain_ms[name] = max_err(pa.decode(words, v), plain_of[key][0]), plain_of[key][1]
        for W, L, lanes in PROBE_ODD["phase_a"]:
            w = np.random.default_rng(W * L).integers(0, 2**32, (W, L), dtype=np.uint32)
            errors[name] = max(errors[name], max_err(pa.decode(w, v, cta_lanes=lanes), pa.decode(w, v, device="cpu")))
        print(f"[probes] {name} {tuple(words.shape)} (plain on the card {plain_ms[name]:.1f} ms) and "
              f"{PROBE_ODD['phase_a']} (W, L, CTA lanes): max |err| {errors[name]}")
    del words, plain_of

    # kernel 8: the probe's 65,536 lanes x 128 words, each instance on the card against its plain version on the card
    args = [probes.on_device(a, cuda) for a in dl.probe_inputs()]
    plain_of = {}
    for lay, r, mode in dl.INSTANCES:
        if (lay, mode) not in plain_of:
            plain_of[lay, mode] = timed_plain(lambda: dl.decode_reference(*args, layout=lay, mode=mode))
        name = dl.instance(lay, r, mode)
        errors[name], plain_ms[name] = max_err(dl.decode(*args, layout=lay, r=r, mode=mode), plain_of[lay, mode][0]), \
            plain_of[lay, mode][1]
        for L, W in PROBE_ODD["layout"]:
            rng = np.random.default_rng(L + W)
            a = (rng.integers(0, 2**32, (W, L), dtype=np.uint32), rng.integers(0, 4081, L).astype(np.int32),
                 rng.integers(-30000, 30000, (4, L)).astype(np.int32), rng.integers(-20000, 20000, (4, L)).astype(np.int32))
            errors[name] = max(errors[name], max_err(dl.decode(*a, layout=lay, r=r, mode=mode),
                                                     dl.decode(*a, layout=lay, r=r, mode=mode, device="cpu")))
        print(f"[probes] {name} (8W, L) = ({8 * args[0].shape[0]}, {args[0].shape[1]}) (plain on the card "
              f"{plain_ms[name]:.1f} ms) and {PROBE_ODD['layout']} (L, W): max |err| {errors[name]}")
    del args, plain_of
    for name, err in errors.items():
        check(err == 0, f"{name} != its plain version: max |err| {err}")
    torch.cuda.synchronize()
    print(f"[probes] every kernel and variant equal to its plain version, bit for bit, in "
          f"{time.perf_counter() - t0:.1f} s ({card})")

    # the three main()s: their lines, and the times of the records
    t1 = time.perf_counter()
    tr = tp.main()
    pa_runs = {rec["variant"]: rec for rec in pa.main() if rec["cta_lanes"] == probes.CTA_LANES}
    dl_runs = {rec["instance"]: rec for rec in dl.main()}
    print(f"[probes] the three main()s in {time.perf_counter() - t1:.1f} s")

    def record(name, source, replaces, ms, bound_, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"aad_tpu_torch/probes/csrc/{source}", "replaces": replaces,
                "launches": main_launches.get(name, 0), "max_abs_err": errors[name], "ms": ms,
                "plain_ms": plain_ms[name], "bound_ms": bound_[0], "bound_by": bound_[1], "library_ms": library_ms}

    records = [record(tp.KERNEL, "transpose.cu", "benchmarks/probe_transpose.py:84", tr["ms"],
                      bound(tp.moved_bytes(int(np.prod(tp.SHAPE))), 0), tr["library_ms"])]
    W, L = pa.WORDS, pa.LANES
    for v, (symbol, line, loops) in PROBE_PHASE_A.items():
        per = probe_per_sample(lib, symbol, loops)
        b, pipe = loop_bound(pa.moved_bytes(W, L), 8 * W * L, per)
        print(f"[sass] {pa.KERNEL}[{v}]: {sass_line(per, pipe)}; {per['branches']} branch regions; bound {b[0]:.4f} ms ({b[1]}), the bytes "
              f"{pa.bound_ms(W, L):.4f}; the kernel {pa_runs[v]['ms']:.4f} ms, {b[0] / pa_runs[v]['ms']:.1%} of it ({card})")
        records.append(record(f"{pa.KERNEL}[{v}]", "phase_a_decode.cu", f"benchmarks/probe_phase_a_decode.py{line}",
                              pa_runs[v]["ms"], b))
    W, L = dl.WORDS, dl.TILES * 1024
    full_ms = dl_runs[dl.instance("natural", 1, "full")]["ms"]
    for lay, r, mode in dl.INSTANCES:
        name = dl.instance(lay, r, mode)
        line = PROBE_LAYOUT_LINE[lay] if (r, mode) == (1, "full") else ":345" if mode == "full" else ":317"
        per = probe_per_sample(lib, f"layout_kernelILi{dl.LAYOUTS.index(lay)}ELi{r}ELi{dl.MODES.index(mode)}E",
                               PROBE_WORD_LOOP)
        b, pipe = loop_bound(dl.moved_bytes(W, L), 8 * W * L, per)
        ms = dl_runs[name]["ms"]
        print(f"[sass] {name}: {sass_line(per, pipe)}; {per['branches']} branch regions; bound {b[0]:.4f} ms ({b[1]}), the bytes "
              f"{dl.bound_ms(W, L):.4f}; the kernel {ms:.4f} ms, {b[0] / ms:.1%} of it"
              + (f"; saves {(full_ms - ms) / full_ms:.1%} of full" if mode != "full" else "") + f" ({card})")
        records.append(record(name, "decode_layout.cu", f"benchmarks/probe_decode_layout.py{line}", ms, b))
    return records


def live_push_before_after(cuda, card, cfg) -> None:
    """A 10-block push of the live cell, before the wire mode (kernel 3's
    other mode, the host's padding, mid/side, relayouts and header bytes
    around it, as ``StreamingEncoder`` pushed until then) and after
    (``StreamingEncoder``: kernel 3's wire mode): the same bytes; the
    device operations a push and kernels 3 and 4's device time under the
    profiler, and a push's time by the host's clock without it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    import aad_tpu_torch as at
    from aad_tpu_torch.ops import fused_encode as fe
    from aad_tpu_torch.ops.encode import lr_to_ms

    geo = cfg.geometry()
    pushes = 400
    feed = bench_pcm(LIVE_PUSH * pushes, seed=SEED + 13)

    class Before:  # the push as it was: one launch of kernel 3's other mode, the carry by kernel 4
        def __init__(self):
            self.carry, self.done = None, 0

        def push(self, x):
            with torch.no_grad():
                pcm = torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
                blocks, valid = fe._pad_to_blocks(pcm, geo, 0, x.shape[1] // geo.num_samples_per_block)
                headers, data, self.carry = fe.encode_stream(
                    lr_to_ms(blocks).to(torch.int16), valid, 4, 2, carry=self.carry, blocks_before=self.done,
                    pack=geo)
                self.done += blocks.shape[0]
                return fe._block_bytes(headers, data, geo).reshape(-1).cpu().numpy().tobytes()

    def run(enc, lo, hi):
        return [enc.push(feed[:, k * LIVE_PUSH: (k + 1) * LIVE_PUSH]) for k in range(lo, hi)]

    def on_card(prof):
        return [e for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA and not e.name().startswith("aad.")]

    out = {}
    for label, enc in (("before", Before()), ("after", at.StreamingEncoder(cfg, device=cuda))):
        got = run(enc, 0, 8)  # warm
        torch.cuda.synchronize()
        times = []
        for k in range(8, pushes - 50):
            t0 = time.perf_counter()
            got += run(enc, k, k + 1)
            times.append(time.perf_counter() - t0)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            got += run(enc, pushes - 50, pushes)
            torch.cuda.synchronize()
        ops = on_card(prof)
        k3 = sum(e.duration_ns() for e in ops if "encode_stream" in e.name()) / 50 / 1e3
        k4 = sum(e.duration_ns() for e in ops if "encode_pass" in e.name()) / 50 / 1e3
        out[label] = (got, len(ops) / 50, k3, k4, float(np.median(times)) * 1e3)
    check(out["before"][0] == out["after"][0], "live sender: the wire mode's bytes != kernel 3's other mode's")
    (_, ob, k3b, k4b, tb), (_, oa, k3a, k4a, ta) = out["before"], out["after"]
    print(f"[live] a 10-block push, before / after the wire mode ({pushes} pushes, bit-exact): device operations a "
          f"push {ob:.3f} / {oa:.3f}; kernel 3 {k3b:.1f} / {k3a:.1f} us, kernel 4 {k4b:.1f} / {k4a:.1f} us a push "
          f"under the profiler; a push {tb:.4f} / {ta:.4f} ms median by the host's clock without it ({card})")


def live_encode_phase(cuda, card) -> None:
    """Phase 18: a live stereo sender. ``StreamingEncoder`` at the live
    cell's configuration, 960-sample pushes of three feeds in turn, each
    finished after its last push, against ``device="cpu"`` bit for bit; a
    10-block push before and after the wire mode
    (:func:`live_push_before_after`); then one feed of LIVE_SECONDS on the
    card, each push timed by the host's clock, with the launches of kernels
    3 and 4 a push."""
    import aad_tpu_torch as at
    from aad_tpu_torch.ops import encode_pass as ep, fused_encode as fe

    cfg = at.EncodeConfig(2, RATE, 4, 128, 1, 2)
    feeds = [bench_pcm(n, seed=SEED + 7 + k) for k, n in enumerate(LIVE_FEEDS)]

    def in_turns(device):
        encs = [at.StreamingEncoder(cfg, device=device) for _ in feeds]
        outs = [[] for _ in encs]
        for off in range(0, max(LIVE_FEEDS), LIVE_PUSH):
            for k, f in enumerate(feeds):
                if off < f.shape[1]:
                    outs[k].append(encs[k].push(f[:, off: off + LIVE_PUSH]))
                    if off + LIVE_PUSH >= f.shape[1]:
                        outs[k].append(encs[k].finish())
        return [e.header() + b"".join(o) for e, o in zip(encs, outs)]

    got = in_turns(cuda)
    check(got == in_turns("cpu"), "live sender: StreamingEncoder on the card != device='cpu'")
    print(f"[live] aad-b4-s128-ms-stereo, 960-sample pushes of feeds of {LIVE_FEEDS} samples/ch in turn, each "
          f"finished after its last push: cuda == cpu, bit-exact")
    live_push_before_after(cuda, card, cfg)
    feed = bench_pcm(RATE * LIVE_SECONDS, seed=SEED + 11)
    enc = at.StreamingEncoder(cfg, device=cuda)
    times, parts = [], []
    k3, k4 = fe.launches[fe.STREAM_KERNEL], ep.launches[ep.PASS_KERNEL]
    for off in range(0, feed.shape[1], LIVE_PUSH):
        t0 = time.perf_counter()
        parts.append(enc.push(feed[:, off: off + LIVE_PUSH]))
        times.append(time.perf_counter() - t0)
    parts.append(enc.finish())
    pushes = len(times)
    k3, k4 = fe.launches[fe.STREAM_KERNEL] - k3, ep.launches[ep.PASS_KERNEL] - k4
    # the feed is whole pushes: the finish encodes nothing
    check((k3, k4) == (pushes, pushes),
          f"live sender: {k3} launches of kernel 3 and {k4} of kernel 4 over {pushes} whole pushes")
    geo = cfg.geometry()
    check(len(b"".join(parts)) == feed.shape[1] // geo.num_samples_per_block * geo.block_size,
          "live sender: not every block came back")
    q = np.quantile(np.array(times[1:]) * 1e3, [0.5, 0.95])
    print(f"[live] one {LIVE_SECONDS}-s feed on the card, {pushes} pushes of 960 samples/ch (10 blocks): a push "
          f"{q[0]:.4f} ms median, {q[1]:.4f} ms p95 by the host's clock (the first left out); launches a push: "
          f"kernel 3 {k3 / pushes:.3f}, kernel 4 {k4 / pushes:.3f} ({card})")


def bridge_ticks(seed: int, ticks: int, joins: int = 50, samples=(16000, 256000)):
    """The bridge's ticks: (pcm (S, 1, BRIDGE_PUSH), lengths, finish) each.
    Slot s's feed is a clip of ``samples`` samples (log-uniform; by default
    1-16 s; noise under a tone, cut from one long buffer at the slot's own
    offset), joining at a tick in [0, ``joins``); its last push is shorter
    and finishes it, and the slot starts the clip again."""
    rng = np.random.default_rng(seed)
    S = BRIDGE_SLOTS
    lo, hi = samples
    lengths = np.exp(rng.uniform(np.log(lo), np.log(hi), S)).astype(np.int64)
    t = np.arange(2 * hi + BRIDGE_PUSH)
    base = np.clip(9000 * np.sin(2 * np.pi * t / 173) + rng.normal(0, 1000, t.size), -32768, 32767).astype(np.int16)
    start = rng.integers(0, hi, S)
    join = rng.integers(0, joins, S)
    pos = np.zeros(S, dtype=np.int64)
    for k in range(ticks):
        on = join <= k
        n = np.where(on, np.minimum(BRIDGE_PUSH, lengths - pos), 0)
        idx = (start + pos)[:, None] + np.arange(BRIDGE_PUSH)
        pcm = np.where(np.arange(BRIDGE_PUSH) < n[:, None], base[idx], 0).astype(np.int16)[:, None, :]
        finish = on & (pos + n == lengths)
        pos = np.where(finish, 0, pos + n)
        yield pcm, n, finish


def bridge_encode_phase(cuda, card) -> None:
    """Phase 19: a conference bridge (see the top)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    import aad_tpu_torch as at
    from aad_tpu_torch.ops import encode_pass as ep, fused_encode as fe

    cfg = at.EncodeConfig(1, 16000, 4, 128, 0, 2)
    S = BRIDGE_SLOTS

    def bank_run(device, ticks, written=False):
        """Each tick's bytes, offsets and finished feeds' headers; ``written``:
        each tick's samples written into the bank's buffer, as the benchmark's
        bridge does."""
        bank = at.StreamingEncoderBank(cfg, S, device=device)
        out = []
        for pcm, n, finish in ticks:
            if written:
                given, pcm = pcm, bank.buffer(pcm.shape[2])
                pcm[...] = given
            out.append((*(a.tobytes() for a in bank.push(pcm, n, finish)),
                        [bank.header(s) for s in np.flatnonzero(finish)]))
        return out

    # every slot on from the second tick, feeds of 200-32,000 samples: every
    # tick 1,024 feeds wide, most carried, about a fifth finished and restarted
    wide = list(bridge_ticks(SEED + 29, BRIDGE_WIDE_TICKS, joins=2, samples=(200, 32000)))
    got = bank_run(cuda, wide, written=True)
    width = [int(((n > 0) | f).sum()) for _, n, f in wide]
    ends = [int(f.sum()) for _, _, f in wide]
    check(got == bank_run("cpu", wide), "bridge: full-width ticks on the card != device='cpu'")
    print(f"[bridge] {BRIDGE_WIDE_TICKS} full-width ticks cuda == cpu, bit-exact: {min(width[1:])}-{max(width)} feeds "
          f"a tick after the first, {min(ends[1:])}-{max(ends)} finished a tick")
    first = list(bridge_ticks(SEED + 19, 60))
    got = bank_run(cuda, first)
    check(got[:6] == bank_run("cpu", first[:6]), "bridge: the bank on the card != device='cpu'")
    encs = [at.StreamingEncoder(cfg, device=cuda) for _ in range(S)]
    for (data, offsets, heads), (pcm, n, finish) in zip(got, first):
        offsets = np.frombuffer(offsets, dtype=np.int64)
        want, want_heads = [], []
        for s in range(S):
            part = encs[s].push(pcm[s, :, : n[s]]) if n[s] else b""
            if finish[s]:
                part += encs[s].finish()
                want_heads.append(encs[s].header())
                encs[s] = at.StreamingEncoder(cfg, device=cuda)
            want.append(part)
        check([data[offsets[s]: offsets[s + 1]] for s in range(S)] == want and heads == want_heads,
              "bridge: a slot's bytes != its StreamingEncoder's")
    print(f"[bridge] aad-b4-s128-mono, {S} slots, 320-sample ticks: 6 ticks cuda == cpu, 60 ticks of every feed == "
          f"a StreamingEncoder a slot on the card, bit-exact")

    ticks = list(bridge_ticks(SEED + 23, 60 + BRIDGE_TICKS + 50))
    bank = at.StreamingEncoderBank(cfg, S, device=cuda)
    for t in ticks[:60]:  # every slot joined
        bank.push(*t)
    torch.cuda.synchronize()
    k3, k4 = fe.launches[fe.STREAM_KERNEL], ep.launches[ep.PASS_KERNEL]
    times = []
    for t in ticks[60: 60 + BRIDGE_TICKS]:
        t0 = time.perf_counter()
        bank.push(*t)
        times.append(time.perf_counter() - t0)
    k3, k4 = fe.launches[fe.STREAM_KERNEL] - k3, ep.launches[ep.PASS_KERNEL] - k4
    check((k3, k4) == (BRIDGE_TICKS, BRIDGE_TICKS), f"bridge: {k3} and {k4} launches over {BRIDGE_TICKS} ticks")
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in ticks[60 + BRIDGE_TICKS:]:
            bank.push(*t)
        torch.cuda.synchronize()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and not e.name().startswith("aad.")]
    us = {k: sum(e.duration_ns() for e in ops if k in e.name()) / 50 / 1e3
          for k in ("encode_stream_paired_kernel", "bank_encode_pass_kernel", "Memcpy HtoD", "Memcpy DtoH")}
    q = np.quantile(np.array(times) * 1e3, [0.5, 0.95])
    samples = sum(int(t[1].sum()) for t in ticks[60: 60 + BRIDGE_TICKS])
    print(f"[bridge] {BRIDGE_TICKS} ticks of {S} feeds on the card: a tick {q[0]:.4f} ms median, {q[1]:.4f} ms p95 by "
          f"the host's clock, {samples / sum(times):.4e} samples/s; launches a tick: kernel 3 {k3 / BRIDGE_TICKS:.3f}, "
          f"kernel 4 {k4 / BRIDGE_TICKS:.3f}; under the profiler {len(ops) / 50:.3f} device operations a tick, "
          + ", ".join(f"{k} {v:.1f} us" for k, v in us.items()) + f" a tick ({card})")
    encs = [at.StreamingEncoder(cfg, device=cuda) for _ in range(S)]
    one = []
    for pcm, n, finish in ticks[:63]:
        t0 = time.perf_counter()
        for s in range(S):
            if n[s]:
                encs[s].push(pcm[s, :, : n[s]])
            if finish[s]:
                encs[s].finish()
                encs[s] = at.StreamingEncoder(cfg, device=cuda)
        one.append(time.perf_counter() - t0)
    print(f"[bridge] the same ticks as {S} StreamingEncoder pushes each, every slot joined: "
          f"{np.median(one[60:]) * 1e3:.2f} ms a tick median of 3, against the bank's {q[0]:.4f} ({card})")


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import aad_tpu_torch as at
    from aad_tpu_torch import probes
    from aad_tpu_torch.ops import _build, fused_decode as fd
    from aad_tpu_torch.tables import STEPSIZE_TABLE

    cuda = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(cuda)
    card = smi()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True, check=True)
    print(f"[device] {name} | nvidia-smi: {card}")
    print(f"[toolchain] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {nvcc.stdout.strip().splitlines()[-1]} | "
          f"triton {'present' if importlib.util.find_spec('triton') else 'absent'}")

    # 2. build: the kernels (one nvcc a source) and, beside them, the native host engine (the host compiler)
    # and the probes' kernels (phase 17 reports their build)
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(2)
    if sys.argv[1:] not in (["--sharding"], ["--live-encode"], ["--bridge-encode"]):
        probes_build = pool.submit(lambda: (probes.build(), time.perf_counter() - t0))
    native_build = pool.submit(at.native.build)
    lib_path = _build.build()
    kernels_s = time.perf_counter() - t0
    native_path = native_build.result()
    pool.shutdown(wait=False)
    _build.library()
    at.native.library()
    print(f"[build] {lib_path.relative_to(_build.BUILD_DIR.parents[1])} in {kernels_s:.3f} s; "
          f"{native_path.relative_to(_build.BUILD_DIR.parents[1])} beside it, both in {time.perf_counter() - t0:.3f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print(f"[build] ptxas: {line.split('ptxas info    : ')[-1]}")

    if sys.argv[1:] == ["--sharding"]:
        # phase 16 alone, for a host with several cards: its inputs as phases 5 and 8 make them
        cfg = at.EncodeConfig(2, RATE, 4, 1024, 0, 2)
        pcm = bench_pcm(RATE * SECONDS)
        data, header = bench_stream(RATE * SECONDS)
        encoded = dict(cfg=cfg, pcm=pcm, par=at.encode(pcm, cfg, device="cuda", parallel_blocks=True))
        every = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, check=True).stdout.strip().replace("\n", "; ")
        print(f"[shard] {torch.cuda.device_count()} cards: {every}")
        print(json.dumps({"sharding_launches": sharding_phase(cuda, card, dict(data=data, header=header), encoded)}))
        stamp("16 sharding")
        return 0
    if sys.argv[1:] == ["--live-encode"]:
        live_encode_phase(cuda, card)
        stamp("18 live sender")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--bridge-encode"]:
        bridge_encode_phase(cuda, card)
        stamp("19 bridge")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--probes"]:
        # phase 17 alone; nothing of a main path has run, so no probe launched on one
        records = probes_phase(cuda, card, probes_build, probe_launches())
        stamp("17 probes")
        print(json.dumps({"kernels": records}))
        print(smi())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0
    # 3. probe
    probe = fd.stepsize_probe(cuda)
    torch.cuda.synchronize()
    probe_plain = fd.stepsize_probe_reference("cpu")
    check(torch.equal(probe.cpu(), torch.from_numpy(STEPSIZE_TABLE)), "probe != STEPSIZE_TABLE")
    check(fd.stepsize_corrections(cuda) == (), "non-empty correction set")
    probe_err = int((probe.cpu() - probe_plain).abs().max())
    print(f"[probe] 256 slots equal STEPSIZE_TABLE; corrections ()")
    # the launch floor: a one-element op on the same stream, the least a launch takes
    one = torch.zeros(1, dtype=torch.int32, device=cuda)
    floor_ms = cuda_ms(lambda: one.add_(1), FLOOR_ITERS, warmup=20)
    print(f"[probe] launch floor: a one-element add_ on the card {floor_ms:.6f} ms a launch, CUDA events over "
          f"{FLOOR_ITERS} launches ({card})")

    stamp("1-3 device, build, probe")
    # 4. each kernel against its plain version, bit for bit
    rng = np.random.default_rng(SEED)
    decode_err = 0
    for bps in (2, 3, 4):
        for C in (1, 2):
            for block, B, skew in ROW_CASES:
                geo = at.compute_block_geometry(block or 1024, C, bps)
                if not block:
                    geo = at.compute_block_geometry(geo.header_bytes + 3 * geo.unit_bytes, C, bps)
                T = geo.codes_per_block
                # random headers: every wire step index (4081-4095 malformed) and weight shift
                raw = torch.from_numpy(rng.integers(0, 256, B * geo.block_size + skew, dtype=np.uint8))
                rows = raw.to(cuda)[skew:].view(B, geo.block_size)
                check(rows.data_ptr() % 4 == skew, "rows off their boundary")
                for ms in (False, True) if C == 2 else (False,):
                    want = fd.decode_rows_reference(raw[skew:].view(B, geo.block_size), geo, ms)
                    got = fd.decode_rows(rows, geo, ms)
                    torch.cuda.synchronize()
                    err = max_err(got, want)
                    what = (f"bps={bps} C={C}{' mid/side' if ms else ''} blocks of {geo.block_size} bytes, T={T}, "
                            f"B={B}, {skew} bytes off")
                    check(err == 0, f"kernel != plain on block rows at {what}: max |err| {err}")
                    decode_err = max(decode_err, err)
                    print(f"[kernel-vs-plain] aad_decode_lanes on block rows, {what} a 4-byte boundary, headers "
                          f"parsed in the kernel, {B * C} lanes, rows of {T + 4}: bit-exact")
        for B, C, T in EDGE_SHAPES:
            args = lane_inputs(rng, B * C, T, bps)
            want = fd.decode_lanes_reference(*args, bps)
            got = fd.decode_lanes(*(a.to(cuda) for a in args), bps)
            torch.cuda.synchronize()
            err = max_err(got, want)
            check(err == 0, f"kernel != plain on codes one a byte at bps={bps} L={B * C} T={T}: max |err| {err}")
            decode_err = max(decode_err, err)
            print(f"[kernel-vs-plain] aad_decode_lanes on codes one a byte, bps={bps}, (L, T) = ({B * C}, {T}), "
                  f"rows of {T + 4}: bit-exact")

    stamp("4 decode kernel checks")
    # 5. main path at full size
    num_samples = RATE * SECONDS
    data, header = bench_stream(num_samples)
    reset_probe_launches()  # counted from here to phase 17: every main path
    fd.reset_launches()
    t0 = time.perf_counter()
    h, pcm = at.decode(data, device="cuda")
    main_s = time.perf_counter() - t0
    launches = dict(fd.launches)
    for kernel, count in launches.items():
        check(count > 0, f"the main path never launched {kernel}")
    geo = at.geometry_from_header(h.num_channels, h.bits_per_sample, h.block_size)
    nspb = geo.num_samples_per_block
    nblocks = -(-num_samples // nspb)
    check(pcm.shape == (2, num_samples) and pcm.dtype == np.int32, f"pcm {pcm.shape} {pcm.dtype}")
    check(pcm.min() >= -32768 and pcm.max() <= 32767, "samples outside the int16 range")
    # every block starts with its header's history, newest last
    from aad_tpu_torch.format.framing import frame_stream

    framed = frame_stream(np.frombuffer(data, np.uint8)[at.FILE_HEADER_SIZE:].copy(), h, geo)
    heads = pcm[:, : nblocks * nspb - nspb].reshape(2, nblocks - 1, nspb)[:, :, :4]
    check(np.array_equal(heads, framed.states.history.numpy()[:-1].transpose(1, 0, 2)[..., ::-1]),
          "block heads != header history")
    _, ref = at.decode(data, device="cpu")
    check(np.array_equal(pcm, ref), "cuda decode != cpu decode")
    bench = dict(data=data, header=h, ref=ref)
    print(f"[main] stereo 4-bit {num_samples} samples/ch, {nblocks} blocks, "
          f"{2 * nblocks} lanes: cuda == cpu, bit-exact; launches {launches}; "
          f"first call {main_s:.3f} s")

    ms_data = data[:30] + bytes([1]) + data[31:]  # same payload, mid/side header
    check(at.decode_header(ms_data).ch_process_method == 1, "mid/side header")
    _, got = at.decode(ms_data, device="cuda")
    _, ref = at.decode(ms_data, device="cpu")
    check(np.array_equal(got, ref), "mid/side: cuda != cpu")
    bench.update(ms_data=ms_data, ms_ref=ref)
    print("[main] mid/side variant: cuda == cpu, bit-exact")

    mono_n = 40 * at.compute_block_geometry(1024, 1, 3).num_samples_per_block - 123  # ragged tail
    mono, _ = bench_stream(mono_n, nch=1, bps=3, seed=SEED + 1)
    _, got = at.decode(mono, device="cuda")
    _, ref = at.decode(mono, device="cpu")
    check(got.shape == (1, mono_n) and np.array_equal(got, ref), "mono 3-bit: cuda != cpu")
    print(f"[main] mono 3-bit {mono_n} samples, ragged tail: cuda == cpu, bit-exact")

    cut = mono[: len(mono) - 1500]
    try:
        at.decode(cut, device="cuda")
        raise AssertionError("strict decode of a truncated stream did not raise")
    except at.InsufficientDataError:
        pass
    _, got = at.decode(cut, device="cuda", strict=False)
    _, ref = at.decode(cut, device="cpu", strict=False)
    check(np.array_equal(got, ref) and not got[:, -100:].any(), "lenient: cuda != cpu")
    print("[main] truncated stream: strict raises, lenient cuda == cpu, bit-exact")

    stamp("5 decode main path")
    # 6. times at the main path's shapes
    from aad_tpu_torch.format.framing import pad_to_blocks

    dec = at.Decoder.from_header(h, device="cuda")
    payload = torch.from_numpy(np.frombuffer(data, np.uint8)[at.FILE_HEADER_SIZE:].copy()).to(cuda)
    rows = pad_to_blocks(payload, nblocks, geo)  # (B, block_size) rows, as framing.split_blocks gives them
    B, C, T = nblocks, geo.num_channels, geo.codes_per_block
    L = B * C
    # the bench stream, its mid/side variant (the same rows) and a live push: 8 blocks of 3-bit mid/side
    # 128-byte blocks (126 on the wire), random bytes; each one launch, against the plain version
    push_geo = at.compute_block_geometry(128, 2, 3)
    push_rows = torch.from_numpy(rng.integers(0, 256, (8, push_geo.block_size), dtype=np.uint8)).to(cuda)
    full_err = 0
    for what, r, g, ms in (("bench stream", rows, geo, False), ("mid/side variant", rows, geo, True),
                           ("push of 8 3-bit mid/side blocks", push_rows, push_geo, True)):
        err = max_err(fd.decode_rows(r, g, ms), fd.decode_rows_reference(r, g, ms))
        check(err == 0, f"kernel != plain on the card at the {what}: max |err| {err}")
        full_err = max(full_err, err)
        print(f"[kernel-vs-plain] aad_decode_lanes on the {what}, {r.shape[0] * g.num_channels} lanes, headers "
              f"parsed{' and left/right combined' if ms else ''} in the kernel: bit-exact")
    kernel_ms = cuda_ms(lambda: fd.decode_rows(rows, geo), KERNEL_ITERS)
    plain_ms = cuda_ms(lambda: fd.decode_rows_reference(rows, geo), PLAIN_ITERS, warmup=1)
    kernel_ms_2 = cuda_ms(lambda: fd.decode_rows(rows, geo), KERNEL_ITERS)
    ms_kernel_ms = cuda_ms(lambda: fd.decode_rows(rows, geo, True), KERNEL_ITERS)
    push_kernel_ms = cuda_ms(lambda: fd.decode_rows(push_rows, push_geo, True), KERNEL_ITERS)
    probe_ms = cuda_ms(lambda: fd.stepsize_probe(cuda), KERNEL_ITERS)
    probe_plain_ms = cuda_ms(lambda: fd.stepsize_probe_reference(cuda), KERNEL_ITERS)
    resident_ms = cuda_ms(lambda: dec.decode_payload_ondevice(payload), DECODE_ITERS)
    total = num_samples * h.num_channels
    at.decode(data, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_ITERS):
        at.decode(data, device="cuda")
    e2e_s = (time.perf_counter() - t0) / DECODE_ITERS
    decode_sass = sass_per_sample(DECODE_SYMBOL)
    # the bytes: each block row read once (headers included), the int16 rows written
    decode_bound, decode_pipe = loop_bound(B * geo.block_size + L * (T + 4) * 2, L * T, decode_sass)
    probe_bound = bound(2 * 256 * 4, 256 * PROBE_OPS_PER_SLOT)
    print(f"[time] card: {card}")
    print(f"[grid] aad_decode_lanes: {grid_line(DECODE_SYMBOL, L, cuda)}")
    print(f"[sass] aad_decode_lanes 4-bit: {sass_line(decode_sass, decode_pipe)}")
    print(f"[time] aad_decode_lanes {L} lanes x {T} codes, 4-bit, packed in {B} block rows: "
          f"kernel {kernel_ms:.4f} / {kernel_ms_2:.4f} ms (two windows), bound {decode_bound[0]:.4f} ms "
          f"({decode_bound[1]}), {decode_bound[0] / min(kernel_ms, kernel_ms_2):.1%} of the bound; "
          f"plain torch on the card {plain_ms:.4f} ms ({card})")
    k1_best = min(kernel_ms, kernel_ms_2)
    print(f"[time] aad_decode_lanes on the bench stream, headers parsed in the kernel: {k1_best:.4f} ms beside "
          f"{K1_STATES_GIVEN_MS:.4f} ms with the states given, {k1_best / K1_STATES_GIVEN_MS - 1:+.2%}; "
          f"the mid/side variant "
          f"{ms_kernel_ms:.4f} ms; a push of 8 3-bit mid/side blocks {push_kernel_ms:.4f} ms a launch ({card})")
    print(f"[time] aad_stepsize_probe 256 slots: kernel {probe_ms:.4f} ms, plain {probe_plain_ms:.4f} ms, "
          f"bound {probe_bound[0]:.6f} ms ({probe_bound[1]}) ({card})")
    floor_bound = floor_ms + probe_bound[0]
    print(f"[time] aad_stepsize_probe against the launch floor: floor-inclusive bound {floor_bound:.6f} ms "
          f"(floor {floor_ms:.6f} + bytes {probe_bound[0]:.6f}), {floor_bound / probe_ms:.1%} of it: "
          f"{'reaches' if probe_ms <= 2 * floor_bound else 'does not reach'} half of it ({card})")
    print(f"[time] device-resident decode_payload_ondevice: {resident_ms:.4f} ms, "
          f"{total / (resident_ms / 1e3):.6e} samples/s ({card})")
    print(f"[time] transfer-inclusive decode(): {e2e_s * 1e3:.4f} ms, "
          f"{total / e2e_s:.6e} samples/s ({card})")
    records = [
        {"name": fd.DECODE_KERNEL, "route": "cuda", "source": "aad_tpu_torch/csrc/decode.cu",
         "replaces": "aad_tpu/ops/pallas_decode.py:542", "launches": launches[fd.DECODE_KERNEL],
         "max_abs_err": max(decode_err, full_err), "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": decode_bound[0], "bound_by": decode_bound[1], "library_ms": None},
        {"name": fd.PROBE_KERNEL, "route": "cuda", "source": "aad_tpu_torch/csrc/decode.cu",
         "replaces": "aad_tpu/ops/pallas_decode.py:93", "launches": launches[fd.PROBE_KERNEL],
         "max_abs_err": probe_err, "ms": probe_ms, "plain_ms": probe_plain_ms,
         "bound_ms": probe_bound[0], "bound_by": probe_bound[1], "library_ms": None},
    ]
    prof = profile("device-resident fused decode, bench stream", lambda: dec.decode_payload_ondevice(payload),
                   10, time_major=(T, L), codes=(L * T, B * geo.data_bytes))
    check(prof["copies"] == 0, f"the fused decode still copies the codes time-major ({prof['copies']} a call)")
    check(prof["code_ops"] == 0, f"the fused decode still unpacks the codes ({prof['code_ops']} operations a call)")
    print(f"[profile]   resident fused decode: {prof['device_ms']:.4f} ms of device time a call, beside "
          f"{BYTE_CODES_DECODE_MS:.4f} ms when the codes were unpacked by torch ops before kernel 1 ({card})")
    del framed, rows, push_rows, payload, dec

    stamp("6 decode times")
    # 7-9. encode
    stream_err, pass_err = encode_kernel_checks(cuda)
    stamp("7 encode kernel checks")
    encoded = encode_main_path(cuda)
    stamp("8 encode main path")
    records += encode_times(cuda, card, encoded, stream_err, pass_err)
    stamp("9 encode times")

    # 10-12. the two-phase decode engine, random access, batch, streaming, transcode
    bench.update(mono=mono, encode=encoded)
    lms_err = lms_kernel_checks(cuda)
    slice_run = slice_main_path(cuda, bench)
    records.append(slice_times(cuda, card, bench, slice_run, lms_err))
    stamp("10-12 two-phase decode, range, batch, streaming, transcode")

    # 13. encode_batch; its pile's launches join kernels 3 and 4's main-path counts
    pile_run = batch_encode_phase(cuda, card, encoded)
    for record in records:
        record["launches"] += pile_run["counts"].get(record["name"], 0)
        record["max_abs_err"] = max(record["max_abs_err"], pile_run["errors"].get(record["name"], 0))

    stamp("13 encode_batch")
    # 14. the CLI and the utilities
    cli_phase(cuda, card, encoded, bench, resident_ms)
    stamp("14 CLI and utilities")
    # 15. the transfer paths and the native engine
    transfer_native_phase(cuda, card, bench, encoded, slice_run, main_s)
    stamp("15 transfer paths and native engine")
    # 16. sharding; its checked calls' launches join kernels 1, 2, 3 and 5's counts
    shard_counts = sharding_phase(cuda, card, bench, encoded)
    for record in records:
        record["launches"] += shard_counts.get(record["name"], 0)
    stamp("16 sharding")
    # 17. the decode probes, kernels 6-8: on no main path, so their launches there are 0
    records += probes_phase(cuda, card, probes_build, probe_launches())
    stamp("17 probes")
    # 18. a live stereo sender
    live_encode_phase(cuda, card)
    stamp("18 live sender")
    # 19. a conference bridge
    bridge_encode_phase(cuda, card)
    stamp("19 bridge")

    print(json.dumps({"kernels": records}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
