#!/usr/bin/env python3
"""Smoke run of aad_tpu_torch's decode and encode paths on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (written for an
H100), nvcc and PyTorch. It imports nothing of JAX or ``aad_tpu``. Phases, in
order (after each, the seconds since the start); nothing is caught, so any
failure exits non-zero:

1. device: name, power limit and toolchain;
2. build: the CUDA kernels, from ``aad_tpu_torch/csrc`` (timed);
3. probe: the step-size probe kernel reads exactly ``STEPSIZE_TABLE``; and
   the launch floor, a one-element torch op timed by CUDA events over 1,000
   launches, against which phase 6 holds the probe;
4. each decode kernel against its plain torch version, bit for bit: bps
   2/3/4, (B, C, T) codes with C = 1 and 2, lane counts that are not
   multiples of the 64-lane CTA, T = 1, T + 4 odd or not a multiple of 8, T
   not a multiple of the 64-position row tile, codes off a 4-byte boundary,
   step indices 0, 4080 and 4081-4095, weights and histories over all of
   int32 (the sums wrap);
5. the decode main path at full size: the benchmark's 10-minute stereo 4-bit
   stream (58,066 lanes of 988 codes) through ``aad_tpu_torch.decode(...,
   device="cuda")``, counting kernel launches, then its mid/side variant,
   a short mono 3-bit stream with a ragged tail and a lenient decode of a
   truncated stream, each bit-exact against ``device="cpu"``;
6. decode times, with CUDA events after warm-up: each kernel beside its
   bound (and its share of it) and its plain version on the card at the
   main path's shapes, kernel 1's bound from its step loop's instructions
   by pipe (``cuobjdump -sass``), how its CTAs spread over the SMs, the
   device-resident decode and the transfer-inclusive ``decode()``, and the
   resident decode's device time by kernel under ``torch.profiler``, which
   must show no time-major copy of the codes;
7. each encode kernel against its plain torch version, bit for bit: bps
   2/3/4, trials 0/1/2, the previous-block warm-up on and off (the serial
   and the paired schedule, its samples staged or not), per-block
   states, a carry in with blocks_before 0 and > 0, ragged valid counts
   below 4, lane counts that are not multiples of 32, forged states whose
   sums wrap, and ``aad_encode_pass`` measuring and emitting;
8. the encode main path at full width: the 10-minute stereo 4-bit signal
   (58,066 lanes) through ``aad_tpu_torch.encode(..., device="cuda",
   parallel_blocks=True)`` with trials 2, and with chunks of 4 and a warm
   pass; a 60-second stream through the sequential, chunked
   ``encode(..., device="cuda")`` (2,904 blocks, 46 chunks, one
   ``aad_encode_pass`` between two), against the one-shot encode and the
   plain encode of an 8-block prefix; the mid/side variant and a mono 3-bit
   stream with a ragged tail; each bit-exact against ``device="cpu"``, with
   launch counts; and a round trip of the parallel stream through the
   CUDA decoder, its SNR beside the CPU round trip's;
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
   ``torch.profiler``;
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
14. ``python -m aad_tpu_torch.cli`` in its six modes (and ``-d`` under
   ``AAD_TPU_ENGINE=pallas``) as subprocesses on a 10-second stereo WAV,
   against ``encode``/``decode(..., device="cuda")``; ``self_check()`` on
   the card; ``measure_throughput`` of the resident fused decode beside
   phase 6's CUDA-event time of the same call.

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
FLOOR_ITERS = 1000  # launches of a one-element op, the launch floor
PILE_STREAMS = 2048  # encode_batch's full-width pile: 4,096 lanes, kernel 3's staging gate
PILE_SECONDS = (1, 4)  # its streams' lengths, drawn from the seed
PILE_CHECKS = 12  # its streams drawn by seed held against their solo encode, beside 4 chosen
PILE_SIZES = (1, 32, 512, 2048)  # streams a timed pile
PILE_TIME_SECONDS = 2  # each timed stream's length
CLI_SECONDS = 10  # the CLI's WAV
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
DECODE_SYMBOL = "decode_lanes_kernelILi4E"  # aad_decode_lanes at 4 bits, as on the main path
LMS_SYMBOL = "lms_lanes_kernel"
SERIAL_SYMBOL = "encode_stream_kernelILi4E"  # aad_encode_stream's serial schedule, 4 bits
PAIRED_SYMBOL = "encode_stream_paired_kernelILi4ELb1E"  # its paired schedule, staged (the sequential shape's)
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
def sass_text() -> str:
    """``cuobjdump -sass`` of the built library."""
    from aad_tpu_torch.ops import _build

    cuobjdump = pathlib.Path(_build.find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout


def sass_loop(symbol: str, marker: str, without: str = "") -> list[tuple[str, str, str]]:
    """The instructions (guard, opcode, operands) of the longest innermost
    loop (a backward branch) that holds an instruction of opcode ``marker``
    and none of opcode ``without``, in the kernel whose mangled name
    contains ``symbol``."""
    funcs = [f for f in sass_text().split("Function : ")[1:] if symbol in f.split("\n", 1)[0]]
    check(len(funcs) == 1, f"{len(funcs)} functions named like {symbol} in the SASS")
    insns = [(int(m[1], 16), (m[2] or "").strip(), m[3], m[4]) for m in SASS_INSN.finditer(funcs[0])]
    loops = [(int(args.split()[-1], 16), addr) for addr, _, op, args in insns
             if op == "BRA" and args.split() and args.split()[-1].startswith("0x") and int(args.split()[-1], 16) <= addr]
    innermost = [(a, b) for a, b in loops if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    bodies = [[(g, op, args) for addr, g, op, args in insns if a <= addr <= b] for a, b in innermost]
    opcodes = [{op.split(".")[0] for _, op, _ in body} for body in bodies]
    return max((body for body, ops in zip(bodies, opcodes) if marker in ops and without not in ops), key=len)


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


def profile(label, fn, iters, time_major=None, host_rows=0):
    """Print the device time by kernel of ``fn`` under torch.profiler, per
    call, beside its CUDA-event time without the profiler; with
    ``host_rows``, also that many host operations by their own host time.

    With ``time_major=(T, L)`` it also counts, per call, the copies that
    make a (T, ...) tensor of T * L elements: the time-major relayout of the
    codes that phase A takes. Returns that count, or None.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    window_ms = cuda_ms(fn, iters, warmup=1)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=time_major is not None) as prof:
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
    if time_major is None:
        return None
    T, L = time_major
    copies = sum(
        e.count for e in prof.key_averages(group_by_input_shape=True)
        if e.device_type == DeviceType.CPU and e.key in ("aten::clone", "aten::contiguous")
        and any(len(s) > 1 and s[0] == T and int(np.prod(s)) == T * L for s in e.input_shapes)
    ) / iters
    print(f"[profile]   time-major copies of the {T} x {L} codes: {copies:g} a call")
    return copies


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


def int32_wide(rng, L) -> np.ndarray:
    """(L, 4) int32: half the rows over all of int32 (the sums wrap at once),
    half as the benchmark draws histories."""
    a = rng.integers(-(2**31), 2**31 - 1, (L, 4), endpoint=True).astype(np.int32)
    a[::2] = rng.integers(-32768, 32768, a[::2].shape)
    return a


def lane_inputs(rng, B, C, T, bps):
    """(B, C, T) codes and channel-major lane states for aad_decode_lanes."""
    import torch

    L = B * C
    codes = rng.integers(0, 2**bps, (B, C, T), dtype=np.uint8)
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

    # (a) block-parallel, the whole 10-minute stream
    reset()
    t0 = time.perf_counter()
    par = at.encode(pcm, cfg, device="cuda", parallel_blocks=True)
    par_s = time.perf_counter() - t0
    par_launches = counts()
    check(par_launches[fe.STREAM_KERNEL] == 1, f"parallel encode launches {par_launches}")
    t0 = time.perf_counter()
    ref = at.encode(pcm, cfg, device="cpu", parallel_blocks=True)
    cpu_s = time.perf_counter() - t0
    check(par == ref, "parallel encode: cuda != cpu")
    print(f"[encode-main] parallel stereo 4-bit trials 2, {n} samples/ch, {nblocks} blocks, "
          f"{2 * nblocks} lanes: cuda == cpu, bit-exact ({len(par)} bytes); launches {par_launches}; "
          f"first call {par_s:.3f} s, cpu {cpu_s:.3f} s")
    kw = dict(parallel_blocks=True, parallel_chunk_blocks=4, parallel_warm_passes=1)
    reset()
    got = at.encode(pcm, cfg, device="cuda", **kw)
    warm_launches = counts()
    check(warm_launches[fe.STREAM_KERNEL] == 2, f"chunked parallel launches {warm_launches}")
    check(got == at.encode(pcm, cfg, device="cpu", **kw), "parallel c=4 k=1: cuda != cpu")
    print(f"[encode-main] parallel, chunks of 4 and 1 warm pass: cuda == cpu, bit-exact; launches {warm_launches}")

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
    prefix = at.encode(seq_pcm[:, : PREFIX_BLOCKS * nspb], cfg, device="cpu")
    head = at.FILE_HEADER_SIZE
    check(prefix[head:] == seq[head : head + PREFIX_BLOCKS * geo.block_size], "sequential prefix != plain")
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
    _, dec_cpu = at.decode(ref, device="cpu")
    snr_cuda, snr_cpu = snr_db(pcm, dec_cuda), snr_db(pcm, dec_cpu)
    check(np.array_equal(dec_cuda, dec_cpu) and snr_cuda == snr_cpu, "round trip: cuda != cpu")
    print(f"[encode-main] round trip of the parallel stream: SNR {snr_cuda:.4f} dB (cuda encode, cuda decode), "
          f"{snr_cpu:.4f} dB (cpu encode, cpu decode)")
    return dict(cfg=cfg, pcm=pcm, seq_pcm=seq_pcm, seq=seq, par_launches=par_launches, seq_launches=seq_launches)


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
    lanes = blocks.reshape(1, -1, nspb)  # (1, B * C, nspb)
    L = lanes.shape[1]
    lane_valid = valid[:, None].expand(-1, geo.num_channels).reshape(1, L).contiguous()
    samples = lanes.transpose(1, 2).contiguous()
    args = (samples, lane_valid, CodecState.zeros((L,), cuda), None, bps, trials)
    codes, headers, _ = fe.encode_stream_tm(*args, warm_on_prev=False)
    want_h, want_c, _ = fe.encode_stream_reference(lanes, lane_valid, bps, trials, warm_on_prev=False, need_carry=False)
    full_err = max(max_err(codes[0].t(), want_c[0]), max_err(headers[0, 8], want_h.step_index[0]),
                   max_err(headers[0, 9], want_h.shift[0]), max_err(headers[0, 4:8].t(), want_h.weight[0]),
                   max_err(headers[0, 0:4].t(), want_h.history[0]))
    check(full_err == 0, f"aad_encode_stream != plain on the card at the main-path shape: {full_err}")
    del codes, headers, want_h, want_c
    stream_ms = cuda_ms(lambda: fe.encode_stream_tm(*args, warm_on_prev=False), ENCODE_ITERS)
    stream_plain_ms = cuda_ms(
        lambda: fe.encode_stream_reference(lanes, lane_valid, bps, trials, warm_on_prev=False, need_carry=False),
        1, warmup=0,
    )
    n_live = torch.clamp(lane_valid - 4, 0, T)
    steps = int((trials * n_live * (lane_valid >= 4)).sum()) + L * T  # measures (data-dependent) + emit
    # each sample-pass at the serial schedule's measure loop, by pipe
    serial_loop = sass_loop(SERIAL_SYMBOL, "LDG", without="STG")
    serial_sass = pipe_counts([op for _, op, _ in serial_loop], sample_loads(serial_loop))
    stream_bound, stream_pipe = loop_bound(L * nspb * 2 + L * 4 + L * 36 + L * T + L * 40, steps, serial_sass)

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
    pass_loop = sass_loop(PASS_SYMBOL, "LDG", without="STG")
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
    seq_stream_ms = cuda_ms(lambda: fe.encode_stream_tm(*seq_args, warm_on_prev=True, blocks_before=cb), 3, warmup=1)
    # the timed launch's first SEQ_CHECK_BLOCKS blocks against the plain
    # version (on the host: it takes seconds a block) on the same carry
    got_c, got_h, _ = fe.encode_stream_tm(*seq_args, warm_on_prev=True, blocks_before=cb)
    k = SEQ_CHECK_BLOCKS
    want_h, want_c, _ = fe.encode_stream_reference(
        chunk[:k].cpu(), chunk_valid[:k].cpu(), bps, trials, carry=(CodecState.zeros((2,), "cpu"), seq_args[3].t().cpu()),
        blocks_before=cb, need_carry=False)
    seq_err = max(max_err(got_c[:k].transpose(1, 2), want_c), max_err(got_h[:k, 8], want_h.step_index),
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
    seq_stream_bound, _ = loop_bound(cb * nspb * 2 * 2 + nspb * 2 * 2 + 2 * 36 + cb * 2 * (T + 40), seq_steps,
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
        ms = cuda_ms(lambda: fe.encode_stream_tm(*sweep_args, warm_on_prev=True, blocks_before=4), 3, warmup=1)
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
    profile("device-resident parallel encode, 10-minute stream", lambda: enc.encode_payload_ondevice(pcm_t), 10)
    profile(f"sequential encode() of {SEQ_SECONDS} s", lambda: at.encode(seq_pcm, cfg, device="cuda"), 1)

    print(f"[time] card: {card}")
    print(f"[time] aad_encode_stream {L} lanes x 1 block of {nspb}, 4-bit trials {trials}, parallel: "
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
    from aad_tpu_torch.ops import fused_decode as fd, lms

    data, h, ref, ms_data, ms_ref = bench["data"], bench["header"], bench["ref"], bench["ms_data"], bench["ms_ref"]
    counts = {}

    def drive(label, fn):
        reset_all_launches()
        out = fn()
        counts[label] = {k: v for k, v in all_launches().items() if v}
        return out

    # (a) the benchmark stream and its mid/side variant, both engines
    t0 = time.perf_counter()
    _, got = drive("decode pallas", lambda: at.decode(data, device="cuda", engine="pallas"))
    first_s = time.perf_counter() - t0
    check(counts["decode pallas"] == {lms.LMS_KERNEL: 1}, f"pallas decode launches {counts['decode pallas']}")
    _, fused = drive("decode fused", lambda: at.decode(data, device="cuda", engine="fused"))
    check(counts["decode fused"] == {fd.DECODE_KERNEL: 1}, f"fused decode launches {counts['decode fused']}")
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
    copies = profile("device-resident two-phase (pallas) decode, bench stream",
                     lambda: pallas.decode_payload_ondevice(payload), 10, time_major=(T, L))
    check(copies >= 1, "the profile does not see the two-phase decode's time-major code copy")
    fused_copies = profile("device-resident fused decode, bench stream",
                           lambda: fused.decode_payload_ondevice(payload), 10, time_major=(T, L))
    check(fused_copies == 0, f"the fused decode copies the codes time-major ({fused_copies} a call)")

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


def batch_encode_phase(cuda, card, main) -> dict:
    """Phase 13: encode_batch on the card: the full-width pile against solo
    encodes, exactness cases against the CPU, and times."""
    import torch
    import aad_tpu_torch as at
    from aad_tpu_torch.codec.batch_encode import _stage
    from aad_tpu_torch.codec.encoder import _OVERLAP_CHUNK_BLOCKS, _OVERLAP_MIN_BLOCKS
    from aad_tpu_torch.ops import encode_pass as ep, fused_encode as fe
    from aad_tpu_torch.ops.transitions import CodecState

    cfg, pcm = main["cfg"], main["pcm"]
    nspb = cfg.geometry().num_samples_per_block
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
    blocks = _stage(pile, nblocks * nspb, cuda).reshape(PILE_STREAMS, 2, nblocks, nspb).permute(2, 0, 1, 3)
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
                                       carry=carry, blocks_before=cb, need_carry=False)
    k = SEQ_CHECK_BLOCKS
    with cpu_threads(1):
        want_h, want_c, _ = fe.encode_stream_reference(
            blocks[cb : cb + k].cpu(), valid[cb : cb + k].cpu(), bps, trials,
            carry=(carry[0].map(lambda a: a.cpu()), carry[1].cpu()), blocks_before=cb, need_carry=False)
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
    }
    env = {k: v for k, v in os.environ.items() if k not in ("AAD_TPU_PLATFORM", "AAD_TPU_ENGINE", "AAD_TPU_STRICT")}
    t0 = time.perf_counter()
    procs = {
        mode: subprocess.Popen([sys.executable, "-m", "aad_tpu_torch.cli", *argv], cwd=ROOT, text=True,
                               env={**env, "AAD_TPU_ENGINE": "pallas"} if mode == "-d pallas" else env,
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
    for name in ("d", "dp", "r"):
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
    print(f"[cli] python -m aad_tpu_torch.cli -e/-d/-r/-g/-c/-i on a {CLI_SECONDS}-s stereo 16-bit WAV, and -d "
          f"under AAD_TPU_ENGINE=pallas, as 7 processes at once in {cli_s:.3f} s: -e == encode(device='cuda'), "
          f"-d/-r == decode(device='cuda'), -g == the residual, -c == in-process; -c printed "
          f"{results['-c'][0][0].strip()!r}")
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


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    import aad_tpu_torch as at
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

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"[build] {lib_path.relative_to(_build.BUILD_DIR.parents[1])} in {time.perf_counter() - t0:.3f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print(f"[build] ptxas: {line.split('ptxas info    : ')[-1]}")

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
        for B, C, T in ((2050, 2, 988), (333, 1, 2684), *EDGE_SHAPES):
            args = lane_inputs(rng, B, C, T, bps)
            want = fd.decode_lanes_reference(*args, bps)
            got = fd.decode_lanes(*(a.to(cuda) for a in args), bps)
            torch.cuda.synchronize()
            err = max_err(got, want)
            check(err == 0, f"kernel != plain at bps={bps} B={B} C={C} T={T}: max |err| {err}")
            decode_err = max(decode_err, err)
            print(f"[kernel-vs-plain] aad_decode_lanes bps={bps} codes (B, C, T) = ({B}, {C}, {T}), "
                  f"{B * C} lanes, rows of {T + 4}: bit-exact")
    codes, si, hist, wt = lane_inputs(rng, 41, 1, 21, 4)
    got = fd.decode_lanes(codes.to(cuda)[1:], *(a[1:].contiguous().to(cuda) for a in (si, hist, wt)), 4)
    err = max_err(got, fd.decode_lanes_reference(codes[1:], si[1:], hist[1:], wt[1:], 4))
    check(err == 0, f"kernel != plain on codes off a 4-byte boundary: max |err| {err}")
    print("[kernel-vs-plain] aad_decode_lanes on a (40, 1, 21) view 21 bytes into its storage: bit-exact")

    stamp("4 decode kernel checks")
    # 5. main path at full size
    num_samples = RATE * SECONDS
    data, header = bench_stream(num_samples)
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
    dec = at.Decoder.from_header(h, device="cuda")
    payload = torch.from_numpy(np.frombuffer(data, np.uint8)[at.FILE_HEADER_SIZE:].copy()).to(cuda)
    lanes = (
        framed.codes.to(cuda),  # (B, C, T), as framing.block_codes gives them
        framed.states.step_index.t().reshape(-1).contiguous().to(cuda),
        framed.states.history.transpose(0, 1).reshape(-1, 4).contiguous().to(cuda),
        framed.states.weight.transpose(0, 1).reshape(-1, 4).contiguous().to(cuda),
        4,
    )
    B, C, T = lanes[0].shape
    L = B * C
    got = fd.decode_lanes(*lanes)
    want = fd.decode_lanes_reference(*lanes)
    full_err = max_err(got, want)
    check(full_err == 0, "kernel != plain on the card at the main-path shape")
    del got, want
    kernel_ms = cuda_ms(lambda: fd.decode_lanes(*lanes), KERNEL_ITERS)
    plain_ms = cuda_ms(lambda: fd.decode_lanes_reference(*lanes), PLAIN_ITERS, warmup=1)
    kernel_ms_2 = cuda_ms(lambda: fd.decode_lanes(*lanes), KERNEL_ITERS)
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
    decode_bound, decode_pipe = loop_bound(T * L + L * 36 + L * (T + 4) * 2, L * T, decode_sass)
    probe_bound = bound(2 * 256 * 4, 256 * PROBE_OPS_PER_SLOT)
    print(f"[time] card: {card}")
    print(f"[grid] aad_decode_lanes: {grid_line(DECODE_SYMBOL, L, cuda)}")
    print(f"[sass] aad_decode_lanes 4-bit: {sass_line(decode_sass, decode_pipe)}")
    print(f"[time] aad_decode_lanes {L} lanes x {T} codes, 4-bit, (B, C, T) codes: "
          f"kernel {kernel_ms:.4f} / {kernel_ms_2:.4f} ms (two windows), bound {decode_bound[0]:.4f} ms "
          f"({decode_bound[1]}), {decode_bound[0] / min(kernel_ms, kernel_ms_2):.1%} of the bound; "
          f"plain torch on the card {plain_ms:.4f} ms ({card})")
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
    copies = profile("device-resident fused decode, bench stream", lambda: dec.decode_payload_ondevice(payload),
                     10, time_major=(T, L))
    check(copies == 0, f"the fused decode still copies the codes time-major ({copies} a call)")
    del framed, lanes, payload, dec

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

    print(json.dumps({"kernels": records}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
