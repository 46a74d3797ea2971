#!/usr/bin/env python3
"""Smoke run of aad_tpu_torch's decode and encode paths on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (written for an
H100), nvcc and PyTorch. It imports nothing of JAX or ``aad_tpu``. Phases, in
order; nothing is caught, so any failure exits non-zero:

1. device: name, power limit and toolchain;
2. build: the CUDA kernels, from ``aad_tpu_torch/csrc`` (timed);
3. probe: the step-size probe kernel reads exactly ``STEPSIZE_TABLE``;
4. each decode kernel against its plain torch version, bit for bit: bps
   2/3/4, a ragged lane count, step indices 0, 4080 and 4081-4095, weights
   and history drawn as the benchmark draws them (the int32 sums wrap);
5. the decode main path at full size: the benchmark's 10-minute stereo 4-bit
   stream (58,066 lanes of 988 codes) through ``aad_tpu_torch.decode(...,
   device="cuda")``, counting kernel launches, then its mid/side variant,
   a short mono 3-bit stream with a ragged tail and a lenient decode of a
   truncated stream, each bit-exact against ``device="cpu"``;
6. decode times, with CUDA events after warm-up: each kernel and its plain
   version on the card at the main path's shapes, the device-resident
   decode and the transfer-inclusive ``decode()``, and the resident
   decode's device time by kernel under ``torch.profiler``;
7. each encode kernel against its plain torch version, bit for bit: bps
   2/3/4, trials 0/1/2, the previous-block warm-up on and off, per-block
   states, a carry in with blocks_before 0 and > 0, ragged valid counts
   below 4, lane counts that are not multiples of 32, forged states whose
   sums wrap, and ``aad_encode_pass`` measuring and emitting;
8. the encode main path at full width: the 10-minute stereo 4-bit signal
   (58,066 lanes) through ``aad_tpu_torch.encode(..., device="cuda",
   parallel_blocks=True)`` with trials 2, and with chunks of 4 and a warm
   pass; a 60-second stream through the sequential, chunked
   ``encode(..., device="cuda")`` (2,904 blocks, 46 chunks, one
   ``aad_encode_pass`` per chunk), against the one-shot encode and the
   plain encode of an 8-block prefix; the mid/side variant and a mono 3-bit
   stream with a ragged tail; each bit-exact against ``device="cpu"``, with
   launch counts; and a round trip of the parallel stream through the
   CUDA decoder, its SNR beside the CPU round trip's;
9. encode times: each encode kernel and its plain version on the card at
   the main path's shapes, the device-resident and transfer-inclusive
   parallel encode, and the sequential 60-second encode; the device time by
   kernel of the resident parallel and the sequential encode under
   ``torch.profiler``.

Before the last line it prints one JSON object with a record per kernel
(its launches on the main path, its time beside its plain version's and
its bound), and the card's name and power limit. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import importlib.util
import json
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

# The least time the card could take (H100 SXM, NVIDIA's data sheet and the
# Hopper white paper): HBM at 3.35 TB/s, and int32 issue at 64 lanes per SM
# per clock on 132 SMs at the 1.98 GHz boost clock (half the float32 lanes).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Integer instructions per sample, counted from the kernels' loop bodies:
# aad_decode_lanes (csrc/decode.cu), and encode_step plus its pass loop
# (csrc/encode.cu; the quotient search has bps - 1 steps).
DECODE_OPS_PER_SAMPLE = 40
ENCODE_OPS_PER_STEP = {2: 52, 3: 56, 4: 60}
PROBE_OPS_PER_SLOT = 5


def bound(num_bytes: float, ops: float) -> tuple[float, str]:
    """(least ms, what bounds it): bytes over HBM rate vs ops over int32 rate."""
    t_bytes = num_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_stream(num_samples, nch=2, bps=4, ms=False, seed=SEED):
    """A valid .aad stream with random codes and states, as bench.py builds its
    stream (bench.py::build_synthetic_stream: same draws from the same seed),
    built with the port's own framing. Returns (bytes, header)."""
    import aad_tpu_torch as at
    from aad_tpu_torch.format.framing import BlockStates, assemble_stream, build_block_headers
    from aad_tpu_torch.format.geometry import num_blocks_for

    geo = at.compute_block_geometry(1024, nch, bps)
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


def profile(label, fn, iters) -> None:
    """Print the device time by kernel of ``fn`` under torch.profiler, per
    call, beside its CUDA-event time without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    window_ms = cuda_ms(fn, iters, warmup=1)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def lane_inputs(rng, L, T, bps):
    import torch

    codes_tm = rng.integers(0, 2**bps, (T, L), dtype=np.uint8)
    si = rng.integers(0, 4096, (L,)).astype(np.int32)
    si[:17] = [0, 4080, *range(4081, 4096)]  # wire values, before the parse clamp
    hist = rng.integers(-32768, 32768, (L, 4)).astype(np.int32)
    wt = rng.integers(-20000, 20000, (L, 4)).astype(np.int32)
    return [torch.from_numpy(a) for a in (codes_tm, si, hist, wt)]


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
    # the full 1024-byte geometries: stereo 4-bit, mono 3-bit (2684 samples a block)
    cases += [(4, 2, True, 2, 67, 992), (3, 2, False, 2, 33, 2684)]
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
    check(seq_launches == {fe.STREAM_KERNEL: chunks, ep.PASS_KERNEL: chunks},
          f"sequential launches {seq_launches}, want {chunks} of each")
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
    return dict(cfg=cfg, pcm=pcm, seq_pcm=seq_pcm, par_launches=par_launches, seq_launches=seq_launches)


def encode_times(cuda, card, main, stream_err, pass_err) -> list[dict]:
    """Phase 9: encode times at the main path's shapes; the encode kernels' records."""
    import torch
    import aad_tpu_torch as at
    from aad_tpu_torch.codec.encoder import _pad_to_blocks
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
    stream_bound = bound(L * nspb * 2 + L * 4 + L * 36 + L * T + L * 40, steps * ENCODE_OPS_PER_STEP[bps])

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
    pass_bound = bound(T * 2 * 2 + 2 * (36 + 4) + 2 * (36 + 8), 2 * T * ENCODE_OPS_PER_STEP[bps])

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
    print(f"[time] aad_encode_pass 2 lanes x {T} codes, measure: kernel {pass_ms:.4f} ms, "
          f"plain torch on the card {pass_plain_ms:.4f} ms, bound {pass_bound[0]:.6f} ms ({pass_bound[1]}) ({card})")
    print(f"[time] device-resident parallel encode_payload_ondevice: {resident_ms:.4f} ms, "
          f"{total / (resident_ms / 1e3):.6e} samples/s ({card})")
    print(f"[time] transfer-inclusive parallel encode(): {e2e_s * 1e3:.4f} ms, {total / e2e_s:.6e} samples/s ({card})")
    print(f"[time] sequential encode() of {SEQ_SECONDS} s stereo: {seq_s * 1e3:.4f} ms, "
          f"{seq_pcm.size / seq_s:.6e} samples/s ({card})")

    par, seq = main["par_launches"], main["seq_launches"]
    return [
        {"name": fe.STREAM_KERNEL, "route": "cuda", "source": "aad_tpu_torch/csrc/encode.cu",
         "replaces": "aad_tpu/ops/pallas_encode_fused.py:1102",
         "launches": par[fe.STREAM_KERNEL] + seq[fe.STREAM_KERNEL], "max_abs_err": max(stream_err, full_err),
         "ms": stream_ms, "plain_ms": stream_plain_ms, "bound_ms": stream_bound[0], "bound_by": stream_bound[1],
         "library_ms": None},
        {"name": ep.PASS_KERNEL, "route": "cuda", "source": "aad_tpu_torch/csrc/encode.cu",
         "replaces": "aad_tpu/ops/pallas_encode.py:298", "launches": seq[ep.PASS_KERNEL],
         "max_abs_err": pass_err, "ms": pass_ms, "plain_ms": pass_plain_ms, "bound_ms": pass_bound[0],
         "bound_by": pass_bound[1], "library_ms": None},
    ]


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

    # 4. each kernel against its plain version, bit for bit
    rng = np.random.default_rng(SEED)
    decode_err = 0
    for bps in (2, 3, 4):
        for L, T in ((4099, 988), (333, 2684)):
            args = lane_inputs(rng, L, T, bps)
            want = fd.decode_lanes_reference(*args, bps)
            got = fd.decode_lanes(*(a.to(cuda) for a in args), bps)
            torch.cuda.synchronize()
            err = int((got.cpu().to(torch.int32) - want.to(torch.int32)).abs().max())
            check(err == 0, f"kernel != plain at bps={bps} L={L} T={T}: max |err| {err}")
            decode_err = max(decode_err, err)
            print(f"[kernel-vs-plain] aad_decode_lanes bps={bps} lanes={L} codes={T}: bit-exact")

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
    print(f"[main] stereo 4-bit {num_samples} samples/ch, {nblocks} blocks, "
          f"{2 * nblocks} lanes: cuda == cpu, bit-exact; launches {launches}; "
          f"first call {main_s:.3f} s")

    ms_data = data[:30] + bytes([1]) + data[31:]  # same payload, mid/side header
    check(at.decode_header(ms_data).ch_process_method == 1, "mid/side header")
    _, got = at.decode(ms_data, device="cuda")
    _, ref = at.decode(ms_data, device="cpu")
    check(np.array_equal(got, ref), "mid/side: cuda != cpu")
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

    # 6. times at the main path's shapes
    dec = at.Decoder.from_header(h, device="cuda")
    payload = torch.from_numpy(np.frombuffer(data, np.uint8)[at.FILE_HEADER_SIZE:].copy()).to(cuda)
    codes_tm = framed.codes.permute(2, 1, 0).reshape(framed.codes.shape[2], -1).contiguous().to(cuda)
    lanes = (
        codes_tm,
        framed.states.step_index.t().reshape(-1).contiguous().to(cuda),
        framed.states.history.transpose(0, 1).reshape(-1, 4).contiguous().to(cuda),
        framed.states.weight.transpose(0, 1).reshape(-1, 4).contiguous().to(cuda),
        4,
    )
    got = fd.decode_lanes(*lanes)
    want = fd.decode_lanes_reference(*lanes)
    check(torch.equal(got, want), "kernel != plain on the card at the main-path shape")
    full_err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    del got, want
    kernel_ms = cuda_ms(lambda: fd.decode_lanes(*lanes), KERNEL_ITERS)
    plain_ms = cuda_ms(lambda: fd.decode_lanes_reference(*lanes), PLAIN_ITERS, warmup=1)
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
    L = codes_tm.shape[1]
    print(f"[time] card: {card}")
    print(f"[time] aad_decode_lanes {L} lanes x {codes_tm.shape[0]} codes, 4-bit: "
          f"kernel {kernel_ms:.4f} ms, plain torch on the card {plain_ms:.4f} ms ({card})")
    print(f"[time] aad_stepsize_probe 256 slots: kernel {probe_ms:.4f} ms, "
          f"plain {probe_plain_ms:.4f} ms ({card})")
    print(f"[time] device-resident decode_payload_ondevice: {resident_ms:.4f} ms, "
          f"{total / (resident_ms / 1e3):.6e} samples/s ({card})")
    print(f"[time] transfer-inclusive decode(): {e2e_s * 1e3:.4f} ms, "
          f"{total / e2e_s:.6e} samples/s ({card})")

    T = codes_tm.shape[0]
    decode_bound = bound(T * L + L * 36 + L * (T + 4) * 2, L * T * DECODE_OPS_PER_SAMPLE)
    probe_bound = bound(2 * 256 * 4, 256 * PROBE_OPS_PER_SLOT)
    print(f"[time] bounds: aad_decode_lanes {decode_bound[0]:.4f} ms ({decode_bound[1]}), "
          f"aad_stepsize_probe {probe_bound[0]:.6f} ms ({probe_bound[1]})")
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
    profile("device-resident decode, bench stream", lambda: dec.decode_payload_ondevice(payload), 10)
    del framed, codes_tm, lanes, payload, dec

    # 7-9. encode
    stream_err, pass_err = encode_kernel_checks(cuda)
    encoded = encode_main_path(cuda)
    records += encode_times(cuda, card, encoded, stream_err, pass_err)

    print(json.dumps({"kernels": records}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
