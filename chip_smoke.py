#!/usr/bin/env python3
"""Smoke run of aad_tpu_torch's decode path on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (written for an
H100), nvcc and PyTorch. It imports nothing of JAX or ``aad_tpu``. Phases, in
order; nothing is caught, so any failure exits non-zero:

1. device: name, power limit and toolchain;
2. build: the CUDA kernels, from ``aad_tpu_torch/csrc`` (timed);
3. probe: the step-size probe kernel reads exactly ``STEPSIZE_TABLE``;
4. each kernel against its plain torch version, bit for bit: bps 2/3/4, a
   ragged lane count, step indices 0, 4080 and 4081-4095, weights and
   history drawn as the benchmark draws them (the int32 sums wrap);
5. the main path at full size: the benchmark's 10-minute stereo 4-bit
   stream (58,066 lanes of 988 codes) through ``aad_tpu_torch.decode(...,
   device="cuda")``, counting kernel launches, then its mid/side variant,
   a short mono 3-bit stream with a ragged tail and a lenient decode of a
   truncated stream, each bit-exact against ``device="cpu"``;
6. times, with CUDA events after warm-up: each kernel and its plain
   version on the card at the main path's shapes, the device-resident
   decode and the transfer-inclusive ``decode()``.

Before the last line it prints one JSON object with a record per kernel,
and the card's name and power limit. The last line is
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

    record = {"kernels": [
        {"name": fd.DECODE_KERNEL, "route": "cuda", "source": "aad_tpu_torch/csrc/decode.cu",
         "replaces": "aad_tpu/ops/pallas_decode.py:542", "launches": launches[fd.DECODE_KERNEL],
         "max_abs_err": max(decode_err, full_err), "ms": kernel_ms, "plain_ms": plain_ms},
        {"name": fd.PROBE_KERNEL, "route": "cuda", "source": "aad_tpu_torch/csrc/decode.cu",
         "replaces": "aad_tpu/ops/pallas_decode.py:93", "launches": launches[fd.PROBE_KERNEL],
         "max_abs_err": probe_err, "ms": probe_ms, "plain_ms": probe_plain_ms},
    ]}
    print(json.dumps(record))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
