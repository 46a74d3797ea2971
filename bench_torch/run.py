"""Run one cell of the benchmark once; print its result as the last line.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``bench_torch/configs/``) and a traffic mix
(``bench_torch/traffic/<mix>.json``) in BENCHMARK.json; the mix names its
API entry (``bench_torch/entries/<entry>.py``). The run builds the mix's
inputs from the seed, warms up its requests, then calls the entry in a
closed loop, one caller, for ``--seconds`` (``--trace 1``: for the
mix's ``trace_seconds``, under torch.profiler). After the window it holds the
answers it kept against the plain reference (``reference/aad.py``) and
prints, on standard error, each number compared beside its limit, and on
standard output one JSON line: ``correct``, ``attempted``, ``failed``, the
cell's end-to-end metrics (``--trace 0``) or per-layer metrics
(``--trace 1``, with ``breakdown``), ``device``, and the numbers compared.

It runs on CUDA cards only: without as many as the cell asks for it exits
with status 2 and prints no result. The program's kernels build into
``build/`` of this checkout on the first run and load from there after.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    program builds its kernels into ``<checkout>/build/aad_tpu_torch``)."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def args_of(argv=None, extra=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=extra is None)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    if extra:
        extra(p)
    return p.parse_args(argv)


def cuda_devices(chips: int):
    """The first ``chips`` cards, or None (and a message) if there are fewer."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA device(s); {have} available", file=sys.stderr)
        return None
    return [torch.device("cuda", k) for k in range(chips)]


def quantile_ms(latencies: list[float], q: int) -> float:
    if len(latencies) == 1:
        return latencies[0] * 1e3
    return statistics.quantiles(latencies, n=100, method="inclusive")[q - 1] * 1e3


def end_to_end(metric: dict, direction: str, lat: list[float], total: int, window: float, setup: float) -> float:
    """A host-clock metric by its name: ``setup_s``,
    ``<direction>_samples_per_s`` or ``<direction>_p<q>_ms``, either with
    a ``.<tag>`` that names the cells it holds a bound of their own for."""
    name = metric["name"]
    if name == "setup_s":
        return setup
    m = re.fullmatch(r"(decode|encode)_(samples_per_s|p(\d+)_ms)(\.[\w.-]+)?", name)
    if m is None or m[1] != direction:
        raise ValueError(f"a {direction} cell cannot report {name}")
    return total / window if m[2] == "samples_per_s" else quantile_ms(lat, int(m[3]))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run(cell, seed: int, seconds: float, trace: bool, devices, t0: float, control: bool = False) -> dict:
    """One run of ``cell`` on ``devices``; returns the result line's object.
    With ``control``, the result also holds the control's readings."""
    import torch

    from harness import entry as base
    from harness import trace as tr
    from harness import traffic

    # the threads of torch's host operations, the mix's: the caller's own
    # (a DataLoader worker sets one), and one process with few threads
    # loads a shared host evenly
    torch.set_num_threads(int(cell.traffic["host_threads"]))
    plan = traffic.Plan(cell.traffic, cell.config, seed)
    ctx = base.Context(cell.config, cell.traffic, plan, devices)
    api = base.load(cell.traffic["entry"])
    t_import = time.perf_counter()
    entry = api.ENTRY(ctx)
    t_inputs = time.perf_counter()
    entry.warm()
    t_warm = time.perf_counter()
    cuda = devices[0].type == "cuda"
    window = min(seconds, float(cell.traffic["trace_seconds"])) if trace else seconds
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    span = (lambda: torch.profiler.record_function(tr.REQUEST_SPAN)) if trace else contextlib.nullcontext
    lat, works = [], []
    total = attempted = failed = 0
    setup = time.perf_counter() - t0
    start = end = time.perf_counter()
    i = 0
    while end - start < window:
        t1 = time.perf_counter()
        attempted += 1
        try:
            with span():
                out = entry.call(i)
        except Exception:  # a request that fails counts, and the loop goes on
            failed += 1
            if failed <= 3:
                traceback.print_exc()
            end = time.perf_counter()
            i += 1
            continue
        end = time.perf_counter()
        lat.append(end - t1)
        total += entry.samples(i, out)
        if plan.keep(i):
            entry.keep(i, out)
        if trace:
            works.append(entry.work(i))
        del out
        i += 1
    elapsed = end - start
    if lat:
        q = statistics.quantiles(lat, n=20, method="inclusive") if len(lat) > 1 else lat * 19
        print(f"set-up {setup:.3f} s: to the entry {t_import - t0:.3f}, inputs {t_inputs - t_import:.3f}, "
              f"warm-up {t_warm - t_inputs:.3f}; {len(lat)} requests, ms: min {min(lat) * 1e3:.3f} "
              f"median {q[9] * 1e3:.3f} p95 {q[18] * 1e3:.3f} max {max(lat) * 1e3:.3f}", file=sys.stderr)
    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {}}
    if trace:
        base.sync(devices)
        prof.__exit__(None, None, None)
        cards = sorted({d.index for d in devices}) if cuda else []
        t = tr.from_profiler(prof, works, cards)
        del prof
        names = [m["name"] for m in cell.per_layer()]
        units = {m["name"]: m["unit"] for m in cell.per_layer()}
        if cards:
            result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in tr.read_metrics(t, names).items()}
    else:
        for m in cell.end_to_end():
            result["metrics"][m["name"]] = {
                "value": end_to_end(m, entry.direction, lat, total, elapsed, setup), "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
              "count": len({str(d) for d in devices}),
              "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0}
    if trace and cards:
        device["busy_s"] = t.busy_mean()
        device["window_s"] = t.window_s
        limit = power_limit()
        if limit:
            device["power_limit"] = limit
            print(f"card and power limit: {limit}", file=sys.stderr)
    result["device"] = device
    if trace and cards:
        result["breakdown"] = t.breakdown()
        t = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    compared = entry.check()
    print(f"check: {time.perf_counter() - t2:.3f} s of reference after a {elapsed:.3f} s window "
          f"of {attempted} requests; set-up {setup:.3f} s", file=sys.stderr)
    if control:
        ctx.control = True
        result["control"] = entry.check()
        ctx.control = False
    limits = api.LIMITS
    result["correct"] = failed == 0 and all(v <= limits[k] for k, v in compared.items())
    result["compared"] = {k: {"value": v, "limit": limits[k]} for k, v in compared.items()}
    for k, v in compared.items():
        print(f"compared {k} = {v}, limit {limits[k]}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    args = args_of(argv)
    cache_dirs(ROOT)
    sys.path[:0] = [str(ROOT), str(BENCH)]
    from harness import spec

    cell = spec.Cell(spec.benchmark(ROOT), args.workload, ROOT)
    devices = cuda_devices(cell.chips)
    if devices is None:
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), devices, T0)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
