"""Profiling and throughput instrumentation on a CUDA card.

``trace`` captures a ``torch.profiler`` trace (CPU and CUDA activities)
around codec calls and writes it as a Chrome trace. ``measure_throughput``
times a function on the card with CUDA events after a warm-up: a host clock
around asynchronous launches would time their enqueue, not the work. Both
need a CUDA device and raise without one; nothing here times the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable

import torch


def _require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device; torch.cuda.is_available() is False")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body under ``torch.profiler`` (CPU and CUDA activities)
    and write ``<log_dir>/trace.json`` (open it in Perfetto or
    chrome://tracing). Yields the profiler, for ``key_averages()``.

    The trace carries the program's own spans (``aad.*``: API entries, host
    framing and staging, copies, kernel launches; ``utils.trace``) as
    ``cpu_op`` events on the caller's thread, and the bytes its copies move
    are added to ``utils.trace.counts``."""
    _require_cuda("trace")
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass
class ThroughputReport:
    samples_per_sec: float
    seconds_per_iter: float
    iters: int
    total_samples: int

    def __str__(self) -> str:
        return (
            f"{self.samples_per_sec / 1e9:.3f} Gsamples/s "
            f"({self.seconds_per_iter * 1e3:.4f} ms/iter, {self.iters} iters)"
        )


def measure_throughput(
    fn: Callable[[torch.Tensor], object],
    example: torch.Tensor,
    samples_per_call: int,
    iters: int = 10,
) -> ThroughputReport:
    """``fn(example)``'s throughput on the card that ``example`` lies on.

    One call warms up (kernel builds, caches), then CUDA events on the
    current stream bracket ``iters`` calls; the time is the device's, from
    the first launch to the end of the last. ``example`` must be a CUDA
    tensor.
    """
    if not isinstance(example, torch.Tensor) or example.device.type != "cuda":
        got = example.device if isinstance(example, torch.Tensor) else type(example).__name__
        raise RuntimeError(f"measure_throughput times a CUDA device; the example lies on {got}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    with torch.cuda.device(example.device):
        fn(example)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(example)
        end.record()
        end.synchronize()
    dt = start.elapsed_time(end) / 1e3 / iters
    return ThroughputReport(
        samples_per_sec=samples_per_call / dt,
        seconds_per_iter=dt,
        iters=iters,
        total_samples=samples_per_call * iters,
    )
