"""The traced window: torch.profiler's events, read into what the per-layer
readers (``bench_torch/metrics/<metric>.py``) and the breakdown take.

Device operations are the profiler's CUDA events: kernels, copies
(``Memcpy ...``) and fills (``Memset ...``). Requests are the harness's own
spans (``bench.request``), recorded around each call. Times are seconds on
the profiler's clock.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

REQUEST_SPAN = "bench.request"
BENCH = pathlib.Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Op:
    name: str
    device: int
    start: float
    end: float

    @property
    def kind(self) -> str:
        return "memcpy" if self.name.startswith("Memcpy") else "memset" if self.name.startswith("Memset") else "kernel"

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Request:
    start: float
    end: float
    work: list


def union(intervals) -> list[tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """What one traced window holds."""

    def __init__(self, ops: list[Op], host: list[Op], requests: list[Request], devices: list[int]):
        self.ops, self.host, self.requests, self.devices = ops, host, requests, devices
        self.window = (min(r.start for r in requests), max(r.end for r in requests)) if requests else (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def device_ops(self, device=None) -> list[Op]:
        a, b = self.window
        return [o for o in self.ops if o.end > a and o.start < b and (device is None or o.device == device)]

    def busy(self, device) -> float:
        """Seconds of the window in which ``device`` ran any operation."""
        a, b = self.window
        return sum(min(y, b) - max(x, a) for x, y in union((o.start, o.end) for o in self.device_ops(device)))

    def busy_mean(self) -> float:
        return sum(self.busy(d) for d in self.devices) / len(self.devices)

    def idle_pct(self):
        """The share of the window in which the cards ran nothing, in %,
        the mean over the cards; None without device operations."""
        if self.window_s <= 0 or not self.device_ops():
            return None
        return 100.0 * (1.0 - self.busy_mean() / self.window_s)

    def kernels(self, *names: str) -> list[Op]:
        return [o for o in self.device_ops() if o.kind == "kernel" and any(n in o.name for n in names)]

    def work(self, kernel: str):
        """``bench_torch/work/<kernel>.py`` as a module."""
        return load(BENCH / "work" / f"{kernel}.py")

    def roofline(self, kernel: str):
        """``kernel``'s share of its roofline, in %: the least time the traced
        requests' work could take (``work/<kernel>.py`` at the peaks of
        ``work/peaks.py``) over the device time the kernel took, on every
        card; None where the kernel did not run."""
        w = self.work(kernel)
        spent = sum(o.seconds for o in self.kernels(*w.KERNELS))
        if spent <= 0:
            return None
        peaks = self.work("peaks")
        return 100.0 * sum(peaks.least_seconds(*w.work(r.work)) for r in self.requests) / spent

    def gaps(self) -> list[tuple[float, float]]:
        """Idle stretches (start, end) of each device in the window, longest first."""
        a, b = self.window
        out = []
        for d in self.devices:
            busy = union((max(o.start, a), min(o.end, b)) for o in self.device_ops(d))
            edges = [a] + [x for iv in busy for x in iv] + [b]
            out += [(x, y) for x, y in zip(edges[::2], edges[1::2]) if y > x]
        return sorted(out, key=lambda g: g[0] - g[1])

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        inner = [h for h in self.host if h.start <= t <= h.end]
        return min(inner, key=lambda h: h.seconds).name if inner else "python"

    def breakdown(self) -> dict:
        by_name: dict = {}
        for o in self.device_ops():
            by_name[o.name] = by_name.get(o.name, 0.0) + o.seconds
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[short(n), s] for n, s in ops], "idle_gaps": [[self.host_at((x + y) / 2), y - x] for x, y in self.gaps()[:10]]}


def short(name: str) -> str:
    """A kernel's name without its argument list and template arguments."""
    base = name.split("(")[0]
    return (base.split("<")[0] or base)[:120]


def load(path):
    spec = importlib.util.spec_from_file_location(pathlib.Path(path).stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def from_profiler(prof, works: list, devices: list[int]) -> Trace:
    """Read a finished ``torch.profiler.profile`` into a :class:`Trace`;
    ``works`` holds each traced request's work, in call order."""
    from torch.autograd import DeviceType

    ops, host, spans = [], [], []
    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)  # seconds from here keep every digit
    for e in events:
        name = e.name()
        start, end = (e.start_ns() - base) * 1e-9, (e.end_ns() - base) * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith("bench."):  # the spans' images on the device's timeline
                ops.append(Op(name, e.device_index(), start, end))
        elif name == REQUEST_SPAN:
            spans.append((start, end))
        else:
            host.append(Op(name, -1, start, end))
    spans.sort()
    requests = [Request(a, b, w) for (a, b), w in zip(spans, works)]
    return Trace(ops, host, requests, devices)


def read_metrics(trace: Trace, names: list[str]) -> dict:
    """Each per-layer reader's value; a reader that returns None is left out."""
    out = {}
    for name in names:
        value = load(BENCH / "metrics" / f"{name}.py").read(trace)
        if value is not None:
            out[name] = value
    return out
