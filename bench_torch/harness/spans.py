"""The program's own spans and counters in a traced window.

``aad_tpu_torch.utils.trace`` records a span (``aad.*``) as a host
operation while torch.profiler records, and adds the bytes of each copy to
its ``counts``. A :class:`~harness.trace.Trace` holds the spans among its
host operations. Here: the spans inside the traced requests, the spans
nested in a span, a span's self time (its duration less the time that the
``aad.*`` spans nested in it cover; torch's own host operations inside it
count as its work), and the program's counters. Every reader returns None
where the program records none of what it reads, as a program that has no
spans does.
"""

from __future__ import annotations

import bisect
import importlib

PREFIX = "aad."


class Span:
    """A program span in a request, with the spans directly inside it."""

    def __init__(self, op):
        self.name, self.start, self.end = op.name, op.start, op.end
        self.children: list[Span] = []

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def self_seconds(self) -> float:
        """The duration less the time of the spans nested in it."""
        return self.seconds - sum(c.seconds for c in self.children)

    def within(self, *names: str) -> list["Span"]:
        """The spans nested in this one, at any depth, named one of ``names``."""
        out = []
        for c in self.children:
            if c.name in names:
                out.append(c)
            out += c.within(*names)
        return out


def spans(trace) -> list[Span]:
    """Every program span that lies inside a traced request, in start order,
    each with its children: the spans directly inside it (spans on the
    caller's thread nest as its calls do)."""
    reqs = sorted((r.start, r.end) for r in trace.requests)
    starts = [a for a, _ in reqs]

    def in_request(op) -> bool:
        k = bisect.bisect_right(starts, op.start) - 1
        return k >= 0 and op.end <= reqs[k][1]

    ops = sorted((o for o in trace.host if o.name.startswith(PREFIX) and in_request(o)),
                 key=lambda o: (o.start, -o.end))
    out, open_ = [], []
    for op in ops:
        s = Span(op)
        while open_ and not (open_[-1].start <= s.start and s.end <= open_[-1].end):
            open_.pop()
        if open_:
            open_[-1].children.append(s)
        open_.append(s)
        out.append(s)
    return out


def named(trace, *names: str) -> list[Span]:
    """The program spans inside the traced requests named one of ``names``."""
    return [s for s in spans(trace) if s.name in names]


def counts() -> dict | None:
    """The program's counters (``aad_tpu_torch.utils.trace.counts``): their
    totals over the traced window, the only one of a run; None where the
    program keeps none."""
    try:
        program = importlib.import_module("aad_tpu_torch.utils.trace")
    except ImportError:
        return None
    return dict(program.counts)
