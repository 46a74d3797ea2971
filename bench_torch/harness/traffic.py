"""The one generator of traffic: a mix file's parameters and a seed -> a plan.

Lengths are the quantiles of the mix's law, the same set for every seed;
the seed orders them, draws the signal and orders the requests. So two
seeds give the same work in another order, and their runs differ by the
system's noise, not by what they were asked to do.

Mix parameters (``bench_torch/traffic/<mix>.json``):

``source``         where each parameter comes from, or that it is chosen;
``entry``          the API entry a request calls (``entries/<entry>.py``);
``clips``          ``count`` clips, ``seconds`` [lo, hi] of audio each,
                   under the ``law`` ``log-uniform`` (the default) or
                   ``triangular``: the triangular law with that least and
                   most and the ``mean`` seconds given;
``request``        ``clips`` a request, and for a pool larger than a
                   request a ``cycle`` of that many compositions drawn with
                   ``layout_seed`` (fixed, so not the run's seed);
``push_bytes``     bytes a push, for the streaming entries;
``signal``         the PCM's parameters (``harness/signal.py``);
``mesh``           (dp, sp) for the sharded entries;
``check``          ``keep_one_in``: a request's answers are kept for the
                   check when its seeded draw says so; ``streams``: how
                   many streams a sharded check samples;
``host_threads``   threads of torch's host operations, the caller's own;
``warm_requests``  requests run at set-up, before the window;
``trace_seconds``  the traced window's length, at most ``--seconds``.
"""

from __future__ import annotations

import math

import numpy as np


def seconds_to_samples(sec: float, rate: int) -> int:
    return max(1, int(round(sec * rate)))


def triangular_quantile(u: float, lo: float, mode: float, hi: float) -> float:
    cut = (mode - lo) / (hi - lo)
    if u < cut:
        return lo + math.sqrt(u * (hi - lo) * (mode - lo))
    return hi - math.sqrt((1 - u) * (hi - lo) * (hi - mode))


def clip_seconds(clips: dict) -> list[float]:
    """The (j + 1/2)/count quantiles of the clips' law, in seconds, shortest first."""
    n = int(clips["count"])
    lo, hi = (float(s) for s in clips["seconds"])
    law = clips.get("law", "log-uniform")
    if law == "log-uniform":
        a, b = math.log(lo), math.log(hi)
        return [math.exp(a + (j + 0.5) / n * (b - a)) for j in range(n)]
    if law == "triangular":
        mode = 3 * float(clips["mean"]) - lo - hi  # the mean of a triangular law is (lo + mode + hi) / 3
        if not lo <= mode <= hi:
            raise ValueError(f"no triangular law on [{lo}, {hi}] has the mean {clips['mean']}")
        return [triangular_quantile((j + 0.5) / n, lo, mode, hi) for j in range(n)]
    raise ValueError(f"unknown law {law!r}")


def clip_lengths(mix: dict, rate: int) -> list[int]:
    """The mix's clip lengths in samples a channel, shortest first."""
    return [seconds_to_samples(s, rate) for s in clip_seconds(mix["clips"])]


class Plan:
    """What a run of one mix asks for, from its seed."""

    def __init__(self, mix: dict, config: dict, seed: int):
        self.mix = mix
        self.seed = seed
        ss = np.random.SeedSequence(seed % 2**63)
        order_seq, signal_seq, keep_seq = ss.spawn(3)
        self.rng = np.random.default_rng(order_seq)
        self.signal_seed = int(np.random.default_rng(signal_seq).integers(0, 2**62))
        self.keep_key = int(np.random.default_rng(keep_seq).integers(0, 2**62))
        lengths = clip_lengths(mix, int(config["sampling_rate"]))
        self.lengths = [lengths[j] for j in self.rng.permutation(len(lengths))]
        req = mix.get("request", {})
        per = int(req.get("clips", len(self.lengths)))
        if per >= len(self.lengths):
            self.cycle = [list(range(len(self.lengths)))]
        else:
            layout = np.random.default_rng(int(req["layout_seed"]))
            comps = [sorted(layout.choice(len(lengths), per, replace=False)) for _ in range(int(req["cycle"]))]
            # composition j names clips by length rank; map ranks to this seed's clips
            rank_to_clip = {r: i for i, r in enumerate(self._ranks())}
            self.cycle = [[rank_to_clip[r] for r in comp] for comp in comps]
            self.cycle = [self.cycle[j] for j in self.rng.permutation(len(self.cycle))]

    def _ranks(self) -> list[int]:
        """Each clip's rank by length (ties by position)."""
        order = sorted(range(len(self.lengths)), key=lambda i: (self.lengths[i], i))
        ranks = [0] * len(order)
        for r, i in enumerate(order):
            ranks[i] = r
        return ranks

    def request_clips(self, i: int) -> list[int]:
        """The clips request ``i`` takes."""
        return self.cycle[i % len(self.cycle)]

    def keep(self, i: int) -> bool:
        """Whether request ``i``'s answers are kept for the check: a seeded
        draw, and always the window's first request."""
        every = int(self.mix.get("check", {}).get("keep_one_in", 1))
        return i == 0 or np.random.default_rng([self.keep_key, i]).integers(0, every) == 0
