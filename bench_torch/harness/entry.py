"""What every API entry shares; the entries themselves are found by name.

An entry is ``bench_torch/entries/<entry>.py``, named by a mix's ``entry``.
It exports ``ENTRY``, a subclass of :class:`Entry`, and ``LIMITS``, each
number its check compares with its limit. The entry builds its inputs from
the plan at set-up, makes one request per :meth:`Entry.call` (the timed
part: from the caller's bytes or PCM on the host to the answer where the
caller gets it), keeps the answers the plan samples, and after the window
holds them against the plain reference (``reference/aad.py``) in
:meth:`Entry.check`. The program is reached through its module attributes
at each call, so that a test can plant a fault under any of them.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import torch

import aad_tpu_torch as at
from reference import aad as R

from . import signal

BENCH = pathlib.Path(__file__).resolve().parents[1]


def load(name: str):
    """``bench_torch/entries/<name>.py`` as a module."""
    path = BENCH / "entries" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no entry {name!r}: there is no {path.relative_to(BENCH.parent)}")
    spec = importlib.util.spec_from_file_location(f"bench_entry_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def encode_config(cfg: dict):
    return at.EncodeConfig(
        num_channels=cfg["num_channels"], sampling_rate=cfg["sampling_rate"],
        bits_per_sample=cfg["bits_per_sample"], max_block_size=cfg["max_block_size"],
        ch_process_method=cfg["ch_process_method"], num_encode_trials=cfg["num_encode_trials"],
    )


def geometry(cfg: dict) -> R.Geometry:
    return R.Geometry(cfg["num_channels"], cfg["bits_per_sample"], cfg["max_block_size"])


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Context:
    def __init__(self, cfg: dict, mix: dict, plan, devices: list, control: bool = False):
        self.cfg, self.mix, self.plan, self.devices, self.control = cfg, mix, plan, devices, control
        self.device = devices[0]
        self.geo = geometry(cfg)
        self.mid_side = cfg["ch_process_method"] == 1


class Entry:
    direction = "decode"

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.kept = []

    def warm(self) -> None:
        """Run the largest requests of the cycle, so that nothing is built,
        loaded or first allocated in the window. Their answers are all held
        to the end, so that the allocator already has room for the answers
        the check keeps (a mix sets ``warm_requests`` one above ``keep_max``
        where answers stay on the card)."""
        plan = self.ctx.plan
        sizes = [sum(plan.lengths[j] for j in comp) for comp in plan.cycle]
        order = sorted(range(len(sizes)), key=lambda j: -sizes[j])
        n = int(self.ctx.mix.get("warm_requests", 1))
        held = [self.call(order[k % len(order)]) for k in range(n)]
        sync(self.ctx.devices)
        del held

    def keep(self, i: int, out) -> None:
        if len(self.kept) < int(self.ctx.mix.get("check", {}).get("keep_max", 1 << 30)):
            self.kept.append((i, out))


def pcm_clips(ctx: Context) -> list[np.ndarray]:
    """The plan's clips as contiguous (C, n) int16 host arrays."""
    lengths = ctx.plan.lengths
    flat = signal.render(lengths, ctx.cfg["num_channels"], ctx.mix["signal"], ctx.plan.signal_seed, ctx.device)
    flat = flat.cpu().numpy()
    bounds = np.cumsum(lengths)[:-1]
    return [np.ascontiguousarray(c) for c in np.split(flat, bounds, axis=1)]


def stream_work(ctx: Context, n: int, wire: int) -> dict:
    g = ctx.geo
    return dict(n=n, channels=g.channels, nspb=g.nspb, wire_bytes=wire, trials=ctx.cfg["num_encode_trials"])


def mismatch(got, want: torch.Tensor) -> int:
    """Samples of ``want`` that ``got`` misses or gets wrong."""
    got = torch.as_tensor(np.asarray(got))
    if tuple(got.shape) != tuple(want.shape):
        return int(want.numel())
    return int((got.to(torch.int32) != want.to(torch.int32)).sum())
