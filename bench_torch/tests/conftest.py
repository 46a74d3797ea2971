"""Shared helpers of the benchmark's CPU tests: tiny cells of BENCHMARK.json,
run on the CPU through the kernels' plain versions.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import copy
import pathlib
import sys
import time

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH.parent), str(BENCH)]

import run as bench_run  # noqa: E402
from harness import spec  # noqa: E402

CELLS = {
    "decode_batch": "b4s1024-loader-decode",
    "stream_decode": "b3s128ms-live-decode",
    "encode_batch": "b4s1024-archive-encode",
    "encode_streams_sharded": "b4s1024-pile-encode-x4",
}

# Cells whose mix and entry stay under bench_torch/ while BENCHMARK.json
# holds no cell of them (the loader: its host-clock rate spreads too widely
# on a shared host for any bound; PERF.md), tested so that they come back as
# a BENCHMARK.json entry alone.
SPARE = [
    {"name": "b4s1024-loader-decode", "config": "aad-b4-s1024-stereo", "traffic": "loader-decode", "chips": 1,
     "why": "decode_batch of 16 of 48 files of LJ Speech's durations"},
]


def benchmark_with_spares() -> dict:
    b = spec.benchmark()
    have = {w["name"] for w in b["workloads"]}
    b["workloads"] = b["workloads"] + [w for w in SPARE if w["name"] not in have]
    return b


def tiny_cell(entry: str, count: int = 6, seconds=(0.01, 0.05), max_block_size=None, warm: int = 1):
    """The cell of ``entry`` with its mix cut to ``count`` clips of ``seconds``
    (and, for the plain encode's sake, its blocks to ``max_block_size``)."""
    c = spec.Cell(benchmark_with_spares(), CELLS[entry])
    c.traffic, c.config = copy.deepcopy(c.traffic), copy.deepcopy(c.config)
    c.traffic["clips"] = dict(count=count, seconds=list(seconds))  # log-uniform
    if "request" in c.traffic:
        c.traffic["request"].update(clips=3, cycle=4)
    c.traffic["warm_requests"] = warm
    c.traffic.setdefault("check", {})["streams"] = count
    if max_block_size:
        c.config["max_block_size"] = max_block_size
    return c


def run_cpu(cell, seed: int = 2**31 + 7, seconds: float = 0.5, control: bool = False) -> dict:
    """One run of ``cell`` on the CPU: the harness's look for a card skipped."""
    devices = [torch.device("cpu")] * cell.chips
    return bench_run.run(cell, seed, seconds, False, devices, time.perf_counter(), control=control)


@pytest.fixture
def cpu_run():
    return run_cpu
