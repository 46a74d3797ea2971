"""What a cell is made of, found by name: BENCHMARK.json's entry, the
configuration's file and the traffic mix's file."""

from __future__ import annotations

import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]  # bench_torch/
ROOT = BENCH.parent                                  # the checkout


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT) -> dict:
    return load_json(pathlib.Path(root) / "BENCHMARK.json")


class Cell:
    """One workload of BENCHMARK.json with its configuration and traffic mix."""

    def __init__(self, bench: dict, name: str, root=ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
        self.workload = cells[name]
        self.name = name
        self.bench = bench
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(pathlib.Path(root) / configs[self.workload["config"]]["file"])
        self.traffic = load_json(BENCH / "traffic" / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])

    def applies(self, metric: dict) -> bool:
        """Whether ``metric`` is reported in this cell: listed under its
        ``workloads``, or, without that key, wherever its ``moves`` metric is."""
        if "workloads" in metric:
            return self.name in metric["workloads"]
        moved = {m["name"]: m for m in self.bench["end_to_end"]}.get(metric.get("moves"))
        return moved is None or self.applies(moved)

    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"] if self.applies(m)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.bench["per_layer"] if self.applies(m)]
