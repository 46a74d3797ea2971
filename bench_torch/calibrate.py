"""Readings that the limits of ``correct`` are set from: for each seed, one
run of the cell (a short window at the cell's own load, every kept answer
compared) and the control's readings of the same answers, in one process.

    python3 bench_torch/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 2

The control is the plain reference with its 4-tap prediction accumulated
in float32 (``reference/aad.py``), put in the program's place: its decode of
the same bytes, or its encode of each block from the same carried state.
One JSON line a seed: the program's numbers compared, the control's, the
end-to-end metrics. Like run.py, it runs on CUDA cards only.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    args = bench_run.args_of(argv, extra=lambda p: p.add_argument("--seeds", required=True))
    bench_run.cache_dirs(bench_run.ROOT)
    sys.path[:0] = [str(bench_run.ROOT), str(bench_run.BENCH)]
    import torch

    from harness import spec

    cell = spec.Cell(spec.benchmark(bench_run.ROOT), args.workload, bench_run.ROOT)
    devices = bench_run.cuda_devices(cell.chips)
    if devices is None:
        return 2
    t0 = T0
    for seed in (int(s) for s in args.seeds.split(",")):
        res = bench_run.run(cell, seed, args.seconds, False, devices, t0, control=True)
        print(json.dumps({"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
                          "compared": {k: v["value"] for k, v in res["compared"].items()},
                          "control": res["control"], "metrics": res["metrics"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
