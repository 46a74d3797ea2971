"""Device time of one ``aad_encode_stream`` launch with the trial search's
warm-up (the paired schedule), by lane count and code unit, on the card.

    python -m aad_tpu_torch.utils.time_lanes [--lanes 14518 58066 2] [--iters 5]

Each launch encodes 4 blocks of 992 samples a lane (stereo 4-bit, 1024-byte
blocks, trials 2) of ``chip_smoke.py``'s encode signal (a tone, 9000
sin(t / 17), plus Gaussian noise of sd 1000, seed 0), once with the codes
one a byte and once packed, each timed by CUDA events over ``--iters``
launches after two. It prints one JSON line with the times, the card's name
and power limit. Run it from the root of each tree to compare two versions,
in turns, in one call to the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

import aad_tpu_torch as at
from aad_tpu_torch.ops import fused_encode as fe
from aad_tpu_torch.ops.transitions import CodecState


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lanes", type=int, nargs="+", default=[14518, 58066, 2])
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_lanes needs a CUDA device")
    cuda = torch.device("cuda", torch.cuda.current_device())
    geo = at.compute_block_geometry(1024, 2, 4)
    nspb = geo.num_samples_per_block
    rng = np.random.default_rng(0)
    times = {}
    for lanes in args.lanes:
        n = 4 * nspb * lanes
        x = (9000 * np.sin(np.arange(n) / 17.0) + rng.normal(0, 1000, n)).astype(np.int16)
        x = torch.from_numpy(x).to(cuda).reshape(4, nspb, lanes)
        state = CodecState.zeros((lanes,), cuda)
        valid = torch.full((4, lanes), nspb, dtype=torch.int32, device=cuda)
        for label, pack in (("one a byte", None), ("packed", geo)):
            def launch():
                fe.encode_stream_tm(x, valid, state, x[-1].flip(0).contiguous(), 4, 2, warm_on_prev=True,
                                    blocks_before=4, pack=pack)

            for _ in range(2):
                launch()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                launch()
            end.record()
            end.synchronize()
            times[f"{lanes} lanes, {label}"] = start.elapsed_time(end) / args.iters
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"launch_ms": times, "card": card[0] if card else "unknown"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
