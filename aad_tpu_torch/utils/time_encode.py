"""Host-clock time of one stream's sequential ``encode()`` on the card.

    python -m aad_tpu_torch.utils.time_encode [--seconds 60] [--iters 3]

The signal is ``chip_smoke.py``'s encode signal: a stereo 48 kHz tone
(9000 sin(t / 17), bench.py:404) plus Gaussian noise of sd 1000, seed 0,
4-bit, 1024-byte blocks, trials 2. After one warm-up call it times each of
``--iters`` calls, the card synchronised before and after, and prints one
JSON line: the seconds of each call, the output's sha256 (so that two trees
timed in one machine can be shown to give the same bytes), the card's name
and power limit. Run it from the root of each tree to compare two versions,
in turns, in one call to the card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import time

import numpy as np
import torch

import aad_tpu_torch as at


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=int, default=60)
    parser.add_argument("--iters", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_encode needs a CUDA device")
    rate = 48000
    n = rate * args.seconds
    rng = np.random.default_rng(0)
    tone = 9000 * np.sin(np.arange(n) / 17.0)
    pcm = np.clip(tone + rng.normal(0, 1000, (2, n)), -32768, 32767).astype(np.int16)
    cfg = at.EncodeConfig(2, rate, 4, 1024, 0, 2)
    out = at.encode(pcm, cfg, device="cuda")
    times = []
    for _ in range(args.iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        at.encode(pcm, cfg, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    print(json.dumps({"seconds": args.seconds, "call_s": times, "sha256": hashlib.sha256(out).hexdigest(),
                      "card": card[0] if card else "unknown"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
