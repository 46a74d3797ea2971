"""Time the host side of the one-shot transfer paths on a machine with a card.

    python -m aad_tpu_torch.utils.time_transfer

A one-shot ``decode()`` or ``encode()`` copies its input into pinned host
memory before the card sees it (``codec.transfer``). This prints, by the
host clock (best and median of 9 runs, ms), that copy at the sizes of the
10-minute stereo benchmark stream, into pinned and into pageable memory,
on one thread and split over threads (numpy releases the GIL in a copy):
the payload's 29.7 MB of bytes (decode), and 57.6 M samples laid out as
int16 blocks of 992 from int16 and from int32 PCM (encode), with the int16
range check of int32 PCM. Needs a CUDA card (for pinned memory).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

RUNS = 9


def _ms(fn) -> tuple[float, float]:
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), sorted(times)[RUNS // 2]


def _split(pool, threads: int, n: int, part) -> None:
    """part(lo, hi) over ``threads`` slices of range(n), on the pool."""
    edges = np.linspace(0, n, threads + 1).astype(int)
    list(pool.map(lambda i: part(edges[i], edges[i + 1]), range(threads)))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_transfer: needs a CUDA card (pinned memory)")
    cores = os.cpu_count() or 1
    rng = np.random.default_rng(0)
    C, n, nspb = 2, 28_800_000, 992
    full = n // nspb
    payload = rng.integers(0, 256, 29_729_056, dtype=np.uint8)
    pcm16 = rng.integers(-32768, 32768, (C, n)).astype(np.int16)
    pcm32 = pcm16.astype(np.int32)
    print(f"[host] {torch.cuda.get_device_name(0)}; {cores} cores; torch {torch.__version__}, "
          f"{torch.get_num_threads()} intra-op threads")
    with ThreadPoolExecutor(cores) as pool:
        for pinned in (True, False):
            where = "pinned" if pinned else "pageable"
            staged = torch.empty(payload.size, dtype=torch.uint8, pin_memory=pinned).numpy()
            blocks = torch.empty((full, C, nspb), dtype=torch.int16, pin_memory=pinned).numpy()
            layout = blocks.transpose(1, 0, 2)
            src16 = pcm16[:, : full * nspb].reshape(C, full, nspb)
            src32 = pcm32[:, : full * nspb].reshape(C, full, nspb)
            for threads in sorted({1, 2, 4, cores}):
                rows = [
                    ("payload bytes, contiguous", lambda lo, hi: np.copyto(staged[lo:hi], payload[lo:hi]),
                     payload.size),
                    ("int16 PCM into int16 blocks", lambda lo, hi: np.copyto(layout[:, lo:hi], src16[:, lo:hi]),
                     full),
                    ("int32 PCM into int16 blocks", lambda lo, hi: np.copyto(
                        layout[:, lo:hi], src32[:, lo:hi], casting="unsafe"), full),
                    ("range check of int32 PCM", lambda lo, hi: (src32[:, lo:hi].min(), src32[:, lo:hi].max()),
                     full),
                ]
                for label, part, size in rows:
                    best, median = _ms(lambda: _split(pool, threads, size, part))
                    print(f"[host] {label} into {where} memory, {threads} thread(s): best {best:.3f} ms, "
                          f"median {median:.3f} ms")
            best, median = _ms(lambda: torch.from_numpy(layout).copy_(torch.from_numpy(src16)))
            print(f"[host] int16 PCM into int16 blocks into {where} memory, torch copy_: best {best:.3f} ms, "
                  f"median {median:.3f} ms")


if __name__ == "__main__":
    main()
