"""Host <-> card copies of the one-shot ``decode()`` and ``encode()``.

A one-shot call takes host bytes or PCM and returns host PCM or bytes, so
its copies cost more than its kernels (PERF.md). :class:`Transfer` runs them
in chunks beside the work on the card:

* host buffers are pinned (page-locked), so a copy is one DMA that returns
  at once, not a staged copy that holds the host;
* each chunk goes up on an upload stream, is worked on the caller's current
  stream (the compute stream, where the kernels launch) once its upload is
  done, and comes down on a download stream once its work is done, while
  the next chunk goes up and is worked;
* a tensor that one stream made and another uses is recorded on the second
  (``record_stream``), so that the allocator does not hand its memory out
  again before that stream is done with it.

On the CPU the same calls run in order, with plain buffers: the tests drive
the chunk logic there.

The host's own copies into the pinned buffers are large (a 10-minute stereo
stream's 115 MB of int16 samples), and one thread copies them several
times slower than the host's cores together (``utils/time_transfer.py``,
PERF.md), so :func:`host_parallel` splits them over threads: numpy
releases the GIL in copies and reductions.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import torch

from ..utils.trace import count, span

# Bytes a thread of host_parallel takes at least: below it, a thread costs
# more than it saves.
_THREAD_BYTES = 1 << 21


def host_parallel(part, n: int, unit_bytes: int) -> None:
    """Run ``part(lo, hi)`` over slices of ``range(n)`` that cover it once, on
    up to one thread a core, each slice at least ``_THREAD_BYTES`` (units of
    ``unit_bytes``); in the calling thread when one slice holds it all. An
    exception in a slice is raised here."""
    threads = max(1, min(os.cpu_count() or 1, n * unit_bytes // _THREAD_BYTES))
    if threads == 1:
        part(0, n)
        return
    edges = [n * i // threads for i in range(threads + 1)]
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(part, edges[:-1], edges[1:]))


class Transfer:
    """The copies of one call on ``device``: pinned host buffers, and on a
    card an upload and a download stream beside the current one."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.up = torch.cuda.Stream(device)
            self.down = torch.cuda.Stream(device)
        # on a card, an event a download call, recorded after its copies
        self.landed: list = []

    def host(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """An uninitialised host tensor, pinned when the device is a card.
        Torch's caching host allocator keeps freed pinned blocks for reuse,
        so only a call that needs more than before pays for pinning."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def upload(self, host: torch.Tensor) -> torch.Tensor:
        """A contiguous host tensor on the device, for work on the compute
        stream: the copy runs on the upload stream, and the compute stream's
        later work waits for it. On the CPU, ``host`` itself."""
        with span("aad.h2d"):
            count("h2d_bytes", host.nbytes)
            if not self.cuda:
                return host
            with torch.cuda.stream(self.up):
                dev = host.to(self.device, non_blocking=True)
        self.compute.wait_stream(self.up)
        dev.record_stream(self.compute)
        return dev

    def download(self, dev: torch.Tensor, host: torch.Tensor) -> None:
        """Copy ``dev`` into ``host`` (same shape; ``host`` contiguous, or 2-D
        with contiguous rows, copied a row at a time) once the compute
        stream's work so far is done. ``host`` holds the values after
        :meth:`finish`, or after :meth:`wait` of this call's index."""
        pairs = [(dev, host)] if host.is_contiguous() else list(zip(dev, host))
        with span("aad.d2h"):
            count("d2h_bytes", host.nbytes)
            if not self.cuda:
                for d, h in pairs:
                    h.copy_(d)
                return
            self.down.wait_stream(self.compute)
            with torch.cuda.stream(self.down):
                for d, h in pairs:
                    h.copy_(d, non_blocking=True)
            self.landed.append(self.down.record_event())
        dev.record_stream(self.down)

    def wait(self, k: int) -> None:
        """Wait until the copies of the ``k``-th :meth:`download` call (from
        0, in call order) have landed; on the CPU they already have."""
        if self.cuda:
            self.landed[k].synchronize()

    def finish(self) -> None:
        """Wait until every download has landed."""
        if self.cuda:
            self.down.synchronize()
