"""The program's spans and counters, recorded only while torch.profiler records.

``span(name)`` marks a stretch of the calling thread's host work: the API
entries, the host's framing and staging, each host <-> device copy and each
kernel launch. ``count(name, n)`` adds ``n`` to :data:`counts`. The running
profiler is the only switch: where none records on the calling thread
(``torch.autograd._profiler_enabled()`` is per thread, so a thread that the
caller starts records nothing), both do nothing beyond that one check.

Where one records, a span is a ``torch._C._profiler._RecordFunctionFast``: a
``cpu_op`` on the profiler's host timeline, on the clock of the device's
operations, with no image on the device's timeline (a ``record_function``
annotation has one, and would read as a device operation). So a trace
(``utils.profiling.trace``) puts every idle stretch of the card down to the
span that the host was in. Spans nest as the calls nest; every name starts
with ``aad.``:

* API entries: ``aad.encode_batch``, ``aad.decode_batch``,
  ``aad.stream_decode.push`` (``StreamingDecoder.push``),
  ``aad.stream_encode.push`` and ``aad.stream_encode.finish``
  (``StreamingEncoder.push`` and ``.finish``), ``aad.stream_encode.bank``
  (a tick of ``StreamingEncoderBank.push``), ``aad.decode``,
  ``aad.encode``, ``aad.encode_streams_sharded``,
  ``aad.decode_blocks_sharded``, ``aad.encode_blocks_parallel_sharded``;
* host framing and staging: ``aad.encode_batch.check`` (shapes, int16
  range, file headers), ``aad.encode_batch.stage`` (a chunk of the pinned
  pile), ``aad.encode_batch.wait`` (the host's wait for a chunk's bytes, or for
  a pile of one launch, its kernel and its one copy down),
  ``aad.encode_batch.assemble`` (the byte strings of the streams that end
  in that chunk), ``aad.push.frame`` (the
  byte queue and the block rows of a push), ``aad.push.buffer`` (a
  ``StreamingEncoder``'s host buffer: the push's samples joined to it,
  its whole blocks cut off), ``aad.stream_encode.blocks`` (the encode of
  those blocks: on a card kernel 3's launch in its wire mode, which pads,
  combines mid/side and writes the block bytes itself, and kernel 4's for
  the carry; on the CPU the padding, mid/side, encode and block bytes as
  torch ops), ``aad.bank.stage`` (a bank tick's samples put after its
  remainders in the pinned upload, its whole blocks cut, the table of its
  feeds filled), ``aad.bank.blocks`` (the tick's encode: on a card kernel
  3's launch in its bank mode and kernel 4's, whatever the number of
  feeds; on the CPU their plain version), ``aad.bank.split`` (while the
  card encodes: the tick's remainders moved into the other of the bank's
  two uploads, its counts and finished feeds' lengths kept; its payloads
  come back by slot after it, in ``aad.d2h``),
  ``aad.frame.blocks`` (the
  block rows' view of the payload, ``Decoder._decode_prefix``; a
  ``decode_batch``'s per-stream rows), ``aad.decode.pcm`` (the decode of
  the rows: on a card the decode kernel's launch, which parses the block
  headers and combines mid/side itself; on the CPU, or under the
  ``pallas`` engine, the header parse, lane reorders and mid/side as torch
  ops), ``aad.sharded.scatter`` (every shard's input copies);
* copies: ``aad.h2d`` and ``aad.d2h``, each counting the bytes it moves as
  ``h2d_bytes`` and ``d2h_bytes`` (on a CPU device, where the copy is none,
  the bytes it would move); a synchronous copy's span holds the host's wait
  for the device;
* ``encode_batch``'s pile counters: ``pile_chunks`` (chunks staged),
  ``pile_chunks_staged_ahead`` (of them, those staged while an earlier
  chunk was queued on the device), ``pile_streams`` (streams encoded),
  ``pile_streams_assembled_early`` (of them, those whose byte strings were
  built before the host waited for the pile's last chunk),
  ``pile_pad_bytes`` (the pile's upload less its samples) and
  ``pile_zero_bytes`` (the zeros the host wrote into it: the tails of the
  streams' last blocks);
* ``StreamingEncoder``'s counters: ``stream_encode_blocks`` (blocks
  encoded by pushes and finishes), ``stream_encode_carried`` (of those
  calls, the ones that rebuilt the carry: on a card, kernel 4's launch)
  and ``stream_encode_idle_pushes`` (pushes that encoded no block, and so
  did no device work);
* ``StreamingEncoderBank``'s counters, a tick: ``bank_feeds`` (slots
  pushed: samples or a finish), ``bank_blocks`` (blocks written),
  ``bank_started`` (feeds encoded with no carry: a feed's first blocks),
  ``bank_finished`` (feeds ended) and ``bank_idle_feeds`` (slots pushed
  that completed no block);
* kernel 1's counters, on a card only (``ops.fused_decode.decode_rows``):
  ``k1_rows_parsed`` (blocks whose headers the kernel parsed itself) and
  ``k1_rows_ms`` (of them, those whose left/right it combined);
* kernel 3's counters, on a card only (``ops.fused_encode.encode_wire``
  and ``encode_bank``):
  ``k3_rows_written`` (blocks whose whole wire bytes, header and data
  region, the kernel wrote itself) and ``k3_rows_ms`` (of them, those whose
  mid/side it combined);
* kernel launches, on a card only: ``aad.launch.decode_lanes``,
  ``aad.launch.stepsize_probe``, ``aad.launch.encode_stream``,
  ``aad.launch.encode_pass``, ``aad.launch.lms_lanes``.

Nothing else here records, times or prints. The kernel wrappers' ``launches``
dicts count launches whether or not a profiler records.
"""

from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

# Totals over every traced stretch of the process, by counter name.
counts: dict[str, int] = {}

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a ``cpu_op`` around its
    body while a profiler records on this thread; else one that does
    nothing."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _OFF


def recording() -> bool:
    """Whether a profiler records on this thread: a caller whose counts cost
    work of their own computes them only then."""
    return _profiler_enabled()


def count(name: str, n: int) -> None:
    """Add ``n`` to ``counts[name]`` while a profiler records on this thread."""
    if _profiler_enabled():
        counts[name] = counts.get(name, 0) + int(n)
