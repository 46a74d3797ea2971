"""Batched multi-stream encode: many PCM streams in one device computation.

Encode chains state across blocks *within* a stream but is independent
across streams, so a pile runs in lockstep: block b of every stream encodes
together, with streams x channels on the kernel's lane axis (kernel 3,
``ops.fused_encode.encode_stream``, with lanes (S, C)). Streams of
different lengths share the launches through per-(block, stream) valid
counts: a stream's blocks past its end have valid 0, encode whatever the
staging buffer held there and are dropped at assembly, so each stream's
bytes equal its solo encode. The chain runs forward only, and a lane's
blocks past its end come after all of its kept ones, so they reach none of
its bytes; only the tail of a stream's last block is zeroed, since the
codes past its valid count are encoded from those samples.

The pipeline, for a pile long enough to run in chunks (``_OVERLAP_MIN_BLOCKS``
blocks and more, sequential; ``codec.encoder.encode_blocks`` with a
``codec.transfer.Transfer``), on the caller's thread:

    host:    check | stage 0 | stage 1 | stage 2 | ... | wait 0, bytes | wait 1, bytes | ...
    upload:            | up 0    | up 1    | up 2 ...
    device:                | chunk 0 ......| chunk 1 ......| chunk 2 ......| ...
    download:                              | down 0        | down 1        | ...

* check: shapes and the int16 range, the file headers;
* stage k: each stream's samples of chunk k's 64 blocks, one run a
  channel, into chunk k's region of the pinned int16 pile, laid out
  stream-major, (S, C, 64, nspb) (the chunks one after another, so a chunk
  is a contiguous slice and goes up in one copy); zeros only from a
  stream's last sample to the end of its last block, and nothing into the
  blocks wholly past its end; chunk k + 1 is laid out only once chunk k's
  upload and launches are queued, so the host's copy runs while the device
  runs;
* device: chunk k seen block-major, (64, S, C, nspb), a view of its
  upload, which kernel 3's relayout into its time-major layout takes as it
  is; its kernel 3 launch on (S, C) lanes, kernel 4 rebuilding the carry
  for the next chunk, the block headers, and the chunk's bytes made
  stream-major, (S, count * block_size);
* down k: those bytes in one copy into chunk k's own region of the pinned
  output (S * B * block_size bytes, chunk after chunk), then an event;
* once the last chunk is launched, the host walks the chunks in order,
  waits for chunk k's event (``aad.encode_batch.wait``), and builds the byte
  strings of the streams whose last block lies in chunk k, each in one copy
  (its file header joined with its rows of chunks 0 to k, the last one cut):
  those ending in early chunks are built while the device still runs the
  later ones.

A shorter pile, or ``parallel_blocks=True``, is one launch: the whole pile
staged stream-major as one chunk, (S, C, B * nspb), the same way, one
upload, one launch, one download queued behind it into pinned memory, then
the host's wait for that download's event (``aad.encode_batch.wait``, as a
chunk's) and the byte strings.
The counters ``pile_chunks``,
``pile_chunks_staged_ahead`` (chunks laid out while an earlier chunk was
queued on the device), ``pile_streams`` and
``pile_streams_assembled_early`` (byte strings built before the host
waited for the last chunk) say how often the overlap engages;
``pile_pad_bytes`` counts the pile's upload less its samples, and
``pile_zero_bytes`` the zeros the host wrote (the tails of the streams'
last blocks), in either layout.

Not carried over from ``aad_tpu.codec.batch_encode``: the folded c-major
wire32 lane layout, a TPU tiling concern (a thread is a lane here, so
(S, C) lanes need no fold). ``engine="native"`` runs the native host
engine, one stream a thread (``aad_tpu_torch.native.encode_batch``).

PCM outside the int16 range raises InvalidFormatError, as ``Encoder.encode``
does. Such input is outside the contract of both packages, and
``aad_tpu``'s engines disagree on it.
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np
import torch

from .. import native as native_engine
from ..format.geometry import num_blocks_for
from ..format.header import encode_header
from ..utils.trace import count, span
from .device import resolve_device
from .encoder import EncodeConfig, as_int16, encode_blocks, payload_size, resolve_engine, runs_in_chunks
from .result import InvalidArgumentError
from .transfer import Transfer


def encode_batch(
    streams: Sequence[np.ndarray],
    config: EncodeConfig,
    device="cuda",
    parallel_blocks: bool = False,
    parallel_chunk_blocks: int = 1,
    parallel_warm_passes: int = 0,
    engine: str = "auto",
) -> list[bytes]:
    """Encode a pile of (C, n_s) PCM streams under one configuration.

    Returns complete .aad byte strings in input order; each equals that
    stream's solo ``encode(pcm, config, device, ...)`` with the same knobs
    (with ``parallel_blocks=True``, its solo block-parallel encode; see
    :class:`aad_tpu_torch.codec.encoder.Encoder`), and
    ``aad_tpu.encode_batch(..., engine="scan")``.

    ``engine="native"`` encodes on the host after the same checks, one
    native encode a stream on a thread pool. ``"auto"`` stays on ``device``,
    where ``aad_tpu`` takes the native engine off the TPU: the port runs on
    the card unless the caller asks otherwise.
    """
    with span("aad.encode_batch"):
        config.validate()
        native = native_engine.resolve(resolve_engine(engine))
        nch = config.num_channels
        with span("aad.encode_batch.check"):
            arrays = []
            for pcm in streams:
                pcm = np.asarray(pcm)
                if pcm.ndim != 2 or pcm.shape[0] != nch:
                    raise InvalidArgumentError(f"stream must be ({nch}, N); got {pcm.shape}")
                arrays.append(pcm)
            if not arrays:
                return []
            # encode_header re-validates, with the header-time checks (num_samples > 0)
            file_headers = [encode_header(config.header_for(pcm.shape[1])) for pcm in arrays]
            arrays = [as_int16(pcm) for pcm in arrays]
        if native is not None:
            return native.encode_batch(arrays, config, parallel_blocks=parallel_blocks,
                                       chunk_blocks=parallel_chunk_blocks, warm_passes=parallel_warm_passes)

        device = resolve_device(device)
        geo = config.geometry()
        nspb, bs = geo.num_samples_per_block, geo.block_size
        lengths = [pcm.shape[1] for pcm in arrays]
        S = len(arrays)
        nbs = [num_blocks_for(n, nspb) for n in lengths]
        B = max(nbs)
        if runs_in_chunks(B, parallel_blocks):
            host, wait, chunks, zeros = _encode_in_chunks(arrays, config, B, device)
        else:
            host, wait, zeros = _encode_at_once(arrays, config, B, device, parallel_blocks,
                                                parallel_chunk_blocks, parallel_warm_passes)
            chunks = [(0, B)]
        count("pile_streams", S)
        count("pile_pad_bytes", (S * B * nspb - sum(lengths)) * nch * 2)  # the pile's upload less its samples
        count("pile_zero_bytes", zeros)
        # each chunk's (S, n * block_size) bytes, and the streams whose last block lies in it
        flat = host.numpy()
        rows = [flat[S * b0 * bs : S * (b0 + n) * bs].reshape(S, n * bs) for b0, n in chunks]
        ends = [b0 + n for b0, n in chunks]
        ending = [[] for _ in chunks]
        for s, nb in enumerate(nbs):
            ending[bisect.bisect_left(ends, nb)].append(s)
        out = [b""] * S
        for k, done in enumerate(ending):
            with span("aad.encode_batch.wait"):
                wait(k)
            with span("aad.encode_batch.assemble"):
                if k < len(chunks) - 1:
                    count("pile_streams_assembled_early", len(done))
                before = chunks[k][0] * bs  # a stream's payload bytes in chunks 0..k-1
                for s in done:
                    # one copy: the file header, the stream's rows of chunks 0..k-1, its cut of chunk k
                    out[s] = b"".join([file_headers[s], *(r[s] for r in rows[:k]),
                                       rows[k][s, : payload_size(geo, lengths[s]) - before]])
        return out


def _valid(arrays: list[np.ndarray], num_blocks: int, nspb: int, device: torch.device) -> torch.Tensor:
    """Valid samples per (block, stream), (B, S, 1) int32 on ``device``,
    broadcast over the channels."""
    starts = torch.arange(num_blocks, device=device)[:, None] * nspb
    lengths = torch.tensor([pcm.shape[1] for pcm in arrays], device=device)
    return torch.clamp(lengths[None, :] - starts, 0, nspb).to(torch.int32)[..., None]


def _encode_in_chunks(arrays: list[np.ndarray], config: EncodeConfig, B: int, device: torch.device):
    """A pile that runs in chunks, each staged while the device runs the one
    before, its bytes brought down into a flat pinned buffer (``encode_blocks``'
    pile output). Returns (the buffer, a function that waits for chunk k's
    bytes, the chunks' (first block, blocks) in launch order, the zero bytes
    staged)."""
    geo = config.geometry()
    nspb, S, C = geo.num_samples_per_block, len(arrays), config.num_channels
    xfer = Transfer(device)
    # chunk after chunk, each stream-major, so that a stream's samples of a chunk
    # go in as one run a channel (block-major, each block's run lands a chunk's
    # S * C * nspb samples from the last, and a pile lays out a third slower);
    # pinned, and torch's to reuse across calls
    pile = xfer.host((S * C * B * nspb,), torch.int16)
    host = xfer.host((S * B * geo.block_size,), torch.uint8)
    chunks, zeros = [], []

    def stage(b0: int, n: int) -> torch.Tensor:
        with span("aad.encode_batch.stage"):
            count("pile_chunks", 1)
            count("pile_chunks_staged_ahead", int(b0 > 0))
            chunk = pile[S * C * b0 * nspb : S * C * (b0 + n) * nspb].view(S, C, n, nspb)
            zeros.append(_stage_runs(arrays, chunk.numpy().reshape(S, C, n * nspb), b0 * nspb, nspb))
        chunks.append((b0, n))
        return chunk

    blocks = torch.empty((B, S, C, nspb), dtype=torch.int16, device="meta")  # the shape; stage gives the blocks
    encode_blocks(blocks, _valid(arrays, B, nspb, device), config, transfer=xfer, out=host, stage=stage)
    return host, xfer.wait, chunks, sum(zeros)


def _encode_at_once(arrays: list[np.ndarray], config: EncodeConfig, B: int, device: torch.device,
                    parallel_blocks: bool, parallel_chunk_blocks: int, parallel_warm_passes: int):
    """A pile of one launch: staged whole, one copy up, one launch, its bytes
    down in one copy queued behind it. Returns (a flat pinned buffer, S * B *
    block_size bytes, each stream's blocks a run; a function that waits for
    the copy down, as ``_encode_in_chunks``' does for chunk k; the zero bytes
    staged)."""
    geo = config.geometry()
    nspb, S = geo.num_samples_per_block, len(arrays)
    with span("aad.encode_batch.stage"):
        count("pile_chunks", 1)
        staged = torch.empty((S, config.num_channels, B * nspb), dtype=torch.int16, pin_memory=device.type == "cuda")
        zeros = _stage_runs(arrays, staged.numpy(), 0, nspb)
        with span("aad.h2d"):
            count("h2d_bytes", staged.nbytes)
            pile = staged.to(device, non_blocking=True)
    blocks = pile.view(S, config.num_channels, B, nspb).permute(2, 0, 1, 3)  # (B, S, C, nspb)
    rows = encode_blocks(blocks, _valid(arrays, B, nspb, device), config, parallel_blocks, parallel_chunk_blocks,
                         parallel_warm_passes)
    rows = rows.transpose(0, 1).contiguous()  # (S, B, block_size)
    host = torch.empty(rows.numel(), dtype=torch.uint8, pin_memory=device.type == "cuda")
    with span("aad.d2h"):
        count("d2h_bytes", rows.nbytes)
        host.view(rows.shape).copy_(rows, non_blocking=True)
    if device.type != "cuda":
        return host, lambda k: None, zeros  # the copy has landed
    landed = torch.cuda.current_stream(device).record_event()
    return host, lambda k: landed.synchronize(), zeros


def _stage_runs(arrays: list[np.ndarray], dst: np.ndarray, s0: int, nspb: int) -> int:
    """Each stream's samples from ``s0`` on into ``dst``, (S, C, n) int16
    stream-major (a pile's blocks [s0 / nspb, (s0 + n) / nspb)), one run a
    channel, and zeros from the stream's last sample to the end of its last
    block. Nothing is written past that: those blocks' valid counts are 0.
    Returns the zero bytes written."""
    zeros = 0
    for s, pcm in enumerate(arrays):
        m = max(0, min(pcm.shape[1] - s0, dst.shape[2]))  # the stream's samples here
        dst[s, :, :m] = pcm[:, s0 : s0 + m]
        tail = dst[s, :, m : m + -m % nspb]  # the rest of its last block, where that lies here
        tail[...] = 0
        zeros += tail.nbytes
    return zeros
