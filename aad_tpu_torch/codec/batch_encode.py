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

Every pile takes one pipeline, on the caller's thread, in the chunks of
``codec.encoder.encode_blocks``: 64 blocks a chunk, chaining the carry, for
a sequential pile of ``_OVERLAP_MIN_BLOCKS`` blocks and more; one chunk of
B blocks for a shorter pile or with ``parallel_blocks=True``.

    host:    check | stage 0 | stage 1 | stage 2 | ... | wait 0, bytes | wait 1, bytes | ...
    upload:            | up 0    | up 1    | up 2 ...
    device:                | chunk 0 ......| chunk 1 ......| chunk 2 ......| ...
    download:                              | down 0        | down 1        | ...

* check: shapes and the int16 range, the file headers;
* stage k: each stream's samples of chunk k's blocks, one run a channel,
  into chunk k's region of the pinned int16 pile; zeros only from a
  stream's last sample to the end of its last block, and nothing into the
  blocks wholly past its end; then the chunk's upload is queued
  (``codec.transfer.Transfer``). Chunk k + 1 is laid out only once chunk
  k's launches and download are queued, so the host's copy runs while the
  device runs;
* device: chunk k's kernel 3 launch on (S, C) lanes, kernel 4 rebuilding
  the carry for the next chunk, the block headers, and the chunk's bytes
  made stream-major;
* down k: those bytes in one copy into chunk k's own region of the pinned
  output, then an event;
* once the last chunk is launched, the host walks the chunks in order,
  waits for chunk k's event (``aad.encode_batch.wait``), and builds the byte
  strings of the streams whose last block lies in chunk k, each in one copy
  (its file header joined with its rows of chunks 0 to k, the last one cut):
  those ending in early chunks are built while the device still runs the
  later ones.

The pile's layout: both pinned buffers hold the chunks one after another,
each chunk stream-major, so that a chunk is a contiguous slice that crosses
in one copy and a stream's samples of a chunk are one run a channel. Chunk
k, blocks [b0, b0 + n), is (S, C, n, nspb) int16 from sample S * C * b0 *
nspb of the pile, seen on the device block-major, (n, S, C, nspb), a view
of its upload, which kernel 3's relayout into its time-major layout takes
as it is; its bytes are (S, n * block_size) from byte S * b0 * block_size
of the output (S * B * block_size bytes).

The counters ``pile_chunks``,
``pile_chunks_staged_ahead`` (chunks laid out while an earlier chunk was
queued on the device), ``pile_streams`` and
``pile_streams_assembled_early`` (byte strings built before the host
waited for the last chunk) say how often the overlap engages;
``pile_pad_bytes`` counts the pile's upload less its samples, and
``pile_zero_bytes`` the zeros the host wrote (the tails of the streams'
last blocks).

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
from .encoder import EncodeConfig, as_int16, encode_blocks, payload_size, resolve_engine
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
        xfer = Transfer(device)
        # pinned, and torch's to reuse across calls; laid out as the module docstring says
        pile = xfer.host((S * nch * B * nspb,), torch.int16)
        host = xfer.host((S * B * bs,), torch.uint8)
        zeros = []

        def stage(b0: int, n: int) -> torch.Tensor:
            with span("aad.encode_batch.stage"):
                count("pile_chunks", 1)
                count("pile_chunks_staged_ahead", int(b0 > 0))
                chunk = pile[S * nch * b0 * nspb : S * nch * (b0 + n) * nspb].view(S, nch, n, nspb)
                zeros.append(_stage_runs(arrays, chunk.numpy().reshape(S, nch, n * nspb), b0 * nspb, nspb))
                return xfer.upload(chunk).permute(2, 0, 1, 3)

        chunks = []  # (first block, blocks), in launch order
        for b0, got in encode_blocks(stage, _valid(arrays, B, nspb, device), config, parallel_blocks,
                                     parallel_chunk_blocks, parallel_warm_passes):
            n = got.shape[0]
            xfer.download(got.transpose(0, 1).reshape(S, n * bs),
                          host[S * b0 * bs : S * (b0 + n) * bs].view(S, n * bs))
            chunks.append((b0, n))
        count("pile_streams", S)
        count("pile_pad_bytes", (S * B * nspb - sum(lengths)) * nch * 2)  # the pile's upload less its samples
        count("pile_zero_bytes", sum(zeros))
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
                xfer.wait(k)
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
