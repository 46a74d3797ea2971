"""Batched multi-stream encode: many PCM streams in one device computation.

Encode chains state across blocks *within* a stream but is independent
across streams, so a pile runs in lockstep: block b of every stream encodes
together, with streams x channels on the kernel's lane axis (kernel 3,
``ops.fused_encode.encode_stream``, with lanes (S, C)). Streams of
different lengths share the launches through per-(block, stream) valid
counts: a stream's blocks past its end encode zeros and are dropped at
assembly, so each stream's bytes equal its solo encode.

The pipeline:

    S streams (C, n_s) --host-----> shape and int16-range checks, file headers;
                                    the (S, C, B * nspb) int16 pile, zero past
                                    each stream's end, in pinned memory
                       --H2D------> once
                       --device---> codec.encoder.encode_blocks, the core
                                    that a solo encode runs on lanes (C,),
                                    here on (S, C) lanes: kernel 3 (for a
                                    long pile in chunks of 64 blocks, kernel
                                    4 rebuilding the carry between them),
                                    block headers + packed units as
                                    (S, B, block_size) bytes
                       --D2H------> once; each stream's first nb_s blocks,
                                    its last one cut to its valid units

Not carried over from ``aad_tpu.codec.batch_encode``: the folded c-major
wire32 lane layout, a TPU tiling concern (a thread is a lane here, so
(S, C) lanes need no fold). ``engine="native"`` runs the native host
engine, one stream a thread (``aad_tpu_torch.native.encode_batch``).

PCM outside the int16 range raises InvalidFormatError, as ``Encoder.encode``
does. Such input is outside the contract of both packages, and
``aad_tpu``'s engines disagree on it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import native as native_engine
from ..format.geometry import num_blocks_for
from ..format.header import encode_header
from .device import resolve_device
from .encoder import EncodeConfig, as_int16, encode_blocks, payload_size, resolve_engine
from .result import InvalidArgumentError


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
    config.validate()
    native = native_engine.resolve(resolve_engine(engine))
    nch = config.num_channels
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
    nspb = geo.num_samples_per_block
    lengths = [pcm.shape[1] for pcm in arrays]
    S = len(arrays)
    B = max(num_blocks_for(n, nspb) for n in lengths)
    pile = _stage(arrays, B * nspb, device)
    # valid samples per (block, stream), broadcast over the channels
    starts = torch.arange(B, device=device)[:, None] * nspb
    valid = torch.clamp(torch.tensor(lengths, device=device)[None, :] - starts, 0, nspb).to(torch.int32)[..., None]
    blocks = pile.reshape(S, nch, B, nspb).permute(2, 0, 1, 3)  # (B, S, C, nspb), a view
    out = encode_blocks(blocks, valid, config, parallel_blocks, parallel_chunk_blocks, parallel_warm_passes)

    # one D2H, into pinned memory: a pageable copy of a pile's blocks runs
    # far slower (PERF.md)
    rows = out.transpose(0, 1).contiguous()  # (S, B, block_size)
    host = torch.empty(rows.shape, dtype=torch.uint8, pin_memory=device.type == "cuda")
    rows = host.copy_(rows).numpy()
    return [head + memoryview(rows[s].reshape(-1)[: payload_size(geo, n)])
            for s, (head, n) in enumerate(zip(file_headers, lengths))]


def _stage(arrays: list[np.ndarray], width: int, device: torch.device) -> torch.Tensor:
    """The (S, C, width) int16 pile on ``device``, each stream zero past its
    end: laid out on the host in one pinned buffer and copied at once (a
    pageable copy a stream costs the host more than the whole pile's copy;
    PERF.md)."""
    staged = torch.empty((len(arrays), arrays[0].shape[0], width), dtype=torch.int16,
                         pin_memory=device.type == "cuda")
    view = staged.numpy()
    for s, pcm in enumerate(arrays):
        view[s, :, : pcm.shape[1]] = pcm
        view[s, :, pcm.shape[1] :] = 0
    return staged.to(device, non_blocking=True)
