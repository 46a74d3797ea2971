"""Batched multi-stream decode: many .aad streams, one kernel launch per geometry.

Every block of every stream is an independent decode task, so a pile of
streams flattens into a few lane batches. Streams are grouped by what the
kernel takes as fixed (channel count, bit depth, block size, mid/side);
each group's blocks are stacked into one byte batch, uploaded once and
decoded by one launch, which parses the block headers and combines
mid/side itself (``Decoder``'s device pipeline).

Not carried over from ``aad_tpu.codec.batch``: the bucketing of the group's
block count, which exists only to reuse jit compiles, and the u32 view of
the wire's bytes (the kernel reads the bytes as they are).
``engine="native"`` runs the native host engine, one stream a thread
(``aad_tpu_torch.native.decode_batch``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import native as native_engine
from ..constants import CH_PROCESS_MS, FILE_HEADER_SIZE
from ..format.framing import pad_to_blocks
from ..format.geometry import geometry_from_header, num_blocks_for
from ..format.header import HeaderInfo, decode_header, validate_header
from ..ops.fused_decode import stepsize_corrections
from ..utils.trace import count, span
from .decoder import _decode_rows_pcm, resolve_engine, stream_bytes
from .device import resolve_device


def decode_batch(
    streams: Sequence[bytes | np.ndarray], device="cuda", engine: str = "auto"
) -> list[tuple[HeaderInfo, np.ndarray]]:
    """Decode many complete .aad streams, one kernel launch per geometry group.

    Returns a list of (header, pcm[C, N] int16 numpy) in input order. A
    payload shorter than its header declares decodes with the missing bytes
    as zeros, as ``aad_tpu.codec.batch.decode_batch`` does.

    ``engine="native"`` decodes on the host, one native decode a stream on a
    thread pool (a cut payload raises there, as in ``aad_tpu``). ``"auto"``
    stays on ``device``, where ``aad_tpu`` takes the native engine off the
    TPU: the port runs on the card unless the caller asks otherwise.
    """
    with span("aad.decode_batch"):
        native = native_engine.resolve(engine)
        if native is not None:
            return [(h, pcm.astype(np.int16)) for h, pcm in native.decode_batch(streams)]
        engine = resolve_engine(engine)
        device = resolve_device(device)
        if engine == "fused":
            stepsize_corrections(device)

        parsed = []
        for data in streams:
            buf = stream_bytes(data)
            header = decode_header(buf[:FILE_HEADER_SIZE].tobytes())
            validate_header(header)
            geo = geometry_from_header(header.num_channels, header.bits_per_sample, header.block_size)
            parsed.append((header, geo, buf[FILE_HEADER_SIZE:]))

        groups: dict[tuple, list[int]] = {}
        for i, (h, geo, _) in enumerate(parsed):
            key = (geo.num_channels, geo.bits_per_sample, geo.block_size, h.ch_process_method == CH_PROCESS_MS)
            groups.setdefault(key, []).append(i)

        results: list = [None] * len(parsed)
        for idxs in groups.values():
            header, geo, _ = parsed[idxs[0]]
            nspb = geo.num_samples_per_block
            spans, rows = [], []  # (first block, samples) per stream; (nb, block_size) byte rows
            start = 0
            with span("aad.frame.blocks"):
                for i in idxs:
                    h, _, payload = parsed[i]
                    nb = num_blocks_for(h.num_samples, nspb)
                    rows.append(pad_to_blocks(payload, nb, geo))
                    spans.append((start, h.num_samples))
                    start += nb
                rows = torch.cat(rows)
            with span("aad.h2d"):
                count("h2d_bytes", rows.nbytes)
                blocks = rows.to(device)
            with span("aad.decode.pcm"):
                pcm = _decode_rows_pcm(blocks, header, start * nspb, engine, geo)
            with span("aad.d2h"):
                count("d2h_bytes", pcm.nbytes)
                pcm = pcm.cpu().numpy()  # (C, start * nspb) int16
            for i, (b0, n) in zip(idxs, spans):
                results[i] = (parsed[i][0], pcm[:, b0 * nspb : b0 * nspb + n])
        return results
