"""Transcode: .aad -> .aad at a different bitrate or geometry, in one call.

The reference CLI reaches this only through two invocations (decode to WAV,
re-encode; reference: src/main.c modes -d then -e). Here the decode feeds
the encoder directly, with every encoder option available for the target
stream, as ``aad_tpu.codec.transcode`` does.
"""

from __future__ import annotations

import numpy as np

from .decoder import decode
from .encoder import EncodeConfig, encode


def transcode(
    data: bytes | np.ndarray,
    *,
    device="cuda",
    engine: str = "auto",
    bits_per_sample: int | None = None,
    max_block_size: int | None = None,
    ch_process_method: int | None = None,
    num_encode_trials: int = 2,
    parallel_blocks: bool = False,
    parallel_chunk_blocks: int = 1,
    parallel_warm_passes: int = 0,
) -> bytes:
    """Re-encode an .aad stream with new parameters, on ``device``.

    Unspecified parameters keep the source stream's values
    (``num_encode_trials`` defaults to the reference CLI's 2: the source
    stream does not record its trial count). ``engine`` selects the decode
    engine (see :class:`~aad_tpu_torch.codec.decoder.Decoder`); the encode
    runs on ``device``, but for ``engine="native"``, which runs both on the
    native host engine. Returns complete .aad bytes.
    """
    header, pcm = decode(data, device=device, engine=engine)
    cfg = EncodeConfig(
        num_channels=header.num_channels,
        sampling_rate=header.sampling_rate,
        bits_per_sample=header.bits_per_sample if bits_per_sample is None else bits_per_sample,
        max_block_size=header.block_size if max_block_size is None else max_block_size,
        ch_process_method=header.ch_process_method if ch_process_method is None else ch_process_method,
        num_encode_trials=num_encode_trials,
    )
    return encode(
        pcm.astype(np.int16), cfg, device=device, parallel_blocks=parallel_blocks,
        parallel_chunk_blocks=parallel_chunk_blocks, parallel_warm_passes=parallel_warm_passes,
        engine="native" if engine == "native" else "auto",
    )
