"""File-level conveniences: WAV <-> .aad in one call, on a torch device.

These mirror the reference CLI's encode and decode modes as library
functions (16-bit ingest truncation included, reference: src/main.c:177),
as ``aad_tpu.io`` does.
"""

from __future__ import annotations

import numpy as np

from .codec.decoder import decode
from .codec.encoder import EncodeConfig, encode
from .format.header import HeaderInfo
from .format.wav import WavFormat, read_wav, write_wav


def encode_file(
    wav_path: str,
    aad_path: str,
    *,
    bits_per_sample: int = 4,
    max_block_size: int = 1024,
    ms: bool = False,
    num_encode_trials: int = 2,
    device="cuda",
    engine: str = "auto",
) -> HeaderInfo:
    """WAV file -> .aad file, encoded on ``device`` (``engine="native"``: by
    the native host engine); returns the written stream header."""
    fmt, canonical = read_wav(wav_path)
    pcm = (canonical >> 16).astype(np.int16)
    cfg = EncodeConfig(
        num_channels=fmt.num_channels,
        sampling_rate=fmt.sampling_rate,
        bits_per_sample=bits_per_sample,
        max_block_size=max_block_size,
        ch_process_method=1 if ms else 0,
        num_encode_trials=num_encode_trials,
    )
    data = encode(pcm, cfg, device=device, engine=engine)
    with open(aad_path, "wb") as f:
        f.write(data)
    return cfg.header_for(pcm.shape[1])


def decode_file(aad_path: str, wav_path: str, device="cuda", engine: str = "auto") -> HeaderInfo:
    """.aad file -> 16-bit WAV file, decoded on ``device`` by ``engine`` (as
    :func:`~aad_tpu_torch.codec.decoder.decode`); returns the stream header."""
    with open(aad_path, "rb") as f:
        data = f.read()
    header, pcm = decode(data, device=device, engine=engine)
    fmt = WavFormat(
        num_channels=header.num_channels,
        sampling_rate=header.sampling_rate,
        bits_per_sample=16,
        num_samples=header.num_samples,
    )
    write_wav(wav_path, fmt, pcm << 16)
    return header
