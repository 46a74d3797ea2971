"""aad_tpu_torch — the AAD codec's decode and encode paths in PyTorch, with
CUDA kernels for Hopper.

A port of ``aad_tpu`` (JAX/Pallas) to PyTorch and hand-written CUDA C++ for
the H100 (``sm_90a``). It keeps ``aad_tpu``'s module names, decodes
bit-identically to it and encodes to the same bytes as its scan engine. It
imports torch and numpy only, never jax or ``aad_tpu``.

Public surface:

    decode(data, device="cuda", engine="auto") -> (HeaderInfo, pcm[C, N] int32)
    Decoder.from_header(h, device, engine)     -> reusable decoder; output stays
                                         on device; decode_block_range /
                                         decode_time_range for seeks
    decode_batch(streams, device, engine) -> [(HeaderInfo, pcm[C, N] int16)],
                                         one kernel launch per geometry
    StreamingDecoder(device, engine)  -> push bytes, get samples per whole block
    encode(pcm, config, device="cuda", parallel_blocks=False, ...) -> .aad bytes
    encode_batch(streams, config, device="cuda", ...) -> [.aad bytes], a pile of
                                         streams on the kernel's lanes
    Encoder.from_config(config, device, ...) -> reusable encoder;
                                         encode_payload_ondevice stays on device
    StreamingEncoder(config, device, total_samples) -> push PCM chunks, get bytes
    StreamingEncoderBank(config, slots, device) -> many live feeds, a tick of pushes
                                         at once: one upload, kernels 3 and 4 once
                                         and one copy down a tick on a card
    EncodeConfig                      -> encoder parameters
    transcode(data, device=, engine=, bits_per_sample=, ...) -> .aad bytes
    encode_file(wav, aad, device=...) / decode_file(aad, wav, device=, engine=)
    decode_header / encode_header / validate_header / HeaderInfo
    compute_block_geometry / geometry_from_header / calculate_block_size
    QualityStats / quality_stats / roundtrip_stats / self_check (utils.quality)
    native                            -> the native host engine (the port's copy
                                         of aad_tpu's aadx.cc), also engine="native"
                                         of the entry points above
    python -m aad_tpu_torch.cli       -> the reference CLI's six modes
    parallel.sharded                  -> make_mesh, decode_blocks_sharded,
                                         encode_streams_sharded,
                                         encode_blocks_parallel_sharded, gather:
                                         a (dp, sp) mesh of this process's devices

``device="cuda"`` runs the CUDA kernels (built with nvcc at first use);
``device="cpu"`` runs their plain torch versions. The decode ``engine`` is
``"auto"``/``"fused"`` (one kernel for the whole recurrence) or ``"pallas"``
(phase A as torch ops, then the LMS kernel), with ``aad_tpu``'s names, or
``"native"``; ``"auto"`` never selects the native engine.
"""

from . import native

from .codec.batch import decode_batch
from .codec.batch_encode import encode_batch
from .codec.decoder import Decoder, decode
from .codec.encoder import EncodeConfig, Encoder, encode
from .codec.streaming import StreamingDecoder, StreamingEncoder, StreamingEncoderBank
from .codec.transcode import transcode
from .codec.result import (
    AadError,
    ApiResult,
    InsufficientBufferError,
    InsufficientDataError,
    InvalidArgumentError,
    InvalidFormatError,
)
from .constants import (
    CH_PROCESS_MS,
    CH_PROCESS_NONE,
    CODEC_VERSION,
    FILE_HEADER_SIZE,
    FILTER_ORDER,
    FORMAT_VERSION,
    MAX_BITS_PER_SAMPLE,
    MAX_NUM_CHANNELS,
    MIN_BITS_PER_SAMPLE,
)
from .format.geometry import (
    BlockGeometry,
    calculate_block_size,
    compute_block_geometry,
    encoded_stream_size,
    geometry_from_header,
    lenient_prefix,
)
from .format.header import HeaderInfo, decode_header, encode_header, validate_header
from .io import decode_file, encode_file
from .utils.quality import QualityStats, quality_stats, roundtrip_stats, self_check

__version__ = "0.1.0"

__all__ = [
    "AadError",
    "ApiResult",
    "BlockGeometry",
    "CH_PROCESS_MS",
    "CH_PROCESS_NONE",
    "CODEC_VERSION",
    "Decoder",
    "EncodeConfig",
    "Encoder",
    "FILE_HEADER_SIZE",
    "FILTER_ORDER",
    "FORMAT_VERSION",
    "HeaderInfo",
    "InsufficientBufferError",
    "InsufficientDataError",
    "InvalidArgumentError",
    "InvalidFormatError",
    "MAX_BITS_PER_SAMPLE",
    "MAX_NUM_CHANNELS",
    "MIN_BITS_PER_SAMPLE",
    "QualityStats",
    "StreamingDecoder",
    "StreamingEncoder",
    "StreamingEncoderBank",
    "calculate_block_size",
    "compute_block_geometry",
    "decode",
    "decode_batch",
    "decode_file",
    "decode_header",
    "encode",
    "encode_batch",
    "encode_file",
    "encode_header",
    "encoded_stream_size",
    "geometry_from_header",
    "lenient_prefix",
    "native",
    "quality_stats",
    "roundtrip_stats",
    "self_check",
    "transcode",
    "validate_header",
]
