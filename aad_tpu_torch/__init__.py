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
    Encoder.from_config(config, device, ...) -> reusable encoder;
                                         encode_payload_ondevice stays on device
    StreamingEncoder(config, device, total_samples) -> push PCM chunks, get bytes
    EncodeConfig                      -> encoder parameters
    transcode(data, device=, engine=, bits_per_sample=, ...) -> .aad bytes
    encode_file(wav, aad, device=...) / decode_file(aad, wav, device=, engine=)
    decode_header / encode_header / validate_header / HeaderInfo
    compute_block_geometry / geometry_from_header / calculate_block_size

``device="cuda"`` runs the CUDA kernels (built with nvcc at first use);
``device="cpu"`` runs their plain torch versions. The decode ``engine`` is
``"auto"``/``"fused"`` (one kernel for the whole recurrence) or ``"pallas"``
(phase A as torch ops, then the LMS kernel), with ``aad_tpu``'s names.
"""

from .codec.batch import decode_batch
from .codec.decoder import Decoder, decode
from .codec.encoder import EncodeConfig, Encoder, encode
from .codec.streaming import StreamingDecoder, StreamingEncoder
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
    "StreamingDecoder",
    "StreamingEncoder",
    "calculate_block_size",
    "compute_block_geometry",
    "decode",
    "decode_batch",
    "decode_file",
    "decode_header",
    "encode",
    "encode_file",
    "encode_header",
    "encoded_stream_size",
    "geometry_from_header",
    "lenient_prefix",
    "transcode",
    "validate_header",
]
