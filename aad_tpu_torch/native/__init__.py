"""The native host engine: ctypes bindings for the port's own copy of libaadx.

``aadx.cc``/``aadx.h`` here are a copy of ``aad_tpu``'s framework-free C++
codec (``aad_tpu/native``): an independent implementation of the format, with
an AVX-512 path and a scalar one (``AADX_FORCE_SCALAR=1`` forces the scalar
one, read per call). It runs on the host, not on the card.

At first use it is built with the host C++ compiler (``CXX``, else ``g++``)
and the flags of ``aad_tpu``'s Makefile into
``build/aad_tpu_torch/<hash>/libaadx.so``, keyed by a hash of the sources,
compiler and flags, under the kernels' file lock (``ops._build.build_locked``).
``AAD_TPU_NATIVE_LIB`` names a prebuilt library in its place; a path that
does not exist raises. A failed build raises :class:`NativeBuildError` with
the compiler's output: nothing falls back.

Callers select it with ``engine="native"``. ``"auto"`` never does: the
port's entry points run on the card unless asked otherwise (``device``), so
this engine serves only callers who name it. ``decode_batch`` and
``encode_batch`` run one GIL-free C call a stream on a thread pool (ctypes
releases the GIL for the call).

Usage:
    from aad_tpu_torch import native
    data = native.encode(pcm, config)
    header, pcm = native.decode(data)
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..codec.result import (
    AadError,
    ApiResult,
    InsufficientBufferError,
    InsufficientDataError,
    InvalidArgumentError,
    InvalidFormatError,
)
from ..format.header import HeaderInfo
from ..ops import _build

SOURCES = tuple(pathlib.Path(__file__).resolve().parent / name for name in ("aadx.cc", "aadx.h"))
LIB_NAME = "libaadx.so"
# aad_tpu/native/Makefile's flags; -fwrapv: the format's semantics are
# two's-complement int32 wraparound.
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-fwrapv", "-Wall", "-Wextra", "-shared")


class NativeBuildError(RuntimeError):
    """The host C++ compiler is missing, or libaadx did not compile or load."""


class _AadxInfo(ctypes.Structure):
    _fields_ = [
        ("format_version", ctypes.c_uint32),
        ("codec_version", ctypes.c_uint32),
        ("num_channels", ctypes.c_uint32),
        ("num_samples", ctypes.c_uint32),
        ("sampling_rate", ctypes.c_uint32),
        ("bits_per_sample", ctypes.c_uint32),
        ("block_size", ctypes.c_uint32),
        ("num_samples_per_block", ctypes.c_uint32),
        ("ch_process_method", ctypes.c_uint32),
    ]


# aadx's status codes (aadx.h: AadxStatus) -> the port's exceptions
_ERRORS = {
    1: InvalidArgumentError,
    2: InvalidFormatError,
    3: InsufficientBufferError,
    4: InsufficientDataError,
}

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U32 = ctypes.c_uint32
_SZ = ctypes.c_size_t
_INFOP = ctypes.POINTER(_AadxInfo)
# Full argtypes, not only restypes: the entries take size_t, and an
# undeclared Python int crosses as a 32-bit int whose upper half is undefined.
_SIGNATURES = {
    "aadx_parse_header": (ctypes.c_int, [_U8P, _SZ, _INFOP]),
    "aadx_decode": (ctypes.c_int, [_U8P, _SZ, _I32P, _SZ, _INFOP]),
    "aadx_encode": (ctypes.c_int, [_I32P, *(_U32,) * 7, _U8P, _SZ, ctypes.POINTER(_SZ)]),
    "aadx_encode_parallel": (ctypes.c_int, [_I32P, *(_U32,) * 9, _U8P, _SZ, ctypes.POINTER(_SZ)]),
    "aadx_encode_bound": (_SZ, [_U32, _U32, _U32, _U32]),
    "aadx_block_geometry": (ctypes.c_int, [_U32, _U32, _U32, _U32P, _U32P]),
    "aadx_encode_chunk": (ctypes.c_int, [_I32P, *(_U32,) * 8, _I32P, _I32P, _U8P, _SZ, ctypes.POINTER(_SZ)]),
    "aadx_decode_blocks": (ctypes.c_int, [_U8P, _SZ, _U32, _I32P, _SZ, _INFOP]),
}


def _raise(rc: int, where: str) -> None:
    if rc == 0:
        return
    exc = _ERRORS.get(rc)
    if exc is None:
        raise AadError(ApiResult.NG, f"{where}: native status {rc}")
    raise exc(f"{where} (native)")


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise NativeBuildError(f"host C++ compiler {cxx!r} not found (CXX, else g++)")
    return found


def build(build_dir: pathlib.Path = _build.BUILD_DIR) -> pathlib.Path:
    """Compile libaadx if this hash of sources, compiler and flags has none
    yet; return its path. Raises NativeBuildError with the compiler's output."""
    cxx = _compiler()
    out_dir = build_dir / _build.source_hash((cxx, *CXX_FLAGS), SOURCES)

    def stages(tmp: pathlib.Path, tag: int) -> list[list[list[str]]]:
        return [[[cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCES[0])]]]

    return _build.build_locked(out_dir, LIB_NAME, stages, NativeBuildError)


@functools.cache
def library() -> ctypes.CDLL:
    """libaadx, built at first use (or ``AAD_TPU_NATIVE_LIB``), loaded once
    per process with its argtypes set."""
    override = os.environ.get("AAD_TPU_NATIVE_LIB")
    if override:
        path = pathlib.Path(override)
        if not path.exists():
            raise FileNotFoundError(f"AAD_TPU_NATIVE_LIB={override!r} does not exist")
    else:
        path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeBuildError(f"cannot load {path}: {e}") from e
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    """True when the library builds (or is built) and loads."""
    try:
        library()
    except NativeBuildError:
        return False
    return True


def resolve(engine: str):
    """This module for ``engine="native"`` (built and loaded, or raising
    NativeBuildError), None for any other engine: ``"auto"`` stays on the
    caller's ``device``."""
    if engine != "native":
        return None
    library()
    return sys.modules[__name__]


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _i32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _as_header(info: _AadxInfo) -> HeaderInfo:
    return HeaderInfo(**{name: getattr(info, name) for name, _ in _AadxInfo._fields_})


def _stream(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)


def decode(data) -> tuple[HeaderInfo, np.ndarray]:
    """Whole-stream decode; the contract of ``aad_tpu_torch.decode`` (strict):
    (header, (C, N) int32 in the int16 range)."""
    lib = library()
    buf = _stream(data)
    info = _AadxInfo()
    _raise(lib.aadx_parse_header(_u8(buf), buf.size, ctypes.byref(info)), "parse_header")
    out = np.empty(info.num_channels * info.num_samples, dtype=np.int32)
    _raise(lib.aadx_decode(_u8(buf), buf.size, _i32(out), out.size, ctypes.byref(info)), "decode")
    return _as_header(info), out.reshape(info.num_channels, info.num_samples)


def _check_pcm(pcm, config) -> np.ndarray:
    """pcm as C-contiguous (config.num_channels, N) int32: the C entry takes
    the geometry from the array's shape, so a mismatched config raises here."""
    pcm = np.ascontiguousarray(pcm, dtype=np.int32)
    if pcm.ndim != 2 or pcm.shape[0] != config.num_channels:
        raise InvalidArgumentError(f"pcm must be ({config.num_channels}, N); got {pcm.shape}")
    return pcm


def _encode_call(fn, pcm: np.ndarray, config, *extra) -> bytes:
    """Run one of the encode entries into a buffer of aadx_encode_bound bytes."""
    lib = library()
    nch, n = pcm.shape
    bound = lib.aadx_encode_bound(nch, n, config.bits_per_sample, config.max_block_size)
    if bound == 0:
        raise InvalidFormatError("bad encode parameters (native)")
    out = np.empty(bound, dtype=np.uint8)
    size = _SZ()
    rc = getattr(lib, fn)(
        _i32(pcm), nch, n, config.sampling_rate, config.bits_per_sample, config.max_block_size,
        config.ch_process_method, config.num_encode_trials, *extra, _u8(out), out.size, ctypes.byref(size),
    )
    _raise(rc, fn[len("aadx_"):])
    return out[: size.value].tobytes()


def encode(pcm, config) -> bytes:
    """Whole-stream sequential encode; the bytes of ``aad_tpu_torch.encode``."""
    return _encode_call("aadx_encode", _check_pcm(pcm, config), config)


def encode_parallel(pcm, config, chunk_blocks: int = 1, warm_passes: int = 0) -> bytes:
    """Block-independent (parallel-mode) encode, equal to
    ``aad_tpu_torch.encode(pcm, config, parallel_blocks=True,
    parallel_chunk_blocks=chunk_blocks, parallel_warm_passes=warm_passes)``:
    chunks of ``chunk_blocks`` blocks encode in sequence within and in
    parallel across (the AVX-512 lanes); ``warm_passes`` adds the chunk-head
    refinement passes."""
    if chunk_blocks < 1:
        raise InvalidArgumentError(f"chunk_blocks must be >= 1: {chunk_blocks}")
    if warm_passes < 0:
        raise InvalidArgumentError(f"warm_passes must be >= 0: {warm_passes}")
    return _encode_call("aadx_encode_parallel", _check_pcm(pcm, config), config, chunk_blocks, warm_passes)


def stream_state(config) -> tuple[np.ndarray, np.ndarray]:
    """A fresh (state, prev) carry for :func:`encode_chunk`: state (C, 9)
    int32, h[4], w[4] and the step index of each channel; prev (C, nspb)
    int32, the previous block after the channel transform. encode_chunk
    updates both in place."""
    nspb = config.geometry().num_samples_per_block
    return (np.zeros((config.num_channels, 9), dtype=np.int32),
            np.zeros((config.num_channels, nspb), dtype=np.int32))


def encode_chunk(pcm, config, state: np.ndarray, prev: np.ndarray, blocks_before: int) -> bytes:
    """Encode one chunk of a stream, continuing the chain in (state, prev);
    returns its payload bytes (no file header).

    Every chunk but the stream's last must be whole blocks: a short chunk
    encodes as the stream's last block. The carry's step index is clamped to
    [0, 4080] on load, where the port's kernels clamp the table slot.
    """
    pcm = _check_pcm(pcm, config)
    nch = pcm.shape[0]
    nspb = config.geometry().num_samples_per_block
    for name, a, shape in (("state", state, (nch, 9)), ("prev", prev, (nch, nspb))):
        # the C entry writes (nch, 9) and (nch, nspb) int32 back into them
        if not (isinstance(a, np.ndarray) and a.dtype == np.int32 and a.flags.c_contiguous and a.shape == shape):
            raise InvalidArgumentError(
                f"carry {name} must be a C-contiguous int32 array of shape {shape} (use stream_state(config))"
            )
    return _encode_call("aadx_encode_chunk", pcm, config, blocks_before, _i32(state), _i32(prev))


def decode_payload_blocks(payload, header: HeaderInfo, num_samples: int) -> np.ndarray:
    """Decode whole blocks of a headerless payload span (the last may be
    zero-padded to block_size) to (C, num_samples) int32."""
    lib = library()
    buf = np.ascontiguousarray(payload, dtype=np.uint8)
    info = _AadxInfo(**{name: getattr(header, name) for name, _ in _AadxInfo._fields_})
    out = np.empty(header.num_channels * num_samples, dtype=np.int32)
    rc = lib.aadx_decode_blocks(_u8(buf), buf.size, num_samples, _i32(out), out.size, ctypes.byref(info))
    _raise(rc, "decode_blocks")
    return out.reshape(header.num_channels, num_samples)


def _map(fn, items: list, max_workers: int | None) -> list:
    if len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(fn, items))


def encode_batch(streams, config, max_workers: int | None = None, parallel_blocks: bool = False,
                 chunk_blocks: int = 1, warm_passes: int = 0) -> list[bytes]:
    """One GIL-free encode a stream on a thread pool; each stream's bytes
    equal its :func:`encode` (with ``parallel_blocks``, its
    :func:`encode_parallel` with the chunk and warm knobs)."""
    library()
    if parallel_blocks:
        return _map(lambda pcm: encode_parallel(pcm, config, chunk_blocks, warm_passes), list(streams), max_workers)
    return _map(lambda pcm: encode(pcm, config), list(streams), max_workers)


def decode_batch(datas, max_workers: int | None = None) -> list[tuple[HeaderInfo, np.ndarray]]:
    """One GIL-free :func:`decode` a stream on a thread pool; (header,
    (C, N) int32) in input order."""
    library()
    return _map(decode, list(datas), max_workers)
