"""The decode probes: three questions about the decode kernels, asked on the card.

Ports of the three Pallas probes under ``benchmarks/`` (the last
``pl.pallas_call``\\ s of the repository outside ``aad_tpu``), each a module
with its CUDA kernel (``probes/csrc``), its plain torch version and a
``main()``, run as ``python -m aad_tpu_torch.probes.<name>`` on the card:

* :mod:`.transpose` (``benchmarks/probe_transpose.py``): the decode
  output's detile transpose against the library's ``permute().contiguous()``;
* :mod:`.phase_a_decode` (``benchmarks/probe_phase_a_decode.py``): the
  decode chain split five ways, phase A as a kernel among them;
* :mod:`.decode_layout` (``benchmarks/probe_decode_layout.py``): the fused
  decode in three output layouts, R lanes a thread, and with one stage of
  the step taken out at a time.

Their kernels build into a library of their own, ``libaad_probes.so``
(``ops/_build.py``, into ``build/``), at first use, so that the codec
library's sources and build stay as they are. Each wrapper counts its
launches in its module's ``launches``. Given ``device="cpu"`` a function runs
the plain version; its default is the card, and without one it raises, as a
failed build does: nothing falls back to the plain version.

This package imports torch, numpy and the port only: never jax, ``aad_tpu``
or ``benchmarks``.
"""

from __future__ import annotations

import ctypes
import functools
import json
import pathlib
import subprocess

import numpy as np
import torch

from ..codec.device import resolve_device
from ..ops import _build

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
LIB_NAME = "libaad_probes.so"
BPS = 4  # the probes decode 4-bit codes, eight a 32-bit word, code k at bits 4k
CODES_PER_WORD = 8
CTA_LANES = 64  # threads a CTA of the decode probes' kernels; the tile of tile_major
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet): the bytes bounds

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every function returns a cudaError_t as int.
_SIGNATURES = {
    # in, out, rows, cols, device, stream
    "aad_probe_transpose": (_P, _P, _I, _I, _I, _P),
    # words, step_table, index_table, out, num_words, num_lanes, variant,
    # cta_lanes, chunk_words, device, stream
    "aad_probe_phase_a": (_P,) * 4 + (_I,) * 6 + (_P,),
    # words, step_index, history, weight, step_table, index_table, out,
    # num_words, num_lanes, layout, r, mode, device, stream
    "aad_probe_decode_layout": (_P,) * 7 + (_I,) * 6 + (_P,),
}


def build(build_dir: pathlib.Path = _build.BUILD_DIR) -> pathlib.Path:
    """Compile ``probes/csrc/*.cu`` (which include the codec's headers) into
    ``libaad_probes.so`` if this source hash has none yet; return its path."""
    headers = tuple(sorted(_build.CSRC.glob("*.cuh")))
    return _build.build(build_dir, csrc=CSRC, lib_name=LIB_NAME, headers=headers)


@functools.cache
def library():
    """The probes' kernel library, built at first use and loaded once per process."""
    return _build.load(build(), _SIGNATURES)


def from_tiled(tiles, tile_axis: int = 1):
    """The JAX probes' lane tiles as flat lanes: (..., n_tiles, S, 128) with
    the tile axis at ``tile_axis`` -> (..., n_tiles * S * 128).

    The words (W, n_tiles, 8 r, 128) become (W, L); a state (n_tiles, 4, 8,
    128) with ``tile_axis=0`` becomes (4, L). Lane ``l`` is tile ``l // (128
    S)``, sublane ``l // 128 % S``, lane ``l % 128``, so an R-fold of adjacent
    tiles keeps each lane's index. Takes and gives numpy arrays or tensors.
    """
    if isinstance(tiles, np.ndarray):
        moved = np.moveaxis(tiles, tile_axis, -3)
    else:
        moved = torch.movedim(torch.as_tensor(tiles), tile_axis, -3)
    return moved.reshape(*moved.shape[:-3], -1)


def on_device(x, device, dtype=torch.int32) -> torch.Tensor:
    """``x`` (array or tensor) as a contiguous tensor of ``dtype`` on
    ``device``; 32-bit unsigned words keep their bits as int32."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x.view(np.int32) if x.dtype == np.uint32 else x)
    x = torch.as_tensor(x)
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(device=resolve_device(device), dtype=dtype).contiguous()


def check_words(words: torch.Tensor, name: str) -> tuple[int, int]:
    """(W, L) of a (W, L) int32 tensor of code words; raises otherwise."""
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError(f"{name}: words must be (W, L) 32-bit, got {tuple(words.shape)} {words.dtype}")
    return words.shape[0], words.shape[1]


def launch(name: str, *args) -> None:
    """Call entry point ``name`` of the probes' library on the current stream
    of the device of the first tensor argument; raise if it fails."""
    lib = library()
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    ints = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    _build.check(lib, name, getattr(lib, name)(*ints, *_build.launch_target(device)))


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(W, L) int32-held code words -> time-major (8W, L) int32 codes, code
    k of word i at row 8i + k (bits 4k of the word)."""
    shifts = BPS * torch.arange(CODES_PER_WORD, dtype=torch.int32, device=words.device)
    return ((words[:, None, :] >> shifts[None, :, None]) & 0xF).reshape(-1, words.shape[1])


# ---------------------------------------------------------------------------
# Measuring on the card.

def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def copies(n: int, *tensors: torch.Tensor) -> list[tuple[torch.Tensor, ...]]:
    """``n`` sets of copies of ``tensors``, for :func:`time_ms` to rotate."""
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def time_ms(fn, inputs: list, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(*inputs[i % len(inputs)])`` in ms, CUDA
    events around ``iters`` calls after ``warmup``. Rotating through input
    copies whose bytes together exceed the 50 MB L2 makes each call read its
    inputs from device memory, as a caller would find them."""
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def require_card() -> torch.device:
    """The current CUDA device; raises without one (a probe measures the card)."""
    return resolve_device("cuda")


def emit(record: dict) -> dict:
    """Print one result line as JSON; return it."""
    print(json.dumps(record), flush=True)
    return record
