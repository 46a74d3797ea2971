"""Build and load the package's CUDA kernels.

The sources under ``aad_tpu_torch/csrc`` have a plain C interface. At first
use each ``.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library,
which is loaded with ctypes. No PyTorch headers are involved, so a build
takes seconds.

The library lands in ``build/aad_tpu_torch/<hash>/libaad_kernels.so`` beside
the package, keyed by a hash of the sources and flags, under a file lock so
that concurrent processes build it once. A missing ``nvcc`` or a failed
build raises :class:`KernelBuildError`: nothing falls back to the plain torch
versions.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "aad_tpu_torch"
LIB_NAME = "libaad_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every function returns a cudaError_t as int.
_SIGNATURES = {
    # codes, step_index, history, weight, step_table, index_table, out,
    # num_lanes, num_codes, bits_per_sample, device, stream
    "aad_decode_lanes": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # step_table, out, device, stream
    "aad_stepsize_probe": (_P, _P, _I, _P),
    # samples, prev0, valid, step_index, history, weight, step_table,
    # index_table, codes, headers, states, num_blocks, num_lanes, nspb,
    # bits_per_sample, num_trials, warm_on_prev, blocks_before, device, stream
    "aad_encode_stream": (_P,) * 11 + (_I,) * 8 + (_P,),
    # samples, step_index, history, weight, valid, step_table, index_table,
    # codes, step_index_out, history_out, weight_out, sse_out, num_lanes,
    # num_codes, bits_per_sample, device, stream
    "aad_encode_pass": (_P,) * 12 + (_I,) * 4 + (_P,),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or the kernels did not compile or load."""


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise KernelBuildError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def build(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile the kernels if this source hash has no library yet; return its path.

    The compiler's output (including ``-Xptxas -v``: registers, shared
    memory and spills per kernel) is kept in ``build.log`` beside it.
    """
    out_dir = build_dir / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.is_file():  # built by another process while we waited
                return lib
            tag = os.getpid()
            tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
            srcs = sorted(CSRC.glob("*.cu"))
            objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
            cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for cmd in cmds]  # one nvcc per source, all at once
            results = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(cmds, procs)]
            link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp),
                    *(str(obj) for obj in objs)]
            if all(rc == 0 for _, _, rc in results):
                proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                results.append((link, proc.stdout, proc.returncode))
            (out_dir / "build.log").write_text(
                "".join(" ".join(cmd) + "\n" + out for cmd, out, _ in results)
            )
            for obj in objs:
                obj.unlink(missing_ok=True)
            failed = [(cmd, out, rc) for cmd, out, rc in results if rc != 0]
            if failed:
                cmd, out, rc = failed[0]
                raise KernelBuildError(f"{' '.join(cmd)} failed ({rc}):\n{out[-4000:]}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process, argtypes set."""
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {path}: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.aad_error_string.argtypes = [ctypes.c_int]
    lib.aad_error_string.restype = ctypes.c_char_p
    return lib


def launch_target(device) -> tuple[int, int]:
    """(device index, current CUDA stream handle): the last two arguments
    of every kernel entry point."""
    return device.index, torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a kernel entry point returned a cudaError_t other than 0."""
    if err != 0:
        msg = lib.aad_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name} failed: cudaError {err} ({msg})")
