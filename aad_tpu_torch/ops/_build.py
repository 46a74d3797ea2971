"""Build and load the package's CUDA kernels.

The sources under ``aad_tpu_torch/csrc`` have a plain C interface. At first
use each ``.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
started together, and the objects are linked into one shared library,
which is loaded with ctypes. No PyTorch headers are involved, so a build
takes seconds.

The library lands in ``build/aad_tpu_torch/<hash>/libaad_kernels.so`` beside
the package, keyed by a hash of the sources and flags, under a file lock so
that concurrent processes build it once (:func:`build_locked`, which also
builds the native host engine, ``aad_tpu_torch.native``). A missing ``nvcc``
or a failed build raises :class:`KernelBuildError`: nothing falls back to the
plain torch versions.
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
    # num_blocks, num_channels, num_codes, bits_per_sample, device, stream
    "aad_decode_lanes": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
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
    # qdiffs, history, weight, out, num_lanes, num_steps, device, stream
    "aad_lms_lanes": (_P, _P, _P, _P, _I, _I, _I, _P),
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


def source_hash(flags=NVCC_FLAGS, sources=None) -> str:
    """16 hex digits of the sha256 of ``flags`` and the sources' names and
    bytes (by default the kernels' flags and sources)."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in _sources() if sources is None else sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def build_locked(out_dir: pathlib.Path, lib_name: str, stages, error: type[Exception]) -> pathlib.Path:
    """Build ``out_dir / lib_name`` once, whatever the number of processes
    that ask at the same time; return its path.

    ``stages(tmp, tag)`` gives the commands to run: a list of stages, each a
    list of commands started together, a stage only once the one before has
    succeeded. The last stage writes ``tmp``, which is moved to the library's
    path at once when every command has succeeded; intermediate files are
    named ``*.{tag}.o`` in ``out_dir`` and removed. The commands' output goes
    to ``build.log`` in ``out_dir``; a command that fails raises ``error``
    with its output.
    """
    lib = out_dir / lib_name
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.is_file():  # built by another process while we waited
                return lib
            tag = os.getpid()
            tmp = out_dir / f"{lib_name}.{tag}.tmp"
            results = []
            for stage in stages(tmp, tag):
                procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                         for cmd in stage]
                results += [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in zip(stage, procs)]
                if any(rc != 0 for _, _, rc in results):
                    break
            (out_dir / "build.log").write_text(
                "".join(" ".join(cmd) + "\n" + out for cmd, out, _ in results)
            )
            for obj in out_dir.glob(f"*.{tag}.o"):
                obj.unlink(missing_ok=True)
            failed = [(cmd, out, rc) for cmd, out, rc in results if rc != 0]
            if failed:
                tmp.unlink(missing_ok=True)
                cmd, out, rc = failed[0]
                raise error(f"{' '.join(cmd)} failed ({rc}):\n{out[-4000:]}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def build(build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    """Compile the kernels if this source hash has no library yet; return its path.

    One nvcc a source, all started together, then one link. The compiler's
    output (including ``-Xptxas -v``: registers, shared memory and spills per
    kernel) is kept in ``build.log`` beside the library.
    """
    out_dir = build_dir / source_hash()
    if (out_dir / LIB_NAME).is_file():
        return out_dir / LIB_NAME
    nvcc = find_nvcc()

    def stages(tmp: pathlib.Path, tag: int) -> list[list[list[str]]]:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
        return [
            [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)],
            [[nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp),
              *(str(obj) for obj in objs)]],
        ]

    return build_locked(out_dir, LIB_NAME, stages, KernelBuildError)


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
