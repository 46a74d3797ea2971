"""The wheel carries the port's sources: its CUDA kernels, the native host
engine it builds at first use, the sharded module and the decode probes
with their kernels.

Builds a wheel with pip from a copy of ``pyproject.toml``, ``README.md``,
``aad_tpu/`` and ``aad_tpu_torch/`` (a build writes ``build/`` and egg-info
into its source directory, which must not dirty the checkout) and lists it.
"""

import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def wheel_names(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_wheel")
    src = out / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    for pkg in ("aad_tpu", "aad_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.pyc"))
    try:
        subprocess.run(
            [sys.executable, "-m", "pip", "wheel", str(src), "--no-deps", "--no-build-isolation", "-w", str(out)],
            check=True, capture_output=True, timeout=300,
        )
    except subprocess.CalledProcessError as e:  # pragma: no cover
        pytest.fail(f"pip wheel failed:\n{e.stderr.decode()[-2000:]}")
    wheels = list(out.glob("aad_tpu-*.whl"))
    assert len(wheels) == 1, f"expected one wheel, got {wheels}"
    with zipfile.ZipFile(wheels[0]) as zf:
        return set(zf.namelist())


def test_wheel_carries_native_engine_sources(wheel_names):
    for name in ("__init__.py", "aadx.cc", "aadx.h"):
        assert f"aad_tpu_torch/native/{name}" in wheel_names, f"wheel is missing aad_tpu_torch/native/{name}"


def test_wheel_carries_kernel_sources_and_sharding(wheel_names):
    sources = sorted(p.relative_to(REPO).as_posix() for ext in ("*.cu", "*.cuh")
                     for p in (REPO / "aad_tpu_torch" / "csrc").glob(ext))
    assert sources and set(sources) <= wheel_names
    for name in ("aad_tpu_torch/parallel/__init__.py", "aad_tpu_torch/parallel/sharded.py"):
        assert name in wheel_names, f"wheel is missing {name}"


def test_wheel_carries_probe_sources(wheel_names):
    sources = sorted(p.relative_to(REPO).as_posix() for ext in ("*.cu", "*.cuh")
                     for p in (REPO / "aad_tpu_torch" / "probes" / "csrc").glob(ext))
    assert len(sources) >= 4, sources
    missing = set(sources) - wheel_names
    assert not missing, f"wheel is missing {sorted(missing)}"
    for name in ("__init__.py", "transpose.py", "phase_a_decode.py", "decode_layout.py"):
        assert f"aad_tpu_torch/probes/{name}" in wheel_names, f"wheel is missing aad_tpu_torch/probes/{name}"


def test_wheel_ships_no_built_library(wheel_names):
    assert not [n for n in wheel_names if n.endswith(".so")], "a built library is host-specific"
