"""aad_tpu_torch.cli against aad_tpu.cli, in process, on the CPU.

The port's CLI runs with ``AAD_TPU_PLATFORM=cpu``, aad_tpu's with
``AAD_TPU_ENGINE=scan``. Each case runs both ``main``s on the same argv and
compares exit codes, stdout, stderr (the program name substituted) and the
output file byte for byte: every mode, the options and their truncation
quirks, >16-bit input through -c and -g, the diagnostics, and lenient
decode of a truncated file under ``AAD_TPU_STRICT=0``. Signals are a few
blocks long: the plain encode engine is slow.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import aad_tpu
import aad_tpu.cli as jax_cli
from aad_tpu.codec.encoder import EncodeConfig as JaxEncodeConfig
from aad_tpu.format.wav import WavFormat, write_wav

import aad_tpu_torch.cli as torch_cli

from util import write_pcm16_wav

ENV_KEYS = ("AAD_TPU_PLATFORM", "AAD_TPU_ENGINE", "AAD_TPU_STRICT")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(0)
    n = 400
    tone = 9000 * np.sin(np.arange(n) / np.array([[7.0], [11.0]]))
    stereo = (tone + rng.normal(0, 900, (2, n))).astype(np.int32)
    write_pcm16_wav(d / "in.wav", stereo, 16000)
    write_pcm16_wav(d / "mono.wav", stereo[:1, :301], 16000)
    wide = rng.integers(-(2**23), 2**23, (2, 350)).astype(np.int32) << 8  # 24-bit canonical
    write_wav(str(d / "in24.wav"), WavFormat(2, 16000, 24, 350), wide)
    data = aad_tpu.encode(stereo, JaxEncodeConfig(2, 16000, max_block_size=256))
    (d / "in.aad").write_bytes(data)
    (d / "cut.aad").write_bytes(data[:-40])
    return d


def _run(main, argv, files, out, env, capsys, monkeypatch):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    names = {"in": "in.wav", "mono": "mono.wav", "in24": "in24.wav", "aad": "in.aad", "cut": "cut.aad",
             "missing": "missing.wav"}
    argv = [str(out) if a == "{out}" else str(files / names[a[1:-1]]) if a.startswith("{") else a for a in argv]
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err, out.read_bytes() if out.exists() else None


def _both(argv, files, tmp_path, capsys, monkeypatch, env=None):
    """(port, aad_tpu) results, the port's program name substituted."""
    env = env or {}
    got = _run(torch_cli.main, argv, files, tmp_path / "port.out", {"AAD_TPU_PLATFORM": "cpu", **env},
               capsys, monkeypatch)
    want = _run(jax_cli.main, argv, files, tmp_path / "jax.out", {"AAD_TPU_ENGINE": "scan", **env},
                capsys, monkeypatch)
    got = (got[0], got[1].replace("aad_tpu_torch", "aad_tpu"), got[2].replace("aad_tpu_torch", "aad_tpu"), got[3])
    return got, want


CASES = {
    "encode": ["-e", "-s", "256", "{in}", "{out}"],
    "encode mid/side 2-bit": ["-e", "-m", "-b", "2", "-s", "256", "{in}", "{out}"],
    "encode mono 3-bit trials 1": ["-e", "-b", "3", "-t", "1", "--max-block-size=256", "{mono}", "{out}"],
    "encode, truncated -b and -s": ["-e", "-b", "260", "-s", "65792", "{in}", "{out}"],
    "encode, bad parameter": ["-e", "-b", "5", "{in}", "{out}"],
    "decode": ["-d", "{aad}", "{out}"],
    "decode a truncated file": ["-d", "{cut}", "{out}"],
    "reconstruct": ["-r", "-s", "256", "{in}", "{out}"],
    "gap": ["-g", "-m", "-s", "256", "{in}", "{out}"],
    "calculate": ["-c", "-s", "256", "{in}"],
    "information": ["-i", "{aad}"],
    "calculate 24-bit": ["-c", "-s", "256", "{in24}"],
    "gap 24-bit": ["-g", "-s", "256", "{in24}", "{out}"],
    "no arguments": [],
    "no mode": ["{in}"],
    "two modes": ["-e", "-d", "{in}", "{out}"],
    "no input": ["-e"],
    "no output": ["-e", "{in}"],
    "missing input": ["-e", "{missing}", "{out}"],
    "unreadable input": ["-r", "{aad}", "{out}"],
    "missing .aad": ["-d", "{missing}", "{out}"],
    "information of a WAV": ["-i", "{in}"],
    "help": ["-h"],
    "version": ["--version"],
    "unknown option": ["-x", "{in}"],
    "argument missing": ["-e", "-b"],
    "option twice": ["-e", "-e", "{in}", "{out}"],
}


SUCCEED = {"encode", "encode mid/side 2-bit", "encode mono 3-bit trials 1", "encode, truncated -b and -s",
           "decode", "reconstruct", "gap", "calculate", "information", "calculate 24-bit", "gap 24-bit", "help",
           "version"}


@pytest.mark.parametrize("case", CASES)
def test_cli_matches_aad_tpu(case, files, tmp_path, capsys, monkeypatch):
    got, want = _both(CASES[case], files, tmp_path, capsys, monkeypatch)
    assert got == want
    assert (got[0] == 0) == (case in SUCCEED)
    assert (got[3] is not None) == ("{out}" in CASES[case] and case in SUCCEED)


@pytest.mark.parametrize("strict", ["0", "1"])
def test_strict_switch_matches_aad_tpu(strict, files, tmp_path, capsys, monkeypatch):
    got, want = _both(["-d", "{cut}", "{out}"], files, tmp_path, capsys, monkeypatch, {"AAD_TPU_STRICT": strict})
    assert got == want
    assert (got[0] == 0) == (strict == "0")


def test_pallas_engine_decodes_the_same(files, tmp_path, capsys, monkeypatch):
    got, want = _both(["-d", "{aad}", "{out}"], files, tmp_path, capsys, monkeypatch, {"AAD_TPU_ENGINE": "pallas"})
    assert got == want and got[0] == 0


@pytest.mark.parametrize("case,strict", [
    ("encode", "1"), ("encode mid/side 2-bit", "1"), ("encode mono 3-bit trials 1", "1"), ("decode", "1"),
    ("decode a truncated file", "1"), ("decode a truncated file", "0"), ("reconstruct", "1"), ("gap", "1"),
    ("calculate", "1"),
])
def test_native_engine_matches_aad_tpu(case, strict, files, tmp_path, capsys, monkeypatch):
    """AAD_TPU_ENGINE=native runs the port's native host engine, as
    aad_tpu's CLI runs its own: the same files, output and exit codes; a
    truncated file fails strict and decodes under AAD_TPU_STRICT=0."""
    env = {"AAD_TPU_ENGINE": "native", "AAD_TPU_STRICT": strict}
    got, want = _both(CASES[case], files, tmp_path, capsys, monkeypatch, env)
    assert got == want
    assert (got[0] == 0) == (case != "decode a truncated file" or strict == "0")


@pytest.mark.parametrize("env,message", [
    ({"AAD_TPU_PLATFORM": "cpu", "AAD_TPU_ENGINE": "native"}, "did not build"),
    ({"AAD_TPU_PLATFORM": "cpu", "AAD_TPU_ENGINE": "scan"}, "expected one of"),
    ({}, "no CUDA device"),
])
def test_knobs_that_cannot_run_fail_without_falling_back(env, message, files, tmp_path, capsys, monkeypatch):
    """A native engine that does not build (no host compiler here), an
    engine the port lacks, no card: each fails before any file is read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.delenv("AAD_TPU_NATIVE_LIB", raising=False)
    torch_cli.native_engine.library.cache_clear()
    rc, out, err, written = _run(torch_cli.main, ["-e", "{in}", "{out}"], files, tmp_path / "out", env,
                                 capsys, monkeypatch)
    torch_cli.native_engine.library.cache_clear()
    assert rc == 1 and out == "" and message in err and written is None


@pytest.mark.parametrize("module", ["aad_tpu_torch.cli", "aad_tpu_torch"])
def test_module_entry_points(module, capsys):
    proc = subprocess.run([sys.executable, "-m", module, "-v"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert jax_cli.main(["-v"]) == 0
    assert (proc.returncode, proc.stdout, proc.stderr) == (0, capsys.readouterr().out, "")
