"""A live stereo sender on the card (needs a GPU): ``StreamingEncoder`` fed
20-ms pushes at the benchmark's ``aad-b4-s128-ms-stereo`` geometry (2
channels, 4 bits, 128-byte blocks of 96 samples a channel, mid/side, 2
trials; 960 samples a channel a push, 10 blocks), three feeds pushed in
turn, as the cell ``b4s128ms-live-encode`` pushes them.

Each feed's bytes on the card must equal those of ``device="cpu"`` (the
kernels' plain versions) and, block by block from the state the stream
carries in, the benchmark's plain reference encoder
(``bench_torch/reference/aad.py``, imported from its path). Each whole
push makes one launch of kernel 3 (``aad_encode_stream``) and one of kernel
4 (``aad_encode_pass``, the carry), both inside ``aad.stream_encode.blocks``.
Imports no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_stream_encode_gpu.py -q

Without a card every test here skips.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

import aad_tpu_torch
from aad_tpu_torch.ops import encode_pass, fused_encode
from test_torch_trace import parent_of, program_spans, recorded

pytestmark = pytest.mark.gpu

REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "bench_torch" / "reference" / "aad.py"
CFG = aad_tpu_torch.EncodeConfig(num_channels=2, sampling_rate=48000, bits_per_sample=4, max_block_size=128,
                                 ch_process_method=1, num_encode_trials=2)
NSPB = CFG.geometry().num_samples_per_block
PUSH = 960
LENGTHS = [2 * PUSH + 2 * NSPB + 58, PUSH + 50, PUSH]  # ends mid-block; an idle last push; ends on a push


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _reference():
    spec = importlib.util.spec_from_file_location("aad_reference", REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pcm(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    common = 26_000 * np.sin(t / rng.uniform(4.0, 40.0))
    left = common + rng.normal(0, 3_000, n)
    right = 0.8 * common + 4_000 * np.sin(t / 7.0) + rng.normal(0, 3_000, n)
    return np.clip(np.stack([left, right]), -32768, 32767).astype(np.int16)


def _launches() -> tuple[int, int]:
    return fused_encode.launches[fused_encode.STREAM_KERNEL], encode_pass.launches[encode_pass.PASS_KERNEL]


def _in_turns(feeds: list, device):
    """Push the feeds 960 samples at a time, in turn, each finished after its
    last push: (each feed's file, the launches (kernel 3, kernel 4) of each
    whole push)."""
    encs = [aad_tpu_torch.StreamingEncoder(CFG, device=device) for _ in feeds]
    outs = [[] for _ in feeds]
    whole = []
    for off in range(0, max(f.shape[1] for f in feeds), PUSH):
        for k, f in enumerate(feeds):
            if off >= f.shape[1]:
                continue
            before = _launches()
            outs[k].append(encs[k].push(f[:, off: off + PUSH]))
            if off + PUSH <= f.shape[1]:
                whole.append(tuple(a - b for a, b in zip(_launches(), before)))
            if off + PUSH >= f.shape[1]:
                outs[k].append(encs[k].finish())
    return [e.header() + b"".join(o) for e, o in zip(encs, outs)], whole


def test_pushes_on_the_card_equal_the_cpu_and_the_reference(cuda):
    feeds = [_pcm(n, seed=2**31 + n) for n in LENGTHS]
    got, whole = _in_turns(feeds, cuda)
    want, _ = _in_turns(feeds, "cpu")  # the plain versions launch nothing
    assert got == want
    R = _reference()
    items = [dict(pcm=torch.from_numpy(f), data=d, rate=48000) for f, d in zip(feeds, got)]
    assert R.check_encoded(items, R.Geometry(2, 4, 128), True, 2, cuda)["bad_blocks"] == 0
    assert len(whole) == sum(n // PUSH for n in LENGTHS) and set(whole) == {(1, 1)}


def test_a_push_marks_its_launches_inside_its_blocks(cuda):
    pcm = _pcm(2 * PUSH, seed=7)
    enc = aad_tpu_torch.StreamingEncoder(CFG, device=cuda)
    enc.push(pcm[:, :PUSH])  # builds and warms; the carry for the next push
    torch.cuda.synchronize()
    data, prof, gained = recorded(lambda: enc.push(pcm[:, PUSH:]), (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    spans = program_spans(prof)
    push, blocks = "aad.stream_encode.push", "aad.stream_encode.blocks"
    assert [(e.name(), parent_of(e, spans)) for e in spans] == [
        (push, None), ("aad.push.buffer", push), ("aad.h2d", push), (blocks, push),
        ("aad.launch.encode_stream", blocks), ("aad.launch.encode_pass", blocks), ("aad.d2h", push)]
    assert gained == {"stream_encode_blocks": 10, "stream_encode_carried": 1, "h2d_bytes": 2 * 2 * PUSH,
                      "d2h_bytes": 10 * 128}
    assert len(data) == 10 * 128
