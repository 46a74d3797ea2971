"""aad_tpu_torch.utils.trace on the card (needs a GPU).

The cases of ``tests/test_torch_trace.py`` on ``cuda``: the same spans, with
each kernel launch's span where it launches, and counters that equal the
bytes that cross (for ``encode_batch``, ``h2d_bytes`` is the pile's bytes);
no span leaves an image on the device's timeline. Imports no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_trace_gpu.py -q

Without a card every test here skips.
"""

from __future__ import annotations

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

from aad_tpu_torch.ops import encode_pass, fused_decode, fused_encode
from test_torch_trace import assert_documented, encode_batch_case, push_case, recorded, sharded_case

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _launches() -> dict:
    return {**fused_encode.launches, **encode_pass.launches, **fused_decode.launches}


def _on_card(call, cuda):
    """``call`` once to build and warm, then once under the profiler with
    the card's activity: (the profile, the counts it added, the launches it
    made). No ``aad.*`` event lies on the device's timeline."""
    call()
    torch.cuda.synchronize(cuda)
    before = _launches()
    _, prof, gained = recorded(lambda: (call(), torch.cuda.synchronize(cuda)),
                               (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    launched = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
    on_device = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA and e.name().startswith("aad.")]
    assert on_device == []
    return prof, gained, launched


def _after(spans: list, name: str, extra: list) -> list:
    """``spans`` with ``extra`` put in after the first span called ``name``."""
    k = [n for n, _ in spans].index(name) + 1
    return spans[:k] + extra + spans[k:]


def test_encode_batch_counts_the_pile_and_marks_its_launch(cuda):
    call, spans, counts = encode_batch_case(cuda)
    prof, gained, launched = _on_card(call, cuda)
    assert gained == counts  # h2d_bytes: the pile's (S, C, B * nspb) int16; one chunk, none ahead
    assert launched == {fused_encode.STREAM_KERNEL: 1}
    assert_documented(prof, _after(spans, "aad.h2d", [("aad.launch.encode_stream", "aad.encode_batch")]))


@pytest.mark.parametrize("ms", [False, True])
def test_push_marks_its_launch_inside_the_decode(cuda, ms):
    """One launch of kernel 1 a push, its span the only one inside
    ``aad.decode.pcm``; the kernel parsed the push's three block headers
    itself and, for a mid/side stream, combined their left/right."""
    call, spans, counts = push_case(cuda, ms)
    prof, gained, launched = _on_card(call, cuda)
    assert gained == {**counts, "k1_rows_parsed": 3, **({"k1_rows_ms": 3} if ms else {})}
    assert launched == {fused_decode.DECODE_KERNEL: 1}
    assert_documented(prof, _after(spans, "aad.decode.pcm", [("aad.launch.decode_lanes", "aad.decode.pcm")]))


def test_sharded_encode_marks_each_shards_launch(cuda):
    call, spans, _ = sharded_case(cuda)
    prof, gained, launched = _on_card(call, cuda)
    assert gained == {} and launched == {fused_encode.STREAM_KERNEL: 2}
    assert_documented(prof, spans + [("aad.launch.encode_stream", "aad.encode_streams_sharded")] * 2)
