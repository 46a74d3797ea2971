"""A live stereo sender on the CPU: ``StreamingEncoder`` fed 20-ms pushes at
the geometry of the benchmark's ``aad-b4-s128-ms-stereo`` configuration
(``bench_torch/configs/aad-b4-s128-ms-stereo.json``: 2 channels, 4 bits a
sample, 128-byte blocks of 96 samples a channel, mid/side, 2 trials; 960
samples a channel a push, 10 blocks).

Each stream below, pushed 960 samples at a time and then finished, must
give the bytes of the port's one-shot ``encode(..., device="cpu")``, of
``aad_tpu``'s scan ``encode`` and, block by block from the state the stream
carries in, of the benchmark's plain reference encoder
(``bench_torch/reference/aad.py``, imported from its path). Under a CPU
``torch.profiler`` each push and the finish record their documented spans,
nested as documented (that every span is a ``cpu_op`` is held for all of
them by ``test_torch_trace.py``), and the counters count what the pushes
did; with no profiler nothing is recorded or counted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import aad_tpu
import aad_tpu_torch
from aad_tpu.codec.encoder import EncodeConfig as JaxEncodeConfig
from aad_tpu_torch.utils import trace
from test_torch_stream_encode_gpu import CFG, NSPB, PUSH, _pcm, _reference, expected_trace
from test_torch_trace import parent_of, program_spans, recorded

GEO = CFG.geometry()

# samples a channel of each stream, pushed 960 at a time
LENGTHS = {
    "ends mid-block": PUSH + 2 * NSPB + 58,  # the last push encodes 2 blocks, finish the 58-sample tail
    "last push crosses no block boundary": PUSH + 50,  # an idle push, then finish
    "ends on a push": PUSH,  # finish has nothing left
    "shorter than a block": 40,  # one idle push
}
R = _reference()
REF_GEO = R.Geometry(2, 4, 128)


def _pushed(pcm: np.ndarray):
    """960-sample pushes of ``pcm`` then finish: (each call's bytes, the encoder)."""
    enc = aad_tpu_torch.StreamingEncoder(CFG, device="cpu")
    outs = [enc.push(pcm[:, off: off + PUSH]) for off in range(0, pcm.shape[1], PUSH)]
    return outs + [enc.finish()], enc


def _blocks(n: int) -> int:
    return -(-n // NSPB)


@pytest.fixture(scope="module", params=sorted(LENGTHS))
def stream(request):
    """One stream of LENGTHS pushed with no profiler, every span made
    noted: (case, PCM, each call's bytes, the header, the spans made, the
    counters changed)."""
    n = LENGTHS[request.param]
    pcm = _pcm(n, seed=2**31 + n)
    made, before = [], dict(trace.counts)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(trace, "_RecordFunctionFast", lambda name: made.append(name))
        outs, enc = _pushed(pcm)
    changed = {k for k in set(trace.counts) | set(before) if trace.counts.get(k) != before.get(k)}
    return request.param, pcm, outs, enc.header(), made, changed


@pytest.fixture(scope="module")
def traced(stream):
    """The same stream pushed under a CPU profiler: (each call's bytes, the
    program's spans as (name, parent's name) in call order, what the
    counters gained)."""
    pcm = stream[1]
    (outs, _), prof, gained = recorded(lambda: _pushed(pcm))
    spans = program_spans(prof)
    return outs, [(e.name(), parent_of(e, spans)) for e in spans], gained


def test_pushes_equal_the_one_shot_encodes(stream):
    _, pcm, outs, header, *_ = stream
    data = header + b"".join(outs)
    assert data == aad_tpu_torch.encode(pcm, CFG, device="cpu")
    assert data == aad_tpu.encode(pcm.astype(np.int32), JaxEncodeConfig(**dataclasses.asdict(CFG)), engine="scan")


def test_pushes_equal_the_plain_reference(stream):
    _, pcm, outs, header, *_ = stream
    item = dict(pcm=torch.from_numpy(pcm), data=header + b"".join(outs), rate=CFG.sampling_rate)
    got = R.check_encoded([item], REF_GEO, True, CFG.num_encode_trials, "cpu")
    assert got == {"bad_blocks": 0, "blocks": _blocks(pcm.shape[1])}


def test_each_push_returns_its_whole_blocks(stream):
    """A push returns the blocks it completes and nothing of the rest; the
    finish returns the tail, cut to the units its samples fill."""
    _, pcm, outs, *_ = stream
    n = pcm.shape[1]
    fed = [min(off + PUSH, n) for off in range(0, n, PUSH)]
    done = [f // NSPB for f in fed]
    assert [len(o) for o in outs[:-1]] == [(b - a) * GEO.block_size for a, b in zip([0] + done, done)]
    tail = n - done[-1] * NSPB
    assert len(outs[-1]) == (REF_GEO.wire_bytes(tail) if tail else 0)


def test_spans_nest_as_documented(stream, traced):
    spans, _ = expected_trace(stream[1].shape[1])
    assert traced[1] == spans


def test_counters_count_what_the_pushes_did(stream, traced):
    outs, _, gained = traced
    _, counts = expected_trace(stream[1].shape[1])
    assert gained == counts
    assert not {"k3_rows_written", "k3_rows_ms"} & set(gained)  # kernel 3 counts them where it launches
    assert gained.get("d2h_bytes", 0) == sum(len(o) for o in outs)


def test_nothing_records_without_a_profiler(stream):
    *_, made, changed = stream
    assert made == [] and changed == set()


def test_the_profiler_leaves_the_bytes_alone(stream, traced):
    assert traced[0] == stream[2]
