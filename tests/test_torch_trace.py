"""aad_tpu_torch.utils.trace: the program's spans and counters.

Under a CPU ``torch.profiler``, ``encode_batch(device="cpu")``,
``StreamingDecoder(device="cpu").push`` and ``encode_streams_sharded`` on a
mesh of CPU shards record their documented ``aad.*`` spans, once each, in
call order, each a ``cpu_op`` (a ``user_annotation`` would leave an image on
a card's timeline) nested in the span documented as its parent; the copy
spans add the bytes they move to ``counts``. With no profiler, or on a
thread that the profiler does not record, nothing is recorded or counted.
Imports no jax (``tests/test_torch_trace_gpu.py`` reuses these cases on a
card). The launch spans exist on a card only: the GPU tests hold them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import aad_tpu_torch
from aad_tpu_torch import EncodeConfig
from aad_tpu_torch.codec import encoder as enc_mod
from aad_tpu_torch.parallel import sharded as ts
from aad_tpu_torch.utils import trace

CFG = EncodeConfig(num_channels=2, sampling_rate=44100, bits_per_sample=4, max_block_size=96,
                   ch_process_method=0, num_encode_trials=1)
GEO = CFG.geometry()
NSPB = GEO.num_samples_per_block


def _pcm(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tone = 9000 * np.sin(np.arange(n) / (5.0 + 4 * rng.random((2, 1))))
    return (tone + rng.normal(0, 900, (2, n))).astype(np.int16)


def encode_batch_case(device):
    """encode_batch of two streams of 2 and 1 blocks: (call, the spans in
    call order as (name, parent's name), the counts it adds). One launch:
    ``aad.d2h`` queues the copy down, and ``aad.encode_batch.wait`` waits
    for it, as for a chunk's."""
    pile = [_pcm(1, NSPB + 5), _pcm(2, NSPB)]
    S, B = len(pile), 2
    spans = [
        ("aad.encode_batch", None),
        ("aad.encode_batch.check", "aad.encode_batch"),
        ("aad.encode_batch.stage", "aad.encode_batch"),
        ("aad.h2d", "aad.encode_batch.stage"),
        ("aad.d2h", "aad.encode_batch"),
        ("aad.encode_batch.wait", "aad.encode_batch"),
        ("aad.encode_batch.assemble", "aad.encode_batch"),
    ]
    # one launch: one chunk, staged with nothing queued before it; the upload
    # holds the rest of the first stream's block 1, past its 5 samples, and
    # the second's block 1, but the host zeroes only the first
    counts = {"h2d_bytes": S * 2 * B * NSPB * 2, "d2h_bytes": S * B * GEO.block_size,
              "pile_chunks": 1, "pile_streams": S, "pile_pad_bytes": ((NSPB - 5) + NSPB) * 2 * 2,
              "pile_zero_bytes": (NSPB - 5) * 2 * 2}
    return lambda: aad_tpu_torch.encode_batch(pile, CFG, device=device), spans, counts


def push_case(device, ms: bool = False):
    """One push of a whole three-block stream, its file header included,
    into a new decoder; ``ms``: a mid/side stream. ``aad.frame.blocks`` holds
    the rows' view and ``aad.decode.pcm`` the decode (on the CPU the header
    parse, the recurrence and the combine; on a card kernel 1's launch, which
    adds ``k1_rows_parsed`` and ``k1_rows_ms``)."""
    n = 2 * NSPB + 7
    data = aad_tpu_torch.encode(_pcm(3, n), dataclasses.replace(CFG, ch_process_method=int(ms)), device="cpu")
    push = "aad.stream_decode.push"
    spans = [(push, None), ("aad.push.frame", push), ("aad.h2d", push), ("aad.frame.blocks", push),
             ("aad.decode.pcm", push), ("aad.d2h", push)]
    counts = {"h2d_bytes": 3 * GEO.block_size, "d2h_bytes": 2 * n * 2}
    return lambda: aad_tpu_torch.StreamingDecoder(device=device).push(data), spans, counts


def push_ms_case(device):
    return push_case(device, ms=True)


def sharded_case(device):
    """encode_streams_sharded of three streams over two shards."""
    blocks = torch.stack([torch.from_numpy(_pcm(4 + s, 2 * NSPB)).reshape(2, 2, NSPB).transpose(0, 1)
                          for s in range(3)]).to(device)
    valid = torch.full((3, 2), NSPB, dtype=torch.int32, device=device)
    mesh = ts.make_mesh(2, devices=[device] * 2, shape=(2, 1))
    spans = [("aad.encode_streams_sharded", None), ("aad.sharded.scatter", "aad.encode_streams_sharded")]
    call = lambda: ts.encode_streams_sharded(blocks, valid, bits_per_sample=4, num_trials=1, mesh=mesh)  # noqa: E731
    return call, spans, {}


CASES = {"encode_batch": encode_batch_case, "push": push_case, "push_ms": push_ms_case, "sharded": sharded_case}


def program_spans(prof) -> list:
    """The ``aad.*`` events of a finished profile, in start order."""
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("aad.")]
    return sorted(events, key=lambda e: e.start_ns())


def parent_of(e, events):
    """The name of the innermost other ``aad.*`` span around ``e`` on its
    thread, or None."""
    around = [p for p in events if p is not e and p.start_thread_id() == e.start_thread_id()
              and p.start_ns() <= e.start_ns() and e.end_ns() <= p.end_ns()]
    return min(around, key=lambda p: p.end_ns() - p.start_ns()).name() if around else None


def recorded(call, activities=(ProfilerActivity.CPU,)):
    """``call()`` under torch.profiler: (its result, the profile, what
    ``counts`` gained)."""
    before = dict(trace.counts)
    with profile(activities=list(activities)) as prof:
        out = call()
    gained = {k: v - before.get(k, 0) for k, v in trace.counts.items() if v != before.get(k, 0)}
    return out, prof, gained


def categories(prof) -> set:
    """The trace event categories of the ``aad.*`` events, as a Chrome
    trace of the profile (what Perfetto shows) gives them."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return {e.get("cat") for e in events if str(e.get("name", "")).startswith("aad.")}


def assert_documented(prof, expected: list) -> None:
    """The program's spans are ``expected``'s (name, parent's name), in call
    order, each a ``cpu_op`` and nothing else."""
    spans = program_spans(prof)
    assert [(e.name(), parent_of(e, spans)) for e in spans] == expected
    assert categories(prof) == {"cpu_op"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_are_cpu_ops_nested_as_documented(case):
    call, spans, counts = CASES[case]("cpu")
    _, prof, gained = recorded(call)
    assert_documented(prof, spans)
    assert gained == counts


@pytest.mark.parametrize("case", sorted(CASES))
def test_nothing_records_without_a_profiler(case, monkeypatch):
    made = []
    monkeypatch.setattr(trace, "_RecordFunctionFast", lambda name: made.append(name))
    call, _, _ = CASES[case]("cpu")
    before = dict(trace.counts)
    call()
    assert made == [] and trace.counts == before


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_thread_the_profiler_does_not_record_counts_nothing(case):
    call, _, _ = CASES[case]("cpu")
    failed = []

    def work():
        try:
            call()
        except Exception as e:  # noqa: BLE001 - raised again below, on the test's thread
            failed.append(e)

    def on_a_thread():
        t = threading.Thread(target=work)
        t.start()
        t.join()

    _, prof, gained = recorded(on_a_thread)
    assert not failed, failed
    assert program_spans(prof) == [] and gained == {}


def pile_counts(nbs: list, parallel: bool = False) -> dict:
    """The pile counters that an encode_batch of streams of ``nbs`` blocks
    adds, from the chunk constants: a sequential pile of
    ``_OVERLAP_MIN_BLOCKS`` blocks or more runs in chunks, every chunk but
    the first staged while an earlier one is queued, and the streams that
    end before the last chunk are assembled early; any other pile is one
    launch."""
    B, step = max(nbs), enc_mod._OVERLAP_CHUNK_BLOCKS
    chunks = -(-B // step) if not parallel and B >= enc_mod._OVERLAP_MIN_BLOCKS else 1
    return {"pile_chunks": chunks, "pile_chunks_staged_ahead": chunks - 1, "pile_streams": len(nbs),
            "pile_streams_assembled_early": sum(nb <= (chunks - 1) * step for nb in nbs) if chunks > 1 else 0}


def pile_of(nbs: list) -> list:
    """Streams of ``nbs`` blocks each, the last block of each ragged."""
    return [_pcm(10 + s, (nb - 1) * NSPB + 1 + (s * 7) % NSPB) for s, nb in enumerate(nbs)]


@pytest.mark.parametrize("nbs,parallel", [
    ([1, 3, 7], False),  # chunks [0, 2) [2, 4) [4, 6) [6, 7): streams end in chunks 0, 1 and 3
    ([7, 7, 8], False),  # every stream in the last chunk
    ([2, 6, 5, 4], False),  # chunks of 2, the last one whole; two streams early
    ([1, 2], False),  # shorter than _OVERLAP_MIN_BLOCKS: one launch
    ([1, 7], True),  # block-parallel: one launch
])
def test_pile_counters_follow_the_chunks(monkeypatch, nbs, parallel):
    """With the chunk constants shrunk, the pile counters equal what the
    streams' lengths imply, and the pile waits once a chunk, each wait and
    stage nested in ``aad.encode_batch``; chunk k + 1 is staged only once
    chunk k's copy down is queued."""
    monkeypatch.setattr(enc_mod, "_OVERLAP_MIN_BLOCKS", 3)
    monkeypatch.setattr(enc_mod, "_OVERLAP_CHUNK_BLOCKS", 2)
    pile = pile_of(nbs)
    out, prof, gained = recorded(lambda: aad_tpu_torch.encode_batch(pile, CFG, device="cpu", parallel_blocks=parallel))
    want = pile_counts(nbs, parallel)
    assert {k: gained.get(k, 0) for k in want} == want
    spans = program_spans(prof)
    for name in ("aad.encode_batch.stage", "aad.encode_batch.wait", "aad.encode_batch.assemble"):
        found = [parent_of(e, spans) for e in spans if e.name() == name]
        assert found == ["aad.encode_batch"] * want["pile_chunks"], name
    order = [e.name() for e in spans if e.name() in ("aad.encode_batch.stage", "aad.d2h")]
    assert order == ["aad.encode_batch.stage", "aad.d2h"] * want["pile_chunks"]
    assert out == aad_tpu_torch.encode_batch(pile, CFG, device="cpu", parallel_blocks=parallel)


@pytest.mark.parametrize("nbs,parallel", [
    ([1, 3, 7], False),  # chunks [0, 2) [2, 4) [4, 6) [6, 7)
    ([2, 6, 5, 4], False),  # chunks of 2, the last one whole
    ([1, 2], False),  # one launch
    ([1, 7], True),  # block-parallel: one launch
])
def test_pile_pad_bytes_count_the_zeros_staged(monkeypatch, nbs, parallel):
    """``pile_pad_bytes`` counts the pile's upload less its samples, in a
    pile of several chunks and of one alike: every block of the pile less the
    stream's own samples; the pile's upload is both."""
    monkeypatch.setattr(enc_mod, "_OVERLAP_MIN_BLOCKS", 3)
    monkeypatch.setattr(enc_mod, "_OVERLAP_CHUNK_BLOCKS", 2)
    pile = pile_of(nbs)
    _, _, gained = recorded(lambda: aad_tpu_torch.encode_batch(pile, CFG, device="cpu", parallel_blocks=parallel))
    samples = sum(p.shape[1] for p in pile)
    assert gained["pile_pad_bytes"] == (len(pile) * max(nbs) * NSPB - samples) * 2 * 2
    assert gained["h2d_bytes"] == gained["pile_pad_bytes"] + samples * 2 * 2


@pytest.mark.parametrize("nbs,parallel", [
    ([1, 3, 7], False),  # chunks [0, 2) [2, 4) [4, 6) [6, 7): streams end in chunks 0, 1 and 3
    ([2, 6, 5, 4], False),  # chunks of 2, the last one whole
    ([1, 2], False),  # one launch
    ([1, 7], True),  # block-parallel: one launch
])
def test_pile_zero_bytes_count_the_tails_of_last_blocks(monkeypatch, nbs, parallel):
    """``pile_zero_bytes`` counts the zeros the host writes, in either layout:
    each stream's last block from its last sample on, and nothing for the
    blocks past it; ``pile_pad_bytes`` still counts the whole upload less the
    samples. One stream ends on a block boundary, with no tail."""
    monkeypatch.setattr(enc_mod, "_OVERLAP_MIN_BLOCKS", 3)
    monkeypatch.setattr(enc_mod, "_OVERLAP_CHUNK_BLOCKS", 2)
    pile = pile_of(nbs) + [_pcm(9, 2 * NSPB)]
    nbs = nbs + [2]
    _, _, gained = recorded(lambda: aad_tpu_torch.encode_batch(pile, CFG, device="cpu", parallel_blocks=parallel))
    samples = [p.shape[1] for p in pile]
    assert gained["pile_zero_bytes"] == sum((nb * NSPB - n) * 2 * 2 for nb, n in zip(nbs, samples))
    assert gained["pile_pad_bytes"] == (len(pile) * max(nbs) * NSPB - sum(samples)) * 2 * 2


@contextlib.contextmanager
def garbage_staging(seed: int):
    """Inside the block, every int16 host tensor that ``torch.empty`` makes
    (a pile's staging buffer among them, ``Transfer.host``'s) holds random
    int16, as a reused buffer does. Yields
    the list of (tensor, a copy of what it held at first), in the order
    made."""
    rng = np.random.default_rng(seed)
    made, empty = [], torch.empty

    def filled(*args, **kwargs):
        t = empty(*args, **kwargs)
        if t.dtype == torch.int16 and t.device.type == "cpu":
            t.numpy()[...] = rng.integers(-(1 << 15), 1 << 15, t.shape, dtype=np.int16)
            made.append((t, t.clone()))
        return t

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(torch, "empty", filled)
        yield made


def test_spans_and_counts_leave_results_alone():
    """The same bytes and samples with the profiler on and off."""
    call, _, _ = encode_batch_case("cpu")
    assert recorded(call)[0] == call()
    call, _, _ = push_case("cpu")
    assert np.array_equal(recorded(call)[0], call())
