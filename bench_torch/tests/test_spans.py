"""The program-span readers on synthetic traces: ``harness/spans.py``'s
nesting and self time, and the six readers of the program's spans and
counters, on traces with known nesting and times; each finds nothing
without its spans, and a span outside every request counts for nothing."""

from __future__ import annotations

import pytest
from conftest import BENCH

from aad_tpu_torch.utils import trace as program
from harness import spans
from harness import trace as tr

READERS = ["stage_ms.encode", "assemble_ms.encode", "copy_gb_per_s.encode", "push_host_us", "push_wait_us",
           "shard_host_ms.sharded"]


def _host(*spec):
    return [tr.Op(name, -1, a, b) for name, a, b in spec]


def _encode_trace():
    """Two encode_batch requests of 10 s each, and spans past the window."""
    host = _host(
        ("aad.encode_batch", 1.0, 9.0),
        ("aad.encode_batch.check", 1.0, 2.0),
        ("aad.encode_batch.stage", 2.0, 5.0),
        ("aten::empty", 2.0, 2.5),  # torch's own work inside a span counts as the span's
        ("aad.h2d", 4.0, 4.5),
        ("aad.launch.encode_stream", 5.0, 5.25),
        ("aad.d2h", 5.5, 8.0),
        ("aad.encode_batch.assemble", 8.0, 8.75),
        ("aad.encode_batch", 11.0, 19.0),
        ("aad.encode_batch.check", 11.0, 11.5),
        ("aad.encode_batch.stage", 11.5, 13.5),
        ("aad.h2d", 13.0, 13.5),
        ("aad.d2h", 14.0, 18.0),
        ("aad.encode_batch.assemble", 18.0, 18.5),
        ("aad.encode_batch.stage", 25.0, 30.0),  # outside every request
        ("aad.encode_batch.assemble", 9.5, 10.5),  # across two requests: in neither
    )
    ops = [tr.Op("Memcpy HtoD (Pinned -> Device)", 0, 4.0, 4.5), tr.Op("Memcpy DtoH (Device -> Pinned)", 0, 7.0, 7.5),
           tr.Op("Memcpy HtoD (Pinned -> Device)", 0, 13.0, 14.0), tr.Op("Memcpy DtoD", 0, 15.0, 16.0),
           tr.Op("encode_stream_paired_kernel", 0, 5.0, 7.0)]
    return tr.Trace(ops, host, [tr.Request(0.0, 10.0, []), tr.Request(10.0, 20.0, [])], [0])


def _push_trace():
    """Three pushes; the last returns before its copies (no block whole)."""
    host = _host(
        ("aad.stream_decode.push", 0.0, 0.001),
        ("aad.push.frame", 0.0, 0.0002),
        ("aad.h2d", 0.0002, 0.0003),
        ("aad.decode.pcm", 0.0004, 0.0006),
        ("aad.launch.decode_lanes", 0.0005, 0.00055),
        ("aad.d2h", 0.0007, 0.001),
        ("aad.stream_decode.push", 0.002, 0.0025),
        ("aad.d2h", 0.0024, 0.0025),
        ("aad.stream_decode.push", 0.003, 0.0031),
        ("aad.push.frame", 0.003, 0.0031),
        ("aad.stream_decode.push", 0.5, 0.6),  # outside every request
        ("aad.d2h", 0.5, 0.6),
    )
    reqs = [tr.Request(0.0, 0.001, []), tr.Request(0.0015, 0.0026, []), tr.Request(0.003, 0.0032, [])]
    return tr.Trace([tr.Op("decode_lanes_kernel", 0, 0.0005, 0.0006)], host, reqs, [0])


def _sharded_trace():
    host = _host(("aad.encode_streams_sharded", 1.0, 1.004), ("aad.sharded.scatter", 1.0, 1.001),
                 ("aad.encode_streams_sharded", 2.0, 2.006), ("aad.encode_streams_sharded", 9.0, 9.5))
    return tr.Trace([tr.Op("encode_stream_paired_kernel", 1, 1.0, 1.8)], host,
                    [tr.Request(0.9, 1.9, []), tr.Request(1.9, 2.9, [])], [0, 1])


def _read(name, t):
    return tr.load(BENCH / "metrics" / f"{name}.py").read(t)


def test_spans_nest_and_take_self_time():
    found = spans.spans(_encode_trace())
    assert [(s.name, s.start) for s in found][:3] == [("aad.encode_batch", 1.0), ("aad.encode_batch.check", 1.0),
                                                      ("aad.encode_batch.stage", 2.0)]
    assert len(found) == 13  # the two spans outside every request are left out
    top = found[0]
    assert [c.name for c in top.children] == ["aad.encode_batch.check", "aad.encode_batch.stage",
                                              "aad.launch.encode_stream", "aad.d2h", "aad.encode_batch.assemble"]
    assert top.self_seconds == pytest.approx(8.0 - 1.0 - 3.0 - 0.25 - 2.5 - 0.75)
    stage = top.children[1]
    assert [c.name for c in stage.children] == ["aad.h2d"] and stage.self_seconds == pytest.approx(2.5)
    assert [s.name for s in top.within("aad.h2d", "aad.d2h")] == ["aad.h2d", "aad.d2h"]


def test_encode_readers(monkeypatch):
    t = _encode_trace()
    monkeypatch.setattr(program, "counts", {"h2d_bytes": 6e9, "d2h_bytes": 2e9, "other": 5})
    got = tr.read_metrics(t, READERS)
    assert set(got) == {"stage_ms.encode", "assemble_ms.encode", "copy_gb_per_s.encode"}
    # check 1.0 + 0.5, stage (3.0 - 0.5) + (2.0 - 0.5), over two requests
    assert got["stage_ms.encode"] == pytest.approx((1.5 + 2.5 + 1.5) / 2 * 1e3)
    assert got["assemble_ms.encode"] == pytest.approx((0.75 + 0.5) / 2 * 1e3)
    # 8 GB over the HtoD and DtoH copies' 2 s (not the DtoD)
    assert got["copy_gb_per_s.encode"] == pytest.approx(4.0)


def test_push_readers():
    got = tr.read_metrics(_push_trace(), READERS)
    assert set(got) == {"push_host_us", "push_wait_us"}
    assert got["push_host_us"] == pytest.approx((700 + 400 + 100) / 3)
    assert got["push_wait_us"] == pytest.approx((300 + 100 + 0) / 3)


def test_sharded_reader():
    got = tr.read_metrics(_sharded_trace(), READERS)
    assert got == {"shard_host_ms.sharded": pytest.approx((4 + 6) / 2)}


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_their_spans(name, monkeypatch):
    """A trace with requests, device work and torch's host operations, but
    none of the program's spans, as a program without them gives; and the
    copy rate without counters, or without copies."""
    monkeypatch.setattr(program, "counts", {})
    host = _host(("aten::copy_", 1.0, 2.0), ("cudaLaunchKernel", 3.0, 3.1), ("aad.encode_batch", 30.0, 31.0))
    ops = [tr.Op("Memcpy HtoD (Pinned -> Device)", 0, 1.0, 2.0), tr.Op("some_kernel", 0, 3.0, 4.0)]
    t = tr.Trace(ops, host, [tr.Request(0.0, 5.0, [])], [0])
    assert _read(name, t) is None
    if name == "copy_gb_per_s.encode":
        monkeypatch.setattr(program, "counts", {"h2d_bytes": 10})
        assert _read(name, tr.Trace([tr.Op("some_kernel", 0, 3.0, 4.0)], host, t.requests, [0])) is None
        assert _read(name, t) == pytest.approx(10 / 1.0 / 1e9)


def test_counters_are_none_without_the_program_module(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "aad_tpu_torch.utils.trace", None)  # an import of it raises
    assert spans.counts() is None
