"""The mono 2-bit cell, ``b2s1024mono-archive-encode``, on the CPU at a tiny
size: its configuration (``configs/aad-b2-s1024-mono.json``: 1 channel, 2
bits, no mid/side, 2 trials) under the ``archive-encode`` mix, cut as
``conftest.tiny_cell`` cuts a cell (6 clips of 0.01-0.05 s, the blocks to
128 bytes) and run through the plain versions of the kernels.

A sound run is correct; one whose answer is altered is not. A run recorded
under torch.profiler gives each of the cell's seven readers a number: the
five it shares with ``b4s1024-archive-encode`` and its own two. The
program's spans and counters are the CPU run's own; the card's timeline,
which a CPU run has none of, is a stand-in copy up, kernel 3 op and copy
down a request."""

from __future__ import annotations

import copy

import pytest
import torch
from conftest import run_cpu
from test_faults import archive_altered
from torch.profiler import ProfilerActivity, profile

from aad_tpu_torch.utils import trace as program
from harness import entry as base
from harness import spec, traffic
from harness import trace as tr

CELL = "b2s1024mono-archive-encode"
SHARED = ["k3_encode_roofline", "device_idle_pct.encode", "stage_ms.encode", "assemble_ms.encode",
          "copy_gb_per_s.encode"]  # the readers of the stereo archive cell
READERS = SHARED + ["launch_wait_ms.mono", "pile_pad_pct.mono"]


def mono_cell(count: int = 6, seconds=(0.01, 0.05), max_block_size: int = 128):
    c = spec.Cell(spec.benchmark(), CELL)
    c.traffic, c.config = copy.deepcopy(c.traffic), copy.deepcopy(c.config)
    c.traffic["clips"] = dict(count=count, seconds=list(seconds))  # log-uniform
    c.traffic["warm_requests"] = 1
    c.config["max_block_size"] = max_block_size
    return c


def test_the_cell_is_mono_2_bit_and_reports_its_metrics():
    c = spec.Cell(spec.benchmark(), CELL)
    assert (c.config["num_channels"], c.config["bits_per_sample"], c.config["ch_process_method"]) == (1, 2, 0)
    assert c.traffic["entry"] == "encode_batch" and c.chips == 1
    assert {m["name"] for m in c.end_to_end()} == {"encode_samples_per_s", "setup_s"}
    assert {m["name"] for m in c.per_layer()} == set(READERS)


def test_the_tiny_cell_is_correct():
    res = run_cpu(mono_cell())
    assert res["correct"] is True and res["failed"] == 0
    assert res["compared"] == {"bad_blocks": {"value": 0, "limit": 0}}
    assert res["metrics"]["encode_samples_per_s"]["value"] > 0


def test_an_altered_answer_is_not_correct(monkeypatch):
    cell = mono_cell()
    archive_altered(monkeypatch)
    res = run_cpu(cell)
    assert res["correct"] is False
    assert res["compared"]["bad_blocks"]["value"] > res["compared"]["bad_blocks"]["limit"]


def _recorded(cell, seed: int, requests: int):
    """``requests`` requests of ``cell`` on the CPU under torch.profiler, as
    run.py traces them: (the window's Trace, the plan)."""
    torch.set_num_threads(int(cell.traffic["host_threads"]))
    plan = traffic.Plan(cell.traffic, cell.config, seed)
    ctx = base.Context(cell.config, cell.traffic, plan, [torch.device("cpu")])
    entry = base.load(cell.traffic["entry"]).ENTRY(ctx)
    entry.warm()
    works = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(requests):
            with torch.profiler.record_function(tr.REQUEST_SPAN):
                entry.call(i)
            works.append(entry.work(i))
    return tr.from_profiler(prof, works, [0]), plan


def test_each_reader_reads_a_recorded_cpu_run(monkeypatch):
    monkeypatch.setattr(program, "counts", {})  # this run's counters alone
    cell = mono_cell(count=3, seconds=(0.02, 0.04))
    t, plan = _recorded(cell, 2**31 + 23, requests=2)
    assert len(t.requests) == 2
    # the card's timeline, each request in eighths: the copy up in the
    # second, kernel 3 over the third to the sixth, the copy down in the seventh
    def ops(r):
        e = (r.end - r.start) / 8
        return [tr.Op("Memcpy HtoD (Pinned -> Device)", 0, r.start + e, r.start + 2 * e),
                tr.Op("void aad::encode_stream_paired_kernel<2, true, true>(...)", 0, r.start + 2 * e,
                      r.start + 6 * e),
                tr.Op("Memcpy DtoH (Device -> Pinned)", 0, r.start + 6 * e, r.start + 7 * e)]

    t.ops = [o for r in t.requests for o in ops(r)]
    got = tr.read_metrics(t, READERS)
    assert set(got) == set(READERS), got
    assert got["device_idle_pct.encode"] == pytest.approx(100 * (1 - sum(o.seconds for o in t.ops) / t.window_s))
    w3, peaks = t.work("k3_encode"), t.work("peaks")
    least = sum(peaks.least_seconds(*w3.work(r.work)) for r in t.requests)
    kernel_s = sum(o.seconds for o in t.ops if o.kind == "kernel")
    assert got["k3_encode_roofline"] == pytest.approx(100 * least / kernel_s)
    counted = program.counts
    copy_s = sum(o.seconds for o in t.ops if o.kind == "memcpy")
    assert got["copy_gb_per_s.encode"] == pytest.approx((counted["h2d_bytes"] + counted["d2h_bytes"]) / copy_s / 1e9)
    assert got["stage_ms.encode"] > 0 and got["assemble_ms.encode"] > 0 and got["launch_wait_ms.mono"] >= 0
    # the pile stream-major: every stream padded to the longest's blocks
    nspb = base.geometry(cell.config).nspb
    lengths = [plan.lengths[j] for j in plan.request_clips(0)]
    blocks = max(-(-n // nspb) for n in lengths)
    assert got["pile_pad_pct.mono"] == pytest.approx(100 * (1 - sum(lengths) / (len(lengths) * blocks * nspb)))


def test_readers_find_nothing_in_another_cells_window(monkeypatch):
    """A window of pushes, with counters left from another window: none of
    the seven reads anything (the counter's reader needs ``encode_batch``
    requests as well)."""
    monkeypatch.setattr(program, "counts", {"pile_pad_bytes": 10, "h2d_bytes": 100})
    host = [tr.Op("aad.stream_decode.push", -1, 1.0, 2.0)]
    t = tr.Trace([], host, [tr.Request(0.0, 5.0, [])], [0])
    assert tr.read_metrics(t, READERS) == {}
