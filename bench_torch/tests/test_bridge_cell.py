"""The conference bridge cell, ``b4s128mono-bridge-encode``, on the CPU at a
tiny size: its configuration (``configs/aad-b4-s128-mono.json``: 1 channel,
4 bits, 2 trials) under the ``bridge-encode`` mix, cut to a few slots of
short feeds, its blocks to 48 bytes (64 samples) and its tick to 90
samples, and run through the plain versions of the kernels.

A sound run is correct; one whose bank takes a slot's carry from its
neighbour is not. A run recorded under torch.profiler gives each of the
cell's readers a number: the span and counter readers from the CPU run's
own spans and counters, the device readers from a stand-in timeline of the
card's (copy up, kernel 3, kernel 4, copy down a tick)."""

from __future__ import annotations

import copy

import pytest
import torch
from conftest import run_cpu
from test_mono_cell import _recorded

from aad_tpu_torch.codec import streaming
from aad_tpu_torch.utils import trace as program
from harness import entry as base
from harness import spans, spec, traffic
from harness import trace as tr

CELL = "b4s128mono-bridge-encode"
OWN = ["bank_host_us", "bank_wait_us", "feeds_per_launch.bank", "k3_wire_roofline.bank"]
SHARED = ["device_idle_pct.encode", "device_ops_per_push.encode", "chain_us_per_push.encode", "copy_gb_per_s.encode"]


def bridge_cell(count: int = 4, samples=(150, 400), push: int = 90):
    """The cell with ``count`` slots of ``samples`` [lo, hi] samples a feed
    (log-uniform), 48-byte blocks (64 samples), ``push`` samples a tick,
    joins over 3 ticks, 2 slots and 2 ticks kept whole."""
    c = spec.Cell(spec.benchmark(), CELL)
    c.traffic, c.config = copy.deepcopy(c.traffic), copy.deepcopy(c.config)
    rate = c.config["sampling_rate"]
    c.traffic["clips"] = dict(count=count, seconds=[samples[0] / rate, samples[1] / rate])
    c.traffic.update(push_samples=push, join_ticks=3, warm_requests=4, check=dict(slots=2, ticks=2))
    c.config["max_block_size"] = 48
    return c


def test_the_cell_is_a_mono_bridge_and_reports_its_readers():
    c = spec.Cell(spec.benchmark(), CELL)
    cfg = c.config
    assert (cfg["num_channels"], cfg["bits_per_sample"], cfg["max_block_size"], cfg["ch_process_method"],
            cfg["num_encode_trials"], cfg["sampling_rate"]) == (1, 4, 128, 0, 2, 16000)
    assert cfg["num_samples_per_block"] == base.geometry(cfg).nspb == 224
    assert c.traffic["entry"] == "bridge_encode" and c.chips == 1
    assert c.traffic["clips"]["count"] == 1024 and c.traffic["push_samples"] == 320  # 20 ms at 16 kHz
    assert {m["name"] for m in c.end_to_end()} == {"encode_samples_per_s", "setup_s"}
    assert {m["name"] for m in c.per_layer()} == set(OWN + SHARED)


def test_the_tiny_cell_is_correct():
    res = run_cpu(bridge_cell(), seconds=1.0)
    assert res["correct"] is True and res["failed"] == 0
    assert res["compared"] == {"bad_blocks": {"value": 0, "limit": 0}}
    assert res["metrics"]["encode_samples_per_s"]["value"] > 0


def test_a_carry_from_the_neighbour_is_not_correct(monkeypatch):
    """The bank's encode, each tick, gives a carried feed's slot its
    neighbour's carry first: its next block starts from another feed's state."""
    real = streaming.encode_bank

    def neighbours(pcm, feeds, geo, num_trials, *, carry, **kwargs):
        carried = feeds[feeds[:, 4] > 0]
        if len(carried):
            s = int(carried[0, 0])
            t = (s + 1) % carry.slots
            for a in carry.end:
                a[s] = a[t].clone()
            carry.prev[:, s] = carry.prev[:, t].clone()
        return real(pcm, feeds, geo, num_trials, carry=carry, **kwargs)

    monkeypatch.setattr(streaming, "encode_bank", neighbours)
    res = run_cpu(bridge_cell(), seconds=1.0)
    assert res["correct"] is False
    assert res["compared"]["bad_blocks"]["value"] > res["compared"]["bad_blocks"]["limit"]


def test_each_reader_reads_a_recorded_cpu_run(monkeypatch):
    monkeypatch.setattr(program, "counts", {})  # this run's counters alone
    cell = bridge_cell(count=3, samples=(150, 200))
    t, _ = _recorded(cell, 2**31 + 23, requests=6)
    assert len(t.requests) == 6

    # the card's timeline, each tick in eighths: the copy up in the first,
    # kernel 3 over the second to the fifth, kernel 4 in the sixth, the copy down in the seventh
    def ops(r):
        e = (r.end - r.start) / 8
        return [tr.Op("Memcpy HtoD (Pinned -> Device)", 0, r.start, r.start + e),
                tr.Op("void aad::encode_stream_paired_kernel<4, true, true, true, true>(...)", 0, r.start + e,
                      r.start + 5 * e),
                tr.Op("void aad::bank_encode_pass_kernel<4>(...)", 0, r.start + 5 * e, r.start + 6 * e),
                tr.Op("Memcpy DtoH (Device -> Pageable)", 0, r.start + 6 * e, r.start + 7 * e)]

    t.ops = [o for r in t.requests for o in ops(r)]
    got = tr.read_metrics(t, [m["name"] for m in cell.per_layer()])
    assert set(got) == set(OWN + SHARED), got
    assert got["device_ops_per_push.encode"] == 4
    kernels = sum(o.seconds for o in t.ops if o.kind == "kernel")
    assert got["chain_us_per_push.encode"] == pytest.approx(1e6 * kernels / 6)
    assert got["device_idle_pct.encode"] == pytest.approx(100 * (1 - sum(o.seconds for o in t.ops) / t.window_s))
    assert got["feeds_per_launch.bank"] == pytest.approx(program.counts["bank_feeds"] / 6)
    copies = sum(o.seconds for o in t.ops if o.kind == "memcpy")
    moved = program.counts["h2d_bytes"] + program.counts["d2h_bytes"]
    assert got["copy_gb_per_s.encode"] == pytest.approx(moved / copies / 1e9)
    w, peaks = t.work("k3_wire"), t.work("peaks")
    k3 = sum(o.seconds for o in t.ops if "encode_stream" in o.name)
    least = sum(peaks.least_seconds(*w.work(r.work)) for r in t.requests)
    assert 0 < got["k3_wire_roofline.bank"] == pytest.approx(100 * least / k3)
    ticks = spans.named(t, "aad.stream_encode.bank")
    assert len(ticks) == 6
    total = 1e6 * sum(s.seconds for s in ticks) / 6
    assert 0 < got["bank_wait_us"] < total
    assert got["bank_host_us"] == pytest.approx(total - got["bank_wait_us"])


def test_the_work_of_a_tick_counts_each_feeds_blocks():
    """k3_wire's count of a feed's first tick equals k3_encode's of the
    same samples as a stream; a carried tick adds its first block's
    re-encode of the carry's block."""
    t = tr.Trace([], [], [], [0])
    w3, ww = t.work("k3_encode"), t.work("k3_wire")
    nspb, trials, n = 224, 2, 2 * 224 + 100
    stream = dict(n=n, channels=1, nspb=nspb, wire_bytes=0, trials=trials)
    coded = 2 * (nspb - 4) + 96
    first = dict(channels=1, nspb=nspb, trials=trials, samples=n, coded=coded, warm_blocks=2, wire_bytes=0)
    assert ww.work([first]) == w3.work([stream])
    carried = dict(first, warm_blocks=3)
    assert ww.sample_passes(carried) - ww.sample_passes(first) == trials * (nspb - 4)
    assert ww.OPS_PER_SAMPLE_PASS == w3.OPS_PER_SAMPLE_PASS == 24


def test_the_entrys_work_is_the_ticks_totals():
    """The entry's work of a tick, against a count feed by feed."""
    cell = bridge_cell(count=3, samples=(150, 200))
    plan = traffic.Plan(cell.traffic, cell.config, 2**31 + 29)
    ctx = base.Context(cell.config, cell.traffic, plan, [torch.device("cpu")])
    entry = base.load("bridge_encode").ENTRY(ctx)
    nspb = ctx.geo.nspb
    done = [0] * entry.slots
    for i in range(8):
        before = entry.pos.copy()
        out = entry.call(i)
        (ends, _, n, finish), data, offsets, _ = out
        (got,) = entry.work(i)
        blocks = coded = warm = samples = 0
        for s in range(entry.slots):
            whole = -(-ends[s] // nspb) if finish[s] else ends[s] // nspb
            b = whole - before[s] // nspb
            k = (ends[s] if finish[s] else whole * nspb) - before[s] // nspb * nspb
            blocks, samples = blocks + b, samples + k
            coded += sum(max(min(nspb, k - j * nspb) - 4, 0) for j in range(b))
            warm += b - (1 if b and done[s] == 0 else 0)
            done[s] = 0 if finish[s] else done[s] + b
        assert got == dict(channels=1, nspb=nspb, trials=2, samples=samples, blocks=blocks, coded=coded,
                           warm_blocks=warm, wire_bytes=len(data))


def test_readers_find_nothing_in_another_cells_window():
    host = [tr.Op("aad.stream_encode.push", -1, 1.0, 2.0), tr.Op("aad.d2h", -1, 1.5, 1.9)]
    t = tr.Trace([], host, [tr.Request(0.0, 5.0, [])], [0])
    assert tr.read_metrics(t, OWN) == {}
