"""The live mid/side encode cell, ``b4s128ms-live-encode``, on the CPU at a
tiny size: its configuration (``configs/aad-b4-s128-ms-stereo.json``: 2
channels, 4 bits, mid/side, 2 trials) under the ``live-encode`` mix, cut to
a few feeds of a few pushes, its blocks to 48 bytes (16 samples a channel)
and its push to 2 blocks, and run through the plain versions of the kernels.

A sound run is correct; one with a block altered, or a push's bytes
dropped, is not; the control fails it (the program there on its native
host engine, to reach the blocks where float32 shows). A run recorded under torch.profiler
gives each of the cell's own readers a number: the two span readers from
the CPU run's own spans, the two device readers from a stand-in timeline of
the card's (copy up, kernel 3, kernel 4, copy down a request)."""

from __future__ import annotations

import copy
import functools

import pytest
from conftest import run_cpu
from test_mono_cell import _recorded

import aad_tpu_torch as at
from harness import entry as base
from harness import spans, spec
from harness import trace as tr

CELL = "b4s128ms-live-encode"
OWN = ["encode_push_host_us", "encode_push_wait_us", "device_ops_per_push.encode", "chain_us_per_push.encode"]
BLOCK = 48  # bytes: 16 samples a channel, the plain encode's work kept small


def live_cell(count: int = 3, samples=(40, 90), push_blocks: int = 2):
    """The cell with ``count`` feeds of ``samples`` [lo, hi] samples a
    channel (log-uniform), blocks of BLOCK bytes, ``push_blocks`` blocks a push."""
    c = spec.Cell(spec.benchmark(), CELL)
    c.traffic, c.config = copy.deepcopy(c.traffic), copy.deepcopy(c.config)
    rate = c.config["sampling_rate"]
    c.traffic["clips"] = dict(count=count, seconds=[samples[0] / rate, samples[1] / rate])
    c.traffic["warm_requests"] = 1
    c.config["max_block_size"] = BLOCK
    c.traffic["push_samples"] = push_blocks * base.geometry(c.config).nspb
    return c


def test_the_cell_is_a_mid_side_live_encoder_and_reports_its_readers():
    c = spec.Cell(spec.benchmark(), CELL)
    cfg = c.config
    assert (cfg["num_channels"], cfg["bits_per_sample"], cfg["max_block_size"], cfg["ch_process_method"],
            cfg["num_encode_trials"]) == (2, 4, 128, 1, 2)
    assert c.traffic["entry"] == "stream_encode" and c.chips == 1
    assert c.traffic["push_samples"] == 10 * cfg["num_samples_per_block"] == 960  # 20 ms at 48 kHz
    assert {m["name"] for m in c.end_to_end()} == {"encode_samples_per_s", "setup_s"}
    assert set(OWN + ["device_idle_pct.encode"]) <= {m["name"] for m in c.per_layer()}


def test_the_tiny_cell_is_correct():
    res = run_cpu(live_cell(), seconds=1.5)
    assert res["correct"] is True and res["failed"] == 0
    assert res["compared"] == {"bad_blocks": {"value": 0, "limit": 0}}
    assert res["metrics"]["encode_samples_per_s"]["value"] > 0


def _altered(mp):
    real = at.StreamingEncoder.push

    def push(self, pcm):
        data = real(self, pcm)
        if data:
            data = bytearray(data)
            data[-1] ^= 0x10  # a code of the push's last block
            data = bytes(data)
        return data
    mp.setattr(at.StreamingEncoder, "push", push)


def _dropped(mp):
    real = at.StreamingEncoder.push
    dropped = []

    def push(self, pcm):
        later = self.num_samples > 0  # a feed's second push or later: in the window, not its warm-up
        data = real(self, pcm)
        if later and data and not dropped:
            dropped.append(data)
            return b""
        return data
    mp.setattr(at.StreamingEncoder, "push", push)


@pytest.mark.parametrize("fault", [_altered, _dropped], ids=["altered", "dropped"])
def test_a_broken_push_is_not_correct(monkeypatch, fault):
    cell = live_cell()
    fault(monkeypatch)
    res = run_cpu(cell, seconds=1.5)
    assert res["correct"] is False
    assert res["compared"]["bad_blocks"]["value"] > res["compared"]["bad_blocks"]["limit"]


def test_the_control_fails(monkeypatch):
    """float32 in the reference's prediction shows only over thousands of
    blocks: the cell's own blocks and push, four feeds of 0.4-0.6 s, the
    program on its native host engine (bit-exact with the kernels' plain
    versions, and fast enough on the CPU to give the window those blocks)."""
    cell = live_cell(count=4, samples=(20_000, 30_000), push_blocks=10)
    cell.config["max_block_size"] = 128
    cell.traffic["push_samples"] = 960
    monkeypatch.setattr(at, "StreamingEncoder", functools.partial(at.StreamingEncoder, engine="native"))
    res = run_cpu(cell, seed=2**31 + 99, seconds=0.5, control=True)
    assert res["correct"] is True
    assert res["control"]["bad_blocks"] > 0, res["control"]


def test_each_reader_reads_a_recorded_cpu_run():
    cell = live_cell(count=2, samples=(40, 50))
    t, _ = _recorded(cell, 2**31 + 23, requests=4)
    assert len(t.requests) == 4

    # the card's timeline, each request in eighths: the copy up in the first,
    # kernel 3 over the second to the fifth, kernel 4 in the sixth, the copy down in the seventh
    def ops(r):
        e = (r.end - r.start) / 8
        return [tr.Op("Memcpy HtoD (Pageable -> Device)", 0, r.start, r.start + e),
                tr.Op("void aad::encode_stream_paired_kernel<4, true, true>(...)", 0, r.start + e, r.start + 5 * e),
                tr.Op("void aad::encode_pass_kernel<4>(...)", 0, r.start + 5 * e, r.start + 6 * e),
                tr.Op("Memcpy DtoH (Device -> Pageable)", 0, r.start + 6 * e, r.start + 7 * e)]

    t.ops = [o for r in t.requests for o in ops(r)]
    names = [m["name"] for m in cell.per_layer()]
    got = tr.read_metrics(t, names)
    assert set(OWN) <= set(got), got
    assert got["device_ops_per_push.encode"] == 4
    chain = sum(o.seconds for o in t.ops if o.kind == "kernel")
    assert got["chain_us_per_push.encode"] == pytest.approx(1e6 * chain / 4)
    assert got["device_idle_pct.encode"] == pytest.approx(100 * (1 - sum(o.seconds for o in t.ops) / t.window_s))
    # every push's span holds one copy down, whose wait is part of the push
    pushes = spans.named(t, "aad.stream_encode.push")
    assert len(pushes) == 4
    total = 1e6 * sum(p.seconds for p in pushes) / 4
    assert 0 < got["encode_push_wait_us"] < total
    assert got["encode_push_host_us"] == pytest.approx(total - got["encode_push_wait_us"])


def test_readers_find_nothing_in_another_cells_window():
    """A window of decode pushes with no device operations: none of the
    cell's own four reads anything."""
    host = [tr.Op("aad.stream_decode.push", -1, 1.0, 2.0), tr.Op("aad.d2h", -1, 1.5, 1.9)]
    t = tr.Trace([], host, [tr.Request(0.0, 5.0, [])], [0])
    assert tr.read_metrics(t, OWN) == {}
