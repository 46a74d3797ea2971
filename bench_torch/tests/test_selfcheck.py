"""The benchmark's self-check on the CPU: BENCHMARK.json against the
contract's shape, the generators' determinism, the traffic's lengths, the
work counts, the readers' arithmetic, the reference against the program's
plain versions, and the result line's keys. No device metric comes out of
it, and a measuring run without a card fails."""

from __future__ import annotations

import json
import math
import re

import numpy as np
import pytest
import torch
from conftest import BENCH, tiny_cell

import aad_tpu_torch as at
import run as bench_run
from harness import entry, signal, spec, traffic
from harness import trace as tr
from reference import aad as R

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
BENCHMARK = spec.benchmark()


def test_benchmark_json_shape():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and b["paths"] == ["bench_torch"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)
    configs = {c["name"] for c in b["configs"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_torch/") and (BENCH.parent / c["file"]).is_file()
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in b["workloads"]:
        cell = spec.Cell(b, w["name"])
        reported = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer()
        for m in cell.per_layer():
            assert m["moves"] in reported


@pytest.mark.parametrize("name", [c["name"] for c in BENCHMARK["configs"]])
def test_config_files_hold_their_geometry(name):
    cfg = spec.load_json(BENCH / "configs" / f"{name}.json")
    geo = R.Geometry(cfg["num_channels"], cfg["bits_per_sample"], cfg["max_block_size"])
    assert (geo.block_size, geo.nspb, geo.header_bytes) == (
        cfg["block_size"], cfg["num_samples_per_block"], cfg["block_header_bytes"])
    prog = at.compute_block_geometry(cfg["max_block_size"], cfg["num_channels"], cfg["bits_per_sample"])
    assert (prog.block_size, prog.num_samples_per_block) == (geo.block_size, geo.nspb)


@pytest.mark.parametrize("mix", sorted(p.stem for p in (BENCH / "traffic").glob("*.json")))
def test_traffic_lengths_and_determinism(mix):
    m = spec.load_json(BENCH / "traffic" / f"{mix}.json")
    assert m["source"] and int(m["host_threads"]) >= 1
    rate = 48000
    lo, hi = m["clips"]["seconds"]
    lengths = traffic.clip_lengths(m, rate)
    assert len(lengths) == m["clips"]["count"] and lengths == sorted(lengths)
    assert lo * rate <= lengths[0] and lengths[-1] <= hi * rate
    if m["clips"].get("law", "log-uniform") == "log-uniform":
        mean = (hi - lo) / math.log(hi / lo) * rate
    else:
        mean = m["clips"]["mean"] * rate
    assert abs(np.mean(lengths) / mean - 1) < 0.02
    cfg = {"sampling_rate": rate}
    a, b, c = traffic.Plan(m, cfg, 2**31 + 5), traffic.Plan(m, cfg, 2**31 + 5), traffic.Plan(m, cfg, 6)
    assert a.lengths == b.lengths and a.cycle == b.cycle and a.signal_seed == b.signal_seed
    assert sorted(a.lengths) == sorted(c.lengths) == lengths  # the same work for every seed
    sizes = lambda p: sorted(sum(p.lengths[j] for j in comp) for comp in p.cycle)  # noqa: E731
    assert sizes(a) == sizes(c)
    assert a.signal_seed != c.signal_seed
    assert [a.keep(i) for i in range(64)] == [b.keep(i) for i in range(64)]


@pytest.mark.parametrize("lo,mean,hi", [(1.11, 6.57, 10.10), (1.0, 2.0, 4.0), (2.0, 2.5, 3.0)])
def test_triangular_law(lo, mean, hi):
    """Quantiles of the triangular law with the given least, most and mean."""
    clips = dict(count=4000, seconds=[lo, hi], law="triangular", mean=mean)
    s = traffic.clip_seconds(clips)
    assert s == sorted(s) and lo < s[0] and s[-1] < hi
    assert np.mean(s) == pytest.approx(mean, rel=1e-3)
    mode = 3 * mean - lo - hi
    assert np.mean(np.array(s) <= mode) == pytest.approx((mode - lo) / (hi - lo), abs=1e-3)
    with pytest.raises(ValueError):
        traffic.clip_seconds(dict(clips, mean=hi))


@pytest.mark.parametrize("mix", sorted(p.stem for p in (BENCH / "traffic").glob("*.json")))
def test_each_mix_finds_its_entry(mix):
    m = spec.load_json(BENCH / "traffic" / f"{mix}.json")
    api = entry.load(m["entry"])
    assert issubclass(api.ENTRY, entry.Entry) and api.LIMITS and all(v >= 0 for v in api.LIMITS.values())


def test_an_unknown_entry_is_refused():
    with pytest.raises(ValueError):
        entry.load("no_such_entry")


def test_signal_is_seeded():
    p = {"tones": 3, "amplitude": 9000, "noise_sd": 1000, "period_samples": [20, 400], "envelope_samples": [100, 900]}
    x = signal.render([500, 1200, 30], 2, p, 11, "cpu")
    assert x.shape == (2, 1730) and x.dtype == torch.int16
    assert torch.equal(x, signal.render([500, 1200, 30], 2, p, 11, "cpu"))
    assert not torch.equal(x, signal.render([500, 1200, 30], 2, p, 12, "cpu"))
    padded = signal.render([500, 1200, 30], 2, p, 11, "cpu", width=1300)
    for s, (a, n) in enumerate([(0, 500), (500, 1200), (1700, 30)]):
        assert torch.equal(padded[s, :, :n], x[:, a: a + n]) and not padded[s, :, n:].any()
    assert 1000 < float(x.float().std()) < 12000  # a loud signal, not silence or clipping


def test_work_counts():
    w1 = tr.load(BENCH / "work" / "k1_decode.py")
    assert w1.coded_samples(992 * 3 + 10, 992) == 3 * 988 + 6 and w1.coded_samples(3, 992) == 0
    s = dict(n=2000, channels=2, nspb=992, wire_bytes=1234, trials=2)
    assert w1.work([s]) == (1234 + 2 * 2000 * 2, 18 * (2 * 988 + 12) * 2)
    w3 = tr.load(BENCH / "work" / "k3_encode.py")
    # block 0: (1 + 2 trials) trial encodes + the emit over 988; block 1 (16 valid, 12 coded):
    # 3 trial encodes and the emit over 12, and 2 re-encodes of block 0 over 988
    assert w3.sample_passes(992 + 16, 992, 2) == 4 * 988 + 4 * 12 + 2 * 988
    peaks = tr.load(BENCH / "work" / "peaks.py")
    assert peaks.INT_OPS_PER_S == 132 * 128 * 1.98e9
    assert peaks.least_seconds(3.35e12, 0) == 1.0 and peaks.least_seconds(0, peaks.INT_OPS_PER_S) == 1.0


def _trace():
    ops = [tr.Op("void decode_lanes_kernel<4, true, 2>(...)", 0, 1.0, 1.5), tr.Op("Memcpy HtoD", 0, 1.4, 2.0),
           tr.Op("Memcpy DtoH", 0, 3.0, 3.5), tr.Op("encode_stream_kernel", 1, 1.0, 4.0)]
    host = [tr.Op("aten::cat", -1, 2.0, 3.0), tr.Op("outer", -1, 0.0, 10.0)]
    reqs = [tr.Request(1.0, 2.5, [dict(n=992, channels=2, nspb=992, wire_bytes=1024, trials=2)]),
            tr.Request(2.5, 5.0, [dict(n=992, channels=2, nspb=992, wire_bytes=1024, trials=2)])]
    return tr.Trace(ops, host, reqs, [0, 1])


def test_trace_arithmetic_and_readers():
    t = _trace()
    assert t.window == (1.0, 5.0) and t.busy(0) == pytest.approx(1.5) and t.busy(1) == pytest.approx(3.0)
    assert t.busy_mean() == pytest.approx(2.25)
    assert t.gaps()[0] == (3.5, 5.0)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["encode_stream_kernel", 3.0]
    assert bd["idle_gaps"][0][0] == "outer" and bd["idle_gaps"][1] == ["aten::cat", pytest.approx(1.0)]
    got = tr.read_metrics(t, ["copy_ms.decode", "device_ops_per_push", "device_idle_pct.decode",
                              "shard_busy_spread_pct", "k1_decode_roofline", "k3_encode_roofline",
                              "k3_encode_roofline.sharded"])
    assert got["copy_ms.decode"] == pytest.approx(1.1 / 2 * 1e3)
    assert got["device_ops_per_push"] == 2.0
    assert got["device_idle_pct.decode"] == pytest.approx(100 * (1 - 2.25 / 4))
    assert got["shard_busy_spread_pct"] == pytest.approx(50.0)
    peaks = tr.load(BENCH / "work" / "peaks.py")
    w1 = tr.load(BENCH / "work" / "k1_decode.py")
    least = sum(peaks.least_seconds(*w1.work(r.work)) for r in t.requests)
    assert got["k1_decode_roofline"] == pytest.approx(100 * least / 0.5)
    w3 = tr.load(BENCH / "work" / "k3_encode.py")
    least = sum(peaks.least_seconds(*w3.work(r.work)) for r in t.requests)
    assert got["k3_encode_roofline"] == got["k3_encode_roofline.sharded"] == pytest.approx(100 * least / 3.0)


def test_readers_find_nothing_without_device_ops():
    t = tr.Trace([], [], [tr.Request(0.0, 1.0, [])], [0])
    assert tr.read_metrics(t, [m["name"] for m in BENCHMARK["per_layer"]]) == {}


@pytest.mark.parametrize("bps,mbs,ms,ch", [(4, 1024, 0, 2), (3, 128, 1, 2), (2, 256, 0, 1)])
def test_reference_holds_the_plain_versions(bps, mbs, ms, ch):
    cfg = at.EncodeConfig(num_channels=ch, sampling_rate=48000, bits_per_sample=bps, max_block_size=mbs,
                          ch_process_method=ms)
    geo = R.Geometry(ch, bps, mbs)
    p = {"tones": 3, "amplitude": 9000, "noise_sd": 1000, "period_samples": [20, 400], "envelope_samples": [99, 999]}
    lengths = [geo.nspb * 2 + 17, geo.nspb, 3] if mbs > 256 else [geo.nspb * 5 + 1, geo.nspb * 3, 5]
    flat = signal.render(lengths, ch, p, 4, "cpu").numpy()
    clips = np.split(flat, np.cumsum(lengths)[:-1], axis=1)
    data = at.encode_batch(clips, cfg, device="cpu")
    for d, got in zip(data, R.decode_streams(data, "cpu")):
        _, want = at.decode(d, device="cpu")
        assert torch.equal(got.to(torch.int32), torch.as_tensor(np.asarray(want)).to(torch.int32))
    items = [dict(pcm=torch.from_numpy(np.ascontiguousarray(c)), data=d, rate=48000) for c, d in zip(clips, data)]
    blocks = [geo.blocks(n) for n in lengths]
    assert R.check_encoded(items, geo, bool(ms), 2, "cpu") == dict(bad_blocks=0, blocks=sum(blocks))
    items[0]["data"] = items[0]["data"][:-1]  # a stream cut short: every one of its blocks counts
    assert R.check_encoded(items, geo, bool(ms), 2, "cpu")["bad_blocks"] == blocks[0]


def test_result_line_keys(cpu_run):
    res = cpu_run(tiny_cell("stream_decode", warm=8))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"decode_samples_per_s", "decode_p95_ms", "setup_s"}
    assert res["device"]["platform"] == "cpu" and "busy_s" not in res["device"]
    assert res["compared"] == {"bad_samples": {"value": 0, "limit": 0}}
    json.dumps(res)


def test_a_run_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "b3s128ms-live-decode", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_unknown_metric_names_are_refused():
    with pytest.raises(ValueError):
        bench_run.end_to_end({"name": "encode_samples_per_s"}, "decode", [0.1], 10, 1.0, 1.0)
    assert bench_run.end_to_end({"name": "decode_p50_ms"}, "decode", [0.1, 0.3], 10, 1.0, 1.0) == pytest.approx(200)
    assert bench_run.end_to_end({"name": "encode_samples_per_s.sharded"}, "encode", [0.1], 10, 2.0, 1.0) == 5.0
