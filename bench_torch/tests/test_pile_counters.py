"""The readers of ``encode_batch``'s pile counters, ``staged_ahead_pct.encode``
and ``assembled_early_pct.encode``, on synthetic traces: a share from the
program's counters where the window holds ``encode_batch`` requests, and
nothing without the counters (as a program that keeps none gives) or
without such requests."""

from __future__ import annotations

import pytest

from aad_tpu_torch.utils import trace as program
from harness import trace as tr

READERS = ["staged_ahead_pct.encode", "assembled_early_pct.encode"]
# two piles of 8 chunks, 7 staged ahead each; 480 of 512 streams built early
PILES = {"pile_chunks": 16, "pile_chunks_staged_ahead": 14, "pile_streams": 512,
         "pile_streams_assembled_early": 480}


def _trace(api: str = "aad.encode_batch"):
    host = [tr.Op(api, -1, 1.0, 9.0), tr.Op(api, -1, 11.0, 19.0)]
    return tr.Trace([tr.Op("encode_stream_paired_kernel", 0, 2.0, 8.0)], host,
                    [tr.Request(0.0, 10.0, []), tr.Request(10.0, 20.0, [])], [0])


@pytest.mark.parametrize("counts,want", [
    (PILES, {"staged_ahead_pct.encode": 100 * 14 / 16, "assembled_early_pct.encode": 100 * 480 / 512}),
    # piles of one launch count their chunk and streams, and nothing ahead or early
    ({"pile_chunks": 2, "pile_streams": 6, "h2d_bytes": 10}, {"staged_ahead_pct.encode": 0.0,
                                                              "assembled_early_pct.encode": 0.0}),
])
def test_readers_take_the_share_from_the_counters(monkeypatch, counts, want):
    monkeypatch.setattr(program, "counts", dict(counts))
    assert tr.read_metrics(_trace(), READERS) == pytest.approx(want)


@pytest.mark.parametrize("counts,api", [
    ({}, "aad.encode_batch"),  # a program that counts nothing, as the parent of the counters
    ({"h2d_bytes": 6e9, "d2h_bytes": 2e9}, "aad.encode_batch"),
    (PILES, "aad.stream_decode.push"),  # counters left from another traced stretch
])
def test_readers_find_nothing_without_counters_or_requests(monkeypatch, counts, api):
    monkeypatch.setattr(program, "counts", dict(counts))
    assert tr.read_metrics(_trace(api), READERS) == {}
