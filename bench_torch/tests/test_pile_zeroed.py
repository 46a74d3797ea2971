"""The reader ``pile_zeroed_pct.encode`` on synthetic traces: the share of
the upload that the host zeroed, from the program's counters, where the
window holds ``encode_batch`` requests; nothing without the counter (as a
program that zeroes every block past a stream's end gives) or without such
requests."""

from __future__ import annotations

import pytest

from aad_tpu_torch.utils import trace as program
from harness import trace as tr

READER = ["pile_zeroed_pct.encode"]
# two piles: 994 MB up, 1.2 MB of it the tails of last blocks, 350 MB padding in all
PILES = {"h2d_bytes": 994_000_000, "pile_zero_bytes": 1_200_000, "pile_pad_bytes": 350_000_000,
         "pile_chunks": 16, "pile_streams": 512}


def _trace(api: str = "aad.encode_batch"):
    host = [tr.Op(api, -1, 1.0, 9.0), tr.Op(api, -1, 11.0, 19.0)]
    return tr.Trace([tr.Op("encode_stream_paired_kernel", 0, 2.0, 8.0)], host,
                    [tr.Request(0.0, 10.0, []), tr.Request(10.0, 20.0, [])], [0])


@pytest.mark.parametrize("counts,want", [
    (PILES, 100 * 1_200_000 / 994_000_000),
    # every stream ends on a block boundary: the counter is there, and reads 0
    ({"h2d_bytes": 10_000, "pile_zero_bytes": 0, "pile_pad_bytes": 4_000}, 0.0),
])
def test_reader_takes_the_share_from_the_counters(monkeypatch, counts, want):
    monkeypatch.setattr(program, "counts", dict(counts))
    assert tr.read_metrics(_trace(), READER) == {"pile_zeroed_pct.encode": pytest.approx(want)}


@pytest.mark.parametrize("counts,api", [
    ({}, "aad.encode_batch"),  # a program that counts nothing
    ({"h2d_bytes": 994_000_000, "pile_pad_bytes": 350_000_000}, "aad.encode_batch"),  # no pile_zero_bytes
    ({"pile_zero_bytes": 1_200_000}, "aad.encode_batch"),  # nothing went up
    (PILES, "aad.stream_decode.push"),  # counters left from another traced stretch
])
def test_reader_finds_nothing_without_the_counter_or_requests(monkeypatch, counts, api):
    monkeypatch.setattr(program, "counts", dict(counts))
    assert tr.read_metrics(_trace(api), READER) == {}
