"""Each cell's run, with its timed path broken underneath, must come out not
correct; and its control (the reference in float32 in the program's place)
must fail it too. On the CPU, at tiny sizes: the harness's look for a card
is skipped and the program runs its kernels' plain versions.

The faults, each where the program produces it: an answer altered; half of
a batch left out; a step that leaves its state unchanged (a stream decoder
that never advances; an encoder whose carry does not move from block to
block); the exchange between cards left out (the shards' input copies)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import run_cpu, tiny_cell

import aad_tpu_torch as at
from aad_tpu_torch.codec import batch_encode
from aad_tpu_torch.ops import encode as ops_encode
from aad_tpu_torch.parallel import sharded

ENCODE_BLOCK = 128  # bytes: the plain encode's work kept small


def _flip_pcm(results):
    h, pcm = results[0]
    pcm = pcm.copy()
    pcm[0, pcm.shape[1] // 2] ^= 1
    return [(h, pcm)] + list(results[1:])


def _flip_byte(outs):
    b = bytearray(outs[0])
    b[len(b) // 2] ^= 0x10
    return [bytes(b)] + list(outs[1:])


def loader_altered(mp):
    real = at.decode_batch
    mp.setattr(at, "decode_batch", lambda files, **kw: _flip_pcm(real(files, **kw)))


def loader_half(mp):
    real = at.decode_batch
    mp.setattr(at, "decode_batch", lambda files, **kw: real(files[: len(files) // 2], **kw))


def live_altered(mp):
    real = at.StreamingDecoder.push

    def push(self, data):
        pcm = real(self, data)
        if pcm.size:
            pcm = pcm.copy()
            pcm[-1, -1] ^= 4
        return pcm
    mp.setattr(at.StreamingDecoder, "push", push)


def live_stuck(mp):
    real = at.StreamingDecoder.push
    mp.setattr(at.StreamingDecoder, "push", lambda self, data: real(self, data)[:, :0])


def archive_altered(mp):
    real = at.encode_batch
    mp.setattr(at, "encode_batch", lambda clips, cfg, **kw: _flip_byte(real(clips, cfg, **kw)))


def archive_half(mp):
    real = at.encode_batch

    def half(clips, cfg, **kw):
        done = real(clips[: len(clips) // 2], cfg, **kw)
        return done + done[: len(clips) - len(done)]
    mp.setattr(at, "encode_batch", half)


def archive_stuck(mp):
    real = batch_encode.encode_blocks
    mp.setattr(batch_encode, "encode_blocks", lambda blocks, valid, cfg, *a: real(blocks, valid, cfg, True, 1, 0))


def pile_no_exchange(mp):
    real = sharded._scatter

    def local_only(tensors, mesh, pieces):
        got = real(tensors, mesh, pieces)
        return [got[0]] + [tuple(torch.zeros_like(t) for t in g) for g in got[1:]]
    mp.setattr(sharded, "_scatter", local_only)


def pile_altered(mp):
    real = sharded.encode_streams_sharded

    def flipped(*a, **kw):
        h, c, r = real(*a, **kw)
        c = list(c)
        k = max(range(len(c)), key=lambda j: c[j].numel())
        c[k] = c[k].clone()
        c[k][0, 0, 0, 0] ^= 1  # the first code of the shard's first stream
        return h, c, r
    mp.setattr(sharded, "encode_streams_sharded", flipped)


def pile_stuck(mp):
    real = sharded.encode_stream

    def heads(blocks, valid, bps, trials, **kw):
        h, c = ops_encode.encode_blocks_parallel(blocks, valid, bps, trials, stream=real)
        return h, c, None
    mp.setattr(sharded, "encode_stream", heads)


FAULTS = [
    ("decode_batch", loader_altered, "bad_samples"),
    ("decode_batch", loader_half, "bad_samples"),
    ("stream_decode", live_altered, "bad_samples"),
    ("stream_decode", live_stuck, "bad_samples"),
    ("encode_batch", archive_altered, "bad_blocks"),
    ("encode_batch", archive_half, "bad_blocks"),
    ("encode_batch", archive_stuck, "bad_blocks"),
    ("encode_streams_sharded", pile_no_exchange, "bad_blocks"),
    ("encode_streams_sharded", pile_altered, "bad_blocks"),
    ("encode_streams_sharded", pile_stuck, "bad_blocks"),
]


def _cell(entry):
    if entry.startswith("encode"):
        return tiny_cell(entry, count=5, max_block_size=ENCODE_BLOCK)
    return tiny_cell(entry, warm=8 if entry == "stream_decode" else 1)


@pytest.mark.parametrize("entry,fault,number", FAULTS, ids=[f.__name__ for _, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, entry, fault, number):
    cell = _cell(entry)
    assert run_cpu(cell)["correct"] is True  # sound as it stands
    fault(monkeypatch)
    res = run_cpu(cell)
    assert res["correct"] is False
    assert res["compared"][number]["value"] > res["compared"][number]["limit"]


@pytest.mark.parametrize("entry", ["decode_batch", "stream_decode", "encode_batch"])
def test_the_control_fails(entry):
    """float32 in the reference's prediction, at sizes where it shows."""
    seconds = 1.0
    if entry.startswith("encode"):
        cell = tiny_cell(entry, count=4, seconds=(0.05, 0.1), max_block_size=ENCODE_BLOCK)
    elif entry == "stream_decode":  # a push decodes a few blocks: go deep into two streams
        cell, seconds = tiny_cell(entry, count=2, seconds=(2.0, 3.0), warm=8), 3.0
    else:
        cell = tiny_cell(entry, count=8, seconds=(0.5, 1.0))
        cell.traffic["check"]["keep_one_in"] = 1
    res = run_cpu(cell, seed=2**31 + 99, seconds=seconds, control=True)
    assert res["correct"] is True
    assert any(v > 0 for v in res["control"].values()), res["control"]


def test_the_plain_encode_meets_the_reference_on_a_pile():
    """The sharded entry's check of every stream, sound, on a mesh of 4 CPU shards."""
    cell = tiny_cell("encode_streams_sharded", count=6, max_block_size=ENCODE_BLOCK)
    cell.traffic["check"]["streams"] = 6
    res = run_cpu(cell)
    assert res["correct"] is True and res["compared"]["bad_blocks"]["value"] == 0
    assert np.isfinite(res["metrics"]["encode_samples_per_s.sharded"]["value"])
