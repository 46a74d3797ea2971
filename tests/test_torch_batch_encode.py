"""aad_tpu_torch.encode_batch(..., device="cpu") against aad_tpu.encode_batch(engine="scan").

A pile of streams runs in lockstep with streams x channels on the lane
axis, so each stream's bytes must equal its solo port encode and
``aad_tpu``'s batch encode (scan engine): ragged lengths (a stream shorter
than a block, a last block with fewer than four samples), mid/side, mono,
bps 2/3/4, trials 0-2, the carry-chained chunks of a long pile (constants
shrunk so that streams end in different chunks: the pile is staged and its
byte strings cut a chunk at a time), and the block-parallel mode with
chunks and warm passes. PCM comes from numpy
seeds; streams are a few blocks of small geometries, since the plain encode
engine is slow.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import aad_tpu
from aad_tpu.codec.encoder import EncodeConfig as JaxEncodeConfig

import aad_tpu_torch
import aad_tpu_torch.codec.encoder as enc_mod
from aad_tpu_torch import EncodeConfig
from test_torch_trace import garbage_staging


def _configs(nch, bps, bsize, ms=False, trials=2):
    args = dict(num_channels=nch, sampling_rate=44100, bits_per_sample=bps, max_block_size=bsize,
                ch_process_method=int(ms), num_encode_trials=trials)
    return JaxEncodeConfig(**args), EncodeConfig(**args)


def _pile(seed, nch, lengths):
    rng = np.random.default_rng(seed)
    pile = []
    for n in lengths:
        tone = 9000 * np.sin(np.arange(n) / (5.0 + 4 * rng.random((nch, 1))))
        pile.append((tone + rng.normal(0, 900, (nch, n))).astype(np.int32))
    return pile


def _check(pile, nch, bps, bsize, ms=False, trials=2, **kw):
    """The port's pile == aad_tpu's pile == each stream's solo port encode."""
    jcfg, tcfg = _configs(nch, bps, bsize, ms, trials)
    got = aad_tpu_torch.encode_batch(pile, tcfg, device="cpu", **kw)
    assert got == aad_tpu.encode_batch(pile, jcfg, engine="scan", **kw)
    assert got == [aad_tpu_torch.encode(pcm, tcfg, device="cpu", **kw) for pcm in pile]


@pytest.mark.parametrize(
    "nch,bps,ms,trials,bsize",
    [(2, 4, False, 2, 96), (2, 3, True, 1, 96), (1, 2, False, 0, 96), (1, 4, False, 2, 128), (2, 2, True, 2, 128)],
)
def test_pile_matches_scan_engine_and_solo_encodes(nch, bps, ms, trials, bsize):
    """Ragged lengths: shorter than a block, a last block of 2 samples (the
    reference's early return), whole blocks, and a ragged tail."""
    nspb = _configs(nch, bps, bsize)[1].geometry().num_samples_per_block
    lengths = [nspb - 9, 3 * nspb + 2, 2 * nspb, 4 * nspb - 17]
    _check(_pile(nch * 10 + bps, nch, lengths), nch, bps, bsize, ms, trials)


def test_mono_cell_pile_matches_scan_engine_and_solo_encodes():
    """The geometry of the benchmark's mono cell (aad-b2-s1024-mono: 1
    channel, 2 bits, 1,024-byte blocks of 4,028 samples, 2 trials): a pile
    of one launch, a stream shorter than a block and one whose last block
    holds 2 samples."""
    nspb = _configs(1, 2, 1024)[1].geometry().num_samples_per_block
    _check(_pile(12, 1, [nspb - 9, nspb + 2]), 1, 2, 1024)


@pytest.mark.parametrize("ms,trials", [(False, 2), (True, 1)])
def test_long_pile_chains_the_carry_across_chunks(monkeypatch, ms, trials):
    """Constants shrunk so that the pile runs in chunks of 2 blocks: one
    stream ends inside chunk 0 and keeps its bytes while the others run on
    to chunk 3, one ends on a chunk boundary, one in the last chunk."""
    monkeypatch.setattr(enc_mod, "_OVERLAP_MIN_BLOCKS", 3)
    monkeypatch.setattr(enc_mod, "_OVERLAP_CHUNK_BLOCKS", 2)
    nspb = _configs(2, 4, 96)[1].geometry().num_samples_per_block
    lengths = [nspb + 5, 7 * nspb - 11, 4 * nspb, 6 * nspb + 3]
    _check(_pile(3 + trials, 2, lengths), 2, 4, 96, ms, trials)


@pytest.mark.parametrize("blocks,ms,trials,parallel", [
    ([1, 6, 3], False, 0, False),  # a stream of one block: it ends in chunk 0 and is cut first
    ([7, 7, 7], True, 2, False),  # every stream ends in the last chunk
    ([5, 2, 4], False, 1, False),  # a ragged last chunk of one block
    ([3, 8, 6, 1], True, 1, False),  # streams end in chunks 1, 3, 2 and 0, out of input order
    ([1, 6], False, 2, True),  # block-parallel: one launch however long
])
def test_staged_pile_cuts_each_stream_in_its_last_chunk(monkeypatch, blocks, ms, trials, parallel):
    """Constants shrunk so that the pile runs in chunks of 2 blocks, staged a
    chunk at a time and each stream's bytes cut once the chunk with its last
    block has come down: the results in input order, each equal to its solo
    encode and to aad_tpu's pile."""
    monkeypatch.setattr(enc_mod, "_OVERLAP_MIN_BLOCKS", 3)
    monkeypatch.setattr(enc_mod, "_OVERLAP_CHUNK_BLOCKS", 2)
    nspb = _configs(2, 4, 96)[1].geometry().num_samples_per_block
    lengths = [(nb - 1) * nspb + 1 + (7 * s + 3) % nspb for s, nb in enumerate(blocks)]
    _check(_pile(sum(blocks) + trials, 2, lengths), 2, 4, 96, ms, trials, parallel_blocks=parallel)


@pytest.mark.parametrize("layout,ms,trials", [
    ("chunks", False, 2), ("chunks", True, 0), ("chunks", True, 2), ("chunks", False, 0),
    ("one launch", False, 2), ("one launch", True, 0), ("block-parallel", True, 2),
])
def test_pile_ignores_what_its_staging_buffer_held(monkeypatch, layout, ms, trials):
    """The pile's staging buffer full of random int16 before it is laid out,
    as a reused pinned buffer is: the bytes still equal aad_tpu's pile and
    the solo encodes, since the host zeroes each stream's last block past its
    end and its blocks past that cannot reach its bytes; and what the buffer
    held in those blocks is still there after the call, so the host wrote
    nothing there. Chunks of 2 blocks (constants shrunk); streams whose last
    block holds 2 and 3 samples, one that ends on a block boundary inside a
    chunk and one on a chunk boundary."""
    chunked = layout == "chunks"
    if chunked:
        monkeypatch.setattr(enc_mod, "_OVERLAP_MIN_BLOCKS", 3)
        monkeypatch.setattr(enc_mod, "_OVERLAP_CHUNK_BLOCKS", 2)
    nspb = _configs(2, 4, 96)[1].geometry().num_samples_per_block
    lengths = [nspb + 2, 4 * nspb, 3, 3 * nspb, 7 * nspb - 5 if chunked else 5 * nspb - 5]
    pile = _pile(len(layout) + 2 * trials + ms, 2, lengths)
    parallel = layout == "block-parallel"
    kw = dict(parallel_blocks=True, parallel_chunk_blocks=2, parallel_warm_passes=1) if parallel else {}
    with garbage_staging(trials + 7 * ms) as made:
        _check(pile, 2, 4, 96, ms, trials, **kw)
    S, B, step = len(pile), -(-max(lengths) // nspb), 2 if chunked else None
    staged, held = next((t, g) for t, g in made if t.numel() == S * 2 * B * nspb)  # the pile's, made first
    for b0 in range(0, B, step or B):
        n = min(step or B, B - b0)
        got = staged.view(-1)[S * 2 * b0 * nspb : S * 2 * (b0 + n) * nspb].view(S, 2, n * nspb)
        was = held.view(-1)[S * 2 * b0 * nspb : S * 2 * (b0 + n) * nspb].view(S, 2, n * nspb)
        for s, length in enumerate(lengths):
            kept = min(max(0, -(-length // nspb) - b0), n) * nspb  # up to the end of the stream's last block
            m = min(max(0, length - b0 * nspb), kept)
            want = np.zeros((2, kept), np.int16)  # its samples, then zeros
            want[:, :m] = pile[s][:, b0 * nspb : b0 * nspb + m]
            assert np.array_equal(got[s, :, :kept].numpy(), want), (b0, s)
            assert torch.equal(got[s, :, kept:], was[s, :, kept:]), (b0, s)  # the garbage past it, left alone


@pytest.mark.parametrize("chunk_blocks,warm_passes", [(1, 0), (2, 1), (3, 0)])
def test_parallel_pile_matches_scan_engine_and_solo_encodes(chunk_blocks, warm_passes):
    nspb = _configs(2, 4, 96)[1].geometry().num_samples_per_block
    lengths = [2 * nspb + 3, 5 * nspb - 7, nspb - 30]
    _check(_pile(chunk_blocks + 10 * warm_passes, 2, lengths), 2, 4, 96, ms=warm_passes > 0, trials=2,
           parallel_blocks=True, parallel_chunk_blocks=chunk_blocks, parallel_warm_passes=warm_passes)


def test_int16_pile_and_the_empty_pile():
    jcfg, tcfg = _configs(1, 4, 96)
    assert aad_tpu_torch.encode_batch([], tcfg, device="cpu") == []
    assert aad_tpu.encode_batch([], jcfg, engine="scan") == []
    pile = _pile(5, 1, [150, 40])
    got = aad_tpu_torch.encode_batch([p.astype(np.int16) for p in pile], tcfg, device="cpu")
    assert got == aad_tpu.encode_batch(pile, jcfg, engine="scan")


@pytest.mark.parametrize("shape", [(1, 50), (3, 50), (100,), (2, 2, 50)])
def test_bad_shapes_raise_as_in_aad_tpu(shape):
    jcfg, tcfg = _configs(2, 4, 96)
    pile = [np.zeros((2, 80), np.int32), np.zeros(shape, np.int32)]
    with pytest.raises(aad_tpu.InvalidArgumentError):
        aad_tpu.encode_batch(pile, jcfg, engine="scan")
    with pytest.raises(aad_tpu_torch.InvalidArgumentError):
        aad_tpu_torch.encode_batch(pile, tcfg, device="cpu")


def test_empty_stream_raises_at_its_header():
    _, tcfg = _configs(2, 4, 96)
    with pytest.raises(aad_tpu_torch.InvalidFormatError):
        aad_tpu_torch.encode_batch([np.zeros((2, 80), np.int32), np.zeros((2, 0), np.int32)], tcfg, device="cpu")
