"""encode_batch of a mono 2-bit pile at the geometry of the benchmark's mono
configuration (``bench_torch/configs/aad-b2-s1024-mono.json``: 1 channel,
2 bits a sample, 1,024-byte blocks of 4,028 samples, no mid/side, 2
trials), on the CPU, against the benchmark's plain reference codec
(``bench_torch/reference/aad.py``, imported from its path; it imports
nothing of the program).

Five seeded streams of 1-3 blocks, their last blocks ragged (3, 2, 1,517
and 3,021 samples, and one whole): under ``_OVERLAP_MIN_BLOCKS``, so the
pile is one launch, staged stream-major. Each stream's bytes must equal the
reference encoder's, block by block from the state the stream carries in
(``check_encoded``), and the stream's solo ``encode``; the port's decode of
them must equal the reference's ``decode_streams``. Imports no jax.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import aad_tpu_torch
from aad_tpu_torch import EncodeConfig
from aad_tpu_torch.codec import encoder as enc_mod

REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "bench_torch" / "reference" / "aad.py"
CFG = EncodeConfig(num_channels=1, sampling_rate=22050, bits_per_sample=2, max_block_size=1024,
                   ch_process_method=0, num_encode_trials=2)
NSPB = CFG.geometry().num_samples_per_block
LENGTHS = [3_021, 2 * NSPB + 2, 2 * NSPB, 3, NSPB + 1_517]


def _reference():
    spec = importlib.util.spec_from_file_location("aad_reference", REFERENCE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _reference()
GEO = R.Geometry(1, 2, 1024)


def _pile(seed: int) -> list:
    """Speech-like mono PCM: a tone under an envelope, and noise."""
    rng = np.random.default_rng(seed)
    out = []
    for n in LENGTHS:
        t = np.arange(n)
        env = 0.3 + 0.7 * np.abs(np.sin(t / rng.uniform(2_000, 9_000)))
        x = 12_000 * env * np.sin(t / rng.uniform(3.0, 60.0)) + rng.normal(0, 1_200, n)
        out.append(np.clip(x, -32768, 32767).astype(np.int16)[None, :])
    return out


PILE = _pile(2**31 + 16)


@pytest.fixture(scope="module")
def encoded() -> list:
    return aad_tpu_torch.encode_batch(PILE, CFG, device="cpu")


def test_the_geometry_is_the_mono_cells():
    assert (GEO.block_size, GEO.nspb, GEO.header_bytes) == (1024, 4028, 18) == (
        CFG.geometry().block_size, NSPB, 18)
    blocks = [GEO.blocks(n) for n in LENGTHS]
    assert blocks == [1, 3, 2, 1, 2] and not enc_mod.runs_in_chunks(max(blocks), False)


def test_pile_matches_the_reference_encoder_block_by_block(encoded):
    items = [dict(pcm=torch.from_numpy(pcm), data=data, rate=22050) for pcm, data in zip(PILE, encoded)]
    assert R.check_encoded(items, GEO, False, 2, "cpu") == dict(bad_blocks=0, blocks=9)


@pytest.mark.parametrize("s", range(len(LENGTHS)))
def test_each_stream_equals_its_solo_encode(encoded, s):
    assert encoded[s] == aad_tpu_torch.encode(PILE[s], CFG, device="cpu")


def test_pile_decodes_as_the_reference_decodes(encoded):
    want = R.decode_streams(encoded, "cpu")
    for data, ref, n in zip(encoded, want, LENGTHS):
        _, pcm = aad_tpu_torch.decode(data, device="cpu")
        assert tuple(ref.shape) == (1, n)
        assert torch.equal(torch.as_tensor(np.asarray(pcm)).to(torch.int32), ref.to(torch.int32))
