"""encode_batch on the card (needs a GPU): a pile long enough to run in
chunks, staged a chunk at a time while kernel 3 runs the chunks before, its
streams' byte strings cut as the chunk with each one's last block lands.

At the chunk constants of ``codec.encoder`` (64 blocks a chunk from 128
blocks on), a pile whose streams end in three different chunks must equal
each stream's solo ``encode()`` on the card, in input order; under the
profiler, every chunk but the first is staged while an earlier one is
queued (``pile_chunks_staged_ahead`` = chunks - 1), and the other pile
counters equal what the lengths imply; with its pinned staging buffer full
of random int16 before it is laid out, the same pile gives the same bytes,
bit for bit. A shorter pile is one launch: a mono
2-bit pile at the benchmark's mono cell geometry must equal the solo
encodes, and under the profiler the host's wait for kernel 3 and the copy
down lies in ``aad.encode_batch.wait``, not in ``aad.d2h``. Imports no jax:

    python -m pytest --noconftest -m gpu tests/test_torch_batch_encode_gpu.py -q

Without a card every test here skips.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

import aad_tpu_torch
from aad_tpu_torch import EncodeConfig
from test_torch_trace import garbage_staging, parent_of, pile_counts, program_spans, recorded

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _pile(seed: int, lengths: list, channels: int = 2) -> list:
    rng = np.random.default_rng(seed)
    return [(9000 * np.sin(np.arange(n) / (5.0 + 40 * rng.random((channels, 1))))
             + rng.normal(0, 900, (channels, n))).astype(np.int16) for n in lengths]


@pytest.mark.parametrize("ms,trials", [(0, 2), (1, 1)])
def test_staged_pile_matches_solo_encodes(cuda, ms, trials):
    """Streams of 30, 150, 100, 1 and 129 blocks: chunks [0, 64), [64, 128),
    [128, 150); they end in chunks 0, 2, 1, 0 and 2."""
    cfg = EncodeConfig(num_channels=2, sampling_rate=48000, bits_per_sample=4, max_block_size=1024,
                       ch_process_method=ms, num_encode_trials=trials)
    nspb = cfg.geometry().num_samples_per_block
    nbs = [30, 150, 100, 1, 129]
    lengths = [(nb - 1) * nspb + 1 + (97 * s) % nspb for s, nb in enumerate(nbs)]
    pile = _pile(ms * 10 + trials, lengths)
    call = lambda: aad_tpu_torch.encode_batch(pile, cfg, device=cuda)  # noqa: E731
    want = [aad_tpu_torch.encode(pcm, cfg, device=cuda) for pcm in pile]
    assert call() == want
    got, prof, gained = recorded(lambda: (call(), torch.cuda.synchronize(cuda))[0],
                                 (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    assert got == want
    counts = pile_counts(nbs)
    assert counts["pile_chunks"] == 3
    assert {k: gained.get(k, 0) for k in counts} == counts
    spans = program_spans(prof)
    waits = [parent_of(e, spans) for e in spans if e.name() == "aad.encode_batch.wait"]
    assert waits == ["aad.encode_batch"] * 3


@pytest.mark.parametrize("ms,trials", [(0, 2), (1, 0)])
def test_staged_pile_ignores_what_its_staging_buffer_held(cuda, ms, trials):
    """Streams of 30, 150, 100, 1, 128 and 129 blocks, the third ending on a
    block boundary, the fifth on a chunk boundary, the first with 2 samples
    in its last block: staged into a pinned buffer full of random int16, the
    pile's bytes equal, bit for bit, those of the same call without it and
    the solo encodes; and the buffer's garbage past each stream's last block
    is still there."""
    cfg = EncodeConfig(num_channels=2, sampling_rate=48000, bits_per_sample=4, max_block_size=1024,
                       ch_process_method=ms, num_encode_trials=trials)
    nspb = cfg.geometry().num_samples_per_block
    lengths = [29 * nspb + 2, 150 * nspb - 7, 100 * nspb, 5, 128 * nspb, 128 * nspb + 400]
    pile = _pile(20 + ms * 10 + trials, lengths)
    want = aad_tpu_torch.encode_batch(pile, cfg, device=cuda)
    assert want == [aad_tpu_torch.encode(pcm, cfg, device=cuda) for pcm in pile]
    with garbage_staging(3 + trials) as made:
        got = aad_tpu_torch.encode_batch(pile, cfg, device=cuda)
    assert got == want
    S, B = len(pile), 150
    staged, held = next((t, g) for t, g in made if t.numel() == S * 2 * B * nspb)
    for b0 in range(0, B, 64):
        n = min(64, B - b0)
        got_chunk, was = (t.view(-1)[S * 2 * b0 * nspb : S * 2 * (b0 + n) * nspb].view(S, 2, n * nspb)
                          for t in (staged, held))
        for s, length in enumerate(lengths):
            kept = min(max(0, -(-length // nspb) - b0), n) * nspb  # up to the end of the stream's last block
            assert torch.equal(got_chunk[s, :, kept:], was[s, :, kept:]), (b0, s)


def test_one_launch_mono_pile_waits_inside_its_wait_span(cuda):
    """16 mono 2-bit streams of 1-40 blocks of 4,028 samples (1,024-byte
    blocks, 2 trials): under 128 blocks, so one launch. The bytes equal the
    solo encodes; on the profiler's timeline ``aad.encode_batch.wait``
    covers the end of kernel 3 and of the copy down, and ``aad.d2h`` (the
    copy queued) is shorter than it."""
    cfg = EncodeConfig(num_channels=1, sampling_rate=22050, bits_per_sample=2, max_block_size=1024,
                       ch_process_method=0, num_encode_trials=2)
    nspb = cfg.geometry().num_samples_per_block
    nbs = [40, 1, 17, 33, 2, 40, 9, 25, 3, 38, 12, 1, 30, 21, 7, 36]
    lengths = [(nb - 1) * nspb + 1 + (613 * s) % nspb for s, nb in enumerate(nbs)]
    pile = _pile(7, lengths, channels=1)
    call = lambda: aad_tpu_torch.encode_batch(pile, cfg, device=cuda)  # noqa: E731
    want = [aad_tpu_torch.encode(pcm, cfg, device=cuda) for pcm in pile]
    assert call() == want
    got, prof, gained = recorded(lambda: (call(), torch.cuda.synchronize(cuda))[0],
                                 (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    assert got == want
    assert gained["pile_chunks"] == 1 and gained["pile_pad_bytes"] == 2 * (16 * 40 * nspb - sum(lengths))
    events = prof.profiler.kineto_results.events()
    on_card = [e for e in events if e.device_type() == DeviceType.CUDA]
    kernel = [e for e in on_card if "encode_stream_paired_kernel" in e.name()]
    down = [e for e in on_card if e.name().startswith("Memcpy DtoH")]
    (wait,) = [e for e in events if e.name() == "aad.encode_batch.wait"]
    (d2h,) = [e for e in events if e.name() == "aad.d2h"]
    assert len(kernel) == 1 and down
    assert wait.start_ns() <= kernel[0].end_ns() <= wait.end_ns()
    assert max(e.end_ns() for e in down) <= wait.end_ns()
    assert d2h.end_ns() - d2h.start_ns() < wait.end_ns() - wait.start_ns()
