"""Seeded PCM: tones under a slow amplitude envelope, plus Gaussian noise.

The pattern of the repository's encode signal (a 9000-amplitude tone plus
noise of sd 1000, bench.py:404), widened to a few tones a clip with
integer periods, so that every phase is exact in float32 whatever the
clip's length. Per-clip parameters come from the host's seeded generator;
the noise comes from a ``torch.Generator`` on the device, in a few large
calls. The same seed on the same kind of device gives the same samples.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHUNK = 1 << 25  # samples a channel rendered at once


def clip_params(count: int, channels: int, p: dict, rng: np.random.Generator) -> dict:
    k = int(p["tones"])
    lo, hi = p["period_samples"]
    elo, ehi = p["envelope_samples"]
    amp = rng.uniform(0.3, 1.0, (count, k))
    return dict(
        period=rng.integers(lo, hi + 1, (count, k)),
        phase=rng.integers(0, hi, (count, k, channels)),
        amp=amp / amp.sum(1, keepdims=True) * float(p["amplitude"]),
        env=rng.integers(elo, ehi + 1, count),
    )


def render(lengths, channels: int, p: dict, seed: int, device, width: int | None = None) -> torch.Tensor:
    """The clips' PCM as int16 on ``device``: (C, sum of lengths), clip after
    clip, or with ``width``, (clips, C, width), each clip zero past its end."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, dtype=np.int64)
    prm = {k: torch.as_tensor(v, device=device) for k, v in clip_params(len(lengths), channels, p, rng).items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**62)))
    if width is None:
        out = torch.empty((channels, int(lengths.sum())), dtype=torch.int16, device=device)
    else:
        out = torch.zeros((len(lengths), channels, width), dtype=torch.int16, device=device)
    starts = np.concatenate([[0], np.cumsum(lengths)])
    first = 0
    while first < len(lengths):  # a run of whole clips of at most CHUNK samples (or one longer clip)
        last = max(first + 1, int(np.searchsorted(starts, starts[first] + CHUNK, side="right")) - 1)
        last = min(last, len(lengths))
        n = lengths[first:last]
        clip = torch.repeat_interleave(torch.arange(first, last, device=device), torch.as_tensor(n, device=device))
        t = torch.arange(int(n.sum()), device=device) - torch.as_tensor(starts[first:last] - starts[first],
                                                                         device=device).repeat_interleave(
            torch.as_tensor(n, device=device))
        env = prm["env"][clip]
        x = 0.55 + 0.45 * torch.sin((2 * math.pi) * torch.remainder(t, env).float() / env.float())
        waves = []
        for ch in range(channels):
            tone = torch.zeros(t.shape, dtype=torch.float32, device=device)
            for k in range(prm["period"].shape[1]):
                per = prm["period"][clip, k]
                ph = torch.remainder(t + prm["phase"][clip, k, ch], per).float() / per.float()
                tone += prm["amp"][clip, k].float() * torch.sin((2 * math.pi) * ph)
            waves.append(tone * x)
        pcm = torch.stack(waves) + float(p["noise_sd"]) * torch.randn(
            (channels, t.numel()), generator=gen, device=device)
        pcm = pcm.round().clamp(-32768, 32767).to(torch.int16)
        if width is None:
            out[:, starts[first]: starts[last]] = pcm
        else:
            for s in range(first, last):
                a = int(starts[s] - starts[first])
                out[s, :, : lengths[s]] = pcm[:, a: a + lengths[s]]
        first = last
    return out

