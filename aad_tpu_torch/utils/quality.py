"""Quality metrics and the codec's self-check on a card.

Library-level equivalents of the reference CLI's QA modes (-c statistics,
reconstruction comparison; reference: src/main.c:441-503), and a deployment
self-check that holds the CUDA kernels bit for bit against their plain
torch versions on this card.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..codec.decoder import decode
from ..codec.device import resolve_device
from ..codec.encoder import EncodeConfig, encode
from ..codec.result import InvalidArgumentError
from ..codec.streaming import StreamingEncoder
from ..constants import FILE_HEADER_SIZE


@dataclasses.dataclass
class QualityStats:
    """Full-scale-normalised error statistics between two PCM signals."""

    rmse: float
    mean_abs: float
    max_abs: float

    def __str__(self) -> str:  # the reference's -c line format
        return f"RMSE:{self.rmse:f} MSD:{self.mean_abs:f} MaxAE:{self.max_abs:f}"


def quality_stats(original, decoded) -> QualityStats:
    """Error statistics between original and decoded int16-valued PCM
    (numpy arrays or tensors on any device).

    Unlike the reference CLI's -c mode (which keeps a historical formula
    quirk, see ``cli.py``), these are the straightforward full-scale
    normalised metrics, by ``aad_tpu``'s numpy formula.
    """
    a = np.asarray(_host(original), dtype=np.float64) / 32768.0
    b = np.asarray(_host(decoded), dtype=np.float64) / 32768.0
    diff = a - b
    return QualityStats(
        rmse=math.sqrt(float(np.mean(diff**2))),
        mean_abs=float(np.mean(np.abs(diff))),
        max_abs=float(np.max(np.abs(diff))) if diff.size else 0.0,
    )


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else a


def roundtrip_stats(pcm, config: EncodeConfig, device="cuda") -> QualityStats:
    """Encode and decode ``pcm`` on ``device``; the reconstruction error."""
    data = encode(pcm, config, device=device)
    _, out = decode(data, device=device)
    return quality_stats(pcm, out)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"self_check: {what}")


def self_check(verbose: bool = False, device="cuda") -> dict:
    """Prove the CUDA kernels bit-exact on this card.

    Encodes and decodes a deterministic signal on ``device`` (a CUDA device)
    and on the CPU, where the plain torch versions run: encode at bps 2, 3
    and 4 (kernel 3), decode under both engines (kernels 1, 2 and 5), a
    streaming encode whose carry crosses a push (kernel 4), and the parallel
    mode's defining property (it equals the concatenated independent
    single-block encodes). Returns a report naming the card; raises
    AssertionError on any mismatch. Intended for deployment smoke tests.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        raise InvalidArgumentError(f"self_check holds the CUDA kernels against the CPU: got device {device}")

    rng = np.random.default_rng(0)
    n = 2500
    pcm = (9000 * np.sin(np.arange(2 * n).reshape(2, n) / 17) + rng.integers(-2000, 2000, (2, n))).astype(np.int32)
    report = {
        "device": torch.cuda.get_device_name(device),
        "device_count": torch.cuda.device_count(),
        "decode_engines": ["fused", "pallas"],
        "checks": [],
    }

    for bps in (2, 3, 4):
        cfg = EncodeConfig(num_channels=2, sampling_rate=16000, bits_per_sample=bps, max_block_size=256)
        ref_stream = encode(pcm, cfg, device="cpu")
        _require(encode(pcm, cfg, device=device) == ref_stream, f"encode mismatch at bps={bps}")
        _, ref_pcm = decode(ref_stream, device="cpu")
        for engine in report["decode_engines"]:
            _, got = decode(ref_stream, device=device, engine=engine)
            _require(np.array_equal(got, ref_pcm), f"decode mismatch at bps={bps}, engine={engine}")
        report["checks"].append({"bits_per_sample": bps, "ok": True})
        if verbose:
            print(f"bps={bps}: encode and both decode engines bit-exact")

    cfg = EncodeConfig(num_channels=2, sampling_rate=16000, max_block_size=256)
    se = StreamingEncoder(cfg, device=device, total_samples=n)
    streamed = se.header() + se.push(pcm[:, :1000]) + se.push(pcm[:, 1000:]) + se.finish()
    _require(streamed == encode(pcm, cfg, device="cpu"), "streaming encode mismatch")
    report["checks"].append({"streaming_carry": True, "ok": True})
    if verbose:
        print("streaming encode: the carry across a push bit-exact")

    # block-parallel mode: its defining property, and decodability
    nspb = cfg.geometry().num_samples_per_block
    par = encode(pcm, cfg, device=device, parallel_blocks=True)
    parts = [encode(pcm[:, b * nspb : (b + 1) * nspb], cfg, device="cpu")[FILE_HEADER_SIZE:]
             for b in range(-(-n // nspb))]
    _require(par == par[:FILE_HEADER_SIZE] + b"".join(parts), "parallel-mode mismatch")
    _, par_pcm = decode(par, device=device)
    _require(par_pcm.shape == pcm.shape, "parallel-mode decode shape")
    report["checks"].append({"parallel_blocks": True, "ok": True})
    if verbose:
        print("parallel mode: the per-block property holds")
    return report
