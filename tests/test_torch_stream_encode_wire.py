"""Kernel 3's wire mode on the CPU: ``StreamingEncoder`` over every
configuration it takes, at small blocks, through its plain version
(``ops.fused_encode.encode_wire`` on a CPU tensor).

The grid (``test_torch_stream_encode_gpu.WIRE_GRID``): mono, L/R and
mid/side; 2, 3 and 4 bits; trials 0, 1 and 2 (and 8 for two of them); PCM
with runs at the int16 limits in both channels, so that L + R and L - R
leave the int16 range before mid/side halves them; a push shorter than a
block, a first push of exactly 2 blocks (no carry), a carried push of a
block, then a finish of a 1- or an (nspb - 1)-sample tail. Each call's bytes
must be those of the composition the wire mode replaces, run once over the
whole stream (``_pad_to_blocks``, ``lr_to_ms``, ``encode_stream_reference``,
``_block_bytes``); a few of the grid's streams also those of ``aad_tpu``'s
scan encode. The card runs the same grid against this plain version
(``test_torch_stream_encode_gpu.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import aad_tpu
import aad_tpu_torch
from aad_tpu.codec.encoder import EncodeConfig as JaxEncodeConfig
from aad_tpu_torch.codec.encoder import _block_bytes, _pad_to_blocks, payload_size
from aad_tpu_torch.format.header import encode_header
from aad_tpu_torch.ops import fused_encode
from aad_tpu_torch.ops.encode import lr_to_ms
from aad_tpu_torch.ops.fused_encode import encode_stream_reference
from test_torch_stream_encode_gpu import TAILS, WIRE_GRID, wire_config, wire_pcm, wire_pushed, wire_pushes

# the grid's streams also held against aad_tpu's scan encode
JAX_CHECKED = {("mono", 2, 2), ("lr", 3, 2), ("ms", 4, 2)}


def composition(cfg, pcm: np.ndarray, carry=None, blocks_before: int = 0):
    """The blocks of ``pcm`` (C, n) as the port made them before the wire
    mode, in one call: (the (B, block_size) rows, the carry)."""
    geo = cfg.geometry()
    n = pcm.shape[1]
    blocks, valid = _pad_to_blocks(torch.from_numpy(pcm), geo, 0, -(-n // geo.num_samples_per_block))
    if cfg.ch_process_method == 1:
        blocks = lr_to_ms(blocks).to(torch.int16)
    headers, data, carry = encode_stream_reference(blocks, valid, cfg.bits_per_sample, cfg.num_encode_trials,
                                                   carry=carry, blocks_before=blocks_before, pack=geo)
    return _block_bytes(headers, data, geo), carry


@pytest.mark.parametrize("tail", sorted(TAILS))
@pytest.mark.parametrize("mode,bits,trials", WIRE_GRID)
def test_wire_pushes_equal_the_composition(mode, bits, trials, tail):
    cfg = wire_config(mode, bits, trials)
    geo = cfg.geometry()
    nspb = geo.num_samples_per_block
    pushes = wire_pushes(nspb, TAILS[tail](nspb))
    n = sum(pushes)
    pcm = wire_pcm(cfg.num_channels, n, seed=bits * 100 + trials)
    outs, header, _ = wire_pushed(cfg, pcm, pushes, "cpu")
    rows, _ = composition(cfg, pcm)
    payload = rows.reshape(-1)[: payload_size(geo, n)].numpy().tobytes()
    # the calls: nothing, blocks 0-1, block 2, the tail's block
    cuts = [0, 0, 2 * geo.block_size, 3 * geo.block_size, len(payload)]
    assert outs == [payload[a:b] for a, b in zip(cuts, cuts[1:])]
    assert header == encode_header(cfg.header_for(n))
    if (mode, bits, trials) in JAX_CHECKED:
        jax_cfg = JaxEncodeConfig(**dataclasses.asdict(cfg))
        assert header + payload == aad_tpu.encode(pcm.astype(np.int32), jax_cfg, engine="scan")


@pytest.mark.parametrize("mode,bits,trials", WIRE_GRID)
def test_wire_calls_chain_as_one(mode, bits, trials):
    """encode_wire's own contract, beyond StreamingEncoder's calls: a block,
    then 2 blocks and 5 samples from its carry, give the rows of one call
    over the whole, the short last block's whole row included."""
    cfg = wire_config(mode, bits, trials)
    geo = cfg.geometry()
    nspb = geo.num_samples_per_block
    pcm = wire_pcm(cfg.num_channels, 3 * nspb + 5, seed=17)
    x = torch.from_numpy(pcm)
    ms = bool(cfg.ch_process_method)
    first, carry = fused_encode.encode_wire(x[:, :nspb], geo, trials, mid_side=ms)
    rest, _ = fused_encode.encode_wire(x[:, nspb:], geo, trials, mid_side=ms, carry=carry, blocks_before=1)
    assert torch.equal(torch.cat([first, rest]), composition(cfg, pcm)[0])


def test_wire_refuses_what_the_kernel_cannot_take():
    """As the wrappers do today: the checks run before the device is asked."""
    geo = wire_config("mono", 4, 2).geometry()
    x = torch.zeros((1, 50), dtype=torch.int16)
    for call, what in (
        (lambda: fused_encode.encode_wire(x, geo, 2, mid_side=True), "mid/side"),
        (lambda: fused_encode.encode_wire(x.to(torch.int32), geo, 2), "int16"),
        (lambda: fused_encode.encode_wire(torch.zeros((2, 50), dtype=torch.int16), geo, 2), "pcm must be"),
        (lambda: fused_encode.encode_wire(x, geo, 2, blocks_before=3), "carry"),
        (lambda: fused_encode.encode_wire(x, geo, -1), "num_trials"),
        (lambda: fused_encode.encode_wire(x, dataclasses.replace(geo, bits_per_sample=1), 2), "bits_per_sample"),
    ):
        with pytest.raises(ValueError, match=what):
            call()
    with pytest.raises(ValueError, match="bits_per_sample"):
        aad_tpu_torch.StreamingEncoder(aad_tpu_torch.EncodeConfig(1, 8000, 1, 256), device="cpu").push(
            np.zeros((1, 3000), np.int16))  # a whole 1,908-sample block
