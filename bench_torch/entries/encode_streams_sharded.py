"""``parallel.sharded.encode_streams_sharded`` over a (dp, sp) mesh of the
run's cards: a pile of streams made as (S, B, C, nspb) blocks on the first
card; a request ends when every shard's headers and codes are ready on its
card.

Number compared (exact, limit 0): ``bad_blocks``, blocks of a seeded sample
of the first kept request's streams (``check.streams``) whose header or
codes differ from the reference encoder's from the state the stream carries
in (every block, where the shards do not hold every stream), and every
block of a shard whose codes or headers differ in a later kept request.
"""

from __future__ import annotations

import numpy as np
import torch

from aad_tpu_torch.parallel import sharded
from harness import entry as E
from harness import signal
from reference import aad as R

LIMITS = {"bad_blocks": 0}


class EncodeSharded(E.Entry):
    direction = "encode"

    def __init__(self, ctx: E.Context):
        super().__init__(ctx)
        if ctx.mid_side:
            raise ValueError("encode_streams_sharded takes blocks with mid/side applied; this entry makes L/R only")
        g, ln = ctx.geo, ctx.plan.lengths
        B = max(g.blocks(n) for n in ln)
        pile = signal.render(ln, g.channels, ctx.mix["signal"], ctx.plan.signal_seed, ctx.device,
                             width=B * g.nspb)
        self.blocks = pile.reshape(len(ln), g.channels, B, g.nspb).permute(0, 2, 1, 3).contiguous()
        del pile
        n = torch.tensor(ln, device=ctx.device)
        self.valid = (n[:, None] - torch.arange(B, device=ctx.device)[None] * g.nspb).clamp(0, g.nspb).to(torch.int32)
        self.mesh = sharded.make_mesh(devices=ctx.devices, shape=tuple(ctx.mix["mesh"]))
        self.samples_per_request = int(sum(ln)) * g.channels

    def call(self, i: int):
        h, c, _ = sharded.encode_streams_sharded(
            self.blocks, self.valid, bits_per_sample=self.ctx.cfg["bits_per_sample"],
            num_trials=self.ctx.cfg["num_encode_trials"], mesh=self.mesh)
        E.sync(self.ctx.devices)
        return h, c

    def samples(self, i: int, out) -> int:
        return self.samples_per_request

    def work(self, i: int) -> list[dict]:
        return [E.stream_work(self.ctx, n, self.ctx.geo.stream_bytes(n)) for n in self.ctx.plan.lengths]

    def check(self) -> dict:
        ctx, g = self.ctx, self.ctx.geo
        ln = ctx.plan.lengths
        every = sum(g.blocks(n) for n in ln)
        if not self.kept:  # no request came back
            return {"bad_blocks": every}
        (_, (h, c)) = self.kept[0]
        sizes = [int(x.shape[0]) for x in c]
        if sum(sizes) != len(ln):
            return {"bad_blocks": every}
        want = int(ctx.mix.get("check", {}).get("streams", len(ln)))
        pick = sorted(np.random.default_rng(ctx.plan.keep_key).choice(len(ln), min(want, len(ln)), replace=False))
        starts = np.concatenate([[0], np.cumsum(sizes)])
        items = []
        for s in pick:
            k = int(np.searchsorted(starts, s, side="right")) - 1
            loc, nb = s - int(starts[k]), g.blocks(ln[s])
            f = dict(idx=h.step_index[k][loc, :nb], shift=h.shift[k][loc, :nb], weight=h.weight[k][loc, :nb],
                     history=h.history[k][loc, :nb])
            pcm = self.blocks[s].permute(1, 0, 2).reshape(g.channels, -1)[:, : ln[s]]
            items.append(dict(pcm=pcm, fields=f, codes=c[k][loc, :nb]))
        bad = R.check_encoded(items, g, False, ctx.cfg["num_encode_trials"], ctx.device, control=ctx.control)["bad_blocks"]
        for _, (h2, c2) in self.kept[1:]:  # the same pile: the same codes and headers, shard by shard
            for k in range(len(c)):
                if not (torch.equal(c2[k], c[k]) and all(torch.equal(a[k], b[k]) for a, b in zip(h2, h))):
                    bad += sum(g.blocks(n) for n in ln[starts[k]: starts[k + 1]])
        return {"bad_blocks": bad}


ENTRY = EncodeSharded
