"""``encode_batch(clips, config, device)``: every request the same pile of
PCM clips on the host, in the plan's order, to .aad bytes.

Number compared (exact, limit 0): ``bad_blocks``, blocks of the first kept
request whose header or codes differ from the reference encoder's from the
state the stream carries in (every block of a stream that is missing or
whose file header or length is wrong), and every block of a later kept
request whose bytes differ from the first's.
"""

from __future__ import annotations

import torch

import aad_tpu_torch as at
from harness import entry as E
from reference import aad as R

LIMITS = {"bad_blocks": 0}


class EncodeBatch(E.Entry):
    direction = "encode"

    def __init__(self, ctx: E.Context):
        super().__init__(ctx)
        self.clips = E.pcm_clips(ctx)
        self.config = E.encode_config(ctx.cfg)

    def call(self, i: int):
        return at.encode_batch([self.clips[j] for j in self.ctx.plan.request_clips(i)], self.config,
                               device=self.ctx.device)

    def samples(self, i: int, out) -> int:
        return sum(int(self.clips[j].size) for j in self.ctx.plan.request_clips(i))

    def work(self, i: int) -> list[dict]:
        ln = self.ctx.plan.lengths
        return [E.stream_work(self.ctx, ln[j], self.ctx.geo.stream_bytes(ln[j]))
                for j in self.ctx.plan.request_clips(i)]

    def check(self) -> dict:
        ctx, g = self.ctx, self.ctx.geo
        if not self.kept:  # no request came back
            return {"bad_blocks": sum(g.blocks(ctx.plan.lengths[j]) for j in ctx.plan.request_clips(0))}
        i0, first = self.kept[0]
        comp = ctx.plan.request_clips(i0)
        items = [dict(pcm=torch.from_numpy(self.clips[j]), data=bytes(d), rate=ctx.cfg["sampling_rate"])
                 for j, d in zip(comp, first)]
        r = R.check_encoded(items, g, ctx.mid_side, ctx.cfg["num_encode_trials"], ctx.device, control=ctx.control)
        blocks = [g.blocks(ctx.plan.lengths[j]) for j in comp]
        bad = r["bad_blocks"] + sum(blocks[len(first):])
        for _, out in self.kept[1:]:  # the same pile: the same bytes
            out = list(out) + [b""] * (len(comp) - len(out))
            bad += sum(nb for nb, a, b in zip(blocks, out, first) if bytes(a) != bytes(b))
        return {"bad_blocks": bad}


ENTRY = EncodeBatch
