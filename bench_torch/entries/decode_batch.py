"""``decode_batch(files, device)``: each request a composition of the plan's
cycle over a pool of .aad files, made at set-up by the program's
block-parallel encode.

Number compared (exact, limit 0): ``bad_samples``, PCM samples of the kept
requests that differ from the reference's decode of the same bytes or are
missing.
"""

from __future__ import annotations

import aad_tpu_torch as at
from harness import entry as E
from reference import aad as R

LIMITS = {"bad_samples": 0}


class DecodeBatch(E.Entry):
    def __init__(self, ctx: E.Context):
        super().__init__(ctx)
        self.files = at.encode_batch(E.pcm_clips(ctx), E.encode_config(ctx.cfg), device=ctx.device,
                                     parallel_blocks=True)

    def call(self, i: int):
        return at.decode_batch([self.files[j] for j in self.ctx.plan.request_clips(i)], device=self.ctx.device)

    def samples(self, i: int, out) -> int:
        return sum(int(p.size) for _, p in out)

    def work(self, i: int) -> list[dict]:
        ln = self.ctx.plan.lengths
        return [E.stream_work(self.ctx, ln[j], len(self.files[j]) - R.FILE_HEADER.size)
                for j in self.ctx.plan.request_clips(i)]

    def check(self) -> dict:
        ctx = self.ctx
        need = sorted({j for i, _ in self.kept for j in ctx.plan.request_clips(i)})
        ref = dict(zip(need, R.decode_streams([self.files[j] for j in need], ctx.device)))
        got_ctl = (dict(zip(need, R.decode_streams([self.files[j] for j in need], ctx.device, control=True)))
                   if ctx.control else None)
        bad = 0
        for i, out in self.kept:
            comp = ctx.plan.request_clips(i)
            out = list(out) + [None] * (len(comp) - len(out))
            for j, item in zip(comp, out):
                want = ref[j].cpu()
                got = got_ctl[j].cpu() if ctx.control else (None if item is None else item[1])
                bad += int(want.numel()) if got is None else E.mismatch(got, want)
        return {"bad_samples": bad}


ENTRY = DecodeBatch
