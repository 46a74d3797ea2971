"""``StreamingDecoder.push``: one caller round-robin over live streams,
``push_bytes`` a push; a stream that ends starts again with a new decoder
and its file header.

Number compared (exact, limit 0): ``bad_samples``, PCM samples that each
stream's pushes returned, against the reference's decode of the bytes
pushed, that differ or are missing.
"""

from __future__ import annotations

import numpy as np

import aad_tpu_torch as at
from harness import entry as E
from reference import aad as R

LIMITS = {"bad_samples": 0}


class StreamDecode(E.Entry):
    def __init__(self, ctx: E.Context):
        super().__init__(ctx)
        self.files = at.encode_batch(E.pcm_clips(ctx), E.encode_config(ctx.cfg), device=ctx.device,
                                     parallel_blocks=True)
        self.push = int(ctx.mix["push_bytes"])
        self.reset()

    def reset(self) -> None:
        self.kept_ints, self.kept_pcm = [], []
        self.pos = [0] * len(self.files)
        self.epoch = [0] * len(self.files)
        self.decoders = [None] * len(self.files)

    def warm(self) -> None:
        """Push ``warm_requests`` times, round-robin, then start every stream
        again from its header."""
        for i in range(int(self.ctx.mix.get("warm_requests", 1))):
            self.call(i)
        E.sync(self.ctx.devices)
        self.reset()

    def call(self, i: int):
        s = i % len(self.files)
        data, pos = self.files[s], self.pos[s]
        if pos == 0:
            self.decoders[s] = at.StreamingDecoder(device=self.ctx.device)
        chunk = data[pos: pos + self.push]
        pcm = self.decoders[s].push(chunk)
        key = (s, self.epoch[s], pos + len(chunk))
        if pos + len(chunk) >= len(data):
            self.pos[s], self.epoch[s] = 0, self.epoch[s] + 1
        else:
            self.pos[s] = pos + len(chunk)
        return key, pcm

    def samples(self, i: int, out) -> int:
        return int(out[1].size)

    def keep(self, i: int, out) -> None:
        """Every push is kept, in flat lists of untracked objects, so that
        the collector's passes do not grow with the window."""
        (s, epoch, pushed), pcm = out
        self.kept_ints.extend((s, epoch, pushed))
        self.kept_pcm.append(pcm)

    def work(self, i: int) -> list[dict]:
        return [dict(pushes=1)]

    def expected(self, s: int, pushed: int) -> int:
        """Samples a channel a decoder owes after ``pushed`` bytes of stream ``s``."""
        g, n = self.ctx.geo, self.ctx.plan.lengths[s]
        payload = pushed - R.FILE_HEADER.size
        if payload >= g.stream_bytes(n):
            return n
        return max(0, min(payload // g.block_size, g.blocks(n) - 1)) * g.nspb if payload > 0 else 0

    def check(self) -> dict:
        ctx = self.ctx
        runs: dict = {}
        keys = self.kept_ints
        for j, pcm in enumerate(self.kept_pcm):
            s, epoch, pushed = keys[3 * j: 3 * j + 3]
            r = runs.setdefault((s, epoch), [0, []])
            r[0] = pushed
            r[1].append(pcm)
        need = sorted({s for s, _ in runs})
        files = [self.files[s] for s in need]
        ref = {s: v.cpu() for s, v in zip(need, R.decode_streams(files, ctx.device))}
        ctl = ({s: v.cpu() for s, v in zip(need, R.decode_streams(files, ctx.device, control=True))}
               if ctx.control else None)
        bad = 0
        for (s, _), (pushed, parts) in runs.items():
            k = self.expected(s, pushed)
            got = ctl[s][:, :k] if ctx.control else np.concatenate(parts, axis=1)
            bad += E.mismatch(got, ref[s][:, :k])
        return {"bad_samples": bad}


ENTRY = StreamDecode
