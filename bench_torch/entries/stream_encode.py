"""``StreamingEncoder.push``: one caller round-robin over live feeds,
``push_samples`` samples a channel a push; a feed's last push also calls
``finish()`` and ``header()``, and the feed starts again with a new encoder
(a new epoch), as a sender starts a new file.

Number compared (exact, limit 0): ``bad_blocks``. For each (feed, epoch)
run, the blocks that its kept pushes returned, held against the reference
encoder's block from the state the stream carries in, over the PCM fed so
far (``reference/aad.py``, ``check_encoded``): a block that differs counts,
and every block of a run whose bytes are missing, or whose file header or
length is wrong. A run that the window left unfinished is checked on its
whole blocks, under a file header that the check writes for them: the
program gives none before ``finish()``.
"""

from __future__ import annotations

import torch

import aad_tpu_torch as at
from harness import entry as E
from reference import aad as R

LIMITS = {"bad_blocks": 0}


class StreamEncode(E.Entry):
    direction = "encode"

    def __init__(self, ctx: E.Context):
        super().__init__(ctx)
        self.clips = E.pcm_clips(ctx)
        self.config = E.encode_config(ctx.cfg)
        self.push = int(ctx.mix["push_samples"])
        self.reset()

    def reset(self) -> None:
        self.kept_ints, self.kept_bytes, self.headers = [], [], {}
        self.pos = [0] * len(self.clips)
        self.epoch = [0] * len(self.clips)
        self.encoders = [None] * len(self.clips)

    def warm(self) -> None:
        """Push ``warm_requests`` times, round-robin; then, for each feed, a
        new encoder's push of the feed's last push's length, its finish and
        its header (the shapes of a feed's end); then start every feed
        again."""
        for i in range(int(self.ctx.mix.get("warm_requests", 1))):
            self.call(i)
        for clip in self.clips:
            enc = at.StreamingEncoder(self.config, device=self.ctx.device)
            enc.push(clip[:, clip.shape[1] - (clip.shape[1] % self.push or self.push):])
            enc.finish()
            enc.header()
        E.sync(self.ctx.devices)
        self.reset()

    def call(self, i: int):
        s = i % len(self.clips)
        clip, pos, epoch = self.clips[s], self.pos[s], self.epoch[s]
        if pos == 0:
            self.encoders[s] = at.StreamingEncoder(self.config, device=self.ctx.device)
        enc = self.encoders[s]
        end = min(pos + self.push, clip.shape[1])
        data = enc.push(clip[:, pos:end])
        header = None
        if end == clip.shape[1]:
            data += enc.finish()
            header = enc.header()
            self.pos[s], self.epoch[s], self.encoders[s] = 0, epoch + 1, None
        else:
            self.pos[s] = end
        return (s, epoch, end, end - pos), data, header

    def samples(self, i: int, out) -> int:
        return out[0][3] * int(self.ctx.cfg["num_channels"])

    def keep(self, i: int, out) -> None:
        """Every push is kept, in flat lists of untracked objects, so that
        the collector's passes do not grow with the window."""
        (s, epoch, end, _), data, header = out
        self.kept_ints.extend((s, epoch, end))
        self.kept_bytes.append(data)
        if header is not None:
            self.headers[(s, epoch)] = header

    def work(self, i: int) -> list[dict]:
        return [dict(pushes=1)]

    def check(self) -> dict:
        ctx, g = self.ctx, self.ctx.geo
        runs: dict = {}
        keys = self.kept_ints
        for j, data in enumerate(self.kept_bytes):
            s, epoch, end = keys[3 * j: 3 * j + 3]
            r = runs.setdefault((s, epoch), [0, []])
            r[0] = end
            r[1].append(data)
        if not runs:  # no push came back
            return {"bad_blocks": g.blocks(self.push)}
        rate = ctx.cfg["sampling_rate"]
        items = []
        for (s, epoch), (end, parts) in runs.items():
            clip = self.clips[s]
            if (s, epoch) in self.headers:  # finished: the program's own file header
                n, header = clip.shape[1], self.headers[(s, epoch)]
            else:
                n = end // g.nspb * g.nspb
                header = R.file_header(g.channels, n, rate, g.bps, g, ctx.mid_side)
            if n:
                items.append(dict(pcm=torch.from_numpy(clip[:, :n]), data=header + b"".join(parts), rate=rate))
        r = R.check_encoded(items, g, ctx.mid_side, ctx.cfg["num_encode_trials"], ctx.device, control=ctx.control)
        return {"bad_blocks": r["bad_blocks"]}


ENTRY = StreamEncode
