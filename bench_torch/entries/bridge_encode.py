"""``StreamingEncoderBank.push``: a conference bridge's live feeds, a tick at a time.

A request is one tick: each of the mix's slots (one a clip) pushes its next
``push_samples`` samples. A slot's feed joins at a tick drawn from the seed
in [0, ``join_ticks``); its last push is shorter, finishes it and is
followed by ``header(slot)``, and the slot starts its clip again as a new
epoch. Warm-up runs a bridge of its own; the window's first tick is the
first of a new bridge, so every feed of the window starts in it.

Number compared (exact, limit 0): ``bad_blocks``. For each (slot, epoch)
run whose pushes were kept, the blocks they returned, held against the
reference encoder's block from the state the stream carries in, over the
PCM fed so far (``reference/aad.py``, ``check_encoded``), as the live
encode cell checks them. Kept: every push of ``check.slots`` slots drawn
from the seed, and every slot's pushes of the window's first
``check.ticks`` ticks; the rest are counted and let go. A run the window
left unfinished is checked on its whole blocks, under a file header that
the check writes for them.
"""

from __future__ import annotations

import numpy as np
import torch

import aad_tpu_torch as at
from harness import entry as E
from harness import signal
from reference import aad as R

LIMITS = {"bad_blocks": 0}


class BridgeEncode(E.Entry):
    direction = "encode"

    def __init__(self, ctx: E.Context):
        super().__init__(ctx)
        mix, plan = ctx.mix, ctx.plan
        self.config = E.encode_config(ctx.cfg)
        self.push = int(mix["push_samples"])
        self.lengths = lengths = np.asarray(plan.lengths, dtype=np.int64)
        self.slots = len(lengths)
        rng = np.random.default_rng(np.random.SeedSequence(plan.seed % 2**63).spawn(4)[3])
        self.join = rng.integers(0, int(mix["join_ticks"]), self.slots)
        self.sampled = np.sort(rng.choice(self.slots, int(mix["check"]["slots"]), replace=False))
        self.whole_ticks = int(mix["check"]["ticks"])
        self.reset()  # first, so that a program without the bank fails at once
        flat = signal.render(plan.lengths, ctx.cfg["num_channels"], mix["signal"], plan.signal_seed, ctx.device)
        flat = flat.cpu().numpy()
        self.starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        self.clips = [flat[:, a: a + n] for a, n in zip(self.starts, lengths)]
        # a tick's samples are rows of these window views, a channel each, the clips' end padded for the
        # last rows; the rows a tick takes are gathered straight into the bank's upload
        padded = torch.zeros((flat.shape[0], flat.shape[1] + self.push), dtype=torch.int16)
        padded[:, : flat.shape[1]] = torch.from_numpy(flat)
        self.rows = [ch.as_strided((ch.numel() - self.push + 1, self.push), (1, 1)) for ch in padded]

    def reset(self) -> None:
        """A new bridge: every slot before its join, at its clip's start."""
        self.bank = at.StreamingEncoderBank(self.config, self.slots, device=self.ctx.device)
        self.pos = np.zeros(self.slots, dtype=np.int64)
        self.epoch = np.zeros(self.slots, dtype=np.int64)
        self.kept_ticks = []
        self.last = None

    def warm(self) -> None:
        """``warm_requests`` ticks of a bridge of its own (the joins, whole
        feeds of the shortest clips, their finishes and restarts), then a
        new bridge for the window."""
        for i in range(int(self.ctx.mix.get("warm_requests", 1))):
            self.call(i)
        E.sync(self.ctx.devices)
        self.reset()
        C = int(self.ctx.cfg["num_channels"])  # the new bridge's upload, before the window: a tick of no samples
        self.bank.push(np.zeros((self.slots, C, self.push), dtype=np.int16), np.zeros(self.slots, dtype=np.int64))

    def call(self, i: int):
        on = self.join <= i
        n = np.where(on, np.minimum(self.push, self.lengths - self.pos), 0)
        finish = on & (self.pos + n == self.lengths)
        pcm = self.bank.buffer(self.push)  # (S, C, push): the tick's samples straight into the bank's upload
        at, into = torch.from_numpy(self.starts + self.pos), torch.from_numpy(pcm)
        for c, rows in enumerate(self.rows):
            torch.index_select(rows, 0, at, out=into[:, c])
        data, offsets = self.bank.push(pcm, n, finish)
        heads = {int(s): self.bank.header(s) for s in np.flatnonzero(finish)}
        ends, epochs = self.pos + n, self.epoch
        self.last = (self.pos, n, finish, int(offsets[-1]))
        self.pos = np.where(finish, 0, ends)
        self.epoch = epochs + finish
        return (ends, epochs, n, finish), data, offsets, heads

    def samples(self, i: int, out) -> int:
        return int(out[0][2].sum()) * int(self.ctx.cfg["num_channels"])

    def keep(self, i: int, out) -> None:
        """Every slot's pushes of the window's first ticks; then the sampled
        slots' alone, their bytes cut out of the tick's."""
        (ends, epochs, n, finish), data, offsets, heads = out
        if i < self.whole_ticks:
            slots = np.flatnonzero((n > 0) | finish)
            offsets = offsets[np.append(slots, slots[-1] + 1)] if len(slots) else offsets[:1]
        else:
            slots = self.sampled[(n[self.sampled] > 0) | finish[self.sampled]]
            sizes = offsets[slots + 1] - offsets[slots]
            shift = np.repeat(offsets[slots] - np.concatenate([[0], np.cumsum(sizes)[:-1]]), sizes)
            data = data[shift + np.arange(int(sizes.sum()))]
            offsets = np.concatenate([[0], np.cumsum(sizes)])
            heads = {s: heads[s] for s in slots.tolist() if s in heads}
        self.kept_ticks.append((slots, ends[slots], epochs[slots], data, offsets, heads))

    def work(self, i: int) -> list[dict]:
        """The last tick's totals (``work/k3_wire.py``): each feed's blocks
        and whether it carried into the tick, from the lengths alone."""
        pos, n, finish, wire = self.last
        g, nspb = self.ctx.geo, self.ctx.geo.nspb
        before = pos // nspb * nspb  # samples of the feed's whole blocks before the tick
        end = pos + n
        blocks = np.where(finish, -(-end // nspb), end // nspb) - pos // nspb
        coded = np.where(finish, end, end // nspb * nspb) - before  # samples the tick encodes
        live = blocks > 0
        full, rest = coded // nspb, coded % nspb
        return [dict(channels=g.channels, nspb=nspb, trials=int(self.ctx.cfg["num_encode_trials"]),
                     samples=int(coded.sum()), blocks=int(blocks.sum()),
                     coded=int((full * (nspb - 4) + np.maximum(rest - 4, 0)).sum()),
                     warm_blocks=int((blocks - (live & (pos < nspb))).sum()), wire_bytes=wire)]

    def check(self) -> dict:
        ctx, g = self.ctx, self.ctx.geo
        runs: dict = {}
        for slots, ends, epochs, data, offsets, heads in self.kept_ticks:
            blob, offsets = data.tobytes(), offsets.tolist()
            for j, (s, epoch, end) in enumerate(zip(slots.tolist(), epochs.tolist(), ends.tolist())):
                r = runs.setdefault((s, epoch), [0, [], None])
                r[0] = end
                r[1].append(blob[offsets[j]: offsets[j + 1]])
                if s in heads:
                    r[2] = heads[s]
        if not runs:  # no push came back
            return {"bad_blocks": g.blocks(self.push)}
        rate = ctx.cfg["sampling_rate"]
        items = []
        for (s, _), (end, parts, header) in runs.items():
            clip = self.clips[s]
            if header is not None:  # finished: the program's own file header
                n = clip.shape[1]
            else:
                n = end // g.nspb * g.nspb
                header = R.file_header(g.channels, n, rate, g.bps, g, ctx.mid_side)
            if n:
                items.append(dict(pcm=torch.from_numpy(clip[:, :n]), data=header + b"".join(parts), rate=rate))
        r = R.check_encoded(items, g, ctx.mid_side, ctx.cfg["num_encode_trials"], ctx.device, control=ctx.control)
        return {"bad_blocks": r["bad_blocks"]}


ENTRY = BridgeEncode
