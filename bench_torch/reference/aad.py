"""The AAD codec written plainly in torch: the benchmark's yardstick for `correct`.

An independent reading of the AAD bitstream (aikiriao/AAD, codec version 18,
format version 4), in plain torch operations on int32 lanes, one Python step
per sample position, every block x channel lane at once. It imports nothing
of the program under test and takes no table from it: the step-size table is
recomputed here from its defining formula, the index deltas are written out.

* :func:`decode_streams` turns .aad streams into PCM.
* :func:`check_encoded` holds an encoder's output, block by block, against
  the reference's own encode of the same PCM (see its docstring for why a
  block-parallel check equals the sequential reference).

``control=True`` runs the same code with the 4-tap prediction accumulated in
float32, the step below int32 exactness: the control that a check must fail.
"""

from __future__ import annotations

import math
import struct

import torch

FILE_HEADER = struct.Struct(">4sIIHIIHHIB")  # 31 bytes, big-endian
MAGIC = b"AAD\x00"
FORMAT_VERSION = 4
CODEC_VERSION = 18
TAPS = 4
Q15_HALF = 1 << 14
WEIGHT_SHIFT = 15 + 3  # Q15, and the sign-LMS update's extra 3
INDEX_MAX = 255 << 4   # Q4 step index
# index deltas per bit depth, in Q4, truncated toward zero; the code's sign
# bit does not change the delta, so each list is repeated once
_DELTAS = {4: [-1.17, -1.07, -0.9, 1, 2, 4, 8, 16], 3: [-1.06, -0.95, 2, 8], 2: [-0.9, 2.5]}


def step_table() -> list[int]:
    """round(x**1.1 + 2**(log2(32767 - 255**1.1) / 255 * x)) for x in 0..255."""
    e = math.log2(32767 - 255 ** 1.1) / 255
    return [int(math.floor(x ** 1.1 + 2 ** (e * x) + 0.5)) for x in range(256)]


def index_deltas(bps: int) -> list[int]:
    return [int(v * 16) for v in _DELTAS[bps]] * 2


class Geometry:
    """Block layout of a (channels, bits, max block size) configuration."""

    def __init__(self, channels: int, bps: int, max_block_size: int):
        self.channels, self.bps = channels, bps
        self.header_bytes = (2 + 4 * TAPS) * channels
        unit_bits = 8 * bps // math.gcd(8, bps)  # lcm(8, bps) bits a channel
        self.unit_bytes = channels * unit_bits // 8
        self.per_unit = unit_bits // bps          # samples a channel a unit
        self.units = (max_block_size - self.header_bytes) // self.unit_bytes
        self.data_bytes = self.units * self.unit_bytes
        self.block_size = self.header_bytes + self.data_bytes
        self.codes = self.units * self.per_unit   # code slots a channel a block
        self.nspb = self.codes + TAPS             # samples a channel a block

    def blocks(self, n: int) -> int:
        return -(-n // self.nspb)

    def wire_bytes(self, valid: int) -> int:
        """Bytes on the wire of a block holding ``valid`` samples a channel."""
        units = -(-max(valid - TAPS, 0) // self.per_unit)
        return self.header_bytes + units * self.unit_bytes

    def stream_bytes(self, n: int) -> int:
        b = self.blocks(n)
        return (b - 1) * self.block_size + self.wire_bytes(n - (b - 1) * self.nspb)


def parse_file_header(data: bytes) -> dict:
    magic, fmt, codec, ch, n, rate, bps, block_size, nspb, method = FILE_HEADER.unpack_from(data)
    if magic != MAGIC or fmt != FORMAT_VERSION or codec != CODEC_VERSION:
        raise ValueError("not an AAD v4/18 stream")
    return dict(channels=ch, num_samples=n, sampling_rate=rate, bps=bps, block_size=block_size,
                nspb=nspb, mid_side=method == 1)


def file_header(channels, num_samples, rate, bps, geo: Geometry, mid_side: bool) -> bytes:
    return FILE_HEADER.pack(MAGIC, FORMAT_VERSION, CODEC_VERSION, channels, num_samples, rate, bps,
                            geo.block_size, geo.nspb, int(mid_side))


# ---- bits -------------------------------------------------------------------

def _shifts(geo: Geometry, device) -> torch.Tensor:
    """Bit offset of each of a unit's codes in its big-endian channel word."""
    return torch.tensor([geo.bps * (geo.per_unit - 1 - j) for j in range(geo.per_unit)], device=device)


def unpack(data: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(N, data_bytes) uint8 data regions -> (N, C, codes) int64 codes."""
    N, C = data.shape[0], geo.channels
    per_ch = geo.unit_bytes // C
    b = data.reshape(N, geo.units, C, per_ch).to(torch.int64)
    word = torch.zeros_like(b[..., 0])
    for k in range(per_ch):
        word = (word << 8) | b[..., k]
    codes = (word[..., None] >> _shifts(geo, data.device)) & ((1 << geo.bps) - 1)  # (N, units, C, per_unit)
    return codes.permute(0, 2, 1, 3).reshape(N, C, geo.codes)


def pack(codes: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(N, C, codes) codes -> (N, data_bytes) uint8 data regions."""
    N, C = codes.shape[0], geo.channels
    per_ch = geo.unit_bytes // C
    c = codes.to(torch.int64).reshape(N, C, geo.units, geo.per_unit).permute(0, 2, 1, 3)
    word = (c << _shifts(geo, codes.device)).sum(-1)  # (N, units, C)
    out = torch.stack([(word >> (8 * (per_ch - 1 - k))) & 0xFF for k in range(per_ch)], -1)
    return out.reshape(N, geo.data_bytes).to(torch.uint8)


def _s16(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u >= 0x8000, u - 0x10000, u)


def parse_blocks(blocks: torch.Tensor, geo: Geometry) -> dict:
    """(N, block_size) uint8 -> the fields each block header states, per channel."""
    N, C = blocks.shape[0], geo.channels
    h = blocks[:, : geo.header_bytes].to(torch.int64).reshape(N, C, 9, 2)
    u = (h[..., 0] << 8) | h[..., 1]
    tag = u[..., 0]
    shift = tag & 0xF
    return dict(idx=(tag >> 4).clamp(max=INDEX_MAX), shift=shift,
                weight=_s16(u[..., 1::2]) << shift[..., None], history=_s16(u[..., 2::2]),
                codes=unpack(blocks[:, geo.header_bytes:], geo))


def header_bytes(f: dict, geo: Geometry) -> torch.Tensor:
    """Block-header fields (N, C[, 4]) -> (N, header_bytes) uint8."""
    tag = (f["idx"] << 4) | (f["shift"] & 0xF)
    w = (f["weight"] >> f["shift"][..., None]) & 0xFFFF
    h = f["history"] & 0xFFFF
    u = torch.cat([tag[..., None], torch.stack([w, h], -1).flatten(-2)], -1)  # (N, C, 9)
    return torch.stack([u >> 8, u & 0xFF], -1).reshape(u.shape[0], -1).to(torch.uint8)


# ---- the step ---------------------------------------------------------------

class Lanes:
    """Predictor state of L lanes: four taps of history (newest first), four
    Q15 weights, the Q4 step index; int32 throughout, as the C codec's."""

    def __init__(self, history, weight, idx):
        self.h = [history[:, k].to(torch.int32).clone() for k in range(TAPS)]
        self.w = [weight[:, k].to(torch.int32).clone() for k in range(TAPS)]
        self.idx = idx.to(torch.int32).clone()

    @classmethod
    def of(cls, h: list, w: list, idx: torch.Tensor) -> "Lanes":
        out = cls.__new__(cls)
        out.h, out.w, out.idx = h, w, idx
        return out

    def copy(self) -> "Lanes":
        return Lanes.of(list(self.h), list(self.w), self.idx)

    def select(self, keep: torch.Tensor, other: "Lanes") -> "Lanes":
        """Lanes where ``keep`` is true from self, the others from ``other``."""
        return Lanes.of([torch.where(keep, a, b) for a, b in zip(self.h, other.h)],
                        [torch.where(keep, a, b) for a, b in zip(self.w, other.w)],
                        torch.where(keep, self.idx, other.idx))

    def history(self) -> torch.Tensor:
        return torch.stack(self.h, 1)

    def weight(self) -> torch.Tensor:
        return torch.stack(self.w, 1)


class Codec:
    """The per-sample transitions for one bit depth, on one device."""

    def __init__(self, bps: int, device, control: bool = False):
        self.bps = bps
        self.sign = 1 << (bps - 1)
        self.steps = torch.tensor(step_table(), dtype=torch.int32, device=device)
        self.deltas = torch.tensor(index_deltas(bps), dtype=torch.int32, device=device)
        self.control = control

    def predict(self, s: Lanes) -> torch.Tensor:
        if self.control:
            acc = sum(h.to(torch.float32) * w.to(torch.float32) for h, w in zip(s.h, s.w)) + Q15_HALF
            return torch.floor(acc / 32768.0).to(torch.int32)
        acc = s.h[0] * s.w[0] + Q15_HALF  # int32 products and sums wrap, as in C
        for k in range(1, TAPS):
            acc = acc + s.h[k] * s.w[k]
        return acc >> 15

    def qdiff(self, step: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
        mag = (step * (((code & (self.sign - 1)) << 1) + 1)) >> (self.bps - 1)
        return torch.where((code & self.sign) != 0, -mag, mag)

    def advance(self, s: Lanes, code: torch.Tensor, q: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """Index adaptation, reconstruction, sign-LMS update, history shift;
        updates ``s`` in place and returns the reconstructed sample."""
        s.idx = (s.idx + self.deltas[code.long()]).clamp(0, INDEX_MAX)
        sample = (q + pred).clamp(-32768, 32767)
        s.w = [w + ((q * h + Q15_HALF) >> WEIGHT_SHIFT) for w, h in zip(s.w, s.h)]
        s.h = [sample] + s.h[:-1]
        return sample

    def step_size(self, s: Lanes) -> torch.Tensor:
        return self.steps[((s.idx + 8) >> 4).long()]

    def decode(self, s: Lanes, code: torch.Tensor) -> torch.Tensor:
        code = code.to(torch.int32)
        q = self.qdiff(self.step_size(s), code)
        return self.advance(s, code, q, self.predict(s))

    def encode(self, s: Lanes, x: torch.Tensor):
        """One sample: returns (code, qdiff); ``s`` advances in place."""
        step = self.step_size(s)
        pred = self.predict(s)
        diff = x - pred
        neg = diff < 0
        mag = torch.div(diff.abs() << (self.bps - 2), step, rounding_mode="trunc").clamp(max=self.sign - 1)
        code = torch.where(neg, mag | self.sign, mag)
        q = self.qdiff(step, code)
        self.advance(s, code, q, pred)
        return code, q


# ---- decode -----------------------------------------------------------------

def decode_lanes(codec: Codec, codes: torch.Tensor, s: Lanes) -> torch.Tensor:
    """(L, T) codes from the lanes' header states -> (L, T) int32 samples;
    ``s`` ends as the state after the last code."""
    codes_tm = codes.t().contiguous()
    return torch.stack([codec.decode(s, codes_tm[t]) for t in range(codes_tm.shape[0])], 1)


def decode_blocks(blocks: torch.Tensor, geo: Geometry, mid_side: bool, control: bool = False) -> torch.Tensor:
    """(N, block_size) uint8 block rows -> (C, N * nspb) int16."""
    f = parse_blocks(blocks, geo)
    N, C = f["idx"].shape
    s = Lanes(f["history"].reshape(N * C, TAPS), f["weight"].reshape(N * C, TAPS), f["idx"].reshape(N * C))
    body = decode_lanes(Codec(geo.bps, blocks.device, control), f["codes"].reshape(N * C, -1), s)
    rows = torch.cat([f["history"].reshape(N * C, TAPS).flip(1).to(torch.int32), body], 1)  # (N*C, nspb)
    pcm = rows.reshape(N, C, geo.nspb).permute(1, 0, 2).reshape(C, -1)
    if mid_side:
        pcm = torch.stack([(pcm[0] + pcm[1]).clamp(-32768, 32767), (pcm[0] - pcm[1]).clamp(-32768, 32767)])
    return pcm.to(torch.int16)


def stream_blocks(data: bytes, device) -> tuple[dict, Geometry, torch.Tensor]:
    """An .aad stream -> (file header, geometry, (N, block_size) zero-padded rows)."""
    info = parse_file_header(data[: FILE_HEADER.size])
    geo = Geometry(info["channels"], info["bps"], info["block_size"])
    if geo.block_size != info["block_size"] or geo.nspb != info["nspb"]:
        raise ValueError("inconsistent block geometry")
    N = geo.blocks(info["num_samples"])
    payload = torch.frombuffer(bytearray(data[FILE_HEADER.size:]), dtype=torch.uint8)
    rows = torch.zeros(N * geo.block_size, dtype=torch.uint8)
    n = min(payload.numel(), rows.numel())
    rows[:n] = payload[:n]
    return info, geo, rows.reshape(N, geo.block_size).to(device)


def decode_streams(streams: list[bytes], device, control: bool = False) -> list[torch.Tensor]:
    """Many .aad streams of one geometry -> each stream's (C, n) int16 PCM,
    every block of every stream decoded at once."""
    parsed = [stream_blocks(d, device) for d in streams]
    geo, mid_side = parsed[0][1], parsed[0][0]["mid_side"]
    if any(vars(g) != vars(geo) or i["mid_side"] != mid_side for i, g, _ in parsed):
        raise ValueError("decode_streams takes streams of one geometry")
    pcm = decode_blocks(torch.cat([rows for _, _, rows in parsed]), geo, mid_side, control)
    out, b0 = [], 0
    for info, _, rows in parsed:
        out.append(pcm[:, b0 * geo.nspb: b0 * geo.nspb + info["num_samples"]])
        b0 += rows.shape[0]
    return out


# ---- encode -----------------------------------------------------------------

def to_blocks(pcm: torch.Tensor, geo: Geometry, mid_side: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, n) int16 PCM -> ((N, C, nspb) int32 zero-padded blocks, (N,) valid)."""
    x = pcm.to(torch.int32)
    if mid_side:
        x = torch.stack([((x[0] + x[1]) >> 1).clamp(-32768, 32767), ((x[0] - x[1]) >> 1).clamp(-32768, 32767)])
    C, n = x.shape
    N = geo.blocks(n)
    padded = torch.zeros(C, N * geo.nspb, dtype=torch.int32, device=pcm.device)
    padded[:, :n] = x
    valid = (n - torch.arange(N, device=pcm.device) * geo.nspb).clamp(max=geo.nspb)
    return padded.reshape(C, N, geo.nspb).transpose(0, 1), valid


def _measure(codec: Codec, s: Lanes, x: torch.Tensor, live: torch.Tensor):
    """Trial-encode the blocks ``x`` (L, nspb): seed the history from the
    first four samples, encode samples 4 .. live + 4 of each lane, sum the
    int32-wrapped squared qdiffs in float64 (exact: every term is below 2**31).
    A lane with fewer than four valid samples keeps its state and sums 0.
    Returns (state, sum, count)."""
    t = s.copy()
    t.h = [x[:, TAPS - 1 - k].clone() for k in range(TAPS)]
    sse = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    n_all = int(live.min().clamp(min=0))  # positions every lane encodes
    for p in range(int(live.max().clamp(min=0))):
        if p < n_all:
            _, q = codec.encode(t, x[:, TAPS + p])
            sse += (q * q).to(torch.float64)
        else:
            before = t.copy()
            _, q = codec.encode(t, x[:, TAPS + p])
            on = live > p
            t = t.select(on, before)
            sse += torch.where(on, q * q, 0).to(torch.float64)
    skip = live < 0
    return t.select(~skip, s), torch.where(skip, 0.0, sse), live.clamp(min=0).to(torch.float64)


def encode_blocks(codec: Codec, entry: Lanes, cur, prev, has_prev, valid, trials: int):
    """The encoder's work on L independent lanes, each one block of one
    channel, from the state the stream carries into it.

    Trial search: the candidates are the entry state and the states left
    by ``trials`` rounds of (re-encoding the previous block, when there is
    one, then the current block); the one whose trial encode of the current
    block has the least RMS error, compared in double as the C encoder does
    (a NaN, from a wrapped negative sum, is never less), and of equals the
    first, wins. Then the block's first four samples seed the history, the
    weights are rounded to fit 16 bits, and every code slot is encoded.
    Returns (header fields of the lanes, (L, codes) codes, end state).
    """
    live = valid - TAPS
    state, sse, n = _measure(codec, entry, cur, live)
    best_rmse = torch.sqrt(sse / n)
    best, tmp = entry, entry
    nspb = cur.shape[1]
    for _ in range(trials):
        warmed, _, _ = _measure(codec, tmp, prev, torch.full_like(live, nspb - TAPS))
        tmp = warmed.select(has_prev, tmp)
        cand = tmp
        tmp, sse, _ = _measure(codec, tmp, cur, live)
        rmse = torch.sqrt(sse / n)
        better = rmse < best_rmse
        best = cand.select(better, best)
        best_rmse = torch.where(better, rmse, best_rmse)
    s = best.copy()
    s.h = [cur[:, TAPS - 1 - k].clone() for k in range(TAPS)]
    w = s.weight()
    big = torch.where(w < 0, -w, w).amax(1)  # |INT32_MIN| wraps to itself, as C's ABS
    bits = torch.zeros_like(big)
    for k in range(32):
        bits += ((big >> k) != 0).to(torch.int32)
    shift = (bits - 15).clamp(min=0)
    s.w = [wk & ~((torch.ones_like(shift) << shift) - 1) for wk in s.w]
    fields = dict(idx=s.idx.clone(), shift=shift, weight=s.weight(), history=s.history())
    codes = torch.stack([codec.encode(s, cur[:, TAPS + p])[0] for p in range(nspb - TAPS)], 1)
    return fields, codes, s


def check_encoded(items: list[dict], geo: Geometry, mid_side: bool, trials: int, device,
                  control: bool = False) -> dict:
    """Hold encoded streams against the reference encoder; returns counts.

    Each item has ``pcm`` (C, n) int16 and the encoder's blocks, either
    ``data`` (the stream's bytes, file header included) or ``fields`` and
    ``codes`` (header fields (N, C[, 4]) and (N, C, codes) codes of each
    block of the stream).

    The C encoder carries one predictor state from block to block, and the
    state it carries out of block k is the state a decoder reaches at the
    end of block k from its header and codes. So every block is checked at
    once: block 0 from the zero state, block k from the state that decoding
    the encoder's own block k - 1 gives. Where every block agrees, by
    induction on k the stream equals the sequential reference's encode;
    where one does not, that block counts. With ``control``, the blocks
    held against the reference are the control's, computed from the same
    states, in place of the encoder's.

    Returns {"bad_blocks", "blocks"}: blocks whose header fields or codes
    differ (their wire bytes, for a byte stream), every block of a stream
    whose file header or length differs among them; and blocks checked.
    """
    xs, ps, has, valids, cand, wire, spans = [], [], [], [], [], [], []
    lost = 0  # blocks of streams whose file header or length is wrong
    for it in items:
        pcm = it["pcm"].to(device)
        x, valid = to_blocks(pcm, geo, mid_side)
        N = x.shape[0]
        if "data" in it:
            data = it["data"]
            head = file_header(pcm.shape[0], pcm.shape[1], it["rate"], geo.bps, geo, mid_side)
            if data[: FILE_HEADER.size] != head or len(data) != FILE_HEADER.size + geo.stream_bytes(pcm.shape[1]):
                lost += N
                continue
            rows = torch.zeros(N * geo.block_size, dtype=torch.uint8)
            rows[: len(data) - FILE_HEADER.size] = torch.frombuffer(bytearray(data[FILE_HEADER.size:]), dtype=torch.uint8)
            rows = rows.reshape(N, geo.block_size).to(device)
            f = parse_blocks(rows, geo)
            f["rows"] = rows
        else:
            f = {k: it["fields"][k].to(device).to(torch.int64) for k in ("idx", "shift", "weight", "history")}
            f["codes"] = it["codes"].to(device).to(torch.int64)
            if f["codes"].shape != (N, geo.channels, geo.codes):
                lost += N
                continue
        xs.append(x)
        ps.append(torch.cat([torch.zeros_like(x[:1]), x[:-1]]))
        has.append(torch.arange(N, device=device) > 0)
        valids.append(valid)
        cand.append(f)
        wire.append(torch.tensor([geo.block_size] * (N - 1) + [geo.wire_bytes(int(valid[-1]))], device=device))
        spans.append(N)
    if not xs:
        return dict(bad_blocks=lost, blocks=lost)
    C = geo.channels
    cat = lambda k: torch.cat([f[k] for f in cand])  # noqa: E731
    fields = {k: cat(k) for k in ("idx", "shift", "weight", "history", "codes")}
    N = fields["idx"].shape[0]
    lanes = lambda t: t.reshape(N * C, *t.shape[2:])  # noqa: E731
    x, prev = lanes(torch.cat(xs)), lanes(torch.cat(ps))
    per_block = lambda t: t[:, None].expand(N, C).reshape(N * C)  # noqa: E731
    has_prev, valid = per_block(torch.cat(has)), per_block(torch.cat(valids)).to(torch.int32)
    first = torch.cat([torch.arange(n, device=device) == 0 for n in spans])

    codec = Codec(geo.bps, device)
    # the state each block's encoder carries out: decode it from its header and codes
    out = Lanes(lanes(fields["history"]), lanes(fields["weight"]), lanes(fields["idx"]))
    decode_lanes(codec, lanes(fields["codes"]), out)
    zero = Lanes(*(torch.zeros_like(t) for t in (lanes(fields["history"]), lanes(fields["weight"]))),
                 torch.zeros(N * C, dtype=torch.int32, device=device))
    rolled = Lanes(torch.roll(out.history(), C, 0), torch.roll(out.weight(), C, 0), torch.roll(out.idx, C, 0))
    entry = zero.select(per_block(first), rolled)

    ref_fields, ref_codes, _ = encode_blocks(codec, entry, x, prev, has_prev, valid, trials)
    got = dict(idx=lanes(fields["idx"]), shift=lanes(fields["shift"]), weight=lanes(fields["weight"]),
               history=lanes(fields["history"]), codes=lanes(fields["codes"]))
    if control:
        got_fields, got_codes, _ = encode_blocks(Codec(geo.bps, device, control=True), entry, x, prev, has_prev,
                                                 valid, trials)
        got = dict(got_fields, codes=got_codes)
    if "rows" in cand[0] and not control:
        unflat = lambda t: t.reshape(N, C, *t.shape[1:])  # noqa: E731
        ref_rows = torch.cat([header_bytes({k: unflat(v.to(torch.int64)) for k, v in ref_fields.items()}, geo),
                              pack(unflat(ref_codes), geo)], 1)
        rows = torch.cat([f["rows"] for f in cand])
        upto = torch.cat(wire)
        col = torch.arange(geo.block_size, device=device)
        bad = ((rows != ref_rows) & (col[None] < upto[:, None])).any(1)
    else:
        diff = torch.zeros(N * C, dtype=torch.bool, device=device)
        for k in ("idx", "shift"):
            diff |= got[k].to(torch.int64) != ref_fields[k].to(torch.int64)
        for k in ("weight", "history", "codes"):
            diff |= (got[k].to(torch.int64) != (ref_fields[k] if k != "codes" else ref_codes).to(torch.int64)).any(1)
        bad = diff.reshape(N, C).any(1)
    return dict(bad_blocks=int(bad.sum()) + lost, blocks=N + lost)
