"""Streaming codec: chunked encode and decode with bit-exact state carry.

The encoder-side state the reference carries implicitly across
``EncodeBlock`` calls (processor state chained at src/aad_encoder.c:870,
trial search reading the previous block at :502-512) is explicit here:

    StreamingEncoder.push(pcm_chunk) -> payload bytes of completed blocks
    StreamingEncoder.finish()        -> tail payload bytes
    StreamingEncoder.header()        -> 31-byte header (after finish, or at
                                        once with a declared total)

Chunk boundaries are arbitrary; the bytes equal a one-shot encode of the
concatenated input. ``StreamingEncoderBank`` holds many such feeds in
slots and encodes a tick of all their pushes at once. Each push uploads its whole blocks' samples as they came
and runs the whole-stream encode kernel's wire mode over them with the carry
of the push before (``ops.fused_encode.encode_wire``, kernels
``aad_encode_stream`` and ``aad_encode_pass``): the kernel pads, combines
mid/side and writes the blocks' bytes, so a push on a card is the upload, the
two kernels and the copy down. On the decode side,
block self-containedness makes streaming direct: the whole blocks in the
buffer decode at once, by ``Decoder``'s pipeline.

``device="cuda"`` launches the kernels, ``"cpu"`` runs their plain torch
versions. ``engine="native"`` runs both classes on the native host engine
(``aad_tpu_torch.native``: ``encode_chunk`` with its own carry,
``decode_payload_blocks``); ``"auto"`` stays on ``device``, where
``aad_tpu`` sends it to the native engine: the port runs on the card unless
the caller asks otherwise. ``aad_tpu``'s jit bucketing of the decode batch
is not carried over (torch runs eagerly).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..constants import CH_PROCESS_MS, FILE_HEADER_SIZE
from ..format.geometry import encoded_block_bytes, geometry_from_header, num_blocks_for
from ..format.header import HeaderInfo, decode_header, encode_header, validate_header
from ..ops.fused_encode import BANK_FIELDS, CarryBank, encode_bank, encode_wire, write_feeds
from ..utils.trace import count, recording, span
from .. import native as native_engine
from .decoder import Decoder, resolve_engine
from .device import resolve_device
from .encoder import EncodeConfig, as_int16, payload_size
from .encoder import resolve_engine as resolve_encode_engine
from .result import InvalidArgumentError


class StreamingEncoder:
    """Chunked encoder with bit-exact predictor-state carryover."""

    def __init__(self, config: EncodeConfig, device="cuda", total_samples: int | None = None,
                 engine: str = "auto"):
        """``total_samples``: declare the stream length up front so
        :meth:`header` is valid before any data arrives (the 31-byte header
        carries the total), for progressive transmission. ``engine`` is
        ``"auto"`` (the kernels on ``device``) or ``"native"`` (the native
        host engine, whatever ``device``)."""
        config.validate()
        self.config = config
        self.geometry = config.geometry()
        self._native = native_engine.resolve(resolve_encode_engine(engine))
        self.device = None if self._native else resolve_device(device)
        if self._native:
            self._native_carry = self._native.stream_state(config)
        self.total_samples = total_samples
        self._buffer = np.empty((config.num_channels, 0), dtype=np.int16)
        self._carry = None
        self._blocks_done = 0
        self._samples_done = 0
        self._finished = False

    def push(self, pcm) -> bytes:
        """Feed (C, n) int16-valued samples; returns the payload bytes of
        completed blocks. The remainder is buffered; the final (possibly
        short) block is emitted by :meth:`finish`."""
        if self._finished:
            raise InvalidArgumentError("encoder already finished")
        pcm = np.asarray(pcm)
        if pcm.ndim != 2 or pcm.shape[0] != self.config.num_channels:
            raise InvalidArgumentError(f"chunk must be ({self.config.num_channels}, n)")
        with span("aad.stream_encode.push"):
            with span("aad.push.buffer"):
                self._buffer = np.concatenate([self._buffer, as_int16(pcm)], axis=1)
                nspb = self.geometry.num_samples_per_block
                whole = self._buffer.shape[1] // nspb
                head = self._buffer[:, : whole * nspb]
                self._buffer = self._buffer[:, whole * nspb :]
            if whole == 0:
                count("stream_encode_idle_pushes", 1)
                return b""
            return self._encode_blocks(head)

    def finish(self) -> bytes:
        """Flush the buffered tail; further pushes are rejected."""
        if self._finished:
            return b""
        self._finished = True
        with span("aad.stream_encode.finish"):
            with span("aad.push.buffer"):
                tail = self._buffer
                self._buffer = self._buffer[:, :0]
            if tail.shape[1] == 0:
                return b""
            return self._encode_blocks(tail)

    def header(self) -> bytes:
        """The 31-byte stream header: of the declared ``total_samples`` when
        given (valid at once), else of the samples consumed so far (valid
        after :meth:`finish`)."""
        n = self.total_samples if self.total_samples is not None else self._samples_done
        return encode_header(self.config.header_for(n))

    @property
    def num_samples(self) -> int:
        return self._samples_done

    def _encode_blocks(self, pcm: np.ndarray) -> bytes:
        """Encode (C, n) int16 samples as the next blocks of the stream; only
        the last block may be short."""
        cfg, geo = self.config, self.geometry
        n = pcm.shape[1]
        nblocks = num_blocks_for(n, geo.num_samples_per_block)
        count("stream_encode_blocks", nblocks)
        if self._native is not None:
            data = self._native.encode_chunk(pcm, cfg, *self._native_carry, self._blocks_done)
            self._blocks_done += nblocks
            self._samples_done += n
            return data
        with span("aad.h2d"):
            count("h2d_bytes", pcm.nbytes)
            pcm_t = torch.from_numpy(np.ascontiguousarray(pcm)).to(self.device)
        with span("aad.stream_encode.blocks"):
            # on a card, kernel 3 writes the blocks' bytes, then kernel 4 rebuilds the carry
            rows, self._carry = encode_wire(
                pcm_t, geo, cfg.num_encode_trials, mid_side=cfg.ch_process_method == CH_PROCESS_MS,
                carry=self._carry, blocks_before=self._blocks_done,
            )
            count("stream_encode_carried", 1)
            payload = rows.reshape(-1)[: payload_size(geo, n)]
        self._blocks_done += nblocks
        self._samples_done += n
        with span("aad.d2h"):
            count("d2h_bytes", payload.nbytes)
            payload = payload.cpu()
        return payload.numpy().tobytes()


class StreamingEncoderBank:
    """Live encoders of ``slots`` feeds of one configuration, pushed a tick at a time.

    Each slot holds one feed at a time: a :class:`StreamingEncoder`'s state
    (its samples past the last whole block, its carry, its count) for each.
    :meth:`push` takes a tick: every slot's next samples, and the slots whose
    feed ends with them. A feed's bytes, tick after tick, equal those of a
    :class:`StreamingEncoder` fed the same pushes, and so a one-shot
    ``encode()`` of its samples. On a card a tick is one upload, one launch
    of kernel 3's bank mode, one of kernel 4's and one copy down, whatever
    the number of feeds (``ops.fused_encode.encode_bank``); the carries stay
    on the card, one set of buffers for every slot (``CarryBank``), and the
    host keeps only the remainders, in the first of two pinned uploads used
    in turn: while the card encodes a tick from one, the remainders move
    to the other. A caller may write a tick's samples straight into it
    (:meth:`buffer`). ``device="cpu"`` runs the plain version.
    On a card the configuration needs ``num_encode_trials`` of 1 or more.
    """

    def __init__(self, config: EncodeConfig, slots: int, device="cuda"):
        config.validate()
        if int(slots) < 1:
            raise InvalidArgumentError(f"a bank needs a slot or more, got {slots}")
        self.config = config
        self.geometry = geo = config.geometry()
        self.slots = int(slots)
        self.device = resolve_device(device)
        C, nspb = config.num_channels, geo.num_samples_per_block
        self._rest_len = np.zeros(self.slots, dtype=np.int64)  # samples past the slot's last whole block
        self._blocks = np.zeros(self.slots, dtype=np.int64)    # blocks of the slot's feed: 0, no carry
        self._samples = np.zeros(self.slots, dtype=np.int64)
        self._ended = np.full(self.slots, -1, dtype=np.int64)  # samples of the slot's last finished feed
        self._carry = CarryBank(self.slots, C, nspb, self.device)
        self._wire = np.array([encoded_block_bytes(geo, v) for v in range(nspb + 1)], dtype=np.int64)
        self._head = config.header_for(0)
        # two uploads, used in turn: the table of feeds (S rows of BANK_FIELDS
        # int32), then (S, C, nspb + n) samples a slot, its remainder
        # right-aligned in the first nspb, the tick's samples after; by n.
        # While the card encodes a tick from one, the remainders move to the other.
        self._uploads = ()
        self._width = 0
        self._given = None  # the view :meth:`buffer` gave for the next push
        self._down = None  # on a card, the pinned download of a tick's bytes; by n

    def buffer(self, n: int) -> np.ndarray:
        """The (S, C, n) int16 array where the next push's samples go. A
        caller that writes a tick's samples into it and pushes it saves the
        push a copy; any other array is copied in."""
        self._given = self._stage_view(int(n))[:, :, self.geometry.num_samples_per_block:]
        return self._given

    def push(self, pcm, lengths, finish=None) -> tuple[np.ndarray, np.ndarray]:
        """Feed a tick: ``pcm`` (S, C, n) int16-valued samples, slot s's first
        ``lengths[s]`` (0 to n) its next samples; ``finish`` (S,) bools, the
        slots whose feed ends after them (their last, maybe short, block is
        encoded; :meth:`header` then gives the feed's file header, and the
        slot's next samples start a new feed). Returns (data, offsets): slot
        s's payload bytes of the tick are ``data[offsets[s]:offsets[s + 1]]``."""
        S, C = self.slots, self.config.num_channels
        given, self._given = self._given, None
        if pcm is not given:
            pcm = np.asarray(pcm)
        if pcm.ndim != 3 or pcm.shape[:2] != (S, C):
            raise InvalidArgumentError(f"a tick must be ({S}, {C}, n), got {pcm.shape}")
        lengths = np.asarray(lengths, dtype=np.int64)
        finish = np.zeros(S, dtype=bool) if finish is None else np.asarray(finish, dtype=bool)
        if lengths.shape != (S,) or finish.shape != (S,):
            raise InvalidArgumentError(f"lengths and finish must be ({S},)")
        if lengths.size and (lengths.min() < 0 or lengths.max() > pcm.shape[2]):
            raise InvalidArgumentError(f"lengths must lie in [0, {pcm.shape[2]}]")
        geo, nspb = self.geometry, self.geometry.num_samples_per_block
        with span("aad.stream_encode.bank"):
            with span("aad.bank.stage"):
                samples = self._stage_view(pcm.shape[2])
                if pcm is not given:
                    as_int16(pcm, out=samples[:, :, nspb:])
                upload_t, upload = self._uploads[0]
                total = self._rest_len + lengths
                whole = total // nspb
                rest = total - whole * nspb
                cut = finish & (rest > 0)  # a finished feed's short last block
                blocks = whole + cut
                coded = np.where(finish, total, whole * nspb)
                size = blocks * geo.block_size - np.where(cut, geo.block_size - self._wire[rest], 0)
                offsets = np.zeros(S + 1, dtype=np.int64)
                np.cumsum(size, out=offsets[1:])
                at = np.flatnonzero(blocks)
                F = len(at)
                write_feeds(upload[: S * BANK_FIELDS * 2].view(np.int32).reshape(S, BANK_FIELDS), at, coded[at],
                            at * (C * self._width) + nspb - self._rest_len[at], offsets[at], self._blocks[at] > 0)
                if recording():
                    pushed = (lengths > 0) | finish
                    count("bank_feeds", int(pushed.sum()))
                    count("bank_blocks", int(blocks.sum()))
                    count("bank_started", int((self._blocks[at] == 0).sum()))
                    count("bank_finished", int(finish.sum()))
                    count("bank_idle_feeds", int((pushed & (blocks == 0)).sum()))
            if F:
                with span("aad.h2d"):
                    count("h2d_bytes", upload.nbytes)
                    up = upload_t.to(self.device, non_blocking=True)
                with span("aad.bank.blocks"):
                    rows = encode_bank(
                        up[S * BANK_FIELDS * 2:], up[: F * BANK_FIELDS * 2].view(torch.int32).view(F, BANK_FIELDS),
                        geo, self.config.num_encode_trials, mid_side=self.config.ch_process_method == CH_PROCESS_MS,
                        carry=self._carry, channel_stride=self._width, num_blocks=int(blocks.max()),
                        total_blocks=int(blocks.sum()), total_bytes=int(offsets[-1]))
            with span("aad.bank.split"):  # while the card encodes: the remainders into the other upload, the state
                self._carry_rest(samples, lengths)
                self._rest_len = np.where(finish, 0, total - coded)
                self._blocks = np.where(finish, 0, self._blocks + blocks)
                done = self._samples + coded
                self._ended = np.where(finish, done, self._ended)
                self._samples = np.where(finish, 0, done)
            data = np.empty(0, dtype=np.uint8)
            if F:
                with span("aad.d2h"):
                    count("d2h_bytes", rows.nbytes)
                    data = self._download(rows)
            return data, offsets

    def _download(self, rows: torch.Tensor) -> np.ndarray:
        """The tick's bytes as a host array of the caller's own: on a card
        through the bank's pinned download (a copy down with no staging, a
        wait for it, one copy out)."""
        if rows.device.type == "cpu":
            return rows.numpy()
        down = self._down[: rows.numel()]
        down.copy_(rows, non_blocking=True)
        torch.cuda.current_stream(rows.device).synchronize()
        return down.numpy().copy()

    def _stage_view(self, n: int) -> np.ndarray:
        """The next push's (S, C, nspb + n) samples of its upload, the
        remainders in place; two new uploads where n changed."""
        S, C = self.slots, self.config.num_channels
        nspb = self.geometry.num_samples_per_block
        width = nspb + n
        table = S * BANK_FIELDS * 2
        if width != self._width:
            if S * C * width >= 2**31:
                raise InvalidArgumentError(f"a tick of {S} x {C} x {n} samples is too large for one upload")
            pin = self.device.type == "cuda"
            uploads = tuple((t, t.numpy()) for t in (torch.empty((table + S * C * width,), dtype=torch.int16,
                                                                   pin_memory=pin) for _ in range(2)))
            if pin:  # the most bytes a tick can write: each slot's remainder and n samples in whole blocks
                most = S * -(-(nspb - 1 + n) // nspb) * self.geometry.block_size
                self._down = torch.empty((most,), dtype=torch.uint8, pin_memory=True)
            if self._uploads:
                samples = uploads[0][1][table:].reshape(S, C, width)
                samples[:, :, :nspb] = self._uploads[0][1][table:].reshape(S, C, self._width)[:, :, :nspb]
            self._uploads, self._width = uploads, width
        return self._uploads[0][1][table:].reshape(S, C, width)

    def _carry_rest(self, samples: np.ndarray, lengths: np.ndarray) -> None:
        """Each slot's samples past its whole blocks, right-aligned in the
        first nspb of the other upload (the last nspb of its joined
        samples), which the next push then takes. The other upload's copy
        up ended with the push before: that push waited for its copy down."""
        S, C, width = samples.shape
        nspb = self.geometry.num_samples_per_block
        n = width - nspb
        self._uploads = self._uploads[::-1]
        dest = self._uploads[0][1][S * BANK_FIELDS * 2:].reshape(S, C, width)
        dest[:, :, :nspb] = samples[:, :, n:]  # slots that took n samples
        short = np.flatnonzero(lengths < n)
        if len(short):
            dest[short, :, :nspb] = np.lib.stride_tricks.sliding_window_view(
                samples[short], nspb, axis=2)[np.arange(len(short)), :, lengths[short]]

    def header(self, slot: int) -> bytes:
        """The 31-byte file header of the slot's last finished feed."""
        n = int(self._ended[slot])
        if n < 0:
            raise InvalidArgumentError(f"slot {slot} has no finished feed")
        return encode_header(dataclasses.replace(self._head, num_samples=n))


class _ByteFIFO:
    """Amortised O(1)-per-byte byte queue (list of chunks + read offset).

    ``bytes += chunk`` / ``buf = buf[n:]`` both copy the whole remainder,
    making many tiny pushes O(n^2); this keeps pushes append-only and pops
    amortised linear.
    """

    def __init__(self):
        self._chunks: collections.deque[bytes] = collections.deque()
        self._offset = 0  # consumed bytes of _chunks[0]
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def append(self, data: bytes) -> None:
        if data:
            self._chunks.append(data)
            self._size += len(data)

    def pop(self, n: int) -> bytes:
        """Remove and return exactly ``n`` bytes."""
        if n > self._size:
            raise ValueError(f"pop({n}) from a queue of {self._size} bytes")
        out = bytearray()
        while n:
            head = self._chunks[0]
            take = min(len(head) - self._offset, n)
            out += head[self._offset : self._offset + take]
            self._offset += take
            self._size -= take
            n -= take
            if self._offset == len(head):
                self._chunks.popleft()
                self._offset = 0
        return bytes(out)


class StreamingDecoder:
    """Push-based decoder: emits samples as soon as whole blocks arrive.

    Block self-containedness (reference: src/aad_decoder.c:363-380) lets
    each pushed span of complete blocks decode on its own, so the latency is
    one block whatever the stream's length. ``engine`` is that of
    :class:`Decoder`, or ``"native"`` (the native host engine, whatever
    ``device``).
    """

    def __init__(self, device="cuda", engine: str = "auto"):
        self._native = native_engine.resolve(engine)
        if self._native is None:
            self._engine = resolve_engine(engine)
            self._device = resolve_device(device)
        self._buffer = _ByteFIFO()
        self._header: HeaderInfo | None = None
        self._geometry = None
        self._decoder: Decoder | None = None
        self._samples_out = 0

    @property
    def header(self) -> HeaderInfo | None:
        return self._header

    def push(self, data: bytes) -> np.ndarray:
        """Feed stream bytes; returns (C, n) int16 decoded samples (n may be 0)."""
        with span("aad.stream_decode.push"):
            with span("aad.push.frame"):
                payload, nblocks, emit = self._frame(data)
            if not nblocks:
                return self._empty()
            if self._native is not None:
                return self._native.decode_payload_blocks(payload, self._header, emit).astype(np.int16)
            with span("aad.h2d"):
                count("h2d_bytes", payload.nbytes)
                payload = torch.from_numpy(payload).to(self._device)
            # only the stream's last block is short, so the samples are a prefix
            pcm = self._decoder._decode_prefix(payload, nblocks, emit)
            with span("aad.d2h"):
                count("d2h_bytes", pcm.nbytes)
                return pcm.cpu().numpy()

    def _frame(self, data: bytes) -> tuple[np.ndarray | None, int, int]:
        """Queue ``data``, parse the file header once it has arrived, and
        pop every decodable block: (their bytes, blocks, samples a channel
        they hold); (None, 0, 0) where no block is whole yet."""
        self._buffer.append(bytes(data))
        if self._header is None:
            if len(self._buffer) < FILE_HEADER_SIZE:
                return None, 0, 0
            header = decode_header(self._buffer.pop(FILE_HEADER_SIZE))
            validate_header(header)
            self._header = header
            self._geometry = geometry_from_header(header.num_channels, header.bits_per_sample, header.block_size)
            if self._native is None:
                self._decoder = Decoder.from_header(header, device=self._device, engine=self._engine)

        h = self._header
        geo = self._geometry
        nspb = h.num_samples_per_block
        remaining = h.num_samples - self._samples_out
        # Collect every decodable block in the buffer (the stream's last
        # block may be shorter on the wire: its missing bytes read as zero
        # codes), then decode them as one batch.
        rows = []
        emit = 0
        while remaining > 0:
            valid = min(nspb, remaining)
            need = encoded_block_bytes(geo, valid) if remaining <= nspb else geo.block_size
            if len(self._buffer) < need:
                break
            row = np.zeros(geo.block_size, dtype=np.uint8)
            row[:need] = np.frombuffer(self._buffer.pop(need), dtype=np.uint8)
            rows.append(row)
            emit += valid
            remaining -= valid
        if not rows:
            return None, 0, 0
        self._samples_out += emit
        # the native engine reads 4 bytes of slack past the blocks (SIMD)
        slack = [np.zeros(4, dtype=np.uint8)] if self._native is not None else []
        return np.concatenate(rows + slack), len(rows), emit

    def _empty(self) -> np.ndarray:
        # the channel count is unknown until the header has arrived
        nch = self._header.num_channels if self._header else 0
        return np.empty((nch, 0), dtype=np.int16)
