"""Streaming codec: chunked encode and decode with bit-exact state carry.

The encoder-side state the reference carries implicitly across
``EncodeBlock`` calls (processor state chained at src/aad_encoder.c:870,
trial search reading the previous block at :502-512) is explicit here:

    StreamingEncoder.push(pcm_chunk) -> payload bytes of completed blocks
    StreamingEncoder.finish()        -> tail payload bytes
    StreamingEncoder.header()        -> 31-byte header (after finish, or at
                                        once with a declared total)

Chunk boundaries are arbitrary; the bytes equal a one-shot encode of the
concatenated input. Each push runs the whole-stream encode kernel over its
blocks with the carry of the push before (``ops.fused_encode.encode_stream``,
kernels ``aad_encode_stream`` and ``aad_encode_pass``). On the decode side,
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

import numpy as np
import torch

from ..constants import CH_PROCESS_MS, FILE_HEADER_SIZE
from ..format.geometry import encoded_block_bytes, geometry_from_header, num_blocks_for
from ..format.header import HeaderInfo, decode_header, encode_header, validate_header
from ..ops.encode import lr_to_ms
from ..ops.fused_encode import encode_stream
from .. import native as native_engine
from .decoder import Decoder, resolve_engine
from .device import resolve_device
from .encoder import EncodeConfig, _block_bytes, _pad_to_blocks, as_int16, payload_size
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
        self._buffer = np.concatenate([self._buffer, as_int16(pcm)], axis=1)
        nspb = self.geometry.num_samples_per_block
        whole = self._buffer.shape[1] // nspb
        if whole == 0:
            return b""
        head = self._buffer[:, : whole * nspb]
        self._buffer = self._buffer[:, whole * nspb :]
        return self._encode_blocks(head)

    def finish(self) -> bytes:
        """Flush the buffered tail; further pushes are rejected."""
        if self._finished:
            return b""
        self._finished = True
        if self._buffer.shape[1] == 0:
            return b""
        tail = self._buffer
        self._buffer = self._buffer[:, :0]
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
        if self._native is not None:
            data = self._native.encode_chunk(pcm, cfg, *self._native_carry, self._blocks_done)
            self._blocks_done += num_blocks_for(n, geo.num_samples_per_block)
            self._samples_done += n
            return data
        pcm_t = torch.from_numpy(np.ascontiguousarray(pcm)).to(self.device)
        blocks, valid = _pad_to_blocks(pcm_t, geo, 0, num_blocks_for(n, geo.num_samples_per_block))
        if cfg.ch_process_method == CH_PROCESS_MS:
            blocks = lr_to_ms(blocks).to(torch.int16)
        headers, codes, self._carry = encode_stream(
            blocks, valid, cfg.bits_per_sample, cfg.num_encode_trials,
            carry=self._carry, blocks_before=self._blocks_done, need_carry=True,
        )
        self._blocks_done += blocks.shape[0]
        self._samples_done += n
        return _block_bytes(headers, codes, geo).reshape(-1)[: payload_size(geo, n)].cpu().numpy().tobytes()


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
        self._buffer.append(bytes(data))
        if self._header is None:
            if len(self._buffer) < FILE_HEADER_SIZE:
                return self._empty()
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
            return self._empty()
        self._samples_out += emit
        if self._native is not None:
            # 4 bytes of slack past the blocks for the engine's SIMD reads
            payload = np.concatenate(rows + [np.zeros(4, dtype=np.uint8)])
            return self._native.decode_payload_blocks(payload, h, emit).astype(np.int16)
        # only the stream's last block is short, so the samples are a prefix
        payload = torch.from_numpy(np.concatenate(rows)).to(self._device)
        return self._decoder._decode_prefix(payload, len(rows), emit).cpu().numpy()

    def _empty(self) -> np.ndarray:
        # the channel count is unknown until the header has arrived
        nch = self._header.num_channels if self._header else 0
        return np.empty((nch, 0), dtype=np.int16)
