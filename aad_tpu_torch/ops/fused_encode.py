"""Wrapper of the CUDA whole-stream encode kernel, beside its plain torch version.

:func:`encode_stream` -> ``aad_encode_stream`` (``csrc/encode.cu``), the port
of the fused Pallas kernel ``aad_tpu/ops/pallas_encode_fused.py::_make_kernel``
(driven by ``encode_stream_fused``): trial search, history seed, weight
rounding, header fields and codes for every block of every lane, in one
launch. It has the contract of the plain engine,
``ops.encode.encode_stream_blocks_carry``, which is its plain version; with
``pack``, the codes come out packed as the wire holds them, each block's
data region, as the TPU kernel packs its code words
(``pallas_encode_fused.py:760-770``), and the plain version is that engine
followed by ``bitpack.pack_codes``.

When the caller needs the predictor carry, the state after the last block is
rebuilt by one pass of ``aad_encode_pass`` over that block from its header
state, where ``aad_tpu`` runs its per-pass kernel
(``pallas_encode_fused.py:1145-1166``).

``pass_stack``'s semantics carry over as the kernel's paired schedule. Where
the trial search warms on the previous block (the sequential path,
``StreamingEncoder``, the chunked parallel mode), the baseline measure and
the speculative emits run beside the chain of warm-ups and measures, on a
second thread of each lane, so a block takes 2N passes of latency in place
of 2N + 2; a narrow launch also stages its samples in shared memory
(``csrc/encode.cu``). The block-parallel mode keeps the serial trial search.

:func:`encode_wire` -> ``aad_encode_stream_wire``, the kernel's wire mode,
for ``StreamingEncoder``: it takes a stream's samples as uploaded and writes
its blocks as the wire holds them (the zero padding, each block's valid
count, mid/side and the header bytes in the kernel, where the plain version
composes :func:`_pad_to_blocks`, ``lr_to_ms``, :func:`encode_stream_reference`
and :func:`_block_bytes`), and leaves the carry where kernel 4 and the next
launch read it (:class:`WireCarry`): a push is the upload, kernels 3 and 4
and the copy down. While a profiler records (``utils.trace``) it counts the
blocks whose whole bytes the kernel wrote (``k3_rows_written``) and, of
them, those whose mid/side it combined (``k3_rows_ms``).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. Nothing falls back. :data:`launches` counts kernel launches.

Not carried over from the TPU kernel, because they exist only for the TPU:

* the u32 sample-pair words, the (8, 128) lane tiles and the R-fold lane
  interleave (``AAD_TPU_ENCODE_R``): a thread is a lane, and samples go in
  as int16, time-major;
* ``pass_stack``'s stacking of two passes on a tile's dead sublane rows:
  two threads of a warp take that place;
* the VMEM chunked-DMA variant for large blocks: the kernel reads device
  memory directly at any block size;
* the f32 step-size formula with its correction set: the kernel reads the
  exact int table;
* the two-limb error sum: int64 here;
* the u32 view of the packed code words: the kernel writes the wire's bytes;
* ``_bucket_blocks``-style shape padding, which only reused jit compiles.
"""

from __future__ import annotations

import functools
import math

import torch

from ..constants import FILTER_ORDER
from ..format.framing import BlockStates, build_block_headers
from ..format.geometry import BlockGeometry, encoded_block_bytes, num_blocks_for
from ..utils.trace import count, span
from . import _build, bitpack
from .encode import BlockHeaderFields, _lane_valid, encode_stream_blocks_carry, lr_to_ms
from .encode_pass import encode_pass, encode_pass_bank
from .transitions import CodecState, index_table, stepsize_table

STREAM_KERNEL = "aad_encode_stream"

# Launch counts; the wrapper adds one where it launches, and nowhere else.
launches: dict[str, int] = {STREAM_KERNEL: 0}


def encode_stream_reference(blocks, valid, bits_per_sample: int, num_trials: int, *,
                            pack: BlockGeometry | None = None, **kwargs):
    """The plain version of ``aad_encode_stream``, on any device:
    ``encode_stream_blocks_carry``, its codes packed by
    ``bitpack.pack_codes`` with ``pack``."""
    headers, codes, out = encode_stream_blocks_carry(blocks, valid, bits_per_sample, num_trials, **kwargs)
    return headers, codes if pack is None else bitpack.pack_codes(codes, pack), out


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _pad_to_blocks(pcm: torch.Tensor, geo: BlockGeometry, first_block: int, num_blocks: int):
    """Blocks [first_block, first_block + num_blocks) of (C, N) PCM.

    Returns ((B, C, nspb) int16 zero-padded, valid (B,) int32): samples past
    N read as zero and a block past the end has valid 0.
    """
    C, n = pcm.shape
    nspb = geo.num_samples_per_block
    s0 = first_block * nspb
    part = pcm[:, s0 : s0 + num_blocks * nspb]
    buf = torch.zeros((C, num_blocks * nspb), dtype=torch.int16, device=pcm.device)
    buf[:, : part.shape[1]] = part
    starts = (first_block + torch.arange(num_blocks, device=pcm.device)) * nspb
    valid = torch.clamp(n - starts, 0, nspb).to(torch.int32)
    return buf.reshape(C, num_blocks, nspb).transpose(0, 1), valid


def _block_bytes(headers: BlockHeaderFields, data: torch.Tensor, geo: BlockGeometry) -> torch.Tensor:
    """Header fields + (B, *streams, data_bytes) data regions, the codes
    packed (``encode_stream(..., pack=geo)``) -> (B, *streams, block_size)
    whole blocks."""
    states = BlockStates(headers.step_index, headers.weight, headers.history)
    return torch.cat([build_block_headers(states, headers.shift, geo), data], dim=-1)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"encode_stream: {what}")


def encode_stream(
    blocks: torch.Tensor,
    valid,
    bits_per_sample: int,
    num_trials: int,
    *,
    carry: tuple[CodecState, torch.Tensor] | None = None,
    blocks_before: int = 0,
    warm_on_prev: bool = True,
    need_carry: bool = True,
    emit_block_states: bool = False,
    pack: BlockGeometry | None = None,
):
    """Encode B blocks of every lane in sequence; the contract of
    ``ops.encode.encode_stream_blocks_carry``.

    ``blocks`` is (B, *lanes, nspb) int16, zero-padded, mid/side applied;
    ``valid`` is (B,) or broadcastable to (B, *lanes). Returns (headers
    (B, *lanes[, 4]), codes, carry' or per-block states or None). The codes
    are (B, *lanes, nspb - 4) uint8, one a byte; with ``pack`` (the blocks'
    geometry, its channels the last lane axis and its nspb theirs), (B,
    *lanes[:-1], pack.data_bytes) uint8: each block's data region, the
    channels' units interleaved, as ``bitpack.pack_codes`` packs them.
    """
    _require(bits_per_sample in (2, 3, 4), f"bits_per_sample {bits_per_sample}")
    _require(num_trials >= 0, f"num_trials {num_trials}")
    _require(blocks.dim() >= 2, f"blocks must be (B, *lanes, nspb), got {tuple(blocks.shape)}")
    _require(blocks.dtype == torch.int16, f"blocks must be int16, got {blocks.dtype}")
    _require(blocks.shape[0] >= 1 and blocks.shape[-1] > FILTER_ORDER, f"shape {tuple(blocks.shape)}")
    if pack is not None:
        _require(blocks.dim() >= 3 and blocks.shape[-2] == pack.num_channels
                 and blocks.shape[-1] == pack.num_samples_per_block and pack.bits_per_sample == bits_per_sample,
                 f"blocks {tuple(blocks.shape)} at {bits_per_sample} bits do not have the geometry {pack}")
    kwargs = dict(
        carry=carry, blocks_before=int(blocks_before), warm_on_prev=warm_on_prev,
        need_carry=need_carry, emit_block_states=emit_block_states,
    )
    device = blocks.device
    if device.type == "cpu":
        return encode_stream_reference(blocks, valid, bits_per_sample, num_trials, pack=pack, **kwargs)
    _require(device.type == "cuda", f"no kernel for device {device}")
    return _launch(blocks, valid, bits_per_sample, num_trials, pack=pack, **kwargs)


def _fields(t: torch.Tensor, lanes) -> CodecState:
    """(B, >=9, L) field-major kernel output -> CodecState leaves (B, *lanes[, 4])."""
    B = t.shape[0]
    return CodecState(
        history=t[:, 0:4].transpose(1, 2).reshape(B, *lanes, FILTER_ORDER),
        weight=t[:, 4:8].transpose(1, 2).reshape(B, *lanes, FILTER_ORDER),
        step_index=t[:, 8].reshape(B, *lanes),
    )


def encode_stream_tm(
    samples: torch.Tensor,
    valid: torch.Tensor,
    state: CodecState,
    prev0: torch.Tensor | None,
    bits_per_sample: int,
    num_trials: int,
    *,
    warm_on_prev: bool = True,
    blocks_before: int = 0,
    emit_block_states: bool = False,
    pack: BlockGeometry | None = None,
):
    """One launch of ``aad_encode_stream`` in the kernel's own layout (CUDA only).

    Args:
      samples: (B, nspb, L) int16, time-major, contiguous.
      valid: (B, L) int32.
      state: initial state, leaves (L, 4) / (L,) int32, contiguous.
      prev0: (nspb, L) int16, the block before block 0; read only when
        ``num_trials > 0`` and ``warm_on_prev``, else may be None.
      pack: the blocks' geometry, lane l channel l % C of row l // C; or None.
    Returns:
      (codes, headers (B, 10, L) int32: history[4], rounded weight[4], step
      index, shift; states (B, 9, L) int32 or None). The codes are (B,
      nspb - 4, L) uint8, one a byte, time-major; with ``pack``, (B, L // C,
      pack.data_bytes) uint8, each row's data region, packed.
    """
    B, nspb, L = samples.shape
    device = samples.device
    _require(device.type == "cuda", f"encode_stream_tm needs CUDA tensors, got {device}")
    needs_prev = num_trials > 0 and warm_on_prev
    tensors = [("samples", samples, torch.int16, (B, nspb, L)), ("valid", valid, torch.int32, (B, L)),
               ("history", state.history, torch.int32, (L, FILTER_ORDER)),
               ("weight", state.weight, torch.int32, (L, FILTER_ORDER)),
               ("step_index", state.step_index, torch.int32, (L,))]
    if needs_prev:
        tensors.append(("prev0", prev0, torch.int16, (nspb, L)))
    for name, t, dtype, shape in tensors:
        _require(t is not None and t.dtype == dtype and tuple(t.shape) == shape,
                 f"{name} must be {dtype} {shape}")
        _require(t.device == device and t.is_contiguous(), f"{name} must be contiguous on {device}")
    C = 1 if pack is None else pack.num_channels
    if pack is not None:
        _require(L % C == 0 and pack.num_samples_per_block == nspb and pack.bits_per_sample == bits_per_sample,
                 f"{L} lanes of {nspb} samples at {bits_per_sample} bits do not have the geometry {pack}")
    i32 = dict(dtype=torch.int32, device=device)
    shape = (B, nspb - FILTER_ORDER, L) if pack is None else (B, L // C, pack.data_bytes)
    codes = torch.empty(shape, dtype=torch.uint8, device=device)
    headers = torch.empty((B, 10, L), **i32)
    states = torch.empty((B, 9, L), **i32) if emit_block_states else None
    if L == 0:
        return codes, headers, states
    with span("aad.launch.encode_stream"):
        lib = _build.library()
        err = lib.aad_encode_stream(
            samples.data_ptr(), prev0.data_ptr() if needs_prev else None, valid.data_ptr(),
            state.step_index.data_ptr(), state.history.data_ptr(), state.weight.data_ptr(),
            stepsize_table(device).data_ptr(), index_table(bits_per_sample, device).data_ptr(),
            codes.data_ptr(), headers.data_ptr(), None if states is None else states.data_ptr(),
            B, L, nspb, C, bits_per_sample, int(pack is not None), num_trials, int(warm_on_prev), int(blocks_before),
            *_build.launch_target(device),
        )
        _build.check(lib, STREAM_KERNEL, err)
    launches[STREAM_KERNEL] += 1
    return codes, headers, states


def _launch(blocks, valid, bits_per_sample, num_trials, *, carry, blocks_before, warm_on_prev,
            need_carry, emit_block_states, pack):
    """encode_stream on CUDA: the kernel's layout in and out around one launch."""
    B, *lanes, nspb = blocks.shape
    L = math.prod(lanes)
    T = nspb - FILTER_ORDER
    device = blocks.device
    i32 = dict(dtype=torch.int32, device=device)

    samples = blocks.reshape(B, L, nspb).transpose(1, 2).contiguous()  # (B, nspb, L)
    va = _lane_valid(valid, B, lanes, device).reshape(B, L).contiguous()
    if carry is None:
        state = CodecState.zeros((L,), device)
        prev0 = torch.zeros((nspb, L), dtype=torch.int16, device=device)
    else:
        st, prev = carry
        state = CodecState(
            history=st.history.reshape(L, FILTER_ORDER), weight=st.weight.reshape(L, FILTER_ORDER),
            step_index=st.step_index.reshape(L),
        ).map(lambda a: a.to(**i32).contiguous())
        prev0 = prev.reshape(L, nspb).to(torch.int16).t().contiguous()
    if num_trials == 0 or not warm_on_prev:
        prev0 = None  # never read
    codes, headers, states = encode_stream_tm(
        samples, va, state, prev0, bits_per_sample, num_trials, warm_on_prev=warm_on_prev,
        blocks_before=blocks_before, emit_block_states=emit_block_states, pack=pack,
    )

    hdr_state = _fields(headers, lanes)
    hdr = BlockHeaderFields(
        step_index=hdr_state.step_index, shift=headers[:, 9].reshape(B, *lanes),
        weight=hdr_state.weight, history=hdr_state.history,
    )
    if pack is None:
        codes = codes.transpose(1, 2).reshape(B, *lanes, T)
    else:
        codes = codes.reshape(B, *lanes[:-1], pack.data_bytes)
    if emit_block_states:
        return hdr, codes, _fields(states, lanes)
    if not need_carry:
        return hdr, codes, None
    # The carry: the last block's emit pass, rerun from its header state
    # (seeded history, rounded weights) by the per-pass kernel.
    last = headers[-1]
    seeded = CodecState(
        history=last[0:4].t().contiguous(), weight=last[4:8].t().contiguous(), step_index=last[8],
    )
    full = torch.full((L,), nspb, **i32)
    final, _, _ = encode_pass(samples[-1, FILTER_ORDER:], seeded, full, bits_per_sample)
    final = CodecState(
        history=final.history.reshape(*lanes, FILTER_ORDER),
        weight=final.weight.reshape(*lanes, FILTER_ORDER), step_index=final.step_index.reshape(*lanes),
    )
    return hdr, codes, (final, blocks[-1])


class WireCarry:
    """What kernel 3's wire mode carries on a card from one launch to the
    next, in buffers that the stream's encoder owns: the state kernel 4 left
    after the last block, and that block's samples (mid/side applied, time-
    major), where kernel 3 wrote them. Two sets, used in turn, so that no
    launch reads what it writes."""

    def __init__(self, lanes: int, nspb: int, device: torch.device):
        # per set: the last block's header state (kernel 4's entry), then
        # kernel 4's end state; each (L,) step index, (L, 4) history, (L, 4) weight
        self._states = torch.empty((2, 2, 9 * lanes), dtype=torch.int32, device=device)
        self.sse = torch.empty((lanes,), dtype=torch.int64, device=device)  # kernel 4's error sum: unread
        self._samples = [torch.empty((0, nspb, lanes), dtype=torch.int16, device=device) for _ in range(2)]
        self.turn = 0    # the set the last launch wrote
        self.blocks = 0  # that launch's blocks

    def header_state(self, turn: int) -> CodecState:
        """Set ``turn``'s last block's header state."""
        return self._state(turn, 0)

    def end_state(self, turn: int) -> CodecState:
        """Set ``turn``'s state after its last block."""
        return self._state(turn, 1)

    def _state(self, turn: int, which: int) -> CodecState:
        flat = self._states[turn, which]
        L = flat.shape[0] // 9
        return CodecState(history=flat[L : 5 * L].view(L, FILTER_ORDER),
                          weight=flat[5 * L :].view(L, FILTER_ORDER), step_index=flat[:L])

    def samples(self, turn: int, num_blocks: int) -> torch.Tensor:
        """Set ``turn``'s (num_blocks, nspb, L) samples buffer, grown to fit."""
        buf = self._samples[turn]
        if buf.shape[0] < num_blocks:
            buf = self._samples[turn] = torch.empty((num_blocks, *buf.shape[1:]), dtype=buf.dtype, device=buf.device)
        return buf[:num_blocks]

    def prev_block(self) -> torch.Tensor:
        """The last launch's last block, (nspb, L) time-major."""
        return self._samples[self.turn][self.blocks - 1]


def encode_wire_reference(pcm, geo: BlockGeometry, num_trials: int, *, mid_side: bool = False, carry=None,
                          blocks_before: int = 0):
    """The plain version of kernel 3's wire mode, on any device: the blocks
    of :func:`_pad_to_blocks`, mid/side by ``lr_to_ms``, the encode of
    :func:`encode_stream_reference`, the rows of :func:`_block_bytes`; the
    carry is ``encode_stream_blocks_carry``'s."""
    blocks, valid = _pad_to_blocks(pcm, geo, 0, num_blocks_for(pcm.shape[1], geo.num_samples_per_block))
    if mid_side:
        blocks = lr_to_ms(blocks).to(torch.int16)
    headers, data, carry = encode_stream_reference(blocks, valid, geo.bits_per_sample, num_trials, carry=carry,
                                                   blocks_before=blocks_before, pack=geo)
    return _block_bytes(headers, data, geo), carry


def encode_wire(pcm: torch.Tensor, geo: BlockGeometry, num_trials: int, *, mid_side: bool = False, carry=None,
                blocks_before: int = 0):
    """Encode a stream's next blocks from its samples, as the wire holds them.

    ``pcm`` is (C, n) int16, the stream's next n samples a channel from a
    block boundary on; samples past n read as zero, so only the last block
    may be short. ``mid_side`` (two channels) encodes mid and side. ``carry``
    is what the call before returned: None for the stream's first blocks,
    with ``blocks_before`` 0. Returns (rows (B, geo.block_size) uint8, each
    block's header bytes and data region; carry'): on a card one launch of
    kernel 3's wire mode and one of kernel 4 for the carry (a
    :class:`WireCarry`, the same object from call to call); on the CPU the
    plain version, :func:`encode_wire_reference`.
    """
    bps = geo.bits_per_sample
    _require(bps in (2, 3, 4), f"bits_per_sample {bps}")
    _require(num_trials >= 0, f"num_trials {num_trials}")
    _require(geo.num_samples_per_block > FILTER_ORDER, f"{geo.num_samples_per_block} samples a block")
    _require(pcm.dim() == 2 and pcm.shape[0] == geo.num_channels and pcm.shape[1] >= 1,
             f"pcm must be ({geo.num_channels}, n >= 1), got {tuple(pcm.shape)}")
    _require(pcm.dtype == torch.int16, f"pcm must be int16, got {pcm.dtype}")
    _require(not mid_side or geo.num_channels == 2, f"mid/side of {geo.num_channels} channel(s)")
    _require(carry is not None or blocks_before == 0, "blocks before the first call need a carry")
    kwargs = dict(mid_side=mid_side, carry=carry, blocks_before=int(blocks_before))
    if pcm.device.type == "cpu":
        return encode_wire_reference(pcm, geo, num_trials, **kwargs)
    _require(pcm.device.type == "cuda", f"no kernel for device {pcm.device}")
    _require(pcm.is_contiguous(), "pcm must be contiguous")
    return _launch_wire(pcm, geo, num_trials, **kwargs)


@functools.cache
def _whole_valid(device: torch.device, lanes: int, nspb: int) -> torch.Tensor:
    """Kernel 4's (L,) valid for the carry's pass: the whole block."""
    return torch.full((lanes,), nspb, dtype=torch.int32, device=device)


def _launch_wire(pcm, geo, num_trials, *, mid_side, carry, blocks_before):
    """encode_wire on CUDA: kernel 3's wire mode, then kernel 4 from the last
    block's header state, both on the carry's buffers."""
    C, n = pcm.shape
    L, nspb, bps = C, geo.num_samples_per_block, geo.bits_per_sample
    B = num_blocks_for(n, nspb)
    device = pcm.device
    if carry is None:  # a zero state and no block before: the kernel takes nulls for them
        carry = WireCarry(L, nspb, device)
        turn, init = 0, (None,) * 4
    else:
        st = carry.end_state(carry.turn)
        turn, init = carry.turn ^ 1, (carry.prev_block(), st.step_index, st.history, st.weight)
    samples, seeded = carry.samples(turn, B), carry.header_state(turn)
    rows = torch.empty((B, geo.block_size), dtype=torch.uint8, device=device)
    with span("aad.launch.encode_stream"):
        lib = _build.library()
        err = lib.aad_encode_stream_wire(
            pcm.data_ptr(), n, *(None if t is None else t.data_ptr() for t in init),
            stepsize_table(device).data_ptr(), index_table(bps, device).data_ptr(), samples.data_ptr(),
            rows.data_ptr(), seeded.step_index.data_ptr(), seeded.history.data_ptr(), seeded.weight.data_ptr(),
            B, L, nspb, C, bps, geo.block_size, int(mid_side), num_trials, blocks_before,
            *_build.launch_target(device),
        )
        _build.check(lib, STREAM_KERNEL, err)
    launches[STREAM_KERNEL] += 1
    count("k3_rows_written", B)
    if mid_side:
        count("k3_rows_ms", B)
    encode_pass(samples[-1, FILTER_ORDER:], seeded, _whole_valid(device, L, nspb), bps,
                out=(carry.end_state(turn), carry.sse))
    carry.turn, carry.blocks = turn, B
    return rows, carry



BANK_FIELDS = 5  # a feed's row of a bank tick's table: slot, n, first sample, first byte, carried


def write_feeds(table, slot, n, first, byte0, carried) -> None:
    """Fill the first F rows of a bank tick's (S, BANK_FIELDS) int32 table
    (:func:`encode_bank`'s ``feeds``), one (F,) array a field."""
    for k, column in enumerate((slot, n, first, byte0, carried)):
        table[: len(slot), k] = column


class CarryBank:
    """The carries of a bank of S slots of C lanes each, in one set of
    buffers, read and written by slot index: each slot's state after its
    feed's last block (history, weight and step index of lane slot * C + c)
    and that block's samples (mid/side applied; (nspb, S * C), time-major).
    On a card kernel 3's bank mode reads them for carried feeds and rewrites
    the samples, and kernel 4 writes the states; on the CPU the plain
    version does both. A slot's carry is read only while its feed has one:
    a feed's first tick starts from a zero state."""

    def __init__(self, slots: int, channels: int, nspb: int, device: torch.device):
        lanes = slots * channels
        self.slots, self.channels, self.nspb, self.device = slots, channels, nspb, device
        self._state = torch.zeros((9 * lanes,), dtype=torch.int32, device=device)
        # each lane's state after its slot's last block, leaves (S * C, 4) / (S * C,)
        self.end = _flat_state(self._state)
        self.prev = torch.zeros((nspb, lanes), dtype=torch.int16, device=device)
        # a tick's scratch on a card: the staged samples and the feeds' last blocks' header states
        self._ms = torch.empty((0,), dtype=torch.int16, device=device)
        self._seeded = torch.empty((0,), dtype=torch.int32, device=device)

    def scratch(self, blocks: int, lanes: int) -> tuple[torch.Tensor, CodecState]:
        """A tick's (blocks, nspb, lanes) samples and (lanes, ...) header states, grown to fit."""
        if self._ms.numel() < blocks * self.nspb * lanes:
            self._ms = torch.empty((blocks * self.nspb * lanes,), dtype=torch.int16, device=self.device)
        if self._seeded.numel() < 9 * lanes:
            self._seeded = torch.empty((9 * lanes,), dtype=torch.int32, device=self.device)
        ms = self._ms[: blocks * self.nspb * lanes].view(blocks, self.nspb, lanes)
        return ms, _flat_state(self._seeded[: 9 * lanes])


def _flat_state(flat: torch.Tensor) -> CodecState:
    """A (9 L,) int32 buffer as a CodecState: step index (L,), history (L, 4), weight (L, 4)."""
    L = flat.shape[0] // 9
    return CodecState(history=flat[L: 5 * L].view(L, FILTER_ORDER), weight=flat[5 * L:].view(L, FILTER_ORDER),
                      step_index=flat[:L])


def encode_bank_reference(pcm, feeds, geo: BlockGeometry, num_trials: int, *, mid_side: bool, carry: CarryBank,
                          channel_stride: int, num_blocks: int, total_blocks: int, total_bytes: int) -> torch.Tensor:
    """The plain version of kernels 3 and 4 in their bank mode, on any
    device: each feed's blocks from ``pcm`` zero-padded past its n, mid/side
    by ``lr_to_ms``; block b of every feed that has one encoded at once by
    :func:`encode_stream_reference`, from the carries the feeds bring
    (block 0's, in two calls: the feeds with a previous block and those
    without), the rows of :func:`_block_bytes`, each at its feed's bytes, a
    short last block cut to its wire bytes; then the carries back to the
    feeds' slots."""
    C, nspb, bs = geo.num_channels, geo.num_samples_per_block, geo.block_size
    F = feeds.shape[0]
    out = torch.zeros((total_bytes,), dtype=torch.uint8, device=pcm.device)
    if F == 0:
        return out
    fd = feeds.to(torch.int64)
    slot, n, first, byte0, carried = fd.unbind(1)
    t = torch.arange(num_blocks * nspb, device=pcm.device)
    idx = first[:, None, None] + channel_stride * torch.arange(C, device=pcm.device)[None, :, None] + t
    live = t < n[:, None, None]
    x = torch.where(live, pcm[torch.where(live, idx, 0)], 0).to(torch.int16)
    blocks = x.reshape(F, C, num_blocks, nspb).permute(2, 0, 1, 3)  # (B, F, C, nspb)
    if mid_side:
        blocks = lr_to_ms(blocks).to(torch.int16)
    valid = (n[None] - nspb * torch.arange(num_blocks, device=pcm.device)[:, None]).clamp(0, nspb)  # (B, F)
    wire = torch.tensor([[encoded_block_bytes(geo, v) for v in row] for row in valid.tolist()], device=pcm.device)
    col = torch.arange(bs, device=pcm.device)

    lanes = slot[:, None] * C + torch.arange(C, device=pcm.device)  # (F, C): the feeds' lanes in the bank
    end = carry.end
    state = CodecState(*(torch.where(carried.bool().view(F, *(1,) * (a.dim() - 1)), a, 0)
                         for a in (end.history[lanes], end.weight[lanes], end.step_index[lanes])))
    prev = carry.prev.t()[lanes]  # (F, C, nspb)
    for b in range(num_blocks):
        has = valid[b] > 0
        groups = [has & (carried > 0), has & (carried == 0)] if b == 0 else [has]
        for g in groups:
            at = torch.nonzero(g).flatten()
            if at.numel() == 0:
                continue
            headers, data, (st, last) = encode_stream_reference(
                blocks[b: b + 1, at], valid[b: b + 1, at, None].expand(1, -1, C), geo.bits_per_sample, num_trials,
                carry=(state.map(lambda a: a[at]), prev[at]), blocks_before=int(b > 0 or bool(carried[at[0]])),
                pack=geo)
            keep = col < wire[b, at, None]  # a short last block: its wire bytes alone
            out[(byte0[at, None] + b * bs + col)[keep]] = _block_bytes(headers, data, geo)[0][keep]
            for a, new in zip(state, st):
                a[at] = new
            prev[at] = last.to(torch.int16)
    for a, got in zip(end, state):
        a[lanes] = got
    carry.prev.t()[lanes] = prev
    return out


def encode_bank(pcm: torch.Tensor, feeds: torch.Tensor, geo: BlockGeometry, num_trials: int, *, mid_side: bool,
                carry: CarryBank, channel_stride: int, num_blocks: int, total_blocks: int,
                total_bytes: int) -> torch.Tensor:
    """Encode one tick of a bank of streams: each feed's next blocks, as the wire holds them.

    ``feeds`` is (F, 5) int32, a row a feed: its slot in ``carry``, its
    samples a channel n >= 1, where its first sample lies in ``pcm`` (a flat
    int16 tensor: channel c at ``first + c * channel_stride``), its first
    byte in the result, and whether it has a carry (its slot's blocks
    before; else a zero state and no block before). Samples past n read as
    zero, so only a feed's last block may be short. ``num_blocks`` is the
    most blocks of a feed, ``total_blocks`` their sum. Returns
    ``total_bytes`` uint8: each feed's blocks
    as the wire holds them (header bytes, data region) from its first byte
    on, a short last block cut to the units of its valid samples; and
    leaves each feed's carry in its slot. On a card one
    launch of kernel 3's bank mode and one of kernel 4's bank instance,
    whatever F; on the CPU the plain version, :func:`encode_bank_reference`.
    """
    bps = geo.bits_per_sample
    _require(bps in (2, 3, 4), f"bits_per_sample {bps}")
    _require(num_trials >= 0, f"num_trials {num_trials}")
    _require(geo.num_samples_per_block > FILTER_ORDER, f"{geo.num_samples_per_block} samples a block")
    _require(not mid_side or geo.num_channels == 2, f"mid/side of {geo.num_channels} channel(s)")
    _require(pcm.dim() == 1 and pcm.dtype == torch.int16, f"pcm must be flat int16, got {pcm.dtype} {tuple(pcm.shape)}")
    _require(feeds.dim() == 2 and feeds.shape[1] == BANK_FIELDS and feeds.dtype == torch.int32,
             f"feeds must be (F, {BANK_FIELDS}) int32")
    _require(carry.channels == geo.num_channels and carry.nspb == geo.num_samples_per_block,
             "the carry bank has another geometry")
    _require(pcm.device == feeds.device == carry.device, "pcm, feeds and the carry bank on one device")
    kwargs = dict(mid_side=mid_side, carry=carry, channel_stride=int(channel_stride), num_blocks=int(num_blocks),
                  total_blocks=int(total_blocks), total_bytes=int(total_bytes))
    if pcm.device.type == "cpu":
        return encode_bank_reference(pcm, feeds, geo, num_trials, **kwargs)
    _require(pcm.device.type == "cuda", f"no kernel for device {pcm.device}")
    _require(num_trials > 0, "the bank's kernel takes the paired schedule: num_trials of 1 or more")
    _require(pcm.is_contiguous() and feeds.is_contiguous(), "pcm and feeds must be contiguous")
    return _launch_bank(pcm, feeds, geo, num_trials, **kwargs)


def _launch_bank(pcm, feeds, geo, num_trials, *, mid_side, carry, channel_stride, num_blocks, total_blocks,
                 total_bytes):
    """encode_bank on CUDA: kernel 3's bank mode, then kernel 4's bank instance."""
    C, nspb, bps = geo.num_channels, geo.num_samples_per_block, geo.bits_per_sample
    L = feeds.shape[0] * C
    device = pcm.device
    rows = torch.empty((total_bytes,), dtype=torch.uint8, device=device)
    if L == 0:
        return rows
    ms, seeded = carry.scratch(num_blocks + 1, L)
    end = carry.end
    with span("aad.launch.encode_stream"):
        lib = _build.library()
        err = lib.aad_encode_stream_bank(
            feeds.data_ptr(), pcm.data_ptr(), channel_stride, carry.prev.data_ptr(), end.step_index.data_ptr(),
            end.history.data_ptr(), end.weight.data_ptr(), carry.slots * C, stepsize_table(device).data_ptr(),
            index_table(bps, device).data_ptr(), ms.data_ptr(), rows.data_ptr(), seeded.step_index.data_ptr(),
            seeded.history.data_ptr(), seeded.weight.data_ptr(), num_blocks, L, nspb, C, bps, geo.block_size,
            int(mid_side), num_trials, *_build.launch_target(device),
        )
        _build.check(lib, STREAM_KERNEL, err)
    launches[STREAM_KERNEL] += 1
    count("k3_rows_written", total_blocks)
    if mid_side:
        count("k3_rows_ms", total_blocks)
    encode_pass_bank(feeds, ms, seeded, end, C, nspb, bps)
    return rows
