"""Plain torch block encode: the CPU engine and the CUDA encode kernels' oracle.

The torch counterpart of ``aad_tpu.ops.encode``'s scan engine. Encode
chains the processor state across blocks and its trial search re-reads the
previous block (reference: src/aad_encoder.c:870, 502-512), so:

* blocks run in sequence (a Python loop carrying the :class:`CodecState`),
* everything inside a block is vectorised over the lane axes (channels,
  streams, or blocks in the block-parallel mode),
* each block's samples run as a loop over time whose body is
  :func:`transitions.encode_sample` on every lane at once,
* trial-search winners are chosen by exact integer comparison of int64
  sums of *wrapped* int32 squared errors (``cseman.sse_better``), which
  decides exactly as the reference's double-precision RMSE comparison
  (see ``aad_tpu/ops/encode.py``'s module docstring).

Every function here has the contract of its ``aad_tpu`` namesake; codes
come out as uint8. The CUDA kernels (``ops.fused_encode``,
``ops.encode_pass``) compute the same functions and are held against these.

Not carried over, because they exist only for the TPU: the two-limb SSE
(torch has int64), the Pallas per-pass pipeline
``encode_stream_blocks_pallas`` and its tile relayout, the u32 view of the
packed code words of ``encode_stream_words`` (the port packs bytes, as the
wire holds them: kernel 3 on the card, ``ops.fused_encode.encode_stream``
with ``pack``, and ``bitpack.pack_codes`` in its plain version), and
``encode_blocks_parallel_flat``, whose channel-major fold existed for the
TPU's (8, 128) tiling.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import FILTER_ORDER
from . import cseman as cs
from .transitions import CodecState, encode_sample

I64 = torch.int64


class BlockHeaderFields(NamedTuple):
    """Per-block header payload produced by the encoder."""

    step_index: torch.Tensor  # (..., C) int32
    shift: torch.Tensor       # (..., C) int32 weight shift
    weight: torch.Tensor      # (..., C, 4) int32, already rounded (low bits cleared)
    history: torch.Tensor     # (..., C, 4) int32


def _select_state(pred: torch.Tensor, a: CodecState, b: CodecState) -> CodecState:
    """Elementwise state select; ``pred`` has the lane shape."""
    p1 = pred[..., None]
    return CodecState(
        history=torch.where(p1, a.history, b.history),
        weight=torch.where(p1, a.weight, b.weight),
        step_index=torch.where(pred, a.step_index, b.step_index),
    )


def _seed_from_block(state: CodecState, block: torch.Tensor) -> CodecState:
    """Load a block's first four samples into history (newest last-in).

    ``block`` is (..., nspb), already zero-padded, which reproduces the
    reference's memset + bounded copy for short blocks (reference:
    src/aad_encoder.c:588-616, 450-453).
    """
    return state._replace(history=block[..., :FILTER_ORDER].to(torch.int32).flip(-1))


def _encode_span(state: CodecState, samples: torch.Tensor, live, bits_per_sample: int):
    """The encode recurrence over a block's code slots, freezing state and
    error past ``live`` slots.

    ``samples`` is (..., T): the block's samples after its four head
    samples. Slot t updates the state and the error sum iff t < ``live``
    (scalar or lane-shaped); codes are computed for every slot, from the
    frozen state past ``live``. Returns (state', codes (..., T) uint8, sse
    (...) int64).
    """
    lane_shape = state.step_index.shape
    live = torch.as_tensor(live, device=samples.device)
    sse = torch.zeros(lane_shape, dtype=I64, device=samples.device)
    codes = []
    for t in range(samples.shape[-1]):
        new_state, code, qdiff = encode_sample(state, samples[..., t], bits_per_sample)
        active = (t < live).expand(lane_shape)
        state = _select_state(active, new_state, state)
        sse = sse + torch.where(active, cs.wrapped_square(qdiff), 0).to(I64)
        codes.append(code.to(torch.uint8))
    return state, torch.stack(codes, dim=-1), sse


def measure_block(state: CodecState, block: torch.Tensor, valid, bits_per_sample: int):
    """Trial-encode a block and sum its squared quantisation errors.

    Mirrors ``AADEncodeProcessor_CalculateRMSError`` (reference:
    src/aad_encoder.c:431-467): seeds history from the first four samples,
    encodes samples [4, valid) and sums the wrapped qdiff**2. Blocks with
    fewer than four valid samples leave the state untouched and report zero
    error (the reference's early return).

    Args:
      state: lanes of codec state, lane shape (...).
      block: (..., nspb) zero-padded samples.
      valid: scalar or (...) valid samples in this block.
    Returns:
      (state', sse (...) int64).
    """
    lane_shape = state.step_index.shape
    valid = torch.as_tensor(valid, device=block.device)
    seeded = _seed_from_block(state, block)
    final, _, sse = _encode_span(seeded, block[..., FILTER_ORDER:], valid - FILTER_ORDER, bits_per_sample)
    skip = (valid < FILTER_ORDER).expand(lane_shape)
    return _select_state(skip, state, final), torch.where(skip, 0, sse)


def search_best_state(
    state: CodecState,
    cur_block: torch.Tensor,
    prev_block: torch.Tensor,
    has_prev: bool,
    valid,
    bits_per_sample: int,
    num_trials: int,
    warm_on_prev: bool = True,
) -> CodecState:
    """Trial search for the lowest-error starting state, per lane.

    Re-encoding consecutive blocks warms the adaptive filter; the candidate
    with the least error on the current block wins, per lane, and the last
    strict improvement wins (reference: src/aad_encoder.c:470-562).
    ``has_prev`` says whether a previous block exists: stream heads skip
    the warm-up (src/aad_encoder.c:503), which is always on the full-length
    previous block. ``warm_on_prev=False`` drops the warm-up altogether
    (the block-parallel mode, where every block is a head).
    """
    _, min_sse = measure_block(state, cur_block, valid, bits_per_sample)
    best = state
    tmp = state
    nspb = cur_block.shape[-1]
    for _ in range(num_trials):
        if warm_on_prev and has_prev:
            tmp, _ = measure_block(tmp, prev_block, nspb, bits_per_sample)
        candidate = tmp
        tmp, sse = measure_block(tmp, cur_block, valid, bits_per_sample)
        better = cs.sse_better(sse, min_sse)
        best = _select_state(better, candidate, best)
        min_sse = torch.where(better, sse, min_sse)
    return best


def round_weights(state: CodecState) -> tuple[CodecState, torch.Tensor]:
    """Round weights so they serialise into 16 bits; returns (state', shift).

    The smallest right shift that puts max|weight| into the int16 range is
    ``max(bitlen(max|w|) - 15, 0)``, and the shifted-out bits are cleared
    in place, per lane (reference: src/aad_encoder.c:620-646). As in
    ``aad_tpu``'s scan engine, |INT32_MIN| wraps to itself (C's ABS macro)
    and then has 32 significant bits, so its shift is 17.
    """
    w = state.weight
    maxabs = torch.where(w >= 0, w, -w).amax(dim=-1)
    # bit length as 32 - clz: (maxabs >> k) != 0 for k < bitlen; a negative
    # maxabs stays non-zero under the arithmetic shift, so counts 32
    bitlen = sum(((maxabs >> k) != 0).to(torch.int32) for k in range(32))
    shift = torch.clamp(bitlen - 15, min=0).to(torch.int32)
    mask = ~(torch.bitwise_left_shift(torch.ones_like(shift), shift) - 1)
    return state._replace(weight=w & mask[..., None]), shift


def encode_block_codes(state: CodecState, block: torch.Tensor, bits_per_sample: int):
    """Encode one zero-padded block's data section: (state', codes (..., T)).

    The reference packs whole interleave units and reads the zero padding
    past the valid count (reference: src/aad_encoder.c:588-594, 661-722),
    so every slot of the padded block is encoded.
    """
    final, codes, _ = _encode_span(state, block[..., FILTER_ORDER:], block.shape[-1], bits_per_sample)
    return final, codes


def _lane_valid(valid, num_blocks: int, lane_axes, device) -> torch.Tensor:
    """``valid`` as (B, *lanes) int32: (B,) or anything broadcastable to it."""
    va = torch.as_tensor(valid, dtype=torch.int32, device=device)
    while va.dim() < 1 + len(lane_axes):
        va = va[..., None]
    return va.expand(num_blocks, *lane_axes)


def encode_stream_blocks_carry(
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
):
    """Encode a stream of blocks in sequence; returns (headers, codes, carry').

    Args:
      blocks: (B, *lanes, nspb) zero-padded int16-valued samples (mid/side
        already applied), any integer dtype.
      valid: (B,) valid sample counts, or anything broadcastable to
        (B, *lanes).
      carry: optional (state, prev_block) from a previous chunk, the
        streaming continuation point: ``prev_block`` (*lanes, nspb) is the
        block just before this chunk.
      blocks_before: blocks already encoded; the trial search warms up on
        the previous block only from the stream's second block on
        (reference: src/aad_encoder.c:503).
      warm_on_prev: False drops the trial search's previous-block warm-up
        (only right when every block is a stream head: the parallel mode).
      need_carry: False returns None in place of the carry.
      emit_block_states: return, in place of the carry, the state after
        every block: a CodecState with leaves (B, *lanes[, 4]).
    Returns:
      (BlockHeaderFields with leaves (B, *lanes[, 4]), codes (B, *lanes, T)
      uint8, carry' = (state, blocks[-1]) or per-block states or None).
    """
    B, *lane_axes, nspb = blocks.shape
    device = blocks.device
    x = blocks.to(torch.int32)
    if carry is None:
        state = CodecState.zeros(tuple(lane_axes), device)
        prev0 = torch.zeros_like(x[0])
    else:
        state, prev0 = carry
        state = CodecState(*(a.to(device=device, dtype=torch.int32) for a in state))
        prev0 = prev0.to(device=device, dtype=torch.int32)
    va = _lane_valid(valid, B, lane_axes, device)
    blocks_before = int(blocks_before)

    headers, codes, states = [], [], []
    for b in range(B):
        cur = x[b]
        if num_trials > 0:
            prev = prev0 if b == 0 else x[b - 1]
            state = search_best_state(
                state, cur, prev, b + blocks_before >= 1, va[b], bits_per_sample,
                num_trials, warm_on_prev=warm_on_prev,
            )
        state = _seed_from_block(state, cur)
        state, shift = round_weights(state)
        headers.append(BlockHeaderFields(state.step_index, shift, state.weight, state.history))
        state, block_codes = encode_block_codes(state, cur, bits_per_sample)
        codes.append(block_codes)
        states.append(state)

    hdr = BlockHeaderFields(*(torch.stack(f) for f in zip(*headers)))
    if emit_block_states:
        out = CodecState(*(torch.stack(f) for f in zip(*states)))
    elif need_carry:
        out = (state, blocks[-1])
    else:
        out = None
    return hdr, torch.stack(codes), out


def encode_blocks_parallel(
    blocks: torch.Tensor,
    valid,
    bits_per_sample: int,
    num_trials: int,
    *,
    chunk_blocks: int = 1,
    warm_passes: int = 0,
    stream=encode_stream_blocks_carry,
):
    """Block-parallel encode: the block axis joins the lane axes.

    As ``aad_tpu.ops.encode.encode_blocks_parallel``: every block header
    carries the complete decoder state (reference: src/aad_decoder.c:363-380),
    so an encoder may treat a block as a stream head.

    * ``chunk_blocks=1``: every block is a stream head; the output equals
      the concatenation of independent single-block encodes.
    * ``chunk_blocks=c > 1``: blocks encode in sequence *within* chunks of
      c (with the previous-block warm-up) and in parallel *across* chunks.
    * ``warm_passes=k``: each pass encodes every chunk with trials=0 and
      hands chunk g's final state to chunk g+1 as its initial state for the
      next pass (a Jacobi refinement of the chunk heads' warm start).

    ``stream`` is the sequential engine, with the contract of
    :func:`encode_stream_blocks_carry`: this plain version by default, or
    ``ops.fused_encode.encode_stream``, which launches the CUDA kernel on a
    CUDA tensor (and, given ``pack``, packs the codes).

    Args:
      blocks: (B, *lanes, nspb) zero-padded samples (mid/side applied).
      valid: (B,) valid sample counts (or broadcastable to (B, *lanes)).
    Returns:
      (headers with leaves (B, *lanes[, 4]), codes (B, *lanes, T) uint8, or
      per block as ``stream`` gives them).
    """
    xs, vs, from_chunks = to_chunks(blocks, valid, chunk_blocks)
    warm = xs.shape[0] > 1  # the chunk-internal previous-block warm-up
    carry = None
    for _ in range(warm_passes):
        st = parallel_warm_states(xs, vs, bits_per_sample, carry=carry, warm_on_prev=warm, stream=stream)
        carry = (shift_chunk_states(st), torch.zeros_like(xs[0]))
    headers, codes, _ = stream(
        xs, vs, bits_per_sample, num_trials, carry=carry, warm_on_prev=warm, need_carry=False
    )
    return BlockHeaderFields(*(from_chunks(f) for f in headers)), from_chunks(codes)


def to_chunks(blocks: torch.Tensor, valid, chunk_blocks: int):
    """The block-parallel mode's layout: (B, *lanes, nspb) blocks in chunks of c.

    Pads B to a multiple of c with valid-0 blocks. Returns (xs (c, G,
    *lanes, nspb), vs (c, G, *lanes) int32, from_chunks): step j of chunk g
    is block g*c + j, and ``from_chunks`` maps a (c, G, ...) result back to
    (B, ...), the padding dropped.
    """
    c = max(int(chunk_blocks), 1)
    B, *lane_axes, nspb = blocks.shape
    Bp = -(-B // c) * c
    va = _lane_valid(valid, B, lane_axes, blocks.device)
    if Bp > B:
        blocks = torch.cat([blocks, blocks.new_zeros((Bp - B, *blocks.shape[1:]))])
        va = torch.cat([va, va.new_zeros((Bp - B, *va.shape[1:]))])
    G = Bp // c

    def chunks(x):
        return x.reshape(G, c, *x.shape[1:]).transpose(0, 1)

    def from_chunks(x):
        return x.transpose(0, 1).reshape(Bp, *x.shape[2:])[:B]

    return chunks(blocks), chunks(va), from_chunks


def parallel_warm_states(
    xs: torch.Tensor,
    vs: torch.Tensor,
    bits_per_sample: int,
    *,
    carry=None,
    warm_on_prev: bool = False,
    stream=encode_stream_blocks_carry,
) -> CodecState:
    """One Jacobi warm pass: each chunk's final chain state.

    ``xs``/``vs`` are chunked, (c, G, *lanes[, nspb]). Encodes every chunk
    with trials=0 from ``carry`` (or the zero state) and returns the state
    after each chunk's last block, leaves (G, *lanes[, 4]): the last of the
    per-block states that ``stream`` emits.
    """
    _, _, states = stream(
        xs, vs, bits_per_sample, 0, carry=carry, warm_on_prev=warm_on_prev, emit_block_states=True
    )
    return states.map(lambda x: x[-1])


def shift_chunk_states(st: CodecState, head: CodecState | None = None) -> CodecState:
    """Chunk g's init <- chunk g-1's final state; chunk 0 <- ``head`` or zeros."""

    def shift(x, h):
        first = torch.zeros_like(x[:1]) if h is None else h[None]
        return torch.cat([first, x[:-1]])

    if head is None:
        return st.map(lambda x: shift(x, None))
    return CodecState(*(shift(x, h) for x, h in zip(st, head)))


def lr_to_ms(pcm: torch.Tensor) -> torch.Tensor:
    """LR -> mid/side with the halving shift and int16 clips, in int32.

    (reference: src/aad_encoder.c:413-428). pcm: (..., 2, N).
    """
    left = pcm[..., 0, :].to(torch.int32)
    right = pcm[..., 1, :].to(torch.int32)
    mid = cs.clip16(cs.asr(left + right, 1))
    side = cs.clip16(cs.asr(left - right, 1))
    return torch.stack([mid, side], dim=-2)
