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

import math

import torch

from ..constants import FILTER_ORDER
from ..format.geometry import BlockGeometry
from ..utils.trace import span
from . import _build, bitpack
from .encode import BlockHeaderFields, _lane_valid, encode_stream_blocks_carry
from .encode_pass import encode_pass
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
