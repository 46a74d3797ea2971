"""aad_tpu_torch's encode ops and kernel wrappers against aad_tpu, on the CPU.

The plain torch engine (``aad_tpu_torch.ops.encode``) is the CPU encoder
and the oracle of both CUDA encode kernels, so it must equal aad_tpu's scan
engine exactly, and the TPU kernels it replaces where they agree with the
scan engine (run in interpret mode, as aad_tpu's own CPU tests run them).
States cross between the packages through ``CodecState.from_numpy`` /
``numpy()``. Inputs come from numpy with fixed seeds; the codec is integer,
so every comparison is exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aad_tpu.ops import cseman as jcs
from aad_tpu.ops import encode as je
from aad_tpu.ops import transitions as jt

from aad_tpu_torch.ops import cseman as tcs
from aad_tpu_torch.ops import encode as te
from aad_tpu_torch.ops import encode_pass, fused_encode
from aad_tpu_torch.ops import transitions as tt
from aad_tpu_torch.ops.transitions import CodecState

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _jstate(st: CodecState) -> jt.CodecState:
    return jt.CodecState(*(jnp.asarray(a) for a in st.numpy()))


def _assert_state(got: CodecState, want) -> None:
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _assert_tree(got, want) -> None:
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _state(rng, shape, forged=False) -> CodecState:
    """Random lane states. ``forged`` draws what only a forged carry holds:
    weights over all of int32 (the 4-tap sum and the weight update wrap),
    history past int16 and step indices outside [0, 4080]."""
    if forged:
        return CodecState.from_numpy((
            rng.integers(I32_MIN, I32_MAX, (*shape, 4), endpoint=True),
            rng.integers(I32_MIN, I32_MAX, (*shape, 4), endpoint=True),
            rng.choice([0, 4080, 4087, 4095, 5000, -1, -100, I32_MAX, I32_MIN, 777], shape),
        ))
    return CodecState.from_numpy((
        rng.integers(-32768, 32768, (*shape, 4)),
        rng.integers(-20000, 20000, (*shape, 4)),
        rng.integers(0, 4081, shape),
    ))


def _loud(rng, shape) -> np.ndarray:
    """int16 samples at full scale, half of them at the rails: the step size
    climbs to the table's top, where qdiff**2 wraps negative."""
    x = rng.integers(-32768, 32768, shape)
    rails = rng.choice([-32768, 32767], shape)
    return np.where(rng.random(shape) < 0.5, rails, x).astype(np.int16)


# --- C integer semantics -----------------------------------------------------


def test_trunc_div_shl_and_wrapped_square_match():
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.integers(I32_MIN, I32_MAX, 500, endpoint=True), [-7, 7, -1, 0, I32_MIN]]).astype(np.int32)
    b = np.concatenate([rng.integers(1, 40000, 500), [2, 2, 3, 5, 3]]).astype(np.int32)
    np.testing.assert_array_equal(
        tcs.trunc_div(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jcs.trunc_div(jnp.asarray(a), jnp.asarray(b))),
    )
    for n in (0, 1, 2, 17):
        np.testing.assert_array_equal(tcs.shl(torch.from_numpy(a), n).numpy(), np.asarray(jcs.shl(jnp.asarray(a), n)))
    q = np.array([0, 46340, 46341, -46341, 61438, -61438, 32767], dtype=np.int32)
    sq = tcs.wrapped_square(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(sq, np.asarray(jcs.wrapped_square(jnp.asarray(q))))
    assert (sq[2:6] < 0).all()  # the reference's product wraps past 46340


def test_sse_better_matches_limb_compare():
    rng = np.random.default_rng(2)
    vals = np.concatenate([rng.integers(-(2**40), 2**40, 300), [0, 0, -1, 5, 5, -(2**33), 2**33]])
    cand, best = vals, np.roll(vals, 3)
    best[-3:] = [0, -1, 5]

    def limbs(v):
        u = v.astype(np.int64).view(np.uint64)
        return jnp.asarray((u >> 32).astype(np.uint32)), jnp.asarray((u & 0xFFFFFFFF).astype(np.uint32))

    want = np.asarray(jcs.sse_better(limbs(cand), limbs(best)))
    got = tcs.sse_better(torch.from_numpy(cand), torch.from_numpy(best)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


# --- per-sample transitions --------------------------------------------------


@pytest.mark.parametrize("bps", [2, 3, 4])
@pytest.mark.parametrize("forged", [False, True])
def test_encode_sample_matches(bps, forged):
    rng = np.random.default_rng(10 * bps + forged)
    st = _state(rng, (400,), forged)
    sample = _loud(rng, (400,))
    want_st, want_code, want_q = jt.encode_sample(_jstate(st), jnp.asarray(sample.astype(np.int32)), bps)
    got_st, got_code, got_q = tt.encode_sample(st, torch.from_numpy(sample), bps)
    _assert_state(got_st, want_st)
    np.testing.assert_array_equal(got_code.numpy(), np.asarray(want_code))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(
        tt.predict(st.history, st.weight).numpy(), np.asarray(jt.predict(*_jstate(st)[:2]))
    )


def test_seed_history_matches_for_short_blocks():
    rng = np.random.default_rng(3)
    st = _state(rng, (6,))
    first = rng.integers(-32768, 32768, (6, 4)).astype(np.int32)
    valid = np.array([0, 1, 2, 3, 4, 900], dtype=np.int32)
    want = jt.seed_history(_jstate(st), jnp.asarray(first), jnp.asarray(valid))
    _assert_state(tt.seed_history(st, torch.from_numpy(first), torch.from_numpy(valid)), want)


def test_codec_state_round_trips_through_numpy():
    st = _state(np.random.default_rng(4), (3, 2), forged=True)
    back = CodecState.from_numpy(st.numpy())
    _assert_state(back, st.numpy())
    assert all(a.dtype == torch.int32 for a in back)
    zeros = CodecState.zeros((3, 2))
    assert zeros.history.shape == (3, 2, 4) and zeros.step_index.shape == (3, 2)


# --- block-level engine ------------------------------------------------------


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_measure_block_matches_with_ragged_valid(bps):
    rng = np.random.default_rng(20 + bps)
    L, nspb = 64, 29
    st = _state(rng, (L,), forged=bps == 4)
    st.step_index[: L // 2] = 4080  # start at the top step: the squares wrap at once
    block = _loud(rng, (L, nspb))
    valid = rng.integers(0, nspb + 1, L).astype(np.int32)
    valid[:6] = [0, 1, 3, 4, 5, nspb]
    want_st, want_sse = je.measure_block(_jstate(st), jnp.asarray(block.astype(np.int32)), jnp.asarray(valid), bps)
    got_st, got_sse = te.measure_block(st, torch.from_numpy(block), torch.from_numpy(valid), bps)
    _assert_state(got_st, want_st)
    hi, lo = (np.asarray(x).astype(np.uint64) for x in want_sse)
    want = ((hi << np.uint64(32)) | lo).view(np.int64)
    np.testing.assert_array_equal(got_sse.numpy(), want)
    assert (want < 0).any()  # wrapped squares drove some sums negative


@pytest.mark.parametrize("trials,warm,has_prev", [(1, True, True), (2, True, False), (3, True, True), (2, False, False)])
def test_search_best_state_matches(trials, warm, has_prev):
    rng = np.random.default_rng(30 + trials)
    L, nspb = 48, 25
    st = _state(rng, (L,))
    cur, prev = _loud(rng, (L, nspb)), _loud(rng, (L, nspb))
    cur[: L // 2] = (cur[: L // 2] // 64).astype(np.int16)  # quiet lanes: finite, non-negative sums
    valid = rng.integers(0, nspb + 1, L).astype(np.int32)
    want = je.search_best_state(
        _jstate(st), jnp.asarray(cur.astype(np.int32)), jnp.asarray(prev.astype(np.int32)),
        jnp.asarray(has_prev), jnp.asarray(valid), 3, trials, warm_on_prev=warm,
    )
    got = te.search_best_state(
        st, torch.from_numpy(cur), torch.from_numpy(prev), has_prev, torch.from_numpy(valid), 3, trials,
        warm_on_prev=warm,
    )
    _assert_state(got, want)


def test_round_weights_matches_at_the_edges():
    edges = [0, 1, 32767, 32768, -32768, -32769, 65535, 2**30, I32_MAX, I32_MIN, I32_MIN + 1]
    rng = np.random.default_rng(5)
    w = np.concatenate([
        np.array([[e, 0, 0, 0] for e in edges]),
        np.full((1, 4), I32_MIN),  # all four at INT32_MIN: bitlen 32, shift 17
        rng.integers(I32_MIN, I32_MAX, (40, 4), endpoint=True),
    ]).astype(np.int32)
    st = CodecState.from_numpy((np.zeros_like(w), w, np.zeros(len(w))))
    want_st, want_shift = je.round_weights(_jstate(st))
    got_st, got_shift = te.round_weights(st)
    _assert_state(got_st, want_st)
    np.testing.assert_array_equal(got_shift.numpy(), np.asarray(want_shift))
    assert got_shift[len(edges)] == 17


@pytest.mark.parametrize(
    "bps,trials,carry,blocks_before",
    [(4, 2, False, 0), (3, 1, False, 0), (2, 0, False, 0), (4, 2, True, 0), (3, 2, True, 5), (4, 0, True, 1)],
)
def test_encode_stream_blocks_carry_matches(bps, trials, carry, blocks_before):
    rng = np.random.default_rng(40 + bps + trials)
    B, S, C, nspb = 3, 2, 2, 26
    blocks = _loud(rng, (B, S, C, nspb))
    valid = np.array([nspb, nspb, 9], dtype=np.int32)
    c = None
    if carry:
        c = (_state(rng, (S, C), forged=trials == 0), rng.integers(-32768, 32768, (S, C, nspb)).astype(np.int16))
    jc = None if c is None else (_jstate(c[0]), jnp.asarray(c[1].astype(np.int32)))
    tc = None if c is None else (c[0], torch.from_numpy(c[1]))
    wh, wc, (ws, wp) = je.encode_stream_blocks_carry(
        jnp.asarray(blocks.astype(np.int32)), jnp.asarray(valid), bps, trials,
        carry=jc, blocks_before=blocks_before, engine="scan",
    )
    gh, gc, (gs, gp) = te.encode_stream_blocks_carry(
        torch.from_numpy(blocks), torch.from_numpy(valid), bps, trials, carry=tc, blocks_before=blocks_before,
    )
    _assert_tree(gh, wh)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert gc.dtype == torch.uint8 and gc.shape == (B, S, C, nspb - 4)
    _assert_state(gs, ws)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def test_carry_chains_two_halves_into_the_one_shot_encode():
    rng = np.random.default_rng(6)
    B, C, nspb = 6, 2, 24
    blocks = torch.from_numpy(_loud(rng, (B, C, nspb)) // 4)
    valid = torch.full((B,), nspb, dtype=torch.int32)
    h_all, c_all, (s_all, _) = te.encode_stream_blocks_carry(blocks, valid, 4, 2)
    h1, c1, carry = te.encode_stream_blocks_carry(blocks[:2], valid[:2], 4, 2)
    h2, c2, (s2, _) = te.encode_stream_blocks_carry(blocks[2:], valid[2:], 4, 2, carry=carry, blocks_before=2)
    for a, x, y in zip(h_all, h1, h2):
        assert torch.equal(a, torch.cat([x, y]))
    assert torch.equal(c_all, torch.cat([c1, c2]))
    _assert_state(s2, s_all.numpy())
    _, _, states = te.encode_stream_blocks_carry(blocks, valid, 4, 2, emit_block_states=True)
    _assert_state(states.map(lambda x: x[-1]), s_all.numpy())
    assert te.encode_stream_blocks_carry(blocks, valid, 4, 2, need_carry=False)[2] is None


@pytest.mark.parametrize("chunk_blocks,warm_passes,trials", [(1, 0, 2), (3, 0, 2), (2, 1, 1), (1, 2, 2), (4, 2, 0)])
def test_encode_blocks_parallel_matches(chunk_blocks, warm_passes, trials):
    rng = np.random.default_rng(50 + chunk_blocks + warm_passes)
    B, C, nspb = 7, 2, 24
    blocks = _loud(rng, (B, C, nspb)) // 8
    valid = np.full(B, nspb, dtype=np.int32)
    valid[-1] = 11
    wh, wk = je.encode_blocks_parallel(
        jnp.asarray(blocks.astype(np.int32)), jnp.asarray(valid), 4, trials, engine="scan",
        chunk_blocks=chunk_blocks, warm_passes=warm_passes,
    )
    gh, gc = te.encode_blocks_parallel(
        torch.from_numpy(blocks), torch.from_numpy(valid), 4, trials,
        chunk_blocks=chunk_blocks, warm_passes=warm_passes,
    )
    _assert_tree(gh, wh)
    # aad_tpu returns its codes packed 8 to a u32 word, LSB first
    words = np.asarray(wk).astype(np.uint64)
    want = np.stack([(words >> np.uint64(4 * k)) & np.uint64(0xF) for k in range(8)], -1)
    want = want.reshape(*words.shape[:-1], -1)[..., : nspb - 4]
    np.testing.assert_array_equal(gc.numpy(), want)


def test_shift_chunk_states_and_lr_to_ms_match():
    rng = np.random.default_rng(7)
    st = _state(rng, (5, 3))
    head = _state(rng, (3,))
    _assert_state(te.shift_chunk_states(st), je.shift_chunk_states(_jstate(st)))
    _assert_state(te.shift_chunk_states(st, head), je.shift_chunk_states(_jstate(st), _jstate(head)))
    edge = np.array([-32768, -32767, -1, 0, 1, 32766, 32767], dtype=np.int32)
    left, right = np.meshgrid(edge, edge)
    pcm = np.stack([left.ravel(), right.ravel()])[None]
    np.testing.assert_array_equal(
        te.lr_to_ms(torch.from_numpy(pcm.astype(np.int16))).numpy(), np.asarray(je.lr_to_ms(jnp.asarray(pcm)))
    )


# --- the TPU kernels the CUDA kernels replace (interpret mode) ---------------


@pytest.mark.parametrize("bps,trials,warm", [(4, 2, True), (2, 1, True), (3, 2, False)])
def test_plain_matches_fused_pallas_kernel(bps, trials, warm):
    """The plain engine == pallas_encode_fused.encode_stream_fused, one tile."""
    from aad_tpu.ops.pallas_encode_fused import encode_stream_fused

    rng = np.random.default_rng(60 + bps)
    B, L, nspb = 2, 6, 28
    blocks = _loud(rng, (B, L, nspb)) // 2
    valid = np.array([nspb, 13], dtype=np.int32)
    wh, wc, _ = encode_stream_fused(
        jnp.asarray(blocks.astype(np.int32)), jnp.asarray(valid), bps, trials, warm_on_prev=warm,
    )
    gh, gc, _ = fused_encode.encode_stream(
        torch.from_numpy(blocks), torch.from_numpy(valid), bps, trials, warm_on_prev=warm,
    )
    _assert_tree(gh, wh)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("trials,stack,carried", [
    (1, True, False), (1, False, True), (2, True, True), (2, False, False), (3, True, False), (3, False, True),
])
def test_plain_matches_pass_stacked_fused_pallas_kernel(monkeypatch, trials, stack, carried):
    """The semantics of aad_encode_stream's paired trial schedule are those
    of pass_stack: the plain engine == encode_stream_fused with the
    pass-stacked trial search on and off, over three blocks (a stream head,
    or a carry) with a ragged last one. A tone under noise, so that later
    trials win on some lanes. The stack setting is read when the kernel is
    traced, so each setting has a lane count of its own."""
    from aad_tpu.ops import pallas_encode_fused as pef

    monkeypatch.setenv("AAD_TPU_ENCODE_STACK", "1" if stack else "0")
    rng = np.random.default_rng(80 + trials)
    B, L, nspb = 3, 6 if stack else 7, 36
    assert pef._use_pass_stack(trials, True, False, False, 1, 1, L) == stack
    t = np.arange(B * nspb)
    tone = 6000 * np.sin(t[None, :] / rng.uniform(3, 9, (L, 1)))
    blocks = (tone + rng.normal(0, 400, tone.shape)).astype(np.int16).reshape(L, B, nspb).transpose(1, 0, 2)
    blocks = np.ascontiguousarray(blocks)
    valid = np.array([nspb, nspb, 19], dtype=np.int32)
    kw, jkw = {}, {}
    if carried:
        st = _state(rng, (L,))
        prev = (rng.normal(0, 3000, (L, nspb))).astype(np.int16)
        kw = dict(carry=(st, torch.from_numpy(prev)), blocks_before=trials)
        jkw = dict(carry=(_jstate(st), jnp.asarray(prev.astype(np.int32))), blocks_before=trials)
    wh, wc, _ = pef.encode_stream_fused(jnp.asarray(blocks.astype(np.int32)), jnp.asarray(valid), 4, trials, **jkw)
    gh, gc, _ = fused_encode.encode_stream(torch.from_numpy(blocks), torch.from_numpy(valid), 4, trials, **kw)
    _assert_tree(gh, wh)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("emit", [False, True])
def test_plain_pass_matches_per_pass_pallas_kernel(emit):
    """encode_pass's plain version == pallas_encode.encode_scan_tiles, one tile."""
    from aad_tpu.ops.pallas_encode import encode_scan_tiles, to_timemajor

    rng = np.random.default_rng(70 + emit)
    L, T = 40, 24
    samples = _loud(rng, (L, T))
    st = _state(rng, (L,))
    valid = rng.integers(0, T + 5, L).astype(np.int32)
    codes, (idx, h, w), (hi, lo) = encode_scan_tiles(
        to_timemajor(jnp.asarray(samples.astype(np.int32))), jnp.asarray(st.step_index.numpy()),
        jnp.asarray(st.history.numpy()), jnp.asarray(st.weight.numpy()), jnp.asarray(valid),
        bits_per_sample=4, emit_codes=emit,
    )
    got_st, got_codes, got_sse = encode_pass.encode_pass(
        torch.from_numpy(np.ascontiguousarray(samples.T)), st, torch.from_numpy(valid), 4, emit_codes=emit,
    )
    _assert_state(got_st, (h, w, idx))
    sse = ((np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)).view(np.int64)
    np.testing.assert_array_equal(got_sse.numpy(), sse)
    if emit:
        np.testing.assert_array_equal(got_codes.numpy().T, np.asarray(codes)[:, :T])
    else:
        assert got_codes is None


def test_jax_engines_disagree_on_forged_carries():
    """Pinned: aad_tpu's scan and fused engines differ on two forged
    carries, and the port follows the scan engine (the oracle of
    aad_tpu's own interpret tests): all four weights at INT32_MIN round
    with shift 17 (scan) or 0 (fused), and a carry step index of 5000 or
    more reads the fused kernel's f32 step formula past the table."""
    from aad_tpu.ops.pallas_encode_fused import encode_stream_fused

    rng = np.random.default_rng(8)
    L, nspb = 4, 20
    blocks = rng.integers(-3000, 3000, (2, L, nspb)).astype(np.int16)
    weight = rng.integers(-20000, 20000, (L, 4)).astype(np.int32)
    weight[0] = I32_MIN
    st = CodecState.from_numpy((np.zeros((L, 4)), weight, [100, 5000, 100000, 4080]))
    carry = (st, torch.zeros((L, nspb), dtype=torch.int16))
    jcarry = (_jstate(st), jnp.zeros((L, nspb), jnp.int32))
    args = (jnp.asarray(blocks.astype(np.int32)), jnp.asarray([nspb, nspb], jnp.int32), 4, 0)
    sh, sc, _ = je.encode_stream_blocks_carry(*args, carry=jcarry, engine="scan")
    fh, fc, _ = encode_stream_fused(*args, carry=jcarry)
    gh, gc, _ = te.encode_stream_blocks_carry(torch.from_numpy(blocks), torch.tensor([nspb, nspb]), 4, 0, carry=carry)
    _assert_tree(gh, sh)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(sc))
    assert np.asarray(sh.shift)[0, 0] == 17 and np.asarray(fh.shift)[0, 0] == 0
    differs = (np.asarray(sc) != np.asarray(fc)).any(axis=(0, 2))
    np.testing.assert_array_equal(differs, [False, True, True, False])


# --- kernel 3's packed codes ---------------------------------------------------


@pytest.mark.parametrize("nch,bps,ms,trials", [
    (1, 2, False, 2), (2, 2, False, 1), (1, 3, False, 2), (2, 3, True, 2), (1, 4, False, 0), (2, 4, True, 2),
])
def test_packed_plain_version_matches_scan_bytes(nch, bps, ms, trials):
    """encode_stream(..., pack=geo) on the CPU, kernel 3's plain version with
    its codes packed as the wire holds them, gives the data regions of
    aad_tpu.encode(engine="scan")'s blocks: with the block headers, its
    payload byte for byte. A ragged last block (at 3 bits a last unit that
    holds padding codes)."""
    import aad_tpu

    import aad_tpu_torch
    from aad_tpu_torch.codec.encoder import _block_bytes, _pad_to_blocks, payload_size

    cfg = aad_tpu_torch.EncodeConfig(nch, 16000, bps, 128, int(ms), trials)
    geo = cfg.geometry()
    n = 3 * geo.num_samples_per_block - 5
    pcm = np.random.default_rng(40 + 10 * nch + bps).integers(-20000, 20000, (nch, n)).astype(np.int16)
    want = aad_tpu.encode(pcm, aad_tpu.EncodeConfig(nch, 16000, bps, 128, int(ms), trials), engine="scan")
    blocks, valid = _pad_to_blocks(torch.from_numpy(pcm), geo, 0, 3)
    if ms:
        blocks = te.lr_to_ms(blocks).to(torch.int16)
    before = dict(fused_encode.launches)
    headers, data, carry = fused_encode.encode_stream(blocks, valid, bps, trials, need_carry=False, pack=geo)
    assert fused_encode.launches == before and carry is None
    assert data.dtype == torch.uint8 and data.shape == (3, geo.data_bytes)
    payload = _block_bytes(headers, data, geo).reshape(-1)[: payload_size(geo, n)]
    assert payload.numpy().tobytes() == want[aad_tpu_torch.FILE_HEADER_SIZE:]


# --- the wrappers on the CPU -------------------------------------------------


def test_cpu_wrappers_run_the_plain_versions_without_launching():
    rng = np.random.default_rng(9)
    B, L, nspb = 2, 5, 20
    blocks = torch.from_numpy(_loud(rng, (B, L, nspb)))
    valid = torch.tensor([nspb, 7], dtype=torch.int32)
    before = (dict(fused_encode.launches), dict(encode_pass.launches))
    got = fused_encode.encode_stream(blocks, valid, 4, 2)
    want = te.encode_stream_blocks_carry(blocks, valid, 4, 2)
    _assert_tree(got[0], want[0])
    assert torch.equal(got[1], want[1])
    _assert_state(got[2][0], want[2][0].numpy())
    st = _state(rng, (L,))
    samples = torch.from_numpy(_loud(rng, (nspb, L)))
    full = torch.full((L,), nspb + 4, dtype=torch.int32)
    final, codes, sse = encode_pass.encode_pass(samples, st, full, 3, emit_codes=True)
    want_st, want_codes, want_sse = te._encode_span(st, samples.t(), nspb, 3)
    _assert_state(final, want_st.numpy())
    assert torch.equal(codes, want_codes.t()) and torch.equal(sse, want_sse)
    assert (dict(fused_encode.launches), dict(encode_pass.launches)) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    blocks = torch.zeros((2, 3, 20), dtype=torch.int16)
    valid = torch.full((2,), 20, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_encode.encode_stream(blocks.to(torch.int32), valid, 4, 2)
    with pytest.raises(ValueError):
        fused_encode.encode_stream(blocks, valid, 5, 2)
    with pytest.raises(ValueError):
        fused_encode.encode_stream(blocks.to("meta"), valid, 4, 2)
    from aad_tpu_torch.format.geometry import compute_block_geometry

    stereo = compute_block_geometry(36 + 8, 2, 4)  # 20 samples a block, 2 channels
    with pytest.raises(ValueError):
        fused_encode.encode_stream(blocks, valid, 4, 2, pack=stereo)  # 3 channels
    with pytest.raises(ValueError):
        fused_encode.encode_stream(blocks[:, :2], valid, 2, 2, pack=stereo)  # 2 bits
    st = CodecState.zeros((3,))
    samples = torch.zeros((16, 3), dtype=torch.int16)
    with pytest.raises(ValueError):
        encode_pass.encode_pass(samples, st, valid, 4)  # valid is (2,), not (3,)
    with pytest.raises(ValueError):
        encode_pass.encode_pass(samples.to(torch.int32), st, torch.zeros(3, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        encode_pass.encode_pass(samples, st._replace(weight=st.weight.to(torch.int64)), torch.zeros(3, dtype=torch.int32), 4)

