"""The two-phase ("pallas") decode engine of aad_tpu_torch against aad_tpu, on the CPU.

Phase A, the log-depth step-index scan (``step_index_prefix``,
``compute_qdiffs_prefix``), is held against ``aad_tpu``'s associative scan
and against the port's own time loop; phase B's plain version
(``ops.lms.lms_lanes_reference``, the CPU side of the ``aad_lms_lanes``
kernel) against ``aad_tpu.ops.pallas_lms.lms_pallas`` run in interpret mode,
with forged weights and histories whose sums wrap; and the whole engine,
``decode(..., device="cpu", engine="pallas")``, against ``aad_tpu``'s pallas
engine. The codec is integer throughout: every comparison is exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aad_tpu
from aad_tpu.ops import transitions as jax_transitions
from aad_tpu.ops.decode import compute_qdiffs as jax_compute_qdiffs
from aad_tpu.ops.pallas_lms import lms_pallas

import aad_tpu_torch
from aad_tpu_torch.ops import fused_decode, lms
from aad_tpu_torch.ops.decode import compute_qdiffs, compute_qdiffs_prefix
from aad_tpu_torch.ops.transitions import step_index_prefix

from test_torch_decoder import random_code_stream

PHASE_A = [(bps, init, T) for bps in (2, 3, 4) for init in (0, 4080) for T in (1, 988)]


def _codes(bps, init, T, L=6):
    """(L, T) codes from a seed and (L,) initial indices: ``init`` on all lanes
    but the last, which draws its own."""
    rng = np.random.default_rng(bps * 1000 + T + init)
    codes = rng.integers(0, 2**bps, (L, T), dtype=np.uint8)
    init_index = np.full(L, init, np.int32)
    init_index[-1] = rng.integers(0, 4081)
    return codes, init_index


@pytest.mark.parametrize("bps,init,T", PHASE_A)
def test_step_index_prefix_matches_aad_tpu(bps, init, T):
    codes, init_index = _codes(bps, init, T)
    want = np.asarray(jax_transitions.step_index_prefix(jnp.asarray(codes), jnp.asarray(init_index), bps))
    got = step_index_prefix(torch.from_numpy(codes), torch.from_numpy(init_index), bps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # time-major, as the decoder runs it
    got_tm = step_index_prefix(torch.from_numpy(codes.T.copy()), torch.from_numpy(init_index), bps, dim=0)
    np.testing.assert_array_equal(got_tm.numpy().T, want)


@pytest.mark.parametrize("bps,init,T", PHASE_A)
def test_compute_qdiffs_prefix_matches_aad_tpu_and_the_loop(bps, init, T):
    codes, init_index = _codes(bps, init, T)
    want = np.asarray(jax_compute_qdiffs(jnp.asarray(codes), jnp.asarray(init_index), bps))
    codes_t, init_t = torch.from_numpy(codes), torch.from_numpy(init_index)
    got = compute_qdiffs_prefix(codes_t, init_t, bps)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(compute_qdiffs(codes_t, init_t, bps).numpy(), want)
    got_tm = compute_qdiffs_prefix(codes_t.t().contiguous(), init_t, bps, dim=0)
    np.testing.assert_array_equal(got_tm.t().numpy(), want)


def _lms_inputs(bps, L, T, seed):
    """Time-major qdiffs from random codes (half the lanes start at the top
    step, where |qdiff| reaches about 61k), int16 histories on half the lanes
    and int32-wide ones on the rest, weights over all of int32 on a quarter of
    the lanes: the 4-tap sums and the weight-update products wrap. A quarter
    of the lanes draw both as the benchmark stream does."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2**bps, (T, L), dtype=np.uint8)
    init_index = rng.integers(0, 4081, L).astype(np.int32)
    init_index[: L // 2] = 4080
    qdiffs = compute_qdiffs_prefix(torch.from_numpy(codes), torch.from_numpy(init_index), bps, dim=0)
    history = rng.integers(-(2**31), 2**31 - 1, (L, 4), endpoint=True).astype(np.int32)
    history[::2] = rng.integers(-32768, 32768, history[::2].shape)
    weight = rng.integers(-(2**31), 2**31 - 1, (L, 4), endpoint=True).astype(np.int32)
    weight[1::2] = rng.integers(-20000, 20000, weight[1::2].shape)
    weight[::4] = rng.integers(-20000, 20000, weight[::4].shape)  # as the benchmark draws them
    sums = (history.astype(np.int64) * weight).sum(-1) + 2**14
    assert (np.abs(sums) >= 2**31).any()  # the int32 sum wraps on some lanes
    return qdiffs, torch.from_numpy(history), torch.from_numpy(weight)


@pytest.mark.parametrize("bps,L,T", [(2, 16, 90), (3, 37, 300), (4, 40, 1), (4, 24, 257)])
def test_lms_reference_matches_lms_pallas(bps, L, T):
    """lms_lanes_reference == aad_tpu's lms_pallas (interpret mode), and
    lms_lanes on a CPU tensor runs it without launching anything."""
    qdiffs_tm, history, weight = _lms_inputs(bps, L, T, seed=bps * 7 + L)
    want = np.asarray(lms_pallas(jnp.asarray(qdiffs_tm.t().numpy()), jnp.asarray(history.numpy()),
                                 jnp.asarray(weight.numpy())))
    got = lms.lms_lanes_reference(qdiffs_tm, history, weight)
    assert got.dtype == torch.int16 and got.shape == (L, T + 4)
    np.testing.assert_array_equal(got[:, 4:].numpy(), want)
    np.testing.assert_array_equal(got[:, :4].numpy(), history.numpy()[:, ::-1].astype(np.int16))
    before = dict(lms.launches)
    assert torch.equal(lms.lms_lanes(qdiffs_tm, history, weight), got)
    assert lms.launches == before


def test_lms_lanes_rejects_bad_arguments():
    qdiffs_tm, history, weight = _lms_inputs(4, 8, 5, seed=1)
    for args, what in (
        ((qdiffs_tm.to(torch.int16), history, weight), "int32"),
        ((qdiffs_tm[0], history, weight), r"\(T, L\)"),
        ((qdiffs_tm, history[:, :3], weight), "history must be"),
        ((qdiffs_tm, history, weight[:7]), "weight must be"),
        ((qdiffs_tm, history.to(torch.int64), weight), "history must be int32"),
        ((qdiffs_tm.to("meta"), history.to("meta"), weight.to("meta")), "no kernel for device meta"),
    ):
        with pytest.raises(ValueError, match=what):
            lms.lms_lanes(*args)


@pytest.mark.parametrize("nch,bps,ms", [(2, 4, True), (1, 3, False), (2, 2, False)])
def test_pallas_engine_decode_matches_aad_tpu(nch, bps, ms):
    """decode(..., device="cpu", engine="pallas") == aad_tpu's pallas engine
    (phase A by associative scan, phase B by lms_pallas in interpret mode),
    on a few-block stream with a ragged tail and wire indices up to 4095."""
    data = random_code_stream(nch * 10 + bps, nch, bps, ms, 128, 700)
    header = aad_tpu.decode_header(data)
    payload = np.frombuffer(data, np.uint8)[aad_tpu.FILE_HEADER_SIZE :]
    want = np.asarray(aad_tpu.Decoder.from_header(header, engine="pallas").decode_payload_ondevice(payload))
    before = {**fused_decode.launches, **lms.launches}
    got_header, got = aad_tpu_torch.decode(data, device="cpu", engine="pallas")
    assert vars(got_header) == vars(header)
    np.testing.assert_array_equal(got, want)
    _, fused = aad_tpu_torch.decode(data, device="cpu", engine="fused")
    np.testing.assert_array_equal(fused, got)
    dec = aad_tpu_torch.Decoder.from_header(aad_tpu_torch.decode_header(data), device="cpu", engine="pallas")
    assert dec.engine == "pallas"
    np.testing.assert_array_equal(dec.decode_payload_ondevice(payload.copy()).numpy(), want)
    assert {**fused_decode.launches, **lms.launches} == before  # the CPU launches nothing


@pytest.mark.parametrize("engine", ["scan", "native", "Pallas", ""])
def test_unknown_engine_raises(engine):
    """An engine the port lacks raises. ``"native"``, the native host
    engine, is an engine of the one-shot entry points (tests/test_torch_native.py)
    but not of the device ``Decoder``, where it raises like the others."""
    data = random_code_stream(3, 1, 4, False, 128, 300)
    header = aad_tpu_torch.decode_header(data)
    calls = [lambda: aad_tpu_torch.Decoder.from_header(header, device="cpu", engine=engine)]
    if engine != "native":
        calls += [
            lambda: aad_tpu_torch.decode(data, device="cpu", engine=engine),
            lambda: aad_tpu_torch.decode_batch([data], device="cpu", engine=engine),
            lambda: aad_tpu_torch.StreamingDecoder(device="cpu", engine=engine),
        ]
    for call in calls:
        with pytest.raises(aad_tpu_torch.InvalidArgumentError, match="'auto', 'fused', 'pallas'"):
            call()
    assert aad_tpu_torch.Decoder.from_header(header, device="cpu").engine == "fused"
