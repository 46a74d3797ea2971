"""Multi-device scaling: sharded batch decode and encode over a device mesh.

The port of ``aad_tpu.parallel.sharded``. The codec's parallel structure
(SURVEY.md §2.3): block x channel decode tasks are independent (every block
header carries the complete state, reference: src/aad_decoder.c:363-380),
and encode chains state per stream but is independent across streams. So
the mesh is used for data and sequence parallelism only:

* **decode** (:func:`decode_blocks_sharded`): the flattened lane axis shards
  over the whole mesh; each shard decodes its lanes on its device, with no
  collective;
* **encode** (:func:`encode_streams_sharded`): streams shard over the mesh;
  each shard encodes its streams' blocks in sequence, streams x channels on
  kernel 3's lanes. The one cross-device step is the optional quality
  statistic, two scalars a shard summed on the mesh's first device;
* **sequence-parallel encode** (:func:`encode_blocks_parallel_sharded`): in
  the block-parallel mode (``ops.encode.encode_blocks_parallel``) one
  stream's block axis shards over the mesh, on chunk boundaries; between
  warm passes, each shard's last chunk state goes to the next shard.

The mesh is the devices of one process: several cards, or several shards on
one device (``cuda:0`` x 4, or ``cpu`` x 8 for the tests), the counterpart of
JAX's single-controller mesh. Shard k is ``mesh.devices.flat[k]`` (row-major
over (dp, sp), as in JAX) and holds the k-th contiguous piece of the sharded
axis. One Python loop queues every shard's work on its device's current
stream and waits for nothing, so shards on separate cards run at the same
time, and shards on one card run one after another.

A result stays where it was computed, as a sharded JAX array does: each
sharded output is a list with one tensor a shard, in mesh order, each on
its shard's device (:data:`Shards`). :func:`gather` brings one to a device.

Not carried over from ``aad_tpu``:

* ``shard_map`` and ``jax.jit``: the loop over the shards above, eager;
* padding to even shards, which ``shard_map`` needs: a shard takes the k-th
  piece of ceil(n / size) items, as JAX places them, so the last pieces may
  be short or empty, and there is no padding to trim;
* the packed u32 code words of the sequence-parallel encode: its contract
  here is the codes-level one of ``encode_blocks_parallel``, one code a
  byte, which kernel 3 writes as such (the codec's entry points take the
  codes packed as the wire holds them, ``codec.encoder``);
* its ``engine`` knob (``"scan"``/``"pallas"``): a CUDA shard launches
  kernel 3 and a CPU shard runs its plain version, as every encode of the
  port does;
* ``ppermute`` and ``psum``: the ring handoff is a copy of one chunk state
  to the next shard's device, and the statistic's sum two scalars a shard
  copied to the first device.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..codec.device import resolve_device
from ..codec.result import InvalidArgumentError, InvalidFormatError
from ..constants import INT16_MAX, INT16_MIN
from ..ops.decode import decode_blocks
from ..ops.encode import BlockHeaderFields, parallel_warm_states, shift_chunk_states, to_chunks
from ..ops.fused_encode import encode_stream
from ..utils.trace import span

# One tensor a shard, in mesh order, each on its shard's device.
Shards = list


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (dp, sp) grid of torch devices in one process.

    ``devices`` is a (dp, sp) object array of ``torch.device``; repeats are
    allowed (several shards on one device).
    """

    devices: np.ndarray
    axis_names: tuple[str, str] = ("dp", "sp")

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def shard_devices(self) -> list[torch.device]:
        """The device of each shard, in shard order."""
        return list(self.devices.flat)


def make_mesh(
    n_devices: int | None = None,
    axis_names=("dp", "sp"),
    shape: tuple[int, int] | None = None,
    devices=None,
) -> Mesh:
    """Build a (dp, sp) mesh over the first ``n_devices`` devices.

    ``devices`` defaults to the CUDA cards (``cuda:0 ... cuda:n-1``); with
    none, this raises ValueError and builds no CPU mesh. An explicit list,
    repeats allowed, places several shards on one device, e.g.
    ``[torch.device("cpu")] * 8`` or ``["cuda:0"] * 4``. dp spans streams,
    sp the block axis; by default sp is the larger of 2 and 4 that divides
    n with n // sp >= sp (else 1), as ``aad_tpu``'s factorisation; pass
    ``shape=(dp, sp)`` to pin it.
    """
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devs:
            raise ValueError("make_mesh: no CUDA device; pass devices= for a mesh of CPU shards")
    else:
        devs = [resolve_device(d) for d in devices]
    if shape is not None:
        dp, sp = shape
        n = n_devices or dp * sp
        if dp * sp != n:
            raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    else:
        n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(f"make_mesh: requested {n} devices but only {len(devs)} available")
    if shape is None:
        sp = 1
        for cand in (2, 4):
            if n % cand == 0 and n // cand >= cand:
                sp = cand
        dp = n // sp
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return Mesh(grid.reshape(dp, sp), tuple(axis_names))


def _pieces(n: int, size: int) -> list[tuple[int, int]]:
    """Shard k's [start, stop) of n items: the k-th piece of ceil(n / size),
    where ``shard_map`` places an axis padded to a multiple of ``size``."""
    per = -(-n // size)
    return [(min(k * per, n), min((k + 1) * per, n)) for k in range(size)]


def _scatter(tensors, mesh: Mesh, pieces) -> list[tuple[torch.Tensor, ...]]:
    """Shard k's piece ``pieces[k]`` of every tensor, on its device. Every
    copy is queued before any shard's work: a copy between two cards runs
    on the source card's stream, behind what that card has queued."""
    with span("aad.sharded.scatter"):
        return [tuple(t[a:b].to(device) for t in tensors) for device, (a, b) in zip(mesh.shard_devices, pieces)]


def _on(device: torch.device):
    """``device`` current inside the block, the caller's restored after (the
    kernels' entry points set the device they launch on)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _int16(blocks: torch.Tensor) -> torch.Tensor:
    """int16-valued integer samples as int16; a sample outside the int16
    range raises InvalidFormatError, as the encoder does."""
    if blocks.dtype.is_floating_point or blocks.dtype.is_complex or blocks.dtype == torch.bool:
        raise InvalidArgumentError(f"encoder blocks must be integers, got {blocks.dtype}")
    if blocks.dtype == torch.int16:
        return blocks
    if blocks.numel() and (int(blocks.min()) < INT16_MIN or int(blocks.max()) > INT16_MAX):
        raise InvalidFormatError("encoder input exceeds int16 range")
    return blocks.to(torch.int16)


def gather(result, device):
    """A sharded result on one device: each :data:`Shards` leaf concatenated
    along its sharded axis, through tuples (named ones keep their type);
    another tensor is moved, None stays."""
    if isinstance(result, list):
        return torch.cat([shard.to(device) for shard in result])
    if isinstance(result, tuple):
        leaves = [gather(x, device) for x in result]
        return type(result)(*leaves) if hasattr(result, "_fields") else tuple(leaves)
    return None if result is None else result.to(device)


def decode_blocks_sharded(
    codes: torch.Tensor,
    step_index: torch.Tensor,
    weight: torch.Tensor,
    history: torch.Tensor,
    *,
    bits_per_sample: int,
    mesh: Mesh,
    engine: str = "auto",
) -> Shards:
    """Decode a flattened lane batch with the lanes sharded over the whole mesh.

    Args:
      codes: (L, T); step_index: (L,); weight/history: (L, 4).
      engine: as ``ops.decode.decode_blocks``: ``"auto"``/``"fused"``
        (kernel 1) or ``"pallas"`` (phase A, then kernel 5).
    Returns:
      (L, T + 4) int32 samples as :data:`Shards`.
    """
    with span("aad.decode_blocks_sharded"):
        pieces = _scatter((codes, step_index, weight, history), mesh, _pieces(codes.shape[0], mesh.size))
        out = []
        for device, args in zip(mesh.shard_devices, pieces):
            with _on(device):
                out.append(decode_blocks(*args, bits_per_sample=bits_per_sample, engine=engine))
        return out


def encode_streams_sharded(
    blocks: torch.Tensor,
    valid: torch.Tensor,
    *,
    bits_per_sample: int,
    num_trials: int,
    mesh: Mesh,
    stat: bool = False,
):
    """Encode a batch of independent streams, sharded over every mesh axis.

    Each shard encodes its streams in one launch of kernel 3 (streams x
    channels on its lanes), as ``encode_batch`` encodes a pile.

    Args:
      blocks: (S, B, C, nspb) zero-padded int16-valued blocks (mid/side
        already applied); valid: (S, B) valid samples a block.
      stat: also return the mesh-global reconstruction RMSE, normalised to
        full scale (the reference CLI's -c statistic, reference:
        src/main.c:441-503): each shard decodes its codes back with its
        headers, sums its squared error in float32 over the live samples
        and counts them; the sums add up on the mesh's first device. It
        costs a decode of every block, so it is off by default.
    Returns:
      (headers with :data:`Shards` leaves (S, B, C[, 4]), codes (S, B, C,
      nspb - 4) uint8 as Shards, the RMSE as a float32 scalar on the first
      device or None).
    """
    with span("aad.encode_streams_sharded"):
        blocks = _int16(blocks)
        nspb = blocks.shape[-1]
        pieces = _scatter((blocks, valid.to(torch.int32)), mesh, _pieces(blocks.shape[0], mesh.size))
        headers, codes, sums, counts = [], [], [], []
        for device, (bl, va) in zip(mesh.shard_devices, pieces):
            with _on(device):
                h, c, _ = encode_stream(bl.transpose(0, 1), va.t()[..., None], bits_per_sample, num_trials,
                                        need_carry=False)
                h = BlockHeaderFields(*(f.transpose(0, 1) for f in h))
                c = c.transpose(0, 1)
                headers.append(h)
                codes.append(c)
                if stat:
                    recon = decode_blocks(c, h.step_index, h.weight, h.history, bits_per_sample=bits_per_sample)
                    err = (recon - bl).to(torch.float32) * (1.0 / 32768.0)
                    live = (torch.arange(nspb, device=device) < va[..., None, None]).expand(err.shape)
                    sums.append(torch.where(live, err * err, 0.0).sum())
                    counts.append(live.sum())
        rmse = None
        if stat:
            first = mesh.shard_devices[0]
            gsse = torch.stack([s.to(first) for s in sums]).sum()
            gcnt = torch.stack([n.to(first) for n in counts]).sum()
            rmse = torch.sqrt(gsse / torch.clamp(gcnt, min=1).to(torch.float32))
        return BlockHeaderFields(*(list(f) for f in zip(*headers))), codes, rmse


def encode_blocks_parallel_sharded(
    blocks: torch.Tensor,
    valid: torch.Tensor,
    *,
    bits_per_sample: int,
    num_trials: int,
    mesh: Mesh,
    engine: str = "auto",
    chunk_blocks: int = 1,
    warm_passes: int = 0,
):
    """Sequence-parallel encode of ONE stream over the whole mesh.

    The block-parallel mode of ``ops.encode.encode_blocks_parallel`` (the
    same ``chunk_blocks`` and ``warm_passes``) with the block axis sharded
    on chunk boundaries: shard k takes the k-th piece of the chunks. Each
    shard runs the chunked core on its piece; between warm passes, shard
    k's last chunk state goes to shard k + 1's device and becomes the
    initial state of its first chunk (the ring handoff; shard 0 starts from
    zeros). So the output equals the unsharded call's for every
    (``chunk_blocks``, ``warm_passes``).

    Args:
      blocks: (B, C, nspb) zero-padded int16-valued blocks (mid/side
        already applied); valid: (B,) valid samples a block.
      engine: only ``"auto"``: a CUDA shard launches kernel 3, a CPU shard
        runs its plain version.
    Returns:
      (headers with :data:`Shards` leaves (B, C[, 4]), codes (B, C,
      nspb - 4) uint8 as Shards).
    """
    with span("aad.encode_blocks_parallel_sharded"):
        if engine != "auto":
            raise InvalidArgumentError(f"encode_blocks_parallel_sharded: engine {engine!r}; only 'auto' is ported")
        blocks = _int16(blocks)
        c = max(int(chunk_blocks), 1)
        B = blocks.shape[0]
        blocks_of = [(g0 * c, min(g1 * c, B)) for g0, g1 in _pieces(-(-B // c), mesh.size)]
        shards = []  # (device, chunked blocks, chunked valid, from_chunks)
        for device, (bl, va) in zip(mesh.shard_devices, _scatter((blocks, valid.to(torch.int32)), mesh, blocks_of)):
            with _on(device):
                shards.append((device, *to_chunks(bl, va, c)))
        warm = c > 1  # the chunk-internal previous-block warm-up
        carries = [None] * len(shards)
        for _ in range(warm_passes):
            states = []
            for (device, xs, vs, _), carry in zip(shards, carries):
                with _on(device):
                    states.append(parallel_warm_states(xs, vs, bits_per_sample, carry=carry, warm_on_prev=warm,
                                                       stream=encode_stream))
            head = None  # the previous shard's last chunk state; zeros for shard 0
            for k, ((device, xs, _, _), st) in enumerate(zip(shards, states)):
                if xs.shape[1] == 0:  # an empty shard: no chunk to seed
                    continue
                with _on(device):
                    carries[k] = (shift_chunk_states(st, None if head is None else head.to(device)),
                                  torch.zeros_like(xs[0]))
                head = st.map(lambda x: x[-1])
        headers, codes = [], []
        for (device, xs, vs, from_chunks), carry in zip(shards, carries):
            with _on(device):
                h, k, _ = encode_stream(xs, vs, bits_per_sample, num_trials, carry=carry, warm_on_prev=warm,
                                        need_carry=False)
                headers.append(BlockHeaderFields(*(from_chunks(f) for f in h)))
                codes.append(from_chunks(k))
        return BlockHeaderFields(*(list(f) for f in zip(*headers))), codes
