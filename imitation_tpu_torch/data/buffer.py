"""On-device FIFO replay buffer.

Port of ``imitation_tpu/data/buffer.py``: a fixed-capacity ring of
transitions with wraparound store and uniform sampling. Storage is a
``TransitionBatch`` of ``[capacity, ...]`` tensors. Unlike the JAX buffer,
which is pure, ``store`` writes into the storage in place (no second copy of
the ring), and the write position and fill level are host integers, so an
empty buffer raises on ``sample`` with no device sync.

A ring split over data-parallel ranks (``shard_ring``, for
``parallel.mesh.shard_sac_state``) keeps on each rank the rows of the env
columns that rank steps: with ``E`` envs in all, ``e = E / dp`` per rank and
a capacity that divides by ``E``, global row ``g`` holds env column
``g % E`` and lives on rank ``(g % E) // e``. A rank's local ring is then an
ordinary ring of ``capacity / dp`` rows that stores the rank's own
transitions, so a store moves nothing; ``sample`` draws global indices from
the replicated generator and the owners send the rows (one collective).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class RingShard:
    """A ring split over ``mesh``'s ``dp`` ranks, ``envs_per_rank`` env
    columns each (module docstring)."""

    mesh: Any
    envs_per_rank: int

    def owner_and_row(self, g: torch.Tensor):
        """(owning rank, local row) of global rows ``g``."""
        num_envs = self.envs_per_rank * self.mesh.dp
        col = g % num_envs
        return col // self.envs_per_rank, (g // num_envs) * self.envs_per_rank + col % self.envs_per_rank


@dataclasses.dataclass
class BufferState:
    data: TransitionBatch  # fields [capacity, ...] (this rank's rows of a split ring)
    idx: int  # next write position (local)
    size: int  # current fill level (local)
    shard: Optional[RingShard] = None  # set on a ring split over ranks

    @property
    def global_size(self) -> int:
        """The fill level of the whole ring."""
        return self.size if self.shard is None else self.size * self.shard.mesh.dp


@dataclasses.dataclass(frozen=True)
class ReplayBuffer:
    """Fixed-capacity device ring buffer of transitions."""

    capacity: int

    def init_state(self, example: TransitionBatch) -> BufferState:
        """Allocates zeroed storage shaped like ``example`` rows."""
        data = example.map(
            lambda x: torch.zeros((self.capacity,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        )
        return BufferState(data=data, idx=0, size=0)

    def store(self, state: BufferState, batch: TransitionBatch) -> BufferState:
        """FIFO store with wraparound.

        If the batch exceeds capacity only its last ``capacity`` rows are
        kept, matching the reference's chunked-store semantics.
        """
        k = batch.batch_size
        capacity = state.data.batch_size  # this rank's rows of a split ring
        dst, src = state.data.fields(), batch.fields()
        if k >= capacity:
            for name, buf in dst.items():
                buf.copy_(src[name][-capacity:])
            return dataclasses.replace(state, idx=0, size=capacity)
        device = state.data.acts.device
        pos = (state.idx + torch.arange(k, device=device)) % capacity
        for name, buf in dst.items():
            buf.index_copy_(0, pos, src[name])
        return dataclasses.replace(state, idx=(state.idx + k) % capacity,
                                   size=min(state.size + k, capacity))

    def sample_indices(self, state: BufferState, n: int, generator: torch.Generator) -> torch.Tensor:
        """``n`` uniform with-replacement row indices ``[n]`` int32 (global
        rows of a split ring)."""
        if state.size == 0:
            raise ValueError(
                "Cannot sample from an empty replay buffer; store transitions "
                "first (e.g. call train_gen())."
            )
        return _uniform_indices(state.global_size, n, generator)

    def sample(self, state: BufferState, n: int, generator: torch.Generator) -> TransitionBatch:
        """Uniform with-replacement sample of ``n`` stored rows."""
        return take_rows(state, self.sample_indices(state, n, generator))


def take_rows(state: BufferState, idx: torch.Tensor) -> TransitionBatch:
    """Rows ``idx`` of the ring; of a split ring, global rows, each sent by
    its owner (every rank calls this with the same ``idx``)."""
    if state.shard is None:
        return state.data.take(idx)
    owner, row = state.shard.owner_and_row(idx.long())
    mine = owner == state.shard.mesh.rank
    local = state.data.take(torch.where(mine, row, torch.zeros_like(row)))
    fields = local.fields()
    masked = [torch.where(mine.reshape((-1,) + (1,) * (v.dim() - 1)), v, torch.zeros_like(v))
              for v in fields.values()]
    # Each row is non-zero on its owner only, so the sum over ranks is the row.
    distributed.all_reduce_(masked, state.shard.mesh)
    return TransitionBatch(**dict(zip(fields, masked)))


def _ring_rows(capacity: int, dp: int, rank: int, e: int) -> torch.Tensor:
    """The global rows rank ``rank`` of ``dp`` holds (``e`` env columns a
    rank), in its local order."""
    local = torch.arange(capacity // dp)
    return (local // e) * (e * dp) + rank * e + local % e


def shard_ring(state: BufferState, mesh, num_envs: int) -> BufferState:
    """This rank's rows of a whole ring (module docstring), as a split ring."""
    capacity = state.data.batch_size
    if capacity % mesh.dp != 0:
        raise ValueError(f"replay capacity {capacity} must be divisible by dp={mesh.dp} to shard the ring")
    if num_envs % mesh.dp != 0 or capacity % num_envs != 0:
        raise ValueError(
            f"replay capacity {capacity} must be divisible by num_envs={num_envs} (and that by "
            f"dp={mesh.dp}) so that each ring row stays with the rank stepping its env"
        )
    if state.idx % num_envs or state.size % num_envs:
        raise ValueError("the ring's fill does not end on a whole env step")
    shard = RingShard(mesh, num_envs // mesh.dp)
    rows = _ring_rows(capacity, mesh.dp, mesh.rank, shard.envs_per_rank).to(state.data.acts.device)
    return BufferState(data=state.data.take(rows), idx=state.idx // mesh.dp,
                       size=state.size // mesh.dp, shard=shard)


def unshard_ring(state: BufferState) -> BufferState:
    """The whole ring of a split one, on every rank (a collective)."""
    shard = state.shard
    W = shard.mesh.dp
    capacity = state.data.batch_size * W
    fields = state.data.fields()
    gathered = distributed.all_gather_many(list(fields.values()), shard.mesh)
    # gathered[i] is [W * local, ...] in rank order; put each rank's rows back.
    order = torch.cat([_ring_rows(capacity, W, r, shard.envs_per_rank)
                       for r in range(W)]).to(state.data.acts.device)
    whole = {}
    for name, g in zip(fields, gathered):
        out = torch.empty_like(g)
        out[order] = g
        whole[name] = out
    return BufferState(data=TransitionBatch(**whole), idx=state.idx * W, size=state.size * W)


def _uniform_indices(high: int, n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` uniform draws from ``[0, high)``, ``[n]`` int32 on the
    generator's device: every replay sample (tests substitute the JAX
    package's draws)."""
    return torch.randint(0, high, (n,), generator=generator, device=generator.device, dtype=torch.int32)
