"""On-device FIFO replay buffer.

Port of ``imitation_tpu/data/buffer.py``: a fixed-capacity ring of
transitions with wraparound store and uniform sampling. Storage is a
``TransitionBatch`` of ``[capacity, ...]`` tensors. Unlike the JAX buffer,
which is pure, ``store`` writes into the storage in place (no second copy of
the ring), and the write position and fill level are host integers, so an
empty buffer raises on ``sample`` with no device sync.
"""

from __future__ import annotations

import dataclasses

import torch

from imitation_tpu_torch.data.types import TransitionBatch


@dataclasses.dataclass
class BufferState:
    data: TransitionBatch  # fields [capacity, ...]
    idx: int  # next write position
    size: int  # current fill level


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
        dst, src = state.data.fields(), batch.fields()
        if k >= self.capacity:
            for name, buf in dst.items():
                buf.copy_(src[name][-self.capacity:])
            return BufferState(data=state.data, idx=0, size=self.capacity)
        device = state.data.acts.device
        pos = (state.idx + torch.arange(k, device=device)) % self.capacity
        for name, buf in dst.items():
            buf.index_copy_(0, pos, src[name])
        return BufferState(
            data=state.data,
            idx=(state.idx + k) % self.capacity,
            size=min(state.size + k, self.capacity),
        )

    def sample_indices(self, state: BufferState, n: int, generator: torch.Generator) -> torch.Tensor:
        """``n`` uniform with-replacement row indices ``[n]`` int32."""
        if state.size == 0:
            raise ValueError(
                "Cannot sample from an empty replay buffer; store transitions "
                "first (e.g. call train_gen())."
            )
        return torch.randint(
            0, state.size, (n,), generator=generator, device=generator.device, dtype=torch.int32
        )

    def sample(self, state: BufferState, n: int, generator: torch.Generator) -> TransitionBatch:
        """Uniform with-replacement sample of ``n`` stored rows."""
        return state.data.take(self.sample_indices(state, n, generator))
