"""Reward relabelling of a rollout chunk.

Port of ``relabel_chunk`` from ``imitation_tpu/rewards/reward_wrapper.py``:
one batched reward-net forward over all ``T * B`` transitions of a chunk,
where the reference wraps the env and relabels step by step. The host
``RewardVecEnvWrapper`` waits for the port's host envs.
"""

from __future__ import annotations

from typing import Any

import torch

from imitation_tpu_torch.data.rollout import RolloutChunk
from imitation_tpu_torch.rl.common import RelabelRewardFn


@torch.no_grad()
def relabel_chunk(chunk: RolloutChunk, reward_fn: RelabelRewardFn, reward_params: Any) -> RolloutChunk:
    """``chunk`` with its ``[T, B]`` rewards replaced by ``reward_fn``'s."""
    T, B = chunk.rews.shape

    def flat(x):
        return x.reshape((T * B,) + tuple(x.shape[2:]))

    rews = reward_fn(
        reward_params, flat(chunk.obs), flat(chunk.acts), flat(chunk.next_obs),
        flat(chunk.dones.float()),
    ).reshape(T, B)
    return chunk.replace(rews=rews)
