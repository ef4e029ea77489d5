"""Tutorial 5a: preference comparisons with a CNN reward net on pixels.

Port of ``examples/tutorials/t05a_preference_comparisons_cnn.py``. The image
env is CartPole drawn on the device into a 16 x 16 x 1 frame (the cart's
column on the bottom row, the pole as eight pixels leaning with the angle),
so everything stays on the card, and the reward is learned by a
``CnnRewardNet`` from synthetic preferences while PPO trains a (64, 64) MLP
policy over the flattened pixels. Run:
``python -m imitation_tpu_torch.examples.tutorials.t05a_preference_comparisons_cnn``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms import preference_comparisons as pc
from imitation_tpu_torch.envs.base import Env, Space, TimeStep
from imitation_tpu_torch.envs.classic import CartPole
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.rewards.reward_nets import CnnRewardNet
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
from imitation_tpu_torch.util.logger import HierarchicalLogger

SIZE = 16


class PixelCartPole(Env):
    """CartPole with observations rendered to ``[B, SIZE, SIZE, 1]`` float32
    frames; the state is CartPole's ``[B, 4]``."""

    max_episode_steps = 200

    def __init__(self):
        self.inner = CartPole()

    @property
    def observation_space(self) -> Space:
        return Space.box(0.0, 1.0, (SIZE, SIZE, 1))

    @property
    def action_space(self) -> Space:
        return self.inner.action_space

    @staticmethod
    def render(state: torch.Tensor) -> torch.Tensor:
        """The frames of CartPole states ``[B, 4]``: the cart at column
        ``clip((x / 2.4 * 0.5 + 0.5) * 15, 0, 15)`` of the bottom row, and
        the pole on rows 14..7 at ``clip(col + trunc(theta / 0.21 * k), 0,
        15)`` for k = 1..8 (truncation toward zero, as ``astype(int32)``)."""
        dev = state.device
        B = state.shape[0]
        x, theta = state[:, 0], state[:, 2]
        # Constants as device tensors: a CUDA division by a Python scalar
        # multiplies by its reciprocal, which can move a pixel across a
        # column boundary against the CPU.
        col = torch.clamp(((x / torch.tensor(2.4, device=dev)) * 0.5 + 0.5) * (SIZE - 1), 0, SIZE - 1)
        col = col.to(torch.int32)
        rows = torch.arange(SIZE - 2, SIZE - 10, -1, device=dev)
        k = torch.arange(1, 9, dtype=torch.int32, device=dev)
        offs = torch.clamp(col[:, None] + ((theta / torch.tensor(0.21, device=dev))[:, None] * k)
                           .to(torch.int32), 0, SIZE - 1)
        b = torch.arange(B, device=dev)
        img = torch.zeros((B, SIZE, SIZE), dtype=torch.float32, device=dev)
        img[b, SIZE - 1, col.long()] = 1.0
        img[b[:, None], rows[None, :], offs.long()] = 1.0
        return img[..., None]

    def reset(self, n: int, generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        obs, state = self.inner.reset(n, generator)
        return self.render(obs), state

    def step(self, state: torch.Tensor, action: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, TimeStep]:
        new_state, ts = self.inner.step(state, action, generator)
        return new_state, TimeStep(obs=self.render(ts.obs), reward=ts.reward,
                                   terminated=ts.terminated, truncated=ts.truncated)


def build(device: Optional[Device] = None,
          custom_logger: Optional[HierarchicalLogger] = None) -> pc.PreferenceComparisons:
    """The tutorial's loop: 8 pixel envs with episodes cut at 100 steps, a
    ``CnnRewardNet(hid_channels=(8, 8))`` without ``done``, a (64, 64) MLP
    policy trained by PPO (n_steps 32, 4 minibatches, 2 epochs), two
    iterations over fragments of 20 steps, a queue of 200 comparisons and
    the first reward training 2 times longer."""
    venv = VectorEnv(PixelCartPole(), num_envs=8, max_episode_steps=100, device=device)
    reward_net = CnnRewardNet(venv.observation_space, venv.action_space, hid_channels=(8, 8),
                              use_done=False)
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(64, 64))
    ppo = PPO(venv, policy, PPOConfig(n_steps=32, n_minibatches=4, n_epochs=2))
    agent = pc.AgentTrainer(ppo, reward_net, venv, rng=0)
    return pc.PreferenceComparisons(
        agent,
        reward_net,
        num_iterations=2,
        fragment_length=20,
        comparison_queue_size=200,
        initial_epoch_multiplier=2,
        allow_variable_horizon=True,  # CartPole terminates when the pole falls
        rng=0,
        custom_logger=custom_logger,
    )


def main(total_timesteps: int = 6_000, total_comparisons: int = 60, device: Optional[Device] = None):
    trainer = build(device)
    result = trainer.train(total_timesteps=total_timesteps, total_comparisons=total_comparisons)
    print(f"CNN reward loss {result['reward_loss']:.3f}, "
          f"accuracy {result['reward_accuracy']:.3f}")
    return result


if __name__ == "__main__":
    main(total_timesteps=30_000, total_comparisons=300)
