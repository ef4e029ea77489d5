"""AIRL: Adversarial Inverse Reinforcement Learning (Fu et al. 2018).

Port of ``imitation_tpu/algorithms/adversarial/airl.py``:

* discriminator logit = f(s,a,s') - log pi(a|s), so the generator policy
  must be stochastic and the disc step passes log pi(a|s);
* the reward net defaults to ``BasicShapedRewardNet``;
* ``reward_train_fn`` is the shaped net f; ``reward_test_fn`` strips the
  potential shaping (``base_forward``), so the unshaped reward transfers to
  new dynamics.
"""

from __future__ import annotations

from typing import Optional

import torch

from imitation_tpu_torch.algorithms.adversarial import common
from imitation_tpu_torch.rewards.reward_nets import (
    BasicShapedRewardNet,
    RewardNet,
    ShapedRewardNet,
)
from imitation_tpu_torch.rl import common as rl_common


class AIRL(common.AdversarialTrainer):
    """AIRL with a PPO or SAC generator; the reward net defaults to
    BasicShapedRewardNet."""

    def __init__(self, *, reward_net: Optional[RewardNet] = None, venv=None, **kwargs):
        if reward_net is None:
            reward_net = BasicShapedRewardNet(venv.observation_space, venv.action_space)
        super().__init__(venv=venv, reward_net=reward_net, **kwargs)

    @property
    def needs_policy_log_prob(self) -> bool:
        return True

    def logits_expert_is_high(
        self, reward_net, obs, acts, next_obs, dones, log_policy_act_prob=None
    ) -> torch.Tensor:
        """Logit = f(s,a,s') - log pi(a|s)."""
        if log_policy_act_prob is None:
            raise TypeError("Non-None `log_policy_act_prob` is required for this method.")
        return reward_net(obs, acts, next_obs, dones) - log_policy_act_prob

    def reward_train_fn(self) -> rl_common.RelabelRewardFn:
        """The generator trains on the full shaped reward f (the forward path)."""

        def fn(reward_net, obs, acts, next_obs, dones):
            return reward_net(obs, acts, next_obs, dones)

        return fn

    def reward_test_fn(self) -> rl_common.RelabelRewardFn:
        """Transfer reward: the shaping-stripped base net."""
        if isinstance(self.reward_net, ShapedRewardNet):

            def fn(reward_net, obs, acts, next_obs, dones):
                return reward_net.base_forward(obs, acts, next_obs, dones)

            return fn
        return self.reward_train_fn()
