"""GAIL: Generative Adversarial Imitation Learning (Ho & Ermon 2016).

Port of ``imitation_tpu/algorithms/adversarial/gail.py``:

* discriminator logits = raw reward-net output;
* generator reward = -log sigmoid(-logits) = softplus(logits);
* reward_train == reward_test == the processed net.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from imitation_tpu_torch.algorithms.adversarial import common
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet, RewardNet
from imitation_tpu_torch.rl import common as rl_common


class GAIL(common.AdversarialTrainer):
    """GAIL with a PPO generator; the reward net defaults to BasicRewardNet."""

    def __init__(self, *, reward_net: Optional[RewardNet] = None, venv=None, **kwargs):
        if reward_net is None:
            reward_net = BasicRewardNet(venv.observation_space, venv.action_space)
        super().__init__(venv=venv, reward_net=reward_net, **kwargs)

    def logits_expert_is_high(
        self, reward_net, obs, acts, next_obs, dones, log_policy_act_prob=None
    ) -> torch.Tensor:
        """Logit = the reward net's raw forward."""
        return reward_net(obs, acts, next_obs, dones)

    def reward_train_fn(self) -> rl_common.RelabelRewardFn:
        """Generator reward: softplus(logits) = -log sigmoid(-logits)."""

        def fn(reward_net, obs, acts, next_obs, dones):
            return F.softplus(reward_net.predict_processed(obs, acts, next_obs, dones))

        return fn
