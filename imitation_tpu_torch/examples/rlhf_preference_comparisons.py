"""Example: reward learning from synthetic preferences (DRLHP/RLHF).

Port of ``examples/rlhf_preference_comparisons.py``: 5 iterations of
preference comparisons over 20,000 Pendulum timesteps and 200 comparisons,
the PPO generator running the GAE kernel once per iteration over [64, 8].
Run: ``python -m imitation_tpu_torch.examples.rlhf_preference_comparisons``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms import preference_comparisons as pc
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig


def main(device: Optional[Device] = None):
    venv = make_vec_env("Pendulum-v1", num_envs=8, device=device)
    reward_net = BasicRewardNet(
        observation_space=venv.observation_space,
        action_space=venv.action_space,
    )
    policy = ActorCriticPolicy(
        observation_space=venv.observation_space,
        action_space=venv.action_space,
    )
    ppo = PPO(venv, policy, PPOConfig(n_steps=64, n_minibatches=8, n_epochs=4))
    agent = pc.AgentTrainer(ppo, reward_net, venv, rng=0, exploration_frac=0.05)

    main_trainer = pc.PreferenceComparisons(
        agent,
        reward_net,
        num_iterations=5,
        fragment_length=25,
        comparison_queue_size=500,
        initial_epoch_multiplier=4,
        query_schedule="hyperbolic",
        rng=0,
    )
    result = main_trainer.train(total_timesteps=20_000, total_comparisons=200)
    print(f"final reward loss {result['reward_loss']:.3f}, "
          f"accuracy {result['reward_accuracy']:.3f}")


if __name__ == "__main__":
    main()
