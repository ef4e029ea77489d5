"""Tutorial 5: learning a reward from synthetic preferences (DRLHP/RLHF).

Port of ``examples/tutorials/t05_preference_comparisons.py``: sample agent
trajectories, fragment them, gather (synthetic) preferences over fragment
pairs, fit the reward net on the Boltzmann preference model, and train PPO
on the learned reward (the GAE kernel once per PPO iteration, over [64, 8]).
Then evaluate on the TRUE env reward. Run:
``python -m imitation_tpu_torch.examples.tutorials.t05_preference_comparisons``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms import preference_comparisons as pc
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.examples.tutorials.t01_train_bc import eval_return
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig


def main(total_timesteps: int = 10_000, total_comparisons: int = 120, device: Optional[Device] = None):
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

    trainer = pc.PreferenceComparisons(
        agent,
        reward_net,
        num_iterations=4,
        fragment_length=25,
        comparison_queue_size=400,
        initial_epoch_multiplier=4,
        query_schedule="hyperbolic",
        rng=0,
    )
    result = trainer.train(
        total_timesteps=total_timesteps, total_comparisons=total_comparisons
    )
    ret = eval_return(agent.policy, venv)
    print(f"reward loss {result['reward_loss']:.3f}, "
          f"accuracy {result['reward_accuracy']:.3f}, "
          f"true-env return {ret:.1f}")
    return result


if __name__ == "__main__":
    main(total_timesteps=60_000, total_comparisons=400)
