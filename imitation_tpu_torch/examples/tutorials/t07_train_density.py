"""Tutorial 7: density-based reward modelling on Pendulum.

Port of ``examples/tutorials/t07_train_density.py``: fit a kernel density
model to expert (s, a) pairs, use the log-density as the reward, and train
PPO on it (the GAE kernel once per PPO iteration, over [64, 8]). The KDE
scoring is one batched matrix product on the device. Run:
``python -m imitation_tpu_torch.examples.tutorials.t07_train_density``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms.density import DensityAlgorithm, DensityType
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.testing import experts


def main(rl_timesteps: int = 5_000, device: Optional[Device] = None):
    demo_venv = make_vec_env("Pendulum-v1", num_envs=8, device=device)
    demos = experts.generate_expert_trajectories(
        "Pendulum-v1", demo_venv, min_episodes=8
    )

    venv = make_vec_env("Pendulum-v1", num_envs=8, device=device)
    algo = DensityAlgorithm(
        demonstrations=demos,
        venv=venv,
        density_type=DensityType.STATE_ACTION_DENSITY,
        rl_config=PPOConfig(n_steps=64, n_minibatches=8, n_epochs=4),
    )
    algo.train()  # fits the KDE

    # The fitted model IS a RewardFn: expert transitions score high.
    t = demos[0]
    expert_rew = algo(np.asarray(t.obs[:-1]), np.asarray(t.acts),
                      np.asarray(t.obs[1:]), np.zeros(len(t)))
    print(f"mean log-density reward on expert episode: {expert_rew.mean():.2f}")

    algo.train_policy(n_timesteps=rl_timesteps)
    stats = algo.test_policy(n_trajectories=5)
    print(f"true-env return after density-reward RL: {stats['return_mean']:.1f}")
    return stats


if __name__ == "__main__":
    main(rl_timesteps=50_000)
