"""Tutorial 9: comparing an algorithm against baselines with rliable-style
statistics.

Port of ``examples/tutorials/t09_compare_baselines.py``: train BC over
several seeds, collect per-seed returns, and compare against a random
baseline with the IQM, a bootstrap CI and the probability of improvement
(``imitation_tpu_torch.benchmarking.summarize``). Run:
``python -m imitation_tpu_torch.examples.tutorials.t09_compare_baselines``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms.bc import BC
from imitation_tpu_torch.benchmarking.summarize import bootstrap_ci, iqm, probability_of_improvement
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.examples.tutorials.t01_train_bc import eval_return
from imitation_tpu_torch.models.policies import RandomPolicy
from imitation_tpu_torch.testing import experts


def main(n_seeds: int = 3, n_epochs: int = 3, device: Optional[Device] = None):
    venv = make_vec_env("CartPole-v1", num_envs=8, max_episode_steps=200, device=device)
    demos = experts.generate_expert_trajectories("CartPole-v1", venv, min_episodes=20)

    bc_scores = []
    for seed in range(n_seeds):
        bc = BC(
            observation_space=venv.observation_space,
            action_space=venv.action_space,
            demonstrations=demos,
            rng=seed,
            batch_size=64,
            device=venv.device,
        )
        bc.train(n_epochs=n_epochs)
        bc_scores.append(eval_return(bc.policy, venv, seed=seed))

    random_policy = RandomPolicy(venv.observation_space, venv.action_space)
    rand_scores = [
        eval_return(random_policy, venv, seed=100 + s) for s in range(n_seeds)
    ]

    bc_scores, rand_scores = np.asarray(bc_scores), np.asarray(rand_scores)
    lo, hi = bootstrap_ci(bc_scores)
    poi = probability_of_improvement(bc_scores, rand_scores)
    print(f"BC IQM return: {iqm(bc_scores):.1f} (95% CI [{lo:.1f}, {hi:.1f}])")
    print(f"random IQM return: {iqm(rand_scores):.1f}")
    print(f"P(BC > random): {poi:.2f}")
    return poi


if __name__ == "__main__":
    main(n_seeds=5, n_epochs=10)
