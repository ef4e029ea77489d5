"""Tutorial 1: Behavioral Cloning on CartPole.

Port of ``examples/tutorials/t01_train_bc.py``: collect expert
demonstrations, evaluate the untrained policy, train BC on the (obs, act)
pairs, and evaluate again. Run:
``python -m imitation_tpu_torch.examples.tutorials.t01_train_bc``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms.bc import BC
from imitation_tpu_torch.data import rollout
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.testing import experts


def eval_return(policy, venv, n: int = 10, seed: int = 99) -> float:
    """Mean return of at least ``n`` episodes of ``policy`` (anything with a
    ``sample_fn``) on ``venv``, rolled out from ``seed``."""
    trajs = rollout.generate_trajectories(
        policy.sample_fn(), venv, rollout.make_min_episodes(n), rng=seed
    )
    return float(np.mean([t.rews.sum() for t in trajs]))


def main(n_epochs: int = 4, n_demos: int = 20, device: Optional[Device] = None):
    venv = make_vec_env("CartPole-v1", num_envs=8, max_episode_steps=200, device=device)
    demos = experts.generate_expert_trajectories(
        "CartPole-v1", venv, min_episodes=n_demos
    )
    print(f"demos: {len(demos)} episodes, "
          f"mean return {np.mean([t.rews.sum() for t in demos]):.1f}")

    bc = BC(
        observation_space=venv.observation_space,
        action_space=venv.action_space,
        demonstrations=demos,
        rng=0,
        batch_size=64,
        device=venv.device,
    )
    before = eval_return(bc.policy, venv)
    print(f"return before BC: {before:.1f}")
    bc.train(n_epochs=n_epochs)
    after = eval_return(bc.policy, venv)
    print(f"return after BC: {after:.1f}")
    return before, after


if __name__ == "__main__":
    main(n_epochs=10)
