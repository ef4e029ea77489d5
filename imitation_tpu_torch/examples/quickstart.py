"""Quickstart: train BC, GAIL and AIRL on CartPole demonstrations.

Port of ``examples/quickstart.py``. GAIL trains through ``train_fused`` for
30 rounds and AIRL through ``train`` for 10, each round running the GAE
kernel once over the generator's [128, 8] chunk and the disc-batch kernel
once per disc step (demo batch 256). Run:
``python -m imitation_tpu_torch.examples.quickstart`` (on the GPU;
``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms.adversarial.airl import AIRL
from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
from imitation_tpu_torch.algorithms.bc import BC
from imitation_tpu_torch.data import rollout
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.testing import experts


def eval_policy(policy, venv, n=10):
    trajs = rollout.generate_trajectories(
        policy.sample_fn(), venv, rollout.make_min_episodes(n), rng=99
    )
    return float(np.mean([t.rews.sum() for t in trajs]))


def main(device: Optional[Device] = None):
    venv = make_vec_env("CartPole-v1", num_envs=8, max_episode_steps=200, device=device)
    print("Generating expert demonstrations...")
    demos = experts.generate_expert_trajectories("CartPole-v1", venv, min_episodes=20)
    print(f"  {len(demos)} episodes, mean return "
          f"{np.mean([t.rews.sum() for t in demos]):.1f}")

    print("\nTraining BC...")
    bc = BC(
        observation_space=venv.observation_space,
        action_space=venv.action_space,
        demonstrations=demos,
        rng=0,
        batch_size=64,
        device=venv.device,
    )
    bc.train(n_epochs=10)
    print(f"  BC return: {eval_policy(bc.policy, venv):.1f}")

    print("\nTraining GAIL (fused loop)...")
    gail = GAIL(
        demonstrations=demos,
        demo_batch_size=256,
        venv=venv,
        gen_config=PPOConfig(n_steps=128, n_minibatches=8, n_epochs=5,
                             learning_rate=1e-3, ent_coef=0.01),
        allow_variable_horizon=True,
        seed=0,
    )
    gail.train_fused(total_timesteps=30 * gail.gen_train_timesteps)
    print(f"  GAIL return: {eval_policy(gail.policy, venv):.1f}")

    print("\nTraining AIRL...")
    airl = AIRL(
        demonstrations=demos,
        demo_batch_size=256,
        venv=venv,
        gen_config=PPOConfig(n_steps=128, n_minibatches=8, n_epochs=5,
                             learning_rate=1e-3, ent_coef=0.01),
        allow_variable_horizon=True,
        seed=0,
    )
    airl.train(total_timesteps=10 * airl.gen_train_timesteps)
    print(f"  AIRL return: {eval_policy(airl.policy, venv):.1f}")


if __name__ == "__main__":
    main()
