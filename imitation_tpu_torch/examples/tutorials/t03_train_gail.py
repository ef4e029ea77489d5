"""Tutorial 3: GAIL on CartPole.

Port of ``examples/tutorials/t03_train_gail.py``: adversarial imitation —
the discriminator learns to tell expert from generator transitions, the PPO
generator trains on -log sigma(-D) rewards. Each round runs the GAE kernel
once over the generator's [128, 8] chunk and the disc-batch kernel once per
disc step (demo batch 256). Run:
``python -m imitation_tpu_torch.examples.tutorials.t03_train_gail``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.examples.tutorials.t01_train_bc import eval_return
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.testing import experts


def main(total_timesteps: int = 20_000, device: Optional[Device] = None):
    venv = make_vec_env("CartPole-v1", num_envs=8, max_episode_steps=200, device=device)
    demos = experts.generate_expert_trajectories("CartPole-v1", venv, min_episodes=20)

    gail = GAIL(
        demonstrations=demos,
        demo_batch_size=256,
        venv=venv,
        gen_config=PPOConfig(
            n_steps=128, n_minibatches=8, n_epochs=5,
            learning_rate=1e-3, ent_coef=0.01,
        ),
        allow_variable_horizon=True,
        seed=0,
    )
    gail.train(total_timesteps)
    after = eval_return(gail.policy, venv)
    print(f"GAIL return: {after:.1f} "
          f"(expert {np.mean([t.rews.sum() for t in demos]):.1f})")
    return after


if __name__ == "__main__":
    main(total_timesteps=100_000)
