"""Tutorial 4: AIRL on CartPole.

Port of ``examples/tutorials/t04_train_airl.py``: like GAIL, but the
discriminator logit is r_theta(s,a,s') - log pi(a|s), so the learned reward
transfers — ``reward_test_fn`` strips the potential shaping term. Run:
``python -m imitation_tpu_torch.examples.tutorials.t04_train_airl``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms.adversarial.airl import AIRL
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.examples.tutorials.t01_train_bc import eval_return
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.testing import experts


def main(total_timesteps: int = 20_000, device: Optional[Device] = None):
    venv = make_vec_env("CartPole-v1", num_envs=8, max_episode_steps=200, device=device)
    demos = experts.generate_expert_trajectories("CartPole-v1", venv, min_episodes=20)

    airl = AIRL(
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
    airl.train(total_timesteps)
    after = eval_return(airl.policy, venv)

    # The transferable (unshaped) reward: reward_test_fn on an expert episode,
    # called with the reward net itself (the port's nets own their weights).
    t = demos[0]

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=venv.device)

    with torch.no_grad():
        r = airl.reward_test_fn()(
            airl.reward_net,
            dev(t.obs[:-1], torch.float32), dev(t.acts),
            dev(t.obs[1:], torch.float32), torch.zeros(len(t), device=venv.device),
        ).cpu().numpy()
    print(f"AIRL return: {after:.1f} "
          f"(expert {np.mean([tr.rews.sum() for tr in demos]):.1f}); "
          f"learned reward on an expert episode: mean {np.mean(r):.3f}")
    return after


if __name__ == "__main__":
    main(total_timesteps=100_000)
