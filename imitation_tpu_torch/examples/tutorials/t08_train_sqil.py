"""Tutorial 8: SQIL on CartPole.

Port of ``examples/tutorials/t08_train_sqil.py``: soft Q-learning imitation —
a DQN whose replay always samples 50% expert transitions with reward 1 and
50% fresh env transitions with reward 0. Run:
``python -m imitation_tpu_torch.examples.tutorials.t08_train_sqil``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms.sqil import SQIL
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.examples.tutorials.t01_train_bc import eval_return
from imitation_tpu_torch.rl.dqn import DQNConfig
from imitation_tpu_torch.testing import experts


def main(total_timesteps: int = 3_000, device: Optional[Device] = None):
    venv = make_vec_env("CartPole-v1", num_envs=8, max_episode_steps=200, device=device)
    demos = experts.generate_expert_trajectories("CartPole-v1", venv, min_episodes=20)

    sqil = SQIL(
        venv=venv,
        demonstrations=demos,
        dqn_config=DQNConfig(learning_starts=64, train_freq=4, batch_size=64),
        allow_variable_horizon=True,
        seed=0,
    )
    sqil.train(total_timesteps=total_timesteps)
    ret = eval_return(sqil.policy, venv)
    print(f"SQIL return after {total_timesteps} steps: {ret:.1f}")
    return ret


if __name__ == "__main__":
    main(total_timesteps=50_000)
