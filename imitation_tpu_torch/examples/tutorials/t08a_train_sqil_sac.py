"""Tutorial 8a: SQIL with a SAC learner on a continuous env.

Port of ``examples/tutorials/t08a_train_sqil_sac.py``: the same 50/50
expert/fresh replay trick, but the off-policy learner is SAC, so continuous
action spaces work. Run:
``python -m imitation_tpu_torch.examples.tutorials.t08a_train_sqil_sac``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms.sqil import SQIL
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.examples.tutorials.t01_train_bc import eval_return
from imitation_tpu_torch.rl.sac import SACConfig
from imitation_tpu_torch.testing import experts


def main(total_timesteps: int = 2_000, device: Optional[Device] = None):
    venv = make_vec_env("Pendulum-v1", num_envs=4, device=device)
    demos = experts.generate_expert_trajectories("Pendulum-v1", venv, min_episodes=8)

    sqil = SQIL(
        venv=venv,
        demonstrations=demos,
        sac_config=SACConfig(
            learning_starts=64, batch_size=64, buffer_size=10_000,
        ),
        allow_variable_horizon=True,
        seed=0,
    )
    assert sqil.rl_algo_name == "sac"
    sqil.train(total_timesteps=total_timesteps)
    ret = eval_return(sqil.policy, venv)
    print(f"SQIL-SAC return after {total_timesteps} steps: {ret:.1f}")
    return ret


if __name__ == "__main__":
    main(total_timesteps=30_000)
