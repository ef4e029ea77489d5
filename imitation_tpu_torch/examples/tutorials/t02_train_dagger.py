"""Tutorial 2: DAgger on CartPole with a synthetic expert.

Port of ``examples/tutorials/t02_train_dagger.py``: wrap BC in
``SimpleDAggerTrainer``; each round collects on-policy states labelled with
the EXPERT's actions (beta-mixed stepping), then retrains BC on all demos so
far. Run: ``python -m imitation_tpu_torch.examples.tutorials.t02_train_dagger``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

import tempfile
from typing import Optional

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms.dagger import SimpleDAggerTrainer
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.examples.tutorials.t01_train_bc import eval_return
from imitation_tpu_torch.testing import experts


def main(total_timesteps: int = 2000, device: Optional[Device] = None):
    venv = make_vec_env("CartPole-v1", num_envs=8, max_episode_steps=200, device=device)
    with tempfile.TemporaryDirectory(prefix="dagger_") as scratch:
        trainer = SimpleDAggerTrainer(
            venv=venv,
            scratch_dir=scratch,
            expert_policy_apply=experts.cartpole_expert_fn,
            rng=0,
        )
        trainer.train(total_timesteps, bc_train_kwargs=dict(n_epochs=4))
        ret = eval_return(trainer.policy, venv)
    print(f"DAgger return after {total_timesteps} steps: {ret:.1f}")
    return ret


if __name__ == "__main__":
    main(total_timesteps=8000)
