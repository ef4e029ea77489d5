"""Tutorial 6: Maximum Causal Entropy IRL on a tabular MDP.

Port of ``examples/tutorials/t06_train_mce.py``: soft value iteration
(``mce_partition_fh``), occupancy measures, then MCE IRL gradient descent
until the learned reward's occupancy matches the expert's. Run:
``python -m imitation_tpu_torch.examples.tutorials.t06_train_mce``
(on the GPU; ``main(device="cpu")`` runs it on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from imitation_tpu_torch import Device, default_device
from imitation_tpu_torch.algorithms.mce_irl import (
    MCEIRL,
    mce_occupancy_measures,
    mce_partition_fh,
)
from imitation_tpu_torch.envs.tabular import random_mdp


def main(n_states: int = 6, n_actions: int = 3, horizon: int = 8, device: Optional[Device] = None):
    device = default_device(device)
    env = random_mdp(n_states, n_actions, horizon=horizon, seed=0)

    # Expert: the soft-optimal policy under the TRUE reward.
    _, _, pi_expert = mce_partition_fh(env, device=device)
    _, D_expert = mce_occupancy_measures(env, pi=pi_expert, device=device)
    D_expert = D_expert.cpu().numpy()
    print("expert state occupancy:", np.round(D_expert, 3))

    irl = MCEIRL(
        np.asarray(D_expert, np.float64), env,
        log_interval=None, optimizer_kwargs=dict(lr=0.05), device=device,
    )
    irl.train(max_iter=400)

    with torch.no_grad():
        reward = irl.reward_net(env.tensors(device)["obs"])
    _, _, pi_learned = mce_partition_fh(env, reward=reward, device=device)
    _, D_learned = mce_occupancy_measures(env, pi=pi_learned, device=device)
    D_learned = D_learned.cpu().numpy()
    gap = float(np.abs(D_learned - D_expert).max())
    print("learned state occupancy:", np.round(D_learned, 3))
    print(f"max occupancy gap: {gap:.4f}")
    return gap


if __name__ == "__main__":
    main()
