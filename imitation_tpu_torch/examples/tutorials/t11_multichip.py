"""Tutorial 11: multi-process GAIL — data-parallel ``train_fused`` and a resume
at another world size.

Port of ``examples/tutorials/t11_multichip.py``. One GAIL trainer's whole
state is placed on a ``dp`` mesh of processes, one device each
(``parallel.mesh.shard_adversarial_trainer``): every rank steps its block of
the envs, the gradients are averaged over the ranks, and the replay ring
and discriminator stay replicated, so the ranks end bitwise equal and with
what one process would compute. The generator state saved from that layout
(rank 0 writes) restores in one process (``dp = 1``) and keeps training.
Tensor parallelism (the JAX tutorial's ``tp = 2``) is not ported
(``parallel.mesh``), so this runs at ``tp = 1``.

Run one rank per GPU with NCCL, or several CPU ranks with gloo::

    torchrun --nproc-per-node 2 -m imitation_tpu_torch.examples.tutorials.t11_multichip
    torchrun --nproc-per-node 4 -m imitation_tpu_torch.examples.tutorials.t11_multichip \
        --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Optional, Tuple

from imitation_tpu_torch import Device
from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.parallel import distributed
from imitation_tpu_torch.parallel import mesh as mesh_mod
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.util.checkpoint import restore_state, save_state
from imitation_tpu_torch.util.logger import configure


def run(mesh: mesh_mod.Mesh, ckpt_dir: str, device: Device, n_rounds: int = 8) -> Tuple[Any, Optional[Any]]:
    """``n_rounds`` rounds of sharded ``train_fused`` over ``mesh``; then rank
    0 alone restores the generator into a fresh trainer and trains 2 more
    rounds. Returns (the sharded trainer, the resumed one or None)."""
    venv = make_vec_env("CartPole-v1", num_envs=8, max_episode_steps=32, device=device)
    demos = experts.generate_expert_trajectories("CartPole-v1", venv, min_episodes=4)

    def build() -> GAIL:
        return GAIL(demonstrations=demos, demo_batch_size=64, venv=venv,
                    gen_config=PPOConfig(n_steps=16, n_minibatches=2, n_epochs=2),
                    n_disc_updates_per_round=2, allow_variable_horizon=True, seed=0,
                    custom_logger=configure(format_strs=()))

    # --- train over dp ranks ---------------------------------------------
    trainer = build()
    mesh_mod.shard_adversarial_trainer(trainer, mesh)
    trainer.train_fused(n_rounds * trainer.gen_train_timesteps, rounds_per_sync=4)
    if mesh.rank == 0:
        print(f"trained {trainer.gen_state.n_updates} gen updates / {trainer.disc_state.step} disc steps "
              f"on mesh {mesh.shape}, {trainer.gen_state.env_state.obs.shape[0]} envs a rank")
    path = os.path.join(ckpt_dir, "gen")
    save_state(path, trainer.gen_state)  # every rank gathers; rank 0 writes

    # --- resume the generator in one process (dp = 1) ---------------------
    resumed = None
    if mesh.rank == 0:
        resumed = build()
        resumed.gen_state = restore_state(path, resumed.gen_algo.init_state())
        resumed.train_fused(2 * resumed.gen_train_timesteps, rounds_per_sync=2)
        print(f"resumed in one process: gen updates now {resumed.gen_state.n_updates}")
    distributed.barrier(mesh)
    return trainer, resumed


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    parser.add_argument("--device", default=None, help="'cpu', or each rank's cuda:LOCAL_RANK by default")
    parser.add_argument("--rounds", type=int, default=8)
    args = parser.parse_args(argv)
    device = distributed.initialize(args.backend, device=args.device)
    if device is None:
        raise SystemExit("run under torchrun (RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT unset)")
    try:
        # Only rank 0 writes and reads the checkpoint in its directory.
        with tempfile.TemporaryDirectory(prefix="t11_ckpt_") as tmp:
            run(mesh_mod.make_mesh(), tmp, device, args.rounds)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
