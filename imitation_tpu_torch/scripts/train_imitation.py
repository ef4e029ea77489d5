"""train_imitation: the ``bc``, ``dagger`` and ``sqil`` commands.

Port of ``imitation_tpu/scripts/train_imitation.py``. ``bc`` trains on the
demonstrations and saves ``policies/final``; ``dagger`` queries the expert
under a linear or exponential beta schedule and checkpoints the trainer
under ``scratch``; ``sqil`` trains DQN (discrete actions) or SAC
(continuous) on the SQIL reward. Each evaluates the final policy
(``imit_stats``).

    python -m imitation_tpu_torch train_imitation bc with bc_cartpole
"""

from __future__ import annotations

import os
from typing import Any, Dict

from imitation_tpu_torch.algorithms.bc import BC
from imitation_tpu_torch.algorithms.dagger import (
    ExponentialBetaSchedule,
    LinearBetaSchedule,
    SimpleDAggerTrainer,
)
from imitation_tpu_torch.algorithms.sqil import SQIL
from imitation_tpu_torch.policies import serialize as policy_serialize
from imitation_tpu_torch.rl.dqn import DQNConfig
from imitation_tpu_torch.rl.sac import SACConfig
from imitation_tpu_torch.scripts import ingredients
from imitation_tpu_torch.scripts.config import Experiment
from imitation_tpu_torch.scripts.tuned_hps import register_tuned_configs

DEFAULT_CONFIG: Dict[str, Any] = {
    **ingredients.ENV_DEFAULTS,
    **ingredients.EVAL_DEFAULTS,
    "seed": 0,
    "log_root": os.path.join("output", "train_imitation"),
    "log_dir": None,
    "log_format_strs": ["stdout", "csv", "json"],
    "demonstrations": {"source": "generated", "n_expert_demos": 10, "path": None},
    "expert": {"policy_type": "scripted", "loader_kwargs": {}},
    # Warm start: a saved policy directory to initialize the learner from.
    "agent_path": None,
    "bc": {
        "batch_size": 32,
        "minibatch_size": None,
        "n_epochs": 10,
        "n_batches": None,
        "ent_weight": 1e-3,
        "l2_weight": 0.0,
        "learning_rate": 1e-3,
    },
    "dagger": {
        "total_timesteps": 4000,
        "rollout_round_min_episodes": 3,
        "rollout_round_min_timesteps": 500,
        # "linear" (LinearBetaSchedule(rampdown_rounds)) or "exponential"
        # (ExponentialBetaSchedule(decay_probability)).
        "beta_schedule": "linear",
        "rampdown_rounds": 15,
        "decay_probability": 0.7,
    },
    "sqil": {
        "total_timesteps": 10_000,
        "learning_starts": 500,
        "batch_size": 64,
        "learning_rate": 3e-4,
    },
}

ex = Experiment("train_imitation", DEFAULT_CONFIG)
ex.named_config("fast", {
    "num_envs": 2,
    "max_episode_steps": 20,
    "n_episodes_eval": 2,
    "demonstrations": {"n_expert_demos": 2},
    "bc": {"n_epochs": 1, "batch_size": 8},
    "dagger": {
        "total_timesteps": 100,
        "rollout_round_min_episodes": 1,
        "rollout_round_min_timesteps": 20,
    },
    "sqil": {"total_timesteps": 200, "learning_starts": 32, "batch_size": 16},
})


def _finish(policy_apply, venv, config, logger):
    stats = ingredients.eval_policy_stats(policy_apply, venv, config)
    for k, v in stats.items():
        logger.record(f"imit_stats/{k}", v)
    logger.dump(0)
    return {"imit_stats": stats}


def _make_bc(config: Dict[str, Any], venv, logger, demonstrations=None) -> BC:
    bc_cfg = config["bc"]
    return BC(
        observation_space=venv.observation_space,
        action_space=venv.action_space,
        demonstrations=demonstrations,
        rng=config["seed"],
        batch_size=bc_cfg["batch_size"],
        minibatch_size=bc_cfg["minibatch_size"],
        ent_weight=bc_cfg["ent_weight"],
        l2_weight=bc_cfg["l2_weight"],
        optimizer_kwargs={"lr": bc_cfg["learning_rate"]},
        custom_logger=logger,
        allow_variable_horizon=True,
        device=venv.device,
    )


def _warm_start(bc: BC, path: str) -> None:
    """Loads the policy saved at ``path`` into ``bc``'s policy, after
    checking that its architecture is the configured one."""
    warm = policy_serialize.load_policy_from_path(path, device=bc.device).state_dict()
    cur = bc.policy.state_dict()
    if sorted(warm) != sorted(cur):
        raise ValueError(
            f"agent_path checkpoint has a different policy architecture: "
            f"parameters {sorted(warm)} do not match the configured BC policy's "
            f"{sorted(cur)}. Check policy hid_sizes / spaces."
        )
    mismatched = [k for k in cur if cur[k].shape != warm[k].shape]
    if mismatched:
        raise ValueError(
            f"agent_path checkpoint parameter shapes do not match the "
            f"configured BC policy (obs/action spaces or hid_sizes "
            f"differ) at: {', '.join(mismatched)}"
        )
    bc.policy.load_state_dict(warm)


@ex.command("bc")
def bc_cmd(config: Dict[str, Any], run_dir: str, logger) -> Dict[str, Any]:
    venv = ingredients.make_venv_from_config(config)
    demos = ingredients.get_expert_trajectories(config, venv)
    bc = _make_bc(config, venv, logger, demos)
    if config.get("agent_path"):
        _warm_start(bc, config["agent_path"])
    bc.train(n_epochs=config["bc"]["n_epochs"], n_batches=config["bc"]["n_batches"])
    bc.save_policy(os.path.join(run_dir, "policies", "final"))
    return _finish(bc.policy.sample_fn(), venv, config, logger)


@ex.command("dagger")
def dagger_cmd(config: Dict[str, Any], run_dir: str, logger) -> Dict[str, Any]:
    venv = ingredients.make_venv_from_config(config)
    expert_apply = ingredients.load_expert_policy(config, venv)
    d_cfg = config["dagger"]
    if d_cfg.get("beta_schedule", "linear") == "exponential":
        schedule = ExponentialBetaSchedule(d_cfg.get("decay_probability", 0.7))
    else:
        schedule = LinearBetaSchedule(d_cfg["rampdown_rounds"])
    bc_trainer = _make_bc(config, venv, logger)
    if config.get("agent_path"):
        _warm_start(bc_trainer, config["agent_path"])
    trainer = SimpleDAggerTrainer(
        venv=venv,
        scratch_dir=os.path.join(run_dir, "scratch"),
        expert_policy_apply=expert_apply,
        rng=config["seed"],
        beta_schedule=schedule,
        bc_trainer=bc_trainer,
        custom_logger=logger,
    )
    trainer.train(
        total_timesteps=d_cfg["total_timesteps"],
        rollout_round_min_episodes=d_cfg["rollout_round_min_episodes"],
        rollout_round_min_timesteps=d_cfg["rollout_round_min_timesteps"],
        bc_train_kwargs={"n_epochs": config["bc"]["n_epochs"]},
    )
    trainer.save_trainer()
    return _finish(trainer.policy.sample_fn(), venv, config, logger)


@ex.command("sqil")
def sqil_cmd(config: Dict[str, Any], run_dir: str, logger) -> Dict[str, Any]:
    venv = ingredients.make_venv_from_config(config)
    demos = ingredients.get_expert_trajectories(config, venv)
    s_cfg = config["sqil"]
    learner = dict(
        learning_starts=s_cfg["learning_starts"],
        batch_size=s_cfg["batch_size"],
        learning_rate=s_cfg["learning_rate"],
    )
    sqil = SQIL(
        venv=venv,
        demonstrations=demos,
        # DQN on discrete actions, SAC on continuous ones.
        dqn_config=DQNConfig(**learner),
        sac_config=SACConfig(**learner),
        custom_logger=logger,
        allow_variable_horizon=True,
        seed=config["seed"],
    )
    sqil.train(total_timesteps=s_cfg["total_timesteps"])
    return _finish(sqil.policy.sample_fn(), venv, config, logger)


register_tuned_configs(ex)


if __name__ == "__main__":
    ex.run_cli()
