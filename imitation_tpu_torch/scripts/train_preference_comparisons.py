"""train_preference_comparisons: reward learning from preferences (RLHF).

Port of ``imitation_tpu/scripts/train_preference_comparisons.py``: builds
the trajectory generator (a PPO agent, a SAC agent for PEBBLE ``with sac``,
or a static dataset from ``trajectory_path``), the reward net (optionally an
ensemble with active selection), the fragmenter, the synthetic gatherer and
the reward trainer, runs the loop and saves ``checkpoints/final``
(``reward_net``, ``policy``) and ``preferences.pkl``.

    python -m imitation_tpu_torch train_preference_comparisons with active env_name=Pendulum-v1
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from imitation_tpu_torch.algorithms import preference_comparisons as pc
from imitation_tpu_torch.data import serialize as traj_serialize
from imitation_tpu_torch.models.networks import EMANorm, RunningNorm
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.policies import serialize as policy_serialize
from imitation_tpu_torch.rewards import serialize as reward_serialize
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet, NormalizedRewardNet, RewardEnsemble
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
from imitation_tpu_torch.rl.sac import SAC, SACConfig
from imitation_tpu_torch.scripts import ingredients
from imitation_tpu_torch.scripts.config import Experiment

NORM_LAYERS = {"running": RunningNorm, "ema": EMANorm}

DEFAULT_CONFIG: Dict[str, Any] = {
    **ingredients.ENV_DEFAULTS,
    **ingredients.EVAL_DEFAULTS,
    "seed": 0,
    "log_root": os.path.join("output", "train_preference_comparisons"),
    "log_dir": None,
    "log_format_strs": ["stdout", "csv", "json"],
    "total_timesteps": 20_000,
    "total_comparisons": 400,
    "num_iterations": 10,
    "fragment_length": 50,
    "transition_oversampling": 1.0,
    "initial_comparison_frac": 0.1,
    "initial_epoch_multiplier": 4.0,
    "comparison_queue_size": None,
    "exploration_frac": 0.0,
    "query_schedule": "hyperbolic",
    # normalize_output_layer: "running" | "ema" | None (with an ensemble, of
    # each member). add_std_alpha: with an ensemble, the agent trains on
    # mean + alpha * std of the members' rewards.
    "reward": {"ensemble": False, "num_members": 3, "active_selection": False,
               "active_selection_oversampling": 2.0, "uncertainty_on": "logit",
               "normalize_output_layer": "running", "add_std_alpha": None},
    "reward_trainer": {"epochs": 3, "batch_size": 32, "lr": 1e-3},
    "gatherer": {"temperature": 1.0, "discount_factor": 1.0, "sample": True},
    # algo: "ppo" | "sac" (PEBBLE)
    "rl": {"algo": "ppo", "n_steps": 128, "batch_size": 64, "n_epochs": 4,
           "learning_rate": 3e-4, "train_freq": 64, "learning_starts": 100},
    "trajectory_path": None,  # a static dataset instead of an agent
}

ex = Experiment("train_preference_comparisons", DEFAULT_CONFIG)
ex.named_config("fast", {
    "num_envs": 2,
    "max_episode_steps": 20,
    "n_episodes_eval": 2,
    "total_timesteps": 128,
    "total_comparisons": 12,
    "num_iterations": 2,
    "fragment_length": 5,
    "initial_epoch_multiplier": 1.0,
    "reward_trainer": {"epochs": 1, "batch_size": 4},
    "rl": {"n_steps": 16, "batch_size": 16, "n_epochs": 1},
})
ex.named_config("ensemble", {"reward": {"ensemble": True}})
ex.named_config("active", {"reward": {"ensemble": True, "active_selection": True}})
ex.named_config("normalize_output_disable", {"reward": {"normalize_output_layer": None}})
ex.named_config("normalize_output_running", {"reward": {"normalize_output_layer": "running"}})
ex.named_config("normalize_output_ema", {"reward": {"normalize_output_layer": "ema"}})
ex.named_config("sac", {"rl": {"algo": "sac"}})


def _reward_net(config: Dict[str, Any], venv):
    r_cfg = config["reward"]
    norm = r_cfg.get("normalize_output_layer")
    if r_cfg["ensemble"]:
        # An ensemble normalizes each member's output, not the mean.
        return RewardEnsemble(
            venv.observation_space,
            venv.action_space,
            member_cls=BasicRewardNet,
            num_members=r_cfg["num_members"],
            member_normalize_cls=NORM_LAYERS[norm] if norm else None,
        )
    net = BasicRewardNet(venv.observation_space, venv.action_space)
    return NormalizedRewardNet(net, NORM_LAYERS[norm]) if norm else net


@ex.main
def train_preference_comparisons(config: Dict[str, Any], run_dir: str, logger):
    venv = ingredients.make_venv_from_config(config)
    r_cfg = config["reward"]
    reward_net = _reward_net(config, venv)

    rl_cfg = config["rl"]
    agent = None
    if config["trajectory_path"] is not None:
        trajectory_generator = pc.TrajectoryDataset(
            traj_serialize.load(config["trajectory_path"]), rng=config["seed"]
        )
    elif rl_cfg.get("algo", "ppo") == "sac":
        sac = SAC(
            venv,
            SACConfig(
                learning_rate=rl_cfg["learning_rate"],
                train_freq=rl_cfg.get("train_freq", 64),
                batch_size=rl_cfg["batch_size"],
                learning_starts=rl_cfg.get("learning_starts", 100),
            ),
            seed=config["seed"],
        )
        agent = trajectory_generator = pc.SACAgentTrainer(
            sac, reward_net, venv, rng=config["seed"],
            exploration_frac=config["exploration_frac"],
            relabel_alpha=r_cfg.get("add_std_alpha"),
        )
    else:
        batch = rl_cfg["n_steps"] * venv.num_envs
        ppo = PPO(
            venv,
            ActorCriticPolicy(venv.observation_space, venv.action_space),
            PPOConfig(
                n_steps=rl_cfg["n_steps"],
                n_minibatches=max(1, batch // rl_cfg["batch_size"]),
                n_epochs=rl_cfg["n_epochs"],
                learning_rate=rl_cfg["learning_rate"],
            ),
            seed=config["seed"],
        )
        agent = trajectory_generator = pc.AgentTrainer(
            ppo, reward_net, venv, rng=config["seed"],
            exploration_frac=config["exploration_frac"],
            relabel_alpha=r_cfg.get("add_std_alpha"),
        )

    preference_model = pc.PreferenceModel(
        reward_net, discount_factor=config["gatherer"]["discount_factor"]
    )
    fragmenter = pc.RandomFragmenter(rng=config["seed"], warning_threshold=0)
    if r_cfg["active_selection"]:
        fragmenter = pc.ActiveSelectionFragmenter(
            preference_model=preference_model,
            base_fragmenter=fragmenter,
            fragment_sample_factor=r_cfg["active_selection_oversampling"],
            uncertainty_on=r_cfg["uncertainty_on"],
        )
    gatherer = pc.SyntheticGatherer(
        temperature=config["gatherer"]["temperature"],
        discount_factor=config["gatherer"]["discount_factor"],
        sample=config["gatherer"]["sample"],
        rng=np.random.default_rng(config["seed"]),
    )
    rt_cfg = config["reward_trainer"]
    reward_trainer = pc._make_reward_trainer(
        preference_model,
        rng=config["seed"],
        reward_trainer_kwargs={
            "epochs": rt_cfg["epochs"],
            "batch_size": rt_cfg["batch_size"],
            "lr": rt_cfg["lr"],
        },
    )

    main = pc.PreferenceComparisons(
        trajectory_generator,
        reward_net,
        num_iterations=config["num_iterations"],
        fragmenter=fragmenter,
        preference_gatherer=gatherer,
        reward_trainer=reward_trainer,
        comparison_queue_size=config["comparison_queue_size"],
        fragment_length=config["fragment_length"],
        transition_oversampling=config["transition_oversampling"],
        initial_comparison_frac=config["initial_comparison_frac"],
        initial_epoch_multiplier=config["initial_epoch_multiplier"],
        custom_logger=logger,
        allow_variable_horizon=config.get("allow_variable_horizon", True),
        rng=config["seed"],
        query_schedule=config["query_schedule"],
        seed=config["seed"],
        device=venv.device,
    )
    result = dict(main.train(
        total_timesteps=config["total_timesteps"],
        total_comparisons=config["total_comparisons"],
    ))

    if not r_cfg["ensemble"]:
        reward_serialize.save_reward_net(
            os.path.join(run_dir, "checkpoints", "final", "reward_net"), reward_net
        )
    main.dataset.save(os.path.join(run_dir, "preferences.pkl"))
    if agent is not None:
        policy_serialize.save_policy(
            os.path.join(run_dir, "checkpoints", "final", "policy"), agent.policy
        )
        result["rollout"] = ingredients.eval_policy_stats(agent.policy.sample_fn(), venv, config)
    logger.dump(0)
    return result


if __name__ == "__main__":
    ex.run_cli()
