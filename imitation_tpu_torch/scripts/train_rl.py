"""train_rl: train a policy with PPO (or SAC), save rollouts and checkpoints.

Port of ``imitation_tpu/scripts/train_rl.py``: trains on the env's reward,
or on a saved learned reward (``reward_type`` / ``reward_path``, reward
transfer), saves policies every ``policy_save_interval`` env steps
(``checkpoints/<update>``), rollouts for use as demonstrations
(``rollouts/final``) and the final policy (``policies/final``), then
evaluates it.

    python -m imitation_tpu_torch train_rl with pendulum total_timesteps=4096
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict

import torch

from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data import serialize
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.policies import serialize as policy_serialize
from imitation_tpu_torch.rewards import serialize as reward_serialize
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
from imitation_tpu_torch.rl.sac import SAC, SACConfig
from imitation_tpu_torch.scripts import ingredients
from imitation_tpu_torch.scripts.config import Experiment

DEFAULT_CONFIG: Dict[str, Any] = {
    **ingredients.ENV_DEFAULTS,
    **ingredients.EVAL_DEFAULTS,
    "seed": 0,
    "log_root": os.path.join("output", "train_rl"),
    "log_dir": None,
    "log_format_strs": ["stdout", "csv", "json"],
    "total_timesteps": 100_000,
    "rl": {
        "algo": "ppo",
        "n_steps": 2048 // 8,
        "batch_size": 64,
        "n_epochs": 10,
        "learning_rate": 3e-4,
        "ent_coef": 0.0,
        "gamma": 0.99,
        "gae_lambda": 0.95,
    },
    # Reward transfer: train on a saved reward net instead of the env's.
    "reward_type": None,
    "reward_path": None,
    "normalize_reward": False,
    "rollout_save_n_timesteps": None,
    "rollout_save_n_episodes": 20,
    "policy_save_interval": 10_000,
    "policy_save_final": True,
    # Warm start: a saved policy directory to continue training from.
    "agent_path": None,
    "policy": {"hid_sizes": [32, 32], "normalize_features": False,
               "features": "flatten"},
}

ex = Experiment("train_rl", DEFAULT_CONFIG)
ex.named_config("fast", {
    "total_timesteps": 2048,
    "num_envs": 4,
    "max_episode_steps": 50,
    "n_episodes_eval": 3,
    "rollout_save_n_episodes": 3,
    "rl": {"n_steps": 32, "batch_size": 32, "n_epochs": 2},
})
ex.named_config("sac", {"rl": {"algo": "sac"}})
ex.named_config("pendulum", {"env_name": "Pendulum-v1"})
ex.named_config("cartpole", {"env_name": "CartPole-v1"})
# NatureCNN features for image observations of at least 36 x 36 pixels.
ex.named_config("cnn_policy", {"policy": {"features": "nature_cnn"}})


@ex.main
def train_rl(config: Dict[str, Any], run_dir: str, logger) -> Dict[str, Any]:
    venv = ingredients.make_venv_from_config(config)
    rl_cfg = config["rl"]

    reward_fn = None
    if config["reward_type"] is not None:
        apply, net = reward_serialize.load_reward_apply(
            config["reward_type"], config["reward_path"], device=venv.device
        )

        @torch.no_grad()
        def reward_fn(params, obs, acts, next_obs, dones):
            return apply(net, obs, acts, next_obs, dones)

        if config["normalize_reward"] and config["reward_type"] == "RewardNet_normalized":
            warnings.warn(
                "Applying normalization to already normalized reward function. "
                "Consider setting normalize_reward as False",
                RuntimeWarning,
            )

    if rl_cfg.get("algo", "ppo") == "sac":
        sac = SAC(venv, SACConfig(learning_rate=rl_cfg.get("learning_rate", 3e-4)), seed=config["seed"])
        state = sac.init_state()
        state = sac.learn(state, config["total_timesteps"], logger=logger)
        policy = sac.policy
    else:
        pol_cfg = config.get("policy", {})
        policy = ActorCriticPolicy(
            observation_space=venv.observation_space,
            action_space=venv.action_space,
            hid_sizes=tuple(pol_cfg.get("hid_sizes", (32, 32))),
            normalize_features=pol_cfg.get("normalize_features", False),
            features=pol_cfg.get("features", "flatten"),
        )
        batch = rl_cfg["n_steps"] * venv.num_envs
        ppo = PPO(
            venv,
            policy,
            PPOConfig(
                n_steps=rl_cfg["n_steps"],
                n_minibatches=max(1, batch // rl_cfg.get("batch_size", 64)),
                n_epochs=rl_cfg.get("n_epochs", 10),
                learning_rate=rl_cfg.get("learning_rate", 3e-4),
                ent_coef=rl_cfg.get("ent_coef", 0.0),
                gamma=rl_cfg.get("gamma", 0.99),
                gae_lambda=rl_cfg.get("gae_lambda", 0.95),
                normalize_rewards=config["normalize_reward"],
            ),
            reward_fn=reward_fn,
            seed=config["seed"],
        )
        state = ppo.init_state()
        if config.get("agent_path"):
            warm = policy_serialize.load_policy_from_path(config["agent_path"], device=venv.device)
            policy.load_state_dict(warm.state_dict())
        callback = None
        if config["policy_save_interval"] > 0:
            callback = policy_serialize.SavePolicyCallback(
                os.path.join(run_dir, "checkpoints"), policy,
                save_interval_updates=max(1, config["policy_save_interval"] // batch),
            )
        state = ppo.learn(state, config["total_timesteps"], callback=callback, logger=logger)

    policy_apply = policy.sample_fn()
    sample_until = rollout_mod.make_sample_until(
        min_timesteps=config["rollout_save_n_timesteps"],
        min_episodes=config["rollout_save_n_episodes"],
    )
    trajs = rollout_mod.generate_trajectories(policy_apply, venv, sample_until, rng=config["seed"])
    serialize.save(os.path.join(run_dir, "rollouts", "final"), trajs)

    if config["policy_save_final"]:
        policy_serialize.save_policy(os.path.join(run_dir, "policies", "final"), policy)

    stats = ingredients.eval_policy_stats(policy_apply, venv, config)
    for k, v in stats.items():
        logger.record(f"eval/{k}", v)
    logger.dump(int(state.timesteps))
    return stats


if __name__ == "__main__":
    ex.run_cli()
