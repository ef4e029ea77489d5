"""train_adversarial: the ``gail`` and ``airl`` commands.

Port of ``imitation_tpu/scripts/train_adversarial.py``: trains GAIL or AIRL
from demonstrations with a PPO generator (or SAC, ``with sac``), saves
``reward_train``, ``reward_test`` and ``gen_policy`` under
``checkpoints/<round>`` every ``checkpoint_interval`` rounds and under
``checkpoints/final``, and evaluates the final policy (``imit_stats``).

    python -m imitation_tpu_torch train_adversarial gail with gail_cartpole
"""

from __future__ import annotations

import os
from typing import Any, Dict

from imitation_tpu_torch.algorithms.adversarial.airl import AIRL
from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.policies import serialize as policy_serialize
from imitation_tpu_torch.rewards import serialize as reward_serialize
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet, BasicShapedRewardNet
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.rl.sac import SAC, SACConfig, SACPolicy
from imitation_tpu_torch.scripts import ingredients
from imitation_tpu_torch.scripts.config import Experiment
from imitation_tpu_torch.scripts.tuned_hps import register_tuned_configs

DEFAULT_CONFIG: Dict[str, Any] = {
    **ingredients.ENV_DEFAULTS,
    **ingredients.EVAL_DEFAULTS,
    "seed": 0,
    "log_root": os.path.join("output", "train_adversarial"),
    "log_dir": None,
    "log_format_strs": ["stdout", "csv", "json"],
    "demonstrations": {"source": "generated", "n_expert_demos": 10, "path": None},
    "expert": {"policy_type": "scripted", "loader_kwargs": {}},
    "total_timesteps": 100_000,
    "checkpoint_interval": 0,  # rounds between checkpoints; 0 = final only
    "algorithm_kwargs": {
        "demo_batch_size": 1024,
        "n_disc_updates_per_round": 4,
    },
    "rl": {
        "n_steps": 256,
        "batch_size": 64,
        "n_epochs": 5,
        "learning_rate": 3e-4,
        "ent_coef": 0.0,
        "gamma": 0.99,
        "gae_lambda": 0.95,
        "clip_range": 0.2,
        "vf_coef": 0.5,
        "max_grad_norm": 0.5,
        # Host envs only: the CLI's envs are device envs, where PPO and SAC
        # raise when it is set.
        "overlap_collection": False,
    },
    "policy": {"hid_sizes": [32, 32], "normalize_features": False},
    "reward": {"normalize_input": False},
    # Warm start: a saved generator policy directory.
    "agent_path": None,
}

ex = Experiment("train_adversarial", DEFAULT_CONFIG)
ex.named_config("fast", {
    "num_envs": 2,
    "max_episode_steps": 20,
    "n_episodes_eval": 2,
    "total_timesteps": 256,
    "demonstrations": {"n_expert_demos": 2},
    "algorithm_kwargs": {"demo_batch_size": 16, "n_disc_updates_per_round": 2},
    "rl": {"n_steps": 16, "batch_size": 16, "n_epochs": 1},
})
# A SAC generator (continuous actions only); its replay batches are
# relabelled by the discriminator's reward at sample time.
ex.named_config("sac", {"rl": {"algo": "sac"}})


def _train(algo_cls, config: Dict[str, Any], run_dir: str, logger) -> Dict[str, Any]:
    venv = ingredients.make_venv_from_config(config)
    demos = ingredients.get_expert_trajectories(config, venv)
    rl_cfg = config["rl"]
    gen_algo = None
    if rl_cfg.get("algo", "ppo") == "sac":
        gen_algo = SAC(
            venv,
            SACConfig(
                learning_rate=rl_cfg["learning_rate"],
                train_freq=rl_cfg.get("train_freq", rl_cfg["n_steps"]),
                batch_size=rl_cfg["batch_size"],
                learning_starts=rl_cfg.get("learning_starts", 100),
                overlap_collection=rl_cfg.get("overlap_collection", False),
            ),
            seed=config["seed"],
        )
    batch = rl_cfg["n_steps"] * venv.num_envs
    gen_config = PPOConfig(
        n_steps=rl_cfg["n_steps"],
        n_minibatches=max(1, batch // rl_cfg["batch_size"]),
        n_epochs=rl_cfg["n_epochs"],
        learning_rate=rl_cfg["learning_rate"],
        ent_coef=rl_cfg["ent_coef"],
        gamma=rl_cfg.get("gamma", 0.99),
        gae_lambda=rl_cfg.get("gae_lambda", 0.95),
        clip_range=rl_cfg.get("clip_range", 0.2),
        vf_coef=rl_cfg.get("vf_coef", 0.5),
        max_grad_norm=rl_cfg.get("max_grad_norm", 0.5),
        overlap_collection=rl_cfg.get("overlap_collection", False),
    )
    pol_cfg = config.get("policy", {})
    policy = ActorCriticPolicy(
        observation_space=venv.observation_space,
        action_space=venv.action_space,
        hid_sizes=tuple(pol_cfg.get("hid_sizes", (32, 32))),
        normalize_features=pol_cfg.get("normalize_features", False),
    )
    rew_cfg = config.get("reward", {})
    net_cls = BasicRewardNet if algo_cls is GAIL else BasicShapedRewardNet
    reward_net = net_cls(
        venv.observation_space,
        venv.action_space,
        normalize_input=rew_cfg.get("normalize_input", False),
    )
    trainer = algo_cls(
        demonstrations=demos,
        venv=venv,
        gen_algo=gen_algo,
        gen_config=gen_config,
        policy=None if gen_algo is not None else policy,
        reward_net=reward_net,
        custom_logger=logger,
        allow_variable_horizon=config.get("allow_variable_horizon", True),
        seed=config["seed"],
        **config["algorithm_kwargs"],
    )
    if config.get("agent_path"):
        warm = policy_serialize.load_policy_from_path(config["agent_path"], device=venv.device)
        trainer.warm_start_generator(
            warm.actor.state_dict() if isinstance(warm, SACPolicy) else warm.state_dict()
        )

    # The input normalizer's statistics are among the saved weights, so the
    # loader must rebuild the net with it.
    net_kwargs = {"normalize_input": True} if rew_cfg.get("normalize_input", False) else None

    def save_checkpoint(tag: str):
        ckpt = os.path.join(run_dir, "checkpoints", tag)
        for name in ("reward_train", "reward_test"):
            reward_serialize.save_reward_net(
                os.path.join(ckpt, name), trainer.reward_net, net_kwargs=net_kwargs
            )
        policy_serialize.save_policy(os.path.join(ckpt, "gen_policy"), trainer.policy)

    interval = config["checkpoint_interval"]
    callback = None
    if interval > 0:
        callback = lambda r: save_checkpoint(f"{r:05d}") if r % interval == 0 else None
    trainer.train(config["total_timesteps"], callback=callback)
    save_checkpoint("final")
    stats = ingredients.eval_policy_stats(trainer.policy.sample_fn(), venv, config)
    for k, v in stats.items():
        logger.record(f"imit_stats/{k}", v)
    logger.dump(0)
    return {"imit_stats": stats}


@ex.command("gail")
def gail_cmd(config, run_dir, logger):
    return _train(GAIL, config, run_dir, logger)


@ex.command("airl")
def airl_cmd(config, run_dir, logger):
    return _train(AIRL, config, run_dir, logger)


register_tuned_configs(ex)


if __name__ == "__main__":
    ex.run_cli()
