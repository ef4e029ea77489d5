"""Building blocks shared by the scripts (Sacred's "ingredients").

Port of ``imitation_tpu/scripts/ingredients.py``: the env (on the config's
``device``), the expert policy, the demonstrations and the final policy
evaluation. A policy here is a rollout closure ``(obs, generator) ->
(acts, aux)``, as ``data.rollout.generate_trajectories`` takes it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Sequence

from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data import serialize, types
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.policies import serialize as policy_serialize
from imitation_tpu_torch.testing import experts as scripted_experts

ENV_DEFAULTS = {
    "env_name": "CartPole-v1",
    "num_envs": 8,
    "max_episode_steps": None,
    # Extra kwargs for the env constructor.
    "env_make_kwargs": {},
    # None: CUDA (raising where there is none); "cpu" runs on the CPU.
    "device": None,
}

EVAL_DEFAULTS = {
    "n_episodes_eval": 50,
}

def make_venv_from_config(config: Dict[str, Any]) -> VectorEnv:
    """The env on ``config["device"]``: CUDA when it is None, raising where
    there is none (``VectorEnv`` resolves it with ``default_device``)."""
    return make_vec_env(
        config["env_name"],
        num_envs=config.get("num_envs", 8),
        max_episode_steps=config.get("max_episode_steps"),
        device=config.get("device"),
        **(config.get("env_make_kwargs") or {}),
    )


def load_expert_policy(config: Dict[str, Any], venv: VectorEnv):
    """The configured expert's rollout closure.

    ``expert.policy_type``: ``scripted`` (a closed-form controller),
    ``ppo`` / ``sac`` / ``saved`` (``loader_kwargs.path``: a
    Stable-Baselines3 ``model.zip``, a directory holding one, or a policy
    directory either package saved), ``ppo-huggingface`` /
    ``sac-huggingface`` (``loader_kwargs.env_name``; raise offline, see
    ``policies.serialize``), ``random`` or ``zero``.
    """
    expert_cfg = config.get("expert", {})
    policy_type = expert_cfg.get("policy_type", "scripted")
    if policy_type == "scripted":
        return scripted_experts.expert_for(config["env_name"])
    loader_kwargs = dict(expert_cfg.get("loader_kwargs", {}))
    return policy_serialize.load_policy(policy_type, venv, **loader_kwargs).sample_fn()


def get_expert_trajectories(
    config: Dict[str, Any], venv: VectorEnv
) -> Sequence[types.TrajectoryWithRew]:
    """The demonstrations: ``demonstrations.source`` ``local`` (loaded from
    ``demonstrations.path``: an ``.npz`` directory or a HuggingFace
    directory) or ``generated`` (rolled out by the configured expert)."""
    demo_cfg = config.get("demonstrations", {})
    source = demo_cfg.get("source", "generated")
    n_expert_demos = demo_cfg.get("n_expert_demos")
    if source == "local":
        path = demo_cfg["path"]
        if path is None:
            raise ValueError("demonstrations.source='local' requires demonstrations.path")
        if not os.path.exists(str(path)):
            raise FileNotFoundError(f"demonstrations.path {path!r} does not exist")
        trajs = serialize.load(path)
    elif source == "generated":
        apply_fn = load_expert_policy(config, venv)
        n = n_expert_demos or 10
        trajs = rollout_mod.generate_trajectories(
            apply_fn, venv, rollout_mod.make_min_episodes(n), rng=config.get("seed", 0)
        )
    else:
        raise ValueError(f"unknown demonstrations.source {source!r}")
    if n_expert_demos is not None:
        if len(trajs) < n_expert_demos:
            raise ValueError(
                f"Want to use n_expert_demos={n_expert_demos} trajectories, but "
                f"only {len(trajs)} are available.",
            )
        trajs = list(trajs)[:n_expert_demos]
    return trajs


def eval_policy_stats(policy_apply, venv: VectorEnv, config: Dict[str, Any]) -> Dict[str, float]:
    """``rollout_stats`` of ``n_episodes_eval`` episodes of the policy."""
    n_episodes = config.get("n_episodes_eval", EVAL_DEFAULTS["n_episodes_eval"])
    trajs = rollout_mod.generate_trajectories(
        policy_apply, venv, rollout_mod.make_min_episodes(n_episodes), rng=config.get("seed", 0) + 1
    )
    return dict(rollout_mod.rollout_stats(trajs))
