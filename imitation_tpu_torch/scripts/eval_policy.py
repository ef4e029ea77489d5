"""eval_policy: rollout statistics of a saved or scripted policy.

Port of ``imitation_tpu/scripts/eval_policy.py``: rolls out the configured
expert (``expert.policy_type`` / ``expert.loader_kwargs``), optionally mixed
with random actions (``explore_kwargs``), saves the rollouts
(``rollout_save_path``), optionally relabels the reported rewards with a
saved reward net (``reward_type`` / ``reward_path``) and returns
``rollout_stats``. ``videos=True`` raises: recording needs gymnasium's
render-capable envs, which the port does not have.

    python -m imitation_tpu_torch eval_policy with expert.policy_type=saved expert.loader_kwargs.path=<dir>
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from imitation_tpu_torch import make_generator
from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data import serialize
from imitation_tpu_torch.policies.exploration_wrapper import ExplorationWrapper
from imitation_tpu_torch.rewards import serialize as reward_serialize
from imitation_tpu_torch.scripts import ingredients
from imitation_tpu_torch.scripts.config import Experiment

DEFAULT_CONFIG: Dict[str, Any] = {
    **ingredients.ENV_DEFAULTS,
    "seed": 0,
    "log_root": os.path.join("output", "eval_policy"),
    "log_dir": None,
    "log_format_strs": ["stdout", "csv", "json"],
    "expert": {"policy_type": "scripted", "loader_kwargs": {}},
    "eval_n_timesteps": None,
    "eval_n_episodes": 50,
    "rollout_save_path": None,
    "reward_type": None,
    "reward_path": None,
    "explore_kwargs": None,  # {"switch_prob":..., "random_prob":...}
    "videos": False,
    "video_kwargs": {},  # {"single_video": bool, "fps": int, "episodes": int}
}

ex = Experiment("eval_policy", DEFAULT_CONFIG)
ex.named_config("fast", {
    "num_envs": 2, "max_episode_steps": 20, "eval_n_episodes": 2,
})

_EXPLORE_CHUNK = 128  # steps per collect of the exploration mixture


@ex.main
def eval_policy(config: Dict[str, Any], run_dir: str, logger) -> Dict[str, Any]:
    if config["videos"]:
        raise NotImplementedError(
            "videos=True records through util/video_wrapper.py, which needs gymnasium's "
            "render-capable envs; the port has none"
        )
    venv = ingredients.make_venv_from_config(config)
    policy_apply = ingredients.load_expert_policy(config, venv)

    explore_kwargs = config.get("explore_kwargs")
    sample_until = rollout_mod.make_sample_until(
        min_timesteps=config["eval_n_timesteps"],
        min_episodes=config["eval_n_episodes"],
    )
    if explore_kwargs:
        explorer = ExplorationWrapper(
            policy_apply, venv,
            random_prob=explore_kwargs.get("random_prob", 0.5),
            switch_prob=explore_kwargs.get("switch_prob", 0.5),
        )
        generator = make_generator(config["seed"], venv.device)
        env_state = venv.reset(generator)
        mode = explorer.initial_mode(generator)
        accum = rollout_mod.TrajectoryAccumulator(venv.num_envs)
        trajs = []
        while not sample_until(trajs):
            env_state, mode, chunk = explorer.collect(env_state, mode, _EXPLORE_CHUNK, generator)
            trajs.extend(accum.add_chunk(chunk))
    else:
        trajs = rollout_mod.generate_trajectories(policy_apply, venv, sample_until, rng=config["seed"])

    if config["rollout_save_path"]:
        serialize.save(config["rollout_save_path"], trajs)

    if config["reward_type"] is not None:
        fn = reward_serialize.load_reward(config["reward_type"], config["reward_path"], venv)
        relabeled = []
        for t in trajs:
            obs = np.asarray(t.obs)
            dones = np.zeros(len(t), np.float32)
            if t.terminal:
                dones[-1] = 1.0
            rews = fn(obs[:-1], t.acts, obs[1:], dones).astype(np.float64)
            relabeled.append(type(t)(obs=t.obs, acts=t.acts, infos=t.infos,
                                     terminal=t.terminal, rews=rews))
        trajs = relabeled

    stats = dict(rollout_mod.rollout_stats(trajs))
    for k, v in stats.items():
        logger.record(k, v)
    logger.dump(0)
    return stats


if __name__ == "__main__":
    ex.run_cli()
