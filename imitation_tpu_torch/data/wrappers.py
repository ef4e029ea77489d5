"""Host vector-env wrappers: transition buffering and rollout-info recording.

Port of ``imitation_tpu/data/wrappers.py``:

* ``BufferingWrapper`` records every transition stepped through a host
  vector env (``is_host``, e.g. ``native.CppVectorEnv``) and hands them out
  as trajectories or transitions; a reset before the samples were taken
  raises.
* ``RolloutInfoWrapper`` stashes a single env's whole episode (observations,
  rewards, monitor return) into ``info["rollout"]`` when it ends.

Device envs need neither: a rollout returns every transition it made.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data import types


class BufferingWrapper:
    """Saves the transitions stepped through a host vector env."""

    is_host = True

    def __init__(self, venv, error_on_premature_reset: bool = True):
        self.venv = venv
        self.error_on_premature_reset = error_on_premature_reset
        self._partial: List[List[Dict[str, np.ndarray]]] = []
        self._trajectories: List[types.TrajectoryWithRew] = []
        self._init_reset = False
        self._n_transitions: Optional[int] = None
        self._last_obs: Optional[np.ndarray] = None

    num_envs = property(lambda self: self.venv.num_envs)
    observation_space = property(lambda self: self.venv.observation_space)
    action_space = property(lambda self: self.venv.action_space)
    device = property(lambda self: self.venv.device)

    @property
    def n_transitions(self) -> Optional[int]:
        return self._n_transitions

    def reset(self, **kwargs) -> np.ndarray:
        if self._init_reset and self.error_on_premature_reset and self._n_transitions:
            raise RuntimeError("BufferingWrapper reset() before samples were accessed")
        self._init_reset = True
        self._n_transitions = 0
        self._trajectories = []
        self._partial = [[] for _ in range(self.venv.num_envs)]
        self._last_obs = self.venv.reset(**kwargs)
        return self._last_obs

    def _finish(self, i: int, terminal: bool) -> types.TrajectoryWithRew:
        steps, self._partial[i] = self._partial[i], []
        return types.TrajectoryWithRew(
            obs=np.stack([s["obs"] for s in steps] + [steps[-1]["next_obs"]]),
            acts=np.stack([s["acts"] for s in steps]),
            rews=np.stack([s["rews"] for s in steps]).astype(np.float64),
            infos=np.array([{} for _ in steps]),
            terminal=terminal,
        )

    def step(self, actions) -> dict:
        if not self._init_reset:
            raise RuntimeError("call reset() first")
        out = self.venv.step(actions)
        acts = np.asarray(actions)
        for i in range(self.venv.num_envs):
            self._partial[i].append(dict(obs=self._last_obs[i], acts=acts[i], rews=out["reward"][i],
                                         next_obs=out["terminal_obs"][i]))
            if out["terminated"][i] or out["truncated"][i]:
                self._trajectories.append(self._finish(i, bool(out["terminated"][i])))
        self._last_obs = out["obs"]
        self._n_transitions += self.venv.num_envs
        return out

    def pop_finished_trajectories(self) -> Sequence[types.TrajectoryWithRew]:
        out, self._trajectories = self._trajectories, []
        self._n_transitions -= sum(len(t) for t in out)
        return out

    def pop_trajectories(self) -> Sequence[types.TrajectoryWithRew]:
        """Pops every trajectory, the unfinished ones included (not terminal)."""
        finished = list(self.pop_finished_trajectories())
        for i in range(self.venv.num_envs):
            if self._partial[i]:
                finished.append(self._finish(i, terminal=False))
        self._n_transitions = 0
        return finished

    def pop_transitions(self) -> types.TransitionsWithRew:
        before = self._n_transitions
        transitions = rollout_mod.flatten_trajectories_with_rew(self.pop_trajectories())
        if len(transitions) != before:
            raise AssertionError(f"{len(transitions)} transitions popped, {before} buffered")
        return transitions


class RolloutInfoWrapper:
    """Wraps one env (``reset() -> (obs, info)``, ``step(a) -> (obs, rew,
    terminated, truncated, info)``) and puts its finished episode into
    ``info["rollout"]``."""

    def __init__(self, env):
        self.env = env
        self._obs: Optional[list] = None
        self._rews: Optional[list] = None

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kwargs):
        new_obs, info = self.env.reset(**kwargs)
        self._obs = [new_obs]
        self._rews = []
        return new_obs, info

    def step(self, action):
        obs, rew, terminated, truncated, info = self.env.step(action)
        self._obs.append(obs)
        self._rews.append(rew)
        if terminated or truncated:
            if "rollout" in info:
                raise ValueError("info already holds a 'rollout' entry")
            info["rollout"] = {
                "obs": np.stack(self._obs),
                "rews": np.stack(self._rews),
                "monitor_return": float(np.sum(self._rews)),
            }
        return obs, rew, terminated, truncated, info
