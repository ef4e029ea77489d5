"""Trajectory (de)serialization in the ``.npz`` directory format.

Port of the ``.npz`` path of ``imitation_tpu/data/serialize.py``: ``save``
writes ``<path>/trajectories.npz`` with arrays ``obs_i``, ``acts_i``,
``terminal_i`` and, when every trajectory has rewards, ``rews_i``, plus the
count ``n``; ``load`` reads it back, rewards as float64. A directory written
by either package loads in the other. ``infos`` are not stored. The
HuggingFace ``datasets`` format and the legacy formats are not ported.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from imitation_tpu_torch.data import types

NPZ_NAME = "trajectories.npz"


def save(path: str, trajectories: Sequence[types.Trajectory]) -> None:
    """Saves ``trajectories`` to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    has_rew = all(isinstance(t, types.TrajectoryWithRew) for t in trajectories)
    arrays = {}
    for i, t in enumerate(trajectories):
        arrays[f"obs_{i}"] = np.asarray(t.obs)
        arrays[f"acts_{i}"] = np.asarray(t.acts)
        arrays[f"terminal_{i}"] = np.asarray(t.terminal)
        if has_rew:
            arrays[f"rews_{i}"] = np.asarray(t.rews)
    arrays["n"] = np.asarray(len(trajectories))
    np.savez_compressed(os.path.join(path, NPZ_NAME), **arrays)


def load(path: str) -> Sequence[types.Trajectory]:
    """Loads the trajectories ``save`` wrote to the directory ``path``."""
    npz_path = os.path.join(path, NPZ_NAME)
    if not os.path.exists(npz_path):
        raise FileNotFoundError(f"no {NPZ_NAME} in {path!r}")
    out = []
    with np.load(npz_path, allow_pickle=False) as data:
        for i in range(int(data["n"])):
            kwargs = dict(
                obs=data[f"obs_{i}"],
                acts=data[f"acts_{i}"],
                infos=None,
                terminal=bool(data[f"terminal_{i}"]),
            )
            if f"rews_{i}" in data:
                out.append(types.TrajectoryWithRew(rews=data[f"rews_{i}"].astype(np.float64), **kwargs))
            else:
                out.append(types.Trajectory(**kwargs))
    return out
