"""Trajectory (de)serialization.

Port of ``imitation_tpu/data/serialize.py``. ``save`` writes a HuggingFace
``datasets`` directory, as the JAX package's ``save`` does wherever
``datasets`` is installed, with the port's own writer
(``huggingface_utils.write_dataset_dir``, no ``datasets`` needed): columns
``obs``, ``acts``, ``infos`` (each step's info as JSON, ``{}`` where there
are none or it does not serialize), ``terminal`` and, when every trajectory
has rewards, ``rews``. ``_save_npz`` writes the ``.npz`` directory format the
JAX package falls back to without ``datasets`` (``<path>/trajectories.npz``
with arrays ``obs_i``, ``acts_i``, ``terminal_i`` and, when every trajectory
has rewards, ``rews_i``, plus the count ``n``; no ``infos``). ``load``
reads, as the JAX package's does:

* that ``.npz`` directory;
* a HuggingFace ``datasets`` directory (``dataset_info.json`` beside
  Arrow files: what ``save`` writes, and the repo's expert demos), through
  the port's own Arrow reader: a lazily decoded ``TrajectoryDatasetSequence``;
* the reference's legacy flat ``.npz`` (concatenated arrays split by
  ``indices``), with a ``DeprecationWarning``;
* the reference's legacy ``.pkl`` (a pickled list of trajectories, its
  classes mapped to the port's by name), refusing a git-lfs pointer;
  unpickling runs code, so load only files of a trusted source.

Rewards load as float64.
"""

from __future__ import annotations

import json
import os
import pickle
import warnings
from typing import Sequence

import numpy as np

from imitation_tpu_torch.data import huggingface_utils, types

NPZ_NAME = "trajectories.npz"


def _infos_to_strs(infos, length: int):
    if infos is None:
        infos = [{}] * length
    out = []
    for info in infos:
        try:
            out.append(json.dumps(info, default=str))
        except TypeError:
            out.append("{}")
    return out


def save(path: str, trajectories: Sequence[types.Trajectory]) -> None:
    """Saves ``trajectories`` as the HuggingFace dataset directory ``path``.
    A ``trajectories.npz`` left there by ``_save_npz`` is removed, since
    ``load`` would read it first."""
    has_rew = all(isinstance(t, types.TrajectoryWithRew) for t in trajectories)
    d = {
        "obs": [np.asarray(types.maybe_unwrap_dictobs(t.obs)) for t in trajectories],
        "acts": [np.asarray(t.acts) for t in trajectories],
        "infos": [_infos_to_strs(t.infos, len(t)) for t in trajectories],
        "terminal": [bool(t.terminal) for t in trajectories],
    }
    if has_rew:
        d["rews"] = [np.asarray(t.rews) for t in trajectories]
    huggingface_utils.write_dataset_dir(path, d)
    stale = os.path.join(path, NPZ_NAME)
    if os.path.exists(stale):
        os.remove(stale)


def _save_npz(path: str, trajectories: Sequence[types.Trajectory]) -> None:
    """Saves ``trajectories`` as the ``.npz`` directory ``path``."""
    os.makedirs(path, exist_ok=True)
    has_rew = all(isinstance(t, types.TrajectoryWithRew) for t in trajectories)
    arrays = {}
    for i, t in enumerate(trajectories):
        arrays[f"obs_{i}"] = np.asarray(types.maybe_unwrap_dictobs(t.obs))
        arrays[f"acts_{i}"] = np.asarray(t.acts)
        arrays[f"terminal_{i}"] = np.asarray(t.terminal)
        if has_rew:
            arrays[f"rews_{i}"] = np.asarray(t.rews)
    arrays["n"] = np.asarray(len(trajectories))
    np.savez_compressed(os.path.join(path, NPZ_NAME), **arrays)


def load(path: str) -> Sequence[types.Trajectory]:
    """Loads the trajectories at ``path`` in any of the formats above."""
    npz_path = os.path.join(path, NPZ_NAME)
    if os.path.exists(npz_path):
        return _load_npz(npz_path)
    if os.path.isdir(path) and os.path.exists(os.path.join(path, huggingface_utils.DATASET_INFO)):
        return huggingface_utils.TrajectoryDatasetSequence(huggingface_utils.load_dataset_dir(path))
    if path.endswith(".npz") and os.path.exists(path):
        warnings.warn("Loading legacy npz trajectory format", DeprecationWarning)
        with np.load(path, allow_pickle=True) as data:
            if "indices" in data.files:
                return _load_reference_npz(data)
        return _load_npz(path)
    if path.endswith(".pkl") and os.path.exists(path):
        warnings.warn("Loading legacy pickle trajectory format", DeprecationWarning)
        return _load_reference_pkl(path)
    raise FileNotFoundError(f"no trajectory data found at {path!r}")


def _trajectory(obs, acts, terminal, rews=None) -> types.Trajectory:
    kwargs = dict(obs=obs, acts=acts, infos=None, terminal=bool(terminal))
    if rews is None:
        return types.Trajectory(**kwargs)
    return types.TrajectoryWithRew(rews=np.asarray(rews).astype(np.float64), **kwargs)


def _load_npz(npz_path: str) -> Sequence[types.Trajectory]:
    with np.load(npz_path, allow_pickle=False) as data:
        return [_trajectory(data[f"obs_{i}"], data[f"acts_{i}"], data[f"terminal_{i}"],
                            data[f"rews_{i}"] if f"rews_{i}" in data else None)
                for i in range(int(data["n"]))]


def _load_reference_npz(data) -> Sequence[types.Trajectory]:
    """The reference's legacy flat format: ``obs``, ``acts`` (and ``rews``)
    concatenated over trajectories, split at ``indices``; each trajectory
    has one more observation than actions, so the i-th observation split
    falls ``i + 1`` rows later."""
    idx = np.asarray(data["indices"])
    obs = np.split(data["obs"], idx + np.arange(len(idx)) + 1)
    acts = np.split(data["acts"], idx)
    rews = np.split(data["rews"], idx) if "rews" in data.files else None
    terminal = np.asarray(data["terminal"])
    return [_trajectory(obs[i], acts[i], terminal[i], None if rews is None else rews[i])
            for i in range(len(terminal))]


class _FieldMapper(pickle.Unpickler):
    """Resolves the reference's trajectory classes to the port's by name."""

    def find_class(self, module, name):
        if name == "TrajectoryWithRew":
            return types.TrajectoryWithRew
        if name == "Trajectory":
            return types.Trajectory
        return super().find_class(module, name)


def _load_reference_pkl(path: str) -> Sequence[types.Trajectory]:
    with open(path, "rb") as f:
        if f.read(12).startswith(b"version http"):
            raise ValueError(
                f"{path!r} is a git-lfs pointer, not pickle data; "
                "run `git lfs pull` in the source repo first"
            )
        f.seek(0)
        return list(_FieldMapper(f).load())
