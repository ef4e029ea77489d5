"""Trajectories in the HuggingFace ``datasets`` on-disk format.

Port of ``imitation_tpu/data/huggingface_utils.py`` without ``datasets``:
``load_dataset_dir`` reads a directory ``Dataset.save_to_disk`` wrote
(``state.json`` naming its ``.arrow`` files, each an Arrow IPC stream read by
``data/arrow.py``), ``TrajectoryDatasetSequence`` views its table as a
sequence of trajectories, decoding each row when it is first asked for and
keeping it, and ``trajectories_to_dict`` gives the column dict the format
holds. The columns are ``obs`` and ``acts`` (lists of steps), ``infos``
(JSON strings), ``terminal`` and, when present, ``rews`` (float64).
"""

from __future__ import annotations

import collections.abc
import json
import os
from typing import Any, Dict, List, Sequence

import numpy as np

from imitation_tpu_torch.data import arrow, types

STATE_JSON = "state.json"
DATASET_INFO = "dataset_info.json"


def load_dataset_dir(path: str) -> arrow.Table:
    """The table of the dataset directory ``path``: its ``state.json``'s
    data files, in order."""
    with open(os.path.join(path, STATE_JSON)) as f:
        files = [d["filename"] for d in json.load(f)["_data_files"]]
    return arrow.concat_tables([arrow.read_file(os.path.join(path, name)) for name in files])


class TrajectoryDatasetSequence(collections.abc.Sequence):
    """A ``Sequence[Trajectory]`` view of a dataset's table. Rows are
    decoded lazily and cached; observations and actions are views of the
    table's buffers."""

    def __init__(self, table: arrow.Table):
        self._table = table
        self._cache: Dict[int, types.Trajectory] = {}
        self._has_rew = "rews" in table.column_names

    def __len__(self) -> int:
        return len(self._table)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(len(self)))]
        if not -len(self) <= idx < len(self):
            raise IndexError(f"trajectory {idx} of {len(self)}")
        idx = int(idx) % len(self)
        if idx not in self._cache:
            self._cache[idx] = self._decode({name: col.value(idx) for name, col in self._table.columns.items()})
        return self._cache[idx]

    def _decode(self, row: Dict[str, Any]) -> types.Trajectory:
        infos = None
        if row.get("infos") is not None:
            try:
                infos = np.array([json.loads(s) for s in row["infos"]])
            except (TypeError, json.JSONDecodeError):
                infos = None
        kwargs = dict(
            obs=np.asarray(row["obs"]),
            acts=np.asarray(row["acts"]),
            infos=infos,
            terminal=bool(row["terminal"]),
        )
        if self._has_rew:
            return types.TrajectoryWithRew(rews=np.asarray(row["rews"], np.float64), **kwargs)
        return types.Trajectory(**kwargs)

    @property
    def table(self) -> arrow.Table:
        return self._table


def trajectories_to_dict(trajectories: Sequence[types.Trajectory]) -> Dict[str, List[Any]]:
    """The HuggingFace column dict of ``trajectories`` (``rews`` when every
    trajectory has rewards; infos as JSON, ``{}`` where there are none)."""
    has_rew = all(isinstance(t, types.TrajectoryWithRew) for t in trajectories)
    d: Dict[str, List[Any]] = {
        "obs": [np.asarray(types.maybe_unwrap_dictobs(t.obs)) for t in trajectories],
        "acts": [np.asarray(t.acts) for t in trajectories],
        "infos": [
            [json.dumps(i, default=str) for i in (t.infos if t.infos is not None else [{}] * len(t))]
            for t in trajectories
        ],
        "terminal": [bool(t.terminal) for t in trajectories],
    }
    if has_rew:
        d["rews"] = [np.asarray(t.rews) for t in trajectories]
    return d
