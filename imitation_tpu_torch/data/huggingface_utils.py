"""Trajectories in the HuggingFace ``datasets`` on-disk format.

Port of ``imitation_tpu/data/huggingface_utils.py`` without ``datasets``:
``load_dataset_dir`` reads a directory ``Dataset.save_to_disk`` wrote
(``state.json`` naming its ``.arrow`` files, each an Arrow IPC stream read by
``data/arrow.py``), ``TrajectoryDatasetSequence`` views its table as a
sequence of trajectories, decoding each row when it is first asked for and
keeping it, and ``trajectories_to_dict`` gives the column dict the format
holds. The columns are ``obs`` and ``acts`` (lists of steps), ``infos``
(JSON strings), ``terminal`` and, when present, ``rews`` (float64).

``trajectories_to_dataset`` writes such a directory, as
``datasets.Dataset.from_dict(trajectories_to_dict(...)).save_to_disk(path)``
does: one shard ``data-00000-of-00001.arrow`` (one record batch, written by
``arrow.write_stream``), ``dataset_info.json`` with the ``features``
``datasets`` infers for the column dict (a numpy array of ``k`` axes becomes
``k`` nested ``List``s of its dtype, a list of strings ``List(string)``, a
bool ``Value(bool)``), the same features in the schema's ``huggingface``
metadata, and ``state.json``.
"""

from __future__ import annotations

import collections.abc
import hashlib
import json
import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from imitation_tpu_torch.data import arrow, types

STATE_JSON = "state.json"
DATASET_INFO = "dataset_info.json"
SHARD_NAME = "data-00000-of-00001.arrow"


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


def _column(values: List[Any]) -> Tuple[arrow.Array, Dict[str, Any]]:
    """The Arrow column of one entry of the column dict and its ``datasets``
    feature: numpy arrays as nested lists of their dtype, lists of strings,
    or bools."""
    first = values[0]
    if isinstance(first, (bool, np.bool_)):
        return arrow.numbers(np.asarray(values, np.bool_)), {"dtype": "bool", "_type": "Value"}
    if isinstance(first, (list, tuple)) and all(isinstance(s, str) for v in values for s in v):
        return (arrow.lists(arrow.strings([s for v in values for s in v]), [len(v) for v in values]),
                {"feature": {"dtype": "string", "_type": "Value"}, "_type": "List"})
    arrays = [np.asarray(v) for v in values]
    if arrays[0].dtype.kind not in "biuf" or arrays[0].ndim == 0:
        raise TypeError(f"no datasets feature for values of dtype {arrays[0].dtype} and shape {arrays[0].shape}")
    feature: Dict[str, Any] = {"dtype": arrays[0].dtype.name, "_type": "Value"}
    for _ in range(arrays[0].ndim):
        feature = {"feature": feature, "_type": "List"}
    return arrow.nested_lists(arrays), feature


def write_dataset_dir(path: str, columns: Dict[str, List[Any]]) -> None:
    """Writes the column dict ``columns`` (one entry per row in each) as the
    dataset directory ``path``."""
    if not columns or not all(len(v) for v in columns.values()):
        raise ValueError("a dataset directory needs at least one row")
    built = {name: _column(values) for name, values in columns.items()}
    features = {name: feature for name, (_, feature) in built.items()}
    data = arrow.write_stream([arrow.Field(name, col.type, True) for name, (col, _) in built.items()],
                              [col for col, _ in built.values()],
                              {"huggingface": json.dumps({"info": {"features": features}})})
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, SHARD_NAME), "wb") as f:
        f.write(data)
    info = {"citation": "", "description": "", "features": features, "homepage": "", "license": ""}
    state = {"_data_files": [{"filename": SHARD_NAME}],
             "_fingerprint": hashlib.sha256(data).hexdigest()[:16],
             "_format_columns": None, "_format_kwargs": {}, "_format_type": None,
             "_output_all_columns": False, "_split": None}
    for name, obj in ((DATASET_INFO, info), (STATE_JSON, state)):
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f, indent=2)


def trajectories_to_dataset(trajectories: Sequence[types.Trajectory], path: str) -> None:
    """Writes ``trajectories`` as the dataset directory ``path`` (the JAX
    package's ``trajectories_to_dataset`` followed by ``save_to_disk``)."""
    write_dataset_dir(path, trajectories_to_dict(trajectories))
