"""Trajectory and transition types.

Port of ``imitation_tpu/data/types.py``:

* **Host tier**: ``DictObs`` (a dict of arrays that behaves like an array
  over its first axis) and its helpers; ``Trajectory`` and
  ``TrajectoryWithRew``, frozen numpy dataclasses with the reference's
  validation (``len(obs) == len(acts) + 1``), equality and slicing; the flat
  ``TransitionsMinimal``, ``Transitions`` and ``TransitionsWithRew``, with
  indexing (a slice or an index array gives transitions, an integer a dict
  of one timestep); ``dataclass_quick_asdict`` and
  ``transitions_collate_fn``. Observations may be arrays or ``DictObs``.
* **Device tier**: ``TransitionBatch``, a struct of ``[B, ...]`` tensors
  (``obs`` and ``next_obs`` a dict of them for dict observations), with
  ``take`` (row gather), ``map`` and ``from_host``; ``TrajectoryBatch``,
  episodes padded to ``[B, T(+1), ...]`` tensors on an explicit device,
  with ``from_host`` (the last frame repeated into the padding), ``mask``
  and ``flatten``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from imitation_tpu_torch import Device, default_device


class DictObs:
    """A dict of arrays behaving like an array over its first axis:
    ``len``, integer and slice indexing applied to every value, ``shape``
    and ``dtype`` views, stacking and concatenation over the first axis."""

    def __init__(self, d: Mapping[str, np.ndarray]):
        if not isinstance(d, Mapping):
            raise TypeError(f"DictObs requires a mapping, got {type(d)}")
        self._d: Dict[str, np.ndarray] = {k: np.asarray(v) for k, v in d.items()}

    @property
    def unwrap(self) -> Dict[str, np.ndarray]:
        return dict(self._d)

    def get(self, key: str) -> np.ndarray:
        return self._d[key]

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def items(self):
        return self._d.items()

    def __len__(self) -> int:
        lens = {k: len(v) for k, v in self._d.items()}
        unique = set(lens.values())
        if len(unique) != 1:
            raise RuntimeError(f"observations of conflicting lengths: {lens}")
        return unique.pop()

    def __getitem__(self, idx) -> "DictObs":
        return DictObs({k: v[idx] for k, v in self._d.items()})

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other) -> bool:
        if not isinstance(other, DictObs):
            return False
        if self._d.keys() != other._d.keys():
            return False
        return all(np.array_equal(self._d[k], other._d[k]) for k in self._d)

    @property
    def shape(self) -> Dict[str, Tuple[int, ...]]:
        return {k: v.shape for k, v in self._d.items()}

    @property
    def dtype(self) -> Dict[str, np.dtype]:
        return {k: v.dtype for k, v in self._d.items()}

    def map_arrays(self, fn) -> "DictObs":
        return DictObs({k: fn(v) for k, v in self._d.items()})

    @staticmethod
    def _unravel(items: Iterable["DictObs"]) -> Dict[str, list]:
        items = list(items)
        if not items:
            raise ValueError("empty input")
        keys = items[0]._d.keys()
        for it in items:
            if it._d.keys() != keys:
                raise ValueError("DictObs keys must match to combine")
        return {k: [it._d[k] for it in items] for k in keys}

    @classmethod
    def stack(cls, items: Iterable["DictObs"]) -> "DictObs":
        return cls({k: np.stack(v) for k, v in cls._unravel(items).items()})

    @classmethod
    def concatenate(cls, items: Iterable["DictObs"]) -> "DictObs":
        return cls({k: np.concatenate(v) for k, v in cls._unravel(items).items()})

    def __repr__(self) -> str:
        return f"DictObs({self._d})"


Observation = Union[np.ndarray, DictObs]


def maybe_wrap_in_dictobs(obs) -> Observation:
    """Wraps a mapping in ``DictObs``; passes arrays through."""
    if isinstance(obs, Mapping):
        return DictObs(obs)
    return obs if isinstance(obs, DictObs) else np.asarray(obs)


def maybe_unwrap_dictobs(obs):
    """Unwraps ``DictObs`` into a plain dict; passes arrays through."""
    if isinstance(obs, DictObs):
        return obs.unwrap
    return obs


def assert_not_dictobs(x, msg: str = "Dict observations are not supported here"):
    if isinstance(x, (DictObs, dict)):
        raise ValueError(msg)
    return x


def stack_maybe_dictobs(obs_list: Sequence[Observation]) -> Observation:
    if isinstance(obs_list[0], DictObs):
        return DictObs.stack(obs_list)
    return np.stack(obs_list)


def concatenate_maybe_dictobs(obs_list: Sequence[Observation]) -> Observation:
    if isinstance(obs_list[0], DictObs):
        return DictObs.concatenate(obs_list)
    return np.concatenate(obs_list)


def dataclass_quick_asdict(obj) -> Dict[str, Any]:
    """Shallow ``asdict`` (no deep copy of the arrays)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@dataclasses.dataclass(frozen=True, eq=False)
class Trajectory:
    """Observations, actions, infos and a terminal flag for one episode."""

    obs: Observation
    acts: np.ndarray
    infos: Optional[np.ndarray]
    terminal: bool

    def __len__(self) -> int:
        return len(self.acts)

    def __post_init__(self):
        object.__setattr__(self, "acts", np.asarray(self.acts))
        object.__setattr__(self, "obs", maybe_wrap_in_dictobs(self.obs))
        if len(self.acts) == 0:
            raise ValueError("Degenerate trajectory: must have at least one action.")
        if len(self.obs) != len(self.acts) + 1:
            raise ValueError(
                "expected one more observation than actions: "
                f"{len(self.obs)} != {len(self.acts)} + 1",
            )
        if self.infos is not None and len(self.infos) != len(self.acts):
            raise ValueError(
                "infos when present must be present for each action: "
                f"{len(self.infos)} != {len(self.acts)}",
            )

    def __eq__(self, other) -> bool:
        if not isinstance(other, Trajectory):
            return False
        if dataclasses.fields(self) != dataclasses.fields(other):
            return False
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.name == "infos":
                a = a if a is not None else []
                b = b if b is not None else []
                if len(a) != len(b) or any(x != y for x, y in zip(a, b)):
                    return False
            elif isinstance(a, DictObs):
                if a != b:
                    return False
            elif isinstance(a, np.ndarray):
                if not np.array_equal(a, b):
                    return False
            elif a != b:
                return False
        return True

    def __getitem__(self, key):
        """A contiguous slice of the episode (``terminal`` only where it
        keeps the last step), or one timestep as a dict."""
        d = dataclass_quick_asdict(self)
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            if step != 1:
                raise ValueError("only contiguous slices with step 1 supported")
            d["obs"] = self.obs[start:stop + 1]
            d["acts"] = self.acts[start:stop]
            if d.get("infos") is not None:
                d["infos"] = d["infos"][start:stop]
            if "rews" in d:
                d["rews"] = d["rews"][start:stop]
            if stop < len(self):
                d["terminal"] = False
            return dataclasses.replace(self, **d)
        return {k: v[key] if v is not None and k != "terminal" else v for k, v in d.items()}

@dataclasses.dataclass(frozen=True, eq=False)
class TrajectoryWithRew(Trajectory):
    """A trajectory with per-step float rewards."""

    rews: np.ndarray

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "rews", np.asarray(self.rews))
        if self.rews.shape != (len(self.acts),):
            raise ValueError(
                "rewards must be 1D array, one entry for each action: "
                f"{self.rews.shape} != ({len(self.acts)},)",
            )
        if not np.issubdtype(self.rews.dtype, np.floating):
            raise ValueError(f"rewards dtype {self.rews.dtype} not a float")


@dataclasses.dataclass(frozen=True, eq=False)
class TransitionsMinimal:
    """A batch of (obs, acts, infos), the minimum BC needs. A slice or an
    index array gives transitions, an integer one timestep's dict."""

    obs: Observation
    acts: np.ndarray
    infos: Optional[np.ndarray]

    def __len__(self) -> int:
        return len(self.acts)

    def __post_init__(self):
        object.__setattr__(self, "obs", maybe_wrap_in_dictobs(self.obs))
        object.__setattr__(self, "acts", np.asarray(self.acts))
        if len(self.obs) != len(self.acts):
            raise ValueError(
                "obs and acts must have same number of timesteps: "
                f"{len(self.obs)} != {len(self.acts)}",
            )
        if self.infos is not None and len(self.infos) != len(self.obs):
            raise ValueError(
                "obs and infos must have same number of timesteps: "
                f"{len(self.obs)} != {len(self.infos)}",
            )

    def __getitem__(self, key):
        d = dataclass_quick_asdict(self)
        d_item = {k: (v[key] if v is not None else None) for k, v in d.items()}
        if isinstance(key, (slice, np.ndarray, list)):
            return dataclasses.replace(self, **d_item)
        if not isinstance(key, (int, np.integer)):
            raise TypeError(f"transitions are indexed by an int, a slice or an index array, not {type(key)}")
        d_item["obs"] = maybe_unwrap_dictobs(d_item["obs"])
        if "next_obs" in d_item:
            d_item["next_obs"] = maybe_unwrap_dictobs(d_item["next_obs"])
        return d_item


@dataclasses.dataclass(frozen=True, eq=False)
class Transitions(TransitionsMinimal):
    """obs/acts/next_obs/dones batch; ``dones`` is boolean."""

    next_obs: Observation
    dones: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "next_obs", maybe_wrap_in_dictobs(self.next_obs))
        object.__setattr__(self, "dones", np.asarray(self.dones))
        super().__post_init__()
        if len(self.next_obs) != len(self.obs):
            raise ValueError(
                "obs and next_obs must have same number of timesteps: "
                f"{len(self.obs)} != {len(self.next_obs)}",
            )
        if self.obs.shape != self.next_obs.shape:
            raise ValueError(
                "obs and next_obs must have the same shape: "
                f"{self.obs.shape} != {self.next_obs.shape}",
            )
        if not isinstance(self.obs, DictObs) and self.obs.dtype != self.next_obs.dtype:
            raise ValueError(
                "obs and next_obs must have the same dtype: "
                f"{self.obs.dtype} != {self.next_obs.dtype}",
            )
        if self.dones.shape != (len(self.acts),):
            raise ValueError(
                "dones must be 1D array, one entry for each timestep: "
                f"{self.dones.shape} != ({len(self.acts)},)",
            )
        if self.dones.dtype != bool:
            raise ValueError(f"dones must be boolean, not {self.dones.dtype}")


@dataclasses.dataclass(frozen=True, eq=False)
class TransitionsWithRew(Transitions):
    """Transitions with per-step float rewards."""

    rews: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "rews", np.asarray(self.rews))
        super().__post_init__()
        if self.rews.shape != (len(self.acts),):
            raise ValueError(
                "rewards must be 1D array, one entry for each timestep: "
                f"{self.rews.shape} != ({len(self.acts)},)",
            )
        if not np.issubdtype(self.rews.dtype, np.floating):
            raise ValueError(f"rewards dtype {self.rews.dtype} not a float")


def transitions_collate_fn(batch: Sequence[Mapping[str, Any]]) -> Dict[str, Any]:
    """Collates timestep dicts (``TransitionsMinimal[i]``) into one dict:
    arrays stacked, dict observations stacked per key, ``infos`` a list."""
    result = {}
    for k in batch[0].keys():
        vals = [b[k] for b in batch]
        if k == "infos":
            result[k] = list(vals)
        elif isinstance(vals[0], Mapping):
            result[k] = {kk: np.stack([v[kk] for v in vals]) for kk in vals[0]}
        else:
            result[k] = np.stack([np.asarray(v) for v in vals])
    return result


# 64-bit host arrays become 32-bit tensors, as ``jnp.asarray`` makes them.
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def _tensor(x: np.ndarray, dtype=None) -> torch.Tensor:
    x = np.asarray(x)
    x = x.astype(dtype or _NARROW.get(x.dtype, x.dtype))
    return torch.from_numpy(np.ascontiguousarray(x))


ObsTensor = Union[torch.Tensor, Dict[str, torch.Tensor]]


def map_obs(fn: Callable[[torch.Tensor], torch.Tensor], obs: ObsTensor) -> ObsTensor:
    """``fn`` of a tensor, or of each tensor of a dict observation."""
    if isinstance(obs, Mapping):
        return {k: fn(v) for k, v in obs.items()}
    return fn(obs)


def _host_obs(obs: Observation) -> ObsTensor:
    return map_obs(_tensor, {k: v for k, v in obs.items()} if isinstance(obs, DictObs) else obs)


@dataclasses.dataclass
class TransitionBatch:
    """A device-resident batch of transitions (struct of tensors).

    All fields share leading dim B; ``obs`` and ``next_obs`` are dicts of
    tensors for dict observations. ``dones`` is float32 {0., 1.}; ``rews``
    is zeros when the source had no rewards.
    """

    obs: ObsTensor
    acts: torch.Tensor
    next_obs: ObsTensor
    dones: torch.Tensor
    rews: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.acts.shape[0]

    def __len__(self) -> int:
        return self.batch_size

    def fields(self) -> Dict[str, ObsTensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def map(self, fn) -> "TransitionBatch":
        """``fn`` of every tensor (each of a dict observation's)."""
        return TransitionBatch(**{k: map_obs(fn, v) for k, v in self.fields().items()})

    @classmethod
    def from_host(cls, t: TransitionsMinimal) -> "TransitionBatch":
        """A CPU batch of host transitions: ``next_obs`` is ``obs`` and
        ``dones`` zeros where ``t`` has none, ``rews`` zeros where it has
        no rewards."""
        obs = _host_obs(t.obs)
        n = len(t)
        if isinstance(t, Transitions):
            next_obs, dones = _host_obs(t.next_obs), _tensor(t.dones, np.float32)
        else:
            next_obs, dones = obs, torch.zeros(n, dtype=torch.float32)
        if isinstance(t, TransitionsWithRew):
            rews = _tensor(t.rews, np.float32)
        else:
            rews = torch.zeros(n, dtype=torch.float32)
        return cls(obs=obs, acts=_tensor(t.acts), next_obs=next_obs, dones=dones, rews=rews)

    def take(self, idx: torch.Tensor) -> "TransitionBatch":
        return self.map(lambda x: x[idx.long()])

    def to(self, device: Any) -> "TransitionBatch":
        return self.map(lambda x: x.to(device))


def _pad_stack(arrays: Sequence[np.ndarray], total: int) -> np.ndarray:
    """``[B, total, ...]``: each array, then its last row repeated, so the
    padding stays in distribution."""
    first = np.asarray(arrays[0])
    out = np.zeros((len(arrays), total) + first.shape[1:], first.dtype)
    for i, a in enumerate(arrays):
        out[i, :len(a)] = a
        out[i, len(a):] = a[-1]
    return out


@dataclasses.dataclass
class TrajectoryBatch:
    """Episodes padded to one shape on one device: ``obs`` ``[B, T+1, ...]``
    (a dict of such tensors for dict observations), ``acts`` ``[B, T, ...]``,
    ``rews`` ``[B, T]`` float32 (0 past an episode's end), ``lengths`` ``[B]``
    int32 and ``terminal`` ``[B]`` bool. ``obs[b, :lengths[b] + 1]`` and
    ``acts[b, :lengths[b]]`` are valid; past them each repeats its last
    valid row."""

    obs: ObsTensor
    acts: torch.Tensor
    rews: torch.Tensor
    lengths: torch.Tensor
    terminal: torch.Tensor

    @property
    def max_length(self) -> int:
        return self.acts.shape[1]

    @property
    def batch_size(self) -> int:
        return self.acts.shape[0]

    @property
    def mask(self) -> torch.Tensor:
        """``[B, T]`` float32: 1 where ``t < lengths[b]``."""
        t = torch.arange(self.max_length, device=self.lengths.device)[None, :]
        return (t < self.lengths[:, None]).to(torch.float32)

    @classmethod
    def from_host(
        cls,
        trajs: Sequence[Trajectory],
        max_length: Optional[int] = None,
        device: Optional[Device] = None,
    ) -> "TrajectoryBatch":
        """Pads ``trajs`` to ``max_length`` steps (default: the longest) on
        ``device`` (CUDA unless the caller says ``"cpu"``)."""
        dev = default_device(device)
        if not trajs:
            raise ValueError("empty trajectory list")
        lengths = np.array([len(t) for t in trajs], dtype=np.int32)
        T = int(max_length if max_length is not None else lengths.max())
        if lengths.max() > T:
            raise ValueError(f"trajectory longer than max_length: {lengths.max()} > {T}")
        if isinstance(trajs[0].obs, DictObs):
            obs = DictObs({k: _pad_stack([t.obs.get(k) for t in trajs], T + 1) for k in trajs[0].obs.keys()})
        else:
            obs = _pad_stack([np.asarray(t.obs) for t in trajs], T + 1)
        acts = _pad_stack([t.acts for t in trajs], T)
        if isinstance(trajs[0], TrajectoryWithRew):
            rews = _pad_stack([t.rews for t in trajs], T).astype(np.float32)
        else:
            rews = np.zeros((len(trajs), T), np.float32)
        rews = rews * (np.arange(T)[None] < lengths[:, None])
        return cls(
            obs=map_obs(lambda x: x.to(dev), _host_obs(obs)),
            acts=_tensor(acts).to(dev),
            rews=_tensor(rews, np.float32).to(dev),
            lengths=torch.from_numpy(lengths).to(dev),
            terminal=torch.from_numpy(np.array([t.terminal for t in trajs], dtype=bool)).to(dev),
        )

    def flatten(self) -> TransitionBatch:
        """The valid timesteps as one ``TransitionBatch`` on the same
        device, episode by episode; ``dones`` marks the last step of a
        terminal episode."""
        idx_b, idx_t = torch.nonzero(self.mask.bool(), as_tuple=True)
        dones = (idx_t == self.lengths[idx_b].long() - 1) & self.terminal[idx_b]
        return TransitionBatch(
            obs=map_obs(lambda x: x[idx_b, idx_t], self.obs),
            acts=self.acts[idx_b, idx_t],
            next_obs=map_obs(lambda x: x[idx_b, idx_t + 1], self.obs),
            dones=dones.to(torch.float32),
            rews=self.rews[idx_b, idx_t],
        )
