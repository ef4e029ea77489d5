"""Algorithm base classes and demonstration handling.

Port of ``imitation_tpu/algorithms/base.py``:

* ``BaseImitationAlgorithm``: logger injection and the fixed-horizon safety
  check (variable-length episodes leak reward information through
  termination, so algorithms refuse them unless
  ``allow_variable_horizon=True``).
* ``DemonstrationAlgorithm``: the ``set_demonstrations`` / ``policy``
  interface.
* ``DemonstrationStore``: demonstrations normalised once into a
  device-resident ``TransitionBatch``, with epoch-shuffled minibatch index
  matrices drawn on the device (``epoch_indices``) and with-replacement
  minibatches (``sample``).

Demonstrations are trajectories (a list, or a lazily decoded
``huggingface_utils.TrajectoryDatasetSequence``), host transitions or a
``TransitionBatch``; observations may be ``DictObs``.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Iterable, Optional, Sequence, Union

import torch

from imitation_tpu_torch.data import rollout as rollout_mod
from imitation_tpu_torch.data import types
from imitation_tpu_torch.util.logger import HierarchicalLogger, configure

AnyDemonstrations = Union[
    Sequence[types.Trajectory], types.TransitionsMinimal, types.TransitionBatch
]


class BaseImitationAlgorithm(abc.ABC):
    """Base for all algorithms."""

    def __init__(
        self,
        *,
        custom_logger: Optional[HierarchicalLogger] = None,
        allow_variable_horizon: bool = False,
    ):
        self._logger = custom_logger or configure()
        self.allow_variable_horizon = allow_variable_horizon
        if allow_variable_horizon:
            self.logger.warn(
                "Running with `allow_variable_horizon` set to True. "
                "Some algorithms are biased towards shorter or longer "
                "episodes, which may significantly confound results. "
                "Additionally, even unbiased algorithms can exploit "
                "the information leak from the termination condition.",
            )
        self._horizon: Optional[int] = None

    @property
    def logger(self) -> HierarchicalLogger:
        return self._logger

    @logger.setter
    def logger(self, value: HierarchicalLogger) -> None:
        self._logger = value

    def _check_fixed_horizon(self, horizons: Iterable[int]) -> None:
        """Raises if episodes of varying length are seen."""
        if self.allow_variable_horizon:
            return
        horizons = set(horizons)
        if self._horizon is not None:
            horizons.add(self._horizon)
        if len(horizons) > 1:
            raise ValueError(
                f"Episodes of different length detected: {sorted(horizons)}. "
                "Variable horizon environments are discouraged -- "
                "termination conditions leak information about reward. "
                "If you are SURE you want to run imitation learning in a "
                "variable horizon setting, then please pass in the flag: "
                "`allow_variable_horizon=True`.",
            )
        elif len(horizons) == 1:
            self._horizon = horizons.pop()


class DemonstrationAlgorithm(BaseImitationAlgorithm):
    """Algorithm trained from demonstrations."""

    def __init__(
        self,
        *,
        demonstrations: Optional[AnyDemonstrations] = None,
        custom_logger: Optional[HierarchicalLogger] = None,
        allow_variable_horizon: bool = False,
    ):
        super().__init__(
            custom_logger=custom_logger,
            allow_variable_horizon=allow_variable_horizon,
        )
        if demonstrations is not None:
            self.set_demonstrations(demonstrations)

    @abc.abstractmethod
    def set_demonstrations(self, demonstrations: AnyDemonstrations) -> None:
        ...

    @property
    @abc.abstractmethod
    def policy(self):
        """The imitation policy produced by training."""


def demonstrations_to_batch(
    demonstrations: AnyDemonstrations, device: torch.device
) -> types.TransitionBatch:
    """Normalises trajectories, host transitions or a TransitionBatch to a
    batch on ``device``."""
    if isinstance(demonstrations, types.TransitionBatch):
        return demonstrations.to(device)
    if isinstance(demonstrations, types.TransitionsMinimal):
        return types.TransitionBatch.from_host(demonstrations).to(device)
    items = list(demonstrations)
    if not items:
        raise ValueError("Empty demonstrations.")
    if isinstance(items[0], types.Trajectory):
        flat = rollout_mod.flatten_trajectories(items)
        return types.TransitionBatch.from_host(flat).to(device)
    raise TypeError(f"`demonstrations` unsupported type: {type(items[0])}")


@dataclasses.dataclass
class DemonstrationStore:
    """Device-resident demonstrations."""

    batch: types.TransitionBatch

    @classmethod
    def from_demonstrations(
        cls, demonstrations: AnyDemonstrations, device: torch.device
    ) -> "DemonstrationStore":
        return cls(batch=demonstrations_to_batch(demonstrations, device))

    @property
    def num_samples(self) -> int:
        return self.batch.batch_size

    def epoch_indices(
        self, generator: torch.Generator, batch_size: int, drop_last: bool = True
    ) -> torch.Tensor:
        """``[n_batches, batch_size]`` shuffled row indices for one epoch, on
        the generator's device. Without ``drop_last`` a ragged last batch is
        padded by wrapping around to the start of the permutation."""
        n = self.num_samples
        if batch_size > n:
            raise ValueError(f"batch_size={batch_size} larger than dataset size {n}")
        perm = _permutation(n, generator)
        n_batches = n // batch_size
        if not drop_last and n % batch_size != 0:
            pad = (n_batches + 1) * batch_size - n
            perm = torch.cat([perm, perm[:pad]])
            n_batches += 1
        return perm[: n_batches * batch_size].reshape(n_batches, batch_size)

    def sample(self, generator: torch.Generator, batch_size: int) -> types.TransitionBatch:
        """A uniform with-replacement minibatch."""
        idx = torch.randint(0, self.num_samples, (batch_size,), generator=generator,
                            device=generator.device)
        return self.batch.take(idx)


def _permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """The shuffle of one demonstration epoch (tests substitute the JAX
    package's)."""
    return torch.randperm(n, generator=generator, device=generator.device)
