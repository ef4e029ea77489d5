"""Loss regularization with an adaptive coefficient.

Port of ``imitation_tpu/algorithms/regularization.py``:

* ``Regularizer``, with a ``create(...)`` factory, holds the coefficient
  ``lambda_`` and an optional updater of it.
* ``LpRegularizer`` adds ``lambda * sum |theta|^p`` to the loss;
  ``WeightDecayRegularizer`` adds ``lambda * sum theta^2 / 2``, whose gradient
  is the decay step.
* ``ConstantParamScaler`` keeps ``lambda``; ``IntervalParamScaler`` scales it
  when the validation/training loss ratio leaves a tolerable interval.

The reward trainer adds ``lambda_ * loss_penalty(params)`` over its reward
net's parameters to each update and calls ``update_params`` between
``train`` calls.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Iterable, Optional, Protocol

import torch

from imitation_tpu_torch.util.logger import HierarchicalLogger, configure


class LambdaUpdater(Protocol):
    """``(lambda, train_loss, val_loss) -> new lambda``."""

    def __call__(self, lambda_: float, train_loss: float, val_loss: float) -> float:
        ...


class ConstantParamScaler:
    def __call__(self, lambda_: float, train_loss: float, val_loss: float) -> float:
        return lambda_


class IntervalParamScaler:
    """Divides lambda by ``scaling_factor`` when val/train loss is above
    ``tolerable_interval``, multiplies it when below."""

    def __init__(self, scaling_factor: float, tolerable_interval: tuple):
        eps = 10 ** (-6)
        if not (eps < scaling_factor < 1 - eps):
            raise ValueError("scaling_factor must be in (0, 1) within numerical precision.")
        if len(tolerable_interval) != 2:
            raise ValueError("tolerable_interval must be a tuple of length 2.")
        if not (tolerable_interval[0] >= 0 and tolerable_interval[0] < tolerable_interval[1]):
            raise ValueError(
                "tolerable_interval must be a tuple whose first element "
                "is non-negative and is smaller than the second element.",
            )
        self.scaling_factor = scaling_factor
        self.tolerable_interval = tolerable_interval

    def __call__(self, lambda_: float, train_loss: float, val_loss: float) -> float:
        if val_loss is None or train_loss is None:
            raise ValueError("train_loss and val_loss must not be None")
        if lambda_ <= 0:
            raise ValueError("lambda_ must be strictly positive")
        if train_loss < 0 or val_loss < 0:
            raise ValueError("losses must be non-negative")
        eps = 10 ** (-6)
        if train_loss < eps:
            # No ratio: keep lambda if both losses vanish, else raise it.
            if val_loss < eps:
                return lambda_
            return lambda_ / self.scaling_factor
        val_to_train = val_loss / train_loss
        if val_to_train > self.tolerable_interval[1]:
            return lambda_ / self.scaling_factor
        if val_to_train < self.tolerable_interval[0]:
            return lambda_ * self.scaling_factor
        return lambda_


class Regularizer(abc.ABC):
    """A loss penalty with coefficient ``lambda_``, updated from the
    train/validation losses where ``lambda_updater`` and ``val_split`` are
    given."""

    def __init__(
        self,
        initial_lambda: float,
        lambda_updater: Optional[LambdaUpdater] = None,
        val_split: Optional[float] = None,
        logger: Optional[HierarchicalLogger] = None,
        optimizer: Any = None,
    ):
        if lambda_updater is None and val_split is not None:
            raise ValueError("If lambda_updater is None, val_split should be None too.")
        if lambda_updater is not None and val_split is None:
            raise ValueError("If lambda_updater is provided, val_split must be provided too.")
        if val_split is not None and (val_split <= 0 or val_split >= 1):
            raise ValueError(f"val_split = {val_split} must be in (0, 1)")
        if lambda_updater is None and initial_lambda == 0:
            raise ValueError("If lambda_updater is None, initial_lambda must be non-zero.")
        self.lambda_ = initial_lambda
        self.lambda_updater = lambda_updater
        self.val_split = val_split
        self.logger = logger or configure()
        self.logger.record("regularization_lambda", self.lambda_)

    @classmethod
    def create(cls, **kwargs) -> Callable[..., "Regularizer"]:
        """A factory ``(*, optimizer=None, logger=None) -> Regularizer``."""

        def factory(*, optimizer=None, logger=None):
            return cls(optimizer=optimizer, logger=logger, **kwargs)

        return factory

    @abc.abstractmethod
    def loss_penalty(self, params: Iterable[torch.Tensor]) -> torch.Tensor:
        """The scalar penalty over ``params`` (not scaled by lambda)."""

    def update_params(self, train_loss: float, val_loss: float) -> None:
        if self.lambda_updater is not None:
            self.lambda_ = self.lambda_updater(self.lambda_, train_loss, val_loss)
            self.logger.record("regularization_lambda", self.lambda_)


class LpRegularizer(Regularizer):
    """Penalty ``sum |theta|^p``."""

    def __init__(self, *args, p: int = 2, **kwargs):
        super().__init__(*args, **kwargs)
        if not isinstance(p, int) or p < 1:
            raise ValueError("p must be a positive integer")
        self.p = p

    def loss_penalty(self, params: Iterable[torch.Tensor]) -> torch.Tensor:
        return sum(torch.sum(torch.abs(p) ** self.p) for p in params)


class WeightDecayRegularizer(Regularizer):
    """Penalty ``sum theta^2 / 2``: its gradient, scaled by lambda, is the
    weight decay step."""

    def loss_penalty(self, params: Iterable[torch.Tensor]) -> torch.Tensor:
        return 0.5 * sum(torch.sum(torch.square(p)) for p in params)
