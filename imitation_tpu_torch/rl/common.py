"""Shared RL infrastructure: train state, the optimizer, diagnostics.

Port of ``imitation_tpu/rl/common.py``. The JAX package carries parameters
and optimizer state in a pure pytree; here the policy ``nn.Module`` owns its
parameters and the optimizer updates them in place, so ``RLState`` holds the
module and optimizer objects and the host-side counters.

``make_optimizer`` reproduces the JAX package's optax chain exactly:
``clip_by_global_norm(max_norm)`` (scale by ``max_norm/||g||`` only when
``||g|| >= max_norm``, with no epsilon) followed by ``adam``, with optax's
order of operations, so parity with the JAX learners is tight. Its learning
rate is a constant or a schedule of the update count (``linear_schedule``,
``optax.linear_schedule``'s values).

Over data-parallel ranks a learner reduces the gradients over the ranks
(``parallel.distributed.all_reduce_grads_``) before ``Adam.step``, which
clips by the global norm of what it reads: clipping each rank's gradients
first would give another step. Where parameters are tp-split
(``parallel.mesh.shard_params_tp``) each rank holds a block of their
gradients, and the norm is that of the whole gradient, as optax computes
it: the split blocks' squares summed over the tp ranks, the replicated
parameters' counted once (``params_global_norm``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from imitation_tpu_torch.envs.vector import VecEnvState
from imitation_tpu_torch.parallel import distributed

# Relabelling reward function over a batch of transitions:
# (reward_params, obs, acts, next_obs, dones) -> rews. ``reward_params`` is
# whatever the function reads (e.g. the reward-net module); None for the
# ground-truth reward.
RelabelRewardFn = Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class RewNormState:
    """Running statistics for reward normalization (SB3 VecNormalize)."""

    ret: torch.Tensor  # [B] discounted return accumulator
    var: torch.Tensor  # scalar running variance of returns
    mean: torch.Tensor  # scalar running mean of returns
    count: torch.Tensor  # scalar sample count


@dataclasses.dataclass
class RLState:
    """Carried state of an on-policy learner."""

    policy: torch.nn.Module
    optimizer: "Adam"
    env_state: Optional[VecEnvState]
    generator: torch.Generator
    timesteps: int = 0  # total env steps taken
    n_updates: int = 0
    reward_norm: Optional[RewNormState] = None
    # The data-parallel mesh the state is split over (parallel.mesh.
    # shard_rl_state): env_state then holds this rank's env rows.
    mesh: Optional[Any] = None

    def replace(self, **changes) -> "RLState":
        return dataclasses.replace(self, **changes)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def params_global_norm(params: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``global_norm`` of the whole of ``tensors`` (one per parameter of
    ``params``, e.g. their gradients): where a parameter is tp-split its
    tensor is this rank's block, whose squares are summed over the tp ranks
    in rank order (a collective) before they join the replicated ones'."""
    tensors = list(tensors)
    split = [t for p, t in zip(params, tensors) if getattr(p, "tp_mesh", None) is not None]
    if not split:
        return global_norm(tensors)
    mesh = next(p.tp_mesh for p in params if getattr(p, "tp_mesh", None) is not None)
    sq = torch.stack([torch.sum(t * t) for t in split]).sum().reshape(1)
    distributed.all_reduce_([sq], mesh, axis="tp")
    whole = [t for p, t in zip(params, tensors) if getattr(p, "tp_mesh", None) is None]
    return torch.sqrt(sum(torch.sum(t * t) for t in whole) + sq[0])


# A learning-rate schedule: the rate of an update, from the number of
# updates before it (optax's ``count``, 0 for the first).
Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: ``init_value`` at count 0, falling linearly
    to ``end_value`` at ``transition_steps`` and staying there, computed in
    float32 as optax computes it."""
    f32 = np.float32

    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return float(f32(init_value))
        frac = f32(1) - f32(min(max(count, 0), transition_steps)) / f32(transition_steps)
        return float(f32(init_value - end_value) * frac + f32(end_value))

    return schedule


class Adam(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, b1, b2, eps))``,
    or with ``weight_decay`` ``optax.adamw(lr, b1, b2, eps, weight_decay)``:
    the decay ``weight_decay * p`` is added to Adam's direction before the
    learning rate scales it, for every parameter, biases included.

    ``lr`` is a float or a ``Schedule``. ``step()`` reads ``p.grad`` of every
    parameter, applies the update in place and returns the global norm of
    the gradients before clipping (of the whole gradient where parameters
    are tp-split: ``params_global_norm``). It never waits for the device.
    """

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        lr: Union[float, Schedule],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        max_grad_norm: Optional[float] = None,
        weight_decay: float = 0.0,
    ):
        self.schedule = lr if callable(lr) else None
        super().__init__(list(params), dict(lr=0.0 if callable(lr) else lr, b1=b1, b2=b2, eps=eps))
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        self.count = 0

    def __getstate__(self) -> Dict[str, Any]:
        """``torch.optim.Optimizer``'s state plus this class's own
        attributes, so that a copy (``copy.deepcopy``) steps as the
        original does."""
        state = super().__getstate__()
        state.update(schedule=self.schedule, max_grad_norm=self.max_grad_norm,
                     weight_decay=self.weight_decay, count=self.count)
        return state

    @property
    def learning_rate(self) -> float:
        """The rate the next ``step()`` applies."""
        if self.schedule is not None:
            return self.schedule(self.count)
        return self.param_groups[0]["lr"]

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("closure is not supported")
        (group,) = self.param_groups
        params = group["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        norm = params_global_norm(params, grads)
        if self.max_grad_norm is not None:
            trigger = norm < self.max_grad_norm
            grads = [torch.where(trigger, g, (g / norm) * self.max_grad_norm) for g in grads]
        lr = self.learning_rate
        self.count += 1
        b1, b2 = group["b1"], group["b2"]
        # optax computes the bias corrections 1 - b**count in float32.
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        # mu = (1-b1)*g + b1*mu ; nu = (1-b2)*(g*g) + b2*nu
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        # p += -lr * ((mu/bc1) / (sqrt(nu/bc2) + eps) + weight_decay * p)
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        return norm

    def step_masked(self) -> None:
        """An update whose gradients are all masked to zero, as optax applies
        one: the count advances, and the parameters move only by moments
        that earlier steps left (none before the first real step, so then
        nothing is computed)."""
        (group,) = self.param_groups
        if any(self.state[p] for p in group["params"]):
            for p in group["params"]:
                p.grad = None  # step() reads a missing gradient as zeros
            self.step()
        else:
            self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        """``torch.optim.Optimizer.state_dict`` plus the update count."""
        state = super().state_dict()
        state["count"] = self.count
        return state

    def load_state_dict(self, state_dict: Mapping[str, Any]) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    learning_rate: Union[float, Schedule],
    max_grad_norm: Optional[float] = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Adam:
    return Adam(params, learning_rate, b1=b1, b2=b2, eps=eps, max_grad_norm=max_grad_norm)


def metrics_to_host(metrics: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copies a dict of same-shaped device tensors to numpy in one transfer."""
    if not metrics:
        return {}
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float() for k in keys]).cpu().numpy()
    return dict(zip(keys, stacked))


def explained_variance(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    var_y = y_true.var(unbiased=False)
    return 1.0 - (y_true - y_pred).var(unbiased=False) / (var_y + 1e-8)

