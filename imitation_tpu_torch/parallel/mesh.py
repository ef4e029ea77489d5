"""The ('dp', 'tp') mesh over the process group, and where each learner's
state lives on it.

Port of ``imitation_tpu/parallel/mesh.py``. The JAX contract holds:
sharding changes where rows live, never the result. Every rank builds the
same full state from the same seed; placing it keeps, on each rank, its
block of the rows that are split over ``dp`` and the whole of everything
else, and marks the state with the mesh so that the learners run their
collectives:

* ``shard_rl_state``: the env batch (and the per-env return accumulator of
  reward normalization) split over ``dp``; the policy and its optimizer
  replicated. PPO steps the rank's env columns, runs GAE (B1) on them,
  gathers the rollout once per round, computes the loss of its share of
  each global minibatch and averages the gradients over the ranks before
  ``Adam.step`` clips them.
* ``shard_adversarial_trainer``: the generator as above; the discriminator,
  the replay ring and the demo batch replicated. The generator's
  transitions are gathered before the ring stores them, so every rank's
  ring, and its discriminator step (B2), is the one-process one.
* ``shard_sac_state``: the env batch and the replay ring split over
  ``dp``. A ring row stays on the rank that stepped its env (row ``g``
  holds env column ``g % num_envs``), so a store moves nothing; a sample
  draws global indices and the owners send the rows.
* ``shard_preference_comparisons``: the reward trainer's batches split on
  their sample axis (axis 1 of an ensemble's bagged batch); the agent as
  above; the dataset, fragments and trajectory sampling replicated.

Tensor parallelism (``tp > 1``: the dense layers' output columns split
over ranks, ``shard_params_tp``) is not ported: ``make_mesh`` and
``shard_params_tp`` raise ``NotImplementedError`` for it. At ``tp = 1``,
every configuration the JAX package runs outside two 2x2 tests, the
parameters are replicated, so the JAX helpers' ``tp_params`` switch (tp
placement or replication) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from imitation_tpu_torch.parallel import distributed

_TP_NOT_PORTED = (
    "tensor parallelism (tp > 1) is not ported yet (ROADMAP A11, item 'tp': the column "
    "split of dense layers and its collectives); use tp=1"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` data-parallel ranks (processes, one device each) by ``tp``;
    ``rank`` is this process's index along ``dp``. ``distributed`` is False
    for a mesh made without a process group (one process, no collective)."""

    dp: int
    tp: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    distributed: bool = False

    @property
    def shape(self):
        return {"dp": self.dp, "tp": self.tp}

    def rows(self, n: int) -> slice:
        """This rank's block of ``n`` rows split over ``dp``."""
        if n % self.dp != 0:
            raise ValueError(f"{n} rows not divisible by dp={self.dp}")
        b = n // self.dp
        return slice(self.rank * b, (self.rank + 1) * b)


def make_mesh(dp: Optional[int] = None, tp: int = 1, device: Optional[Any] = None) -> Mesh:
    """The ('dp', 'tp') mesh over the process group's ranks (one process and
    no collectives without a group). ``device`` defaults to the one
    ``distributed.initialize`` gave this rank."""
    n = distributed.process_count()
    if dp is None:
        if n % tp != 0:
            raise ValueError(f"{n} devices (one per process) not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices (one per process)")
    if tp > 1:
        raise NotImplementedError(_TP_NOT_PORTED)
    dev = torch.device(device) if device is not None else distributed.local_device()
    return Mesh(dp=dp, tp=tp, rank=distributed.process_index(), device=dev,
                distributed=dist.is_initialized())


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Rows of ``axis`` split over the mesh's ``dp`` ranks in blocks."""

    mesh: Mesh
    axis: int = 0


def batch_sharding(mesh: Mesh, axis: int = 0) -> BatchSharding:
    """Sharding for tensors whose ``axis`` (the leading one by default) is
    the batch."""
    return BatchSharding(mesh, axis)


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over every tensor of a tree of dicts, lists, tuples and
    dataclasses; other leaves (generators, numbers, modules) unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def shard_batch_tree(tree: Any, mesh: Mesh) -> Any:
    """Every tensor whose leading dim divides by ``dp`` keeps this rank's
    row block; others (and scalars) stay whole."""

    def place(x):
        if x.dim() >= 1 and x.shape[0] % mesh.dp == 0 and x.shape[0] >= mesh.dp:
            return x[mesh.rows(x.shape[0])].clone()
        return x

    return tree_map(place, tree)


def replicate_tree(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's value of every tensor on every rank, in place (a module's
    parameters and buffers, an optimizer's state included)."""
    if distributed._single(mesh):
        return tree
    tensors = []
    _collect_tensors(tree, tensors)
    for t in tensors:
        dist.broadcast(t.data, src=0)
    return tree


def _collect_tensors(tree: Any, out: list) -> None:
    if isinstance(tree, nn.Module):
        out.extend(tree.parameters())
        out.extend(tree.buffers())
    elif isinstance(tree, torch.optim.Optimizer):
        for state in tree.state.values():
            out.extend(v for v in state.values() if isinstance(v, torch.Tensor))
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _collect_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect_tensors(v, out)


def shard_params_tp(params: Any, mesh: Mesh) -> Any:
    """Tensor-parallel placement of parameters: replication at ``tp = 1``;
    ``tp > 1`` is not ported (module docstring)."""
    if mesh.tp > 1:
        raise NotImplementedError(_TP_NOT_PORTED)
    return replicate_tree(params, mesh)


def _check_envs(num_envs: int, mesh: Mesh) -> None:
    if num_envs % mesh.dp != 0:
        raise ValueError(f"num_envs={num_envs} not divisible by dp={mesh.dp}")


def shard_rl_state(state: Any, mesh: Mesh) -> Any:
    """An ``RLState`` on ``mesh``: the env batch and the per-env return
    accumulator split over ``dp``, the policy and its optimizer replicated
    (module docstring). A host-env state (no ``env_state``) is marked only:
    each rank's host env is its own block already (``local_env_count``)."""
    shard_params_tp([state.policy, state.optimizer], mesh)
    env_state = state.env_state
    if env_state is not None:
        _check_envs(env_state.obs.shape[0], mesh)
        env_state = shard_batch_tree(env_state, mesh)
    reward_norm = state.reward_norm
    if reward_norm is not None and env_state is not None:
        reward_norm = dataclasses.replace(reward_norm, ret=reward_norm.ret[mesh.rows(reward_norm.ret.shape[0])].clone())
    return state.replace(env_state=env_state, reward_norm=reward_norm, mesh=mesh)


def shard_sac_state(state: Any, mesh: Mesh, num_envs: Optional[int] = None) -> Any:
    """A ``SACState`` on ``mesh``: the env batch and the replay ring split
    over ``dp`` (the ring's capacity must divide by ``dp`` and by the global
    env count, so that ring rows keep their env column), the actor, critics,
    temperature and optimizers replicated. ``num_envs`` is the global env
    count (read from the env state when it has one)."""
    from imitation_tpu_torch.data import buffer as buffer_mod

    shard_params_tp([state.actor, state.critic, state.target_critic, state.actor_opt, state.critic_opt], mesh)
    replicate_tree([state.log_alpha, state.alpha_opt], mesh)
    env_state = state.env_state
    if env_state is not None:
        num_envs = env_state.obs.shape[0]
        _check_envs(num_envs, mesh)
        env_state = shard_batch_tree(env_state, mesh)
    elif num_envs is None:
        raise ValueError("num_envs (the global env count) is needed for a host-env SAC state")
    ring = buffer_mod.shard_ring(state.buffer_state, mesh, num_envs)
    return dataclasses.replace(state, env_state=env_state, buffer_state=ring, mesh=mesh)


def shard_adversarial_trainer(trainer: Any, mesh: Mesh) -> Any:
    """An ``AdversarialTrainer``'s whole state on ``mesh``: the generator's
    through ``shard_rl_state`` / ``shard_sac_state``; the discriminator, its
    optimizer, the replay ring and the demo batch replicated (module
    docstring)."""
    from imitation_tpu_torch.rl.sac import SAC

    if trainer.gen_state is None:
        trainer.gen_state = trainer.gen_algo.init_state()
    if isinstance(trainer.gen_algo, SAC):
        trainer.gen_state = shard_sac_state(trainer.gen_state, mesh, num_envs=trainer.venv.num_envs)
    else:
        trainer.gen_state = shard_rl_state(trainer.gen_state, mesh)
    shard_params_tp([trainer.reward_net, trainer.disc_state.optimizer], mesh)
    if trainer._gen_buffer_state is None:
        trainer._gen_buffer_state = trainer._gen_replay_buffer.init_state(trainer._example_transitions())
    replicate_tree([trainer._gen_buffer_state.data.fields(), trainer._demo_store.batch.fields()], mesh)
    return trainer


def shard_preference_comparisons(pc: Any, mesh: Mesh) -> Any:
    """A ``PreferenceComparisons`` run on ``mesh``: the reward trainer's
    batches split over ``dp`` on their sample axis, its net and optimizer
    replicated; the agent through ``shard_rl_state`` / ``shard_sac_state``
    (module docstring)."""
    from imitation_tpu_torch.algorithms.preference_comparisons import (
        AgentTrainer,
        EnsembleTrainer,
        SACAgentTrainer,
    )

    rt = pc.reward_trainer
    dp = mesh.dp
    if rt.batch_size % dp != 0:
        raise ValueError(
            f"reward trainer batch_size={rt.batch_size} must be divisible "
            f"by dp={dp} to shard fragment batches"
        )
    if rt.minibatch_size % dp != 0:
        raise ValueError(
            f"reward trainer minibatch_size={rt.minibatch_size} must be divisible "
            f"by dp={dp} to shard fragment batches"
        )
    shard_params_tp([rt.preference_model.model, rt.optimizer], mesh)
    rt.batch_sharding = batch_sharding(mesh, 1 if isinstance(rt, EnsembleTrainer) else 0)
    tg = pc.trajectory_generator
    if isinstance(tg, SACAgentTrainer):
        tg.state = shard_sac_state(tg.state, mesh, num_envs=tg.venv.num_envs)
    elif isinstance(tg, AgentTrainer):
        tg.state = shard_rl_state(tg.state, mesh)
    return pc


def unshard_state(state: Any) -> Any:
    """The one-process form of a state placed by ``shard_rl_state`` or
    ``shard_sac_state`` (a collective: every rank calls it): the env rows
    and the replay ring gathered, the mesh mark dropped. Parameters are
    shared with ``state``."""
    from imitation_tpu_torch.data import buffer as buffer_mod

    mesh = getattr(state, "mesh", None)
    if mesh is None:
        return state
    changes = {"mesh": None}
    if state.env_state is not None:
        leaves = []
        tree_map(lambda x: leaves.append(x) or x, state.env_state)
        whole = iter(distributed.all_gather_many(leaves, mesh))
        changes["env_state"] = tree_map(lambda x: next(whole), state.env_state)
    if getattr(state, "reward_norm", None) is not None and state.env_state is not None:
        changes["reward_norm"] = dataclasses.replace(
            state.reward_norm, ret=distributed.all_gather_many([state.reward_norm.ret], mesh)[0])
    if getattr(state, "buffer_state", None) is not None and state.buffer_state.shard is not None:
        changes["buffer_state"] = buffer_mod.unshard_ring(state.buffer_state)
    return dataclasses.replace(state, **changes)
