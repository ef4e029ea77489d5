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
  tp-split (replicated at ``tp = 1``). PPO steps the rank's env columns, runs GAE (B1) on them,
  gathers the rollout once per round, computes the loss of its share of
  each global minibatch and averages the gradients over the ranks before
  ``Adam.step`` clips them.
* ``shard_adversarial_trainer``: the generator as above; the discriminator
  tp-split as the policy; the replay ring and the demo batch replicated.
  The generator's
  transitions are gathered before the ring stores them, so every rank's
  ring, and its discriminator step (B2), is the one-process one.
* ``shard_sac_state``: the env batch and the replay ring split over
  ``dp``. A ring row stays on the rank that stepped its env (row ``g``
  holds env column ``g % num_envs``), so a store moves nothing; a sample
  draws global indices and the owners send the rows.
* ``shard_preference_comparisons``: the reward trainer's batches split on
  their sample axis (axis 1 of an ensemble's bagged batch); the agent as
  above; the dataset, fragments and trajectory sampling replicated.

Tensor parallelism (``tp > 1``) splits the dense layers instead of the rows
(``shard_params_tp``). Rank ``r`` of the process group has dp index
``r // tp`` and tp index ``r % tp``: the ``tp`` ranks of one dp row hold the
same rows and each holds one block of output columns of every split layer,
whose forward gathers the blocks (``models.networks.linear``). The learners'
collectives over rows (gradient averaging, the rollout gather, the moment
merges) run over the ranks of one tp index, the dp group; the split layers'
over the ranks of one dp row, the tp group. Each helper above takes
``tp_params``, as the JAX package's do: tp placement of the parameters and
their optimizer moments (the default), or replication.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from imitation_tpu_torch.parallel import distributed

@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` data-parallel by ``tp`` tensor-parallel ranks (processes, one
    device each). ``rank`` is this process's dp index (the block of rows it
    owns) and ``tp_rank`` its tp index (the block of columns of each split
    layer). ``dp_group`` holds the ranks of this rank's tp index and
    ``tp_group`` those of its dp row (None: the whole group, at tp = 1).
    ``distributed`` is False for a mesh made without a process group (one
    process, no collective)."""

    dp: int
    tp: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    distributed: bool = False
    tp_rank: int = 0
    dp_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    tp_group: Any = dataclasses.field(default=None, compare=False, repr=False)

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
    no collectives without a group): rank ``r`` at dp index ``r // tp`` and
    tp index ``r % tp``. At ``tp > 1`` every rank creates the ``tp`` dp
    groups and the ``dp`` tp groups, in that order, so every rank must call
    this. ``device`` defaults to the one ``distributed.initialize`` gave
    this rank."""
    n = distributed.process_count()
    if dp is None:
        if n % tp != 0:
            raise ValueError(f"{n} devices (one per process) not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices (one per process)")
    dev = torch.device(device) if device is not None else distributed.local_device()
    r = distributed.process_index()
    dp_group = tp_group = None
    if tp > 1:
        for j in range(tp):  # the ranks of tp index j, one per dp row
            group = distributed.new_group([i * tp + j for i in range(dp)])
            dp_group = group if j == r % tp else dp_group
        for i in range(dp):  # the ranks of dp row i
            group = distributed.new_group([i * tp + j for j in range(tp)])
            tp_group = group if i == r // tp else tp_group
    return Mesh(dp=dp, tp=tp, rank=r // tp, device=dev, distributed=dist.is_initialized(),
                tp_rank=r % tp, dp_group=dp_group, tp_group=tp_group)


def replicated(mesh: Mesh) -> Mesh:
    """The layout of a tensor whole on every rank: no placement beyond the
    mesh itself (``replicate_tree`` makes the values agree)."""
    return mesh


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
    parameters and buffers, an optimizer's state included). A tp-split
    parameter and its optimizer state, a different block on each tp rank,
    are left as they are."""
    if distributed._single(mesh):
        return tree
    tensors = []
    _collect_tensors(tree, tensors)
    for t in tensors:
        dist.broadcast(t.data, src=0)
    return tree


def _collect_tensors(tree: Any, out: list) -> None:
    if isinstance(tree, nn.Module):
        out.extend(p for p in tree.parameters() if not is_tp_split(p))
        out.extend(tree.buffers())
    elif isinstance(tree, torch.optim.Optimizer):
        for p, state in tree.state.items():
            if not is_tp_split(p):
                out.extend(v for v in state.values() if isinstance(v, torch.Tensor))
    elif isinstance(tree, torch.Tensor):
        if not is_tp_split(tree):
            out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _collect_tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect_tensors(v, out)


def _split(tree: Any):
    """The modules and optimizers of a tree of lists, tuples and dicts."""
    modules: List[nn.Module] = []
    optimizers: List[torch.optim.Optimizer] = []

    def walk(t):
        if isinstance(t, nn.Module):
            modules.append(t)
        elif isinstance(t, torch.optim.Optimizer):
            optimizers.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(tree)
    return modules, optimizers


def is_tp_split(p: torch.Tensor) -> bool:
    """Whether ``p`` holds one tp rank's block of its parameter."""
    return getattr(p, "tp_mesh", None) is not None


def tp_split_params(module: nn.Module, tp: int) -> Dict[str, nn.Parameter]:
    """The parameters of ``module`` that ``shard_params_tp`` splits at
    ``tp``, by name: the JAX rule, in which a dense ``kernel`` ``[in, out]``
    and a 1-D ``bias`` split their output dim when ``tp`` divides it. Here
    that is the weight and bias of every ``nn.Linear`` with ``out_features``
    divisible by ``tp``, and the bias of every ``nn.Conv2d`` with as many
    output channels (its 4-D kernel stays whole). Stacked member layers (3-D
    kernels, 2-D biases), norm statistics and other parameters stay whole."""
    out = {}
    for name, layer in module.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(layer, nn.Linear) and layer.out_features % tp == 0:
            out[prefix + "weight"] = layer.weight
            if layer.bias is not None:
                out[prefix + "bias"] = layer.bias
        elif isinstance(layer, nn.Conv2d) and layer.bias is not None and layer.out_channels % tp == 0:
            out[prefix + "bias"] = layer.bias
    return out


def shard_params_tp(params: Any, mesh: Mesh) -> Any:
    """Tensor-parallel placement of the modules and optimizers in
    ``params``, in place: each split parameter (``tp_split_params``) keeps
    this rank's block of output rows, ``[tp_rank * n / tp, (tp_rank + 1) *
    n / tp)``, as do its optimizer moments, and is marked with the mesh
    (``tp_mesh``); everything else is replicated. At ``tp = 1`` this is
    replication. Every rank holds the same full modules before the call
    (same-seed construction; rank 0's values are broadcast first)."""
    replicate_tree(params, mesh)
    if mesh.tp == 1:
        return params
    modules, optimizers = _split(params)
    blocks = {}  # parameter -> this rank's rows (a tensor hashes by identity)
    for module in modules:
        for p in tp_split_params(module, mesh.tp).values():
            if not is_tp_split(p):
                n = p.shape[0] // mesh.tp
                blocks[p] = slice(mesh.tp_rank * n, (mesh.tp_rank + 1) * n)
    for opt in optimizers:
        for p, state in opt.state.items():
            if p in blocks:
                for k, v in state.items():
                    if isinstance(v, torch.Tensor) and v.shape == p.shape:
                        state[k] = v[blocks[p]].clone()
    for p, rows in blocks.items():
        with torch.no_grad():
            p.data = p.data[rows].clone()
        p.grad = None
        p.tp_mesh = mesh
    return params


def unshard_params_(params: Any) -> Any:
    """The inverse of ``shard_params_tp``, in place (a collective over each
    tp group: every rank calls it): every split parameter of the modules in
    ``params``, and its moments in the optimizers there, gathered whole and
    unmarked."""
    modules, optimizers = _split(params)
    split = {id(p): p for m in modules for p in m.parameters() if is_tp_split(p)}
    if not split:
        return params
    mesh = next(iter(split.values())).tp_mesh
    targets = []  # (owner, key) pairs, each gathered whole
    for p in split.values():
        targets.append((p, None))
        for opt in optimizers:
            for k, v in opt.state.get(p, {}).items():
                if isinstance(v, torch.Tensor) and v.shape == p.shape:
                    targets.append((opt.state[p], k))
    local = [t.data if k is None else t[k] for t, k in targets]
    whole = distributed.all_gather_many(local, mesh, dim=0, axis="tp")
    for (t, k), w in zip(targets, whole):
        if k is None:
            t.data = w
            t.grad = None
        else:
            t[k] = w
    for p in split.values():
        del p.tp_mesh
    return params


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s ``state_dict`` with every tp-split parameter gathered
    whole (a collective over its tp group where any is split)."""
    state = module.state_dict(keep_vars=True)
    names = [k for k, v in state.items() if is_tp_split(v)]
    if names:
        whole = distributed.all_gather_many([state[k].detach() for k in names], state[names[0]].tp_mesh,
                                            dim=0, axis="tp")
        state.update(zip(names, whole))
    return {k: v.detach() for k, v in state.items()}


def unsplit_copy(module: nn.Module) -> nn.Module:
    """A deep copy of ``module`` with every tp-split parameter at its whole
    shape (zeros) and unmarked: a frame for ``full_state_dict``, computed
    with no collective."""
    twin = copy.deepcopy(module)  # a copied Parameter drops its attributes, the mark included
    for p, q in zip(module.parameters(), twin.parameters()):
        if is_tp_split(p):
            with torch.no_grad():
                q.data = q.data.new_zeros((p.shape[0] * p.tp_mesh.tp,) + tuple(p.shape[1:]))
    return twin


def _check_envs(num_envs: int, mesh: Mesh) -> None:
    if num_envs % mesh.dp != 0:
        raise ValueError(f"num_envs={num_envs} not divisible by dp={mesh.dp}")


def _place_params(params: Any, mesh: Mesh, tp_params: bool) -> Any:
    """tp placement (``tp_params``) or replication."""
    return shard_params_tp(params, mesh) if tp_params else replicate_tree(params, mesh)


def shard_rl_state(state: Any, mesh: Mesh, tp_params: bool = True) -> Any:
    """An ``RLState`` on ``mesh``: the env batch and the per-env return
    accumulator split over ``dp``, the policy and its optimizer tp-split or
    replicated (module docstring). A host-env state (no ``env_state``) is
    marked only: each rank's host env is its own block already
    (``local_env_count``)."""
    _place_params([state.policy, state.optimizer], mesh, tp_params)
    env_state = state.env_state
    if env_state is not None:
        _check_envs(env_state.obs.shape[0], mesh)
        env_state = shard_batch_tree(env_state, mesh)
    reward_norm = state.reward_norm
    if reward_norm is not None and env_state is not None:
        reward_norm = dataclasses.replace(reward_norm, ret=reward_norm.ret[mesh.rows(reward_norm.ret.shape[0])].clone())
    return state.replace(env_state=env_state, reward_norm=reward_norm, mesh=mesh)


def shard_sac_state(state: Any, mesh: Mesh, num_envs: Optional[int] = None, tp_params: bool = True) -> Any:
    """A ``SACState`` on ``mesh``: the env batch and the replay ring split
    over ``dp`` (the ring's capacity must divide by ``dp`` and by the global
    env count, so that ring rows keep their env column), the actor, critics
    and their optimizers tp-split or replicated, the temperature and its
    optimizer replicated. ``num_envs`` is the global env count (read from
    the env state when it has one)."""
    from imitation_tpu_torch.data import buffer as buffer_mod

    _place_params([state.actor, state.critic, state.target_critic, state.actor_opt, state.critic_opt], mesh,
                  tp_params)
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


def shard_adversarial_trainer(trainer: Any, mesh: Mesh, tp_params: bool = True) -> Any:
    """An ``AdversarialTrainer``'s whole state on ``mesh``: the generator's
    through ``shard_rl_state`` / ``shard_sac_state``; the discriminator and
    its optimizer tp-split or replicated; the replay ring and the demo batch
    replicated (module docstring)."""
    from imitation_tpu_torch.rl.sac import SAC

    if trainer.gen_state is None:
        trainer.gen_state = trainer.gen_algo.init_state()
    if isinstance(trainer.gen_algo, SAC):
        trainer.gen_state = shard_sac_state(trainer.gen_state, mesh, num_envs=trainer.venv.num_envs,
                                            tp_params=tp_params)
    else:
        trainer.gen_state = shard_rl_state(trainer.gen_state, mesh, tp_params)
    _place_params([trainer.reward_net, trainer.disc_state.optimizer], mesh, tp_params)
    if trainer._gen_buffer_state is None:
        trainer._gen_buffer_state = trainer._gen_replay_buffer.init_state(trainer._example_transitions())
    replicate_tree([trainer._gen_buffer_state.data.fields(), trainer._demo_store.batch.fields()], mesh)
    return trainer


def shard_preference_comparisons(pc: Any, mesh: Mesh, tp_params: bool = True) -> Any:
    """A ``PreferenceComparisons`` run on ``mesh``: the reward trainer's
    batches split over ``dp`` on their sample axis, its net and optimizer
    tp-split or replicated; the agent through ``shard_rl_state`` /
    ``shard_sac_state`` (module docstring)."""
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
    _place_params([rt.preference_model.model, rt.optimizer], mesh, tp_params)
    rt.batch_sharding = batch_sharding(mesh, 1 if isinstance(rt, EnsembleTrainer) else 0)
    tg = pc.trajectory_generator
    if isinstance(tg, SACAgentTrainer):
        tg.state = shard_sac_state(tg.state, mesh, num_envs=tg.venv.num_envs, tp_params=tp_params)
    elif isinstance(tg, AgentTrainer):
        tg.state = shard_rl_state(tg.state, mesh, tp_params)
    return pc


def unshard_state(state: Any) -> Any:
    """The one-process form of a state placed by ``shard_rl_state`` or
    ``shard_sac_state`` (a collective: every rank calls it): the env rows
    and the replay ring gathered, the mesh mark dropped. Parameters are
    shared with ``state``, unless some are tp-split: then the state's
    modules and optimizers are copies with those gathered whole."""
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
    if mesh.tp > 1:
        owners = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
                  if isinstance(getattr(state, f.name), (nn.Module, torch.optim.Optimizer, nn.Parameter))}
        memo: Dict[int, Any] = {}
        copies = copy.deepcopy(owners, memo)  # one copy: the optimizers keep pointing at the copied parameters
        for owner in owners.values():
            for p in (owner.parameters() if isinstance(owner, nn.Module) else ()):
                if is_tp_split(p):
                    memo[id(p)].tp_mesh = p.tp_mesh  # a copied Parameter drops the mark
        unshard_params_(list(copies.values()))
        changes.update(copies)
    return dataclasses.replace(state, **changes)
