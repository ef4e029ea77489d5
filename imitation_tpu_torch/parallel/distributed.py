"""Several processes, one device each: initialization, the collectives the
learners share, and the rows a rank owns of a global batch.

Port of ``imitation_tpu/parallel/distributed.py``. The JAX package runs one
SPMD program over a global device mesh, and XLA inserts the reductions; here
each process drives one device and the learners call the collectives
themselves. Its single-process (``mesh.py``) and multi-process helpers reach
the same code, so both sets of names are kept.

* ``initialize`` starts the process group from explicit arguments or from
  torchrun's variables (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``); with neither it does nothing (one
  process). The backend is the caller's choice: ``nccl`` (one GPU per rank,
  ``cuda:LOCAL_RANK``) or ``gloo`` (CPU tensors, or several ranks sharing a
  GPU). Every collective waits at most ``timeout``, so a missing peer fails
  the run instead of blocking it.
* The collectives use only ``all_reduce`` and ``broadcast``, which both
  backends take for CPU and CUDA tensors: a gather is the sum of a
  zero-filled ``[W, ...]`` buffer in which each rank writes its own block
  (adding zeros is exact), and a reduction of gradients or moments gathers
  the ranks' values and combines them in rank order on every rank, so that
  every rank gets the same bits whatever the backend's reduction order.
* ``local_rows(mesh)`` marks code that works on this rank's block of env
  rows of a global batch: inside it, a draw of ``n`` rows through
  ``draw_rows`` is this rank's block of a draw of ``n * W`` rows from the
  (replicated) generator, as the one-process run draws it, and the batch
  moments of ``row_moments`` / ``row_mean`` are those of the global batch.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=180)

_LOCAL = {"device": None}


# ---------------------------------------------------------------------------
# The process group
# ---------------------------------------------------------------------------


def initialize(
    backend: Optional[str] = None,
    *,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    init_method: Optional[str] = None,
    device: Optional[Any] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> Optional[torch.device]:
    """Joins the process group and returns this rank's device.

    Arguments left None are read from torchrun's variables; ``init_method``
    defaults to ``env://`` when ``MASTER_ADDR`` is set (a ``file://`` path
    names a ``FileStore``). Returns None, and does nothing, when neither
    arguments nor variables ask for several processes. ``backend`` must then
    be given: ``"nccl"`` or ``"gloo"``. The device is ``device`` if given,
    else ``cuda:LOCAL_RANK``; a CPU rank passes ``device="cpu"``.
    """
    env = os.environ
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", 0))
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if rank is None and world_size is None and init_method is None:
        return None  # a single-process run
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if rank is None or world_size is None or init_method is None:
        raise ValueError(
            f"rank={rank}, world_size={world_size} and init_method={init_method!r} "
            "must all be known (arguments or RANK / WORLD_SIZE / MASTER_ADDR)"
        )
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    dev = torch.device(device) if device is not None else torch.device("cuda", local_rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize places each rank on a CUDA device unless device='cpu' is passed, "
                "and none is available"
            )
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=timeout, **kwargs)
    _LOCAL["device"] = dev
    return dev


def shutdown() -> None:
    """Leaves the process group (after a last barrier)."""
    if dist.is_initialized():
        barrier()
        dist.destroy_process_group()
    _LOCAL["device"] = None


def is_multiprocess() -> bool:
    return process_count() > 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device() -> torch.device:
    """The device ``initialize`` gave this rank (CUDA without one)."""
    return _LOCAL["device"] if _LOCAL["device"] is not None else torch.device("cuda")


def barrier(mesh=None) -> None:
    """Waits for every rank (an ``all_reduce`` of one element on the ranks'
    device, which both backends take)."""
    if _single(mesh) and not dist.is_initialized():
        return
    flag = torch.zeros((1,), device=local_device() if mesh is None else mesh.device)
    dist.all_reduce(flag)


def local_env_count(global_num_envs: int) -> int:
    """Number of envs THIS process should step for a global env batch."""
    n = process_count()
    if global_num_envs % n != 0:
        raise ValueError(f"global_num_envs={global_num_envs} not divisible by {n} processes")
    return global_num_envs // n


def make_global_mesh(tp: int = 1, device: Optional[Any] = None):
    """The ('dp', 'tp') mesh over every process (``mesh.make_mesh``)."""
    from imitation_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.make_mesh(tp=tp, device=device)


def process_allgather(tree: Any, mesh=None) -> Any:
    """Every rank's row block of each tensor leaf, concatenated in rank order
    on every rank (a dp-sharded batch made whole)."""
    from imitation_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh if mesh is not None else make_global_mesh(device=local_device())
    leaves: List[torch.Tensor] = []
    mesh_mod.tree_map(lambda x: leaves.append(x) or x, tree)
    gathered = iter(all_gather_many(leaves, mesh))
    return mesh_mod.tree_map(lambda x: next(gathered), tree)


def replicate_global(tree: Any, mesh=None) -> Any:
    """Rank 0's value of every tensor leaf on every rank (a broadcast, in
    place; modules' parameters and buffers too)."""
    from imitation_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh if mesh is not None else make_global_mesh(device=local_device())
    return mesh_mod.replicate_tree(tree, mesh)


def shard_batch_tree_global(tree: Any, mesh) -> Any:
    from imitation_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.shard_batch_tree(tree, mesh)


def shard_rl_state_global(state: Any, mesh) -> Any:
    from imitation_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.shard_rl_state(state, mesh)


def shard_adversarial_trainer_global(trainer: Any, mesh) -> Any:
    from imitation_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.shard_adversarial_trainer(trainer, mesh)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _single(mesh) -> bool:
    """True where no collective runs: no mesh, or one not over a process group."""
    return mesh is None or not mesh.distributed


def _wire(dtype: torch.dtype) -> torch.dtype:
    return torch.uint8 if dtype == torch.bool else dtype


def all_gather_many(tensors: Sequence[torch.Tensor], mesh, dim: int = 0) -> List[torch.Tensor]:
    """Each tensor's blocks from every rank, concatenated along ``dim`` in
    rank order; one ``all_reduce`` per dtype."""
    tensors = list(tensors)
    if _single(mesh) or not tensors:
        return tensors
    W, r = mesh.dp, mesh.rank
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((_wire(t.dtype), t.device), []).append(i)
    for (wire, device), idxs in groups.items():
        sizes = [tensors[i].numel() for i in idxs]
        buf = torch.zeros((W, sum(sizes)), dtype=wire, device=device)
        buf[r] = torch.cat([tensors[i].reshape(-1).to(wire) for i in idxs])
        dist.all_reduce(buf)
        off = 0
        for i, n in zip(idxs, sizes):
            t = tensors[i]
            blocks = buf[:, off:off + n].reshape((W,) + tuple(t.shape)).to(t.dtype)
            out[i] = torch.cat(blocks.unbind(0), dim=dim)
            off += n
    return out


def all_reduce_(tensors: Sequence[torch.Tensor], mesh, average: bool = False) -> None:
    """In place: each tensor becomes the sum (or mean) over ranks, added in
    rank order on every rank."""
    tensors = list(tensors)
    if _single(mesh) or not tensors:
        return
    stacked = all_gather_many([t.unsqueeze(0) for t in tensors], mesh, dim=0)
    for t, s in zip(tensors, stacked):
        total = s[0]
        for w in range(1, s.shape[0]):
            total = total + s[w]
        t.copy_(total / s.shape[0] if average else total)


def all_reduce_grads_(params: Sequence[torch.Tensor], mesh, extra: Sequence[torch.Tensor] = (),
                      average: bool = True) -> None:
    """The gradients of ``params`` (a missing one counts as zeros) and the
    ``extra`` tensors, reduced over the ranks in one collective, in place:
    the mean by default (each rank's loss is its share's mean)."""
    if _single(mesh):
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    tensors = [p.grad for p in params] + list(extra)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_([flat], mesh, average=average)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].reshape(t.shape).to(t.dtype))
        off += n


def merge_moments(count: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor,
                  mesh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (count, mean, M2) of every rank's rows together, merged in rank
    order (Chan et al.). ``count`` broadcasts against ``mean``."""
    if _single(mesh):
        return count, mean, m2
    count = torch.broadcast_to(count.to(mean.dtype), mean.shape)
    counts, means, m2s = (s.unsqueeze(0) for s in (count, mean, m2))
    counts, means, m2s = all_gather_many([counts, means, m2s], mesh, dim=0)
    n, mu, m = counts[0], means[0], m2s[0]
    for w in range(1, counts.shape[0]):
        nb, mub, mb = counts[w], means[w], m2s[w]
        total = n + nb
        denom = torch.clamp(total, min=1)
        delta = mub - mu
        mu = mu + delta * (nb / denom)
        m = m + mb + delta * delta * n * nb / denom
        n = total
    return n, mu, m


# ---------------------------------------------------------------------------
# This rank's rows of a global batch
# ---------------------------------------------------------------------------


class _Rows(threading.local):
    mesh = None


_ROWS = _Rows()


@contextlib.contextmanager
def local_rows(mesh):
    """Inside, tensors hold this rank's block of rows of a batch split over
    ``mesh``'s ``dp`` ranks (module docstring). ``mesh=None`` is one process."""
    prev = _ROWS.mesh
    _ROWS.mesh = mesh
    try:
        yield
    finally:
        _ROWS.mesh = prev


def draw_rows(draw: Callable[[Tuple[int, ...]], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for ``shape[0]`` rows; inside ``local_rows(mesh)``
    this rank's block of ``draw`` at ``shape[0] * dp`` rows."""
    mesh = _ROWS.mesh
    shape = tuple(shape)
    if mesh is None:
        return draw(shape)
    n = shape[0]
    full = draw((n * mesh.dp,) + shape[1:])
    return full[mesh.rank * n:(mesh.rank + 1) * n]


def row_moments(b: torch.Tensor) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """(count, mean, population variance) over axis -2 of ``b``; inside
    ``local_rows`` those of every rank's rows together."""
    count = b.shape[-2]
    mean = b.mean(dim=-2)
    var = b.var(dim=-2, unbiased=False)
    mesh = _ROWS.mesh
    if _single(mesh):
        return count, mean, var
    n, mean, m2 = merge_moments(torch.tensor(float(count), device=b.device), mean, var * count, mesh)
    return n, mean, m2 / torch.clamp(n, min=1)


def row_mean(b: torch.Tensor) -> torch.Tensor:
    """The mean over axis -2 of ``b``; inside ``local_rows`` that of every
    rank's rows together."""
    mesh = _ROWS.mesh
    if _single(mesh):
        return b.mean(dim=-2)
    count = torch.tensor(float(b.shape[-2]), device=b.device)
    total = b.sum(dim=-2)
    counts, totals = all_gather_many([count.reshape(1), total.unsqueeze(0)], mesh, dim=0)
    s, n = totals[0], counts[0]
    for w in range(1, totals.shape[0]):
        s, n = s + totals[w], n + counts[w]
    return s / n
