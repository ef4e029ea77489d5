"""Training-state checkpoints with exact resume.

Port of ``imitation_tpu/util/checkpoint.py``. The JAX package saves a
state pytree as an orbax checkpoint; here a state (``RLState``,
``SACState``, ``DQNState``, or any tree of dataclasses, dicts, lists and
tuples over the leaves below) is written with ``torch.save`` as plain data
that ``torch.load(weights_only=True)`` reads back, and restored into a
template of the same structure, such as a fresh ``init_state()``:

* an ``nn.Module`` saves its ``state_dict`` (parameters and buffers) and is
  restored in place, so every holder of the module sees the weights;
* an optimizer saves its ``state_dict`` (``Adam``'s moments and its update
  count, hence its schedule position) and is restored in place;
* a ``torch.Generator`` saves ``get_state()`` and is restored with
  ``set_state``. A generator held in several places (an RL state and its
  ``VecEnvState`` share one) is saved once; restoring checks that the
  template shares its generators the same way, since resume diverges at
  the first auto-reset otherwise;
* an ``nn.Parameter`` is restored in place (an optimizer holds it); any
  other tensor is loaded onto the template tensor's device;
* numbers, strings and None are kept as they are.

Nothing is pickled but tensors, dicts, lists and numbers; tensors are read
back onto the CPU first.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from imitation_tpu_torch.parallel import distributed
from imitation_tpu_torch.parallel import mesh as mesh_mod

_KIND = "__checkpoint_kind__"


def _to_savable(tree: Any, generators: Dict[int, int]) -> Any:
    if isinstance(tree, nn.Module):
        return {_KIND: "module", "state": tree.state_dict()}
    if isinstance(tree, torch.optim.Optimizer):
        return {_KIND: "optimizer", "state": tree.state_dict()}
    if isinstance(tree, torch.Generator):
        if id(tree) in generators:
            return {_KIND: "generator_ref", "index": generators[id(tree)]}
        generators[id(tree)] = len(generators)
        return {_KIND: "generator", "index": generators[id(tree)], "state": tree.get_state()}
    if isinstance(tree, torch.Tensor):
        return {_KIND: "tensor", "value": tree.detach()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {_KIND: "dataclass", "type": type(tree).__name__,
                "fields": {f.name: _to_savable(getattr(tree, f.name), generators)
                           for f in dataclasses.fields(tree)}}
    if isinstance(tree, dict):
        return {_KIND: "dict", "items": {k: _to_savable(v, generators) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {_KIND: "list", "items": [_to_savable(v, generators) for v in tree]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _mismatch(path: str, what: str) -> ValueError:
    return ValueError(f"checkpoint does not match the template at {path or '<root>'}: {what}")


def _restore(template: Any, saved: Any, path: str, gens: Dict[str, Dict[int, Any]]) -> Any:
    kind = saved.get(_KIND) if isinstance(saved, dict) else None
    if isinstance(template, nn.Module):
        if kind != "module":
            raise _mismatch(path, f"expected a module, found {kind}")
        template.load_state_dict(saved["state"])
        return template
    if isinstance(template, torch.optim.Optimizer):
        if kind != "optimizer":
            raise _mismatch(path, f"expected an optimizer, found {kind}")
        template.load_state_dict(saved["state"])
        return template
    if isinstance(template, torch.Generator):
        if kind not in ("generator", "generator_ref"):
            raise _mismatch(path, f"expected a generator, found {kind}")
        index = saved["index"]
        bound, owner = gens["by_index"].get(index), gens["by_template"].get(id(template))
        if (bound is not None and bound is not template) or (owner is not None and owner != index):
            raise _mismatch(path, "the template shares its generators otherwise than the saved state")
        gens["by_index"][index], gens["by_template"][id(template)] = template, index
        if kind == "generator":
            template.set_state(saved["state"])
        return template
    if isinstance(template, torch.Tensor):
        if kind != "tensor":
            raise _mismatch(path, f"expected a tensor, found {kind}")
        value = saved["value"]
        if value.shape != template.shape or value.dtype != template.dtype:
            raise _mismatch(path, f"tensor {tuple(value.shape)} {value.dtype}, template "
                                  f"{tuple(template.shape)} {template.dtype}")
        if isinstance(template, nn.Parameter):
            with torch.no_grad():
                template.copy_(value)
            return template
        return value.to(template.device)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        if kind != "dataclass" or saved["type"] != type(template).__name__:
            raise _mismatch(path, f"expected a {type(template).__name__}, found {kind}")
        fields = saved["fields"]
        names = [f.name for f in dataclasses.fields(template)]
        if sorted(fields) != sorted(names):
            raise _mismatch(path, f"fields {sorted(fields)} against {sorted(names)}")
        return dataclasses.replace(template, **{
            n: _restore(getattr(template, n), fields[n], f"{path}.{n}", gens) for n in names})
    if isinstance(template, dict):
        if kind != "dict" or sorted(saved["items"], key=str) != sorted(template, key=str):
            raise _mismatch(path, "dict keys differ")
        return {k: _restore(v, saved["items"][k], f"{path}[{k!r}]", gens) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if kind != "list" or len(saved["items"]) != len(template):
            raise _mismatch(path, "sequence lengths differ")
        return type(template)(_restore(v, s, f"{path}[{i}]", gens)
                              for i, (v, s) in enumerate(zip(template, saved["items"])))
    if kind is not None:
        raise _mismatch(path, f"template holds {type(template).__name__}, checkpoint a {kind}")
    return saved


def save_state(path: str, state: Any) -> None:
    """Writes a training state to the file ``path`` (atomically: a
    temporary file renamed over it).

    A state split over ranks (its ``mesh`` set) is a collective: every
    rank calls this, the split rows and tp-split columns are gathered into
    the one-process form, rank 0 writes it and the others wait at a
    barrier. It restores at any layout: into an unsplit template, then
    placed again (``parallel.mesh.shard_rl_state`` / ``shard_sac_state``)."""
    from imitation_tpu_torch.parallel import distributed, mesh as mesh_mod

    mesh = getattr(state, "mesh", None)
    state = mesh_mod.unshard_state(state)
    if mesh is None or (mesh.rank == 0 and mesh.tp_rank == 0):
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(_to_savable(state, {}), tmp)
        os.replace(tmp, path)
    if mesh is not None:
        distributed.barrier(mesh)


def restore_state(path: str, template: Any) -> Any:
    """Restores a state saved by ``save_state`` into ``template`` (a state
    of the same structure, e.g. a fresh ``init_state()``): modules,
    optimizers, parameters and generators in place, other tensors onto the
    template's devices. Returns the restored state."""
    if getattr(template, "mesh", None) is not None:
        raise ValueError("restore into an unsplit template (a fresh init_state()), then shard it")
    saved = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return _restore(template, saved, "", {"by_index": {}, "by_template": {}})


class CheckpointManager:
    """Periodic checkpointing with retention: ``step_{step:012d}.pt`` files
    in ``directory``, the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_every: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_every = save_every
        os.makedirs(self.directory, exist_ok=True)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}.pt")

    def maybe_save(self, step: int, state: Any) -> bool:
        if step % self.save_every != 0:
            return False
        save_state(self._step_path(step), state)
        self._cleanup()
        return True

    def _cleanup(self) -> None:
        for s in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._step_path(s))

    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".pt"):
                steps.append(int(name[len("step_"):-len(".pt")]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, template: Any) -> Any:
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_state(self._step_path(step), template)
