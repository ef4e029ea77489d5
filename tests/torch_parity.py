"""Helpers for the tests that hold imitation_tpu_torch against imitation_tpu.

Inputs are made with numpy from a seed and handed to both packages; weights
are made by the JAX package and carried into the port with
``imitation_tpu_torch.convert``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imitation_tpu.data.rollout import RolloutChunk as JaxChunk
from imitation_tpu.envs import base as jax_base
from imitation_tpu.envs.classic import CartPole as JaxCartPole
from imitation_tpu_torch.data.rollout import RolloutChunk as TorchChunk
from imitation_tpu_torch.envs import base as torch_base
from imitation_tpu_torch.envs.classic import CartPole as TorchCartPole


def spaces(kind: str):
    """(jax obs, jax act, torch obs, torch act) spaces of one kind."""
    if kind == "discrete":
        j, t = JaxCartPole(), TorchCartPole()
        return j.observation_space, j.action_space, t.observation_space, t.action_space
    box = dict(low=-2.0, high=2.0)
    return (
        jax_base.Space.box(shape=(3,), **box), jax_base.Space.box(shape=(2,), **box),
        torch_base.Space.box(shape=(3,), **box), torch_base.Space.box(shape=(2,), **box),
    )


def host(tree):
    """A flax variables tree as nested dicts of numpy arrays."""
    return jax.tree.map(np.asarray, jax.device_get(tree))


def random_chunk(T: int, B: int, seed: int, obs_dim: int = 4):
    """One [T, B] CartPole-shaped rollout chunk, as (jax, torch) chunks."""
    rng = np.random.default_rng(seed)
    terminated = rng.random((T, B)) < 0.05
    truncated = (rng.random((T, B)) < 0.05) & ~terminated
    arrays = dict(
        obs=rng.normal(scale=0.5, size=(T, B, obs_dim)).astype(np.float32),
        acts=rng.integers(0, 2, (T, B)).astype(np.int32),
        rews=np.ones((T, B), np.float32),
        next_obs=rng.normal(scale=0.5, size=(T, B, obs_dim)).astype(np.float32),
        terminated=terminated,
        truncated=truncated,
        episode_return=rng.integers(1, 50, (T, B)).astype(np.float32),
        episode_length=rng.integers(1, 50, (T, B)).astype(np.int32),
    )
    aux = dict(
        log_prob=(np.log(0.5) + rng.normal(scale=0.05, size=(T, B))).astype(np.float32),
        value=rng.normal(size=(T, B)).astype(np.float32),
    )
    jchunk = JaxChunk(aux={k: jnp.asarray(v) for k, v in aux.items()},
                      **{k: jnp.asarray(v) for k, v in arrays.items()})
    tchunk = TorchChunk(aux={k: torch.from_numpy(v) for k, v in aux.items()},
                        **{k: torch.from_numpy(v) for k, v in arrays.items()})
    return jchunk, tchunk


def on_policy_aux(jax_policy, variables, jchunk, tchunk):
    """Sets both chunks' ``aux`` to the JAX policy's own log-probs and values,
    as a rollout under that policy would have recorded them."""
    T, B = jchunk.acts.shape
    dist, value = jax_policy.dist_and_value(variables, jchunk.obs.reshape(T * B, -1))
    aux = dict(log_prob=np.asarray(dist.log_prob(jchunk.acts.reshape(-1))).reshape(T, B),
               value=np.asarray(value).reshape(T, B))
    jchunk = jchunk.replace(aux={k: jnp.asarray(v) for k, v in aux.items()})
    tchunk = tchunk.replace(aux={k: torch.from_numpy(v.copy()) for k, v in aux.items()})
    return jchunk, tchunk


def jax_epoch_perms(key, n_epochs: int, n: int):
    """The epoch permutations PPO.process_chunk draws from ``key``
    (imitation_tpu/rl/ppo.py: ``key, k_perm = split(key)``, then one
    ``permutation`` per ``split(k_perm, n_epochs)`` key)."""
    _, k_perm = jax.random.split(key)
    return [np.asarray(jax.random.permutation(k, n)) for k in jax.random.split(k_perm, n_epochs)]


def jax_disc_indices(key, n_steps: int, batch: int, n_demo: int, buffer_size: int):
    """The (e_idx, g_idx) of ``n_steps`` successive disc steps from ``key``
    (imitation_tpu/algorithms/adversarial/common.py ``_disc_step`` and
    ``ReplayBuffer.sample``)."""
    out = []
    for _ in range(n_steps):
        key, k_expert, k_gen = jax.random.split(key, 3)
        e_idx = jax.random.randint(k_expert, (batch,), 0, n_demo)
        g_idx = jax.random.randint(k_gen, (batch,), 0, max(buffer_size, 1))
        out.append((np.asarray(e_idx, np.int32), np.asarray(g_idx, np.int32)))
    return out


def feed(values):
    """A stand-in for a port sampling helper that returns ``values`` in order."""
    queue = list(values)

    def take(*args, **kwargs):
        item = queue.pop(0)
        if isinstance(item, tuple):
            return tuple(torch.from_numpy(np.array(x)) for x in item)
        return torch.from_numpy(np.array(item)).long()

    take.remaining = queue
    return take


def flat_params(tree, prefix: str = "") -> dict:
    """flax params -> {port state_dict key: numpy array} via convert."""
    from imitation_tpu_torch.convert import flax_to_state_dict

    return {k: v.numpy() for k, v in flax_to_state_dict({"params": host(tree)}, prefix).items()}


PARAM_REL = 1e-5
FLOOR_NUDGES = (1.2e-7, -6e-8, 2.4e-7)
FLOOR_FACTOR = 4.0


def nudge_(modules, rel: float) -> None:
    """Scales every parameter of ``modules`` by ``1 + rel`` in place."""
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                p.mul_(1 + rel)


def snapshot(module) -> dict:
    return {k: v.detach().clone().numpy() for k, v in module.named_parameters()}


def update_floors(run) -> dict:
    """How far float32 rounding alone moves the port's own parameter updates.

    ``run(rel)`` runs the port's side of a parity case from its initial
    weights scaled by ``1 + rel`` and returns ``{label: (init, final)}``
    snapshots of the modules it updates. For each label the floor is the
    largest difference between the update from the exact weights and an
    update from weights nudged by about one float32 ulp (``FLOOR_NUDGES``),
    relative to the largest entry of the exact update. Adam divides each
    coordinate's step by its own running gradient scale, so where a
    coordinate's moments nearly cancel a last-bit difference of a gradient
    moves its step by far more than an ulp; the JAX package and the port
    sum matrix products in another order, so their gradients differ in the
    last bits too, and their updates by about this floor.
    """
    def updates(rel):
        return {label: {k: final[k] - init[k] for k in init}
                for label, (init, final) in run(rel).items()}

    exact = updates(0.0)
    floors = {label: 0.0 for label in exact}
    for rel in FLOOR_NUDGES:
        nudged = updates(rel)
        for label, upd in exact.items():
            scale = max(np.abs(v).max() for v in upd.values())
            spread = max(np.abs(nudged[label][k] - v).max() for k, v in upd.items())
            floors[label] = max(floors[label], spread / scale)
    return floors


def param_tolerance(floor: float) -> float:
    """``PARAM_REL`` of the largest update, or ``FLOOR_FACTOR`` times the
    case's own float32 floor (``update_floors``) where that is larger."""
    return max(PARAM_REL, FLOOR_FACTOR * floor)


def assert_params_close(torch_module, jax_params, jax_init, prefix: str, rel: float) -> float:
    """Every parameter within ``rel`` times the largest update of the JAX run.

    Both runs start from the same weights, so this compares the updates; the
    error is measured against the size of the update it rides on. Returns
    the ratio reached.
    """
    want = flat_params(jax_params, prefix)
    init = flat_params(jax_init, prefix)
    got = {k: v.detach().numpy() for k, v in torch_module.named_parameters()}
    assert sorted(got) == sorted(want)
    upd = max(np.abs(want[k] - init[k]).max() for k in want)
    assert upd > 0
    err = max(np.abs(got[k] - want[k]).max() for k in want)
    assert err <= rel * upd, f"max param error {err:.3g} vs largest update {upd:.3g} (limit {rel:.3g})"
    return err / upd
