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


def random_chunk(T: int, B: int, seed: int, obs_dim: int = 4, act_dim=None):
    """One [T, B] rollout chunk, as (jax, torch) chunks: CartPole-shaped
    (int32 actions in {0, 1}), or with ``act_dim`` float32 actions
    ``[T, B, act_dim]`` (Pendulum-shaped at ``obs_dim=3, act_dim=1``)."""
    rng = np.random.default_rng(seed)
    terminated = rng.random((T, B)) < 0.05
    truncated = (rng.random((T, B)) < 0.05) & ~terminated
    obs = rng.normal(scale=0.5, size=(T, B, obs_dim)).astype(np.float32)
    if act_dim is None:
        acts = rng.integers(0, 2, (T, B)).astype(np.int32)
    else:
        acts = rng.normal(size=(T, B, act_dim)).astype(np.float32)
    arrays = dict(
        obs=obs,
        acts=acts,
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
    T, B = jchunk.acts.shape[:2]
    dist, value = jax_policy.dist_and_value(variables, jchunk.obs.reshape(T * B, -1))
    acts = jchunk.acts.reshape((T * B,) + jchunk.acts.shape[2:])
    aux = dict(log_prob=np.asarray(dist.log_prob(acts)).reshape(T, B),
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


def feed_arrays(values):
    """As ``feed``, keeping each array's dtype (noise and uniforms)."""
    queue = [np.array(v) for v in values]

    def take(*args, **kwargs):
        return torch.from_numpy(queue.pop(0))

    take.remaining = queue
    return take


def _jax_sample_draws(k_sample, batch, size, n_expert, replay_idx, expert_idx):
    """The indices one replay sample draws from ``k_sample``: uniform rows
    of the ring (``ReplayBuffer.sample``), or SQIL's ``half`` fresh rows and
    ``batch - half`` expert rows (imitation_tpu/algorithms/sqil.py
    ``sample_hook``)."""
    if n_expert is None:
        replay_idx.append(np.asarray(jax.random.randint(k_sample, (batch,), 0, max(size, 1))))
        return
    k_new, k_exp = jax.random.split(k_sample)
    half = batch // 2
    replay_idx.append(np.asarray(jax.random.randint(k_new, (half,), 0, max(size, 1))))
    expert_idx.append(np.asarray(jax.random.randint(k_exp, (batch - half,), 0, n_expert)))


def jax_sac_draws(key, *, train_freq, num_envs, act_dim, gradient_steps, batch, size, n_expert=None,
                  host=False):
    """The draws of one SAC ``train_step`` from its state's key
    (imitation_tpu/rl/sac.py ``train_step`` and ``_process``): the collect's
    noise, then each update's next-action and policy noise, in the order the
    port asks for them; the replay (and SQIL expert) indices of each update;
    and the key of the next step. With ``host``, those of ``train_step_host``:
    the updates draw from ``k_proc`` (``key, k_proc = split(key)``) and the
    collect's noise, the host collector's own, is left out (``jax_host_noise``)."""
    if host:
        _, key = jax.random.split(key)
        noise = []
    else:
        key, k_roll = jax.random.split(key)
        noise = [np.asarray(jax.random.normal(k, (num_envs, act_dim)))
                 for k in jax.random.split(k_roll, train_freq)]
    update_keys = jax.random.split(key, gradient_steps + 1)
    replay_idx, expert_idx = [], []
    for k in update_keys[1:]:
        k_sample, k_next, k_pi = jax.random.split(k, 3)
        _jax_sample_draws(k_sample, batch, size, n_expert, replay_idx, expert_idx)
        noise += [np.asarray(jax.random.normal(k_next, (batch, act_dim))),
                  np.asarray(jax.random.normal(k_pi, (batch, act_dim)))]
    return noise, replay_idx, expert_idx, update_keys[0]


def jax_dqn_draws(key, *, train_freq, num_envs, n_actions, gradient_steps, batch, size, n_expert=None,
                  host=False):
    """The draws of one DQN ``train_step`` from its state's key
    (imitation_tpu/rl/dqn.py): each collect step's (uniforms of the epsilon
    test, random actions), the replay (and SQIL expert) indices of each
    update, and the key of the next step. With ``host``, those of
    ``train_step_host``: the updates draw from ``k_proc`` and the collect's
    draws, the host collector's own, are left out (``jax_host_explore``)."""
    if host:
        _, key = jax.random.split(key)
        explore = []
    else:
        key, k_roll = jax.random.split(key)
        explore = []
        for step_key in jax.random.split(k_roll, train_freq):
            _, k_eps, k_unif = jax.random.split(step_key, 3)
            explore.append((np.asarray(jax.random.uniform(k_eps, (num_envs,))),
                            np.asarray(jax.random.randint(k_unif, (num_envs,), 0, n_actions))))
    sample_keys = jax.random.split(key, gradient_steps + 1)
    replay_idx, expert_idx = [], []
    for k in sample_keys[1:]:
        _jax_sample_draws(k, batch, size, n_expert, replay_idx, expert_idx)
    return explore, replay_idx, expert_idx, sample_keys[0]


def inject_resets(monkeypatch, venv, state_x):
    """Makes every reset of ``venv``'s env return the JAX engine's initial
    states ``state_x`` (``[B, ...]``), so both packages step from the same
    states; no episode may end in a test that uses it."""
    obs_of = getattr(type(venv.env), "obs_of", lambda x: x)

    def reset(n, generator):
        x = torch.from_numpy(np.array(state_x))
        return obs_of(x), x

    monkeypatch.setattr(venv.env, "reset", reset)


def fixed_resets(monkeypatch, jax_env_cls, venv, x0):
    """Makes every reset, in both packages (auto-resets included), start
    from the env state ``x0`` (an ``ArrayState`` vector such as Pendulum's
    ``[th, thdot]``), so episodes that end mid-rollout restart alike."""
    from imitation_tpu.envs.classic import ArrayState

    x0 = np.asarray(x0, np.float32)
    monkeypatch.setattr(jax_env_cls, "reset", lambda self, key: (
        self.obs_of(ArrayState(x=jnp.asarray(x0))), ArrayState(x=jnp.asarray(x0))))
    obs_of = type(venv.env).obs_of

    def reset(n, generator):
        x = torch.from_numpy(np.tile(x0, (n, 1)))
        return obs_of(x), x

    monkeypatch.setattr(venv.env, "reset", reset)


def jax_explore_draws(key, num_steps, space, num_envs, act_dim):
    """The draws of ``num_steps`` steps of the JAX package's
    ``ExplorationWrapper.collect`` from ``key`` under a Gaussian policy
    (imitation_tpu/policies/exploration_wrapper.py ``step_fn``): per step
    the policy's noise ``[B, act_dim]`` and the mixture's (random actions,
    switch uniforms, new-mode uniforms)."""
    noise, mix = [], []
    for step_key in jax.random.split(key, num_steps):
        k_act, k_rand, k_switch, k_new = jax.random.split(step_key, 4)
        noise.append(np.asarray(jax.random.normal(k_act, (num_envs, act_dim))))
        mix.append((np.asarray(jax.vmap(space.sample)(jax.random.split(k_rand, num_envs))),
                    np.asarray(jax.random.uniform(k_switch, (num_envs,))),
                    np.asarray(jax.random.uniform(k_new, (num_envs,)))))
    return noise, mix


def jax_rollout_noise(key, num_steps, num_envs, act_dim):
    """The Gaussian policy noise of ``num_steps`` steps of the JAX package's
    ``rollout.collect`` from ``key`` (``k_act, _ = split(step_key)``)."""
    return [np.asarray(jax.random.normal(jax.random.split(k)[0], (num_envs, act_dim)))
            for k in jax.random.split(key, num_steps)]


def _jax_host_keys(seed, num_steps):
    """The per-step keys of the JAX package's ``HostCollector`` seeded with
    ``seed`` (imitation_tpu/data/rollout.py: ``key, k_act = split(key)``)."""
    key, out = jax.random.key(seed), []
    for _ in range(num_steps):
        key, k_act = jax.random.split(key)
        out.append(k_act)
    return out


def jax_host_noise(seed, num_steps, num_envs, act_dim):
    """The Gaussian (or squashed-Gaussian) noise of ``num_steps`` steps of
    the JAX package's ``HostCollector`` from ``seed``."""
    return [np.asarray(jax.random.normal(k, (num_envs, act_dim))) for k in _jax_host_keys(seed, num_steps)]


def jax_host_explore(seed, num_steps, num_envs, n_actions):
    """The (uniforms of the epsilon test, random actions) of ``num_steps``
    steps of the JAX DQN's host collector from ``seed``
    (imitation_tpu/rl/dqn.py ``eps_greedy``: ``k_eps, k_unif = split(key)``)."""
    out = []
    for k in _jax_host_keys(seed, num_steps):
        k_eps, k_unif = jax.random.split(k)
        out.append((np.asarray(jax.random.uniform(k_eps, (num_envs,))),
                    np.asarray(jax.random.randint(k_unif, (num_envs,), 0, n_actions))))
    return out
