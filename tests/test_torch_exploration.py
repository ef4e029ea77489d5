"""``ExplorationWrapper`` in imitation_tpu_torch against the JAX package.

Both packages run the Markov-switching mixture on device Pendulum-v1 with
every reset at one fixed state and the same Gaussian actor-critic (the JAX
policy's weights carried across with ``convert``). The JAX package's draws
(its initial mode, each step's policy noise, random actions, switch and
new-mode uniforms; imitation_tpu/policies/exploration_wrapper.py) are
recomputed from its keys and fed to the port through
``exploration_wrapper._mode_uniform``, ``_explore_draws`` and
``distributions._standard_normal``.

Tolerances: the modes, the random actions and the episode flags exactly;
policy actions and observations 1e-5 (float32 products and dynamics summed
in another order).
"""

import jax
import numpy as np
import pytest
import torch

import imitation_tpu_torch.models.distributions as torch_dist
import imitation_tpu_torch.policies.exploration_wrapper as torch_explore
from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.envs.classic import Pendulum as JaxPendulum
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.policies.exploration_wrapper import ExplorationWrapper as JaxExplorationWrapper
from imitation_tpu_torch import convert
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.policies.exploration_wrapper import ExplorationWrapper
from tests.torch_parity import feed_arrays, fixed_resets, host, jax_explore_draws

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
X0 = np.array([0.5, -0.3], np.float32)


def _pair(monkeypatch, B, horizon):
    jvenv = jax_make_vec_env("Pendulum-v1", num_envs=B, max_episode_steps=horizon)
    venv = make_vec_env("Pendulum-v1", num_envs=B, max_episode_steps=horizon, device="cpu")
    fixed_resets(monkeypatch, JaxPendulum, venv, X0)
    jpol = JaxPolicy(jvenv.observation_space, jvenv.action_space)
    variables = jpol.init(jax.random.key(1))
    pol = ActorCriticPolicy(venv.observation_space, venv.action_space)
    pol.load_state_dict(convert.policy_state_dict(host(variables)))
    return jvenv, venv, jpol, variables, pol


def _feed(monkeypatch, mode_u, noise, mix):
    mode = feed_arrays([mode_u])
    noise, mix_q = feed_arrays(noise), list(mix)

    def draws(space, n, generator):
        return tuple(torch.from_numpy(np.array(x)) for x in mix_q.pop(0))

    monkeypatch.setattr(torch_explore, "_mode_uniform", mode)
    monkeypatch.setattr(torch_explore, "_explore_draws", draws)
    monkeypatch.setattr(torch_dist, "_standard_normal", noise)
    return lambda: mode.remaining == [] and noise.remaining == [] and mix_q == []


def _assert_chunks(got, want):
    for name in ("terminated", "truncated", "episode_length"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    for name in ("obs", "acts", "rews", "next_obs", "episode_return"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("random_prob,switch_prob", [(0.5, 0.5), (0.3, 0.1), (1.0, 0.0), (0.0, 1.0)])
def test_collect_matches_jax(monkeypatch, random_prob, switch_prob):
    """Two successive collects, the mode carried across, with episodes of 12
    steps ending and restarting inside them."""
    B, T = 4, 16
    jvenv, venv, jpol, variables, pol = _pair(monkeypatch, B, horizon=12)
    jexp = JaxExplorationWrapper(jpol.sample_fn(), jvenv, random_prob=random_prob, switch_prob=switch_prob)
    exp = ExplorationWrapper(pol.sample_fn(), venv, random_prob=random_prob, switch_prob=switch_prob)
    k_reset, k_mode, k1, k2 = jax.random.split(jax.random.key(3), 4)
    jstate = jvenv.reset(k_reset)
    jmode = jexp.initial_mode(k_mode)
    jstate, jmode1, jchunk1 = jexp.collect(variables, jstate, jmode, T, k1)
    _, jmode2, jchunk2 = jexp.collect(variables, jstate, jmode1, T, k2)

    noise1, mix1 = jax_explore_draws(k1, T, jvenv.action_space, B, 1)
    noise2, mix2 = jax_explore_draws(k2, T, jvenv.action_space, B, 1)
    done = _feed(monkeypatch, np.asarray(jax.random.uniform(k_mode, (B,))), noise1 + noise2, mix1 + mix2)
    generator = torch.Generator().manual_seed(0)
    state = venv.reset(generator)
    mode = exp.initial_mode(generator)
    np.testing.assert_array_equal(mode.numpy(), np.asarray(jmode))
    state, mode1, chunk1 = exp.collect(state, mode, T, generator)
    _, mode2, chunk2 = exp.collect(state, mode1, T, generator)
    assert done()
    np.testing.assert_array_equal(mode1.numpy(), np.asarray(jmode1))
    np.testing.assert_array_equal(mode2.numpy(), np.asarray(jmode2))
    _assert_chunks(chunk1, jchunk1)
    _assert_chunks(chunk2, jchunk2)
    assert chunk1.aux == {} and chunk1.acts.dtype == torch.float32
    if random_prob == 1.0:  # every action is a random one
        np.testing.assert_array_equal(chunk1.acts.numpy(), np.stack([m[0] for m in mix1]))


def test_probabilities_are_checked():
    venv = make_vec_env("Pendulum-v1", num_envs=2, device="cpu")
    for bad in (dict(random_prob=1.5), dict(switch_prob=-0.1)):
        with pytest.raises(ValueError, match="probabilities"):
            ExplorationWrapper(None, venv, **bad)


def test_draws_are_uniform_and_in_the_space():
    """The port's own draws: actions inside the box, uniforms in [0, 1)."""
    venv = make_vec_env("Pendulum-v1", num_envs=4096, device="cpu")
    acts, u_switch, u_new = torch_explore._explore_draws(venv.action_space, 4096, torch.Generator().manual_seed(0))
    assert acts.shape == (4096, 1) and float(acts.min()) >= -2.0 and float(acts.max()) < 2.0
    for u in (u_switch, u_new):
        assert u.shape == (4096,) and 0.0 <= float(u.min()) and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.02
    assert not torch.equal(u_switch, u_new)
