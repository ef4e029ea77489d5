"""algorithms/mce_irl.py in imitation_tpu_torch against the JAX package.

Tolerances:
* ``mce_partition_fh`` and ``mce_occupancy_measures``: 1e-5 (absolute and
  relative), the same float32 recursions contracted in the same order;
* ``sample_tabular_trajectories`` with the JAX package's draws fed in
  (its initial uniforms through ``envs.tabular._tabular_uniforms``, its
  Gumbel noise through ``_gumbel``): equal;
* the Monte-Carlo check of the port's own draws: 3,000 episodes' visit
  counts within 0.15 of the occupancy measure (the JAX package's test);
* ``MCEIRL.train`` for a fixed number of iterations with both thresholds
  out of reach, from the same weights (``convert``): the logged occupancy
  gap and gradient norm of every iteration within 1e-4 relative, the
  weights within 1e-4 of the largest weight update. The gradient is
  ``D_pi - D_demo``, a difference of nearly equal float32 occupancies, so
  its low bits are rounding, and Adam normalises each coordinate's step
  by its own running scale; measured: 3e-7 to 1.4e-5 relative. The MLP's
  output bias is held apart: it shifts every state's reward alike, so its
  gradient is rounding noise that Adam turns into full steps either way
  (bounded by the learning rate times the iterations; the rewards are
  compared with the two biases' difference taken out);
* the run that stops on its threshold is compared by its final occupancy
  gap only (both within the JAX test's 2e-2): an iteration of difference
  in where two float32 runs cross the threshold is not a fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imitation_tpu.algorithms.mce_irl as jax_mce
import imitation_tpu_torch.algorithms.mce_irl as torch_mce
import imitation_tpu_torch.envs.tabular as torch_tabular
from imitation_tpu.data import types as jax_types
from imitation_tpu.envs.tabular import random_mdp as jax_random_mdp
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.data import types
from imitation_tpu_torch.envs.tabular import random_mdp
from imitation_tpu_torch.util.logger import KVWriter, configure
from tests.torch_parity import feed_arrays, host

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _envs(*args, **kwargs):
    return jax_random_mdp(*args, **kwargs), random_mdp(*args, **kwargs)


@pytest.mark.parametrize("discount", [1.0, 0.9])
@pytest.mark.parametrize("reward", ["env", "given"])
def test_partition_and_occupancy_match_jax(discount, reward):
    jenv, env = _envs(12, 3, horizon=9, seed=1)
    r = np.random.default_rng(0).normal(size=12).astype(np.float32) if reward == "given" else None
    kw = dict(discount=discount)
    jV, jQ, jpi = jax_mce.mce_partition_fh(jenv, reward=None if r is None else jnp.asarray(r), **kw)
    V, Q, pi = torch_mce.mce_partition_fh(
        env, reward=None if r is None else torch.from_numpy(r), device="cpu", **kw)
    for got, want in ((V, jV), (Q, jQ), (pi, jpi)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jDt, jD = jax_mce.mce_occupancy_measures(jenv, pi=jpi, **kw)
    Dt, D = torch_mce.mce_occupancy_measures(env, pi=pi, **kw)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(jDt), **TOL)
    np.testing.assert_allclose(D.numpy(), np.asarray(jD), **TOL)
    # From the reward, through the partition.
    _, jD2 = jax_mce.mce_occupancy_measures(jenv, reward=None if r is None else jnp.asarray(r), **kw)
    _, D2 = torch_mce.mce_occupancy_measures(
        env, reward=None if r is None else torch.from_numpy(r), device="cpu", **kw)
    np.testing.assert_allclose(D2.numpy(), np.asarray(jD2), **TOL)
    np.testing.assert_allclose(pi.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(Dt.sum()) == pytest.approx(env.horizon, rel=1e-5)


def test_sample_tabular_trajectories_with_jax_draws_equal_jax(monkeypatch):
    jenv, env = _envs(6, 3, horizon=5, obs_dim=4, seed=2)
    _, _, jpi = jax_mce.mce_partition_fh(jenv)
    n, key = 9, jax.random.key(3)
    want = jax_mce.sample_tabular_trajectories(jenv, jpi, n, key)
    k0, key = jax.random.split(key)
    u0 = np.asarray(jax.random.uniform(k0, (n,)))
    noise = []
    for k in jax.random.split(key, env.horizon):
        k_a, k_s = jax.random.split(k)
        noise += [np.asarray(jax.random.gumbel(k_a, (n, env.n_actions))),
                  np.asarray(jax.random.gumbel(k_s, (n, env.n_states)))]
    fed_u = feed_arrays([u0])
    monkeypatch.setattr(torch_tabular, "_tabular_uniforms", fed_u)
    fed = feed_arrays(noise)
    monkeypatch.setattr(torch_mce, "_gumbel", fed)
    got = torch_mce.sample_tabular_trajectories(env, torch.from_numpy(np.array(jpi)), n, torch.Generator())
    assert fed.remaining == [] and fed_u.remaining == []
    assert len(got) == len(want) == n
    for t, jt in zip(got, want):
        np.testing.assert_array_equal(t.obs, np.asarray(jt.obs))
        np.testing.assert_array_equal(t.acts, np.asarray(jt.acts))
        np.testing.assert_array_equal(t.rews, np.asarray(jt.rews))
        assert t.acts.dtype == np.asarray(jt.acts).dtype and t.rews.dtype == np.float64
        assert t.terminal and t.infos is None


def test_monte_carlo_visits_match_occupancy():
    """The port's own draws: empirical visits of 3,000 episodes against D."""
    env = random_mdp(4, 2, horizon=6, seed=2)
    _, _, pi = torch_mce.mce_partition_fh(env, device="cpu")
    _, D = torch_mce.mce_occupancy_measures(env, pi=pi)
    trajs = torch_mce.sample_tabular_trajectories(env, pi, 3000, torch.Generator().manual_seed(0))
    visits = np.zeros(env.n_states)
    for t in trajs:
        np.add.at(visits, np.argmax(t.obs[:-1], axis=-1), 1)
    np.testing.assert_allclose(visits / len(trajs), D.numpy(), atol=0.15)


class _Rows(KVWriter):
    def __init__(self):
        self.rows = []

    def write(self, kvs, step):
        self.rows.append((step, dict(kvs)))


def _capture(logger):
    rows = _Rows()
    logger.default_logger.output_formats.append(rows)
    return rows.rows


@pytest.mark.parametrize("net", ["linear", "mlp"])
@pytest.mark.parametrize("discount", [1.0, 0.95])
def test_train_matches_jax(tmp_path, net, discount):
    obs_dim = None if net == "linear" else 5
    jenv, env = _envs(8, 3, horizon=7, obs_dim=obs_dim, seed=4)
    _, _, jpi = jax_mce.mce_partition_fh(jenv, reward=jnp.asarray(-jenv.reward_matrix), discount=discount)
    _, jD = jax_mce.mce_occupancy_measures(jenv, pi=jpi, discount=discount)
    demo = np.asarray(jD, np.float64)
    kw = dict(discount=discount, linf_eps=0.0, grad_l2_eps=0.0, log_interval=1,
              optimizer_kwargs=dict(lr=0.05))
    jnet = jax_mce.MLPRewardNet(hid_sizes=(16,)) if net == "mlp" else None
    jirl = jax_mce.MCEIRL(demo, jenv, jnet, custom_logger=jax_configure(str(tmp_path), []), **kw)
    jrows = _capture(jirl.logger)
    init = host(jirl.variables)
    jr = jirl.train(max_iter=25)

    tnet = torch_mce.MLPRewardNet(env.obs_dim, hid_sizes=(16,)) if net == "mlp" else None
    irl = torch_mce.MCEIRL(demo, env, tnet, device="cpu", custom_logger=configure(format_strs=()), **kw)
    irl.reward_net.load_state_dict(convert.tabular_reward_net_state_dict(init))
    rows = _capture(irl.logger)
    r = irl.train(max_iter=25)

    assert [s for s, _ in rows] == [s for s, _ in jrows] == list(range(25))
    for (_, row), (_, jrow) in zip(rows, jrows):
        assert sorted(row) == sorted(jrow) == ["grad_norm", "iteration", "linf_delta"]
        for k in ("linf_delta", "grad_norm"):
            np.testing.assert_allclose(row[k], jrow[k], rtol=1e-4, err_msg=k)
    want = convert.tabular_reward_net_state_dict(host(jirl.variables))
    start = convert.tabular_reward_net_state_dict(init)
    upd = max(float((want[k] - start[k]).abs().max()) for k in want)
    got = irl.reward_net.state_dict()
    assert sorted(got) == sorted(want)
    errs = {k: float((got[k] - want[k]).abs().max()) for k in want}
    keys = [k for k in want if k != "out.bias"]
    err = max(errs[k] for k in keys)
    assert err <= 1e-4 * upd, (err, upd)
    # The output bias adds the same amount to every state's reward, which
    # leaves the policy and the occupancy as they are: its gradient
    # sum(D_pi - D_demo) is rounding noise, which Adam turns into steps of
    # up to the learning rate either way.
    bias = errs.get("out.bias", 0.0)
    assert bias <= 2 * 0.05 * 25
    shift = float(got["out.bias"] - want["out.bias"]) if "out.bias" in want else 0.0
    np.testing.assert_allclose(r - shift, np.asarray(jr), rtol=1e-4, atol=1e-4 * upd)
    np.testing.assert_allclose(irl.policy.pi, np.asarray(jirl.policy.pi), atol=1e-4)
    assert irl.optimizer.count == 25


def test_stopping_run_reaches_the_demo_occupancy():
    """Each package to its own threshold: the learned policy's occupancy
    within 2e-2 of the demonstrations', as the JAX package's test holds it."""
    jenv, env = _envs(5, 3, horizon=8, seed=7)
    _, _, jpi = jax_mce.mce_partition_fh(jenv)
    _, jD = jax_mce.mce_occupancy_measures(jenv, pi=jpi)
    jirl = jax_mce.MCEIRL(jD, jenv, linf_eps=1e-3, log_interval=None, custom_logger=jax_configure(format_strs=[]))
    jirl.train(max_iter=500)
    irl = torch_mce.MCEIRL(torch.from_numpy(np.array(jD)), env, linf_eps=1e-3, log_interval=None,
                           device="cpu", custom_logger=configure(format_strs=()))
    irl.train(max_iter=500)
    _, jgot = jax_mce.mce_occupancy_measures(jenv, pi=jnp.asarray(jirl.policy.pi))
    _, got = torch_mce.mce_occupancy_measures(env, pi=irl.policy.pi, device="cpu")
    assert np.abs(np.asarray(jgot) - np.asarray(jD)).max() <= 2e-2
    assert np.abs(got.numpy() - np.asarray(jD)).max() <= 2e-2


@pytest.mark.parametrize("discount", [1.0, 0.9])
def test_demonstrations_om_from_trajectories_matches_jax(discount):
    jenv, env = _envs(5, 2, horizon=6, obs_dim=3, seed=3)
    _, _, jpi = jax_mce.mce_partition_fh(jenv)
    jtrajs = jax_mce.sample_tabular_trajectories(jenv, jpi, 20, jax.random.key(1))
    trajs = [types.TrajectoryWithRew(obs=np.asarray(t.obs), acts=np.asarray(t.acts), rews=np.asarray(t.rews),
                                     infos=None, terminal=True) for t in jtrajs]
    jirl = jax_mce.MCEIRL(jtrajs, jenv, discount=discount, custom_logger=jax_configure(format_strs=[]))
    irl = torch_mce.MCEIRL(trajs, env, discount=discount, device="cpu", custom_logger=configure(format_strs=()))
    np.testing.assert_array_equal(irl.demo_state_om, jirl.demo_state_om)
    assert irl.demo_state_om.dtype == np.float64


def test_demonstration_errors_match_jax():
    jenv, env = _envs(4, 2, horizon=5, seed=0)
    for cls, e, kw in ((jax_mce.MCEIRL, jenv, dict(custom_logger=jax_configure(format_strs=[]))),
                       (torch_mce.MCEIRL, env, dict(device="cpu", custom_logger=configure(format_strs=())))):
        with pytest.raises(ValueError, match="OM vector"):
            cls(np.zeros(5), e, **kw)
        tmod = jax_types if cls is jax_mce.MCEIRL else types
        t = tmod.Transitions(obs=np.zeros((4, 4), np.float32), acts=np.zeros((4,), np.int64), infos=None,
                             next_obs=np.zeros((4, 4), np.float32), dones=np.zeros((4,), bool))
        with pytest.raises(TypeError, match="occupancy-measure|trajectories"):
            cls(t, e, **kw)
        with pytest.raises(ValueError, match="No demonstrations"):
            cls(None, e, **kw).train(max_iter=1)


def test_tabular_policy_matches_jax():
    """Numpy on both sides: the same draws from the same seed."""
    jenv, env = _envs(4, 3, horizon=5, seed=1)
    _, _, jpi = jax_mce.mce_partition_fh(jenv)
    jpol = jax_mce.TabularPolicy(jenv, np.asarray(jpi), rng=3)
    pol = torch_mce.TabularPolicy(env, np.asarray(jpi), rng=3)
    states, times = np.array([0, 1, 2, 3, 1, 2]), np.array([0, 1, 4, 2, 3, 0])
    np.testing.assert_array_equal(pol.predict(states, times), jpol.predict(states, times))
    with pytest.raises(AssertionError):
        pol.set_pi(np.zeros((env.horizon, env.n_states, env.n_actions)))
    det = np.zeros((5, 4, 3), np.float32)
    det[..., 2] = 1.0
    pol.set_pi(det)
    assert (pol.predict(np.zeros(20, np.int64), np.zeros(20, np.int64)) == 2).all()


def test_reward_nets_match_jax():
    """Both reward nets' forward from converted weights; the linear net has
    no bias."""
    x = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)
    for jnet, net in ((jax_mce.LinearRewardNet(), torch_mce.LinearRewardNet(5)),
                      (jax_mce.MLPRewardNet(hid_sizes=(8, 4)), torch_mce.MLPRewardNet(5, (8, 4)))):
        variables = jnet.init(jax.random.key(0), jnp.asarray(x))
        net.load_state_dict(convert.tabular_reward_net_state_dict(host(variables)))
        with torch.no_grad():
            np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(),
                                       np.asarray(jnet.apply(variables, jnp.asarray(x))), **TOL)
    assert [k for k, _ in torch_mce.LinearRewardNet(5).named_parameters()] == ["w.weight"]
