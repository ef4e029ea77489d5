"""The reward wrappers of preference comparisons in imitation_tpu_torch
against the JAX package.

``NormalizedRewardNet``, ``RewardEnsemble`` (stacked members, with and
without input normalization and per-member output normalization) and
``AddSTDRewardWrapper`` take the JAX package's variables through
``convert.reward_net_state_dict``; the training forward, the processed
rewards, the ensemble's moments and the statistics after folds with
``update_stats`` agree within 1e-6 (float32 products summed in another
order); standardized outputs within 1e-6 times the normalizer's 1/std,
since standardizing divides the raw error by the std. ``relabel_chunk`` to 1e-6. The port's ``Adam`` with weight decay
follows ``optax.adamw`` step for step (1e-6 relative). Their serialization
is in ``tests/test_torch_reward_serialize.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imitation_tpu.models import networks as jax_networks
from imitation_tpu.rewards import reward_nets as jax_nets
from imitation_tpu.rewards import reward_wrapper as jax_wrapper
from imitation_tpu_torch import convert
from imitation_tpu_torch.models import networks
from imitation_tpu_torch.rewards import reward_nets, reward_wrapper
from imitation_tpu_torch.rl.common import Adam
from tests.torch_parity import host, random_chunk, spaces

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
NORMS = {"running": (jax_networks.RunningNorm, networks.RunningNorm),
         "ema": (jax_networks.EMANorm, networks.EMANorm)}


def _inputs(kind, B, seed):
    jo, ja, _, _ = spaces(kind)
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B,) + jo.shape).astype(np.float32)
    next_obs = rng.normal(size=(B,) + jo.shape).astype(np.float32)
    acts = (rng.integers(0, ja.n, B).astype(np.int32) if ja.is_discrete
            else rng.normal(size=(B,) + ja.shape).astype(np.float32))
    dones = (rng.random(B) < 0.2).astype(np.float32)
    return obs, acts, next_obs, dones


def _t(arrays):
    return tuple(torch.from_numpy(np.array(x)) for x in arrays)


def _close(got, want, scale=1.0):
    tol = {k: v * max(1.0, scale) for k, v in TOL.items()}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _scale(net):
    """The largest 1/std of ``net``'s output normalizers (1 without one)."""
    norms = [m for m in net.modules() if isinstance(m, networks.NormLayer) and m.num_features == 1]
    return max([float(torch.rsqrt(m.running_var + m.eps).max()) for m in norms], default=1.0)


def _assert_stats(net, jvars):
    want = convert.reward_net_state_dict(host(jvars))
    got = net.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL, err_msg=k)


def _fold(jnet, jvars, inputs, method):
    """One JAX apply of ``method`` with ``update_stats=True``; returns
    (output, variables with the new statistics)."""
    out, mut = jnet.apply(jvars, *inputs, update_stats=True, method=method, mutable=["stats"])
    return out, ({**jvars, "stats": mut["stats"]} if "stats" in mut else jvars)


def _normalized(kind, norm, normalize_input=False):
    jo, ja, to, ta = spaces(kind)
    jcls, tcls = NORMS[norm]
    jnet = jax_nets.NormalizedRewardNet(
        observation_space=jo, action_space=ja, normalize_cls=jcls,
        base=jax_nets.BasicRewardNet(observation_space=jo, action_space=ja, normalize_input=normalize_input))
    net = reward_nets.NormalizedRewardNet(
        reward_nets.BasicRewardNet(to, ta, normalize_input=normalize_input), tcls)
    return jnet, net


def _ensemble(kind, norm, normalize_input=False, members=3):
    jo, ja, to, ta = spaces(kind)
    jcls, tcls = NORMS[norm] if norm else (None, None)
    kw = dict(normalize_input=normalize_input)
    jnet = jax_nets.RewardEnsemble(observation_space=jo, action_space=ja, member_cls=jax_nets.BasicRewardNet,
                                   num_members=members, member_kwargs=kw, member_normalize_cls=jcls)
    net = reward_nets.RewardEnsemble(to, ta, num_members=members, member_kwargs=kw, member_normalize_cls=tcls)
    return jnet, net


def _loaded(jnet, net, seed):
    jvars = host(jnet.init_variables(jax.random.key(seed)))
    net.load_state_dict(convert.reward_net_state_dict(jvars))
    return jvars


@pytest.mark.parametrize("kind", ["box", "discrete"])
@pytest.mark.parametrize("norm", ["running", "ema"])
def test_normalized_reward_net_matches_jax(kind, norm):
    jnet, net = _normalized(kind, norm, normalize_input=True)
    jvars = _loaded(jnet, net, 1)
    for step in range(3):
        x = _inputs(kind, 16, step)
        _close(net(*_t(x)), jnet.apply(jvars, *x))
        # frozen statistics, then a fold (twice: the first batch is adopted outright)
        _close(net.predict_processed(*_t(x), update_stats=False),
               jnet.apply(jvars, *x, False, method="predict_processed"), _scale(net))
        want, jvars = _fold(jnet, jvars, x, "predict_processed")
        _close(net.predict_processed(*_t(x)), want, _scale(net))
        _assert_stats(net, jvars)


@pytest.mark.parametrize("kind", ["box", "discrete"])
@pytest.mark.parametrize("norm,normalize_input", [(None, False), (None, True), ("running", True), ("ema", False)])
def test_reward_ensemble_matches_jax(kind, norm, normalize_input):
    jnet, net = _ensemble(kind, norm, normalize_input)
    jvars = _loaded(jnet, net, 2)
    for step in range(3):
        x = _inputs(kind, 12, 10 + step)
        raw = net(*_t(x))
        assert raw.shape == (3, 12)
        _close(raw, jnet.apply(jvars, *x))
        scale = _scale(net)
        _close(net.predict_processed_all(*_t(x)),
               jnet.apply(jvars, *x, method="predict_processed_all"), scale)
        mean, var = net.predict_reward_moments(*_t(x))
        jmean, jvar = jnet.apply(jvars, *x, method="predict_reward_moments")
        _close(mean, jmean, scale)
        _close(var, jvar, scale)
        _close(net.predict_processed(*_t(x)), jmean, scale)
        # A fold moves each member's own output statistics.
        (jmean, _), jvars = _fold(jnet, jvars, x, "predict_reward_moments")
        with torch.no_grad():
            mean, _ = net.predict_reward_moments(*_t(x), update_stats=True)
        _close(mean, jmean, _scale(net))
        _assert_stats(net, jvars)


def test_ensemble_members_take_their_own_rows():
    """Per-member inputs ``[M, B, ...]``: member m's outputs on its rows
    equal the shared forward's row m on the same rows."""
    jnet, net = _ensemble("box", "running", normalize_input=True)
    _loaded(jnet, net, 3)
    per = [_inputs("box", 10, 20 + m) for m in range(3)]
    stacked = _t(tuple(np.stack([p[i] for p in per]) for i in range(4)))
    got = net(*stacked)
    assert got.shape == (3, 10)
    for m in range(3):
        _close(got[m], net(*_t(per[m]))[m].detach())


@pytest.mark.parametrize("alpha", [None, 0.5, -1.0])
def test_add_std_wrapper_matches_jax(alpha):
    jo, ja, to, ta = spaces("box")
    jens, ens = _ensemble("box", "running")
    jnet = jax_nets.AddSTDRewardWrapper(observation_space=jo, action_space=ja, base=jens, default_alpha=0.25)
    net = reward_nets.AddSTDRewardWrapper(ens, default_alpha=0.25)
    ens_vars = host(jens.init_variables(jax.random.key(4)))
    jvars = {c: {"base": tree} for c, tree in ens_vars.items()}
    net.load_state_dict(convert.reward_net_state_dict(jvars))
    x = _inputs("box", 9, 5)
    _close(net.predict_processed(*_t(x), alpha=alpha),
           jnet.apply(jvars, *x, False, alpha, method="predict_processed"))
    _close(net(*_t(x)), jnet.apply(jvars, *x))


def test_ensemble_refuses_one_member_and_other_member_nets():
    _, _, to, ta = spaces("box")
    with pytest.raises(ValueError, match="at least 2"):
        reward_nets.RewardEnsemble(to, ta, num_members=1)
    # Members of any RewardNet class are stacked (CnnRewardNet's in
    # tests/test_torch_cnn_reward_nets.py); a factory function is refused, as
    # the JAX package's nn.vmap refuses it.
    with pytest.raises(TypeError, match="RewardNet class"):
        reward_nets.RewardEnsemble(to, ta, member_cls=reward_nets.BasicShapedRewardNet)
    jo, ja, _, _ = spaces("box")
    with pytest.raises(TypeError):
        jax_nets.RewardEnsemble(observation_space=jo, action_space=ja,
                                member_cls=jax_nets.BasicShapedRewardNet).init_variables(jax.random.key(0))


@pytest.mark.parametrize("norm", [None, "running"])
def test_relabel_chunk_matches_jax(norm):
    if norm:
        jnet, net = _normalized("box", norm, normalize_input=True)
    else:
        jnet, net = _ensemble("box", None)
    jvars = _loaded(jnet, net, 6)
    jchunk, tchunk = random_chunk(9, 4, seed=7, obs_dim=3, act_dim=2)
    jfn = lambda v, *a: jnet.apply(v, *a, False, method="predict_processed")
    tfn = lambda n, *a: n.predict_processed(*a, update_stats=False)
    got = reward_wrapper.relabel_chunk(tchunk, tfn, net)
    want = jax_wrapper.relabel_chunk(jchunk, jfn, jvars)
    assert got.rews.shape == (9, 4) and not got.rews.requires_grad
    _close(got.rews, want.rews)
    np.testing.assert_array_equal(got.obs.numpy(), tchunk.obs.numpy())


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_weight_decay_matches_optax_adamw(weight_decay):
    """``Adam(weight_decay=...)`` against ``optax.adamw``, biases decayed too."""
    import optax

    rng = np.random.default_rng(0)
    params = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(3,)).astype(np.float32)]
    tx = optax.adamw(1e-2, weight_decay=weight_decay)
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = Adam(tparams, 1e-2, weight_decay=weight_decay)
    for _ in range(6):
        grads = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, jp in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_adam_deepcopy_keeps_its_settings_and_moments():
    """A deep copy of the port's ``Adam`` (with the module it updates)
    keeps the clip norm, the weight decay, the count and the moments, and
    steps exactly as the original."""
    import copy

    net = torch.nn.Linear(3, 2)
    opt = Adam(net.parameters(), 1e-2, max_grad_norm=0.5, weight_decay=1e-2)
    x = torch.randn(4, 3)
    for _ in range(2):
        opt.zero_grad()
        net(x).square().sum().backward()
        opt.step()
    net2, opt2 = copy.deepcopy((net, opt))
    assert (opt2.max_grad_norm, opt2.weight_decay, opt2.count) == (0.5, 1e-2, 2)
    for o, m in ((opt, net), (opt2, net2)):
        o.zero_grad()
        m(x).square().sum().backward()
        o.step()
    for p, q in zip(net.parameters(), net2.parameters()):
        assert torch.equal(p, q)
