"""CnnRewardNet, BasicPotentialCNN, CNN ensembles, ``RewardNet.predict``,
saved CNN reward nets and a CNN-shaped AIRL disc step of
imitation_tpu_torch against the JAX package, after carrying the flax
weights across with ``convert``.

Tolerances: outputs 1e-5 (relative and absolute), the same float32
arithmetic with convolutions summed in another order; the AIRL disc step's
parameters within 1e-5 of the largest update, raised where needed to 4x the
case's own float32 floor (``tests.torch_parity.update_floors``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imitation_tpu_torch.algorithms.adversarial.common as torch_common
from imitation_tpu.algorithms.adversarial.airl import AIRL as JaxAIRL
from imitation_tpu.data.types import TransitionBatch as JaxBatch
from imitation_tpu.envs.base import Space as JaxSpace
from imitation_tpu.envs.vector import VectorEnv as JaxVectorEnv
from imitation_tpu.models import networks as jax_networks
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.rewards import reward_nets as jnets
from imitation_tpu.rewards import serialize as jax_serialize
from imitation_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from imitation_tpu.util.logger import configure as jax_configure
from examples.tutorials.t05a_preference_comparisons_cnn import PixelCartPole as JaxPixelCartPole
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms.adversarial.airl import AIRL
from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.examples.tutorials.t05a_preference_comparisons_cnn import PixelCartPole
from imitation_tpu_torch.models import networks
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.rewards import reward_nets, serialize
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.util.logger import configure
from tests.torch_parity import (
    assert_params_close, feed, host, jax_disc_indices, nudge_, param_tolerance, snapshot, update_floors,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = (12, 12, 3)


def _spaces(kind, n=4):
    """(jax obs, jax act, torch obs, torch act): uint8 frames 0..255
    (``int``) or float frames in [0, 1] (``float``), Discrete(n)."""
    if kind == "int":
        return (JaxSpace.box(0, 255, SHAPE, np.uint8), JaxSpace.discrete(n),
                Space.box(0, 255, SHAPE, np.uint8), Space.discrete(n))
    return (JaxSpace.box(0.0, 1.0, SHAPE), JaxSpace.discrete(n),
            Space.box(0.0, 1.0, SHAPE), Space.discrete(n))


def _inputs(kind, n, seed, n_actions=4, shape=SHAPE):
    rng = np.random.default_rng(seed)
    if kind == "int":
        obs, next_obs = (rng.integers(0, 256, (n,) + shape).astype(np.uint8) for _ in range(2))
    else:
        obs, next_obs = (rng.random((n,) + shape).astype(np.float32) for _ in range(2))
    acts = rng.integers(0, n_actions, n).astype(np.int32)
    dones = (rng.random(n) < 0.3).astype(np.float32)
    return obs, acts, next_obs, dones


def _both(args):
    return [torch.from_numpy(a) for a in args], [jnp.asarray(a) for a in args]


def _close(got, want):
    if isinstance(want, torch.Tensor):
        want = want.detach()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


FLAGS = [dict(), dict(use_done=True), dict(use_action=False), dict(use_action=False, use_done=True),
         dict(use_state=False, use_next_state=True), dict(use_next_state=True, use_done=True),
         dict(hid_channels=(3, 5, 2), kernel_size=4, stride=2)]


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items()) or "default")
def test_cnn_reward_net_matches_jax(kind, flags):
    jo, ja, to, ta = _spaces(kind)
    kw = dict(hid_channels=(4, 6), **flags) if "hid_channels" not in flags else flags
    jnet = jnets.CnnRewardNet(observation_space=jo, action_space=ja, **kw)
    variables = jnet.init_variables(jax.random.key(0))
    net = reward_nets.CnnRewardNet(to, ta, **kw)
    state = convert.reward_net_state_dict(host(variables))
    assert sorted(state) == sorted(net.state_dict())
    net.load_state_dict(state)
    n_out = (4 if kw.get("use_action", True) else 1) * (2 if kw.get("use_done") else 1)
    assert net.cnn.dense_out.out_features == n_out
    targs, jargs = _both(_inputs(kind, 9, seed=1))
    _close(net(*targs), jnet.apply(variables, *jargs))
    _close(net.predict_processed(*targs), jnet.apply(variables, *jargs, method="predict_processed"))


def test_cnn_reward_net_done_doubling_selects_the_half():
    _, _, to, ta = _spaces("float")
    net = reward_nets.CnnRewardNet(to, ta, use_done=True, hid_channels=(2,))
    net.init(torch.Generator().manual_seed(0))
    obs, acts, next_obs, _ = (torch.from_numpy(a) for a in _inputs("float", 6, seed=2))
    outputs = net.cnn(obs)  # [B, 2 * n_actions]
    rows = torch.arange(6)
    for done, half in ((0.0, 0), (1.0, 4)):
        got = net(obs, acts, next_obs, torch.full((6,), done))
        _close(got, outputs[rows, half + acts.long()])


def test_cnn_reward_net_refusals():
    jo, _, to, _ = _spaces("float")
    box = Space.box(-1.0, 1.0, (2,))
    with pytest.raises(ValueError, match="discrete"):
        reward_nets.CnnRewardNet(to, box)
    with pytest.raises(ValueError, match="current or next state"):
        reward_nets.CnnRewardNet(to, Space.discrete(2), use_state=False)
    reward_nets.CnnRewardNet(to, box, use_action=False)  # a box is fine without actions
    jnet = jnets.CnnRewardNet(observation_space=jo, action_space=JaxSpace.box(-1.0, 1.0, (2,)))
    with pytest.raises(ValueError, match="discrete"):
        jnet.init_variables(jax.random.key(0))


@pytest.mark.parametrize("kind", ["int", "float"])
def test_cnn_shaped_net_matches_jax(kind):
    """``ShapedRewardNet(CnnRewardNet, BasicPotentialCNN)``: the forward with
    the potential's shaping, its base, and the potential alone."""
    jo, ja, to, ta = _spaces(kind)
    jnet = jnets.ShapedRewardNet(
        observation_space=jo, action_space=ja, discount_factor=0.9,
        base=jnets.CnnRewardNet(observation_space=jo, action_space=ja, hid_channels=(4,)),
        potential=jnets.BasicPotentialCNN(observation_space=jo, hid_channels=(3, 3)))
    variables = jnet.init_variables(jax.random.key(1))
    net = reward_nets.ShapedRewardNet(reward_nets.CnnRewardNet(to, ta, hid_channels=(4,)),
                                      reward_nets.BasicPotentialCNN(to, hid_channels=(3, 3)),
                                      discount_factor=0.9)
    state = convert.reward_net_state_dict(host(variables))
    assert any(k.startswith("potential.cnn.conv1.") for k in state)
    net.load_state_dict(state)
    targs, jargs = _both(_inputs(kind, 7, seed=3))
    _close(net(*targs), jnet.apply(variables, *jargs))
    _close(net.base_forward(*targs), jnet.apply(variables, *jargs, method="base_forward"))
    pot = jnets.BasicPotentialCNN(observation_space=jo, hid_channels=(3, 3))
    _close(net.potential(targs[0]), pot.apply({"params": variables["params"]["potential"]}, jargs[0]))


def _cnn_ensemble(kind, normalize):
    jo, ja, to, ta = _spaces(kind)
    kw = dict(hid_channels=(3, 4), use_done=True)
    jnorm = jax_networks.RunningNorm if normalize == "running" else (
        jax_networks.EMANorm if normalize == "ema" else None)
    norm = {"running": networks.RunningNorm, "ema": networks.EMANorm}.get(normalize)
    jnet = jnets.RewardEnsemble(observation_space=jo, action_space=ja, member_cls=jnets.CnnRewardNet,
                                num_members=3, member_kwargs=kw, member_normalize_cls=jnorm)
    net = reward_nets.RewardEnsemble(to, ta, member_cls=reward_nets.CnnRewardNet, num_members=3,
                                     member_kwargs=kw, member_normalize_cls=norm)
    return jnet, net


@pytest.mark.parametrize("normalize", [None, "running", "ema"])
def test_cnn_ensemble_matches_jax(normalize):
    jnet, net = _cnn_ensemble("int", normalize)
    variables = jnet.init_variables(jax.random.key(2))
    state = convert.reward_net_state_dict(host(variables))
    assert sorted(state) == sorted(net.state_dict())
    base = "members.base." if normalize else "members."
    assert state[base + "cnn.conv0.weight"].shape == (3, 3, 3, 3, 3)  # [M, O, I, k, k]
    assert state[base + "cnn.dense_out.weight"].shape == (3, 4, 8)  # [M, in, out]
    net.load_state_dict(state)
    targs, jargs = _both(_inputs("int", 10, seed=4))
    _close(net(*targs), jnet.apply(variables, *jargs))
    for update in (False, True):
        if update:
            (jmean, jvar), mutated = jnet.apply(variables, *jargs, update_stats=True,
                                                method="predict_reward_moments", mutable=["stats"])
        else:
            jmean, jvar = jnet.apply(variables, *jargs, method="predict_reward_moments")
        with torch.no_grad():
            mean, var = net.predict_reward_moments(*targs, update_stats=update)
        _close(mean, jmean)
        _close(var, jvar)
    if normalize:
        want = host(mutated["stats"])["members"]["normalizer"]
        _close(net.members.normalizer.running_mean, want["running_mean"])
        _close(net.members.normalizer.running_var, want["running_var"])


def test_cnn_ensemble_per_member_rows_and_gradients():
    """Per-member inputs ``[M, B, ...]`` give member m its own rows (the
    bagged ensemble trainer's batches); the loss's gradient reaches every
    member's stacked weights, as member m's own JAX gradient."""
    jnet, net = _cnn_ensemble("float", None)
    variables = jnet.init_variables(jax.random.key(3))
    net.load_state_dict(convert.reward_net_state_dict(host(variables)))
    rows = [_inputs("float", 5, seed=10 + m) for m in range(3)]
    stacked = [torch.from_numpy(np.stack([r[i] for r in rows])) for i in range(4)]
    out = net(*stacked)
    assert out.shape == (3, 5)
    for m in range(3):
        _close(out[m], jnet.apply(variables, *(jnp.asarray(a) for a in rows[m]))[m])
    loss = (out ** 2).sum()
    loss.backward()

    def jloss(params):
        return sum((jnet.apply({"params": params}, *(jnp.asarray(a) for a in rows[m]))[m] ** 2).sum()
                   for m in range(3))

    grads = convert.reward_net_state_dict(host({"params": jax.grad(jloss)(variables["params"])}))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


def test_vmap_members_init_draws_each_member():
    _, _, to, ta = _spaces("float")
    ens = reward_nets.RewardEnsemble(to, ta, member_cls=reward_nets.CnnRewardNet, num_members=4,
                                     member_kwargs=dict(hid_channels=(64,)))
    ens.init(torch.Generator().manual_seed(0))
    w = ens.members.cnn.conv0.weight.detach()  # [4, 64, 3, 3, 3]
    fan_in = 3 * 3 * 3
    assert not torch.equal(w[0], w[1])
    assert abs(float(w.std()) - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
    assert float(ens.members.cnn.conv0.bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("which", ["basic", "cnn", "normalized"])
def test_predict_matches_jax(which):
    """``predict``: host arrays in, a host array out, through
    ``predict_processed`` with no gradient and no statistics folded."""
    jo, ja, to, ta = _spaces("float")
    if which == "basic":
        jnet = jnets.BasicRewardNet(observation_space=jo, action_space=ja)
        net = reward_nets.BasicRewardNet(to, ta)
    elif which == "cnn":
        jnet = jnets.CnnRewardNet(observation_space=jo, action_space=ja, hid_channels=(4,))
        net = reward_nets.CnnRewardNet(to, ta, hid_channels=(4,))
    else:
        jnet = jnets.NormalizedRewardNet(
            observation_space=jo, action_space=ja, normalize_cls=jax_networks.RunningNorm,
            base=jnets.CnnRewardNet(observation_space=jo, action_space=ja, hid_channels=(4,)))
        net = reward_nets.NormalizedRewardNet(reward_nets.CnnRewardNet(to, ta, hid_channels=(4,)))
    variables = jnet.init_variables(jax.random.key(5))
    net.load_state_dict(convert.reward_net_state_dict(host(variables)))
    args = _inputs("float", 8, seed=6)
    if which == "normalized":  # non-trivial statistics, and JAX's predict reads them frozen
        warm = _both(_inputs("float", 8, seed=7))
        _, mutated = jnet.apply(variables, *warm[1], update_stats=True, method="predict_processed",
                                mutable=["stats"])
        variables = {**variables, **mutated}
        net.load_state_dict(convert.reward_net_state_dict(host(variables)))
        want = jnet.apply(variables, *(jnp.asarray(a) for a in args), update_stats=False,
                          method="predict_processed")
    else:
        want = jnet.predict(variables, *args)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    got = net.predict(*args)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in before.items())


@pytest.mark.parametrize("kind", ["cnn", "cnn_ensemble"])
def test_jax_saved_cnn_reward_net_loads(tmp_path, kind):
    """A ``reward_config.json`` the JAX package wrote for a CnnRewardNet (or
    an ensemble of them) builds the same net in the port, which gives the
    JAX outputs with its weights; the port's own save writes the same
    config and loads back exactly."""
    jo, ja, to, ta = _spaces("int")
    if kind == "cnn":
        kw = {"hid_channels": [4, 4], "use_done": True}
        jnet = jnets.CnnRewardNet(observation_space=jo, action_space=ja, **kw)
    else:
        kw = {"member_kwargs": {"hid_channels": [3]}}
        jnet = jnets.RewardEnsemble(observation_space=jo, action_space=ja, member_cls=jnets.CnnRewardNet,
                                    num_members=2, member_normalize_cls=jax_networks.RunningNorm, **kw)
    variables = jnet.init_variables(jax.random.key(8))
    jax_serialize.save_reward_net(str(tmp_path / "jax"), jnet, variables, net_kwargs=kw)
    with open(tmp_path / "jax" / jax_serialize.REWARD_CONFIG) as f:
        config = json.load(f)
    net = serialize._build_net(config, to, ta)
    assert type(net).__name__ == type(jnet).__name__
    net.load_state_dict(convert.reward_net_state_dict(host(variables)))
    targs, jargs = _both(_inputs("int", 6, seed=9))
    _close(net.predict_processed(*targs), jnet.apply(variables, *jargs, method="predict_processed"))
    serialize.save_reward_net(str(tmp_path / "port"), net, net_kwargs=kw)
    with open(tmp_path / "port" / serialize.REWARD_CONFIG) as f:
        assert json.load(f) == config
    loaded = serialize.load_reward_net(str(tmp_path / "port"), device="cpu")
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in loaded.state_dict().items())


# -- a CNN-shaped AIRL disc step on pixel CartPole ----------------------------


def _pixels(n, seed):
    rng = np.random.default_rng(seed)
    arrays = dict(
        obs=(rng.random((n, 16, 16, 1)) < 0.1).astype(np.float32),
        acts=rng.integers(0, 2, n).astype(np.int32),
        next_obs=(rng.random((n, 16, 16, 1)) < 0.1).astype(np.float32),
        dones=(rng.random(n) < 0.1).astype(np.float32),
        rews=np.zeros(n, np.float32),
    )
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            TransitionBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


@pytest.mark.parametrize("minibatch", [None, 16])
def test_cnn_airl_disc_step_matches_jax(tmp_path, monkeypatch, minibatch):
    B, n_demo, n_gen = 32, 100, 64
    jdemo, tdemo = _pixels(n_demo, seed=1)
    jgen, tgen = _pixels(n_gen, seed=2)
    common = dict(demo_batch_size=B, demo_minibatch_size=minibatch, n_disc_updates_per_round=1,
                  allow_variable_horizon=True, seed=0)
    ppo_kw = dict(n_steps=8, n_minibatches=2, n_epochs=1)
    jvenv = JaxVectorEnv(JaxPixelCartPole(), num_envs=8)
    jo, ja = jvenv.observation_space, jvenv.action_space
    jnet = jnets.ShapedRewardNet(
        observation_space=jo, action_space=ja,
        base=jnets.CnnRewardNet(observation_space=jo, action_space=ja, hid_channels=(4, 4)),
        potential=jnets.BasicPotentialCNN(observation_space=jo, hid_channels=(4, 4)))
    jtr = JaxAIRL(demonstrations=jdemo, venv=jvenv, reward_net=jnet,
                  policy=JaxPolicy(jo, ja, hid_sizes=(64, 64)), gen_config=JaxPPOConfig(**ppo_kw),
                  custom_logger=jax_configure(str(tmp_path), format_strs=[]), **common)
    jtr.gen_state = jtr.gen_algo.init_state()
    jreward, jpolicy = host(jtr.disc_state.variables), host(jtr.gen_state.variables)
    jbuf = jtr._gen_replay_buffer.store(jtr._gen_replay_buffer.init_state(jgen), jgen)
    jds, jstats = jtr._disc_step(jtr.disc_state, jbuf, jtr.gen_state.variables, jtr._demo_store.batch)

    def port(rel):
        venv = VectorEnv(PixelCartPole(), num_envs=8, device="cpu")
        o, a = venv.observation_space, venv.action_space
        net = reward_nets.ShapedRewardNet(reward_nets.CnnRewardNet(o, a, hid_channels=(4, 4)),
                                          reward_nets.BasicPotentialCNN(o, hid_channels=(4, 4)))
        tr = AIRL(demonstrations=tdemo, venv=venv, reward_net=net,
                  policy=ActorCriticPolicy(o, a, hid_sizes=(64, 64)), gen_config=PPOConfig(**ppo_kw),
                  custom_logger=configure(format_strs=()), **common)
        tr.reward_net.load_state_dict(convert.reward_net_state_dict(jreward))
        tr.warm_start_generator(convert.policy_state_dict(jpolicy))
        nudge_([tr.reward_net], rel)
        buf = tr._gen_replay_buffer.store(tr._gen_replay_buffer.init_state(tgen), tgen)
        indices = feed(jax_disc_indices(jtr.disc_state.key, 1, B, n_demo, n_gen))
        monkeypatch.setattr(torch_common, "_disc_indices", indices)
        init = snapshot(tr.reward_net)
        ds, stats = tr._disc_step(tr.disc_state, buf, tr.policy, tr._demo_store.batch)
        assert indices.remaining == [] and ds.step == 1
        return tr, stats, init

    tr, stats, _ = port(0.0)
    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), **TOL, err_msg=k)

    def port_updates(rel):
        nudged, _, init = port(rel)
        return {"disc": (init, snapshot(nudged.reward_net))}

    floor = update_floors(port_updates)["disc"]
    assert_params_close(tr.reward_net, jds.variables["params"], jtr.disc_state.variables["params"], "",
                        param_tolerance(floor))
