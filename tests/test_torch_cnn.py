"""The CNN, build_cnn / build_mlp, NatureCNN actor-critic and bfloat16
compute of imitation_tpu_torch against the JAX package, after carrying the
flax weights across with ``convert`` (HWIO conv kernels become OIHW).

Tolerances: float32 within 1e-5 (relative and absolute), the same
arithmetic with products and convolutions summed in another order.
bfloat16: within ``BF16_ULPS`` units of bfloat16's roundoff 2**-8 times the
output's scale (its largest float32 magnitude), and the port's bfloat16
output no farther from the float32 output than twice JAX's (or one unit of
2**-8 times the scale, where JAX's own error is below that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imitation_tpu.envs.base import Space as JaxSpace
from imitation_tpu.models import networks as jnet
from imitation_tpu.models.policies import ActorCriticNet as JaxActorCriticNet
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu_torch import convert
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.models import networks
from imitation_tpu_torch.models.policies import ActorCriticNet, ActorCriticPolicy, nature_cnn_flat_dim
from tests.torch_parity import host

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_EPS = 2.0 ** -8
BF16_ULPS = 8


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def _bf16_close(got, want, f32):
    """``got`` (port bf16) against ``want`` (JAX bf16), both against ``f32``."""
    got, want, f32 = (np.asarray(x, np.float32) for x in (got.detach().float(), want, f32))
    scale = float(np.abs(f32).max())
    assert np.abs(got - want).max() <= BF16_ULPS * BF16_EPS * scale
    port_err, jax_err = np.abs(got - f32).max(), np.abs(want - f32).max()
    assert port_err <= max(2 * jax_err, BF16_EPS * scale), (port_err, jax_err)


@pytest.mark.parametrize("hw,stride,kernel", [((16, 16), 1, 3), ((15, 17), 2, 3), ((12, 9), 2, 4),
                                               ((7, 7), 3, 5), ((8, 10), 1, 2)])
def test_cnn_matches_jax(hw, stride, kernel):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5,) + hw + (3,)).astype(np.float32)
    jcnn = jnet.build_cnn((4, 6), out_size=3, kernel_size=kernel, stride=stride)
    variables = jcnn.init(jax.random.key(0), jnp.asarray(x))
    cnn = networks.build_cnn(3, (4, 6), out_size=3, kernel_size=kernel, stride=stride)
    state = convert.flax_to_state_dict(host(variables))
    assert state["conv0.weight"].shape == (4, 3, kernel, kernel)  # OIHW
    cnn.load_state_dict(state)
    _close(cnn(torch.from_numpy(x)), jcnn.apply(variables, jnp.asarray(x)))


def test_cnn_one_channel_input_and_padding():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 11, 11)).astype(np.float32)  # [B, H, W]: one channel
    jcnn = jnet.CNN(hid_channels=(2,), out_size=1, squeeze_output=True, stride=2, kernel_size=4)
    variables = jcnn.init(jax.random.key(1), jnp.asarray(x))
    cnn = networks.CNN(1, (2,), out_size=1, squeeze_output=True, stride=2, kernel_size=4)
    cnn.load_state_dict(convert.flax_to_state_dict(host(variables)))
    _close(cnn(torch.from_numpy(x)), jcnn.apply(variables, jnp.asarray(x)))
    # XLA's SAME: (ceil(11 / 2) - 1) * 2 + 4 - 11 = 3 in all, 1 before and 2 after.
    assert networks.same_padding(11, 4, 2) == (1, 2)
    assert networks.same_padding(16, 3, 1) == (1, 1)
    assert networks.same_padding(16, 1, 1) == (0, 0)


def test_cnn_init_is_lecun_normal():
    cnn = networks.CNN(16, (256,), out_size=1, kernel_size=3)
    cnn.reset_parameters(torch.Generator().manual_seed(0))
    w = cnn.conv0.weight.detach()
    fan_in = 16 * 3 * 3
    assert abs(float(w.std()) - fan_in ** -0.5) < 0.05 * fan_in ** -0.5
    assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / networks._TRUNC_STD + 1e-6
    assert float(cnn.conv0.bias.detach().abs().max()) == 0.0


def test_build_mlp_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 2, 3)).astype(np.float32)  # flattened to 6
    jmlp = jnet.build_mlp((8, 5), out_size=2)
    variables = jmlp.init(jax.random.key(2), jnp.asarray(x))
    mlp = networks.build_mlp(6, (8, 5), out_size=2)
    mlp.load_state_dict(convert.flax_to_state_dict(host(variables)))
    _close(mlp(torch.from_numpy(x)), jmlp.apply(variables, jnp.asarray(x)))


def test_conv_kernel_layouts():
    rng = np.random.default_rng(3)
    hwio = rng.normal(size=(3, 5, 2, 7)).astype(np.float32)
    stacked = rng.normal(size=(4, 3, 5, 2, 7)).astype(np.float32)
    dense = rng.normal(size=(4, 6)).astype(np.float32)
    member_dense = rng.normal(size=(4, 6, 2)).astype(np.float32)
    out = convert.flax_to_state_dict({"params": {"c": {"kernel": hwio}, "m": {"kernel": stacked},
                                                 "d": {"kernel": dense}, "s": {"kernel": member_dense}}})
    np.testing.assert_array_equal(out["c.weight"].numpy(), hwio.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(out["m.weight"].numpy(), stacked.transpose(0, 4, 3, 1, 2))
    np.testing.assert_array_equal(out["d.weight"].numpy(), dense.T)
    np.testing.assert_array_equal(out["s.weight"].numpy(), member_dense)


def _image_spaces(shape, n=5, dtype=np.uint8):
    return (JaxSpace.box(0, 255, shape, dtype), JaxSpace.discrete(n),
            Space.box(0, 255, shape, dtype), Space.discrete(n))


def _frames(shape, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,) + shape).astype(np.uint8)


@pytest.mark.parametrize("shape", [(36, 36, 4), (96, 96, 3), (40, 37)])
def test_nature_cnn_policy_matches_jax(shape):
    jobs, jact, tobs, tact = _image_spaces(shape)
    jpol = JaxPolicy(jobs, jact, features="nature_cnn", hid_sizes=(16,))
    variables = jpol.init(jax.random.key(0))
    pol = ActorCriticPolicy(tobs, tact, features="nature_cnn", hid_sizes=(16,))
    state = convert.policy_state_dict(host(variables))
    assert state["net.cnn_fc.weight"].shape == (512, nature_cnn_flat_dim(shape))
    pol.load_state_dict(state)
    obs = _frames(shape, 6, seed=1)
    acts = np.random.default_rng(2).integers(0, 5, 6).astype(np.int32)
    jdist, jvalue = jpol.dist_and_value(variables, jnp.asarray(obs))
    dist, value = pol.dist_and_value(torch.from_numpy(obs))
    _close(dist.logits, jdist.logits)
    _close(value, jvalue)
    jlp, jent, jv = jpol.evaluate_actions(variables, jnp.asarray(obs), jnp.asarray(acts))
    lp, ent, v = pol.evaluate_actions(torch.from_numpy(obs), torch.from_numpy(acts))
    for got, want in ((lp, jlp), (ent, jent), (v, jv)):
        _close(got, want)


def test_nature_cnn_feature_norm_matches_jax():
    """With normalize_features, feat_norm is 512 wide and folds the CNN
    features into its statistics, as JAX's does."""
    shape = (36, 36, 4)
    assert nature_cnn_flat_dim((96, 96)) == 4096 and nature_cnn_flat_dim((84, 84)) == 3136
    with pytest.raises(ValueError, match="36 pixels"):
        nature_cnn_flat_dim((16, 16))
    jobs, jact, tobs, tact = _image_spaces(shape)
    jpol = JaxPolicy(jobs, jact, features="nature_cnn", normalize_features=True)
    variables = jpol.init(jax.random.key(3))
    pol = ActorCriticPolicy(tobs, tact, features="nature_cnn", normalize_features=True)
    assert pol.net.feat_norm.num_features == 512
    pol.load_state_dict(convert.policy_state_dict(host(variables)))
    obs = _frames(shape, 8, seed=4)
    acts = np.arange(8, dtype=np.int32) % 5
    *jout, mutated = jpol.evaluate_actions(variables, jnp.asarray(obs), jnp.asarray(acts), update_stats=True)
    out = pol.evaluate_actions(torch.from_numpy(obs), torch.from_numpy(acts), update_stats=True)
    for got, want in zip(out, jout):
        _close(got, want)
    for name in ("running_mean", "running_var"):
        _close(getattr(pol.net.feat_norm, name), host(mutated)["stats"]["feat_norm"][name])


def test_nature_cnn_flattens_in_nhwc_order():
    """cnn_fc reads the last conv's output in flax's (h, w, c) order: with
    cnn_fc the identity on its first inputs, the features are the NHWC
    flatten of the conv stack's output (44-pixel frames leave 2 x 2 x 64)."""
    shape = (44, 44, 3)
    assert nature_cnn_flat_dim(shape) == 256
    net = ActorCriticPolicy(Space.box(0, 255, shape, np.uint8), Space.discrete(5),
                            features="nature_cnn").net
    obs = torch.from_numpy(_frames(shape, 3, seed=5))
    x = (obs.float() / 255.0).permute(0, 3, 1, 2)
    with torch.no_grad():
        for name in ("conv32_8", "conv64_4", "conv64_3"):
            x = torch.relu(networks.conv_nchw(getattr(net, name), x))
        net.cnn_fc.weight.zero_()
        net.cnn_fc.weight[:256] = torch.eye(256)
        net.cnn_fc.bias.zero_()
        got = net._extract(obs)[:, :256]
    assert x.shape == (3, 64, 2, 2)
    np.testing.assert_array_equal(got.numpy(), x.permute(0, 2, 3, 1).reshape(3, -1).numpy())


def test_mlp_bf16_matches_jax():
    rng = np.random.default_rng(5)
    x = (3 * rng.normal(size=(64, 12))).astype(np.float32)
    j32 = jnet.MLP(hid_sizes=(32, 32), out_size=3)
    j16 = jnet.MLP(hid_sizes=(32, 32), out_size=3, compute_dtype=jnp.bfloat16,
                   normalize_input_layer=None)
    variables = j32.init(jax.random.key(5), jnp.asarray(x))
    m16 = networks.MLP(12, (32, 32), out_size=3, compute_dtype=torch.bfloat16)
    m16.load_state_dict(convert.flax_to_state_dict(host(variables)))
    out = m16(torch.from_numpy(x))
    assert out.dtype == torch.float32
    _bf16_close(out, j16.apply(variables, jnp.asarray(x)), j32.apply(variables, jnp.asarray(x)))


def test_cnn_bf16_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.random(size=(16, 16, 16, 1)).astype(np.float32)
    j32 = jnet.CNN(hid_channels=(8, 8), out_size=2)
    j16 = jnet.CNN(hid_channels=(8, 8), out_size=2, compute_dtype=jnp.bfloat16)
    variables = j32.init(jax.random.key(6), jnp.asarray(x))
    c16 = networks.CNN(1, (8, 8), out_size=2, compute_dtype=torch.bfloat16)
    c16.load_state_dict(convert.flax_to_state_dict(host(variables)))
    out = c16(torch.from_numpy(x))
    assert out.dtype == torch.float32
    _bf16_close(out, j16.apply(variables, jnp.asarray(x)), j32.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("features,shape", [("nature_cnn", (36, 36, 4)), ("flatten", (6,))])
def test_actor_critic_bf16_matches_jax(features, shape):
    jobs, jact, tobs, tact = _image_spaces(shape)
    j32 = JaxActorCriticNet(action_space=jact, features=features, hid_sizes=(64, 64))
    j16 = JaxActorCriticNet(action_space=jact, features=features, hid_sizes=(64, 64),
                            compute_dtype=jnp.bfloat16)
    obs = _frames(shape, 16, seed=7)
    variables = j32.init(jax.random.key(7), jnp.asarray(obs, jnp.float32))
    net = ActorCriticNet(tobs.flat_dim, tact, hid_sizes=(64, 64), features=features, obs_shape=shape,
                         compute_dtype=torch.bfloat16)
    net.load_state_dict(convert.flax_to_state_dict(host(variables)))
    dist, value = net(torch.from_numpy(obs))
    assert dist.logits.dtype == value.dtype == torch.float32
    (jd16, jv16), (jd32, jv32) = (j.apply(variables, jnp.asarray(obs)) for j in (j16, j32))
    _bf16_close(dist.logits, jd16.logits, jd32.logits)
    _bf16_close(value, jv16, jv32)
