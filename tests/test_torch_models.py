"""Policy, reward net and RunningNorm in imitation_tpu_torch against the JAX
package, after carrying the flax weights across with ``convert``.

Tolerance 1e-5 (relative and absolute): the same float32 arithmetic, with
matrix products summed in another order by XLA and by PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imitation_tpu.models.networks import RunningNorm as JaxRunningNorm
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.rewards.reward_nets import BasicRewardNet as JaxRewardNet
from imitation_tpu_torch import convert
from imitation_tpu_torch.models.networks import RunningNorm
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
from tests.torch_parity import host, spaces

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(kind, n, seed):
    rng = np.random.default_rng(seed)
    dim = 4 if kind == "discrete" else 3
    obs = rng.normal(size=(n, dim)).astype(np.float32)
    next_obs = rng.normal(size=(n, dim)).astype(np.float32)
    if kind == "discrete":
        acts = rng.integers(0, 2, n).astype(np.int32)
    else:
        acts = rng.normal(size=(n, 2)).astype(np.float32)
    dones = (rng.random(n) < 0.2).astype(np.float32)
    return obs, acts, next_obs, dones


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
@pytest.mark.parametrize("normalize", [False, True])
def test_policy_matches_jax(kind, normalize):
    jobs, jact, tobs, tact = spaces(kind)
    jpol = JaxPolicy(jobs, jact, normalize_features=normalize, log_std_init=-0.3)
    variables = jpol.init(jax.random.key(0))
    obs, acts, _, _ = _inputs(kind, 64, seed=1)
    if normalize:  # non-trivial stats first
        warm = _inputs(kind, 32, seed=2)[0] * 3 + 1
        _, mutated = jpol.net.apply(variables, jnp.asarray(warm), update_stats=True, mutable=["stats"])
        variables = {**variables, **mutated}
    pol = ActorCriticPolicy(tobs, tact, normalize_features=normalize, log_std_init=-0.3)
    pol.load_state_dict(convert.policy_state_dict(host(variables)))

    jdist, jvalue = jpol.dist_and_value(variables, jnp.asarray(obs))
    dist, value = pol.dist_and_value(torch.from_numpy(obs))
    _close(value, jvalue)
    if kind == "discrete":
        _close(dist.logits, jdist.logits)
        _close(dist.mode(), jdist.mode())
    else:
        _close(dist.mean, jdist.mean)
        _close(dist.mode(), jdist.mode())
    _close(dist.log_prob(torch.from_numpy(acts)), jdist.log_prob(jnp.asarray(acts)))
    _close(dist.entropy(), jdist.entropy())

    jout = jpol.evaluate_actions(variables, jnp.asarray(obs), jnp.asarray(acts), update_stats=normalize)
    out = pol.evaluate_actions(torch.from_numpy(obs), torch.from_numpy(acts), update_stats=normalize)
    for got, want in zip(out, jout[:3]):
        _close(got, want)
    if normalize:
        stats = host(jout[3])["stats"]["feat_norm"]
        _close(pol.net.feat_norm.running_mean, stats["running_mean"])
        _close(pol.net.feat_norm.running_var, stats["running_var"])
        assert int(pol.net.feat_norm.count) == int(stats["count"])


def test_policy_sample_fn_shapes_and_log_probs():
    _, _, tobs, tact = spaces("discrete")
    pol = ActorCriticPolicy(tobs, tact).init(torch.Generator().manual_seed(0))
    obs = torch.from_numpy(_inputs("discrete", 4096, seed=3)[0])
    acts, aux = pol.sample_fn()(obs, torch.Generator().manual_seed(1))
    assert acts.dtype == torch.int32 and acts.shape == (4096,)
    dist, value = pol.dist_and_value(obs)
    torch.testing.assert_close(aux["log_prob"], dist.log_prob(acts))
    torch.testing.assert_close(aux["value"], value)
    # Gumbel-max sampling draws each action with its probability.
    p1 = torch.softmax(dist.logits, -1)[:, 1].mean().item()
    assert abs(acts.float().mean().item() - p1) < 0.03


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
@pytest.mark.parametrize("normalize", [False, True])
def test_reward_net_matches_jax(kind, normalize):
    jobs, jact, tobs, tact = spaces(kind)
    jnet = JaxRewardNet(observation_space=jobs, action_space=jact, normalize_input=normalize)
    variables = jnet.init_variables(jax.random.key(1))
    net = BasicRewardNet(tobs, tact, normalize_input=normalize)
    net.load_state_dict(convert.reward_net_state_dict(host(variables)))
    batch = _inputs(kind, 64, seed=4)
    jbatch = tuple(map(jnp.asarray, batch))
    tbatch = tuple(map(torch.from_numpy, batch))
    _close(net(*tbatch), jnet.apply(variables, *jbatch))
    _close(net.predict_processed(*tbatch), jnet.apply(variables, *jbatch, method="predict_processed"))
    if normalize:
        jout, mutated = jnet.apply(variables, *jbatch, update_stats=True, mutable=["stats"])
        _close(net(*tbatch, update_stats=True), jout)
        stats = host(mutated)["stats"]["input_norm"]
        _close(net.input_norm.running_mean, stats["running_mean"])
        _close(net.input_norm.running_var, stats["running_var"])


def test_running_norm_update_matches_jax():
    rng = np.random.default_rng(5)
    batches = [rng.normal(loc=2.0, scale=3.0, size=(n, 3)).astype(np.float32) for n in (7, 50, 1)]
    jnorm = JaxRunningNorm(num_features=3)
    variables = jnorm.init(jax.random.key(0), jnp.asarray(batches[0]))
    norm = RunningNorm(3)
    for b in batches:
        jout, variables = jnorm.apply(variables, jnp.asarray(b), update_stats=True, mutable=["stats"])
        out = norm(torch.from_numpy(b), update_stats=True)
        _close(out, jout)
        stats = host(variables)["stats"]
        _close(norm.running_mean, stats["running_mean"])
        _close(norm.running_var, stats["running_var"])
        assert int(norm.count) == int(stats["count"])
    probe = rng.normal(size=(5, 3)).astype(np.float32)
    _close(norm(torch.from_numpy(probe)), jnorm.apply(variables, jnp.asarray(probe)))


def test_init_matches_flax_distribution():
    # The port draws Dense kernels as flax does: LeCun normal truncated at 2 std.
    _, _, tobs, tact = spaces("discrete")
    w = torch.cat([
        ActorCriticPolicy(tobs, tact).init(torch.Generator().manual_seed(s)).net.pi1.weight.flatten()
        for s in range(40)
    ])
    jw = np.concatenate([
        np.asarray(JaxPolicy(*spaces("discrete")[:2]).init(jax.random.key(s))["params"]["pi1"]["kernel"]).ravel()
        for s in range(40)
    ])
    assert abs(w.std().item() - jw.std()) < 0.01
    assert w.abs().max().item() <= 2 * np.sqrt(1 / 32) / 0.8796256610342398 + 1e-6
