"""Trajectory and policy serialization in imitation_tpu_torch against the
JAX package.

Trajectories: a directory of the ``.npz`` format written by either package
loads in the other with equal arrays (exactly; rewards come back float64).
Both packages' ``save`` write the HuggingFace format (the JAX package's when
``datasets`` is installed; ``tests/test_torch_writers.py`` holds the two
directories against each other), so their ``.npz`` writers ``_save_npz`` are
called directly.
Policies: ``policy_config.json`` equals the JAX package's for the same
policy (actor-critic or SAC actor), and the weights round-trip exactly.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from imitation_tpu.data import serialize as jax_serialize
from imitation_tpu.data import types as jax_types
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.policies import serialize as jax_policy_serialize
from imitation_tpu.rl.sac import SACPolicy as JaxSACPolicy
from imitation_tpu_torch.data import serialize, types
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.models.policies import ActorCriticPolicy, RandomPolicy, ZeroPolicy
from imitation_tpu_torch import convert
from imitation_tpu_torch.policies import serialize as policy_serialize
from imitation_tpu_torch.rl.sac import SACPolicy
from tests.torch_parity import spaces

torch.set_num_threads(1)


def _trajs(mod, with_rew, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate((5, 1, 12)):
        kw = dict(obs=rng.normal(size=(n + 1, 3)).astype(np.float32),
                  acts=rng.integers(0, 4, n).astype(np.int32) if i % 2 else
                  rng.normal(size=(n, 2)).astype(np.float32),
                  infos=None, terminal=bool(i % 2))
        if with_rew:
            out.append(mod.TrajectoryWithRew(rews=rng.normal(size=n).astype(np.float32), **kw))
        else:
            out.append(mod.Trajectory(**kw))
    return out


def _assert_equal(got, want, with_rew):
    assert len(got) == len(want)
    for t, w in zip(got, want):
        np.testing.assert_array_equal(t.obs, w.obs)
        np.testing.assert_array_equal(t.acts, w.acts)
        assert t.obs.dtype == w.obs.dtype and t.acts.dtype == w.acts.dtype
        assert t.terminal == w.terminal and t.infos is None
        assert isinstance(t, types.TrajectoryWithRew if with_rew else types.Trajectory) or \
            isinstance(t, jax_types.TrajectoryWithRew if with_rew else jax_types.Trajectory)
        if with_rew:
            assert t.rews.dtype == np.float64
            np.testing.assert_array_equal(t.rews, w.rews)
        else:
            assert not hasattr(t, "rews")


@pytest.mark.parametrize("with_rew", [True, False])
def test_npz_written_by_port_loads_in_jax(tmp_path, with_rew):
    trajs = _trajs(types, with_rew)
    serialize._save_npz(str(tmp_path / "d"), trajs)
    assert os.listdir(tmp_path / "d") == ["trajectories.npz"]
    _assert_equal(jax_serialize.load(str(tmp_path / "d")), trajs, with_rew)
    _assert_equal(serialize.load(str(tmp_path / "d")), trajs, with_rew)


@pytest.mark.parametrize("with_rew", [True, False])
def test_npz_written_by_jax_loads_in_port(tmp_path, with_rew):
    trajs = _trajs(jax_types, with_rew)
    jax_serialize._save_npz(str(tmp_path / "d"), trajs)
    _assert_equal(serialize.load(str(tmp_path / "d")), trajs, with_rew)


def test_npz_same_keys_as_jax(tmp_path):
    serialize._save_npz(str(tmp_path / "t"), _trajs(types, True))
    jax_serialize._save_npz(str(tmp_path / "j"), _trajs(jax_types, True))
    with np.load(tmp_path / "t" / "trajectories.npz") as t, np.load(tmp_path / "j" / "trajectories.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])
            assert t[k].dtype == j[k].dtype


def test_load_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        serialize.load(str(tmp_path))


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
@pytest.mark.parametrize("normalize", [False, True])
def test_policy_config_matches_jax(tmp_path, kind, normalize):
    jobs, jact, tobs, tact = spaces(kind)
    kw = dict(hid_sizes=(16, 8), normalize_features=normalize, log_std_init=-0.5)
    jpol = JaxPolicy(jobs, jact, **kw)
    jax_policy_serialize.save_policy(str(tmp_path / "j"), jpol, jpol.init(jax.random.key(0)))
    pol = ActorCriticPolicy(tobs, tact, **kw).init(torch.Generator().manual_seed(0))
    if normalize:
        pol.net.feat_norm.update(torch.randn(10, tobs.flat_dim))
    policy_serialize.save_policy(str(tmp_path / "t"), pol)
    with open(tmp_path / "j" / "policy_config.json") as f, open(tmp_path / "t" / "policy_config.json") as g:
        assert json.load(g) == json.load(f)
    assert sorted(os.listdir(tmp_path / "t")) == ["policy.pt", "policy_config.json"]
    loaded = policy_serialize.load_policy_from_path(str(tmp_path / "t"), device="cpu")
    assert loaded.net.hid_sizes == (16, 8) and loaded.normalize_features == normalize
    assert loaded.action_space.n == tact.n and loaded.action_space.shape == tact.shape
    for (k, v), (k2, v2) in zip(pol.state_dict().items(), loaded.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)
    # The architecture from the JAX package's own config file.
    with open(tmp_path / "j" / "policy_config.json") as f:
        from_jax = policy_serialize.policy_from_config(json.load(f))
    assert sorted(from_jax.state_dict()) == sorted(pol.state_dict())


def test_load_policy_registry(tmp_path):
    venv = make_vec_env("Pendulum-v1", num_envs=3, device="cpu")
    rand = policy_serialize.load_policy("random", venv)
    zero = policy_serialize.load_policy("zero", venv)
    assert isinstance(rand, RandomPolicy) and isinstance(zero, ZeroPolicy)
    obs = torch.zeros((3, 3))
    acts, _ = zero.sample_fn()(obs, torch.Generator())
    assert acts.shape == (3, 1) and not acts.any()
    pol = ActorCriticPolicy(venv.observation_space, venv.action_space)
    policy_serialize.save_policy(str(tmp_path / "p"), pol)
    saved = policy_serialize.load_policy("saved", venv, path=str(tmp_path / "p"))
    assert isinstance(saved, ActorCriticPolicy)
    other = make_vec_env("CartPole-v1", num_envs=3, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        policy_serialize.load_policy("saved", other, path=str(tmp_path / "p"))
    with pytest.raises(KeyError):
        policy_serialize.load_policy("no-such-type", venv)
    # A HuggingFace-hub expert is registered, and refused offline without a download.
    with pytest.raises(RuntimeError, match="policy_type='ppo' path=<model.zip>"):
        policy_serialize.load_policy("ppo-huggingface", venv, env_name="Pendulum-v1")
    with pytest.raises(TypeError):
        policy_serialize.save_policy(str(tmp_path / "r"), rand)


def test_load_policy_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, tobs, tact = spaces("discrete")
    policy_serialize.save_policy(str(tmp_path / "p"), ActorCriticPolicy(tobs, tact))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        policy_serialize.load_policy_from_path(str(tmp_path / "p"))


def test_sac_actor_config_matches_jax_and_round_trips(tmp_path):
    """The ``sac_actor`` type: the same ``policy_config.json`` as the JAX
    package's for the same policy; save -> load gives back the weights and
    the env-scaled actions."""
    jobs, jact, tobs, tact = spaces("continuous")
    jpol = JaxSACPolicy(jobs, jact, hid_sizes=(16, 8))
    jvars = jpol.init_variables(jax.random.key(0))
    jax_policy_serialize.save_policy(str(tmp_path / "j"), jpol, jvars)
    pol = SACPolicy(tobs, tact, hid_sizes=(16, 8))
    pol.actor.load_state_dict(convert.sac_actor_state_dict(jax.device_get(jvars)))
    policy_serialize.save_policy(str(tmp_path / "t"), pol)
    with open(tmp_path / "j" / "policy_config.json") as f, open(tmp_path / "t" / "policy_config.json") as g:
        want = json.load(f)
        assert json.load(g) == want and want["policy_type"] == "sac_actor"
    assert sorted(os.listdir(tmp_path / "t")) == ["policy.pt", "policy_config.json"]
    loaded = policy_serialize.load_policy_from_path(str(tmp_path / "t"), device="cpu")
    assert isinstance(loaded, SACPolicy) and loaded.hid_sizes == (16, 8)
    assert sorted(loaded.state_dict()) == sorted(pol.state_dict())
    for k, v in pol.state_dict().items():
        assert torch.equal(v, loaded.state_dict()[k]), k
    obs = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    got, _ = loaded.deterministic_fn()(torch.from_numpy(obs))
    want_acts, _ = jpol.deterministic_fn()(jvars, jax.numpy.asarray(obs), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_acts), rtol=1e-5, atol=1e-5)
    # The architecture from the JAX package's own config file, and the
    # "saved" loader.
    with open(tmp_path / "j" / "policy_config.json") as f:
        assert isinstance(policy_serialize.policy_from_config(json.load(f)), SACPolicy)
    venv = make_vec_env("Pendulum-v1", num_envs=2, device="cpu")
    pend = SACPolicy(venv.observation_space, venv.action_space, hid_sizes=(8,))
    policy_serialize.save_policy(str(tmp_path / "p"), pend)
    assert isinstance(policy_serialize.load_policy("saved", venv, path=str(tmp_path / "p")), SACPolicy)
