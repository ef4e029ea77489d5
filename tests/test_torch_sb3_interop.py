"""Stable-Baselines3 ``model.zip`` policies in the port
(``imitation_tpu_torch.policies.sb3_interop``) against the JAX package's
loader (``imitation_tpu/policies/sb3_interop.py``), on the same zips.

The zips are made as tests/policies/test_sb3_interop.py makes them (torch
and ``zipfile``, no SB3): discrete (64, 64) with tanh, continuous (32,) with
``log_std``, and ReLU. Logits or means, ``log_std`` and values agree within
1e-5 on seeded observations; every error has the JAX loader's type and
message; the registry routes a ``.zip``, a directory holding ``model.zip``
and a saved policy directory, and the ``*-huggingface`` names raise the
offline ``RuntimeError`` without importing ``huggingface_hub`` (both
packages are run with it blocked, so nothing is downloaded); the CLI's
``expert.policy_type=ppo|sac`` trains BC from a zip.
"""

import io
import json
import sys
import zipfile

import numpy as np
import pytest
import torch

from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.envs.base import Space as JaxSpace
from imitation_tpu.policies import sb3_interop as jax_sb3
from imitation_tpu.policies import serialize as jax_serialize
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.policies import sb3_interop
from imitation_tpu_torch.policies import serialize
from tests.policies.test_sb3_interop import _make_sb3_zip
from tests.test_torch_cli_runs import run_port

torch.set_num_threads(1)

RELU = "<class 'torch.nn.modules.activation.ReLU'>"
# name: (obs dim, head size, hidden sizes, continuous, activation)
ZIPS = {
    "discrete_tanh": (4, 2, (64, 64), False, "Tanh"),
    "continuous_log_std": (3, 2, (32,), True, "Tanh"),
    "discrete_relu": (4, 2, (64, 64), False, RELU),
}


def _spaces(obs_dim, out_dim, continuous):
    """(JAX obs, JAX act, port obs, port act) spaces."""
    act = dict(shape=(out_dim,), dtype=np.float32, low=-1.0, high=1.0) if continuous else \
        dict(shape=(), dtype=np.int64, n=out_dim)
    obs = dict(shape=(obs_dim,), dtype=np.float32)
    return JaxSpace(**obs), JaxSpace(**act), Space(**obs), Space(**act)


def _rewrite(path, sd, data):
    buf = io.BytesIO()
    torch.save(sd, buf)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("policy.pth", buf.getvalue())
        zf.writestr("data", json.dumps(data))


@pytest.mark.parametrize("name", list(ZIPS))
def test_zip_loads_as_the_jax_loader_loads_it(tmp_path, name):
    obs_dim, out_dim, hid, continuous, activation = ZIPS[name]
    path = str(tmp_path / "model.zip")
    sd = _make_sb3_zip(path, obs_dim=obs_dim, out_dim=out_dim, hid=hid, continuous=continuous,
                       activation=activation)
    jo, ja, to, ta = _spaces(obs_dim, out_dim, continuous)
    jpolicy, jvars = jax_sb3.load_sb3_policy(path, jo, ja)
    policy = sb3_interop.load_sb3_policy(path, to, ta, device="cpu")
    assert isinstance(policy, ActorCriticPolicy) and policy.net.hid_sizes == tuple(hid)
    assert policy.net.activation is (torch.relu if activation == RELU else torch.tanh)
    obs = np.random.default_rng(1).normal(size=(7, obs_dim)).astype(np.float32)
    jdist, jvalue = jpolicy.dist_and_value(jvars, obs)
    with torch.no_grad():
        dist, value = policy.dist_and_value(torch.from_numpy(obs))
    if continuous:
        np.testing.assert_allclose(dist.mean.numpy(), np.asarray(jdist.mean), atol=1e-5)
        np.testing.assert_allclose(dist.log_std.detach().numpy(), np.asarray(jdist.log_std), atol=1e-5)
        np.testing.assert_array_equal(policy.net.log_std.detach().numpy(), sd["log_std"].numpy())
    else:
        np.testing.assert_allclose(dist.logits.numpy(), np.asarray(jdist.logits), atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jvalue), atol=1e-5)


def _bad_zip(path, kind):
    """A zip that the loaders refuse, and the spaces it is loaded with."""
    continuous = kind == "no_log_std"
    sd = _make_sb3_zip(path, obs_dim=4, out_dim=2, hid=(8,), continuous=False)
    data = {"activation_fn": "Tanh"}
    obs_dim, out_dim = 4, 2
    if kind == "shared_torso":
        sd["mlp_extractor.shared_net.0.weight"] = torch.zeros(8, 4)
    elif kind == "cnn_extractor":
        sd["features_extractor.cnn.0.weight"] = torch.zeros(8, 1, 3, 3)
    elif kind == "no_policy_layers":
        sd = {k: v for k, v in sd.items() if "policy_net" not in k}
    elif kind == "obs_dim":
        obs_dim = 5
    elif kind == "head_size":
        out_dim = 3
    if kind == "no_policy_pth":
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("data", json.dumps(data))
    else:
        _rewrite(path, sd, data)
    return _spaces(obs_dim, out_dim, continuous)


@pytest.mark.parametrize("kind", ["shared_torso", "cnn_extractor", "no_policy_layers", "obs_dim", "head_size",
                                  "no_log_std", "no_policy_pth"])
def test_refusals_match_jax(tmp_path, kind):
    path = str(tmp_path / "model.zip")
    jo, ja, to, ta = _bad_zip(path, kind)
    with pytest.raises(Exception) as jax_err:
        jax_sb3.load_sb3_policy(path, jo, ja)
    with pytest.raises(Exception) as port_err:
        sb3_interop.load_sb3_policy(path, to, ta, device="cpu")
    assert port_err.type is jax_err.type
    assert jax_err.type in (NotImplementedError, ValueError)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("policy_type", ["ppo", "sac", "saved"])
def test_registry_routes_zips_and_policy_directories(tmp_path, policy_type):
    venv = make_vec_env("CartPole-v1", num_envs=2, device="cpu")
    zip_dir = tmp_path / "sb3"
    zip_dir.mkdir()
    sd = _make_sb3_zip(str(zip_dir / "model.zip"), obs_dim=4, out_dim=2)
    obs = torch.from_numpy(np.random.default_rng(3).normal(size=(5, 4)).astype(np.float32))
    logits = []
    for path in (zip_dir / "model.zip", zip_dir):  # the zip, and SB3's save layout
        policy = serialize.load_policy(policy_type, venv, path=str(path))
        assert isinstance(policy, ActorCriticPolicy) and policy.net.hid_sizes == (64, 64)
        with torch.no_grad():
            logits.append(policy.distribution(obs).logits.numpy())
    np.testing.assert_array_equal(logits[0], logits[1])
    np.testing.assert_array_equal(policy.net.pi_out.weight.detach().numpy(), sd["action_net.weight"].numpy())
    # Any other path is a policy directory, as for ``saved``.
    saved = tmp_path / "saved"
    serialize.save_policy(str(saved), policy)
    again = serialize.load_policy(policy_type, venv, path=str(saved))
    with torch.no_grad():
        np.testing.assert_array_equal(again.distribution(obs).logits.numpy(), logits[0])


@pytest.mark.parametrize("policy_type", ["ppo-huggingface", "sac-huggingface"])
def test_huggingface_names_raise_offline_without_a_download(monkeypatch, policy_type):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # any import of it fails
    with pytest.raises(RuntimeError) as jax_err:
        jax_serialize.load_policy(policy_type, jax_make_vec_env("CartPole-v1", num_envs=2),
                                  env_name="seals/CartPole-v0")
    with pytest.raises(RuntimeError) as port_err:
        serialize.load_policy(policy_type, make_vec_env("CartPole-v1", num_envs=2, device="cpu"),
                              env_name="seals/CartPole-v0")
    assert str(port_err.value) == str(jax_err.value)
    assert "seals-CartPole-v0" in str(port_err.value) and "policy_type='ppo' path=<model.zip>" in str(port_err.value)
    assert port_err.value.__cause__ is None  # raised by the port itself, not by a failed import


@pytest.mark.parametrize("policy_type", ["ppo", "sac"])
def test_cli_trains_bc_from_an_sb3_expert(tmp_path, policy_type):
    path = str(tmp_path / "model.zip")
    _make_sb3_zip(path, obs_dim=4, out_dim=2)
    result, run_dir = run_port(("train_imitation", "bc"), tmp_path / "logs", f"expert.policy_type={policy_type}",
                               f"expert.loader_kwargs.path={path}")
    run = json.loads((run_dir / "run.json").read_text())
    assert run["status"] == "COMPLETED"
    assert np.isfinite(result["imit_stats"]["monitor_return_mean"])
