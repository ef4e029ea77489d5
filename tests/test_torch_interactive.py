"""policies/interactive.py in imitation_tpu_torch against the JAX package.

Both packages' policies are given the same scripted keys through a
monkeypatched ``input``; their actions, their printed prompts, re-prompts
and observations, and the errors of their constructors (type and message)
are equal. The one deliberate difference: the image policy's ``_render``
prints the frame's shape, dtype and value range where the JAX package draws
it with matplotlib, so the image policies are compared with ``_render``
replaced in both. ``as_rollout_fn`` on a CartPole ``VectorEnv`` returns the
scripted actions as int32 on the observations' device.
"""

import collections
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import imitation_tpu.policies.interactive as jax_interactive
import imitation_tpu_torch.policies.interactive as interactive
from imitation_tpu.envs.base import Space as JaxSpace
from imitation_tpu_torch.data import rollout
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.envs.base import Space

torch.set_num_threads(1)

MODULES = {"jax": (jax_interactive, JaxSpace), "port": (interactive, Space)}


def _scripted(monkeypatch, keys):
    it = iter(keys)
    monkeypatch.setattr("builtins.input", lambda prompt="": next(it))


def _run(monkeypatch, keys, make, obs):
    """(actions, stdout) of ``make(module, Space).predict(obs)`` in each
    package, fed ``keys``."""
    out = {}
    for name, (mod, space) in MODULES.items():
        _scripted(monkeypatch, keys)
        buf = io.StringIO()
        with redirect_stdout(buf):
            acts = make(mod, space).predict(obs)
        out[name] = (np.asarray(acts), buf.getvalue())
    return out


# (keys, the actions of three observations, invalid keys among those read)
SCRIPTS = [(["d", "a", "d"], [1, 0, 1], 0), (["zzz", "a", "", "d", " a ", "q"], [0, 1, 0], 2),
           (["A", "left", "a", "d", "d"], [0, 1, 1], 2)]


@pytest.mark.parametrize("clear", [False, True])
@pytest.mark.parametrize("keys,acts,invalid", SCRIPTS, ids=["plain", "reprompts", "case"])
def test_text_policy_actions_and_prompts_equal_jax(monkeypatch, keys, acts, invalid, clear):
    def make(mod, space):
        return mod.TextInteractivePolicy(space.box(-1, 1, (3,)), space.discrete(2),
                                         collections.OrderedDict([("a", "left"), ("d", "right")]),
                                         clear_screen_on_query=clear)

    obs = np.arange(9, dtype=np.float32).reshape(3, 3) / 10
    out = _run(monkeypatch, keys, make, obs)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    np.testing.assert_array_equal(out["port"][0], acts)
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1].count("Invalid key") == invalid


def test_cartpole_policy_equals_jax(monkeypatch):
    out = _run(monkeypatch, ["a", "x", "d"], lambda mod, space: mod.cartpole_interactive_policy(
        space.box(-4, 4, (4,)), space.discrete(2)), np.zeros((2, 4), np.float32))
    np.testing.assert_array_equal(out["port"][0], [0, 1])
    assert out["port"][1] == out["jax"][1]


CONSTRUCTION_ERRORS = [
    ("one key", lambda mod, s: mod.TextInteractivePolicy(
        s.box(-1, 1, (3,)), s.discrete(2), collections.OrderedDict([("a", "left")]))),
    ("continuous", lambda mod, s: mod.TextInteractivePolicy(
        s.box(-1, 1, (3,)), s.box(-1, 1, (2,)), collections.OrderedDict([("a", "x"), ("b", "y")]))),
    ("unknown atari", lambda mod, s: mod.AtariInteractivePolicy(
        s.box(0, 255, (84, 84, 3)), s.discrete(2), ["NOOP", "WARP"])),
    ("no meanings", lambda mod, s: mod.atari_interactive_policy(
        type("Env", (), {"observation_space": s.box(0, 255, (8, 8, 3)), "action_space": s.discrete(4)})())),
]


@pytest.mark.parametrize("build", [b for _, b in CONSTRUCTION_ERRORS], ids=[n for n, _ in CONSTRUCTION_ERRORS])
def test_construction_errors_equal_jax(build):
    errors = {}
    for name, (mod, space) in MODULES.items():
        with pytest.raises(Exception) as info:
            build(mod, space)
        errors[name] = (type(info.value), str(info.value))
    assert errors["port"] == errors["jax"]
    assert errors["port"][0] is ValueError


def test_atari_policy_from_env_meanings_equals_jax(monkeypatch):
    policies = {}
    for name, (mod, space) in MODULES.items():
        class FakeAle:
            observation_space = space.box(0, 255, (84, 84, 3))
            action_space = space.discrete(6)

            def get_action_meanings(self):
                return ["NOOP", "FIRE", "RIGHT", "LEFT", "RIGHTFIRE", "LEFTFIRE"]

        env = FakeAle()
        env.unwrapped = env
        wrapper = type("Venv", (), {"env": env, "observation_space": env.observation_space,
                                    "action_space": env.action_space})()
        policies[name] = mod.atari_interactive_policy(wrapper, clear_screen_on_query=False)
        monkeypatch.setattr(policies[name], "_render", lambda obs: print("frame"))
    assert policies["port"].action_keys_names == policies["jax"].action_keys_names
    assert list(policies["port"].action_keys_names) == ["1", "2", "d", "a", "h", "f"]
    assert interactive.ATARI_ACTION_NAMES_TO_KEYS == jax_interactive.ATARI_ACTION_NAMES_TO_KEYS
    keys = ["h", "w", "1", "f", "2"]
    obs = np.zeros((4, 84, 84, 3), np.uint8)
    got = {}
    for name, policy in policies.items():
        _scripted(monkeypatch, keys)
        buf = io.StringIO()
        with redirect_stdout(buf):
            got[name] = (policy.predict(obs), buf.getvalue())
    np.testing.assert_array_equal(got["port"][0], [4, 0, 5, 1])
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1]


def test_image_render_prints_the_frame(monkeypatch, capsys):
    policy = interactive.ImageObsDiscreteInteractivePolicy(
        Space.box(0, 255, (4, 4, 1)), Space.discrete(2), collections.OrderedDict([("a", "x"), ("b", "y")]),
        clear_screen_on_query=False)
    _scripted(monkeypatch, ["b"])
    frame = np.arange(16, dtype=np.uint8).reshape(4, 4, 1)
    assert int(policy._choose_action(frame)) == 1
    assert "Observation: image (4, 4, 1) uint8, values in [0, 15]" in capsys.readouterr().out


def test_rollout_fn_over_a_vector_env(monkeypatch):
    venv = make_vec_env("CartPole-v1", num_envs=3, max_episode_steps=5, device="cpu")
    policy = interactive.cartpole_interactive_policy(venv.observation_space, venv.action_space)
    keys = ["a", "d", "d"] * 5 + ["a"] * 30
    _scripted(monkeypatch, keys)
    with redirect_stdout(io.StringIO()):
        state, chunk = rollout.collect(venv, policy.as_rollout_fn(), venv.reset(torch.Generator().manual_seed(0)),
                                       5, torch.Generator().manual_seed(0))
    assert chunk.acts.dtype == torch.int32 and chunk.acts.device == chunk.obs.device
    np.testing.assert_array_equal(chunk.acts.numpy(), np.array([[0, 1, 1]] * 5))
