"""util/checkpoint.py: exact resume of the port's learner states.

For PPO, SAC and DQN on the CPU: run one train step, save, run another;
then restore the checkpoint into a fresh learner's ``init_state()`` and run
the second step again. The weights, the optimizer moments and count, the
env state, the replay ring and the generators' states must equal the
uninterrupted run's bit for bit: the same float32 operations on the same
values in the same order. Episodes are cut short (CartPole at 3 steps,
Pendulum at 5) so that the second step auto-resets envs, which draws from
the generator the RL state shares with its ``VecEnvState``.
"""

import dataclasses
import os

import pytest
import torch

from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.rl.dqn import DQN, DQNConfig
from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
from imitation_tpu_torch.rl.sac import SAC, SACConfig
from imitation_tpu_torch.util import checkpoint

torch.set_num_threads(1)


def _ppo():
    venv = make_vec_env("CartPole-v1", num_envs=4, max_episode_steps=3, device="cpu")
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space, normalize_features=True)
    return PPO(venv, policy, PPOConfig(n_steps=8, n_minibatches=2, n_epochs=2, normalize_rewards=True,
                                      lr_schedule="linear", total_updates_hint=4), seed=3)


def _sac():
    venv = make_vec_env("Pendulum-v1", num_envs=2, max_episode_steps=5, device="cpu")
    return SAC(venv, SACConfig(learning_starts=8, batch_size=8, train_freq=4, gradient_steps=2,
                               buffer_size=12, actor_hid_sizes=(16, 16), critic_hid_sizes=(16, 16)), seed=3)


def _dqn():
    venv = make_vec_env("CartPole-v1", num_envs=2, max_episode_steps=3, device="cpu")
    return DQN(venv, DQNConfig(learning_starts=4, batch_size=8, train_freq=4, gradient_steps=2,
                               buffer_size=12, target_update_interval=8, hid_sizes=(16,)),
               total_timesteps_hint=64, seed=3)


LEARNERS = {"ppo": _ppo, "sac": _sac, "dqn": _dqn}


def _flat(tree, prefix=""):
    """Every tensor, number and generator state of a state, by path."""
    out = {}
    if isinstance(tree, torch.nn.Module):
        for k, v in tree.state_dict().items():
            out[f"{prefix}.{k}"] = v
    elif isinstance(tree, torch.optim.Optimizer):
        sd = tree.state_dict()
        out[f"{prefix}.count"] = sd["count"]
        for i, s in sd["state"].items():
            for k, v in s.items():
                out[f"{prefix}.{i}.{k}"] = v
    elif isinstance(tree, torch.Generator):
        out[prefix] = tree.get_state()
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(_flat(getattr(tree, f.name), f"{prefix}.{f.name}"))
    else:
        out[prefix] = tree
    return out


def _step(algo, state):
    return algo.train_step(state)[0]


@pytest.mark.parametrize("name", list(LEARNERS))
def test_resume_is_bitwise(tmp_path, name):
    algo = LEARNERS[name]()
    state = _step(algo, algo.init_state())
    path = str(tmp_path / "ckpt" / "state.pt")
    checkpoint.save_state(path, state)
    want = _flat(_step(algo, state))

    fresh = LEARNERS[name]()
    template = fresh.init_state(torch.Generator().manual_seed(99))
    restored = checkpoint.restore_state(path, template)
    assert restored.generator is template.generator is restored.env_state.generator
    got = _flat(_step(fresh, restored))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    assert got[".timesteps"] > 0 and not any(isinstance(v, torch.Tensor) and v.is_floating_point()
                                             and not torch.isfinite(v).all() for v in got.values())


def test_checkpoint_holds_only_plain_data(tmp_path):
    """The file loads with ``weights_only=True`` and names no class."""
    algo = _sac()
    path = str(tmp_path / "s.pt")
    checkpoint.save_state(path, algo.init_state())
    saved = torch.load(path, weights_only=True)
    assert saved["type"] == "SACState"
    assert not os.path.exists(path + ".tmp")


def test_restore_refuses_a_template_that_shares_generators_otherwise(tmp_path):
    algo = _ppo()
    state = algo.init_state()
    path = str(tmp_path / "p.pt")
    checkpoint.save_state(path, state)
    template = _ppo().init_state()
    template = template.replace(env_state=dataclasses.replace(template.env_state, generator=torch.Generator()))
    with pytest.raises(ValueError, match="shares its generators"):
        checkpoint.restore_state(path, template)
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.restore_state(path, _sac().init_state())


def test_manager_retention_and_latest(tmp_path):
    manager = checkpoint.CheckpointManager(str(tmp_path / "run"), max_to_keep=2, save_every=2)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        manager.restore_latest({"x": torch.zeros(2)})
    assert manager.latest_step() is None
    saved = [manager.maybe_save(step, {"x": torch.full((2,), float(step)), "step": step, "name": "run"})
             for step in range(7)]
    assert saved == [True, False, True, False, True, False, True]
    assert manager.all_steps() == [4, 6] and manager.latest_step() == 6
    out = manager.restore_latest({"x": torch.zeros(2), "step": 0, "name": ""})
    assert torch.equal(out["x"], torch.full((2,), 6.0)) and out["step"] == 6 and out["name"] == "run"
    assert sorted(os.listdir(tmp_path / "run")) == ["step_000000000004.pt", "step_000000000006.pt"]
