"""The port's CLI end to end on the CPU (``device=cpu``), against the JAX
package's own CLI runs.

Every command runs ``with fast`` and leaves ``config.json``, ``run.json``
(``COMPLETED`` with its result), ``progress.csv`` and its checkpoints under
the relative names the JAX package's ``fast`` run writes. Three kinds of
file keep a format of each package's own, and are compared by role: weights
(``variables.msgpack`` there, ``policy.pt`` / ``reward_net.pt`` here),
trajectories (a HuggingFace directory there, ``trajectories.npz`` here) and
DAgger's trainer checkpoint (``.pkl`` there, ``.pt`` here). AIRL's layout
and result keys are compared with a JAX run made in this module; the other
commands' layouts were listed from the JAX package's ``fast`` runs.

The JAX run's reward net and generator policy load in the port's CLI: the
reward transfer of ``train_rl`` runs on it and the loaded reward equals the
JAX loader's, and a GAIL trainer warm-started from the JAX policy
(``agent_path``) acts as the JAX policy does. A run that raises records
``FAILED``; with no CUDA and no ``device`` a run raises (no CPU fallback).
"""

import json
import os
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from imitation_tpu.envs import make_vec_env as jax_make_vec_env
from imitation_tpu.policies import serialize as jax_policy_serialize
from imitation_tpu.rewards import serialize as jax_reward_serialize
from imitation_tpu.scripts import train_adversarial as jax_train_adversarial
from imitation_tpu_torch.algorithms.adversarial import common
from imitation_tpu_torch.rewards import serialize as reward_serialize
from imitation_tpu_torch.scripts import (
    eval_policy,
    train_adversarial,
    train_imitation,
    train_preference_comparisons,
    train_rl,
)

torch.set_num_threads(1)

SCRIPTS = {m.ex.name: m for m in (train_rl, train_imitation, train_adversarial,
                                  train_preference_comparisons, eval_policy)}
FORMATS = [
    (r"(variables\.msgpack|policy\.pt|reward_net\.pt)$", "<weights>"),
    (r"(data-\d+-of-\d+\.arrow|dataset_info\.json|state\.json|trajectories\.npz)$", "<trajectories>"),
    (r"checkpoint-(\d+|latest)\.(pkl|pt)$", r"checkpoint-\1.<trainer>"),
    (r"dagger-demo-\d+", "dagger-demo-<i>"),
]
LOGS = {"config.json", "run.json", "progress.csv", "progress.json"}
POLICY = {"policy_config.json", "<weights>"}
REWARD = {"reward_config.json", "<weights>"}


def under(prefix, names):
    return {f"{prefix}/{n}" for n in names}


# The files of each command's ``fast`` run in the JAX package, by role.
JAX_LAYOUT = {
    ("train_rl",): LOGS | under("policies/final", POLICY) | {"rollouts/final/<trajectories>"},
    ("train_imitation", "bc"): LOGS | under("policies/final", POLICY),
    ("train_imitation", "dagger"): LOGS | {
        "scratch/checkpoint-001.<trainer>", "scratch/checkpoint-latest.<trainer>",
        "scratch/demos/round-000/dagger-demo-<i>/<trajectories>",
    } | under("scratch/policy-001", POLICY) | under("scratch/policy-latest", POLICY),
    ("train_imitation", "sqil"): LOGS | under("raw/sqil", {"progress.csv", "progress.json"}),
    ("train_adversarial", "gail"): LOGS | under("raw/disc", {"progress.csv", "progress.json"})
    | under("raw/gen", {"progress.csv", "progress.json"}) | under("checkpoints/final/gen_policy", POLICY)
    | under("checkpoints/final/reward_train", REWARD) | under("checkpoints/final/reward_test", REWARD),
    ("train_preference_comparisons",): LOGS | {"preferences.pkl"}
    | under("checkpoints/final/policy", POLICY) | under("checkpoints/final/reward_net", REWARD)
    | {f"raw/{d}/progress.{x}" for d in ("agent", "preferences", "reward") for x in ("csv", "json")},
    ("eval_policy",): set(LOGS),
}
JAX_LAYOUT[("train_adversarial", "airl")] = JAX_LAYOUT[("train_adversarial", "gail")]
COMMANDS = sorted(JAX_LAYOUT)
FAST = ["with", "fast", "log_format_strs=['csv','json']"]


def run_dir_of(root):
    """The one run directory under ``root/<env>/``."""
    dirs = [p for env in pathlib.Path(root).iterdir() for p in env.iterdir()
            if p.is_dir() and not p.is_symlink()]
    assert len(dirs) == 1, dirs
    return dirs[0]


def layout(run_dir):
    names = set()
    for root, _, files in os.walk(run_dir):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), run_dir)
            for pattern, repl in FORMATS:
                rel = re.sub(pattern, repl, rel)
            names.add(rel)
    return names


def run_port(command, tmp_path, *extra):
    script, *cmd = command
    result = SCRIPTS[script].ex.run_cli(cmd + FAST + ["device=cpu", f"log_root={tmp_path}", *extra])
    return result, run_dir_of(tmp_path)


@pytest.fixture(scope="module")
def jax_airl(tmp_path_factory):
    """One ``train_adversarial airl with fast`` run of the JAX package."""
    root = tmp_path_factory.mktemp("jax_airl")
    result = jax_train_adversarial.ex.run_cli(["airl"] + FAST + [f"log_root={root}"])
    return result, run_dir_of(root)


def stats_keys(jax_airl):
    return sorted(jax_airl[0]["imit_stats"])


def expected_result_keys(command, jax_airl):
    if command[0] in ("train_rl", "eval_policy"):
        return stats_keys(jax_airl)
    if command[0] == "train_preference_comparisons":
        return ["reward_accuracy", "reward_loss", "rollout"]
    return ["imit_stats"]


@pytest.mark.parametrize("command", COMMANDS, ids=[" ".join(c) for c in COMMANDS])
def test_fast_run_completes_with_the_jax_layout(command, tmp_path, jax_airl):
    result, run_dir = run_port(command, tmp_path)
    run = json.loads((run_dir / "run.json").read_text())
    assert run["status"] == "COMPLETED" and run["experiment"]["name"] == command[0]
    assert sorted(run["result"]) == sorted(result) == expected_result_keys(command, jax_airl)
    stats = result.get("imit_stats") or result.get("rollout") or result
    assert sorted(stats) == stats_keys(jax_airl) and np.isfinite(stats["return_mean"])
    assert json.loads((run_dir / "config.json").read_text())["device"] == "cpu"
    assert len((run_dir / "progress.csv").read_text().splitlines()) >= 2
    assert layout(run_dir) == JAX_LAYOUT[command]
    assert (run_dir.parent / "latest").resolve() == run_dir.resolve()


def test_airl_layout_equals_the_jax_run(jax_airl, tmp_path):
    jax_result, jax_dir = jax_airl
    result, run_dir = run_port(("train_adversarial", "airl"), tmp_path)
    assert layout(run_dir) == layout(jax_dir) == JAX_LAYOUT[("train_adversarial", "airl")]
    assert sorted(result["imit_stats"]) == sorted(jax_result["imit_stats"])
    jax_config = json.loads((jax_dir / "config.json").read_text())
    config = json.loads((run_dir / "config.json").read_text())
    assert config.pop("device") == "cpu"
    assert config.pop("log_root") != jax_config.pop("log_root")
    assert config == jax_config


def test_reward_transfer_from_the_jax_run(jax_airl, tmp_path):
    """``train_rl`` on the JAX run's shaped reward, unshaped; the reward the
    port loads equals the JAX loader's on seeded observations."""
    reward_path = str(jax_airl[1] / "checkpoints" / "final" / "reward_test")
    result, run_dir = run_port(("train_rl",), tmp_path, "reward_type=RewardNet_unshaped",
                               f"reward_path={reward_path}")
    assert json.loads((run_dir / "run.json").read_text())["status"] == "COMPLETED"
    assert np.isfinite(result["return_mean"])

    rng = np.random.default_rng(0)
    obs = rng.normal(scale=0.5, size=(64, 4)).astype(np.float32)
    next_obs = rng.normal(scale=0.5, size=(64, 4)).astype(np.float32)
    acts = rng.integers(0, 2, 64).astype(np.int32)
    dones = (rng.random(64) < 0.1).astype(np.float32)
    want = jax_reward_serialize.load_reward("RewardNet_unshaped", reward_path,
                                            jax_make_vec_env("CartPole-v1", num_envs=2))(obs, acts, next_obs, dones)
    got = reward_serialize.load_reward("RewardNet_unshaped", reward_path, device="cpu")(obs, acts, next_obs, dones)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_agent_path_warm_starts_from_the_jax_policy(jax_airl, tmp_path, monkeypatch):
    """A ``gail with fast agent_path=<JAX gen_policy>`` trainer, caught
    before it trains, acts as the JAX policy does on seeded observations."""
    path = str(jax_airl[1] / "checkpoints" / "final" / "gen_policy")
    trainers = []
    monkeypatch.setattr(common.AdversarialTrainer, "train",
                        lambda self, total_timesteps, callback=None: trainers.append(self))
    run_port(("train_adversarial", "gail"), tmp_path, f"agent_path={path}")
    (trainer,) = trainers

    jpolicy, jvars = jax_policy_serialize.load_policy_from_path(path)
    obs = np.random.default_rng(1).normal(scale=0.5, size=(256, 4)).astype(np.float32)
    want_acts = np.asarray(jpolicy.deterministic_fn()(jvars, obs, jax.random.key(0))[0])
    want_lp = [np.asarray(jpolicy.distribution(jvars, obs).log_prob(np.full(256, a, np.int32))) for a in (0, 1)]
    with torch.no_grad():
        got_acts = trainer.policy.deterministic_fn()(torch.from_numpy(obs))[0].numpy()
        dist = trainer.policy.distribution(torch.from_numpy(obs))
        got_lp = [dist.log_prob(torch.full((256,), a, dtype=torch.int32)).numpy() for a in (0, 1)]
    np.testing.assert_array_equal(got_acts, want_acts)
    assert 0 < want_acts.sum() < 256  # both actions occur
    for got, want in zip(got_lp, want_lp):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the checkpoint written without training holds the JAX weights too
    saved = json.loads((run_dir_of(tmp_path) / "checkpoints" / "final" / "gen_policy" / "policy_config.json")
                       .read_text())
    assert saved["hid_sizes"] == [32, 32]


FAILING = [
    (("train_adversarial", "gail"), ["demonstrations.source=local", "demonstrations.path=/no/such/demos"],
     FileNotFoundError),
    (("train_adversarial", "gail"), ["rl.overlap_collection=True"], NotImplementedError),
    (("eval_policy",), ["videos=True"], NotImplementedError),
    # A model.zip policy type with no loader_kwargs.path: the JAX package's TypeError.
    (("train_imitation", "bc"), ["expert.policy_type=ppo"], TypeError),
]


@pytest.mark.parametrize("command,extra,error", FAILING, ids=[" ".join(e) for _, e, _ in FAILING])
def test_a_run_that_raises_records_failed(command, extra, error, tmp_path):
    with pytest.raises(error):
        run_port(command, tmp_path, *extra)
    run = json.loads((run_dir_of(tmp_path) / "run.json").read_text())
    assert run["status"] == "FAILED" and run["error"].startswith(error.__name__)


@pytest.mark.parametrize("command", [("train_rl",), ("train_adversarial", "gail")])
def test_no_cuda_and_no_device_raises(command, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    script, *cmd = command
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SCRIPTS[script].ex.run_cli(cmd + FAST + [f"log_root={tmp_path}"])
    run = json.loads((run_dir_of(tmp_path) / "run.json").read_text())
    assert run["status"] == "FAILED" and "CUDA" in run["error"]


def test_normalized_input_reward_checkpoint_reloads(tmp_path):
    """A reward net with an input normalizer (the seals tuned configs'
    ``reward.normalize_input``) is saved with that flag, so its checkpoint
    loads with its statistics and gives the trainer's rewards."""
    run_port(("train_adversarial", "airl"), tmp_path, "reward.normalize_input=True")
    path = run_dir_of(tmp_path) / "checkpoints" / "final" / "reward_test"
    config = json.loads((path / "reward_config.json").read_text())
    assert config["net_kwargs"] == {"normalize_input": True}
    net = reward_serialize.load_reward_net(str(path), device="cpu")
    assert net.base.input_norm is not None and float(net.base.input_norm.count) > 0
