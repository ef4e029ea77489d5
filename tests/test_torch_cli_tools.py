"""The port's CLI tools against the JAX package's: the sweep's search-space
expansion and best-trial choice, ``analyze`` over run directories, the
run-directory helpers, ``convert_trajs`` and the ``python -m`` dispatcher.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import imitation_tpu.__main__ as jax_main
from imitation_tpu.data import serialize as jax_serialize
from imitation_tpu.data import types as jax_types
from imitation_tpu.scripts import analyze as jax_analyze
from imitation_tpu.scripts import parallel as jax_parallel
from imitation_tpu.scripts import tuning as jax_tuning
from imitation_tpu.util import run_dirs as jax_run_dirs
import imitation_tpu_torch.__main__ as port_main
from imitation_tpu_torch.data import huggingface_utils, serialize, types
from imitation_tpu_torch.scripts import analyze, parallel, tuning
from imitation_tpu_torch.scripts.convert_trajs import update_traj_file_in_place
from imitation_tpu_torch.util import run_dirs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPACES = [
    {"a": {"grid": [1, 2]}, "b": {"grid": [10, 20]}},
    {"rl.learning_rate": {"choice": [1e-4, 3e-4, 1e-3]}, "total_timesteps": {"choice": [1000, 2000]}},
    {"a": {"grid": ["x", "y", "z"]}, "c": {"choice": [0.1, 0.2, 0.3, 0.4]}},
    {},
]


@pytest.mark.parametrize("space", SPACES, ids=range(len(SPACES)))
@pytest.mark.parametrize("num_samples", [1, 5])
def test_expand_search_space_draws_as_jax(space, num_samples):
    got = parallel.expand_search_space(space, num_samples, np.random.default_rng(7))
    want = jax_parallel.expand_search_space(space, num_samples, np.random.default_rng(7))
    assert got == want


def sweep_records(seed):
    rng = np.random.default_rng(seed)
    records = []
    for i in range(12):
        overrides = {"rl.learning_rate": [1e-4, 3e-4, 1e-3][i % 3], "seed": i // 3}
        kind = ["imit_stats", "rollout", "flat", "failed"][int(rng.integers(4))]
        stats = {"return_mean": float(rng.normal(100, 30))}
        if rng.random() < 0.5:
            stats["monitor_return_mean"] = float(rng.normal(100, 30))
        result = {"imit_stats": stats} if kind == "imit_stats" else {"rollout": stats} if kind == "rollout" \
            else stats
        records.append({"trial": i, "overrides": overrides, "result": result,
                        "status": "FAILED" if kind == "failed" else "COMPLETED"})
    return records


@pytest.mark.parametrize("seed", range(4))
def test_find_best_trial_agrees_with_jax(seed):
    records = sweep_records(seed)
    assert tuning.find_best_trial(records) == jax_tuning.find_best_trial(records)


def write_run(root, name, config, run):
    d = os.path.join(root, *name.split("/"))
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(d, "run.json"), "w") as f:
        json.dump(run, f)


@pytest.fixture
def run_tree(tmp_path):
    """Run directories of several experiments, results and statuses."""
    stats = lambda m: {"return_mean": m, "return_std": m / 10, "n_traj": 4}
    runs = [
        ("train_adversarial/CartPole-v1/a", "CartPole-v1", 0, "COMPLETED", {"imit_stats": stats(480.0)}),
        ("train_adversarial/CartPole-v1/b", "CartPole-v1", 1, "COMPLETED",
         {"imit_stats": dict(stats(20.0), monitor_return_mean=21.5)}),
        ("train_preference_comparisons/Pendulum-v1/c", "Pendulum-v1", 0, "COMPLETED",
         {"reward_loss": 0.5, "rollout": stats(-150.0)}),
        ("train_rl/Pendulum-v1/d", "Pendulum-v1", 2, "COMPLETED", stats(-170.25)),
        ("eval_policy/CartPole-v1/e", "CartPole-v1", 3, "FAILED", None),
    ]
    for name, env, seed, status, result in runs:
        write_run(str(tmp_path), name, {"env_name": env, "seed": seed, "total_timesteps": 1000 + seed},
                  {"experiment": {"name": name.split("/")[0]}, "status": status, "result": result})
    os.makedirs(tmp_path / "not_a_run")
    return tmp_path


ANALYZE = [dict(verbosity_level=1, skip_failed_runs=True), dict(verbosity_level=2, skip_failed_runs=True),
           dict(verbosity_level=2, skip_failed_runs=True, env_name="Pendulum-v1")]


@pytest.mark.parametrize("kwargs", ANALYZE, ids=range(len(ANALYZE)))
def test_analyze_rows_equal_the_jax_dataframe(run_tree, kwargs, tmp_path):
    got = analyze.analyze_imitation(str(run_tree), csv_output_path=str(tmp_path / "port.csv"), **kwargs)
    want = jax_analyze.analyze_imitation(str(run_tree), csv_output_path=str(tmp_path / "jax.csv"), **kwargs)
    key = lambda r: (r["exp_name"], r["seed"])
    assert sorted(got, key=key) == sorted(want.to_dict("records"), key=key)
    assert [list(r) for r in got] == [list(want.columns)] * len(got)
    port_lines = (tmp_path / "port.csv").read_text().splitlines()
    jax_lines = (tmp_path / "jax.csv").read_text().splitlines()
    assert port_lines[0] == jax_lines[0] and sorted(port_lines[1:]) == sorted(jax_lines[1:])
    table = analyze.format_table(got)
    assert len(table.splitlines()) == len(got) + 1 and "imit_return_mean" in table


def test_analyze_failed_runs_are_kept_without_skip(run_tree):
    rows = analyze.analyze_imitation([str(run_tree)])
    assert len(rows) == len(jax_analyze.analyze_imitation([str(run_tree)])) == 5
    assert sorted(r["status"] for r in rows).count("FAILED") == 1


def test_run_dirs_agree_with_jax(run_tree):
    got = run_dirs.filter_subdirs(run_tree)
    assert got == jax_run_dirs.filter_subdirs(run_tree) and len(got) == 5
    loaded = run_dirs.RunDicts.load_from_dir(got[0])
    assert tuple(loaded) == tuple(jax_run_dirs.RunDicts.load_from_dir(got[0]))
    write_run(str(got[0]), "nested", {}, {})
    for mod in (run_dirs, jax_run_dirs):
        with pytest.raises(ValueError, match="nested"):
            mod.filter_subdirs(run_tree)
    assert len(run_dirs.filter_subdirs(run_tree, nested_ok=True)) == 6
    for mod in (run_dirs, jax_run_dirs):
        mod.link_latest(got[0].parent, got[0])
        mod.link_latest(got[0].parent, got[1])  # replaced
    assert (got[0].parent / "latest").resolve() == got[1].resolve()


def trajectories(seed, n=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(3, 12))
        out.append(types.TrajectoryWithRew(
            obs=rng.normal(size=(length + 1, 4)).astype(np.float32),
            acts=rng.integers(0, 2, length).astype(np.int32), infos=None, terminal=bool(i % 2),
            rews=rng.normal(size=length).astype(np.float64)))
    return out


def assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for field in ("obs", "acts", "rews"):
            np.testing.assert_array_equal(np.asarray(getattr(a, field)), np.asarray(getattr(b, field)))
        assert bool(a.terminal) == bool(b.terminal)


def test_convert_trajs_round_trips_a_port_directory(tmp_path):
    trajs = trajectories(0)
    serialize.save(str(tmp_path / "demos"), trajs)
    assert update_traj_file_in_place(tmp_path / "demos") == tmp_path / "demos"
    assert_same(serialize.load(str(tmp_path / "demos")), trajs)


def test_convert_trajs_reads_what_the_jax_package_saved(tmp_path):
    trajs = trajectories(1)
    jax_serialize.save(str(tmp_path / "hf"), [jax_types.TrajectoryWithRew(
        obs=t.obs, acts=t.acts, infos=None, terminal=t.terminal, rews=t.rews) for t in trajs])
    assert not (tmp_path / "hf" / serialize.NPZ_NAME).exists()
    before = (tmp_path / "hf" / huggingface_utils.SHARD_NAME).read_bytes()
    update_traj_file_in_place(str(tmp_path / "hf"))
    # Rewritten in place by the port's own HuggingFace writer.
    assert not (tmp_path / "hf" / serialize.NPZ_NAME).exists()
    assert (tmp_path / "hf" / huggingface_utils.SHARD_NAME).read_bytes() != before
    assert_same(serialize.load(str(tmp_path / "hf")), trajs)


def test_convert_trajs_main(tmp_path, monkeypatch, capsys):
    legacy = tmp_path / "legacy.npz"
    serialize._save_npz(str(tmp_path / "tmp"), trajectories(2))
    os.replace(tmp_path / "tmp" / serialize.NPZ_NAME, legacy)
    monkeypatch.setattr(sys, "argv", ["python -m imitation_tpu_torch", "convert_trajs", str(legacy)])
    port_main.main()
    assert "converted" in capsys.readouterr().out
    assert_same(serialize.load(str(tmp_path / "legacy")), trajectories(2))


DISPATCH = [[], ["--help"], ["-h"], ["no_such_script"]]


@pytest.mark.parametrize("args", DISPATCH, ids=[" ".join(a) or "none" for a in DISPATCH])
def test_dispatcher_exits_as_jax(args, monkeypatch):
    codes = []
    for mod in (jax_main, port_main):
        monkeypatch.setattr(sys, "argv", ["prog"] + args)
        with pytest.raises(SystemExit) as info, redirect_stdout(io.StringIO()):
            mod.main()
        codes.append(info.value.code)
    assert codes[0] == codes[1]
    assert sorted(port_main.SCRIPTS) == sorted(jax_main.SCRIPTS)
    assert sorted(port_main.MAIN_SCRIPTS) == sorted(jax_main.MAIN_SCRIPTS)


def test_python_m_help_and_a_fast_run(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "imitation_tpu_torch", "--help"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "train_adversarial" in out.stdout
    out = subprocess.run([sys.executable, "-m", "imitation_tpu_torch", "eval_policy", "with", "fast",
                          "device=cpu", f"log_root={tmp_path}"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    (run_dir,) = run_dirs.filter_subdirs(tmp_path)
    assert json.loads((run_dir / "run.json").read_text())["result"]["return_mean"] == 20.0


def test_parallel_sweep_in_spawned_workers(tmp_path):
    """Two seeds of ``eval_policy with fast device=cpu`` in two spawned
    workers, one failing trial, then analyze and the best trial."""
    results = parallel.parallel_sweep(
        "eval_policy", named_configs=["fast"], base_config_updates={"device": "cpu"},
        search_space={"max_episode_steps": {"grid": [10, 20]}}, seeds=[0, 1],
        run_root=str(tmp_path), n_workers=2,
    )
    assert [r["status"] for r in results] == ["COMPLETED"] * 4
    assert json.loads((tmp_path / "sweep_results.json").read_text())[0]["trial"] == 0
    rows = analyze.analyze_imitation(str(tmp_path), verbosity_level=2)
    assert sorted(r["imit_return_mean"] for r in rows) == [10.0, 10.0, 20.0, 20.0]
    best, mean = tuning.find_best_trial(results)
    assert best == {"device": "cpu", "max_episode_steps": 20} and mean == 20.0
    failed = parallel.parallel_sweep("eval_policy", named_configs=["fast"],
                                     base_config_updates={"device": "cpu", "env_name": "NoSuchEnv-v99"},
                                     run_root=str(tmp_path / "bad"))
    assert failed[0]["status"] == "FAILED" and "KeyError" in failed[0]["error"]
