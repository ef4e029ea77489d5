"""parallel: hyper-parameter and seed sweeps over any experiment.

Port of ``imitation_tpu/scripts/parallel.py``: a grid or random sweep of one
experiment's config, repeated over seeds, each trial one ``run_cli`` under
``{run_root}/trial_<i>``, in this process or in ``spawn`` worker processes
(each worker puts its runs on the config's device, CUDA by default).

Search-space grammar (JSON-friendly):
    {"rl.learning_rate": {"grid": [1e-4, 3e-4]},
     "total_timesteps":  {"choice": [1000, 2000]}}
``grid`` keys are expanded combinatorially; ``choice`` keys are sampled
uniformly per trial (``num_samples`` trials).
"""

from __future__ import annotations

import itertools
import json
import multiprocessing as mp
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

EXPERIMENT_MODULES = {
    "train_rl": "imitation_tpu_torch.scripts.train_rl",
    "train_imitation": "imitation_tpu_torch.scripts.train_imitation",
    "train_adversarial": "imitation_tpu_torch.scripts.train_adversarial",
    "train_preference_comparisons": "imitation_tpu_torch.scripts.train_preference_comparisons",
    "eval_policy": "imitation_tpu_torch.scripts.eval_policy",
}


def _load_experiment(name: str):
    import importlib

    if name not in EXPERIMENT_MODULES:
        raise KeyError(f"unknown experiment {name!r}; options: {sorted(EXPERIMENT_MODULES)}")
    return importlib.import_module(EXPERIMENT_MODULES[name]).ex


def expand_search_space(
    search_space: Mapping[str, Mapping[str, Any]],
    num_samples: int,
    rng: np.random.Generator,
) -> List[Dict[str, Any]]:
    """Expands grid x sampled-choice keys into a list of override dicts."""
    grid_keys = {k: v["grid"] for k, v in search_space.items() if "grid" in v}
    choice_keys = {k: v["choice"] for k, v in search_space.items() if "choice" in v}
    grid_points = (
        [dict(zip(grid_keys, vals)) for vals in itertools.product(*grid_keys.values())]
        if grid_keys
        else [{}]
    )
    trials = []
    for point in grid_points:
        for _ in range(max(1, num_samples)):
            t = dict(point)
            for k, options in choice_keys.items():
                t[k] = options[int(rng.integers(len(options)))]
            trials.append(t)
    return trials


def _run_trial(args):
    (experiment_name, command, named_configs, overrides, run_root, trial_idx) = args
    ex = _load_experiment(experiment_name)
    argv: List[str] = []
    if command:
        argv.append(command)
    argv.append("with")
    argv.extend(named_configs)
    for k, v in overrides.items():
        argv.append(f"{k}={v!r}" if isinstance(v, str) else f"{k}={v}")
    argv.append(f"log_root={os.path.join(run_root, f'trial_{trial_idx:04d}')}")
    try:
        result = ex.run_cli(argv)
        return {"trial": trial_idx, "overrides": overrides, "result": result,
                "status": "COMPLETED"}
    except Exception as e:  # sweep must survive individual failures
        return {"trial": trial_idx, "overrides": overrides,
                "error": f"{type(e).__name__}: {e}", "status": "FAILED"}


def parallel_sweep(
    experiment_name: str,
    *,
    command: Optional[str] = None,
    named_configs: Sequence[str] = (),
    base_config_updates: Optional[Mapping[str, Any]] = None,
    search_space: Optional[Mapping[str, Mapping[str, Any]]] = None,
    num_samples: int = 1,
    seeds: Sequence[int] = (0,),
    run_root: str = "output/parallel",
    n_workers: int = 1,
    seed: int = 0,
) -> List[Dict[str, Any]]:
    """Runs the sweep; returns per-trial result records and writes
    ``sweep_results.json`` under ``run_root``."""
    rng = np.random.default_rng(seed)
    trials = expand_search_space(search_space or {}, num_samples, rng)
    jobs = []
    idx = 0
    for t in trials:
        for s in seeds:
            overrides = dict(base_config_updates or {})
            overrides.update(t)
            overrides["seed"] = s
            jobs.append(
                (experiment_name, command, list(named_configs), overrides, run_root, idx)
            )
            idx += 1
    os.makedirs(run_root, exist_ok=True)
    if n_workers > 1:
        ctx = mp.get_context("spawn")
        with ctx.Pool(n_workers) as pool:
            results = pool.map(_run_trial, jobs)
    else:
        results = [_run_trial(j) for j in jobs]
    with open(os.path.join(run_root, "sweep_results.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    return results


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("experiment")
    p.add_argument("--command", default=None)
    p.add_argument("--named", nargs="*", default=[])
    p.add_argument("--search-space", type=json.loads, default={})
    p.add_argument("--base-updates", type=json.loads, default={})
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--seeds", type=int, nargs="*", default=[0])
    p.add_argument("--run-root", default="output/parallel")
    p.add_argument("--workers", type=int, default=1)
    args = p.parse_args()
    results = parallel_sweep(
        args.experiment,
        command=args.command,
        named_configs=args.named,
        base_config_updates=args.base_updates,
        search_space=args.search_space,
        num_samples=args.num_samples,
        seeds=args.seeds,
        run_root=args.run_root,
        n_workers=args.workers,
    )
    n_ok = sum(r["status"] == "COMPLETED" for r in results)
    print(f"{n_ok}/{len(results)} trials completed")


if __name__ == "__main__":
    main()
