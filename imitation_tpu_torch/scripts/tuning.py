"""tuning: two-phase hyperparameter tuning.

Port of ``imitation_tpu/scripts/tuning.py``: phase 1 sweeps a search space
through ``parallel``; phase 2 groups the trials by config across seeds,
picks the best mean return and runs that config again on fresh seeds.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from imitation_tpu_torch.scripts.parallel import parallel_sweep


def _result_return(record: Mapping[str, Any]) -> Optional[float]:
    result = record.get("result") or {}
    stats = result.get("imit_stats") or result.get("rollout") or result
    if not isinstance(stats, Mapping):
        return None
    for k in ("monitor_return_mean", "return_mean"):
        if k in stats and stats[k] is not None:
            return float(stats[k])
    return None


def find_best_trial(results: Sequence[Mapping[str, Any]]):
    """The overrides (the seed aside) with the best mean return over
    their seeds, and that mean."""
    groups: Dict[str, List[float]] = defaultdict(list)
    group_overrides: Dict[str, Dict[str, Any]] = {}
    for rec in results:
        if rec.get("status") != "COMPLETED":
            continue
        ret = _result_return(rec)
        if ret is None:
            continue
        overrides = {k: v for k, v in rec["overrides"].items() if k != "seed"}
        key = json.dumps(overrides, sort_keys=True, default=str)
        groups[key].append(ret)
        group_overrides[key] = overrides
    if not groups:
        raise RuntimeError("no successful trials with returns found")
    best_key = max(groups, key=lambda k: float(np.mean(groups[k])))
    return group_overrides[best_key], float(np.mean(groups[best_key]))


def tune(
    experiment_name: str,
    *,
    command: Optional[str] = None,
    named_configs: Sequence[str] = (),
    base_config_updates: Optional[Mapping[str, Any]] = None,
    search_space: Mapping[str, Mapping[str, Any]],
    num_samples: int = 1,
    tune_seeds: Sequence[int] = (0, 1),
    eval_seeds: Sequence[int] = (100, 101, 102, 103, 104),
    run_root: str = "output/tuning",
    n_workers: int = 1,
) -> Dict[str, Any]:
    """The phase 1 sweep, then the phase 2 runs of its best config."""
    results = parallel_sweep(
        experiment_name,
        command=command,
        named_configs=named_configs,
        base_config_updates=base_config_updates,
        search_space=search_space,
        num_samples=num_samples,
        seeds=tune_seeds,
        run_root=f"{run_root}/phase1",
        n_workers=n_workers,
    )
    best_overrides, tune_mean = find_best_trial(results)
    eval_results = parallel_sweep(
        experiment_name,
        command=command,
        named_configs=named_configs,
        base_config_updates={**(base_config_updates or {}), **best_overrides},
        search_space={},
        num_samples=1,
        seeds=eval_seeds,
        run_root=f"{run_root}/phase2_eval",
        n_workers=n_workers,
    )
    eval_returns = [
        r for r in (_result_return(rec) for rec in eval_results) if r is not None
    ]
    summary = {
        "best_overrides": best_overrides,
        "tune_mean_return": tune_mean,
        "eval_returns": eval_returns,
        "eval_mean_return": float(np.mean(eval_returns)) if eval_returns else None,
    }
    with open(f"{run_root}/tuning_summary.json", "w") as f:
        json.dump(summary, f, indent=2, default=str)
    return summary


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("experiment")
    p.add_argument("--command", default=None)
    p.add_argument("--named", nargs="*", default=[])
    p.add_argument("--search-space", type=json.loads, required=True)
    p.add_argument("--base-updates", type=json.loads, default={})
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--tune-seeds", type=int, nargs="*", default=[0, 1])
    p.add_argument("--eval-seeds", type=int, nargs="*", default=[100, 101, 102, 103, 104])
    p.add_argument("--run-root", default="output/tuning")
    p.add_argument("--workers", type=int, default=1)
    args = p.parse_args()
    summary = tune(
        args.experiment,
        command=args.command,
        named_configs=args.named,
        base_config_updates=args.base_updates,
        search_space=args.search_space,
        num_samples=args.num_samples,
        tune_seeds=args.tune_seeds,
        eval_seeds=args.eval_seeds,
        run_root=args.run_root,
        n_workers=args.workers,
    )
    print(json.dumps(summary, indent=2, default=str))


if __name__ == "__main__":
    main()
