"""analyze: summarize run directories into a table.

Port of ``imitation_tpu/scripts/analyze.py`` without pandas:
``analyze_imitation`` walks the run directories (each holding the
``config.json`` and ``run.json`` that ``scripts/config.py`` writes), filters
them and returns one row (a dict) per run, with the columns of the JAX
package's DataFrame in its order, optionally written as csv;
``gather_tb_directories`` collects TensorBoard directories in one place.

    python -m imitation_tpu_torch analyze output/train_adversarial --verbosity 2
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Mapping, Optional


def _walk_runs(source_dirs) -> List[Dict[str, Any]]:
    runs = []
    if isinstance(source_dirs, (str, os.PathLike)):
        # a bare string would otherwise be walked one character at a time
        source_dirs = [source_dirs]
    for source in source_dirs:
        for root, dirs, files in os.walk(source):
            if "run.json" in files and "config.json" in files:
                try:
                    with open(os.path.join(root, "config.json")) as f:
                        config = json.load(f)
                    with open(os.path.join(root, "run.json")) as f:
                        run = json.load(f)
                    runs.append({"dir": root, "config": config, "run": run})
                except (json.JSONDecodeError, OSError):
                    continue
    return runs


def _get(d: Mapping, dotted: str, default=None):
    node = d
    for p in dotted.split("."):
        if not isinstance(node, Mapping) or p not in node:
            return default
        node = node[p]
    return node


def analyze_imitation(
    source_dirs,
    *,
    env_name: Optional[str] = None,
    skip_failed_runs: bool = False,
    csv_output_path: Optional[str] = None,
    verbosity_level: int = 1,
) -> List[Dict[str, Any]]:
    """One row per run: ``status``, ``exp_name``, ``env_name``, ``seed``,
    ``imit_return_mean``, and at ``verbosity_level`` 2 also ``dir``,
    ``total_timesteps``, ``imit_return_std`` and ``n_traj``."""
    rows = []
    for rec in _walk_runs(source_dirs):
        config, run = rec["config"], rec["run"]
        status = run.get("status")
        if skip_failed_runs and status != "COMPLETED":
            continue
        if env_name is not None and config.get("env_name") != env_name:
            continue
        result = run.get("result") or {}
        imit_stats = result.get("imit_stats") or result.get("rollout") or result
        row = {
            "status": status,
            "exp_name": run.get("experiment", {}).get("name"),
            "env_name": config.get("env_name"),
            "seed": config.get("seed"),
            "imit_return_mean": _get(imit_stats, "monitor_return_mean",
                                     _get(imit_stats, "return_mean")),
        }
        if verbosity_level >= 2:
            row.update(
                {
                    "dir": rec["dir"],
                    "total_timesteps": config.get("total_timesteps"),
                    "imit_return_std": _get(imit_stats, "return_std"),
                    "n_traj": _get(imit_stats, "n_traj"),
                }
            )
        rows.append(row)
    if csv_output_path is not None:
        with open(csv_output_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]) if rows else [])
            writer.writeheader()
            writer.writerows(rows)
    return rows


def format_table(rows: List[Dict[str, Any]]) -> str:
    """The rows as a plain text table, one line per row under a header."""
    if not rows:
        return "(no runs)"
    columns = list(rows[0])
    cells = [columns] + [["" if r.get(c) is None else str(r.get(c)) for c in columns] for r in rows]
    widths = [max(len(line[i]) for line in cells) for i in range(len(columns))]
    return "\n".join("  ".join(v.rjust(w) for v, w in zip(line, widths)) for line in cells)


def gather_tb_directories(source_dirs, tb_output_dir: Optional[str] = None) -> Dict[str, Any]:
    """Symlinks (or copies) each run's TensorBoard event directories into
    ``tb_output_dir`` (a new temporary directory by default)."""
    if tb_output_dir is None:
        tb_output_dir = tempfile.mkdtemp(prefix="analyze_tb_")
    os.makedirs(tb_output_dir, exist_ok=True)
    n = 0
    for rec in _walk_runs(source_dirs):
        for root, dirs, files in os.walk(rec["dir"]):
            if any(f.startswith("events.out.tfevents") for f in files):
                dst = os.path.join(tb_output_dir, f"run_{n:04d}")
                try:
                    os.symlink(os.path.abspath(root), dst)
                except OSError:
                    shutil.copytree(root, dst, dirs_exist_ok=True)
                n += 1
    return {"gather_dir": tb_output_dir, "n_tb_dirs": n}


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("source_dirs", nargs="+")
    p.add_argument("--env-name", default=None)
    p.add_argument("--csv", default=None)
    p.add_argument("--verbosity", type=int, default=1)
    p.add_argument("--skip-failed", action="store_true")
    args = p.parse_args()
    rows = analyze_imitation(
        args.source_dirs,
        env_name=args.env_name,
        skip_failed_runs=args.skip_failed,
        csv_output_path=args.csv,
        verbosity_level=args.verbosity,
    )
    print(format_table(rows))


if __name__ == "__main__":
    main()
