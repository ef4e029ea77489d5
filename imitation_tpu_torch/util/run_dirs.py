"""Run-directory utilities.

Port of ``imitation_tpu/util/run_dirs.py``: every CLI run writes
``config.json`` / ``run.json`` into its run directory
(``scripts/config.py``). ``RunDicts`` loads the pair, ``filter_subdirs``
finds run directories under a root, and ``link_latest`` keeps the
``{log_root}/latest`` symlink on the newest run.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Callable, NamedTuple, Sequence


class RunDicts(NamedTuple):
    """``config.json`` and ``run.json`` of one run directory."""

    run_dir: pathlib.Path
    config: dict
    run: dict

    @classmethod
    def load_from_dir(cls, run_dir) -> "RunDicts":
        run_dir = pathlib.Path(run_dir)
        return cls(
            run_dir=run_dir,
            config=json.loads((run_dir / "config.json").read_text()),
            run=json.loads((run_dir / "run.json").read_text()),
        )


def dir_contains_run_jsons(dir_path: pathlib.Path) -> bool:
    """Whether ``dir_path`` holds both ``run.json`` and ``config.json``."""
    dir_path = pathlib.Path(dir_path)
    return (dir_path / "run.json").is_file() and (dir_path / "config.json").is_file()


def filter_subdirs(
    root_dir,
    filter_fn: Callable[[pathlib.Path], bool] = dir_contains_run_jsons,
    *,
    nested_ok: bool = False,
) -> Sequence[pathlib.Path]:
    """The directories under ``root_dir`` (itself included) that pass
    ``filter_fn``, sorted; raises on one nested in another unless
    ``nested_ok``."""
    root_dir = pathlib.Path(root_dir)
    filtered = set()
    for root_str, _, _ in os.walk(root_dir, followlinks=False):
        root = pathlib.Path(root_str)
        if filter_fn(root):
            filtered.add(root)
    if not nested_ok:
        for d in filtered:
            for other in filtered:
                if d != other and other in d.parents:
                    raise ValueError(f"Found nested directories: {d} and {other}")
    return sorted(filtered)


def link_latest(log_root, run_dir) -> None:
    """Points the relative symlink ``{log_root}/latest`` at ``run_dir``,
    replacing an older link; a real directory named ``latest`` is left
    alone, as are filesystems without symlinks."""
    log_root = pathlib.Path(log_root)
    symlink_path = log_root / "latest"
    target = pathlib.Path(os.path.relpath(run_dir, start=log_root))
    if symlink_path.is_symlink():
        symlink_path.unlink()
    if symlink_path.exists():
        return
    try:
        symlink_path.symlink_to(target, target_is_directory=True)
    except OSError:
        pass
