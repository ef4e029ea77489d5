"""convert_trajs: re-save rollout files in the port's current format.

Port of ``imitation_tpu/scripts/convert_trajs.py``: loads trajectories in
any format ``data.serialize.load`` reads (the ``.npz`` directory,
HuggingFace directories, the legacy ``.npz`` / ``.pkl`` files) and saves
them as a HuggingFace dataset directory (``data.serialize.save``) beside the
original (a legacy ``x.npz`` becomes ``x/``; a directory is rewritten in
place).

    python -m imitation_tpu_torch convert_trajs path1 [path2 ...]
"""

from __future__ import annotations

import pathlib
import sys

from imitation_tpu_torch.data import serialize
from imitation_tpu_torch.util import util


def update_traj_file_in_place(path) -> pathlib.Path:
    """Converts the trajectories at ``path``; returns where they now are."""
    path = util.parse_path(path)
    trajs = list(serialize.load(str(path)))
    converted_path = path.with_suffix("") if path.suffix == ".npz" else path
    serialize.save(str(converted_path), trajs)
    return converted_path


def main() -> None:
    if len(sys.argv) <= 1:
        print("Supply at least one path to convert", file=sys.stderr)
        raise SystemExit(1)
    for path in sys.argv[1:]:
        out = update_traj_file_in_place(path)
        print(f"converted {path} -> {out}")


if __name__ == "__main__":
    main()
