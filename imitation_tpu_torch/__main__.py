"""The command-line dispatcher.

Usage:
    python -m imitation_tpu_torch <script> [command] [with] [config tokens...]

Scripts: train_rl, train_imitation, train_adversarial,
train_preference_comparisons, eval_policy, convert_trajs, parallel, tuning,
analyze. Runs go to the CUDA device unless the config says device=cpu.
"""

from __future__ import annotations

import importlib
import sys

SCRIPTS = {
    "train_rl": "imitation_tpu_torch.scripts.train_rl",
    "train_imitation": "imitation_tpu_torch.scripts.train_imitation",
    "train_adversarial": "imitation_tpu_torch.scripts.train_adversarial",
    "train_preference_comparisons": "imitation_tpu_torch.scripts.train_preference_comparisons",
    "eval_policy": "imitation_tpu_torch.scripts.eval_policy",
}
MAIN_SCRIPTS = {
    "convert_trajs": "imitation_tpu_torch.scripts.convert_trajs",
    "parallel": "imitation_tpu_torch.scripts.parallel",
    "tuning": "imitation_tpu_torch.scripts.tuning",
    "analyze": "imitation_tpu_torch.scripts.analyze",
}


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        names = sorted(list(SCRIPTS) + list(MAIN_SCRIPTS))
        print(__doc__)
        print("available scripts:", ", ".join(names))
        raise SystemExit(0 if len(sys.argv) >= 2 else 1)
    name = sys.argv[1]
    if name in SCRIPTS:
        mod = importlib.import_module(SCRIPTS[name])
        mod.ex.run_cli(sys.argv[2:])
    elif name in MAIN_SCRIPTS:
        mod = importlib.import_module(MAIN_SCRIPTS[name])
        sys.argv = [name] + sys.argv[2:]
        mod.main()
    else:
        print(f"unknown script {name!r}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
