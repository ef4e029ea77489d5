"""The tuned hyper-parameter configs.

Port of ``imitation_tpu/scripts/tuned_hps.py``. The JSON files under this
package's ``config_files/tuned_hps/`` (copies of the JAX package's, byte for
byte) are registered as named configs on the experiment each declares,
under the file's stem:

    python -m imitation_tpu_torch train_adversarial gail with gail_cartpole
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict

TUNED_DIR = pathlib.Path(__file__).parent / "config_files" / "tuned_hps"


def load_tuned_configs() -> Dict[str, dict]:
    configs = {}
    if TUNED_DIR.is_dir():
        for path in sorted(TUNED_DIR.glob("*.json")):
            with open(path) as f:
                configs[path.stem] = json.load(f)
    return configs


def register_tuned_configs(experiment) -> None:
    """Registers every tuned config that declares this experiment's name."""
    for name, cfg in load_tuned_configs().items():
        cfg = dict(cfg)
        target = cfg.pop("experiment", None)
        if target == experiment.name and name not in experiment.named_configs:
            experiment.named_config(name, cfg)
