"""The config layer of the CLI scripts: Sacred's command line without Sacred.

Port of ``imitation_tpu/scripts/config.py``, the same grammar and files:

* ``Experiment`` holds a default config (a nested dict), named configs
  (partial dicts merged on request), commands and a ``main`` function.
* The command line is ``script [command] [with] [named_config|key=value ...]``,
  or ``print_config`` to print the config and run nothing. Dotted keys set
  nested values; values are Python literals, else strings.
* A key found nowhere in the config raises ``KeyError``, except under a dict
  whose name ends in ``kwargs`` (or an empty dict), which takes new keys.
* Each run writes ``config.json`` and ``run.json`` into
  ``{log_root}/{env}/{timestamp}``, keeps ``{log_root}/{env}/latest`` on the
  newest run, and records ``COMPLETED`` with the result, or ``FAILED`` /
  ``INTERRUPTED`` with the error.

Which device a run uses is the config's ``device`` key (``scripts/
ingredients.py``): CUDA unless it says ``cpu``.
"""

from __future__ import annotations

import ast
import copy
import datetime
import json
import os
import sys
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

from imitation_tpu_torch.util import util
from imitation_tpu_torch.util.logger import HierarchicalLogger, configure as configure_logger
from imitation_tpu_torch.util.run_dirs import link_latest


def deep_update(base: Dict[str, Any], upd: Mapping[str, Any]) -> Dict[str, Any]:
    """Merges ``upd`` into ``base`` recursively (dicts merge, the rest is
    replaced by a copy)."""
    for k, v in upd.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
    return base


def set_dotted(config: Dict[str, Any], dotted_key: str, value: Any) -> None:
    """Sets ``config["a"]["b"] = value`` for ``dotted_key`` ``"a.b"``."""
    parts = dotted_key.split(".")
    node = config
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise KeyError(f"cannot descend into non-dict at {p!r} for {dotted_key!r}")
    node[parts[-1]] = value


def parse_value(text: str) -> Any:
    """A Python literal, else the text itself."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


class Experiment:
    """A configurable CLI experiment (the counterpart of a Sacred experiment)."""

    def __init__(self, name: str, default_config: Dict[str, Any]):
        self.name = name
        self.default_config = default_config
        self.named_configs: Dict[str, Dict[str, Any]] = {}
        self.commands: Dict[str, Callable] = {}
        self.main_fn: Optional[Callable] = None

    def named_config(self, name: str, updates: Dict[str, Any]) -> None:
        self.named_configs[name] = updates

    def command(self, name: str):
        def deco(fn):
            self.commands[name] = fn
            return fn

        return deco

    def main(self, fn: Callable) -> Callable:
        self.main_fn = fn
        return fn

    # -- config assembly ---------------------------------------------------
    def build_config(
        self,
        named: Sequence[str] = (),
        overrides: Optional[Mapping[str, Any]] = None,
    ) -> Dict[str, Any]:
        config = copy.deepcopy(self.default_config)
        for n in named:
            if n not in self.named_configs:
                raise KeyError(
                    f"unknown named config {n!r}; available: {sorted(self.named_configs)}"
                )
            deep_update(config, self.named_configs[n])
        for k, v in (overrides or {}).items():
            self._check_known_key(config, k)
            set_dotted(config, k, v)
        return config

    @staticmethod
    def _check_known_key(config: Dict[str, Any], dotted_key: str) -> None:
        """Rejects overrides of keys that exist nowhere in the config, as
        Sacred does. Dicts named ``*kwargs``, and empty dicts, are open."""
        parts = dotted_key.split(".")
        node = config
        for i, p in enumerate(parts):
            if not isinstance(node, dict):
                return  # descending into a non-dict raises in set_dotted
            if p not in node:
                parent_name = parts[i - 1] if i else ""
                if parent_name.endswith("kwargs") or (node == {} and i):
                    return
                raise KeyError(
                    f"unknown config key {dotted_key!r} (no {p!r} at this "
                    f"level); available: {sorted(node)}"
                )
            node = node[p]

    def parse_cli(self, argv: Sequence[str]):
        """``(command, config)`` of ``[command] [with] [named|k=v ...]``;
        ``(None, None)`` after printing the config for ``print_config``."""
        argv = list(argv)
        command = None
        if argv and argv[0] in self.commands:
            command = argv.pop(0)
        if argv and argv[0] == "with":
            argv.pop(0)
        if argv and argv[0] == "print_config":
            argv.pop(0)
            config = self._parse_tokens(argv)
            print(json.dumps(config, indent=2, default=str))
            return None, None
        config = self._parse_tokens(argv)
        return command, config

    def _parse_tokens(self, tokens: Sequence[str]) -> Dict[str, Any]:
        named, overrides = [], {}
        for tok in tokens:
            if tok == "print_config":
                continue
            if "=" in tok:
                k, v = tok.split("=", 1)
                overrides[k] = parse_value(v)
            else:
                named.append(tok)
        return self.build_config(named, overrides)

    # -- run management ----------------------------------------------------
    def make_run_dir(self, config: Dict[str, Any]) -> str:
        log_root = config.get("log_root") or os.path.join("output", self.name)
        env_name = config.get("env_name", "unknown").replace("/", "_")
        run_dir = config.get("log_dir")
        if run_dir is None:
            run_dir = os.path.join(log_root, env_name, util.make_unique_timestamp())
        os.makedirs(run_dir, exist_ok=True)
        link_latest(os.path.dirname(run_dir), run_dir)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
        with open(os.path.join(run_dir, "run.json"), "w") as f:
            json.dump(
                {
                    "experiment": {"name": self.name},
                    "status": "RUNNING",
                    "start_time": datetime.datetime.now().isoformat(),
                },
                f,
                indent=2,
            )
        return run_dir

    def finish_run(self, run_dir: str, result: Any) -> None:
        run_path = os.path.join(run_dir, "run.json")
        with open(run_path) as f:
            run = json.load(f)
        run["status"] = "COMPLETED"
        run["stop_time"] = datetime.datetime.now().isoformat()
        run["result"] = result
        with open(run_path, "w") as f:
            json.dump(run, f, indent=2, default=str)

    def make_logger(self, run_dir: str, config: Dict[str, Any]) -> HierarchicalLogger:
        fmts = config.get("log_format_strs", ["stdout", "csv", "json"])
        return configure_logger(run_dir, format_strs=fmts)

    def run_cli(self, argv: Optional[Sequence[str]] = None) -> Any:
        """Parses ``argv`` (``sys.argv[1:]`` by default), runs the command
        in a new run directory and returns its result."""
        argv = list(sys.argv[1:] if argv is None else argv)
        command, config = self.parse_cli(argv)
        if config is None:  # print_config
            return None
        run_dir = self.make_run_dir(config)
        logger = self.make_logger(run_dir, config)
        fn = self.commands[command] if command else self.main_fn
        if fn is None:
            raise ValueError(f"no command given and no main registered for {self.name}")
        try:
            result = fn(config, run_dir, logger)
        except BaseException as e:
            self._mark_failed(run_dir, e)
            raise
        finally:
            logger.close()
        self.finish_run(run_dir, result)
        return result

    def _mark_failed(self, run_dir: str, error: BaseException) -> None:
        run_path = os.path.join(run_dir, "run.json")
        try:
            with open(run_path) as f:
                run = json.load(f)
        except (OSError, ValueError):
            run = {"experiment": {"name": self.name}}
        run["status"] = "INTERRUPTED" if isinstance(error, KeyboardInterrupt) else "FAILED"
        run["stop_time"] = datetime.datetime.now().isoformat()
        run["error"] = f"{type(error).__name__}: {error}"
        with open(run_path, "w") as f:
            json.dump(run, f, indent=2, default=str)
