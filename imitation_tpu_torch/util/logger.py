"""Hierarchical metrics logger with accumulate-means contexts.

A copy of the subset of ``imitation_tpu/util/logger.py`` that the adversarial
trainer's ``train`` uses: ``record``, ``accumulate_means`` and ``dump``,
writing to stdout. Inside an ``accumulate_means(name)`` context
raw values go to a per-context sub-logger while running means accumulate
into ``mean/{name}/{key}`` of the default logger, flushed at the next
default ``dump``. No files are written.
"""

from __future__ import annotations

import contextlib
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, TextIO


class KVWriter:
    def write(self, kvs: Dict[str, Any], step: int) -> None:
        raise NotImplementedError


class HumanOutputFormat(KVWriter):
    def __init__(self, file: TextIO = sys.stdout):
        self.file = file

    def write(self, kvs: Dict[str, Any], step: int) -> None:
        if not kvs:
            return
        key2str = {}
        for k, v in sorted(kvs.items()):
            vs = f"{v:.3g}" if isinstance(v, float) else str(v)
            key2str[self._trunc(k)] = self._trunc(vs)
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for k, v in key2str.items():
            lines.append(f"| {k}{' ' * (keywidth - len(k))} | {v}{' ' * (valwidth - len(v))} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    @staticmethod
    def _trunc(s: str, maxlen: int = 40) -> str:
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s


class _Logger:
    """A flat key-value logger instance."""

    def __init__(self, output_formats: Sequence[KVWriter]):
        self.output_formats = list(output_formats)
        self.name_to_value: Dict[str, Any] = {}
        self.name_to_count: Dict[str, int] = defaultdict(int)

    def record(self, key: str, value: Any) -> None:
        self.name_to_value[key] = value

    def record_mean(self, key: str, value: Any) -> None:
        old, cnt = self.name_to_value.get(key, 0.0), self.name_to_count[key]
        self.name_to_value[key] = (old * cnt + value) / (cnt + 1)
        self.name_to_count[key] = cnt + 1

    def dump(self, step: int = 0) -> None:
        for fmt in self.output_formats:
            fmt.write(dict(self.name_to_value), step)
        self.name_to_value.clear()
        self.name_to_count.clear()

    def warn(self, msg: str) -> None:
        print(f"WARNING: {msg}", file=sys.stderr)


class HierarchicalLogger:
    """Two-tier logger with accumulate_means contexts."""

    def __init__(self, default_logger: _Logger):
        self.default_logger = default_logger
        self._cached_loggers: Dict[str, _Logger] = {}
        self._subdir: Optional[str] = None
        self._name: Optional[str] = None
        self.current_logger: Optional[_Logger] = None

    @contextlib.contextmanager
    def accumulate_means(self, name: str):
        """Temporarily redirect record() to a sub-logger for ``name``.

        Means accumulate into the default logger under ``mean/{name}/...``
        and flush at the next default dump.
        """
        if self.current_logger is not None:
            raise RuntimeError("Nested `accumulate_means` context")
        subdir = f"raw/{name}"
        logger = self._cached_loggers.setdefault(subdir, _Logger([]))
        try:
            self.current_logger = logger
            self._subdir = subdir
            self._name = name
            yield
        finally:
            self.current_logger = None
            self._subdir = None
            self._name = None

    def record(self, key: str, value: Any) -> None:
        if self.current_logger is not None:
            self.current_logger.record(f"{self._subdir}/{key}", value)
            self.default_logger.record_mean(f"mean/{self._name}/{key}", value)
        else:
            self.default_logger.record(key, value)

    def dump(self, step: int = 0) -> None:
        (self.current_logger or self.default_logger).dump(step)

    def warn(self, msg: str) -> None:
        self.default_logger.warn(msg)


def configure(format_strs: Optional[Sequence[str]] = ("stdout",)) -> HierarchicalLogger:
    """A HierarchicalLogger writing to stdout (``format_strs=()`` for none)."""
    fmts: List[KVWriter] = []
    for fmt in format_strs or ():
        if fmt != "stdout":
            raise ValueError(f"only the stdout format is ported, got {fmt!r}")
        fmts.append(HumanOutputFormat(sys.stdout))
    return HierarchicalLogger(_Logger(fmts))
