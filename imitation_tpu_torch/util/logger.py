"""Hierarchical metrics logger with accumulate-means contexts.

Port of ``imitation_tpu/util/logger.py``:

* ``record(key, value)`` writes to the active context. Inside an
  ``accumulate_means(name)`` context, raw values go to a per-context
  sub-logger (``raw/{prefixes}/{name}`` under the log folder, with the same
  formats) while running means accumulate into ``mean/{prefixes}/{name}/{key}``
  of the default logger, flushed at the next default ``dump``.
* ``add_key_prefix`` / ``add_accumulate_prefix`` context managers.
* Output formats: ``stdout`` (a table), ``log`` (the same table in
  ``log.txt``), ``csv`` (``progress.csv``, with columns added as new keys
  appear and the header rewritten), ``json`` (``progress.json``, one
  object per dump) and ``tensorboard`` (``events.out.tfevents.<time>.<host>``,
  the scalars as ``tensorboardX``'s ``add_scalar`` writes them, written with
  the standard library: see ``TensorBoardOutputFormat``). The W&B writer is
  not ported: it needs ``wandb``, which the GPU machine lacks, and logs to an
  outside service, so asking for it raises.
"""

from __future__ import annotations

import contextlib
import csv
import datetime
import json
import os
import socket
import struct
import sys
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, TextIO, Tuple


class KVWriter:
    def write(self, kvs: Dict[str, Any], step: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


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

    def close(self) -> None:
        if self.file not in (sys.stdout, sys.stderr):
            self.file.close()

    @staticmethod
    def _trunc(s: str, maxlen: int = 40) -> str:
        return s[: maxlen - 3] + "..." if len(s) > maxlen else s


class CSVOutputFormat(KVWriter):
    """``progress.csv``: one row per dump. A key not seen before adds a
    column: the file is rewritten with the new header and earlier rows
    padded with empty cells."""

    def __init__(self, filename: str):
        self.filename = filename
        self.keys: List[str] = []
        self.file = open(filename, "w", newline="")

    def write(self, kvs: Dict[str, Any], step: int) -> None:
        extra = [k for k in sorted(kvs.keys()) if k not in self.keys]
        if extra:
            self.keys.extend(extra)
            self.file.close()
            with open(self.filename, newline="") as f:
                rows = list(csv.reader(f))
            old_header, old_rows = (rows[0], rows[1:]) if rows else ([], [])
            self.file = open(self.filename, "w", newline="")
            writer = csv.writer(self.file)
            writer.writerow(self.keys)
            for row in old_rows:
                mapping = dict(zip(old_header, row))
                writer.writerow([mapping.get(k, "") for k in self.keys])
        csv.writer(self.file).writerow([kvs.get(k, "") for k in self.keys])
        self.file.flush()

    def close(self) -> None:
        self.file.close()


class JSONOutputFormat(KVWriter):
    """``progress.json``: one JSON object per dump, with its ``_step``."""

    def __init__(self, filename: str):
        self.file = open(filename, "w")

    def write(self, kvs: Dict[str, Any], step: int) -> None:
        rec = dict(kvs)
        rec["_step"] = step
        self.file.write(json.dumps(rec, default=float) + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)  # Castagnoli, reflected
        table.append(crc)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``, by a table of 256 entries."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: the CRC rotated right by 15 bits plus
    ``0xA282EAD8``, modulo 2^32."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: the uint64 length, its masked CRC, the data and its
    masked CRC, little-endian."""
    length = struct.pack("<Q", len(data))
    return length + struct.pack("<I", masked_crc32c(length)) + data + struct.pack("<I", masked_crc32c(data))


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # a negative int64 as its two's complement
    out = bytearray()
    while True:
        bits, n = n & 0x7F, n >> 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _bytes_field(number: int, data: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(data)) + data


def event_bytes(wall_time: float, step: int = 0, file_version: Optional[str] = None,
                scalar: Optional[Tuple[str, float]] = None) -> bytes:
    """A serialized ``tensorboard.Event``: ``wall_time`` (field 1, double),
    ``step`` (2, varint), ``file_version`` (3, string) and, for a ``(tag,
    value)`` ``scalar``, ``summary`` (5) holding one ``Summary.Value{tag (1),
    simple_value (2, float)}``. A zero ``step`` is left out, as proto3
    leaves out defaults; ``simple_value`` is a member of a oneof, so it is
    written even when zero."""
    out = struct.pack("<Bd", 1 << 3 | 1, wall_time)
    if step:
        out += _varint(2 << 3) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode("utf-8"))
    if scalar is not None:
        tag, value = scalar
        v = _bytes_field(1, tag.encode("utf-8")) + struct.pack("<Bf", 2 << 3 | 5, value)
        out += _bytes_field(5, _bytes_field(1, v))
    return out


class TensorBoardOutputFormat(KVWriter):
    """Scalars in a TensorBoard events file ``events.out.tfevents.<time>.<host>``
    of ``folder``: a first ``Event`` with ``file_version "brain.Event:2"``,
    then, per ``write``, one ``Event{wall_time, step, summary}`` per int or
    float value, as ``tensorboardX.SummaryWriter.add_scalar`` writes them,
    each framed as a TFRecord and flushed."""

    def __init__(self, folder: str):
        self.path = os.path.join(folder, f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}")
        self.file = open(self.path, "wb")
        self._write_event(event_bytes(time.time(), file_version="brain.Event:2"))

    def _write_event(self, data: bytes) -> None:
        self.file.write(tfrecord(data))
        self.file.flush()

    def write(self, kvs: Dict[str, Any], step: int) -> None:
        for k, v in kvs.items():
            if isinstance(v, (int, float)):
                self._write_event(event_bytes(time.time(), int(step), scalar=(k, float(v))))

    def close(self) -> None:
        self.file.close()


_NOT_PORTED = {
    "wandb": "the W&B writer needs wandb and logs to an outside service",
}


def make_output_format(fmt: str, folder: str) -> KVWriter:
    if fmt in _NOT_PORTED:
        raise ValueError(
            f"format {fmt!r} is not ported: {_NOT_PORTED[fmt]}, which the port may not "
            "import (the GPU machine lacks it); use stdout, log, csv, json or tensorboard"
        )
    os.makedirs(folder, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(open(os.path.join(folder, "log.txt"), "w"))
    if fmt == "csv":
        return CSVOutputFormat(os.path.join(folder, "progress.csv"))
    if fmt == "json":
        return JSONOutputFormat(os.path.join(folder, "progress.json"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(folder)
    raise ValueError(f"Unknown format: {fmt}")


class _Logger:
    """A flat key-value logger instance (one output folder + formats)."""

    def __init__(self, folder: Optional[str], output_formats: Sequence[KVWriter]):
        self.dir = folder
        self.output_formats = list(output_formats)
        self.name_to_value: Dict[str, Any] = {}
        self.name_to_count: Dict[str, int] = defaultdict(int)

    def record(self, key: str, value: Any, exclude=None) -> None:
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

    def close(self) -> None:
        for fmt in self.output_formats:
            fmt.close()

    def warn(self, msg: str) -> None:
        print(f"WARNING: {msg}", file=sys.stderr)

    def info(self, msg: str) -> None:
        print(msg)


class HierarchicalLogger:
    """Two-tier logger with accumulate_means contexts."""

    def __init__(
        self,
        default_logger: _Logger,
        format_strs: Sequence[str] = ("stdout",),
    ):
        self.default_logger = default_logger
        self._cached_loggers: Dict[str, _Logger] = {}
        self._accumulate_prefixes: List[str] = []
        self._key_prefixes: List[str] = []
        self._subdir: Optional[str] = None
        self._name: Optional[str] = None
        self.format_strs = list(format_strs)
        self.current_logger: Optional[_Logger] = None

    # -- context managers --------------------------------------------------
    @contextlib.contextmanager
    def accumulate_means(self, name: str):
        """Temporarily redirect record() to a sub-logger for ``name``.

        Raw values go to ``raw/{prefixes}/{name}``; means accumulate into the
        default logger under ``mean/{prefixes}/{name}/...`` and flush at the
        next default dump.
        """
        if self.current_logger is not None:
            raise RuntimeError("Nested `accumulate_means` context")
        subdir = os.path.join("raw", *self._accumulate_prefixes, name)
        if subdir in self._cached_loggers:
            logger = self._cached_loggers[subdir]
        else:
            folder = None
            fmts: List[KVWriter] = []
            if self.default_logger.dir is not None:
                folder = os.path.join(self.default_logger.dir, subdir)
                os.makedirs(folder, exist_ok=True)
                fmts = [make_output_format(f, folder) for f in self.format_strs]
            logger = _Logger(folder, fmts)
            self._cached_loggers[subdir] = logger
        try:
            self.current_logger = logger
            self._subdir = subdir
            self._name = name
            yield
        finally:
            self.current_logger = None
            self._subdir = None
            self._name = None

    @contextlib.contextmanager
    def add_accumulate_prefix(self, prefix: str):
        """Prefix future accumulate_means names."""
        if self.current_logger is not None:
            raise RuntimeError(
                "Cannot add accumulate prefix when inside an accumulate_means context"
            )
        self._accumulate_prefixes.append(prefix)
        try:
            yield self
        finally:
            self._accumulate_prefixes.pop()

    @contextlib.contextmanager
    def add_key_prefix(self, prefix: str):
        """Prefix all recorded keys."""
        self._key_prefixes.append(prefix)
        try:
            yield self
        finally:
            self._key_prefixes.pop()

    # -- recording ---------------------------------------------------------
    def record(self, key: str, value: Any, exclude=None) -> None:
        key = "/".join([*self._key_prefixes, key])
        if self.current_logger is not None:
            assert self._subdir is not None
            self.current_logger.record("/".join([self._subdir, key]), value)
            mean_key = "/".join(["mean", *self._accumulate_prefixes, str(self._name), key])
            self.default_logger.record_mean(mean_key, value)
        else:
            self.default_logger.record(key, value)

    def record_mean(self, key: str, value: Any) -> None:
        key = "/".join([*self._key_prefixes, key])
        (self.current_logger or self.default_logger).record_mean(key, value)

    def dump(self, step: int = 0) -> None:
        (self.current_logger or self.default_logger).dump(step)

    @property
    def dir(self) -> Optional[str]:
        return self.default_logger.dir

    def close(self) -> None:
        self.default_logger.close()
        for logger in self._cached_loggers.values():
            logger.close()

    def warn(self, msg: str) -> None:
        self.default_logger.warn(msg)

    def info(self, msg: str) -> None:
        self.default_logger.info(msg)


def configure(
    folder: Optional[str] = None,
    format_strs: Optional[Sequence[str]] = None,
) -> HierarchicalLogger:
    """Builds a HierarchicalLogger writing ``format_strs`` (default
    ``["stdout"]``; ``()`` for none) into ``folder``, which is made if
    missing. With no folder, a timestamped one under the temporary
    directory."""
    if folder is None:
        now = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        folder = os.path.join(tempfile.gettempdir(), "imitation_tpu_torch", now)
    if format_strs is None:
        format_strs = ["stdout"]
    os.makedirs(folder, exist_ok=True)
    fmts = [make_output_format(f, folder) for f in format_strs]
    return HierarchicalLogger(_Logger(folder, fmts), format_strs=format_strs)
