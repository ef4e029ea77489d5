"""Profiling and phase timing.

Port of ``imitation_tpu/util/profiling.py``:

* ``trace``: a ``torch.profiler.profile`` of host and (where there is a
  card) CUDA activity, written into ``log_dir`` as a Chrome trace;
* ``annotate``: ``torch.profiler.record_function``, a named host range
  inside an active trace;
* ``PhaseTimer``: wall-clock time per phase, reported into the logger as
  ``time/{phase}_s`` and ``time/{phase}_mean_s``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Set

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Host and device profiler trace, written to ``log_dir/trace.json``
    (chrome://tracing or Perfetto) when the block ends; yields the
    profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str) -> record_function:
    """Label a host-side span inside an active trace."""
    return record_function(name)


def _cuda_devices(tree: Any, out: Set[torch.device]) -> Set[torch.device]:
    """The CUDA devices of the tensors in a tree of dicts, lists, tuples
    and dataclasses."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    return out


class PhaseTimer:
    """Accumulates wall-clock per phase; flushes into a logger.

    CUDA launches return before the device finishes, so a phase measures
    the enqueue unless ``block_on`` names its results: the phase then ends
    with ``torch.cuda.synchronize`` of each CUDA device they lie on (one
    wait per device, however many tensors).
    """

    def __init__(self, logger=None):
        self.logger = logger
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                for device in _cuda_devices(block_on, set()):
                    torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self, reset: bool = True) -> Dict[str, float]:
        out = {}
        for name, total in self.totals.items():
            out[f"time/{name}_s"] = total
            out[f"time/{name}_mean_s"] = total / max(1, self.counts[name])
        if self.logger is not None:
            for k, v in out.items():
                self.logger.record(k, v)
        if reset:
            self.totals.clear()
            self.counts.clear()
        return out
