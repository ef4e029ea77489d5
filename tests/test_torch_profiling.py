"""util/profiling.py in imitation_tpu_torch against the JAX package.

``PhaseTimer``'s report has the JAX package's keys and arithmetic (times
differ: they are wall-clock); ``trace`` writes a Chrome trace that holds
the ``annotate`` ranges.
"""

import json
import os

import jax.numpy as jnp
import pytest
import torch

from imitation_tpu.util import profiling as jax_profiling
from imitation_tpu_torch.util import profiling
from imitation_tpu_torch.util.logger import configure

torch.set_num_threads(1)


def _drive(timer, block):
    for _ in range(2):
        with timer.phase("collect", block_on=block):
            pass
    with timer.phase("update"):
        pass
    return timer.report()


def test_phase_timer_report_matches_jax():
    want = _drive(jax_profiling.PhaseTimer(), {"a": jnp.ones(3), "b": [jnp.zeros(2)]})
    logger = configure(format_strs=())
    timer = profiling.PhaseTimer(logger)
    got = _drive(timer, {"a": torch.ones(3), "b": [torch.zeros(2)]})
    assert sorted(got) == sorted(want) == ["time/collect_mean_s", "time/collect_s",
                                           "time/update_mean_s", "time/update_s"]
    assert got["time/collect_mean_s"] == pytest.approx(got["time/collect_s"] / 2)
    assert logger.default_logger.name_to_value == got
    assert timer.report() == {}  # reset after the report


def test_block_on_finds_no_device_on_the_cpu():
    assert profiling._cuda_devices({"x": [torch.ones(2)], "y": (torch.zeros(1), 3)}, set()) == set()


def test_trace_writes_the_annotated_ranges(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("phase.one"):
            torch.ones(8).sum()
    path = tmp_path / "prof" / "trace.json"
    assert os.path.exists(path)
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "phase.one" in names
