"""util/logger.py in imitation_tpu_torch against the JAX package.

The same record/dump sequence goes through both packages' loggers, each
into its own folder with the csv, json and log formats; the files they
write must parse to the same rows: the default logger's, with a column
added after the first rows, and each ``accumulate_means`` sub-folder's,
with key and accumulate prefixes. Values are Python numbers on both sides,
so the comparison is exact.
"""

import csv
import io
import json
import os

import pytest
import torch

from imitation_tpu.util import logger as jax_logger
from imitation_tpu_torch.util import logger

torch.set_num_threads(1)

FORMATS = ["csv", "json", "log"]


def _drive(log):
    log.record("a", 1)
    log.record("b", 0.5)
    log.dump(0)
    log.record("a", 2)
    log.record("c", "late")  # a column added after the first row
    log.dump(1)
    for v in (1.0, 2.0, 4.5):
        with log.accumulate_means("disc"):
            log.record("loss", v)
            log.record("acc", v / 10)
            log.dump(7)
    with log.add_key_prefix("gen"):
        log.record("ret", -3.0)
        with log.add_accumulate_prefix("outer"):
            with log.accumulate_means("inner"):
                log.record("x", 5)
                log.record_mean("y", 1.0)
                log.record_mean("y", 3.0)
                log.dump(3)
            with pytest.raises(RuntimeError, match="accumulate prefix"):
                with log.accumulate_means("inner"):
                    with log.add_accumulate_prefix("nested"):
                        pass
    log.record_mean("m", 1.0)
    log.record_mean("m", 2.0)
    log.dump(2)
    with pytest.raises(RuntimeError, match="Nested"):
        with log.accumulate_means("disc"):
            with log.accumulate_means("gen"):
                pass
    log.close()


def _read(folder):
    """{relative sub-folder: (csv rows, json rows, log text)} under ``folder``."""
    out = {}
    for root, _, files in os.walk(folder):
        if "progress.csv" not in files:
            continue
        with open(os.path.join(root, "progress.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        with open(os.path.join(root, "progress.json")) as f:
            records = [json.loads(line) for line in f]
        with open(os.path.join(root, "log.txt")) as f:
            text = f.read()
        out[os.path.relpath(root, folder)] = (rows, records, text)
    return out


def test_file_outputs_match_jax(tmp_path):
    jlog = jax_logger.configure(str(tmp_path / "jax"), FORMATS)
    log = logger.configure(str(tmp_path / "port"), FORMATS)
    assert log.dir == str(tmp_path / "port")
    _drive(jlog)
    _drive(log)
    got, want = _read(tmp_path / "port"), _read(tmp_path / "jax")
    assert sorted(got) == sorted(want) == [".", "raw/disc", "raw/outer/inner"]
    assert got == want
    rows, records, _ = got["."]
    assert list(rows[0]) == ["a", "b", "c", "gen/ret", "m", "mean/disc/acc", "mean/disc/loss",
                             "mean/outer/inner/gen/x"]
    assert rows[0]["c"] == "" and rows[1]["c"] == "late"
    assert records[2]["mean/disc/loss"] == pytest.approx(7.5 / 3) and records[2]["_step"] == 2
    assert [r["raw/disc/loss"] for r in got["raw/disc"][1]] == [1.0, 2.0, 4.5]
    assert got["raw/outer/inner"][1] == [{"raw/outer/inner/gen/x": 5, "gen/y": 2.0, "_step": 3}]


def test_stdout_table_matches_jax():
    tables = []
    for mod in (jax_logger, logger):
        file = io.StringIO()
        log = mod.HierarchicalLogger(mod._Logger(None, [mod.HumanOutputFormat(file)]))
        log.record("loss", 0.123456)
        log.record("a_very_long_key_name_that_is_cut_at_forty_characters", 3)
        log.dump()
        tables.append(file.getvalue())
    assert tables[0] == tables[1] and "0.123" in tables[0] and "..." in tables[0]


@pytest.mark.parametrize("fmt", ["tensorboard", "wandb"])
def test_unported_formats_raise(tmp_path, fmt):
    """``wandb`` is not ported and raises; ``tensorboard`` is ported (the
    port's own events writer, ``tests/test_torch_writers.py``) and writes
    its events file. An unknown format raises either way."""
    if fmt == "wandb":
        with pytest.raises(ValueError, match=f"{fmt}.*not ported"):
            logger.configure(str(tmp_path), [fmt])
    else:
        logger.configure(str(tmp_path), [fmt]).close()
        assert [f for f in os.listdir(tmp_path) if f.startswith("events.out.tfevents.")]
    with pytest.raises(ValueError, match="Unknown format"):
        logger.make_output_format("nope", str(tmp_path))


def test_default_folder_and_formats(tmp_path, monkeypatch, capsys):
    """No folder: a timestamped one under the temporary directory, with
    stdout only, as in the JAX package; ``format_strs=()`` writes nothing."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    log = logger.configure()
    assert os.path.isdir(log.dir) and log.dir.startswith(str(tmp_path))
    assert log.format_strs == ["stdout"]
    log.record("k", 1)
    log.dump()
    assert "| k | 1 |" in capsys.readouterr().out
    quiet = logger.configure(str(tmp_path / "quiet"), format_strs=())
    quiet.record("k", 1)
    quiet.dump()
    assert capsys.readouterr().out == "" and os.listdir(tmp_path / "quiet") == []
