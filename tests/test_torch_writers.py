"""The port's own writers against the libraries the JAX package writes with.

* ``data/arrow.py`` ``write_stream``: every type it writes (numbers of each
  width, bools, strings, lists and large lists, nested lists, nulls), read
  back by ``pyarrow.ipc.open_stream`` and by the port's reader, exactly.
* ``data/serialize.py`` ``save``: the HuggingFace directory of the same
  trajectories as the JAX package's ``save`` (``datasets``), with and
  without rewards, for vector, image and continuous-action trajectories:
  ``dataset_info.json``'s features and the Arrow schema (field types and
  the ``huggingface`` metadata) equal; the directory loads through
  ``datasets.load_from_disk``, ``pyarrow.ipc.open_stream``, the JAX
  package's ``serialize.load`` and the port's ``load`` with the same
  contents (``infos`` as JSON strings, ``{}`` where an info does not
  serialize, as JAX ``_infos_to_strs``).
* ``util/logger.py`` ``TensorBoardOutputFormat``: the events file read by
  tensorboard's record reader (CRCs checked; a flipped byte is refused),
  every event equal, field for field, to the JAX writer's (``tensorboardX``)
  for the same ``kvs`` once the wall times are set aside; CRC-32C of
  ``b"123456789"`` is ``0xE3069283``; ``log_format_strs`` with
  ``tensorboard`` in the port's CLI.
"""

import glob
import json
import os

import datasets
import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest
import torch
from tensorboard.compat.proto import event_pb2
from tensorboard.compat.tensorflow_stub import errors as tb_errors
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import PyRecordReader_New

from imitation_tpu.data import serialize as jax_serialize
from imitation_tpu.data import types as jax_types
from imitation_tpu.util import logger as jax_logger
from imitation_tpu_torch.data import arrow, huggingface_utils, serialize, types
from imitation_tpu_torch.scripts import train_imitation
from imitation_tpu_torch.util import logger

torch.set_num_threads(1)


# -- the Arrow IPC stream writer ----------------------------------------------


def _columns():
    rng = np.random.default_rng(0)
    nested = [rng.standard_normal((n, 2, 3)).astype(np.float32) for n in (4, 1, 0, 6)]
    cols = {
        "nested_f32": arrow.nested_lists(nested),
        "i64_list": arrow.nested_lists([rng.integers(-9, 9, n) for n in (3, 0, 0, 5)]),
        "u8_image": arrow.nested_lists([rng.integers(0, 255, (n, 2, 2, 1)).astype(np.uint8) for n in (2, 1, 3, 1)]),
        "strings": arrow.lists(arrow.strings(["a", "bé", "", "{}"]), [1, 1, 0, 2]),
        "bool": arrow.numbers(np.array([True, False, True, True])),
        "f16": arrow.numbers(np.array([1.5, -2, 3, 65504], np.float16)),
        "f64": arrow.numbers(np.array([1e300, -0.0, np.inf, 2.5])),
        "u16": arrow.numbers(np.array([1, 2, 3, 65535], np.uint16)),
        "i8": arrow.numbers(np.array([-128, 0, 5, 127], np.int8)),
        "large_list": arrow.lists(arrow.numbers(np.arange(10, dtype=np.int32)), [1, 2, 3, 4], large=True),
    }
    return cols, nested


@pytest.mark.parametrize("with_nulls", [False, True])
def test_write_stream_reads_back_in_pyarrow_and_the_port(with_nulls):
    cols, nested = _columns()
    if with_nulls:
        cols["bool"].validity = np.array([True, False, True, True])
        cols["strings"].validity = np.array([False, True, True, True])
    fields = [arrow.Field(name, col.type, True) for name, col in cols.items()]
    data = arrow.write_stream(fields, list(cols.values()), {"huggingface": "{}", "k": "v"})
    table = ipc.open_stream(pa.BufferReader(data)).read_all()
    table.validate(full=True)
    assert table.schema.metadata == {b"huggingface": b"{}", b"k": b"v"}
    assert [str(t) for t in table.schema.types] == [
        "list<item: list<item: list<item: float>>>", "list<item: int64>",
        "list<item: list<item: list<item: list<item: uint8>>>>", "list<item: string>", "bool",
        "halffloat", "double", "uint16", "int8", "large_list<item: int32>"]
    got = arrow.read_stream(data)
    assert got.metadata == {"huggingface": "{}", "k": "v"}
    for name in cols:
        want = table.column(name).to_pylist()
        assert got.column(name).to_pylist() == want, name
    for i, a in enumerate(nested):
        np.testing.assert_array_equal(np.array(table.column("nested_f32")[i].as_py(), np.float32).reshape(a.shape), a)
    assert table.column("bool").null_count == (1 if with_nulls else 0)


def test_write_stream_refuses_bad_input():
    col = arrow.numbers(np.arange(3))
    with pytest.raises(ValueError, match="fields for"):
        arrow.write_stream([], [col])
    with pytest.raises(ValueError, match="different lengths"):
        arrow.write_stream([arrow.Field("a", col.type, True)] * 2, [col, arrow.numbers(np.arange(2))])
    with pytest.raises(ValueError, match="its column"):
        arrow.write_stream([arrow.Field("a", arrow.DataType("bool"), True)], [col])
    with pytest.raises(TypeError, match="no Arrow number type"):
        arrow.numbers(np.array(["x"], object))
    with pytest.raises(ValueError, match="trailing shapes"):
        arrow.nested_lists([np.zeros((2, 3)), np.zeros((2, 4))])


# -- serialize.save: the HuggingFace directory ----------------------------------


def _trajectories(kind, with_rew, cls):
    rng = np.random.default_rng({"vector": 0, "image": 1, "continuous": 2}[kind])
    out = []
    for i, n in enumerate((5, 1, 9)):
        if kind == "vector":
            obs, acts = rng.standard_normal((n + 1, 4)).astype(np.float32), rng.integers(0, 2, n).astype(np.int32)
        elif kind == "image":
            obs, acts = rng.integers(0, 255, (n + 1, 3, 3, 2)).astype(np.uint8), rng.integers(0, 5, n)
        else:
            obs, acts = rng.standard_normal((n + 1, 3)).astype(np.float32), rng.standard_normal((n, 1)).astype(np.float32)
        infos = None
        if i == 0:  # one info per step: plain, numpy-valued, and one json cannot write
            infos = np.array([{"a": 1}, {"b": np.float32(2.5)}, {(1, 2): 3}, {}, {"s": "x"}][:n])
        kw = dict(obs=obs, acts=acts, infos=infos, terminal=bool(i % 2))
        out.append(cls.TrajectoryWithRew(rews=rng.standard_normal(n), **kw) if with_rew else cls.Trajectory(**kw))
    return out


def _schema(path):
    with open(os.path.join(path, "data-00000-of-00001.arrow"), "rb") as f:
        return ipc.open_stream(f).schema


KINDS = ["vector", "image", "continuous"]


@pytest.mark.parametrize("with_rew", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_save_writes_the_directory_jax_save_writes(tmp_path, kind, with_rew):
    serialize.save(str(tmp_path / "port"), _trajectories(kind, with_rew, types))
    jax_serialize.save(str(tmp_path / "jax"), _trajectories(kind, with_rew, jax_types))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "data-00000-of-00001.arrow", "dataset_info.json", "state.json"]
    info = {p: json.load(open(tmp_path / p / "dataset_info.json")) for p in ("port", "jax")}
    assert info["port"] == info["jax"]
    state = {p: json.load(open(tmp_path / p / "state.json")) for p in ("port", "jax")}
    assert state["port"].keys() == state["jax"].keys()
    assert state["port"]["_data_files"] == state["jax"]["_data_files"]
    port_schema, jax_schema = _schema(tmp_path / "port"), _schema(tmp_path / "jax")
    assert port_schema.equals(jax_schema, check_metadata=True)
    assert ("rews" in port_schema.names) == with_rew
    ds = {p: datasets.load_from_disk(str(tmp_path / p)) for p in ("port", "jax")}
    assert ds["port"].features == ds["jax"].features
    assert ds["port"].to_dict() == ds["jax"].to_dict()


@pytest.mark.parametrize("with_rew", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_saved_directory_loads_in_every_reader(tmp_path, kind, with_rew):
    trajs = _trajectories(kind, with_rew, types)
    serialize.save(str(tmp_path), trajs)
    with open(tmp_path / "data-00000-of-00001.arrow", "rb") as f:
        table = ipc.open_stream(f).read_all()
    assert table.num_rows == len(trajs)
    infos = table.column("infos").to_pylist()
    assert infos[0] == ['{"a": 1}', '{"b": "2.5"}', "{}", "{}", '{"s": "x"}']
    assert infos[1] == ["{}"]
    # The port's loader keeps the stored dtypes; the JAX package's reads
    # through datasets' numpy format, which widens integers to int64 and
    # narrows float64 rewards to float32.
    for port, got in ((True, serialize.load(str(tmp_path))), (False, jax_serialize.load(str(tmp_path)))):
        assert len(got) == len(trajs)
        for i, (g, t) in enumerate(zip(got, trajs)):
            np.testing.assert_array_equal(g.obs, t.obs)
            np.testing.assert_array_equal(g.acts, t.acts)
            assert bool(g.terminal) == t.terminal
            assert [json.dumps(x) for x in g.infos] == infos[i]
            if port:
                assert g.obs.dtype == t.obs.dtype and g.acts.dtype == t.acts.dtype
            if not with_rew:
                assert not hasattr(g, "rews")
            elif port:
                assert g.rews.dtype == np.float64
                np.testing.assert_array_equal(g.rews, t.rews)
            else:
                np.testing.assert_array_equal(g.rews, t.rews.astype(np.float32))


def test_save_replaces_an_npz_directory(tmp_path):
    serialize._save_npz(str(tmp_path), _trajectories("vector", True, types)[:1])
    trajs = _trajectories("vector", True, types)
    serialize.save(str(tmp_path), trajs)
    assert serialize.NPZ_NAME not in os.listdir(tmp_path)
    assert len(serialize.load(str(tmp_path))) == len(trajs)


def test_trajectories_to_dataset_matches_jax_dataset(tmp_path):
    from imitation_tpu.data import huggingface_utils as jax_hf

    trajs = _trajectories("vector", True, types)
    trajs[0] = types.TrajectoryWithRew(obs=trajs[0].obs, acts=trajs[0].acts, infos=None,
                                       terminal=trajs[0].terminal, rews=trajs[0].rews)
    huggingface_utils.trajectories_to_dataset(trajs, str(tmp_path))
    want = jax_hf.trajectories_to_dataset([jax_types.TrajectoryWithRew(**t.__dict__) for t in trajs])
    got = datasets.load_from_disk(str(tmp_path))
    assert got.features == want.features
    assert got.to_dict() == want.to_dict()
    with pytest.raises(ValueError, match="at least one row"):
        huggingface_utils.trajectories_to_dataset([], str(tmp_path / "empty"))


# -- the TensorBoard events file -------------------------------------------------


def test_crc32c_check_value():
    assert logger.crc32c(b"123456789") == 0xE3069283
    assert logger.crc32c(b"") == 0


def _records(path):
    """Every record of a TFRecord file through tensorboard's reader, which
    checks both CRCs of each."""
    reader, out = PyRecordReader_New(path), []
    while True:
        try:
            reader.GetNext()
        except tb_errors.OutOfRangeError:
            return out
        out.append(reader.record())


def _events(folder):
    (path,) = glob.glob(os.path.join(folder, "events.out.tfevents.*"))
    events = [event_pb2.Event.FromString(r) for r in _records(path)]
    return path, events


KVS = [({"a/loss": 0.25, "n": 3, "zero": 0.0, "text": "skipped", "neg": -1.5, "flag": True}, 0),
       ({"a/loss": 1e-30, "big": 3.0e38, "i": -2**40}, 7),
       ({"x": 1.0}, 2**40)]


def test_events_equal_the_jax_writers(tmp_path):
    for name, mod in (("port", logger), ("jax", jax_logger)):
        writer = mod.make_output_format("tensorboard", str(tmp_path / name))
        for kvs, step in KVS:
            writer.write(kvs, step)
        writer.close()
    path, port = _events(tmp_path / "port")
    _, jax = _events(tmp_path / "jax")
    assert os.path.basename(path).startswith("events.out.tfevents.")
    assert port[0].file_version == "brain.Event:2" and port[0].wall_time > 0
    assert len(port) == len(jax) == 1 + sum(isinstance(v, (int, float)) for kvs, _ in KVS for v in kvs.values())
    for p, j in zip(port, jax):
        assert p.wall_time > 0 and j.wall_time > 0
        p.wall_time = j.wall_time = 0
        assert p == j
        assert p.SerializeToString() == j.SerializeToString()
    got = [(e.step, v.tag, v.simple_value) for e in port[1:] for v in e.summary.value]
    assert got[:2] == [(0, "a/loss", 0.25), (0, "n", 3.0)] and got[-1] == (2**40, "x", 1.0)


def test_events_crc_checked(tmp_path):
    writer = logger.make_output_format("tensorboard", str(tmp_path))
    writer.write({"a": 1.0}, 1)
    writer.close()
    (path,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0x01  # a byte of the last event's data
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(tb_errors.DataLossError, match="crc32"):
        _records(path)


def test_logger_and_cli_write_tensorboard(tmp_path):
    log = logger.configure(str(tmp_path / "log"), format_strs=["tensorboard"])
    log.record("loss", 0.5)
    log.dump(3)
    log.close()
    _, events = _events(tmp_path / "log")
    assert [(e.step, v.tag, v.simple_value) for e in events for v in e.summary.value] == [(3, "loss", 0.5)]
    # The CLI: every numeric column of progress.csv is a tag of the events.
    result = train_imitation.ex.run_cli(["bc", "with", "fast", "device=cpu", f"log_root={tmp_path / 'cli'}",
                                         "log_format_strs=['csv','tensorboard']"])
    assert result is not None
    (run_dir,) = [p for p in glob.glob(str(tmp_path / "cli" / "*" / "*")) if not os.path.islink(p)]
    _, events = _events(run_dir)
    tags = {v.tag for e in events for v in e.summary.value}
    with open(os.path.join(run_dir, "progress.csv")) as f:
        header, *rows = [line.rstrip("\n").split(",") for line in f]
    numeric = {k for row in rows for k, v in zip(header, row) if v.replace(".", "").replace("-", "").replace(
        "e", "").isdigit()}
    assert "imit_stats/monitor_return_mean" in numeric and numeric <= tags, sorted(numeric - tags)
