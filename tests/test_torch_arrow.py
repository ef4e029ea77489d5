"""The port's Arrow IPC reader and trajectory loaders against pyarrow,
``datasets`` and the JAX package.

* The five expert rollouts under ``output/experts``: the port's
  ``data.serialize.load`` against the JAX package's (``datasets``), per
  episode: ``obs``, ``acts``, ``rews`` (float64), ``terminal`` and
  ``infos`` exactly.
* Streams written by pyarrow: every type the reader reads, nulls at each
  level, ``large_list``, several record batches, sliced tables and offsets
  that do not start at 0, against ``pyarrow.ipc.open_stream(...).read_all()``
  exactly; compressed bodies, dictionaries, the legacy format and truncated
  streams refused.
* A dataset the JAX package saves with ``datasets`` (one shard and two),
  ``trajectories_to_dict``, and the legacy ``.npz`` / ``.pkl`` formats against
  the JAX package's loaders on the same files.
"""

import io
import os
import pickle
import struct

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest
import torch

from imitation_tpu.data import huggingface_utils as jax_hf
from imitation_tpu.data import serialize as jax_serialize
from imitation_tpu.data import types as jax_types
from imitation_tpu_torch.data import arrow, huggingface_utils, serialize, types

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS = ["seals_ant", "seals_half_cheetah", "seals_hopper", "seals_swimmer", "seals_walker2d"]


def assert_same_trajectories(got, want, rews_as_float32=False):
    """Equal trajectories; ``rews_as_float32`` compares the rewards after a
    cast to float32 (the JAX package reads ``datasets`` directories through
    its numpy format, which casts float64 to float32)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        for name in ("obs", "acts"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b)
        assert g.terminal is w.terminal or g.terminal == w.terminal
        if hasattr(w, "rews"):
            assert g.rews.dtype == w.rews.dtype == np.float64
            cast = (lambda r: r.astype(np.float32)) if rews_as_float32 else (lambda r: r)
            np.testing.assert_array_equal(cast(g.rews), cast(w.rews))
        if w.infos is None:
            assert g.infos is None
        else:
            assert list(g.infos) == list(w.infos)


@pytest.mark.parametrize("env", ENVS)
def test_expert_rollouts_equal_jax(env):
    path = os.path.join(REPO, "output", "experts", env, "rollouts")
    got = serialize.load(path)
    assert isinstance(got, huggingface_utils.TrajectoryDatasetSequence)
    assert got.table.metadata.keys() == {"huggingface"} and got.table.num_batches == 1
    want = jax_serialize.load(path)
    assert_same_trajectories(list(got), want)
    assert got[0].obs.dtype == np.float32 and got[0].obs.ndim == 2


def _stream(table_or_batches, schema=None, **options):
    sink = io.BytesIO()
    batches = table_or_batches if isinstance(table_or_batches, list) else None
    schema = schema or (batches[0].schema if batches else table_or_batches.schema)
    with ipc.new_stream(sink, schema, options=ipc.IpcWriteOptions(**options)) as w:
        if batches:
            for b in batches:
                w.write_batch(b)
        else:
            w.write_table(table_or_batches)
    return sink.getvalue()


def _typed_table():
    """A column of every type read, each with nulls (and one without)."""
    nested = [[[1.5, None], [2.0, 3.0, 4.0]], None, [], [[]], [None, [5.0]]]
    return pa.table({
        "i8": pa.array([1, -2, None, 4, -128], pa.int8()),
        "u16": pa.array([0, 65535, 7, None, 1], pa.uint16()),
        "i32": pa.array([1, 2, 3, 4, 5], pa.int32()),  # no nulls: zero-length bitmap
        "u64": pa.array([2**64 - 1, None, 0, 1, 2], pa.uint64()),
        "i64": pa.array([-(2**63), 2, None, 4, 5], pa.int64()),
        "f16": pa.array(np.array([0.5, 1.0, 2.0, -3.0, 65504.0], np.float16), pa.float16()),
        "f32": pa.array([1.25, None, float("inf"), -0.0, 3.0], pa.float32()),
        "f64": pa.array([0.1, 1e300, None, -2.5, 7.0], pa.float64()),
        "b": pa.array([True, None, False, True, True], pa.bool_()),
        "bits": pa.array([i % 3 == 0 for i in range(5)], pa.bool_()),
        "s": pa.array(["", "héllo", None, "{}", "x" * 100], pa.string()),
        "ls": pa.array(["a", None, "bc", "", "d"], pa.large_string()),
        "nested": pa.array(nested, pa.list_(pa.list_(pa.float32()))),
        "large": pa.array([[1, 2], None, [3], [], [4, 5, 6]], pa.large_list(pa.int64())),
        "strs": pa.array([["{}", None], [], None, ["a"], ["b", "c"]], pa.list_(pa.string())),
    }, metadata={"huggingface": '{"info": 1}', "other": "x"})


def _check(data):
    want = ipc.open_stream(data).read_all()
    got = arrow.read_stream(data)
    assert got.column_names == want.column_names and got.num_rows == want.num_rows
    for name in want.column_names:
        got_rows, want_rows = got.column(name).to_pylist(), want.column(name).to_pylist()
        assert got_rows == want_rows, name
    return got, want


def test_every_type_with_nulls_equals_pyarrow():
    got, want = _check(_stream(_typed_table()))
    assert got.metadata == {k.decode(): v.decode() for k, v in want.schema.metadata.items()}
    assert str(got.fields[12].type) == "list<list<float:float32>>"
    assert [f.nullable for f in got.fields] == [f.nullable for f in want.schema]
    col = got.column("nested")
    assert col.value(1) is None and col.value(3).shape == (1, 0)
    first = col.value(0)  # a null inside: lists, the full inner list a view
    assert first[0] == [1.5, None] and first[1].tolist() == [2.0, 3.0, 4.0]


def test_row_values_are_views_or_lists():
    """A row of numbers is a read-only view of the stream's bytes; a row of
    equal-length lists an [n, k] view; ragged or null rows Python lists."""
    data = _stream(pa.table({"obs": pa.array([[[1.0, 2.0], [3.0, 4.0]], [[5.0], [6.0, 7.0]], [[8.0, None]]],
                                             pa.list_(pa.list_(pa.float32()))),
                             "r": pa.array([[0.5, 1.5], [2.5], [None]], pa.list_(pa.float64()))}))
    got = arrow.read_stream(data)
    obs = got.column("obs")
    first = obs.value(0)
    assert isinstance(first, np.ndarray) and first.shape == (2, 2) and first.dtype == np.float32
    assert not first.flags.writeable and not first.flags.owndata
    assert [x.tolist() for x in obs.value(1)] == [[5.0], [6.0, 7.0]]
    assert isinstance(obs.value(2), list)
    np.testing.assert_array_equal(got.column("r").value(0), [0.5, 1.5])
    assert got.column("r").value(2) == [None]


def test_several_record_batches_and_slices_equal_pyarrow():
    table = _typed_table()
    batches = [table.slice(0, 2).to_batches()[0], table.slice(2, 3).to_batches()[0], table.slice(1, 3).to_batches()[0]]
    got, _ = _check(_stream(batches))
    assert got.num_batches == 3 and got.num_rows == 8
    for name in ("nested", "large", "s", "b", "f32"):
        col = got.column(name)
        assert [col.value(i) is None for i in range(8)] == [v is None for v in col.to_pylist()]
    got, _ = _check(_stream(table.slice(1, 4)))
    big = pa.table({"x": pa.array(np.arange(10_000, dtype=np.float32))})
    got, _ = _check(_stream(big.to_batches(max_chunksize=999)))
    assert got.num_batches == 11 and got.column("x").value(9_999) == np.float32(9_999)


def _patch(data: bytes, old: bytes, new: bytes) -> bytes:
    assert data.count(old) == 1, "the pattern must be unique"
    return data.replace(old, new)


@pytest.mark.parametrize("kind", ["list", "large_list", "utf8"])
def test_offsets_that_do_not_start_at_zero(kind):
    """pyarrow rebases offsets when it writes; the format allows any start,
    so the first offset is moved by hand (the child keeps its values)."""
    if kind == "utf8":
        arr, fmt = pa.array(["abc", "de", "fgh"], pa.string()), "<4i"
    else:
        typ = pa.list_(pa.float32()) if kind == "list" else pa.large_list(pa.float32())
        arr = pa.array([[1.0, 2.0, 3.0], [4.0, 5.0], [6.0, 7.0, 8.0]], typ)
        fmt = "<4i" if kind == "list" else "<4q"
    data = _stream(pa.table({"c": arr}))
    data = _patch(data, struct.pack(fmt, 0, 3, 5, 8), struct.pack(fmt, 1, 3, 5, 8))
    got, want = _check(data)
    assert want.column("c").to_pylist()[0] == ("bc" if kind == "utf8" else [2.0, 3.0])
    assert int(got.column("c").chunks[0].offsets[0]) == 1


@pytest.mark.parametrize("codec", ["zstd", "lz4"])
def test_compressed_bodies_are_refused(codec):
    data = _stream(_typed_table(), compression=codec)
    assert ipc.open_stream(data).read_all().num_rows == 5
    with pytest.raises(ValueError, match="compressed.*(ZSTD|LZ4_FRAME)"):
        arrow.read_stream(data)


@pytest.mark.parametrize("case,match", [
    ("dictionary", "dictionary"),
    ("legacy", "pre-0.15"),
    ("truncated", "truncated"),
    ("struct", "type code 13"),
    ("empty", "no Schema"),
])
def test_refusals(case, match):
    if case == "dictionary":
        data = _stream(pa.table({"d": pa.array(["a", "b", "a"]).dictionary_encode()}))
    elif case == "legacy":
        data = _stream(_typed_table(), use_legacy_format=True)
    elif case == "truncated":
        data = _stream(_typed_table())[:-200]
    elif case == "struct":
        data = _stream(pa.table({"s": pa.array([{"a": 1}])}))
    else:
        data = b""
    with pytest.raises(ValueError, match=match):
        arrow.read_stream(data)


def _trajectories(jax_side: bool, n=5, seed=0, dict_infos=True):
    mod = jax_types if jax_side else types
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(3, 9))
        infos = np.array([{"step": j, "name": f"t{i}"} for j in range(length)]) if dict_infos else None
        out.append(mod.TrajectoryWithRew(
            obs=rng.normal(size=(length + 1, 3)).astype(np.float32),
            acts=rng.normal(size=(length, 2)).astype(np.float32),
            rews=rng.normal(size=length), infos=infos, terminal=bool(i % 2)))
    return out


@pytest.mark.parametrize("num_shards", [1, 2])
def test_dataset_saved_by_the_jax_package(tmp_path, num_shards):
    """The JAX package's ``save`` writes with ``datasets``; the port's
    ``load`` reads the directory (every shard state.json names): the saved
    trajectories exactly, float64 rewards included, and the JAX package's
    load of it (whose rewards come back rounded to float32)."""
    import datasets

    trajs = _trajectories(jax_side=True)
    ds = datasets.Dataset.from_dict(jax_hf.trajectories_to_dict(trajs))
    ds.save_to_disk(str(tmp_path), num_shards=num_shards)
    got = serialize.load(str(tmp_path))
    assert got.table.num_batches >= num_shards
    assert_same_trajectories(list(got), trajs)
    assert_same_trajectories(list(got), jax_serialize.load(str(tmp_path)), rews_as_float32=True)
    assert got[1].infos[0] == {"step": 0, "name": "t1"}
    # lazily decoded, once
    assert got[2] is got[2] and got[-1] is got[len(got) - 1]
    assert [t.terminal for t in got[1:4]] == [True, False, True]
    with pytest.raises(IndexError):
        got[len(got)]


def test_trajectories_to_dict_equals_jax():
    got = huggingface_utils.trajectories_to_dict(_trajectories(jax_side=False))
    want = jax_hf.trajectories_to_dict(_trajectories(jax_side=True))
    assert got.keys() == want.keys()
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    no_infos = huggingface_utils.trajectories_to_dict(_trajectories(jax_side=False, dict_infos=False))
    assert no_infos["infos"][0][0] == "{}"


def test_npz_directory_both_ways(tmp_path):
    serialize._save_npz(str(tmp_path / "port"), _trajectories(jax_side=False))
    jax_serialize._save_npz(str(tmp_path / "jax"), _trajectories(jax_side=True))
    for path in ("port", "jax"):
        got, want = serialize.load(str(tmp_path / path)), jax_serialize.load(str(tmp_path / path))
        assert_same_trajectories(got, want)


def _reference_npz(path, with_rews=True):
    """The reference's legacy flat npz: arrays concatenated, split at
    ``indices`` (cumulative action counts)."""
    trajs = _trajectories(jax_side=True, n=4, seed=3)
    arrays = dict(obs=np.concatenate([t.obs for t in trajs]), acts=np.concatenate([t.acts for t in trajs]),
                  indices=np.cumsum([len(t) for t in trajs])[:-1],
                  terminal=np.array([t.terminal for t in trajs]))
    if with_rews:
        arrays["rews"] = np.concatenate([t.rews for t in trajs])
    np.savez(path, **arrays)


@pytest.mark.parametrize("with_rews", [True, False])
def test_legacy_npz_equals_jax(tmp_path, with_rews):
    path = str(tmp_path / "demos.npz")
    _reference_npz(path, with_rews)
    with pytest.warns(DeprecationWarning):
        got = serialize.load(path)
    with pytest.warns(DeprecationWarning):
        want = jax_serialize.load(path)
    assert_same_trajectories(got, want)
    assert len(got) == 4 and all(isinstance(t, types.TrajectoryWithRew) == with_rews for t in got)


def test_legacy_pkl_equals_jax(tmp_path):
    path = str(tmp_path / "demos.pkl")
    with open(path, "wb") as f:
        pickle.dump(_trajectories(jax_side=True, n=3, seed=5, dict_infos=False), f)
    with pytest.warns(DeprecationWarning):
        got = serialize.load(path)
    with pytest.warns(DeprecationWarning):
        want = jax_serialize.load(path)
    assert all(type(t) is types.TrajectoryWithRew for t in got)
    assert_same_trajectories(got, want)
    lfs = str(tmp_path / "pointer.pkl")
    with open(lfs, "wb") as f:
        f.write(b"version https://git-lfs.github.com/spec/v1\noid sha256:abc\nsize 12\n")
    for load in (serialize.load, jax_serialize.load):
        with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="git-lfs"):
            load(lfs)
    with pytest.raises(FileNotFoundError):
        serialize.load(str(tmp_path / "nothing"))
