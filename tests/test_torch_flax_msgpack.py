"""The port's flax-msgpack reader against ``flax.serialization``.

``imitation_tpu_torch.util.flax_msgpack.msgpack_restore`` must give what
``flax.serialization.msgpack_restore`` gives, exactly (keys in order, leaf
types, dtypes, shapes and bytes): on the five expert policies under
``output/experts``, on reward nets the JAX package saved, and on crafted
files covering every msgpack type, flax's three extension types and the
``"0"``/``"1"`` keys of a saved tuple. It refuses what it cannot read
exactly: bfloat16, chunked arrays, other extension codes, truncated and
trailing bytes. Reward nets the JAX package saved load in the port and
compute the JAX net's rewards (1e-5, as tests/test_torch_reward_wrappers.py).
"""

import glob
import os

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from imitation_tpu.rewards import serialize as jax_serialize
from imitation_tpu_torch.rewards import serialize
from imitation_tpu_torch.util import flax_msgpack
from tests.test_torch_reward_serialize import _nets
from tests.test_torch_reward_wrappers import _inputs, _t

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPERT_VARS = sorted(glob.glob(os.path.join(REPO, "output", "experts", "*", "policy", "variables.msgpack")))


def assert_same_tree(got, want, path="root"):
    """Equal keys in order, types, dtypes, shapes and bytes."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
        assert not got.flags.writeable, path  # a view of the file's bytes, as flax's
        return
    assert type(got) is type(want), f"{path}: {type(got)} vs {type(want)}"
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert got == want, path


def test_all_five_experts_are_found():
    assert [p.split(os.sep)[-3] for p in EXPERT_VARS] == [
        "seals_ant", "seals_half_cheetah", "seals_hopper", "seals_swimmer", "seals_walker2d"]


@pytest.mark.parametrize("path", EXPERT_VARS, ids=lambda p: p.split(os.sep)[-3])
def test_expert_variables_equal_flax(path):
    with open(path, "rb") as f:
        data = f.read()
    assert_same_tree(flax_msgpack.msgpack_restore(data), flax.serialization.msgpack_restore(data))
    assert_same_tree(flax_msgpack.read_msgpack(path), flax.serialization.msgpack_restore(data))


def _crafted():
    rng = np.random.default_rng(0)
    arrays = {dt: rng.normal(size=(2, 3)).astype(dt) for dt in ("float16", "float32", "float64")}
    arrays.update({dt: rng.integers(-100, 100, (4,)).astype(dt) for dt in ("int8", "int16", "int32", "int64")})
    arrays.update({dt: rng.integers(0, 200, (3, 1)).astype(dt) for dt in ("uint8", "uint16", "uint32", "uint64")})
    arrays["bool"] = rng.random((5,)) < 0.5
    arrays["complex64"] = (rng.normal(size=3) + 1j * rng.normal(size=3)).astype(np.complex64)
    arrays["scalar_rank0"] = np.asarray(2.5, np.float32)
    arrays["empty"] = np.zeros((0, 4), np.float32)
    arrays["big"] = rng.normal(size=(70, 40)).astype(np.float32)  # bin32 payload
    return {
        "params": {"layers": (arrays["float32"], arrays["int64"]), "dense": {"kernel": arrays["big"]}},
        "arrays": arrays,
        "scalars": {"f32": np.float32(3.25), "i64": np.int64(-7), "u8": np.uint8(200), "b": np.bool_(True),
                    "f64": np.float64(1e300)},
        "python": {"complex": complex(1.5, -2.0), "int": 7, "neg": -3, "big": 2**40, "neg_big": -2**40,
                   "float": 0.1, "none": None, "true": True, "str": "a" * 40, "long_str": "b" * 300},
    }


def test_crafted_flax_tree_equals_flax():
    """to_bytes of a tree with every dtype, numpy scalars (ext 3), a complex
    (ext 2), a tuple (keys "0", "1") and Python leaves."""
    data = flax.serialization.to_bytes(_crafted())
    got, want = flax_msgpack.msgpack_restore(data), flax.serialization.msgpack_restore(data)
    assert_same_tree(got, want)
    assert list(got["params"]["layers"]) == ["0", "1"]
    assert isinstance(got["scalars"]["f32"], np.float32) and got["scalars"]["f32"] == np.float32(3.25)
    assert got["python"]["complex"] == complex(1.5, -2.0)


@pytest.mark.parametrize("single_float", [False, True])
def test_plain_msgpack_types_equal_flax(single_float):
    """Every msgpack format flax's unpacker reads: fix/8/16/32/64 ints of
    both signs, float32 and float64, nil, bools, str and bin of each
    width, arrays and maps beyond 15 and 65,535 items."""
    rng = np.random.default_rng(1)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 1e-30, float("inf"), float("nan"), 3.4e38],
        "misc": [None, True, False, "", "x" * 31, "y" * 32, "z" * 255, "w" * 70000],
        "bins": [b"", b"\x00" * 255, b"\x01" * 256, bytes(rng.integers(0, 256, 70000).astype(np.uint8))],
        "long_list": list(range(20)),
        "huge_list": list(range(70000)),
        "map16": {f"k{i}": i for i in range(20)},
        "map32": {f"k{i}": i for i in range(70000)},
    }
    data = msgpack.packb(tree, use_bin_type=True, use_single_float=single_float)
    assert_same_tree(flax_msgpack.msgpack_restore(data), flax.serialization.msgpack_restore(data))


def test_refuses_bfloat16():
    data = flax.serialization.msgpack_serialize({"w": np.asarray(jnp.ones((3,), jnp.bfloat16))})
    assert flax.serialization.msgpack_restore(data)["w"].dtype == jnp.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        flax_msgpack.msgpack_restore(data)


def test_refuses_chunked_arrays(monkeypatch):
    """flax splits leaves above MAX_CHUNK_SIZE bytes (2^30) into chunks;
    made small here so the test writes a few bytes."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 16)
    data = flax.serialization.msgpack_serialize({"w": np.arange(10, dtype=np.float32)})
    np.testing.assert_array_equal(flax.serialization.msgpack_restore(data)["w"], np.arange(10))
    with pytest.raises(ValueError, match="chunked"):
        flax_msgpack.msgpack_restore(data)


@pytest.mark.parametrize("data,match", [
    (msgpack.packb({"a": msgpack.ExtType(7, b"xyz")}), "extension type 7"),
    (b"\x81\xa1a\xd7\xff" + b"\x00" * 8, "extension type -1"),  # msgpack's timestamp
    (flax.serialization.to_bytes({"w": np.ones(4, np.float32)})[:-3], "truncated"),
    (flax.serialization.to_bytes({"w": np.ones(4, np.float32)}) + b"\x00", "trailing"),
    (b"\xc1", "not valid msgpack"),
    (msgpack.packb({1: 2}), "not a string"),
])
def test_refuses_what_it_cannot_read(data, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.msgpack_restore(data)


def _perturbed(tree, rng):
    """The variables with every float leaf moved off its initial value
    (running variances kept positive), counts left as they are."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, rng)
        elif np.issubdtype(np.asarray(v).dtype, np.floating):
            v = np.asarray(v) + rng.normal(scale=0.3, size=np.shape(v)).astype(np.asarray(v).dtype)
            out[k] = np.abs(v) + 0.5 if "var" in k else v
        else:
            out[k] = np.asarray(v) + 3
    return out


@pytest.mark.parametrize("kind", ["basic", "shaped", "normalized", "normalized_shaped", "ensemble"])
def test_jax_saved_reward_net_loads_in_the_port(tmp_path, kind):
    """JAX ``save_reward_net`` writes flax msgpack; the port's
    ``load_reward_net`` reads it, the arrays equal to flax's own restore,
    and computes the JAX net's rewards."""
    _, jnet, kw = _nets(kind)
    jvars = _perturbed(jax.device_get(jnet.init_variables(jax.random.key(0))), np.random.default_rng(2))
    jax_serialize.save_reward_net(str(tmp_path), jnet, jvars, net_kwargs=kw)
    with open(tmp_path / "variables.msgpack", "rb") as f:
        data = f.read()
    assert_same_tree(flax_msgpack.msgpack_restore(data), flax.serialization.msgpack_restore(data))
    assert not (tmp_path / serialize.REWARD_WEIGHTS).exists()
    net = serialize.load_reward_net(str(tmp_path), device="cpu")
    _, jloaded = jax_serialize.load_reward_net(str(tmp_path))
    x = _inputs("box", 9, 4)
    with torch.no_grad():
        got = net(*_t(x)).numpy()
    want = np.asarray(jnet.apply(jloaded, *x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))
    # the same directory through the registry's loader
    if kind == "normalized":
        fn = serialize.load_reward("RewardNet_normalized", str(tmp_path), device="cpu")
        jfn = jax_serialize.load_reward("RewardNet_normalized", str(tmp_path))
        np.testing.assert_allclose(fn(*x), jfn(*x), rtol=1e-5, atol=1e-5)


def test_missing_weights_are_refused(tmp_path):
    _, jnet, kw = _nets("basic")
    jax_serialize.save_reward_net(str(tmp_path), jnet, jnet.init_variables(jax.random.key(0)), net_kwargs=kw)
    os.remove(tmp_path / "variables.msgpack")
    with pytest.raises(FileNotFoundError, match="variables.msgpack"):
        serialize.load_reward_net(str(tmp_path), device="cpu")
