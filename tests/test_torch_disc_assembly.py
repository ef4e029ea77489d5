"""Disc-batch assembly in imitation_tpu_torch against the JAX package.

The port's ``assemble_fields`` and ``assemble_rows`` take their plain
version for CPU tensors (the CUDA kernel B2, one launch for all fields, is
held against that plain version on the card by ``chip_smoke.py``). A gather
copies values, so the comparison is exact.

Like JAX's ``assemble_rows``, the port takes fields of any dtype and any
rank >= 1. JAX without x64 demotes float64 and int64 arrays to 32 bits when
they enter it, so for those dtypes its values are compared after the same
demotion, while the port keeps torch's input dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imitation_tpu.ops.disc_assembly import assemble_rows as jax_assemble
from imitation_tpu.ops.disc_assembly import assemble_rows_pallas
import imitation_tpu_torch.algorithms.adversarial.common as torch_common
from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
from imitation_tpu_torch.envs import make_vec_env
from imitation_tpu_torch.ops import disc_assembly
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.testing import experts
from imitation_tpu_torch.util.logger import configure

torch.set_num_threads(1)


def _case(N, C, B, F, dtype, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    shape = (N,) if F is None else (N, F)
    gshape = (C,) if F is None else (C, F)
    if dtype == np.int32:
        demo = rng.integers(-1000, 1000, shape).astype(np.int32)
        gen = rng.integers(-1000, 1000, gshape).astype(np.int32)
    else:
        demo = rng.normal(size=shape).astype(np.float32)
        gen = rng.normal(size=gshape).astype(np.float32)
    e_idx = rng.integers(0 if lo is None else lo, N if hi is None else hi, B).astype(np.int32)
    g_idx = rng.integers(0 if lo is None else lo, C if hi is None else hi, B).astype(np.int32)
    return demo, gen, e_idx, g_idx


def _port(demo, gen, e_idx, g_idx):
    return disc_assembly.assemble_rows(*map(torch.from_numpy, (demo, gen, e_idx, g_idx))).numpy()


@pytest.mark.parametrize("N,C,B,F", [(64, 48, 16, 8), (7, 300, 33, 4), (5, 5, 1, 1)])
def test_2d_float_matches_jax_and_pallas(N, C, B, F):
    demo, gen, e_idx, g_idx = _case(N, C, B, F, np.float32, seed=N + C + B)
    args = tuple(map(jnp.asarray, (demo, gen, e_idx, g_idx)))
    got = _port(demo, gen, e_idx, g_idx)
    np.testing.assert_array_equal(got, np.asarray(jax_assemble(*args)))
    np.testing.assert_array_equal(got, np.asarray(assemble_rows_pallas(*args, interpret=True)))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_1d_field_matches_jax(dtype):
    demo, gen, e_idx, g_idx = _case(50, 80, 24, None, dtype, seed=5)
    got = _port(demo, gen, e_idx, g_idx)
    assert got.dtype == dtype and got.shape == (48,)
    np.testing.assert_array_equal(
        got, np.asarray(jax_assemble(*map(jnp.asarray, (demo, gen, e_idx, g_idx))))
    )
    # The Pallas kernel takes [N, F] fields; a [N] field is F = 1.
    pallas = assemble_rows_pallas(
        jnp.asarray(demo[:, None]), jnp.asarray(gen[:, None]),
        jnp.asarray(e_idx), jnp.asarray(g_idx), interpret=True,
    )
    np.testing.assert_array_equal(got, np.asarray(pallas)[:, 0])


@pytest.mark.parametrize("F", [None, 3])
def test_out_of_range_indices_read_as_jax_reads_them(F):
    # Indices past the end clamp to the last row; negative ones count from
    # the end and then clamp to row 0, as JAX's x[idx] does.
    demo, gen, e_idx, g_idx = _case(12, 9, 40, F, np.float32, seed=6, lo=-30, hi=30)
    assert (e_idx >= 12).any() and (e_idx < -12).any() and ((e_idx < 0) & (e_idx >= -12)).any()
    np.testing.assert_array_equal(
        _port(demo, gen, e_idx, g_idx),
        np.asarray(jax_assemble(*map(jnp.asarray, (demo, gen, e_idx, g_idx)))),
    )


def _jax_equal(got: torch.Tensor, demo, gen, e_idx, g_idx) -> None:
    """``got`` equals JAX's ``assemble_rows`` of the same numpy inputs in shape
    and values (JAX demotes 64-bit inputs; the port keeps their dtype)."""
    want = np.asarray(jax_assemble(*map(jnp.asarray, (demo, gen, e_idx, g_idx))))
    assert got.shape == want.shape and got.dtype == torch.from_numpy(demo).dtype
    np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)


def test_rejects_bad_inputs():
    demo, gen, e_idx, g_idx = map(torch.from_numpy, _case(8, 8, 4, 2, np.float32, seed=7))
    # float64 fields assemble now, equal to JAX (they were refused before).
    _jax_equal(disc_assembly.assemble_rows(demo.double(), gen.double(), e_idx, g_idx),
               demo.double().numpy(), gen.double().numpy(), e_idx.numpy(), g_idx.numpy())
    with pytest.raises(TypeError):
        disc_assembly.assemble_rows(demo.double(), gen, e_idx, g_idx)  # two dtypes in a field
    with pytest.raises(ValueError):
        disc_assembly.assemble_rows(demo[0, 0], gen[0, 0], e_idx, g_idx)  # rank 0
    with pytest.raises(TypeError):
        disc_assembly.assemble_rows(demo, gen, e_idx.long(), g_idx)
    with pytest.raises(ValueError):
        disc_assembly.assemble_rows(demo, gen[:, :1].contiguous(), e_idx, g_idx)
    with pytest.raises(ValueError):
        disc_assembly.assemble_rows(demo, gen, e_idx, g_idx[:2])
    with pytest.raises(ValueError):
        disc_assembly.assemble_rows(demo[::2], gen, e_idx, g_idx)  # not contiguous
    launches = disc_assembly.assemble_fields.launches
    disc_assembly.assemble_rows(demo, gen, e_idx, g_idx)
    assert disc_assembly.assemble_fields.launches == launches  # no kernel on CPU tensors


# The four fields of a disc step: obs f32 [., 4], acts int32 [.], next_obs
# f32 [., 4], dones f32 [.]; and a field of F = 3 (not a whole 16 bytes).
DISC_FIELDS = (("obs", 4, np.float32), ("acts", None, np.int32),
               ("next_obs", 4, np.float32), ("dones", None, np.float32))


@pytest.mark.parametrize("extra_f3", [False, True])
@pytest.mark.parametrize("N,C,B,lo,hi", [
    (300, 640, 64, None, None),  # indices in range
    (12, 9, 40, -30, 30),  # out of range both ways, as JAX's x[idx] reads them
])
def test_fused_fields_match_jax_and_pallas(N, C, B, lo, hi, extra_f3):
    kinds = DISC_FIELDS + ((("wide", 3, np.float32),) if extra_f3 else ())
    rng = np.random.default_rng(N + C + B)
    e_idx = rng.integers(0 if lo is None else lo, N if hi is None else hi, B).astype(np.int32)
    g_idx = rng.integers(0 if lo is None else lo, C if hi is None else hi, B).astype(np.int32)
    fields = [_case(N, C, 1, F, dtype, seed=k)[:2] for k, (_, F, dtype) in enumerate(kinds)]
    got = disc_assembly.assemble_fields(
        [(torch.from_numpy(d), torch.from_numpy(g)) for d, g in fields],
        torch.from_numpy(e_idx), torch.from_numpy(g_idx),
    )
    assert len(got) == len(kinds)
    je, jg = jnp.asarray(e_idx), jnp.asarray(g_idx)
    for out, (demo, gen), (name, F, dtype) in zip(got, fields, kinds):
        out = out.numpy()
        assert out.dtype == dtype and out.shape == (2 * B,) + demo.shape[1:], name
        np.testing.assert_array_equal(
            out, np.asarray(jax_assemble(jnp.asarray(demo), jnp.asarray(gen), je, jg)), err_msg=name)
        # The Pallas kernel takes [N, F] fields; a [N] field is F = 1.
        col = (lambda x: x) if F is not None else (lambda x: x[:, None])
        pallas = np.asarray(assemble_rows_pallas(
            jnp.asarray(col(demo)), jnp.asarray(col(gen)), je, jg, interpret=True))
        np.testing.assert_array_equal(out, pallas if F is not None else pallas[:, 0], err_msg=name)


def test_fused_fields_reject_bad_inputs():
    (d4, g4, e_idx, g_idx), (d1, g1) = (
        map(torch.from_numpy, _case(8, 8, 4, 4, np.float32, seed=8)),
        map(torch.from_numpy, _case(8, 8, 4, None, np.int32, seed=9)[:2]),
    )
    with pytest.raises(ValueError, match="fields"):
        disc_assembly.assemble_fields([], e_idx, g_idx)
    with pytest.raises(ValueError, match="fields"):
        disc_assembly.assemble_fields([(d4, g4)] * (disc_assembly.MAX_FIELDS + 1), e_idx, g_idx)
    with pytest.raises(ValueError, match="same demo rows"):
        disc_assembly.assemble_fields([(d4, g4), (d1[:5], g1)], e_idx, g_idx)
    # int64 fields assemble now, equal to JAX (they were refused before).
    _, acts64 = disc_assembly.assemble_fields([(d4, g4), (d1.long(), g1.long())], e_idx, g_idx)
    _jax_equal(acts64, d1.long().numpy(), g1.long().numpy(), e_idx.numpy(), g_idx.numpy())
    with pytest.raises(TypeError):
        disc_assembly.assemble_fields([(d4, g4), (d1.long(), g1)], e_idx, g_idx)
    launches = disc_assembly.assemble_fields.launches
    obs, acts = disc_assembly.assemble_fields([(d4, g4), (d1, g1)], e_idx, g_idx)
    assert obs.shape == (8, 4) and acts.shape == (8,) and acts.dtype == torch.int32
    assert disc_assembly.assemble_fields.launches == launches  # no kernel on CPU tensors


def test_disc_step_assembles_its_batch_in_one_call(monkeypatch):
    calls = []
    real = torch_common.assemble_fields

    def counted(fields, e_idx, g_idx):
        calls.append(len(fields))
        return real(fields, e_idx, g_idx)

    monkeypatch.setattr(torch_common, "assemble_fields", counted)
    demo_venv = make_vec_env("CartPole-v1", num_envs=4, max_episode_steps=20, device="cpu")
    demos = experts.generate_expert_trajectories("CartPole-v1", demo_venv, min_episodes=4, seed=0)
    venv = make_vec_env("CartPole-v1", num_envs=4, device="cpu")
    tr = GAIL(demonstrations=demos, demo_batch_size=16, venv=venv,
              gen_config=PPOConfig(n_steps=8, n_minibatches=2, n_epochs=1),
              n_disc_updates_per_round=2, custom_logger=configure(format_strs=()), seed=0)
    tr.train(2 * tr.gen_train_timesteps)
    assert tr.disc_state.step == 4
    assert calls == [4] * 4  # one call per disc step, all four fields in it


def _any_field(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(max(info.min, -10**6), min(info.max, 10**6), shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


# Fields that JAX's assemble_rows takes and the port refused before: ranks
# above 2, rows that are not whole 4-byte words (the kernel's byte path),
# 64-bit elements, and empty rows.
ANY_FIELDS = {
    "uint8 [., 2, 2]": (np.uint8, (2, 2)),
    "bool [.]": (np.bool_, ()),
    "float32 [., 2, 2]": (np.float32, (2, 2)),
    "float16 [., 3]": (np.float16, (3,)),
    "int8 [., 5]": (np.int8, (5,)),
    "float64 [., 3]": (np.float64, (3,)),
    "int64 [.]": (np.int64, ()),
    "float32 [., 0]": (np.float32, (0,)),  # empty rows: nothing to move
}


@pytest.mark.parametrize("N,C,B,lo,hi", [
    (3, 3, 2, None, None),  # the 3-row case: e_idx and g_idx of two rows
    (40, 64, 24, -50, 70),  # out of range both ways
])
@pytest.mark.parametrize("kind", list(ANY_FIELDS))
def test_any_dtype_and_rank_matches_jax(kind, N, C, B, lo, hi):
    dtype, trailing = ANY_FIELDS[kind]
    rng = np.random.default_rng(N + B)
    e_idx = rng.integers(0 if lo is None else lo, N if hi is None else hi, B).astype(np.int32)
    g_idx = rng.integers(0 if lo is None else lo, C if hi is None else hi, B).astype(np.int32)
    demo, gen = _any_field(dtype, (N,) + trailing, 1), _any_field(dtype, (C,) + trailing, 2)
    got = disc_assembly.assemble_rows(*map(torch.from_numpy, (demo, gen, e_idx, g_idx)))
    assert got.shape == (2 * B,) + trailing
    _jax_equal(got, demo, gen, e_idx, g_idx)


def test_mixed_any_fields_in_one_call_match_jax():
    N, C, B = 30, 50, 17
    rng = np.random.default_rng(3)
    e_idx = rng.integers(-5, N + 5, B).astype(np.int32)
    g_idx = rng.integers(-5, C + 5, B).astype(np.int32)
    fields = [(_any_field(dt, (N,) + tr, 2 * k), _any_field(dt, (C,) + tr, 2 * k + 1))
              for k, (dt, tr) in enumerate(ANY_FIELDS.values())]
    assert len(fields) <= disc_assembly.MAX_FIELDS
    got = disc_assembly.assemble_fields(
        [(torch.from_numpy(d), torch.from_numpy(g)) for d, g in fields],
        torch.from_numpy(e_idx), torch.from_numpy(g_idx))
    for out, (demo, gen) in zip(got, fields):
        _jax_equal(out, demo, gen, e_idx, g_idx)
