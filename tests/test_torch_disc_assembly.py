"""Disc-batch assembly in imitation_tpu_torch against the JAX package.

The port's ``assemble_rows`` takes its plain version for CPU tensors (the
CUDA kernel B2 is held against that plain version on the card by
``chip_smoke.py``). A gather copies values, so the comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imitation_tpu.ops.disc_assembly import assemble_rows as jax_assemble
from imitation_tpu.ops.disc_assembly import assemble_rows_pallas
from imitation_tpu_torch.ops import disc_assembly

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


def test_rejects_bad_inputs():
    demo, gen, e_idx, g_idx = map(torch.from_numpy, _case(8, 8, 4, 2, np.float32, seed=7))
    with pytest.raises(TypeError):
        disc_assembly.assemble_rows(demo.double(), gen.double(), e_idx, g_idx)
    with pytest.raises(TypeError):
        disc_assembly.assemble_rows(demo, gen, e_idx.long(), g_idx)
    with pytest.raises(ValueError):
        disc_assembly.assemble_rows(demo, gen[:, :1].contiguous(), e_idx, g_idx)
    with pytest.raises(ValueError):
        disc_assembly.assemble_rows(demo, gen, e_idx, g_idx[:2])
    with pytest.raises(ValueError):
        disc_assembly.assemble_rows(demo[::2], gen, e_idx, g_idx)  # not contiguous
    launches = disc_assembly.assemble_rows.launches
    disc_assembly.assemble_rows(demo, gen, e_idx, g_idx)
    assert disc_assembly.assemble_rows.launches == launches  # no kernel on CPU tensors
