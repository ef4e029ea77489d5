"""GAE in imitation_tpu_torch against the JAX package's scan and Pallas kernel.

The port's ``gae`` takes its plain version for CPU tensors (the CUDA kernel
B1 is held against that plain version on the card by ``chip_smoke.py``).
Tolerance 1e-4, as in tests/rl/test_gae_pallas.py: the JAX reference runs an
associative scan, which sums the recurrence in another order than the
sequential loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imitation_tpu.ops import gae as jax_gae
from imitation_tpu.ops.gae_pallas import gae_pallas
from imitation_tpu_torch.ops import gae as torch_gae

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _panels(T, B, seed):
    rng = np.random.default_rng(seed)
    rews = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    next_values = rng.normal(size=(T, B)).astype(np.float32)
    terminated = (rng.random((T, B)) < 0.1).astype(np.float32)
    truncated = (rng.random((T, B)) < 0.1).astype(np.float32)
    dones = np.maximum(terminated, truncated)
    return rews, values, next_values, terminated, dones


@pytest.mark.parametrize("T,B", [(32, 8), (1, 5), (17, 37), (64, 64)])
def test_gae_matches_jax_scan_and_pallas(T, B):
    panels = _panels(T, B, seed=T * 100 + B)
    gamma, lam = 0.99, 0.95
    adv_ref, ret_ref = jax_gae.gae(*map(jnp.asarray, panels), gamma, lam)
    adv_pl, ret_pl = gae_pallas(*map(jnp.asarray, panels), gamma, lam, interpret=True)
    adv, ret = torch_gae.gae(*map(torch.from_numpy, panels), gamma, lam)
    for want_adv, want_ret in ((adv_ref, ret_ref), (adv_pl, ret_pl)):
        np.testing.assert_allclose(adv.numpy(), np.asarray(want_adv), **TOL)
        np.testing.assert_allclose(ret.numpy(), np.asarray(want_ret), **TOL)


def test_gae_cpu_wrapper_is_the_plain_version():
    panels = [torch.from_numpy(p) for p in _panels(20, 6, seed=1)]
    launches = torch_gae.gae.launches
    got = torch_gae.gae(*panels, 0.9, 0.8)
    want = torch_gae.gae_plain(*panels, 0.9, 0.8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch_gae.gae.launches == launches  # no kernel on CPU tensors


def test_gae_rejects_bad_panels():
    panels = [torch.from_numpy(p) for p in _panels(4, 3, seed=2)]
    with pytest.raises(TypeError):
        torch_gae.gae(panels[0].double(), *panels[1:], 0.99, 0.95)
    with pytest.raises(ValueError):
        torch_gae.gae(panels[0][:, :2], *panels[1:], 0.99, 0.95)
    with pytest.raises(ValueError):
        torch_gae.gae(panels[0].t().contiguous().t(), *panels[1:], 0.99, 0.95)


@pytest.mark.parametrize("bootstrap", [False, True])
def test_discounted_returns_matches_jax(bootstrap):
    rews, _, _, terminated, dones = _panels(25, 7, seed=3)
    rng = np.random.default_rng(4)
    boot = rng.normal(size=(7,)).astype(np.float32) if bootstrap else None
    term_last = terminated[-1] if bootstrap else None
    want = jax_gae.discounted_returns(
        jnp.asarray(rews), jnp.asarray(dones), 0.97,
        None if boot is None else jnp.asarray(boot),
        None if term_last is None else jnp.asarray(term_last),
    )
    got = torch_gae.discounted_returns(
        torch.from_numpy(rews), torch.from_numpy(dones), 0.97,
        None if boot is None else torch.from_numpy(boot),
        None if term_last is None else torch.from_numpy(term_last),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("flag_dtype", [np.bool_, np.int32])
def test_gae_casts_flag_panels_as_jax(flag_dtype):
    """Bool or integer terminated/dones are cast to float32 first, as the JAX
    ``gae`` casts them to the dtype of ``rews``; the other panels stay float32."""
    rews, values, next_values, terminated, dones = _panels(24, 9, seed=5)
    flags = (terminated.astype(flag_dtype), dones.astype(flag_dtype))
    want = jax_gae.gae(*map(jnp.asarray, (rews, values, next_values) + flags), 0.99, 0.95)
    got = torch_gae.gae(*map(torch.from_numpy, (rews, values, next_values) + flags), 0.99, 0.95)
    same = torch_gae.gae(*map(torch.from_numpy, (rews, values, next_values, terminated, dones)),
                         0.99, 0.95)
    for g, w, s in zip(got, want, same):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        assert torch.equal(g, s)  # the same as float32 flags
    with pytest.raises(TypeError):  # the value panels must still be float32
        torch_gae.gae(*map(torch.from_numpy, (rews.astype(np.float64), values, next_values) + flags),
                      0.99, 0.95)
