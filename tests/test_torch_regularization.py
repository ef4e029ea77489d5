"""Regularizers in imitation_tpu_torch against the JAX package.

The penalties over the same parameters agree within 1e-6 (relative), and
their gradients too; lambda updates, the factory, the logged lambda and
every validation error match value for value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imitation_tpu.algorithms import regularization as jax_reg
from imitation_tpu_torch.algorithms import regularization as reg
from imitation_tpu_torch.util.logger import configure

torch.set_num_threads(1)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (3,), (3, 1), (1,))]


@pytest.mark.parametrize("make", [
    lambda m: m.LpRegularizer(0.3, p=1), lambda m: m.LpRegularizer(0.3, p=2),
    lambda m: m.LpRegularizer(0.3, p=3), lambda m: m.WeightDecayRegularizer(0.3),
])
def test_penalty_and_its_gradient_match_jax(make):
    params = _params()
    jr, r = make(jax_reg), make(reg)
    jparams = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    want, jgrad = jax.value_and_grad(lambda p: jr.lambda_ * jr.loss_penalty(p))(jparams)
    tparams = [torch.tensor(p, requires_grad=True) for p in params]
    got = r.lambda_ * r.loss_penalty(tparams)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for i, p in enumerate(tparams):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad[str(i)]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("losses", [(1.0, 4.0), (4.0, 1.0), (1.0, 1.0), (0.0, 0.0), (0.0, 1.0), (2.0, 0.9)])
def test_interval_scaler_matches_jax(losses):
    for args in ((0.5, (0.5, 1.5)), (0.9, (0.0, 1.1))):
        assert reg.IntervalParamScaler(*args)(0.7, *losses) == jax_reg.IntervalParamScaler(*args)(0.7, *losses)
    assert reg.ConstantParamScaler()(0.7, *losses) == jax_reg.ConstantParamScaler()(0.7, *losses) == 0.7


@pytest.mark.parametrize("bad", [
    lambda m: m.IntervalParamScaler(1.5, (0.5, 1.5)), lambda m: m.IntervalParamScaler(0.5, (1.5, 0.5)),
    lambda m: m.IntervalParamScaler(0.5, (0.5,)), lambda m: m.IntervalParamScaler(0.5, (0.5, 1.5))(-1.0, 1.0, 1.0),
    lambda m: m.IntervalParamScaler(0.5, (0.5, 1.5))(1.0, -1.0, 1.0),
    lambda m: m.IntervalParamScaler(0.5, (0.5, 1.5))(1.0, None, 1.0),
    lambda m: m.LpRegularizer(1.0, lambda_updater=m.IntervalParamScaler(0.5, (0.5, 1.5)), p=2),
    lambda m: m.LpRegularizer(1.0, val_split=0.2, p=2),
    lambda m: m.LpRegularizer(0.0, p=2),
    lambda m: m.LpRegularizer(1.0, lambda_updater=m.ConstantParamScaler(), val_split=1.5, p=2),
    lambda m: m.LpRegularizer(1.0, p=0),
])
def test_validation_errors_match_jax(bad):
    with pytest.raises(ValueError) as jerr:
        bad(jax_reg)
    with pytest.raises(ValueError) as err:
        bad(reg)
    assert str(err.value) == str(jerr.value)


def test_update_params_factory_and_logged_lambda():
    scaler_kw = dict(scaling_factor=0.5, tolerable_interval=(0.9, 1.1))
    logger = configure(format_strs=())
    factory = reg.LpRegularizer.create(initial_lambda=0.2, val_split=0.25, p=2,
                                       lambda_updater=reg.IntervalParamScaler(**scaler_kw))
    r = factory(optimizer=None, logger=logger)
    jr = jax_reg.LpRegularizer.create(initial_lambda=0.2, val_split=0.25, p=2,
                                      lambda_updater=jax_reg.IntervalParamScaler(**scaler_kw))(optimizer=None)
    assert logger.default_logger.name_to_value["regularization_lambda"] == 0.2
    for train_loss, val_loss in ((1.0, 2.0), (1.0, 2.0), (2.0, 1.0), (1.0, 1.0)):
        r.update_params(train_loss, val_loss)
        jr.update_params(train_loss, val_loss)
        assert r.lambda_ == jr.lambda_
        assert logger.default_logger.name_to_value["regularization_lambda"] == r.lambda_
    assert r.lambda_ == 0.4 and r.val_split == 0.25
