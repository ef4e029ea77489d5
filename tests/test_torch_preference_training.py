"""The reward trainers and the loop of preference comparisons in
imitation_tpu_torch against the JAX package: ``BasicRewardTrainer`` and
``EnsembleTrainer`` (trailing batches, minibatch slices, AdamW weight decay,
a regularizer with a train/val split, per-member bagging) and
``PreferenceComparisons.train`` over a ``TrajectoryDataset``.

Both packages draw every host-side choice from numpy ``Generator``s seeded
alike; reward nets take the JAX package's weights through ``convert``.

Tolerances: the dataset's fragments and preferences exactly; metrics 1e-5;
the reward nets' parameters within ``tests/torch_parity.py``'s float32
floor (``PARAM_REL`` of the largest update, or 4x the case's own float32
floor). The output bias is held apart: it adds the same amount to both
fragments' returns, so the preference loss's gradient on it is zero but
for rounding, and Adam turns the sign of that rounding into a full step.
It is checked to move by at most the learning rate per step in both
packages.
"""

import numpy as np
import pytest
import torch

from imitation_tpu.algorithms import preference_comparisons as jpc
from imitation_tpu.algorithms import regularization as jax_reg
from imitation_tpu.data import types as jax_types
from imitation_tpu.util import util as jax_util
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms import preference_comparisons as pc
from imitation_tpu_torch.algorithms import regularization as reg
from imitation_tpu_torch.data import types
from imitation_tpu_torch.rewards import reward_nets
from imitation_tpu_torch.util import util
from imitation_tpu_torch.util.logger import configure
from tests.test_torch_preference_comparisons import (
    L, TOL, _assert_same_pairs, _basic, _dataset, _ensemble, _load, _logger, _trajs, _weights,
)
from tests.torch_parity import flat_params, param_tolerance, update_floors

torch.set_num_threads(1)


def _is_out_bias(name):
    return name.endswith("dense_out.bias")


def _snapshot(net):
    """The parameters the preference loss identifies (all but the output bias)."""
    return {k: v.detach().clone().numpy() for k, v in net.named_parameters() if not _is_out_bias(k)}


def _assert_params(net, jparams, jinit, floor, lr, steps):
    """Each identified parameter within ``param_tolerance(floor)`` of the
    largest JAX update; the output bias within ``lr`` per step of its start
    in both packages."""
    want, init = flat_params(jparams), flat_params(jinit)
    got = {k: v.detach().numpy() for k, v in net.named_parameters()}
    assert sorted(got) == sorted(want)
    keys = [k for k in want if not _is_out_bias(k)]
    upd = max(np.abs(want[k] - init[k]).max() for k in keys)
    err = max(np.abs(got[k] - want[k]).max() for k in keys)
    rel = param_tolerance(floor)
    assert upd > 0 and err <= rel * upd, f"error {err:.3g} vs largest update {upd:.3g} (limit {rel:.3g})"
    for k in want:
        if _is_out_bias(k):
            for moved in (got[k] - init[k], want[k] - init[k]):
                assert np.abs(moved).max() <= lr * steps * (1 + 1e-5), k


# -- reward trainers ------------------------------------------------------------


def _regularizer(mod):
    return mod.LpRegularizer.create(initial_lambda=0.05, val_split=0.25, p=2,
                                    lambda_updater=mod.IntervalParamScaler(0.5, (0.9, 1.1)))


TRAINER_CASES = {
    # (net, trainer kwargs, regularizer): a trailing batch of 6 (22 pairs,
    # batch 8) and minibatch slices of 4; with a regularizer 16 pairs train
    # (trailing batch 0) and 6 validate.
    "basic": (_basic, dict(batch_size=8, minibatch_size=4, epochs=3, lr=1e-3), False),
    "basic_reg_wd": (_basic, dict(batch_size=8, epochs=2, lr=1e-3, weight_decay=1e-2), True),
    "ensemble": (_ensemble, dict(batch_size=8, minibatch_size=4, epochs=2, lr=1e-3), False),
    "ensemble_reg": (_ensemble, dict(batch_size=8, minibatch_size=4, epochs=2, lr=1e-3), True),
}


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_reward_trainer_train_matches_jax(case):
    make, kw, with_reg = TRAINER_CASES[case]
    jnet, _ = make()
    jvars = _weights(jnet, 4)
    jpm = jpc.PreferenceModel(jnet)
    jtrainer = jpc._make_reward_trainer(jpm, rng=5, reward_trainer_kwargs=dict(
        kw, regularizer_factory=_regularizer(jax_reg) if with_reg else None))
    jtrainer.attach(jvars)
    jlogger = jax_configure(format_strs=())
    jtrainer.logger = jlogger
    jds = _dataset(jpc, 22)
    jmetrics = jtrainer.train(jds, epoch_multiplier=1.5)
    runs = {}

    def run(rel):
        net = _load(make()[1], jvars, rel)
        trainer = pc._make_reward_trainer(pc.PreferenceModel(net), rng=5, reward_trainer_kwargs=dict(
            kw, regularizer_factory=_regularizer(reg) if with_reg else None))
        trainer.logger = configure(format_strs=())
        assert isinstance(trainer, pc.EnsembleTrainer) == (make is _ensemble)
        init = _snapshot(net)
        metrics = trainer.train(_dataset(pc, 22), epoch_multiplier=1.5)
        runs[rel] = (net, trainer, metrics)
        return {"reward": (init, _snapshot(net))}

    floors = update_floors(run)
    net, trainer, metrics = runs[0.0]
    _assert_params(net, jtrainer.variables["params"], jvars["params"], floors["reward"], kw["lr"],
                   trainer.optimizer.count)
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k], v, **TOL, err_msg=k)
    got = trainer.logger.default_logger.name_to_value
    want = jlogger.default_logger.name_to_value
    assert sorted(got) == sorted(want)
    if with_reg:
        assert trainer.regularizer.lambda_ == jtrainer.regularizer.lambda_
        np.testing.assert_allclose(got["mean/reward/val_loss"], want["mean/reward/val_loss"], **TOL)
    assert all(p.grad is not None for p in net.parameters())


def test_trainer_batch_must_divide_and_ensemble_trainer_needs_an_ensemble():
    _, net = _basic()
    with pytest.raises(ValueError, match="multiple"):
        pc.BasicRewardTrainer(pc.PreferenceModel(net), batch_size=8, minibatch_size=3)
    with pytest.raises(TypeError, match="RewardEnsemble"):
        pc.EnsembleTrainer(pc.PreferenceModel(net))


def test_regularizer_split_needs_enough_pairs():
    _, net = _basic()
    trainer = pc.BasicRewardTrainer(pc.PreferenceModel(net), regularizer_factory=_regularizer(reg),
                                    custom_logger=configure(format_strs=()))
    with pytest.raises(ValueError, match="Not enough data"):
        trainer.train(_dataset(pc, 3))


# -- the loop ---------------------------------------------------------------------


def test_schedules_oric_and_base_model():
    x = np.array([0.4, 1.7, 2.5, 3.4])
    np.testing.assert_array_equal(util.oric(x), jax_util.oric(x))
    for name, f in pc.QUERY_SCHEDULES.items():
        for t in (0.0, 0.3, 1.0):
            assert f(t) == jpc.QUERY_SCHEDULES[name](t)
    _, net = _basic()
    wrapped = reward_nets.NormalizedRewardNet(net)
    assert pc.get_base_model(wrapped) is net and pc.get_base_model(net) is net


@pytest.mark.parametrize("ensemble", [False, True])
def test_preference_comparisons_train_matches_jax(ensemble):
    """Two iterations (an initial share and two scheduled ones) over a
    ``TrajectoryDataset``, the rng shared by fragmenter, gatherer and
    trainer as the loop builds them; with the ensemble, active selection."""
    make = _ensemble if ensemble else _basic
    jnet, _ = make()
    jvars = _weights(jnet, 6)

    def build(mod, net, variables):
        rng = np.random.default_rng(11)
        pm = mod.PreferenceModel(net)
        fragmenter = None
        if ensemble:
            fragmenter = mod.ActiveSelectionFragmenter(pm, mod.RandomFragmenter(rng=rng), 2.0)
        trainer = mod._make_reward_trainer(pm, rng=rng, reward_trainer_kwargs=dict(batch_size=8, lr=1e-3))
        kw = dict(reward_variables=variables, device="cpu") if mod is pc else dict(reward_variables=variables)
        return mod.PreferenceComparisons(
            mod.TrajectoryDataset(_trajs(jax_types if mod is jpc else types, 8, n=24), rng=rng), net,
            num_iterations=2, fragmenter=fragmenter, reward_trainer=trainer, fragment_length=L,
            initial_epoch_multiplier=3.0, custom_logger=_logger(mod), allow_variable_horizon=True,
            rng=rng, transition_oversampling=1.5, initial_comparison_frac=0.2, **kw)

    jloop = build(jpc, jnet, jvars)
    jresult = jloop.train(total_timesteps=100, total_comparisons=20)
    runs = {}

    def run(rel):
        net = make()[1]
        sd = {k: v * (1 + rel) if k in dict(net.named_parameters()) else v
              for k, v in convert.reward_net_state_dict(jvars).items()}
        loop = build(pc, net, sd)
        init = _snapshot(net)
        runs[rel] = (loop, loop.train(total_timesteps=100, total_comparisons=20))
        return {"reward": (init, _snapshot(net))}

    floors = update_floors(run)
    loop, result = runs[0.0]
    assert len(loop.dataset) == len(jloop.dataset) == 20
    np.testing.assert_array_equal(loop.dataset.preferences, jloop.dataset.preferences)
    _assert_same_pairs([loop.dataset[i][0] for i in range(20)], [jloop.dataset[i][0] for i in range(20)])
    _assert_params(loop.model, jloop.reward_variables["params"], jvars["params"], floors["reward"], 1e-3,
                   loop.reward_trainer.optimizer.count)
    for k in ("reward_loss", "reward_accuracy"):
        np.testing.assert_allclose(result[k], jresult[k], **TOL)
    assert loop._iteration == 3
