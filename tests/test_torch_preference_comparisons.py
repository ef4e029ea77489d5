"""Preference comparisons in imitation_tpu_torch against the JAX package:
fragments, preferences, the preference dataset, the preference model and
the loss (the reward trainers and the loop are in
``tests/test_torch_preference_training.py``).

Both packages draw every host-side choice from numpy ``Generator``s seeded
alike, so nothing is injected: the same trajectories give the same
fragments and preferences, exactly. Reward nets take the JAX package's
weights through ``convert``.

Tolerances: fragments, preferences and selected pairs exactly; the
gatherer's entropy 1e-6; preference probabilities, losses and metrics 1e-5
(float32 products summed in another order).
"""

import jax
import numpy as np
import pytest
import torch

from imitation_tpu.algorithms import preference_comparisons as jpc
from imitation_tpu.data import types as jax_types
from imitation_tpu.models import networks as jax_networks
from imitation_tpu.rewards import reward_nets as jax_nets
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms import preference_comparisons as pc
from imitation_tpu_torch.data import types
from imitation_tpu_torch.models import networks
from imitation_tpu_torch.rewards import reward_nets
from imitation_tpu_torch.util.logger import configure
from tests.torch_parity import host, spaces

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
L = 6  # fragment length


def _trajs(mod, seed=0, n=8):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        steps = int(rng.integers(L, 4 * L))
        out.append(mod.TrajectoryWithRew(
            obs=rng.normal(size=(steps + 1, 3)).astype(np.float32),
            acts=rng.normal(size=(steps, 2)).astype(np.float32),
            rews=rng.normal(size=steps), infos=None, terminal=bool(i % 3 == 0)))
    return out


def _assert_same_pairs(got, want):
    assert len(got) == len(want) > 0
    for pair, jpair in zip(got, want):
        for f, jf in zip(pair, jpair):
            assert f.terminal == jf.terminal and f.infos is None
            for name in ("obs", "acts", "rews"):
                np.testing.assert_array_equal(getattr(f, name), np.asarray(getattr(jf, name)), name)


def _basic(normalize_input=True):
    jo, ja, to, ta = spaces("box")
    return (jax_nets.BasicRewardNet(observation_space=jo, action_space=ja, normalize_input=normalize_input),
            reward_nets.BasicRewardNet(to, ta, normalize_input=normalize_input))


def _ensemble():
    jo, ja, to, ta = spaces("box")
    return (jax_nets.RewardEnsemble(observation_space=jo, action_space=ja, member_cls=jax_nets.BasicRewardNet,
                                    num_members=3, member_normalize_cls=jax_networks.RunningNorm),
            reward_nets.RewardEnsemble(to, ta, num_members=3, member_normalize_cls=networks.RunningNorm))


def _weights(jnet, seed=0):
    """JAX variables with non-trivial statistics (one fold of random rows
    where the net has output normalizers)."""
    jvars = jnet.init_variables(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(32, 3)).astype(np.float32), rng.normal(size=(32, 2)).astype(np.float32),
         rng.normal(size=(32, 3)).astype(np.float32), np.zeros(32, np.float32))
    if isinstance(jnet, jax_nets.RewardEnsemble):
        _, mut = jnet.apply(jvars, *x, update_stats=True, method="predict_reward_moments", mutable=["stats"])
        jvars = {**jvars, "stats": mut["stats"]}
    return host(jvars)


def _load(net, jvars, rel=0.0):
    sd = convert.reward_net_state_dict(jvars)
    names = dict(net.named_parameters())
    net.load_state_dict({k: v * (1 + rel) if k in names else v for k, v in sd.items()})
    return net


def _dataset(mod, n_pairs, seed=0, pairs=None):
    """A preference dataset of ``n_pairs`` fragment pairs from ``_trajs``,
    with sampled preferences (one push, or two when ``pairs`` splits)."""
    ds = mod.PreferenceDataset()
    frag = mod.RandomFragmenter(rng=seed, warning_threshold=0, custom_logger=_logger(mod))
    gatherer = mod.SyntheticGatherer(rng=seed, custom_logger=_logger(mod))
    for n in pairs or (n_pairs,):
        fragments = frag(_trajs(jax_types if mod is jpc else types, seed), L, n)
        ds.push(fragments, gatherer(fragments))
    return ds


def _logger(mod):
    return jax_configure(format_strs=()) if mod is jpc else configure(format_strs=())


# -- fragments and preferences -------------------------------------------------


@pytest.mark.parametrize("num_pairs,warning_threshold", [(5, 10), (40, 0), (3, 0)])
def test_random_fragmenter_matches_jax(num_pairs, warning_threshold):
    got = pc.RandomFragmenter(rng=3, warning_threshold=warning_threshold, custom_logger=_logger(pc))(
        _trajs(types, 1), L, num_pairs)
    want = jpc.RandomFragmenter(rng=3, warning_threshold=warning_threshold, custom_logger=_logger(jpc))(
        _trajs(jax_types, 1), L, num_pairs)
    _assert_same_pairs(got, want)
    assert all(len(f) == L for pair in got for f in pair)


def test_random_fragmenter_refuses_short_trajectories():
    with pytest.raises(ValueError, match="long enough"):
        pc.RandomFragmenter(rng=0, custom_logger=_logger(pc))(_trajs(types, 1), 10 * L, 2)


@pytest.mark.parametrize("uncertainty_on", ["logit", "probability", "label"])
def test_active_selection_fragmenter_matches_jax(uncertainty_on):
    jnet, net = _ensemble()
    jvars = _weights(jnet, 2)
    _load(net, jvars)
    jfrag = jpc.ActiveSelectionFragmenter(
        jpc.PreferenceModel(jnet), jpc.RandomFragmenter(rng=4, custom_logger=_logger(jpc)), 2.5,
        uncertainty_on=uncertainty_on, custom_logger=_logger(jpc))
    jfrag.variables = jvars
    frag = pc.ActiveSelectionFragmenter(
        pc.PreferenceModel(net), pc.RandomFragmenter(rng=4, custom_logger=_logger(pc)), 2.5,
        uncertainty_on=uncertainty_on, custom_logger=_logger(pc))
    got, want = frag(_trajs(types, 5), L, 7), jfrag(_trajs(jax_types, 5), L, 7)
    assert len(got) == 7
    _assert_same_pairs(got, want)


def test_active_selection_needs_an_ensemble_and_a_known_mode():
    _, net = _basic()
    with pytest.raises(ValueError, match="ensemble"):
        pc.ActiveSelectionFragmenter(pc.PreferenceModel(net), pc.RandomFragmenter(), 2.0)
    _, ens = _ensemble()
    with pytest.raises(ValueError, match="not supported"):
        pc.ActiveSelectionFragmenter(pc.PreferenceModel(ens), pc.RandomFragmenter(), 2.0, uncertainty_on="x")


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.5, discount_factor=0.9), dict(sample=False),
                                dict(temperature=0.0), dict(sample=False, threshold=0.2)])
def test_synthetic_gatherer_matches_jax(kw):
    fragments = pc.RandomFragmenter(rng=6, custom_logger=_logger(pc))(_trajs(types, 2), L, 50)
    jfragments = jpc.RandomFragmenter(rng=6, custom_logger=_logger(jpc))(_trajs(jax_types, 2), L, 50)
    logger, jlogger = configure(format_strs=()), jax_configure(format_strs=())
    gatherer = pc.SyntheticGatherer(rng=np.random.default_rng(7), custom_logger=logger, **kw)
    jgatherer = jpc.SyntheticGatherer(rng=np.random.default_rng(7), custom_logger=jlogger, **kw)
    for _ in range(2):
        prefs, jprefs = gatherer(fragments), jgatherer(jfragments)
        assert prefs.dtype == jprefs.dtype
        np.testing.assert_array_equal(prefs, jprefs)
    if kw.get("sample", True):
        assert np.isin(prefs, [0.0, 0.5, 1.0]).all()
    if kw.get("temperature", 1.0):
        entropy, jentropy = (lg.default_logger.name_to_value["entropy"] for lg in (logger, jlogger))
        np.testing.assert_allclose(entropy, jentropy, rtol=1e-6)
        assert entropy > 0


def test_xlogx_is_zero_at_zero_without_warnings():
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = pc._xlogx(np.array([0.0, 0.25, 1.0], np.float32))
    np.testing.assert_allclose(out, [0.0, 0.25 * np.log(0.25), 0.0])
    assert out.dtype == np.float32


def test_preference_dataset_fifo_and_pickle(tmp_path):
    ds, jds = _dataset(pc, 0, pairs=(6, 5)), _dataset(jpc, 0, pairs=(6, 5))
    assert len(ds) == len(jds) == 11
    small = pc.PreferenceDataset(max_size=4)
    pairs = [ds[i][0] for i in range(len(ds))]
    small.push(pairs, ds.preferences.astype(np.float32))
    assert len(small) == 4 and small[0][0][0] is pairs[-4][0] and small[0][0][1] is pairs[-4][1]
    np.testing.assert_array_equal(small.preferences, ds.preferences[-4:])
    with pytest.raises(ValueError, match="dtype"):
        small.push(pairs[:2], np.zeros(2))
    with pytest.raises(ValueError, match="shape"):
        small.push(pairs[:2], np.zeros(3, np.float32))
    ds.save(tmp_path / "prefs.pkl")
    back = pc.PreferenceDataset.load(tmp_path / "prefs.pkl")
    np.testing.assert_array_equal(back.preferences, jds.preferences)
    _assert_same_pairs([back[i][0] for i in range(len(back))], [jds[i][0] for i in range(len(jds))])


def test_fragment_batch_from_pairs_matches_jax():
    ds, jds = _dataset(pc, 40), _dataset(jpc, 40)
    batch, jbatch = ds.as_batch("cpu"), jds.as_batch()
    for name in ("obs", "acts", "rews_gt", "dones", "prefs"):
        got, want = getattr(batch, name), getattr(jbatch, name)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    assert batch.num_pairs == 40 and batch.fragment_length == L
    assert batch.obs.shape == (40, 2, L + 1, 3) and float(batch.dones.sum()) > 0
    short = types.TrajectoryWithRew(obs=np.zeros((3, 3)), acts=np.zeros((2, 2)), rews=np.zeros(2),
                                    infos=None, terminal=False)
    with pytest.raises(ValueError, match="equal length"):
        pc.FragmentBatch.from_pairs([(ds[0][0][0], short)], np.zeros(1), "cpu")


# -- preference model and loss ---------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(discount_factor=0.9), dict(noise_prob=0.2, threshold=0.3)])
@pytest.mark.parametrize("make", [_basic, _ensemble])
def test_preference_model_and_loss_match_jax(make, kw):
    jnet, net = make()
    jvars = _weights(jnet, 1)
    _load(net, jvars)
    batch, jbatch = _dataset(pc, 12).as_batch("cpu"), _dataset(jpc, 12).as_batch()
    pm, jpm = pc.PreferenceModel(net, **kw), jpc.PreferenceModel(jnet, **kw)
    assert pm.is_ensemble == jpm.is_ensemble
    np.testing.assert_allclose(pm.fragment_rewards(batch).detach().numpy(),
                               np.asarray(jpm.fragment_rewards(jvars, jbatch)), **TOL)
    probs = pm(batch)
    assert probs.shape == ((3, 12) if pm.is_ensemble else (12,))
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(jpm(jvars, jbatch)), **TOL)
    out = pc.CrossEntropyRewardLoss()(pm, batch)
    jout = jpc.CrossEntropyRewardLoss()(jpm, jvars, jbatch)
    np.testing.assert_allclose(float(out.loss.detach()), float(jout.loss), **TOL)
    assert sorted(out.metrics) == sorted(jout.metrics)
    for k, v in jout.metrics.items():
        np.testing.assert_allclose(float(out.metrics[k].detach()), float(v), **TOL, err_msg=k)


def test_member_fragment_rewards_match_jax():
    """Each member on its own bagged pairs, in one forward."""
    jnet, net = _ensemble()
    jvars = _weights(jnet, 3)
    _load(net, jvars)
    batch, jbatch = _dataset(pc, 10).as_batch("cpu"), _dataset(jpc, 10).as_batch()
    idx = np.random.default_rng(0).integers(0, 10, size=(3, 7))
    got = pc.PreferenceModel(net).member_fragment_rewards(batch.map(lambda x: x[torch.from_numpy(idx)]))
    want = jpc.PreferenceModel(jnet).member_fragment_rewards(jvars, jax.tree.map(lambda x: x[idx], jbatch))
    assert got.shape == (3, 7, 2, L)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    with pytest.raises(TypeError, match="RewardEnsemble"):
        pc.PreferenceModel(_basic()[1]).member_fragment_rewards(batch)
