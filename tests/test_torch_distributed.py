"""Data-parallel training over gloo ranks on the CPU: every rank ends with
bitwise identical parameters, and the W-rank run agrees with the port's
one-process run and with the JAX package's sharded run.

Two launches of ranks (``tests/torch_dist_worker.py``; each joins through a
``FileStore`` in the test's temporary directory, every collective waits at
most 120 s and the launch 240 s):

* W = 2: the counterpart of tests/parallel/test_distributed.py's psum step
  against its closed form, the collectives, their errors and a
  ``dp=1 x tp=2`` mesh with a tp placement; PPO
  ``process_chunk`` with feature and reward normalization, plain and with a
  ``target_kl`` that stops early; GAIL ``train_fused`` over 2 rounds with
  the JAX package's draws fed in (its epoch permutations and disc-step
  indices, one fixed rollout chunk, its weights), held against the JAX
  package's ``shard_adversarial_trainer`` on ``make_mesh(dp=2)`` over two of
  the conftest's virtual CPU devices; SAC with the split replay ring;
  ``BasicRewardTrainer`` and ``EnsembleTrainer`` with split batches; two
  ``PreferenceComparisons`` iterations placed by
  ``shard_preference_comparisons``; a PPO checkpoint saved at W = 2 and
  resumed here at W = 1.
* W = 4: GAIL ``train_fused`` on 8 CartPole envs stepped for real, the
  ``tp = 1`` counterpart of ``test_four_process_fused_adversarial_2x2``;
  the ported tutorial 11 (4 sharded rounds, then a resume at dp = 1).

Tolerances: parameters within ``tests/torch_parity.py``'s
``param_tolerance`` of the largest update of the run they are held
against, the float32 floor measured on the port's one-process run by
nudging its initial weights (``update_floors``); a reward net's output
bias, whose preference-loss gradient is rounding noise, apart (it moves at
most the learning rate per step); statistics and metrics 1e-5.
"""

import functools
import threading

import jax
import numpy as np
import pytest
import torch

import imitation_tpu.data.rollout as jax_rollout
from imitation_tpu.parallel import mesh as jax_mesh
from imitation_tpu_torch import convert
from imitation_tpu_torch.util.checkpoint import restore_state
from tests import torch_dist_worker as worker
from tests.test_torch_gail import _trainers, _transitions
from tests.torch_parity import (
    flat_params, host, jax_disc_indices, jax_epoch_perms, on_policy_aux, param_tolerance, random_chunk,
    update_floors,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
W2_CASES = "collectives,ppo,gail_fixed,sac,reward_basic,reward_ensemble,rlhf"


def _jax_gail(tmp_path, tp=1):
    """The JAX trainer, the inputs of the port's ranks (its weights, its
    draws, the fixed chunk), and a runner of its sharded ``train_fused`` on
    ``make_mesh(dp=2, tp=tp)``."""
    T, Bv, n_demo, B, rounds = 16, 8, 300, 64, 2
    jtr, _ = _trainers(tmp_path, n_steps=T, num_envs=Bv, n_demo=n_demo)
    if jtr.gen_state is None:
        jtr.gen_state = jtr.gen_algo.init_state()
    jchunk, tchunk = on_policy_aux(jtr.policy, jtr.gen_state.variables, *random_chunk(T, Bv, seed=3))
    jgen0 = host(jtr.gen_state.variables["params"])
    jdisc0 = host(jtr.disc_state.variables["params"])
    # Round 1's train_step splits the state's key; process_chunk's own split
    # of k_proc gives the key that round 2's train_step splits (ppo.py).
    _, _, k_proc1 = jax.random.split(jtr.gen_state.key, 3)
    _, _, k_proc2 = jax.random.split(jax.random.split(k_proc1)[0], 3)
    _, tdemo = _transitions(n_demo, seed=1)
    inputs = dict(
        T=T, B=Bv, rounds=rounds,
        demos={k: v.numpy() for k, v in tdemo.fields().items()},
        reward_sd=convert.reward_net_state_dict(host(jtr.disc_state.variables)),
        policy_sd=convert.policy_state_dict(host({"params": jtr.gen_state.variables["params"]})),
        chunk={f: getattr(tchunk, f).numpy() for f in worker.RolloutChunk.__dataclass_fields__ if f != "aux"},
        aux={k: v.numpy() for k, v in tchunk.aux.items()},
        perms=jax_epoch_perms(k_proc1, 2, T * Bv) + jax_epoch_perms(k_proc2, 2, T * Bv),
        disc_indices=jax_disc_indices(jtr.disc_state.key, 2 * rounds, B, n_demo, T * Bv),
    )

    def run():
        m = jax_mesh.make_mesh(dp=2, tp=tp, devices=jax.devices()[:2 * tp])
        jax_mesh.shard_adversarial_trainer(jtr, m)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_rollout, "collect", lambda venv, fn, params, state, n, key: (state, jchunk))
            with m:
                jtr.train_fused(rounds * T * Bv, rounds_per_sync=rounds)
        return {"policy": flat_params(jtr.gen_state.variables["params"], "net."),
                "disc": flat_params(jtr.disc_state.variables["params"]),
                "init": {"policy": flat_params(jgen0, "net."), "disc": flat_params(jdisc0)},
                "timesteps": int(jtr.gen_state.timesteps), "disc_step": int(jtr.disc_state.step)}

    return inputs, run


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The W = 2 launch, with the JAX package's sharded GAIL run computed
    meanwhile."""
    out = tmp_path_factory.mktemp("two_ranks")
    inputs, run_jax = _jax_gail(tmp_path_factory.mktemp("jax_logs"))
    torch.save({"gail": inputs}, out / "inputs.pt")
    failure = []

    def ranks():
        try:
            worker.launch(str(out), 2, W2_CASES)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            failure.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        jax_result = run_jax()
    finally:
        thread.join()
    if failure:
        raise failure[0]
    return out, inputs, jax_result


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("four_ranks")
    worker.launch(str(out), 4, "gail_envs,tutorial")
    return out


def _equal_ranks(results, *keys):
    for r in results[1:]:
        for key in keys:
            for name, v in results[0][key].items():
                np.testing.assert_array_equal(r[key][name], v, err_msg=f"{key}.{name}")


def _assert_close(got, want, init, rel, skip=()):
    """Every parameter within ``rel`` times the largest update of ``want``."""
    assert sorted(got) == sorted(want)
    keys = [k for k in want if k not in skip]
    upd = max(np.abs(want[k] - init[k]).max() for k in keys)
    err = max(np.abs(got[k] - want[k]).max() for k in keys)
    assert upd > 0 and err <= rel * upd, f"max error {err:.3g} vs largest update {upd:.3g} (limit {rel:.3g})"


@functools.lru_cache(maxsize=None)
def _ppo_one_process(label):
    """The one-process PPO case and its float32 floor."""
    one = worker.ppo_case(None)[label]

    def run(rel):
        res = worker.ppo_case(None, rel)[label]
        return {"policy": (res["init"], res["params"])}

    return one, update_floors(run)["policy"]


def test_collectives_against_closed_form(two_ranks):
    out, _, _ = two_ranks
    r0, r1 = worker.load(str(out), "collectives", 2)
    x = np.concatenate([np.arange(16, dtype=np.float32).reshape(4, 4) + 100.0 * pid for pid in range(2)])
    w = np.ones(4, np.float32)
    expected_w = w - 0.01 * 2.0 * (x.T @ (x @ w)) / x.shape[0]
    for rank, r in enumerate((r0, r1)):
        np.testing.assert_array_equal(r["w"], r0["w"])
        np.testing.assert_allclose(r["w"], expected_w, rtol=1e-4)
        np.testing.assert_allclose(r["full"], x, rtol=0)
        assert r["count"] == 32.0
        np.testing.assert_allclose(r["batch_mean"], x.mean(), rtol=1e-6)
        np.testing.assert_allclose(r["batch_var"], x.var(), rtol=1e-5)
        assert r["col_count"] == 8.0
        np.testing.assert_allclose(r["col_mean"], x.mean(0), rtol=1e-6)
        np.testing.assert_allclose(r["col_mean_ema"], x.mean(0), rtol=1e-6)
        np.testing.assert_allclose(r["col_var"], x.var(0), rtol=1e-5)
        np.testing.assert_array_equal(r["replicated"], np.ones(3, np.float32))
        assert r["local_envs"] == 4
        errors = r["errors"]
        assert errors["env_count"][0] == "ValueError" and "not divisible by 2" in errors["env_count"][1]
        assert errors["tp"] is None  # the tp placement over a dp=1 x tp=2 mesh of both ranks
        assert r["tp_mesh"] == ({"dp": 1, "tp": 2}, 0, rank)
        assert errors["dp_tp"][0] == "ValueError" and "dp*tp = 3*1 != 2" in errors["dp_tp"][1]
    whole = np.arange(12).reshape(4, 3)
    np.testing.assert_array_equal(r0["draw"], whole[:2])
    np.testing.assert_array_equal(r1["draw"], whole[2:])


@pytest.mark.parametrize("label", ["plain", "kl"])
def test_ppo_process_chunk_two_ranks(two_ranks, label):
    out, _, _ = two_ranks
    ranks = [r[label] for r in worker.load(str(out), "ppo", 2)]
    _equal_ranks(ranks, "params")
    for name in ("feat_mean", "feat_var", "rew_stats"):
        np.testing.assert_array_equal(ranks[1][name], ranks[0][name])
    one, floor = _ppo_one_process(label)
    _assert_close(ranks[0]["params"], one["params"], one["init"], param_tolerance(floor))
    for name in ("feat_mean", "feat_var", "rew_stats"):
        np.testing.assert_allclose(ranks[0][name], one[name], **TOL, err_msg=name)
    assert ranks[0]["timesteps"] == one["timesteps"] == 2 * worker.PPO_T * worker.PPO_B
    assert sorted(ranks[0]["metrics"]) == sorted(one["metrics"])
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    if label == "kl":
        assert ranks[0]["metrics"]["early_stop"] == one["metrics"]["early_stop"] == 1.0


def test_gail_train_fused_two_ranks_against_jax(two_ranks):
    out, inputs, jres = two_ranks
    ranks = worker.load(str(out), "gail_fixed", 2)
    _equal_ranks(ranks, "policy", "disc")
    np.testing.assert_array_equal(ranks[1]["ring"], ranks[0]["ring"])
    got = ranks[0]
    T, B, rounds = inputs["T"], inputs["B"], inputs["rounds"]
    assert got["timesteps"] == jres["timesteps"] == rounds * T * B
    assert got["disc_step"] == jres["disc_step"] == 2 * rounds and got["ring_size"] == T * B

    def port(rel):
        res = worker.gail_fixed_case(None, inputs, rel)
        return {k: (res["init"][k], res[k]) for k in ("policy", "disc")}

    one = worker.gail_fixed_case(None, inputs)
    np.testing.assert_array_equal(got["ring"], one["ring"])  # the one-process ring exactly
    floors = update_floors(port)
    for key in ("policy", "disc"):
        tol = param_tolerance(floors[key])
        _assert_close(got[key], jres[key], jres["init"][key], tol)
        _assert_close(got[key], one[key], one["init"][key], tol)


def test_sac_split_ring_two_ranks(two_ranks):
    out, _, _ = two_ranks
    ranks = worker.load(str(out), "sac", 2)
    _equal_ranks(ranks, "actor", "critic")
    assert ranks[0]["log_alpha"] == ranks[1]["log_alpha"]
    one = worker.sac_case(None)
    assert one["local_rows"] == 32 and all(r["local_rows"] == 16 for r in ranks)
    assert all(r["local_size"] == 16 for r in ranks) and ranks[0]["timesteps"] == one["timesteps"] == 48
    for name in ("ring_obs", "ring_acts"):
        np.testing.assert_array_equal(ranks[1][name], ranks[0][name])
        np.testing.assert_allclose(ranks[0][name], one[name], **TOL, err_msg=name)
    # Every rank computes the whole update on the gathered batch: the
    # one-process update up to the rounding of the collection's forward.
    for key in ("actor", "critic"):
        scale = max(np.abs(v).max() for v in one[key].values())
        err = max(np.abs(ranks[0][key][k] - v).max() for k, v in one[key].items())
        assert err <= 1e-5 * scale, (key, err, scale)
    np.testing.assert_allclose(ranks[0]["log_alpha"], one["log_alpha"], **TOL)
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["basic", "ensemble"])
def test_reward_trainer_split_batches_two_ranks(two_ranks, kind):
    out, _, _ = two_ranks
    ranks = worker.load(str(out), f"reward_{kind}", 2)
    _equal_ranks(ranks, "params")
    one = worker.reward_case(None, kind)
    bias = [k for k in one["params"] if k.endswith("dense_out.bias")]

    def run(rel):
        res = worker.reward_case(None, kind, rel)
        return {"net": tuple({k: v for k, v in res[part].items() if k not in bias}
                             for part in ("init", "params"))}

    floor = update_floors(run)["net"]
    _assert_close(ranks[0]["params"], one["params"], one["init"], param_tolerance(floor), skip=bias)
    steps = 3 * 3  # 3 epochs of 3 batches
    for k in bias:
        for res in (ranks[0], one):
            assert np.abs(res["params"][k] - res["init"][k]).max() <= 1e-3 * steps * (1 + 1e-5)
    assert sorted(ranks[0]["metrics"]) == sorted(one["metrics"])
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, **TOL, err_msg=k)


def test_preference_comparisons_two_ranks(two_ranks):
    out, _, _ = two_ranks
    ranks = worker.load(str(out), "rlhf", 2)
    _equal_ranks(ranks, "policy", "net")
    one = worker.rlhf_case(None)
    assert ranks[0]["timesteps"] == one["timesteps"] and ranks[0]["dataset"] == one["dataset"] == 32
    bias = [k for k in one["net"] if k.endswith("dense_out.bias")]

    def run(rel):
        res = worker.rlhf_case(None, rel)
        return {"policy": (res["init"]["policy"], res["policy"]),
                "net": tuple({k: v for k, v in part.items() if k not in bias}
                             for part in (res["init"]["net"], res["net"]))}

    floors = update_floors(run)
    _assert_close(ranks[0]["policy"], one["policy"], one["init"]["policy"], param_tolerance(floors["policy"]))
    _assert_close(ranks[0]["net"], one["net"], one["init"]["net"], param_tolerance(floors["net"]), skip=bias)
    np.testing.assert_allclose(ranks[0]["accuracy"], one["accuracy"], **TOL)


def test_checkpoint_saved_at_two_ranks_resumes_at_one(two_ranks):
    out, _, _ = two_ranks
    ranks = worker.load(str(out), "ppo", 2)
    ppo = worker.build_ppo()
    fresh = ppo.init_state()
    reset_obs = fresh.env_state.obs.clone()
    state = restore_state(str(out / "ppo.ckpt"), fresh)
    assert state.mesh is None and state.timesteps == 2 * worker.PPO_T * worker.PPO_B
    for k, v in worker.params(ppo.policy).items():
        np.testing.assert_array_equal(v, ranks[0]["plain"]["params"][k], err_msg=k)
    # The env rows gathered from both ranks are the one-process reset.
    np.testing.assert_array_equal(state.env_state.obs.numpy(), reset_obs.numpy())
    local = np.concatenate([r["local_ret"] for r in ranks])
    init = worker.params(ppo.policy)
    state, metrics = ppo.process_chunk(state, state.env_state, worker.ppo_chunk(ppo.policy, 3), state.generator)
    np.testing.assert_allclose(state.reward_norm.ret.numpy(), local, **TOL)
    resumed = ranks[0]["resumed"]
    np.testing.assert_allclose(float(state.reward_norm.mean), resumed["rew_stats"][0], **TOL)
    _, floor = _ppo_one_process("plain")
    _assert_close(resumed["params"], worker.params(ppo.policy), init, param_tolerance(floor))


def test_gail_train_fused_four_ranks(four_ranks):
    ranks = worker.load(str(four_ranks), "gail_envs", 4)
    _equal_ranks(ranks, "policy", "disc")
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["ring"], ranks[0]["ring"])
    got = ranks[0]
    assert got["local_envs"] == 2 and got["timesteps"] == 2 * 8 * 8
    assert got["n_updates"] == 2 and got["disc_step"] == 4

    def port(rel):
        res = worker.gail_envs_case(None, rel)
        return {k: (res["init"][k], res[k]) for k in ("policy", "disc")}

    one = worker.gail_envs_case(None)
    np.testing.assert_allclose(got["ring"], one["ring"], **TOL)
    floors = update_floors(port)
    for key in ("policy", "disc"):
        _assert_close(got[key], one[key], one["init"][key], param_tolerance(floors[key]))


def test_tutorial_11_trains_sharded_and_resumes_in_one_process(four_ranks):
    ranks = worker.load(str(four_ranks), "tutorial", 4)
    _equal_ranks(ranks, "policy")
    assert all(r["n_updates"] == 4 and r["timesteps"] == 4 * 16 * 8 for r in ranks)
    assert ranks[0]["resumed_n_updates"] == 6 and ranks[0]["resumed_timesteps"] == 6 * 16 * 8
    assert all("resumed_n_updates" not in r for r in ranks[1:])
