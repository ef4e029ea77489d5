"""The port's examples and tutorials (``imitation_tpu_torch/examples``)
against the JAX package's.

* Every ported ``main`` runs on the CPU (``device="cpu"``) at the budgets
  of ``tests/test_examples.py`` and prints the JAX tutorial's line (5a has
  its own test in ``tests/test_torch_pixel_cartpole.py``, 11 needs ranks:
  ``tests/test_torch_distributed.py``). The quickstart and the RLHF example
  take no budget arguments; on the CPU their trainers' ``train`` /
  ``train_fused`` calls are cut to 3 rounds and the RLHF loop's to 4,000
  timesteps and 40 comparisons (the chip run takes them whole). These are
  stochastic runs of different random streams, so the printed numbers are
  not compared.
* Tutorial 10's ``GoalGrid``: ``step`` on given states and actions equals
  the JAX env's exactly (positions and rewards); ``reset`` draws in the JAX
  range, U(-1, 0) per coordinate.
* ``benchmarking.summarize``'s ``iqm``, ``bootstrap_ci`` (seed 0) and
  ``probability_of_improvement`` equal ``benchmarking/summarize.py``'s on
  seeded numpy scores, ties included.
* Tutorial 6: the expert's occupancy equals the JAX tutorial's within 1e-5
  (the same float32 recursions; the printed rounded line is equal), and
  the learned occupancy after 100 iterations of the tutorial's MCE IRL (lr
  0.05) from the JAX weights within 1e-4. The stop on ``linf_eps`` is not
  reproducible across float32 runs (a flat tail), so iterations are fixed.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarking.summarize as jax_summarize
import examples.tutorials.t06_train_mce as jax_t06
import examples.tutorials.t10_train_custom_env as jax_t10
import imitation_tpu.algorithms.mce_irl as jax_mce
from imitation_tpu.envs.tabular import random_mdp as jax_random_mdp
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms import mce_irl
from imitation_tpu_torch.benchmarking import summarize
from imitation_tpu_torch.envs.tabular import random_mdp
from imitation_tpu_torch.examples.tutorials import t06_train_mce, t10_train_custom_env
from tests.torch_parity import host

torch.set_num_threads(1)

PORT = "imitation_tpu_torch.examples."
# (module, kwargs at tests/test_examples.py's budgets, expected line)
MAINS = [
    ("tutorials.t01_train_bc", {}, "return after BC"),
    ("tutorials.t02_train_dagger", {"total_timesteps": 1000}, "DAgger return after 1000 steps"),
    ("tutorials.t03_train_gail", {"total_timesteps": 4096}, "GAIL return"),
    ("tutorials.t04_train_airl", {"total_timesteps": 4096}, "learned reward on an expert episode"),
    ("tutorials.t05_preference_comparisons", {"total_timesteps": 4000, "total_comparisons": 40}, "reward loss"),
    ("tutorials.t06_train_mce", {}, "occupancy gap"),
    ("tutorials.t07_train_density", {"rl_timesteps": 1024}, "log-density"),
    ("tutorials.t08_train_sqil", {"total_timesteps": 1000}, "SQIL return after 1000 steps"),
    ("tutorials.t08a_train_sqil_sac", {"total_timesteps": 500}, "SQIL-SAC return after 500 steps"),
    ("tutorials.t09_compare_baselines", {"n_seeds": 2, "n_epochs": 1}, "P(BC > random)"),
    ("tutorials.t10_train_custom_env", {"ppo_iters": 5}, "BC return"),
    ("quickstart", {}, "AIRL return"),
    ("rlhf_preference_comparisons", {}, "final reward loss"),
]


def _cut(monkeypatch, mod):
    """Cuts the quickstart's GAIL and AIRL to 3 rounds each and the RLHF
    example's loop to 4,000 timesteps and 40 comparisons."""
    if hasattr(mod, "GAIL"):
        for name, method in (("GAIL", "train_fused"), ("AIRL", "train")):
            cls = getattr(mod, name)

            def cut(self, total_timesteps, *args, _train=getattr(cls, method), **kwargs):
                return _train(self, min(total_timesteps, 3 * self.gen_train_timesteps), *args, **kwargs)

            monkeypatch.setattr(mod, name, type(name, (cls,), {method: cut}))
    if hasattr(mod, "pc"):
        train = mod.pc.PreferenceComparisons.train
        monkeypatch.setattr(mod.pc.PreferenceComparisons, "train",
                            lambda self, total_timesteps, total_comparisons, **kw: train(
                                self, min(total_timesteps, 4000), min(total_comparisons, 40), **kw))


@pytest.mark.parametrize("module,kwargs,expect", MAINS, ids=[m.rsplit(".", 1)[-1] for m, _, _ in MAINS])
def test_main_runs_on_the_cpu(module, kwargs, expect, capsys, monkeypatch):
    mod = importlib.import_module(PORT + module)
    if module in ("quickstart", "rlhf_preference_comparisons"):
        _cut(monkeypatch, mod)
    out_value = mod.main(device="cpu", **kwargs)
    out = capsys.readouterr().out
    assert expect in out
    if module == "quickstart":
        assert "BC return" in out and "GAIL return" in out
    if module.endswith("t01_train_bc"):
        before, after = out_value
        assert after > before  # BC on the scripted expert's demos learns
    if module.endswith(("t05_preference_comparisons",)):
        assert np.isfinite(out_value["reward_loss"])


def test_mains_default_to_cuda():
    """Without ``device`` an entry point asks for CUDA, and with no CUDA it
    raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(PORT + "tutorials.t06_train_mce")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main()


# -- tutorial 10's GoalGrid ------------------------------------------------------


def test_goal_grid_step_equals_jax():
    rng = np.random.default_rng(0)
    pos = np.concatenate([rng.uniform(-1, 1, (60, 2)), [[1, 1], [-1, -1], [0.95, 1.0], [-0.95, -1]]]).astype(np.float32)
    acts = np.concatenate([rng.integers(0, 4, 60), [0, 1, 2, 3]]).astype(np.int32)
    jenv = jax_t10.GoalGrid()
    jstate, jts = jax.vmap(lambda p, a: jenv.step(jax_t10.GridState(pos=p), a, jax.random.key(0)))(
        jnp.asarray(pos), jnp.asarray(acts))
    env = t10_train_custom_env.GoalGrid()
    state, ts = env.step(torch.from_numpy(pos), torch.from_numpy(acts))
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate.pos))
    np.testing.assert_array_equal(ts.obs.numpy(), np.asarray(jts.obs))
    np.testing.assert_array_equal(ts.reward.numpy(), np.asarray(jts.reward))
    assert ts.reward.dtype == torch.float32
    assert not ts.terminated.any() and not ts.truncated.any()
    assert env.max_episode_steps == jenv.max_episode_steps == 40
    assert env.action_space.n == jenv.action_space.n
    assert env.observation_space.shape == jenv.observation_space.shape


def test_goal_grid_reset_in_the_jax_range():
    n = 4096
    obs, state = t10_train_custom_env.GoalGrid().reset(n, torch.Generator().manual_seed(0))
    jobs, _ = jax.vmap(jax_t10.GoalGrid().reset)(jax.random.split(jax.random.key(0), n))
    for x in (obs.numpy(), np.asarray(jobs)):
        assert x.shape == (n, 2) and x.dtype == np.float32
        assert x.min() >= -1.0 and x.max() < 0.0
        assert abs(x.mean() + 0.5) < 0.02
    assert torch.equal(obs, state)


def test_goal_grid_registers_once():
    from imitation_tpu_torch.envs import registry

    t10_train_custom_env.main(ppo_iters=1, device="cpu")  # registers, or finds it registered
    assert "GoalGrid-v0" in registry.registered_envs()
    with pytest.raises(ValueError, match="already registered"):
        registry.register("GoalGrid-v0", t10_train_custom_env.GoalGrid)


# -- the statistics of tutorial 9 --------------------------------------------------


SCORES = [
    (np.random.default_rng(0).normal(100, 20, 7), np.random.default_rng(1).normal(80, 30, 5)),
    (np.array([1.0, 2.0, 2.0, 3.0]), np.array([2.0, 2.0, 5.0])),
    (np.array([5.0]), np.array([5.0])),
    (np.random.default_rng(2).integers(0, 4, 10).astype(float), np.random.default_rng(3).integers(0, 4, 10)),
]


@pytest.mark.parametrize("x,y", SCORES, ids=["normal", "ties", "one", "integers"])
def test_statistics_equal_jax(x, y):
    assert summarize.iqm(x) == jax_summarize.iqm(x)
    assert summarize.iqm(y) == jax_summarize.iqm(y)
    assert summarize.bootstrap_ci(x) == jax_summarize.bootstrap_ci(x)
    assert summarize.bootstrap_ci(x, n_resamples=300, alpha=0.1, seed=5) == \
        jax_summarize.bootstrap_ci(x, n_resamples=300, alpha=0.1, seed=5)
    assert summarize.probability_of_improvement(x, y) == jax_summarize.probability_of_improvement(x, y)
    assert summarize.probability_of_improvement(y, x) == jax_summarize.probability_of_improvement(y, x)


# -- tutorial 6 ----------------------------------------------------------------------


def test_t06_occupancies_match_jax(capsys):
    assert jax_t06.main() <= 1e-2
    jax_out = capsys.readouterr().out
    assert t06_train_mce.main(device="cpu") <= 1e-2
    out = capsys.readouterr().out
    expert = [line for line in out.splitlines() if line.startswith("expert state occupancy")]
    assert expert == [line for line in jax_out.splitlines() if line.startswith("expert state occupancy")]

    jenv, env = jax_random_mdp(6, 3, horizon=8, seed=0), random_mdp(6, 3, horizon=8, seed=0)
    _, _, jpi = jax_mce.mce_partition_fh(jenv)
    _, jD = jax_mce.mce_occupancy_measures(jenv, pi=jpi)
    _, _, pi = mce_irl.mce_partition_fh(env, device="cpu")
    _, D = mce_irl.mce_occupancy_measures(env, pi=pi, device="cpu")
    np.testing.assert_allclose(D.numpy(), np.asarray(jD), rtol=1e-5, atol=1e-5)

    # 100 iterations of the tutorial's MCE IRL from the JAX weights, both
    # thresholds out of reach, then the tutorial's learned occupancy.
    demo = np.asarray(jD, np.float64)
    kw = dict(log_interval=None, optimizer_kwargs=dict(lr=0.05), linf_eps=0.0, grad_l2_eps=0.0)
    jirl = jax_mce.MCEIRL(demo, jenv, **kw)
    init = host(jirl.variables)
    jirl.train(max_iter=100)
    irl = mce_irl.MCEIRL(demo, env, device="cpu", **kw)
    irl.reward_net.load_state_dict(convert.tabular_reward_net_state_dict(init))
    irl.train(max_iter=100)
    jr = jirl.reward_net.apply(jirl.variables, jnp.asarray(jenv.observation_matrix))
    _, _, jpi_l = jax_mce.mce_partition_fh(jenv, reward=jnp.asarray(jr))
    _, jD_l = jax_mce.mce_occupancy_measures(jenv, pi=jpi_l)
    with torch.no_grad():
        r = irl.reward_net(env.tensors("cpu")["obs"])
    _, _, pi_l = mce_irl.mce_partition_fh(env, reward=r, device="cpu")
    _, D_l = mce_irl.mce_occupancy_measures(env, pi=pi_l, device="cpu")
    np.testing.assert_allclose(D_l.numpy(), np.asarray(jD_l), atol=1e-4)
