"""Tutorial 5a's pixel CartPole in imitation_tpu_torch against the JAX
tutorial (``examples/tutorials/t05a_preference_comparisons_cnn.py``): its
render and its steps exactly, a GAIL round on its frames with a
``CnnRewardNet`` discriminator, and the ported tutorial's ``main``.

The render of the same CartPole states must equal JAX's exactly, the
frame's edge clips and the truncation toward zero of negative angles
included. A step from the same states gives the same frames exactly except
where a coordinate of the new state lies within float noise (1e-4 of a
pixel) of a pixel boundary: XLA and PyTorch evaluate CartPole's cos and sin
a few ulp apart. The GAIL round (8 envs x 16 steps, ``hid_channels=(4, 4)``)
starts from the JAX trainer's weights with its PPO epoch permutations and
disc-step indices fed in (``tests/torch_parity.py``); each parameter tensor
is held within 1e-5 of the largest update, raised where needed to 4x the
case's own float32 floor: the larger of ``update_floors``' and the tensor's
spread between two summation orders of the port's convolutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imitation_tpu.data.rollout as jax_rollout
import imitation_tpu_torch.algorithms.adversarial.common as torch_common
import imitation_tpu_torch.rl.ppo as torch_ppo_mod
from examples.tutorials import t05a_preference_comparisons_cnn as jax_tutorial
from imitation_tpu.algorithms.adversarial.gail import GAIL as JaxGAIL
from imitation_tpu.data.rollout import RolloutChunk as JaxChunk
from imitation_tpu.data.types import TransitionBatch as JaxBatch
from imitation_tpu.envs.classic import ArrayState
from imitation_tpu.envs.vector import VectorEnv as JaxVectorEnv
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.rewards.reward_nets import CnnRewardNet as JaxCnnRewardNet
from imitation_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from imitation_tpu.util.logger import configure as jax_configure
from imitation_tpu_torch import convert
from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
from imitation_tpu_torch.data.rollout import RolloutChunk
from imitation_tpu_torch.data.types import TransitionBatch
from imitation_tpu_torch.envs.vector import VectorEnv
from imitation_tpu_torch.examples.tutorials import t05a_preference_comparisons_cnn as tutorial
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.rewards.reward_nets import CnnRewardNet
from imitation_tpu_torch.rl.ppo import PPOConfig
from imitation_tpu_torch.util.logger import configure
from tests.torch_parity import (
    feed, flat_params, host, jax_disc_indices, jax_epoch_perms, nudge_, param_tolerance, snapshot,
    update_floors,
)

torch.set_num_threads(1)

SIZE = tutorial.SIZE


def _states(n, seed):
    """CartPole states over and past the track and the angle limits, with
    exact pixel boundaries and negative angles among them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.5, 3.5, (n, 4)).astype(np.float32)
    x[:, 2] = rng.uniform(-0.6, 0.6, n).astype(np.float32)
    x[: n // 8, 0] = np.float32(2.4) * (2 * rng.integers(0, 16, n // 8) / 15 - 1)  # column edges
    x[: n // 8, 2] = np.float32(0.21) * rng.integers(-8, 9, n // 8) / 8  # offset edges
    x[-4:, [0, 2]] = [[0.0, -0.0262], [-2.4, 0.21], [2.4, -0.21], [100.0, -5.0]]
    return x


def _jax_render(states):
    env = jax_tutorial.PixelCartPole()
    return np.array(jax.vmap(env._render)(jnp.asarray(states)))


def test_render_equals_jax_exactly():
    states = _states(4096, seed=0)
    got = tutorial.PixelCartPole.render(torch.from_numpy(states)).numpy()
    want = _jax_render(states)
    assert got.shape == want.shape == (4096, SIZE, SIZE, 1) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # Every frame has the cart on the bottom row and 1 to 8 pole pixels.
    assert (got[:, SIZE - 1].sum(axis=(1, 2)) == 1).all()
    assert ((got[:, SIZE - 9:SIZE - 1].sum(axis=(1, 2, 3)) >= 1)).all()


def test_spaces_and_reset():
    env, jenv = tutorial.PixelCartPole(), jax_tutorial.PixelCartPole()
    for a, b in ((env.observation_space, jenv.observation_space), (env.action_space, jenv.action_space)):
        assert a.shape == b.shape and a.n == b.n
        np.testing.assert_array_equal(a.low, b.low)
    assert env.max_episode_steps == jenv.max_episode_steps == 200
    assert env.name == jenv.name == "PixelCartPole"
    obs, state = env.reset(16, torch.Generator().manual_seed(0))
    assert state.shape == (16, 4) and bool((state.abs() <= 0.05).all())
    np.testing.assert_array_equal(obs.numpy(), _jax_render(state.numpy()))


def _clear(states):
    """Rows whose pixel coordinates lie away from every pixel boundary."""
    col = ((states[:, 0] / 2.4) * 0.5 + 0.5) * (SIZE - 1)
    offs = (states[:, 2] / 0.21)[:, None] * np.arange(1, 9)
    near = lambda v: np.abs(v - np.round(v)) < 1e-4
    return ~near(col) & ~near(offs).any(axis=1)


def test_step_equals_jax():
    states = _states(1024, seed=1)
    states[:, 0] = np.clip(states[:, 0], -2.3, 2.3)
    states[:, 2] = np.clip(states[:, 2], -0.2, 0.2)
    acts = np.random.default_rng(2).integers(0, 2, 1024).astype(np.int32)
    jenv = jax_tutorial.PixelCartPole()
    keys = jax.random.split(jax.random.key(0), 1024)
    jstate, jts = jax.vmap(jenv.step)(ArrayState(x=jnp.asarray(states)), jnp.asarray(acts), keys)
    state, ts = tutorial.PixelCartPole().step(torch.from_numpy(states), torch.from_numpy(acts))
    clear = _clear(np.asarray(jstate.x))
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(ts.obs.numpy()[clear], np.asarray(jts.obs)[clear])
    np.testing.assert_array_equal(ts.reward.numpy(), np.asarray(jts.reward))
    np.testing.assert_array_equal(ts.terminated.numpy()[clear], np.asarray(jts.terminated)[clear])
    np.testing.assert_array_equal(ts.obs.numpy(), tutorial.PixelCartPole.render(state).numpy())


def test_vector_env_steps_and_autoresets():
    venv = VectorEnv(tutorial.PixelCartPole(), num_envs=32, max_episode_steps=20, device="cpu")
    vstate = venv.reset(torch.Generator().manual_seed(0))
    dones = 0
    for _ in range(40):
        vstate, out = venv.step(vstate, torch.ones(32, dtype=torch.int32))
        dones += int(out.done.sum())
        np.testing.assert_array_equal(vstate.obs.numpy(), tutorial.PixelCartPole.render(vstate.env_state).numpy())
        assert out.obs.dtype == torch.float32 and out.obs.shape == (32, SIZE, SIZE, 1)
    assert dones >= 32  # pushing right always topples the pole within 20 steps


# -- one GAIL round on pixel CartPole ------------------------------------------


def _pixel_arrays(n, seed, lead=()):
    rng = np.random.default_rng(seed)
    shape = lead + (n,)
    return dict(
        obs=_jax_render(_states(int(np.prod(shape)), seed)).reshape(shape + (SIZE, SIZE, 1)),
        acts=rng.integers(0, 2, shape).astype(np.int32),
        next_obs=_jax_render(_states(int(np.prod(shape)), seed + 100)).reshape(shape + (SIZE, SIZE, 1)),
    )


def _pixel_transitions(n, seed):
    rng = np.random.default_rng(seed + 1)
    arrays = dict(_pixel_arrays(n, seed), dones=(rng.random(n) < 0.1).astype(np.float32),
                  rews=np.zeros(n, np.float32))
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            TransitionBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))


def _pixel_chunk(T, B, seed):
    rng = np.random.default_rng(seed)
    arrays = _pixel_arrays(B, seed, lead=(T,))
    terminated = rng.random((T, B)) < 0.05
    arrays.update(
        rews=np.ones((T, B), np.float32),
        terminated=terminated,
        truncated=(rng.random((T, B)) < 0.05) & ~terminated,
        episode_return=rng.integers(1, 50, (T, B)).astype(np.float32),
        episode_length=rng.integers(1, 50, (T, B)).astype(np.int32),
    )
    aux = dict(log_prob=(np.log(0.5) + rng.normal(scale=0.05, size=(T, B))).astype(np.float32),
               value=rng.normal(size=(T, B)).astype(np.float32))
    return (JaxChunk(aux={k: jnp.asarray(v) for k, v in aux.items()},
                     **{k: jnp.asarray(v) for k, v in arrays.items()}),
            RolloutChunk(aux={k: torch.from_numpy(v) for k, v in aux.items()},
                         **{k: torch.from_numpy(v) for k, v in arrays.items()}))


def test_gail_pixel_round_matches_jax(tmp_path, monkeypatch):
    T, Bv, n_demo, B = 16, 8, 200, 64
    jdemo, tdemo = _pixel_transitions(n_demo, seed=1)
    jchunk, tchunk = _pixel_chunk(T, Bv, seed=3)
    ppo_kw = dict(n_steps=T, n_minibatches=4, n_epochs=2, learning_rate=1e-3)
    common = dict(demo_batch_size=B, n_disc_updates_per_round=2, allow_variable_horizon=True, seed=0)
    jvenv = JaxVectorEnv(jax_tutorial.PixelCartPole(), num_envs=Bv, max_episode_steps=100)
    jo, ja = jvenv.observation_space, jvenv.action_space
    jtr = JaxGAIL(demonstrations=jdemo, venv=jvenv, gen_config=JaxPPOConfig(**ppo_kw),
                  reward_net=JaxCnnRewardNet(observation_space=jo, action_space=ja, hid_channels=(4, 4)),
                  policy=JaxPolicy(jo, ja, hid_sizes=(64, 64)),
                  custom_logger=jax_configure(str(tmp_path), format_strs=[]), **common)
    jreward = host(jtr.disc_state.variables)
    jtr.gen_state = jtr.gen_algo.init_state()
    jgen0, jdisc0 = jtr.gen_state.variables["params"], jtr.disc_state.variables["params"]
    disc_key = jtr.disc_state.key
    _, _, k_proc = jax.random.split(jtr.gen_state.key, 3)  # ppo.py train_step
    monkeypatch.setattr(jax_rollout, "collect", lambda venv, fn, params, state, n, key: (state, jchunk))
    jtr.train(T * Bv)
    monkeypatch.setattr(torch_ppo_mod.rollout_mod, "collect",
                        lambda venv, fn, state, n, generator: (state, tchunk))

    def port(rel):
        venv = VectorEnv(tutorial.PixelCartPole(), num_envs=Bv, max_episode_steps=100, device="cpu")
        o, a = venv.observation_space, venv.action_space
        tr = GAIL(demonstrations=tdemo, venv=venv, gen_config=PPOConfig(**ppo_kw),
                  reward_net=CnnRewardNet(o, a, hid_channels=(4, 4)),
                  policy=ActorCriticPolicy(o, a, hid_sizes=(64, 64)),
                  custom_logger=configure(format_strs=()), **common)
        tr.reward_net.load_state_dict(convert.reward_net_state_dict(jreward))
        tr.gen_state = tr.gen_algo.init_state()
        tr.policy.load_state_dict(convert.policy_state_dict(host({"params": jgen0})))
        nudge_([tr.policy, tr.reward_net], rel)
        perms = feed(jax_epoch_perms(k_proc, 2, T * Bv))
        indices = feed(jax_disc_indices(disc_key, 2, B, n_demo, T * Bv))
        monkeypatch.setattr(torch_ppo_mod, "_epoch_permutation", perms)
        monkeypatch.setattr(torch_common, "_disc_indices", indices)
        init = {"policy": snapshot(tr.policy), "disc": snapshot(tr.reward_net)}
        tr.train(T * Bv)
        assert perms.remaining == [] and indices.remaining == []
        assert tr._gen_buffer_state.size == T * Bv and tr.disc_state.step == 2
        assert tr._gen_buffer_state.data.obs.shape == (T * Bv, SIZE, SIZE, 1)
        return tr, init

    tr, _ = port(0.0)

    def port_updates(rel):
        nudged, init = port(rel)
        return {"policy": (init["policy"], snapshot(nudged.policy)),
                "disc": (init["disc"], snapshot(nudged.reward_net))}

    floors = update_floors(port_updates)
    # A second float32 floor, per tensor: the same round with the port's
    # convolutions summed in another order (PyTorch's own conv without
    # oneDNN). The conv biases' gradients sum expert and generator rows that
    # nearly cancel, so their Adam steps are mostly rounding noise, which
    # the uniform nudges of update_floors do not stir.
    with torch.backends.mkldnn.flags(enabled=False):
        other, init = port(0.0)
    for label, module, jparams, jinit, prefix in (
            ("policy", "policy", jtr.gen_state.variables["params"], jgen0, "net."),
            ("disc", "reward_net", jtr.disc_state.variables["params"], jdisc0, "")):
        a, b = snapshot(getattr(tr, module)), snapshot(getattr(other, module))
        want, start = flat_params(jparams, prefix), flat_params(jinit, prefix)
        assert sorted(a) == sorted(want)
        scale = max(np.abs(want[k] - start[k]).max() for k in want)
        for k in want:
            order = np.abs(a[k] - b[k]).max() / scale
            tol = param_tolerance(max(floors[label], order))
            err = np.abs(a[k] - want[k]).max() / scale
            assert err <= tol, f"{label} {k}: error {err:.3g} of the largest update (limit {tol:.3g})"


def test_tutorial_main_runs(capsys):
    """The ported tutorial at the JAX tutorial test's budget
    (tests/test_examples.py: 2,000 timesteps, 30 comparisons)."""
    result = tutorial.main(total_timesteps=2000, total_comparisons=30, device="cpu")
    assert np.isfinite(result["reward_loss"]) and 0.0 <= result["reward_accuracy"] <= 1.0
    assert "CNN reward loss" in capsys.readouterr().out


def test_tutorial_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tutorial.build()
