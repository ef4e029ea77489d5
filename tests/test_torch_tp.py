"""Tensor parallelism (``tp``) in imitation_tpu_torch.parallel: the placement of
every net of the tp path against imitation_tpu/parallel/mesh.py's
``shard_params_tp``, and training over ``dp=2 x tp=2`` gloo ranks on the CPU.

In one process: the split parameters and each tp rank's blocks of them equal
the JAX package's placement on ``make_mesh(dp=4, tp=2)`` over the conftest's
8 virtual CPU devices, for the gail_cartpole actor-critic and discriminator,
SAC's actor and critic, ``BasicRewardNet``, ``BasicShapedRewardNet``, a
``RewardEnsemble`` and a ``CnnRewardNet`` (whose conv biases split and
kernels do not); Adam's moments split with their parameters.

One launch of 4 ranks (``tests/torch_dist_worker.py`` with ``TP=2``; rank
``r`` at dp index ``r // 2`` and tp index ``r % 2``), while the JAX
package's sharded GAIL runs on ``make_mesh(dp=2, tp=2)``:

* the column-split layer (an MLP whose layers are all split): output and
  input, weight and bias gradients against one process, within float32
  rounding; the tp-aware clip of ``Adam`` against optax's
  ``clip_by_global_norm`` on the whole gradient, clipping and not;
* each net above split, against its own unsplit outputs;
* GAIL ``train_fused`` over 2 rounds with the JAX package's draws fed in,
  against one process and against the JAX package's
  ``shard_adversarial_trainer`` on ``make_mesh(dp=2, tp=2)``;
* SAC with the split ring, ``BasicRewardTrainer`` and ``EnsembleTrainer``
  against one process;
* a PPO checkpoint saved at ``dp=2 x tp=2`` and resumed here at ``tp = 1``;
  the ported tutorial 11 (sharded rounds, then a resume in one process).

Tolerances as in tests/test_torch_distributed.py: parameters within
``param_tolerance`` of the largest update of the run held against (floors
from ``update_floors`` of the port's one-process run), a reward net's output
bias apart; the four ranks' gathered parameters bitwise equal.
"""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imitation_tpu.envs.base import Space as JaxSpace
from imitation_tpu.models.policies import ActorCriticPolicy as JaxPolicy
from imitation_tpu.parallel import mesh as jax_mesh
from imitation_tpu.rewards import reward_nets as jax_nets
from imitation_tpu.rl.sac import SACActor as JaxActor
from imitation_tpu.rl.sac import SACCritic as JaxCritic
from imitation_tpu_torch import convert
from imitation_tpu_torch.envs.base import Space
from imitation_tpu_torch.models.policies import ActorCriticPolicy
from imitation_tpu_torch.parallel import mesh as mesh_mod
from imitation_tpu_torch.parallel.mesh import Mesh
from imitation_tpu_torch.rewards import reward_nets
from imitation_tpu_torch.rl import common as rl_common
from imitation_tpu_torch.rl.sac import SACActor, SACCritic
from imitation_tpu_torch.util.checkpoint import restore_state
from tests import torch_dist_worker as worker
from tests.test_torch_distributed import _assert_close, _equal_ranks, _jax_gail, _ppo_one_process
from tests.torch_parity import host, param_tolerance, spaces, update_floors

torch.set_num_threads(1)

TP_CASES = "tp_layer,tp_nets,gail_fixed,sac,reward_basic,reward_ensemble,ppo,tutorial"
NETS = ("policy", "disc", "sac_actor", "sac_critic", "basic", "shaped", "ensemble", "cnn")
OUTPUTS = {"policy": ("policy_logits", "policy_value"), "disc": ("disc",), "sac_actor": ("sac_mean", "sac_log_std"),
           "sac_critic": ("sac_q",), "basic": ("basic",), "shaped": ("shaped",), "ensemble": ("ensemble",),
           "cnn": ("cnn",)}


# -- the placement against the JAX package's ----------------------------------------


def _jax_and_port(name):
    """(JAX variables, port module holding the same weights, key prefix)."""
    key = jax.random.key(NETS.index(name))
    if name in ("policy", "disc"):
        jo, ja, to, ta = spaces("discrete")
    else:
        jo, ja, to, ta = spaces("box")
    obs = jnp.zeros((2, 3))
    if name == "policy":
        jvars, net = JaxPolicy(jo, ja, hid_sizes=(32, 32)).init(key), ActorCriticPolicy(to, ta, hid_sizes=(32, 32))
        return host(jvars), net, "net."
    if name == "sac_actor":
        return host(JaxActor(2, (32, 32)).init(key, obs)), SACActor(3, 2, (32, 32)), ""
    if name == "sac_critic":
        return host(JaxCritic((32, 32)).init(key, obs, jnp.zeros((2, 2)))), SACCritic(3, 2, (32, 32)), ""
    jnet, net = {
        "disc": lambda: (jax_nets.BasicRewardNet(observation_space=jo, action_space=ja, normalize_input=False),
                         reward_nets.BasicRewardNet(to, ta, normalize_input=False)),
        "basic": lambda: (jax_nets.BasicRewardNet(observation_space=jo, action_space=ja, normalize_input=True),
                          reward_nets.BasicRewardNet(to, ta, normalize_input=True)),
        "shaped": lambda: (jax_nets.BasicShapedRewardNet(observation_space=jo, action_space=ja),
                           reward_nets.BasicShapedRewardNet(to, ta)),
        "ensemble": lambda: (jax_nets.RewardEnsemble(observation_space=jo, action_space=ja,
                                                     member_cls=jax_nets.BasicRewardNet, num_members=3),
                             reward_nets.RewardEnsemble(to, ta, num_members=3)),
        "cnn": lambda: (jax_nets.CnnRewardNet(observation_space=JaxSpace.box(0.0, 1.0, (12, 12, 3)),
                                              action_space=JaxSpace.discrete(4), hid_channels=(4, 6)),
                        reward_nets.CnnRewardNet(Space.box(0.0, 1.0, (12, 12, 3)), Space.discrete(4),
                                                 hid_channels=(4, 6))),
    }[name]()
    return host(jnet.init_variables(key)), net, ""


@pytest.mark.parametrize("name", NETS)
def test_placement_matches_jax_shard_params_tp(name):
    """The port's split parameters are the JAX placement's tp-sharded leaves,
    and each tp rank's blocks (and whole leaves) are the JAX shards on its
    devices."""
    jvars, net, prefix = _jax_and_port(name)
    net.load_state_dict(convert.flax_to_state_dict(jvars, prefix))
    m = jax_mesh.make_mesh(dp=4, tp=2)
    placed = jax_mesh.shard_params_tp(jvars, m)
    specs = convert.flax_to_state_dict(jax.tree.map(lambda x: np.full(x.shape, "tp" in x.sharding.spec), placed),
                                       prefix)
    jax_split = sorted(k for k, v in specs.items() if v.all())
    assert (len(jax_split) > 0) == (name != "ensemble")  # ensemble kernels are [M, in, out]: whole
    for tp_rank in range(2):
        device = m.devices[0, tp_rank]
        shard = jax.tree.map(lambda x: next(np.asarray(s.data) for s in x.addressable_shards if s.device == device),
                             placed)
        want = convert.flax_to_state_dict(shard, prefix)
        port = copy.deepcopy(net)
        mesh_mod.shard_params_tp([port], Mesh(dp=4, tp=2, tp_rank=tp_rank))
        assert sorted(k for k, p in port.named_parameters() if mesh_mod.is_tp_split(p)) == jax_split
        got = port.state_dict()
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_adam_moments_split_with_their_parameters():
    """After a step, ``shard_params_tp`` of (module, optimizer) keeps each
    split parameter's block of its moments; ``tp_split_params`` names them."""
    net = reward_nets.BasicRewardNet(*spaces("box")[2:], normalize_input=False)
    opt = rl_common.Adam(net.parameters(), 1e-3)
    x = torch.ones(4, 3), torch.ones(4, 2), torch.ones(4, 3), torch.zeros(4)
    net(*x).sum().backward()
    opt.step()
    split = mesh_mod.tp_split_params(net, 2)
    assert sorted(split) == ["mlp.dense0.bias", "mlp.dense0.weight", "mlp.dense1.bias", "mlp.dense1.weight"]
    whole = {n: {k: v.clone() for k, v in opt.state[p].items()} for n, p in net.named_parameters()}
    mesh_mod.shard_params_tp([net, opt], Mesh(dp=1, tp=2, tp_rank=1))
    for n, p in net.named_parameters():
        for k in ("mu", "nu"):
            want = whole[n][k][whole[n][k].shape[0] // 2:] if n in split else whole[n][k]
            np.testing.assert_array_equal(opt.state[p][k].numpy(), want.numpy(), err_msg=f"{n}.{k}")
    mesh_mod.shard_params_tp([net, opt], Mesh(dp=1, tp=2, tp_rank=1))  # placed already: unchanged
    assert net.mlp.dense0.weight.shape == (16, 5)


def test_tp_params_false_replicates():
    """The ``tp_params`` switch of the placements, as the JAX package's:
    replication at tp > 1 leaves every parameter whole."""
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.rl.ppo import PPO, PPOConfig

    venv = make_vec_env("CartPole-v1", num_envs=4, device="cpu")
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(8,))
    ppo = PPO(venv, policy, PPOConfig(n_steps=4, n_minibatches=2), seed=0)
    m = Mesh(dp=1, tp=2, tp_rank=1)
    state = mesh_mod.shard_rl_state(ppo.init_state(), m, tp_params=False)
    assert state.mesh is m and not any(mesh_mod.is_tp_split(p) for p in policy.parameters())
    mesh_mod.shard_rl_state(state.replace(mesh=None), m)
    assert sorted(n for n, p in policy.named_parameters() if mesh_mod.is_tp_split(p)) == [
        "net.pi0.bias", "net.pi0.weight", "net.pi_out.bias", "net.pi_out.weight", "net.vf0.bias", "net.vf0.weight"]


# -- the launch ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    """The dp=2 x tp=2 launch, with the JAX package's sharded GAIL on
    make_mesh(dp=2, tp=2) computed meanwhile."""
    out = tmp_path_factory.mktemp("tp_ranks")
    inputs, run_jax = _jax_gail(tmp_path_factory.mktemp("jax_logs"), tp=2)
    torch.save({"gail": inputs}, out / "inputs.pt")
    failure = []

    def ranks():
        try:
            worker.launch(str(out), 4, TP_CASES, tp=2)
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


def test_column_split_layer_against_one_process(tp_ranks):
    out, _, _ = tp_ranks
    ranks = worker.load(str(out), "tp_layer", 4)
    _equal_ranks(ranks, "params", "grads")
    one = worker.tp_layer_case(None)
    got = ranks[0]
    assert len(got["split"]) == 6  # every weight and bias of the three layers
    np.testing.assert_allclose(got["y"], one["y"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["x_grad"], one["x_grad"], rtol=1e-5, atol=1e-6)
    for k, v in one["grads"].items():
        np.testing.assert_allclose(got["grads"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("max_norm", [0.05, 1e6], ids=["clipping", "not_clipping"])
def test_tp_clip_matches_optax_on_the_whole_gradient(tp_ranks, max_norm):
    out, _, _ = tp_ranks
    ranks = worker.load(str(out), "tp_layer", 4)
    got = [r[f"clip_{max_norm:g}"] for r in ranks]
    _equal_ranks(got, "params")
    one = worker.tp_layer_case(None)
    init = worker.params(worker.tp_mlp())
    grads = {k: jnp.asarray(v) for k, v in one["grads"].items()}
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(1e-2))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    updates, _ = tx.update(grads, tx.init(params), params)
    norm = float(optax.global_norm(grads))
    assert (norm > max_norm) == (max_norm < 1)
    np.testing.assert_allclose(got[0]["norm"], norm, rtol=1e-6)
    for k in init:
        np.testing.assert_allclose(got[0]["params"][k], np.asarray(optax.apply_updates(params, updates)[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", NETS)
def test_split_nets_give_the_unsplit_outputs(tp_ranks, name):
    out, _, _ = tp_ranks
    ranks = worker.load(str(out), "tp_nets", 4)
    placed = copy.deepcopy(worker.tp_nets(torch.Generator().manual_seed(6))[name])
    mesh_mod.shard_params_tp([placed], Mesh(dp=2, tp=2, tp_rank=1))
    want_split = sorted(k for k, p in placed.named_parameters() if mesh_mod.is_tp_split(p))
    for r in ranks:
        assert r["split"][name] == want_split
        for k in OUTPUTS[name]:
            np.testing.assert_allclose(r["split_outputs"][k], r["whole"][k], rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(r["split_outputs"][k], ranks[0]["split_outputs"][k])


def test_gail_train_fused_dp2_tp2_against_one_process_and_jax(tp_ranks):
    out, inputs, jres = tp_ranks
    ranks = worker.load(str(out), "gail_fixed", 4)
    _equal_ranks(ranks, "policy", "disc")
    got = ranks[0]
    T, B, rounds = inputs["T"], inputs["B"], inputs["rounds"]
    assert got["timesteps"] == jres["timesteps"] == rounds * T * B
    assert got["disc_step"] == jres["disc_step"] == 2 * rounds and got["ring_size"] == T * B

    def port(rel):
        res = worker.gail_fixed_case(None, inputs, rel)
        return {k: (res["init"][k], res[k]) for k in ("policy", "disc")}

    one = worker.gail_fixed_case(None, inputs)
    floors = update_floors(port)
    for key in ("policy", "disc"):
        tol = param_tolerance(floors[key])
        _assert_close(got[key], jres[key], jres["init"][key], tol)
        _assert_close(got[key], one[key], one["init"][key], tol)


def test_sac_dp2_tp2_against_one_process(tp_ranks):
    out, _, _ = tp_ranks
    ranks = worker.load(str(out), "sac", 4)
    _equal_ranks(ranks, "actor", "critic")
    one = worker.sac_case(None)
    assert all(r["local_rows"] == 16 for r in ranks) and ranks[0]["timesteps"] == one["timesteps"]
    for key in ("actor", "critic"):
        scale = max(np.abs(v).max() for v in one[key].values())
        err = max(np.abs(ranks[0][key][k] - v).max() for k, v in one[key].items())
        assert err <= 1e-5 * scale, (key, err, scale)
    np.testing.assert_allclose(ranks[0]["log_alpha"], one["log_alpha"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["basic", "ensemble"])
def test_reward_trainer_dp2_tp2_against_one_process(tp_ranks, kind):
    out, _, _ = tp_ranks
    ranks = worker.load(str(out), f"reward_{kind}", 4)
    _equal_ranks(ranks, "params")
    one = worker.reward_case(None, kind)
    bias = [k for k in one["params"] if k.endswith("dense_out.bias")]

    def run(rel):
        res = worker.reward_case(None, kind, rel)
        return {"net": tuple({k: v for k, v in res[part].items() if k not in bias} for part in ("init", "params"))}

    _assert_close(ranks[0]["params"], one["params"], one["init"], param_tolerance(update_floors(run)["net"]),
                  skip=bias)
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_checkpoint_saved_at_dp2_tp2_resumes_at_tp1(tp_ranks):
    out, _, _ = tp_ranks
    ranks = worker.load(str(out), "ppo", 4)
    _equal_ranks([r["plain"] for r in ranks], "params")
    ppo = worker.build_ppo()
    state = restore_state(str(out / "ppo.ckpt"), ppo.init_state())
    assert state.mesh is None and state.timesteps == 2 * worker.PPO_T * worker.PPO_B
    assert not any(mesh_mod.is_tp_split(p) for p in ppo.policy.parameters())
    for k, v in worker.params(ppo.policy).items():  # the gathered columns, whole
        np.testing.assert_array_equal(v, ranks[0]["plain"]["params"][k], err_msg=k)
    for p in ppo.policy.parameters():  # the moments came back whole too
        assert state.optimizer.state[p]["mu"].shape == p.shape
    init = worker.params(ppo.policy)
    state, _ = ppo.process_chunk(state, state.env_state, worker.ppo_chunk(ppo.policy, 3), state.generator)
    _, floor = _ppo_one_process("plain")
    _assert_close(ranks[0]["resumed"]["params"], worker.params(ppo.policy), init, param_tolerance(floor))


def test_tutorial_11_dp2_tp2_then_resumes_in_one_process(tp_ranks):
    out, _, _ = tp_ranks
    ranks = worker.load(str(out), "tutorial", 4)
    _equal_ranks(ranks, "policy")
    assert all(r["n_updates"] == 4 and r["timesteps"] == 4 * 16 * 8 for r in ranks)
    assert ranks[0]["resumed_n_updates"] == 6 and ranks[0]["resumed_timesteps"] == 6 * 16 * 8
    assert all("resumed_n_updates" not in r for r in ranks[1:])
