"""The port's CLI config layer against the JAX package's.

Every experiment's default config and every named config (the tuned ones
and ``fast`` included) builds to the same dict in both packages, but for
the port's ``device`` key; the command-line grammar gives the same command
and config and raises the same errors; the tuned JSON files are byte copies;
and each script hands its learners the same hyper-parameters. For the last,
the trainer and learner classes of both packages' script modules are
replaced, in the test only, by recorders that stop before training.
"""

import dataclasses
import io
import json
import pathlib
import types
from contextlib import redirect_stdout

import pytest
import torch

from imitation_tpu.scripts import (
    eval_policy as jax_eval_policy,
    train_adversarial as jax_train_adversarial,
    train_imitation as jax_train_imitation,
    train_preference_comparisons as jax_train_preference_comparisons,
    train_rl as jax_train_rl,
)
from imitation_tpu_torch.scripts import (
    eval_policy,
    train_adversarial,
    train_imitation,
    train_preference_comparisons,
    train_rl,
)

torch.set_num_threads(1)

PAIRS = {
    "train_rl": (jax_train_rl, train_rl),
    "train_imitation": (jax_train_imitation, train_imitation),
    "train_adversarial": (jax_train_adversarial, train_adversarial),
    "train_preference_comparisons": (jax_train_preference_comparisons, train_preference_comparisons),
    "eval_policy": (jax_eval_policy, eval_policy),
}
NAMED = [(script, name) for script, (jax_mod, _) in PAIRS.items()
         for name in [None] + sorted(jax_mod.ex.named_configs)]

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_TUNED = REPO / "imitation_tpu" / "scripts" / "config_files" / "tuned_hps"
PORT_TUNED = REPO / "imitation_tpu_torch" / "scripts" / "config_files" / "tuned_hps"


def without_device(config):
    config = dict(config)
    assert config.pop("device") is None
    return config


# -- (a) config parity ---------------------------------------------------------


def test_named_config_sets_are_equal():
    for script, (jax_mod, mod) in PAIRS.items():
        assert sorted(mod.ex.named_configs) == sorted(jax_mod.ex.named_configs), script
        assert sorted(mod.ex.commands) == sorted(jax_mod.ex.commands), script
    assert sum(name is not None and name in {p.stem for p in JAX_TUNED.glob("*.json")}
               for _, name in NAMED) == 25


@pytest.mark.parametrize("script,name", NAMED, ids=[f"{s}-{n or 'default'}" for s, n in NAMED])
def test_build_config_equals_jax(script, name):
    jax_mod, mod = PAIRS[script]
    named = [] if name is None else [name]
    assert without_device(mod.ex.build_config(named)) == jax_mod.ex.build_config(named)


# -- (b) grammar parity --------------------------------------------------------

ARGVS = [
    ("train_adversarial", ["gail", "with", "gail_cartpole", "total_timesteps=32768", "log_root=/tmp/x"]),
    ("train_adversarial", ["airl", "fast", "rl.learning_rate=0.01", "policy.hid_sizes=[64, 64]"]),
    ("train_adversarial", ["with", "fast", "algorithm_kwargs.demo_minibatch_size=8",
                           "algorithm_kwargs.disc_opt_kwargs={'lr': 1e-4}"]),
    ("train_rl", ["with", "fast", "sac", "env_make_kwargs.g=9.81", "reward_type=RewardNet_unshaped"]),
    ("train_rl", ["with", "pendulum", "rl.n_epochs=3", "seed=7", "reward_path=/a/b c"]),
    ("train_imitation", ["dagger", "with", "dagger_cartpole", "dagger.beta_schedule=exponential"]),
    ("train_imitation", ["bc", "with", "expert.loader_kwargs.path=/x/y", "demonstrations.path=None"]),
    ("train_preference_comparisons", ["with", "active", "reward.add_std_alpha=0.5", "query_schedule=constant"]),
    ("eval_policy", ["with", "fast", "explore_kwargs={'random_prob': 1.0, 'switch_prob': 0.5}"]),
    ("eval_policy", []),
]


@pytest.mark.parametrize("script,argv", ARGVS, ids=[" ".join([s] + a) for s, a in ARGVS])
def test_parse_cli_equals_jax(script, argv):
    jax_mod, mod = PAIRS[script]
    jax_command, jax_config = jax_mod.ex.parse_cli(argv)
    command, config = mod.ex.parse_cli(argv)
    assert command == jax_command
    assert without_device(config) == jax_config


@pytest.mark.parametrize("argv", [["print_config", "fast"], ["with", "print_config", "fast", "seed=3"],
                                  ["gail", "with", "print_config", "gail_cartpole"]])
def test_print_config_equals_jax(argv):
    outs = []
    for ex in (jax_train_adversarial.ex, train_adversarial.ex):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert ex.parse_cli(argv) == (None, None)
            assert ex.run_cli(argv) is None  # runs nothing
        outs.append(buf.getvalue())
    jax_out, out = outs
    assert without_device(json.loads(out.split("\n}\n")[0] + "\n}")) == json.loads(jax_out.split("\n}\n")[0] + "\n}")


BAD = [
    ["with", "rl.no_such_key=1"],  # unknown key
    ["with", "no_such_named_config"],  # unknown named config
    ["with", "total_timesteps.x=1"],  # descending into a number
    ["with", "policy.hid_sizes.x=1"],  # descending into a list
]


@pytest.mark.parametrize("argv", BAD, ids=[" ".join(a) for a in BAD])
def test_bad_argv_raises_like_jax(argv):
    errors = []
    for ex in (jax_train_adversarial.ex, train_adversarial.ex):
        with pytest.raises(Exception) as info:
            ex.parse_cli(["gail"] + argv)
        errors.append(type(info.value))
    assert errors[0] is errors[1] is KeyError


# -- (c) the tuned files -------------------------------------------------------


def test_tuned_file_sets_are_equal():
    assert sorted(p.name for p in PORT_TUNED.glob("*.json")) == sorted(p.name for p in JAX_TUNED.glob("*.json"))
    assert len(list(PORT_TUNED.glob("*.json"))) == 25


@pytest.mark.parametrize("name", sorted(p.name for p in JAX_TUNED.glob("*.json")))
def test_tuned_file_is_a_byte_copy(name):
    assert (PORT_TUNED / name).read_bytes() == (JAX_TUNED / name).read_bytes()


# -- (d) construction parity ---------------------------------------------------


class Stop(Exception):
    """Raised by the recorder of the outermost trainer: nothing trains."""


def recorder(records, name, stop=False):
    def record(*args, **kwargs):
        records[name] = (args, kwargs)
        if stop:
            raise Stop
        return types.SimpleNamespace(recorded=name)

    return record


def patch(monkeypatch, modules, attr, fn):
    hit = False
    for module in modules:
        if hasattr(module, attr):
            monkeypatch.setattr(module, attr, fn)
            hit = True
    assert hit, attr


def dc(x):
    """A config dataclass as a dict; recorded stubs as their name."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, types.SimpleNamespace):
        return x.recorded
    return x


def policy_summary(policy):
    net = getattr(policy, "net", policy)  # the port keeps the widths on its net
    return {"cls": type(policy).__name__, "hid_sizes": tuple(net.hid_sizes),
            "normalize_features": policy.normalize_features, "features": policy.features}


def net_summary(net):
    name = type(net).__name__
    if name == "ShapedRewardNet":
        return {"shaped": net_summary(net.base), "potential": type(net.potential).__name__,
                "discount_factor": net.discount_factor}
    if name == "NormalizedRewardNet":
        return {"normalized": net.normalize_cls.__name__, "base": net_summary(net.base)}
    if name == "RewardEnsemble":
        norm = net.member_normalize_cls
        return {"ensemble": net.member_cls.__name__, "num_members": net.num_members,
                "member_normalize_cls": None if norm is None else norm.__name__}
    assert name == "BasicRewardNet", name
    norm = getattr(net, "normalize_input", None)
    return {"cls": name, "normalize_input": norm if isinstance(norm, bool) else net.input_norm is not None}


def run_recorded(pkg_mod, argv, stop_attr, patches, monkeypatch):
    """Runs the script's command up to the recorder of ``stop_attr``; the
    demonstrations are stubbed out (both packages), the env is built."""
    records = {}
    ingredients_mod = pkg_mod.ingredients
    monkeypatch.setattr(ingredients_mod, "get_expert_trajectories", lambda config, venv: [])
    for modules, attr in patches:
        patch(monkeypatch, modules, attr, recorder(records, attr, stop=attr == stop_attr))
    command, config = pkg_mod.ex.parse_cli(argv)
    fn = pkg_mod.ex.commands[command] if command else pkg_mod.ex.main_fn
    with pytest.raises(Stop):
        fn(config, "unused-run-dir", None)
    return records


def both(script, argv, stop_attr, patch_specs, monkeypatch):
    """Records of the JAX package's script, then of the port's (``device=cpu``)."""
    import importlib

    jax_mod, mod = PAIRS[script]
    out = []
    for pkg, m, extra in (("imitation_tpu", jax_mod, []), ("imitation_tpu_torch", mod, ["device=cpu"])):
        patches = [([m] + [importlib.import_module(f"{pkg}.{d}") for d in defining], attr)
                   for defining, attr in patch_specs]
        out.append(run_recorded(m, argv + extra, stop_attr, patches, monkeypatch))
        monkeypatch.undo()
    return out


SCALARS = ("demo_batch_size", "n_disc_updates_per_round", "allow_variable_horizon", "seed",
           "gen_replay_buffer_capacity", "demo_minibatch_size")

ADVERSARIAL = [["gail", "with", "fast"], ["airl", "with", "fast"], ["gail", "with", "gail_cartpole"],
               ["airl", "with", "sac", "env_name=Pendulum-v1"]]


@pytest.mark.parametrize("argv", ADVERSARIAL, ids=[" ".join(a) for a in ADVERSARIAL])
def test_train_adversarial_builds_like_jax(argv, monkeypatch):
    trainer = argv[0].upper()
    jax_rec, rec = both("train_adversarial", argv, trainer,
                        [(["algorithms.adversarial.gail"], "GAIL"), (["algorithms.adversarial.airl"], "AIRL"),
                         (["rl.sac"], "SAC")], monkeypatch)
    (_, jkw), (_, kw) = jax_rec[trainer], rec[trainer]
    assert sorted(kw) == sorted(jkw)
    for k in SCALARS:
        assert kw.get(k) == jkw.get(k), k
    assert dataclasses.asdict(kw["gen_config"]) == dataclasses.asdict(jkw["gen_config"])
    assert net_summary(kw["reward_net"]) == net_summary(jkw["reward_net"])
    assert (kw["policy"] is None) == (jkw["policy"] is None) == ("sac" in argv)
    if kw["policy"] is not None:
        assert policy_summary(kw["policy"]) == policy_summary(jkw["policy"])
    assert ("SAC" in rec) == ("SAC" in jax_rec) == ("sac" in argv)
    if "SAC" in rec:
        assert dataclasses.asdict(rec["SAC"][0][1]) == dataclasses.asdict(jax_rec["SAC"][0][1])
        assert rec["SAC"][1] == jax_rec["SAC"][1]  # the seed


@pytest.mark.parametrize("argv", [["with", "fast"], ["with", "fast", "sac", "pendulum"],
                                  ["with", "normalize_reward=True", "rl.batch_size=128"]])
def test_train_rl_builds_like_jax(argv, monkeypatch):
    algo = "SAC" if "sac" in argv else "PPO"
    jax_rec, rec = both("train_rl", argv, algo, [(["rl.ppo"], "PPO"), (["rl.sac"], "SAC")], monkeypatch)
    (jargs, jkw), (args, kw) = jax_rec[algo], rec[algo]
    assert kw["seed"] == jkw["seed"]
    config = args[2] if algo == "PPO" else args[1]
    jconfig = jargs[2] if algo == "PPO" else jargs[1]
    assert dataclasses.asdict(config) == dataclasses.asdict(jconfig)
    if algo == "PPO":
        assert policy_summary(args[1]) == policy_summary(jargs[1])
        assert kw["reward_fn"] is jkw["reward_fn"] is None


IMITATION = [(["bc", "with", "fast"], "BC"), (["bc", "with", "bc_cartpole"], "BC"),
             (["bc", "with", "fast", "bc.learning_rate=0.005", "bc.minibatch_size=4"], "BC"),
             (["dagger", "with", "fast"], "SimpleDAggerTrainer"),
             (["dagger", "with", "dagger_cartpole", "dagger.beta_schedule=exponential"], "SimpleDAggerTrainer"),
             (["sqil", "with", "fast"], "SQIL"), (["sqil", "with", "sqil_cartpole"], "SQIL")]


@pytest.mark.parametrize("argv,stop", IMITATION, ids=[" ".join(a) for a, _ in IMITATION])
def test_train_imitation_builds_like_jax(argv, stop, monkeypatch):
    jax_rec, rec = both("train_imitation", argv, stop,
                        [(["algorithms.bc"], "BC"), (["algorithms.dagger"], "SimpleDAggerTrainer"),
                         (["algorithms.sqil"], "SQIL")], monkeypatch)
    if "BC" in rec:
        (_, jkw), (_, kw) = jax_rec["BC"], rec["BC"]
        for k in ("rng", "batch_size", "minibatch_size", "ent_weight", "l2_weight",
                  "optimizer_kwargs", "allow_variable_horizon"):
            assert kw[k] == jkw[k], k
        assert kw["optimizer_kwargs"] == {"lr": 0.005 if "bc.learning_rate=0.005" in argv else 1e-3}
    if stop == "SimpleDAggerTrainer":
        (_, jkw), (_, kw) = jax_rec[stop], rec[stop]
        assert kw["rng"] == jkw["rng"]
        assert type(kw["beta_schedule"]).__name__ == type(jkw["beta_schedule"]).__name__
        assert vars(kw["beta_schedule"]) == vars(jkw["beta_schedule"])
        assert dc(kw["bc_trainer"]) == dc(jkw["bc_trainer"]) == "BC"
    if stop == "SQIL":
        (_, jkw), (_, kw) = jax_rec[stop], rec[stop]
        for k in ("dqn_config", "sac_config"):
            assert dataclasses.asdict(kw[k]) == dataclasses.asdict(jkw[k]), k
        assert kw["seed"] == jkw["seed"] and kw["allow_variable_horizon"] == jkw["allow_variable_horizon"]


PREFERENCE = [["with", "fast"], ["with", "fast", "active"], ["with", "fast", "sac", "env_name=Pendulum-v1"],
              ["with", "fast", "ensemble", "normalize_output_ema", "reward.add_std_alpha=0.5",
               "exploration_frac=0.1", "reward_trainer.lr=0.003"]]


@pytest.mark.parametrize("argv", PREFERENCE, ids=[" ".join(a) for a in PREFERENCE])
def test_train_preference_comparisons_builds_like_jax(argv, monkeypatch):
    pc = "algorithms.preference_comparisons"
    jax_rec, rec = both("train_preference_comparisons", argv, "PreferenceComparisons",
                        [(["rl.ppo"], "PPO"), (["rl.sac"], "SAC"), ([pc], "AgentTrainer"),
                         ([pc], "SACAgentTrainer"), ([pc], "_make_reward_trainer"),
                         ([pc], "PreferenceComparisons")], monkeypatch)
    assert sorted(rec) == sorted(jax_rec)
    (jargs, jkw), (args, kw) = jax_rec["PreferenceComparisons"], rec["PreferenceComparisons"]
    assert net_summary(args[1]) == net_summary(jargs[1])
    for k in ("num_iterations", "comparison_queue_size", "fragment_length", "transition_oversampling",
              "initial_comparison_frac", "initial_epoch_multiplier", "allow_variable_horizon", "rng",
              "query_schedule", "seed"):
        assert kw[k] == jkw[k], k
    frag, jfrag = kw["fragmenter"], jkw["fragmenter"]
    assert type(frag).__name__ == type(jfrag).__name__
    if type(frag).__name__ == "ActiveSelectionFragmenter":
        assert frag.fragment_sample_factor == jfrag.fragment_sample_factor
        assert frag.uncertainty_on == jfrag.uncertainty_on
    gat, jgat = kw["preference_gatherer"], jkw["preference_gatherer"]
    for k in ("temperature", "discount_factor", "sample"):
        assert getattr(gat, k) == getattr(jgat, k), k
    (_, jrt), (_, rt) = jax_rec["_make_reward_trainer"], rec["_make_reward_trainer"]
    assert rt == jrt and rt["reward_trainer_kwargs"]["lr"] == (0.003 if "reward_trainer.lr=0.003" in argv else 1e-3)
    agent = "SACAgentTrainer" if "sac" in argv else "AgentTrainer"
    (jargs, jkw), (args, kw) = jax_rec[agent], rec[agent]
    assert kw == jkw  # rng, exploration_frac, relabel_alpha
    algo = "SAC" if "sac" in argv else "PPO"
    (jargs, _), (args, _) = jax_rec[algo], rec[algo]
    assert dataclasses.asdict(args[-1]) == dataclasses.asdict(jargs[-1])
    if algo == "PPO":
        assert policy_summary(args[1]) == policy_summary(jargs[1])
