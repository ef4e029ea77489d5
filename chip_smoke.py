#!/usr/bin/env python3
"""Smoke run of imitation_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Phases, each timed and printed on its own line:

1. device: the card's name and power limit (nvidia-smi); exits non-zero
   without CUDA.
2. build: compiles the CUDA kernels (one nvcc call) and loads them.
3. kernels: holds each kernel against its plain PyTorch version at the GAIL
   CartPole shapes and at edge shapes (B1 GAE within 1e-5, B2 disc-batch
   assembly exactly), and times kernel, plain version and, for B2, the
   ``index_select`` + ``cat`` yardstick with CUDA events (median of repeats).
   ``device_ms`` is the kernel's own device time from a torch.profiler trace
   (``ms`` is the time per call, wrapper and launch included).
4. reference: one PPO update of a small problem on the GPU against the same
   update on the CPU, and the trained reward net's GPU forward against its
   CPU forward.
5. gail: GAIL on device CartPole-v1 at the headline configuration (1024 envs
   x 128 steps, PPO 32 minibatches x 5 epochs, demo batch 2048, 2 disc
   updates per round) with demos made on the card by the scripted expert:
   one warm-up round, then two rounds of ``train`` with the kernels' launch
   counts set to 0 just before and read just after; then one more round
   under torch.profiler, split by the port's ``record_function`` phases
   (host and kernel time of each, busy share, top kernels).

Then one JSON line listing the kernels, the nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 non-tensor rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``reps`` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_times(prof):
    """{kernel name: (count, device microseconds)} of a torch.profiler trace,
    kernels only (GPU-side user annotations such as ``Optimizer.step`` span
    kernels and would count them twice)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        count, us = out.get(e.name, (0, 0.0))
        out[e.name] = (count + 1, us + e.time_range.elapsed_us())
    return out


def device_ms(fn, reps: int, kernel: str):
    """Mean device time of the CUDA kernels whose name holds ``kernel``, per
    call of ``fn``, from a torch.profiler (CUPTI) trace; None if the trace
    shows none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(us for name, (_, us) in kernel_times(prof).items() if kernel in name)
    return total / 1e3 / reps if total > 0 else None


def check_kernels(torch, dev):
    from imitation_tpu_torch.ops import disc_assembly, gae

    g = torch.Generator(device=dev).manual_seed(0)
    entries = []

    # -- B1 GAE ---------------------------------------------------------------
    def panels(T, B):
        r = torch.randn((T, B), generator=g, device=dev)
        v = torch.randn((T, B), generator=g, device=dev)
        nv = torch.randn((T, B), generator=g, device=dev)
        term = (torch.rand((T, B), generator=g, device=dev) < 0.02).float()
        trunc = (torch.rand((T, B), generator=g, device=dev) < 0.02).float()
        return r, v, nv, term, torch.maximum(term, trunc)

    gamma, lam = 0.99, 0.95
    err_path = None
    for T, B in ((128, 1024), (1, 5), (17, 37), (32, 8), (2048, 4096)):
        p = panels(T, B)
        adv, ret = gae.gae(*p, gamma, lam)
        adv_p, ret_p = gae.gae_plain(*p, gamma, lam)
        err = max((adv - adv_p).abs().max().item(), (ret - ret_p).abs().max().item())
        if not (torch.allclose(adv, adv_p, rtol=1e-5, atol=1e-5)
                and torch.allclose(ret, ret_p, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"GAE kernel disagrees with plain at T={T} B={B}: {err}")
        log("kernels", f"gae T={T} B={B}: max_abs_err {err:.3g} (tol 1e-5)")
        if (T, B) == (128, 1024):
            err_path, p_path = err, p
    T, B = 128, 1024
    ms = cuda_ms(lambda: gae.gae(*p_path, gamma, lam), reps=200)
    plain_ms = cuda_ms(lambda: gae.gae_plain(*p_path, gamma, lam), reps=5)
    dev_ms = device_ms(lambda: gae.gae(*p_path, gamma, lam), 50, "gae_kernel")
    gae_bytes = 7 * T * B * 4
    gae_ops = 10 * T * B
    bound = max(gae_bytes / HBM_BYTES_PER_S, gae_ops / F32_FLOP_PER_S) * 1e3
    entries.append(dict(
        name="gae", route="cuda", source="imitation_tpu_torch/csrc/gae.cu",
        replaces="imitation_tpu/ops/gae_pallas.py:30",
        max_abs_err=err_path, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes" if gae_bytes / HBM_BYTES_PER_S >= gae_ops / F32_FLOP_PER_S else "operations",
        library_ms=None, device_ms=dev_ms, shape=f"[{T}, {B}] f32 x5 -> x2",
    ))
    log("kernels", f"gae [{T},{B}]: call {ms:.4f} ms (device {dev_ms} ms), plain {plain_ms:.4f} ms, "
                   f"bound {bound:.5f} ms")

    # -- B2 disc-batch assembly ---------------------------------------------------
    def field(rows, F, dtype):
        shape = (rows,) if F is None else (rows, F)
        if dtype == torch.int32:
            return torch.randint(0, 2, shape, generator=g, device=dev, dtype=torch.int32)
        return torch.randn(shape, generator=g, device=dev)

    def idx(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int32)

    N, C, Bd = 12800, 131072, 2048  # demo rows, replay rows, demo_batch_size
    err_b2 = 0.0
    cases = [
        ("obs", N, C, Bd, 4, torch.float32, 0),
        ("acts", N, C, Bd, None, torch.int32, 0),
        ("dones", N, C, Bd, None, torch.float32, 0),
        ("edge-1row", 5, 5, 1, 1, torch.float32, 0),
        ("edge-out-of-range", 12, 9, 40, 3, torch.float32, 30),
        ("edge-1d-out-of-range", 12, 9, 40, None, torch.int32, 30),
    ]
    for name, n, c, b, F, dtype, spread in cases:
        demo, gen_rows = field(n, F, dtype), field(c, F, dtype)
        e = idx(b, -spread, n + spread) if spread else idx(b, 0, n)
        gi = idx(b, -spread, c + spread) if spread else idx(b, 0, c)
        out = disc_assembly.assemble_rows(demo, gen_rows, e, gi)
        want = disc_assembly.assemble_rows_plain(demo, gen_rows, e, gi)
        if not torch.equal(out, want):
            raise AssertionError(f"assembly kernel disagrees with plain on {name}")
        err_b2 = max(err_b2, (out.double() - want.double()).abs().max().item())
        log("kernels", f"assemble_rows {name} [{n}|{c}]->[{2 * b}{'' if F is None else f', {F}'}] {dtype}: exact")
        if name == "obs":
            demo_o, gen_o, e_o, g_o = demo, gen_rows, e, gi
    ms_b2 = cuda_ms(lambda: disc_assembly.assemble_rows(demo_o, gen_o, e_o, g_o), reps=200)
    plain_b2 = cuda_ms(lambda: disc_assembly.assemble_rows_plain(demo_o, gen_o, e_o, g_o), reps=200)
    lib_b2 = cuda_ms(
        lambda: torch.cat([torch.index_select(demo_o, 0, e_o), torch.index_select(gen_o, 0, g_o)]),
        reps=200,
    )
    dev_b2 = device_ms(lambda: disc_assembly.assemble_rows(demo_o, gen_o, e_o, g_o), 50,
                       "assemble_rows_kernel")
    b2_bytes = 2 * Bd * 4 + 2 * (2 * Bd * 4 * 4)
    bound_b2 = b2_bytes / HBM_BYTES_PER_S * 1e3
    entries.append(dict(
        name="assemble_rows", route="cuda", source="imitation_tpu_torch/csrc/disc_assembly.cu",
        replaces="imitation_tpu/ops/disc_assembly.py:36",
        max_abs_err=err_b2, ms=ms_b2, plain_ms=plain_b2, bound_ms=bound_b2, bound_by="bytes",
        library_ms=lib_b2, device_ms=dev_b2,
        shape=f"obs field: demo [{N}, 4], gen [{C}, 4], B={Bd} f32",
    ))
    log("kernels", f"assemble_rows obs: call {ms_b2:.4f} ms (device {dev_b2} ms), plain {plain_b2:.4f} ms, "
                   f"index_select+cat {lib_b2:.4f} ms, bound {bound_b2:.6f} ms")
    return entries


def reference_check(torch, dev):
    """One small PPO update with a learned reward, on the GPU and on the CPU."""
    from imitation_tpu_torch.data import rollout
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.models.policies import ActorCriticPolicy
    from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
    from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
    import torch.nn.functional as F

    cfg = PPOConfig(n_steps=32, n_minibatches=1, n_epochs=3, learning_rate=1e-3)
    runs = {}
    for device in ("cpu", dev):
        venv = make_vec_env("CartPole-v1", num_envs=16, device=device)
        policy = ActorCriticPolicy(venv.observation_space, venv.action_space)
        reward = BasicRewardNet(venv.observation_space, venv.action_space)
        reward.init(torch.Generator().manual_seed(1))
        reward = reward.to(device)
        ppo = PPO(venv, policy, cfg, seed=0,
                  reward_fn=lambda net, o, a, no, d: F.softplus(net(o, a, no, d)))
        state = ppo.init_state()
        if device == "cpu":
            init = {k: v.clone() for k, v in policy.state_dict().items()}
            _, chunk = rollout.collect(venv, policy.sample_fn(), state.env_state, 32, state.generator)
        else:
            policy.load_state_dict(init)
        moved = chunk.replace(
            **{k: getattr(chunk, k).to(device) for k in
               ("obs", "acts", "rews", "next_obs", "terminated", "truncated",
                "episode_return", "episode_length")},
            aux={k: v.to(device) for k, v in chunk.aux.items()},
        )
        state, metrics = ppo.process_chunk(state, None, moved, state.generator, reward)
        runs[device] = ({k: v.detach().cpu() for k, v in policy.state_dict().items()},
                        float(metrics["loss"]))
    (cpu_sd, cpu_loss), (gpu_sd, gpu_loss) = runs["cpu"], runs[dev]
    upd = max((cpu_sd[k] - init[k]).abs().max().item() for k in init)
    err = max((cpu_sd[k] - gpu_sd[k]).abs().max().item() for k in init)
    log("reference", f"PPO update GPU vs CPU: largest update {upd:.3g}, max param diff {err:.3g}, "
                     f"loss {gpu_loss:.6g} vs {cpu_loss:.6g}")
    if not (math.isfinite(gpu_loss) and err <= 1e-3 * upd + 1e-6):
        raise AssertionError("GPU PPO update disagrees with the CPU one")


def run_gail(torch, dev, num_envs=1024, n_steps=128, demo_batch_size=2048):
    from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
    from imitation_tpu_torch.data.rollout import rollout_stats
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.ops import disc_assembly, gae
    from imitation_tpu_torch.rl.ppo import PPOConfig
    from imitation_tpu_torch.testing import experts
    from imitation_tpu_torch.util.logger import KVWriter, configure

    class Capture(KVWriter):
        def __init__(self):
            self.rows = []

        def write(self, kvs, step):
            self.rows.append(dict(kvs))

    t0 = time.perf_counter()
    demo_venv = make_vec_env("CartPole-v1", num_envs=64, max_episode_steps=100, device=dev)
    demos = experts.generate_expert_trajectories("CartPole-v1", demo_venv, min_episodes=64, seed=0)
    stats = rollout_stats(demos)
    log("gail", f"expert demos: {stats['n_traj']} episodes, {sum(len(d) for d in demos)} rows, "
                f"return mean {stats['return_mean']} in {time.perf_counter() - t0:.2f} s")
    if stats["return_min"] != 100.0:
        raise AssertionError("the scripted expert should balance every 100-step episode")

    venv = make_vec_env("CartPole-v1", num_envs=num_envs, max_episode_steps=500, device=dev)
    logger = configure(format_strs=())
    capture = Capture()
    logger.default_logger.output_formats.append(capture)
    trainer = GAIL(
        demonstrations=demos,
        demo_batch_size=demo_batch_size,
        venv=venv,
        gen_config=PPOConfig(n_steps=n_steps, n_minibatches=32, n_epochs=5),
        n_disc_updates_per_round=2,
        allow_variable_horizon=True,
        custom_logger=logger,
        seed=0,
    )
    t0 = time.perf_counter()
    trainer.train(trainer.gen_train_timesteps)
    torch.cuda.synchronize()
    log("gail", f"warm-up round {time.perf_counter() - t0:.3f} s")

    rounds = 2
    round_ends = []
    gae.gae.launches = 0
    disc_assembly.assemble_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(rounds * trainer.gen_train_timesteps,
                  callback=lambda r: round_ends.append(time.perf_counter()))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"gae": gae.gae.launches, "assemble_rows": disc_assembly.assemble_rows.launches}
    per_round = [round_ends[0] - t0] + [b - a for a, b in zip(round_ends, round_ends[1:])]
    log("gail", f"{rounds} rounds in {elapsed:.3f} s ({', '.join(f'{s:.3f}' for s in per_round)} s "
                f"per round; {trainer.gen_train_timesteps} env steps each); launches {launches}")
    for row in capture.rows[-rounds:]:
        log("gail", "round: " + ", ".join(
            f"{k.split('/')[-1]} {row[k]:.4g}" for k in (
                "mean/gen/loss", "mean/gen/ep_return_mean", "mean/gen/relabeled_rew_mean",
                "mean/disc/disc_loss", "mean/disc/disc_acc")))
        bad = [k for k in ("mean/gen/loss", "mean/gen/value_loss", "mean/disc/disc_loss")
               if not math.isfinite(row[k])]
        if bad:
            raise AssertionError(f"non-finite losses: {bad}")
    params = list(trainer.policy.parameters()) + list(trainer.reward_net.parameters())
    if not all(bool(torch.isfinite(p).all()) for p in params):
        raise AssertionError("non-finite parameters after training")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")

    # The reward net's GPU forward against its CPU forward on the replay rows.
    data = trainer._gen_buffer_state.data
    rows = slice(0, 4096)
    cpu_net = type(trainer.reward_net)(venv.observation_space, venv.action_space)
    cpu_net.load_state_dict({k: v.cpu() for k, v in trainer.reward_net.state_dict().items()})
    with torch.no_grad():
        got = trainer.reward_net(data.obs[rows], data.acts[rows], data.next_obs[rows], data.dones[rows])
        want = cpu_net(*(x[rows].cpu() for x in (data.obs, data.acts, data.next_obs, data.dones)))
    err = (got.cpu() - want).abs().max().item()
    log("reference", f"reward net GPU vs CPU forward on 4096 replay rows: max abs diff {err:.3g}")
    if err > 1e-4:
        raise AssertionError("GPU reward forward disagrees with the CPU one")
    profile_round(torch, trainer, elapsed / rounds)
    return launches, elapsed / rounds


PHASES = ("ppo.collect", "ppo.process_chunk", "gail.buffer_store", "gail.disc_step",
          "gail.metrics_to_host")


def profile_round(torch, trainer, s_per_round):
    """One more GAIL round under torch.profiler. Splits it by the port's own
    ``record_function`` ranges (``PHASES``): host time of each, and the
    device time of the kernels that ran inside each range's device span.
    Busy share is kernel time over an unprofiled round (``s_per_round``),
    since the profiler slows the host loop down."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train(trainer.gen_train_timesteps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host, spans, kernels = {p: 0.0 for p in PHASES}, [], []
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in PHASES:
            host[e.name] += e.time_range.elapsed_us()
        elif e.device_type == DeviceType.CUDA and getattr(e, "is_user_annotation", False):
            if e.name in PHASES:
                spans.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.elapsed_us()))
    dev = {p: 0.0 for p in PHASES}
    for start, us in kernels:
        for lo, hi, name in spans:
            if lo <= start < hi:
                dev[name] += us
                break
    log("profile", "one round by phase (host ms / kernel ms): " + ", ".join(
        f"{p} {host[p] / 1e3:.1f} / " + (f"{dev[p] / 1e3:.2f}" if spans else "not measured")
        for p in PHASES))
    per_name = kernel_times(prof)
    busy = sum(t for _, t in per_name.values()) / 1e6
    n = sum(c for c, _ in per_name.values())
    log("profile", f"kernel time {busy:.4f} s, {n} kernels = {100 * busy / s_per_round:.1f}% of an "
                   f"unprofiled round ({s_per_round:.3f} s); the profiled round took {wall:.3f} s "
                   f"({wall / s_per_round:.2f}x)")
    for name, (count, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log("profile", f"  {us / 1e3:9.3f} ms  x{count:<6} {name[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from imitation_tpu_torch.ops import kernels

    t_all = time.perf_counter()
    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    log("device", f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
                  f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernels.load()
    log("build", f"nvcc + load {time.perf_counter() - t0:.2f} s -> {kernels.library_path().name}")

    t0 = time.perf_counter()
    entries = check_kernels(torch, dev)
    log("kernels", f"done in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    reference_check(torch, dev)
    log("reference", f"done in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    launches, s_per_round = run_gail(torch, dev)
    log("gail", f"done in {time.perf_counter() - t0:.2f} s; {s_per_round:.3f} s per round")

    for e in entries:
        e["launches"] = launches[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms", "shape")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}), flush=True)
    log("total", f"{time.perf_counter() - t_all:.2f} s")
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
