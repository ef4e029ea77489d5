#!/usr/bin/env python3
"""Smoke run of imitation_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Phases, each timed and printed on its own line:

1. device: the card's name and power limit (nvidia-smi); exits non-zero
   without CUDA.
2. build: compiles the CUDA kernels (one nvcc call) and loads them.
3. kernels: holds each kernel against its plain PyTorch version at the GAIL
   CartPole shapes and at edge shapes: B1 GAE allclose at rtol = atol = 1e-5
   (it composes segments of the scan, so it sums in another order), printing
   its grid at each shape; B2 disc-batch assembly exactly, the four fields of
   a disc step in one launch, plus a field of F = 3 and fields whose base is
   offset by one element (the word path and the misaligned path). Times the
   kernel and its plain version and, for B2, the yardstick of four x
   (``index_select`` x 2 + ``cat``), with CUDA events (median of repeats);
   B1 at [128, 1024], [64, 64] and [2048, 4096], B2 per disc step.
   ``device_ms`` is the kernel's own device time from a torch.profiler trace
   (``ms`` is the time per call, wrapper and launch included).
4. reference: one PPO update of a small problem on the GPU against the same
   update on the CPU, and the trained reward net's GPU forward against its
   CPU forward.
5. gail: GAIL on device CartPole-v1 at the headline configuration (1024 envs
   x 128 steps, PPO 32 minibatches x 5 epochs, demo batch 2048, 2 disc
   updates per round) with demos made on the card by the scripted expert:
   one warm-up round, then two rounds of ``train`` with the kernels' launch
   counts set to 0 just before and read just after (B1 once per round, B2
   once per disc step); then one more round
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
    timed = ((128, 1024), (64, 64), (2048, 4096))  # main path, HalfCheetah path, large
    kept, err_path = {}, None
    for T, B in ((128, 1024), (64, 64), (1, 5), (17, 37), (32, 8), (2048, 4096)):
        p = panels(T, B)
        adv, ret = gae.gae(*p, gamma, lam)
        adv_p, ret_p = gae.gae_plain(*p, gamma, lam)
        err = max((adv - adv_p).abs().max().item(), (ret - ret_p).abs().max().item())
        if not (torch.allclose(adv, adv_p, rtol=1e-5, atol=1e-5)
                and torch.allclose(ret, ret_p, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"GAE kernel disagrees with plain at T={T} B={B}: {err}")
        log("kernels", f"gae T={T} B={B}: max_abs_err {err:.3g} (allclose rtol=atol=1e-5); "
                       f"grid {gae.launch_shape(T, B)}")
        if (T, B) in timed:
            kept[(T, B)] = p
        if (T, B) == (128, 1024):
            err_path = err
    gae_rows = {}
    for T, B in timed:
        p = kept[(T, B)]
        big = T * B > 10**6
        ms = cuda_ms(lambda: gae.gae(*p, gamma, lam), reps=20 if big else 200)
        dev_ms = device_ms(lambda: gae.gae(*p, gamma, lam), 10 if big else 50, "gae_kernel")
        gae_bytes, gae_ops = 7 * T * B * 4, 10 * T * B
        bound = max(gae_bytes / HBM_BYTES_PER_S, gae_ops / F32_FLOP_PER_S) * 1e3
        share = f"{100 * bound / dev_ms:.1f}%" if dev_ms else "not measured"
        gae_rows[(T, B)] = (ms, dev_ms, bound, gae_bytes, gae_ops)
        log("kernels", f"gae [{T},{B}]: call {ms:.4f} ms, device {dev_ms} ms, bound {bound:.5f} ms "
                       f"(bytes {gae_bytes}), device time at {share} of the bound; "
                       f"grid {gae.launch_shape(T, B)}")
    T, B = 128, 1024
    ms, dev_ms, bound, gae_bytes, gae_ops = gae_rows[(T, B)]
    plain_ms = cuda_ms(lambda: gae.gae_plain(*kept[(T, B)], gamma, lam), reps=5)
    log("kernels", f"gae [{T},{B}]: plain {plain_ms:.4f} ms")
    entries.append(dict(
        name="gae", route="cuda", source="imitation_tpu_torch/csrc/gae.cu",
        replaces="imitation_tpu/ops/gae_pallas.py:30",
        max_abs_err=err_path, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes" if gae_bytes / HBM_BYTES_PER_S >= gae_ops / F32_FLOP_PER_S else "operations",
        library_ms=None, device_ms=dev_ms, shape=f"[{T}, {B}] f32 x5 -> x2",
        grid=gae.launch_shape(T, B),
    ))

    # -- B2 disc-batch assembly: one launch for a disc step's four fields -----------
    def field(rows, F, dtype, offset=0):
        """[rows] or [rows, F]; ``offset`` words into a larger buffer, so the
        base is only 4-byte aligned when offset is odd."""
        n = rows * (F or 1) + offset
        if dtype == torch.int32:
            flat = torch.randint(-1000, 1000, (n,), generator=g, device=dev, dtype=torch.int32)
        else:
            flat = torch.randn((n,), generator=g, device=dev)
        flat = flat[offset:]
        return flat if F is None else flat.view(rows, F)

    def idx(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int32)

    def check_fused(name, n, c, b, kinds, spread=0):
        pairs = [(field(n, F, dt, off), field(c, F, dt, off)) for F, dt, off in kinds]
        e = idx(b, -spread, n + spread) if spread else idx(b, 0, n)
        gi = idx(b, -spread, c + spread) if spread else idx(b, 0, c)
        outs = disc_assembly.assemble_fields(pairs, e, gi)
        err = 0.0
        for out, (d, gr) in zip(outs, pairs):
            want = disc_assembly.assemble_rows_plain(d, gr, e, gi)
            if not torch.equal(out, want):
                raise AssertionError(f"fused assembly disagrees with plain on {name}")
            err = max(err, (out.double() - want.double()).abs().max().item())
        log("kernels", f"assemble_fields {name} [{n}|{c}] B={b}, fields (F, dtype, offset) "
                       f"{[(F, str(dt).split('.')[-1], off) for F, dt, off in kinds]}: exact, one launch")
        return pairs, e, gi, err

    f32, i32 = torch.float32, torch.int32
    N, C, Bd = 12800, 131072, 2048  # demo rows, replay rows, demo_batch_size
    disc_kinds = ((4, f32, 0), (None, i32, 0), (4, f32, 0), (None, f32, 0))  # obs acts next_obs dones
    pairs, e_o, g_o, err_b2 = check_fused("disc step", N, C, Bd, disc_kinds)
    for name, kinds, n, c, b, spread in (
        ("edge-1row", ((1, f32, 0),), 5, 5, 1, 0),
        ("edge-out-of-range", ((3, f32, 0),), 12, 9, 40, 30),
        ("edge-1d-out-of-range", ((None, i32, 0),), 12, 9, 40, 30),
        ("F=3 word path", ((3, f32, 0),), N, C, Bd, 0),
        ("1-D base offset by one element", ((None, f32, 1),), N, C, Bd, 0),
        ("mixed: aligned F=4, F=3, offset 1-D, offset F=4",
         ((4, f32, 0), (3, i32, 0), (None, f32, 1), (4, f32, 1)), 300, 700, 257, 40),
    ):
        err_b2 = max(err_b2, check_fused(name, n, c, b, kinds, spread)[3])

    def fused():
        return disc_assembly.assemble_fields(pairs, e_o, g_o)

    def plain_step():
        return [disc_assembly.assemble_rows_plain(d, gr, e_o, g_o) for d, gr in pairs]

    def yardstick():  # four x (two index_select + cat): one PyTorch call chain per field
        return [torch.cat([torch.index_select(d, 0, e_o), torch.index_select(gr, 0, g_o)])
                for d, gr in pairs]

    ms_b2 = cuda_ms(fused, reps=200)
    plain_b2 = cuda_ms(plain_step, reps=100)
    lib_b2 = cuda_ms(yardstick, reps=200)
    dev_b2 = device_ms(fused, 50, "assemble_fields_kernel")
    lib_dev_b2 = device_ms(yardstick, 50, "")
    obs_only = lambda: disc_assembly.assemble_rows(pairs[0][0], pairs[0][1], e_o, g_o)
    dev_obs = device_ms(obs_only, 50, "assemble_fields_kernel")
    b2_bytes = 2 * Bd * 4 + sum(2 * 2 * Bd * 4 * (d.shape[1] if d.dim() == 2 else 1) for d, _ in pairs)
    bound_b2 = b2_bytes / HBM_BYTES_PER_S * 1e3
    ctas_b2 = -(-2 * Bd // 128)
    entries.append(dict(
        name="assemble_rows", route="cuda", source="imitation_tpu_torch/csrc/disc_assembly.cu",
        replaces="imitation_tpu/ops/disc_assembly.py:36",
        max_abs_err=err_b2, ms=ms_b2, plain_ms=plain_b2, bound_ms=bound_b2, bound_by="bytes",
        library_ms=lib_b2, device_ms=dev_b2, library_device_ms=lib_dev_b2,
        shape=f"one disc step, 4 fields in one launch: demo [{N}], replay [{C}], B={Bd}; "
              f"obs/next_obs [., 4] f32, acts [.] int32, dones [.] f32",
        grid={"ctas": ctas_b2, "threads": 128},
    ))
    log("kernels", f"assemble_fields disc step (4 fields, {b2_bytes} bytes, grid {ctas_b2} x 128): "
                   f"call {ms_b2:.4f} ms, device {dev_b2} ms (obs field alone {dev_obs} ms), "
                   f"plain {plain_b2:.4f} ms, 4 x (index_select+index_select+cat) call {lib_b2:.4f} ms "
                   f"device {lib_dev_b2} ms, bound {bound_b2:.6f} ms")
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
    disc_assembly.assemble_fields.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(rounds * trainer.gen_train_timesteps,
                  callback=lambda r: round_ends.append(time.perf_counter()))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"gae": gae.gae.launches, "assemble_rows": disc_assembly.assemble_fields.launches}
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
    want = {"gae": rounds, "assemble_rows": rounds * trainer.n_disc_updates_per_round}
    if launches != want:  # GAE once per round, B2 once per disc step
        raise AssertionError(f"launches {launches}, expected {want}")

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
    print(json.dumps({"kernels": entries}), flush=True)
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
