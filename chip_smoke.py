#!/usr/bin/env python3
"""Smoke run of imitation_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Phases, each timed and printed on its own line:

1. device: the card's name and power limit (nvidia-smi); exits non-zero
   without CUDA.
2. build: compiles the CUDA kernels (one nvcc per source, all started
   together, then one link) and loads them.
3. kernels: holds each kernel against its plain PyTorch version at the main
   paths' shapes and at edge shapes. B1 GAE allclose at rtol = atol = 1e-5
   (it composes segments of the scan, so it sums in another order), printing
   its grid at each shape; the main paths' [128, 1024], [256, 8], [64, 32],
   [128, 8], [64, 16], [32, 8] and the CLI's [128, 64] with float32 and
   with bool flag panels.
   B2 disc-batch assembly exactly: a GAIL
   CartPole and an AIRL Pendulum disc step (12-byte rows: the word path),
   the latter also at the CLI defaults' sizes, and GAIL at gail_cartpole's
   (demo 5,000 rows, replay 8,192, B = 1024) and over host Pendulum (demo
   12,800 rows, replay 512, B = 8192: the host GAIL phase's) and over
   seals/HalfCheetah (demo 48,000 rows, replay 512, B = 8192, obs/next_obs
   [., 18] f32, acts [., 6] f32: gail_seals_half_cheetah's) and at the
   tuned GAIL configs of seals/Hopper (demo 48,000, replay 4,096, B = 128,
   48-byte obs rows: the uint4 path), Walker2d (32,000, 16,384, B = 512,
   72-byte rows) and Swimmer (48,000, 4,096, B = 32, 40-byte rows), each
   four fields in one launch; pixel CartPole's GAIL disc step (obs/next_obs [., 16, 16, 1] f32,
   1,024-byte rows) and CarRacing-size uint8 rows ([., 96, 96, 3], 27,648
   bytes, 2,048 rows each side, B = 1024; not on a main path); the byte path (uint8 [., 2, 2], bool [.], f16 [., 3], f32
   [., 2, 2]), alone and mixed with word fields and offset bases; the
   tutorials' GAIL / AIRL disc step (demo 4,800 rows, replay 1,024, B = 256);
   out-of-range indices. Times each kernel and its plain version and, for
   B2, the yardstick of one ``index_select`` x 2 + ``cat`` per field, with
   CUDA events (median of repeats); B1 at [128, 1024], [64, 64],
   [2048, 4096], the CLI's [256, 8], the RLHF paths' [64, 32] and
   [128, 8], density's [64, 16], the pixel tutorial's [32, 8] and
   gail_cartpole's [128, 64], the tutorials' [64, 8] and [40, 16],
   gail_seals_walker's [256, 64], B2 per
   disc step (the CLI defaults', the tutorials',
   gail_cartpole's, both host GAIL ones, the three seals configs' and both
   image-row shapes included). ``device_ms`` is the kernel's own device
   time from a torch.profiler trace (``ms`` is the time per call, wrapper
   and launch included).
4. reference: one PPO update of a small problem on the GPU against the same
   update on the CPU.
5. envs: each classic-control env added after CartPole, at 1024 envs: one
   step on the card against the same step on the CPU, then 200 steps under
   the scripted expert (random actions where there is none), with finite
   observations and one truncation per episode that reaches the horizon.
6. gail: GAIL on device CartPole-v1 at the headline configuration (1024 envs
   x 128 steps, PPO 32 minibatches x 5 epochs, demo batch 2048, 2 disc
   updates per round) with demos made on the card by the scripted expert:
   one warm-up round, then two rounds of ``train``; then one more round under
   torch.profiler, split by the port's ``record_function`` ranges (host and
   kernel time of each, busy share, top kernels).
7. airl: AIRL on device Pendulum-v1 at the same widths, with a (32, 32)
   DiagGaussian policy, ``BasicShapedRewardNet`` and 64 expert episodes of
   200 steps: one warm-up round, two rounds of ``train``, two of
   ``train_fused(rounds_per_sync=2)`` on a fresh trainer (its replay ring
   sized by ``_example_transitions``), the test reward against the train
   reward, one profiled round; then one round at the JAX CLI's defaults (8
   envs x 256 steps, demo batch 1024, 4 disc updates, 10 expert episodes).
8. rl: ``PPO.learn`` on device Pendulum-v1 for 2 iterations at 1024 x 128
   with the linear learning rate, printed after each.
9. bc_cartpole: ``BC.train`` on the GAIL phase's demos (128 scripted
   episodes, 12,800 rows) with a (32, 32) tanh ``FeedForward32Policy`` with
   feature normalization, at the JAX CLI's BC defaults (batch 32, ent 1e-3,
   l2 0, lr 1e-3) for 2 epochs; then a fresh trainer for 1 epoch at batch 64
   with ``minibatch_size=16`` (gradient accumulation).
10. bc_pendulum: the same on 64 scripted Pendulum-v1 episodes of 200 rows,
   batch 64, l2 1e-4, 2 epochs (the DiagGaussian branch).
11. dagger_cartpole: ``SimpleDAggerTrainer.train`` on 16 device CartPole-v1
   envs with the scripted expert, BC at batch 16, l2 1e-4, lr 1e-3,
   ``LinearBetaSchedule(15)``, 2000 timesteps, 3 episodes and 500
   timesteps a round, episodes cut at 200 steps (cut from the CLI's 4000
   timesteps and CartPole-v1's 500 steps, one round of 8,000 rows, to make
   room for the examples: one round of 3,200 rows, 2.5x fewer BC steps),
   in a temporary scratch dir; then ``save_trainer``,
   ``reconstruct_trainer`` and one more round.
12. dagger_pendulum: the same on Pendulum-v1, ``ExponentialBetaSchedule(0.7)``
   and 2000 timesteps. The DAgger phases (this, dagger_cartpole and
   dagger_host_cartpole) train BC 2 epochs a round, not
   ``DEFAULT_N_EPOCHS`` (4), to keep the script within its time.
13. sac_pendulum: ``SAC.learn`` on 16 device Pendulum-v1 envs at the
   expert-training settings (train_freq 16, 256 gradient steps of batch 256
   a round, (256, 256) actor and critics, lr 3e-4), ``learning_starts`` cut
   to 768: 3 rounds with masked updates (cut from 10 to make room for the
   examples, then from 5 for the seals envs' phases), then 3 learning
   rounds (cut from 6 to make room for the host phases) under the CUDA
   sync debug mode (asserted: no host read); s/round, updates/s, the
   actor's forward on the card against the CPU on 4096 replay rows, and one
   profiled round split by ``sac.collect``, ``sac.buffer_store`` and
   ``sac.update`` (kernels and kernel time per update).
14. sqil_cartpole: ``SQIL.train`` (DQN) on 8 device CartPole-v1 envs at
   benchmarking/run_small_algos.py:52-67 (train_freq 4, batch 64, 4
   gradient steps, lr 1e-4, target copy every 2000 steps, exploration 0.3
   -> 0.05) on 10 scripted episodes, 5,000 steps (cut from 300,000).
15. sqil_pendulum: ``SQIL.train`` (SAC) on 8 device Pendulum-v1 envs at the
   ``train_imitation sqil`` defaults (learning_starts 500, batch 64, lr
   3e-4) on 10 scripted episodes, 3,000 steps (cut from 10,000).
16. airl_sac / gail_sac: AIRL and GAIL with a SAC generator on 8 device
   Pendulum-v1 envs at ``train_adversarial airl|gail with sac`` (train_freq
   256, SAC batch 64, learning_starts 100, demo batch 1024, 4 disc updates,
   10 scripted episodes): AIRL 2 rounds of ``train`` and 2 of
   ``train_fused`` on a fresh trainer, GAIL 1 round of ``train``; then B2
   on the AIRL trainer's own demo store and ring, exactly against its plain
   version, timed beside its bound and the ``index_select`` + ``cat`` route.
17. rlhf_pendulum: ``PreferenceComparisons.train`` at
   benchmarking/run_rlhf.py's ``pendulum`` preset (32 envs, PPO n_steps 64,
   32 minibatches x 10 epochs, a (32, 32) actor-critic with
   normalize_features, ``BasicRewardNet(normalize_input=True)``, fragments
   of 100 steps, initial_epoch_multiplier 200, exploration_frac 0.05,
   transition_oversampling 1.5), cut to 2 iterations, 8,192 timesteps and
   60 comparisons (each cut printed; 3, 12,288 and 90 until PR 13): B1 at
   [64, 32].
18. rlhf_active_pendulum: ``train_preference_comparisons with active``
   (8 envs, PPO n_steps 128, 16 minibatches x 4 epochs, lr 3e-4, a
   ``RewardEnsemble`` of 3 ``BasicRewardNet``s with member ``RunningNorm``,
   ``ActiveSelectionFragmenter`` on the logit with oversampling 2,
   fragments of 50, the reward trainer's 3 epochs of batch 32), cut to 2
   iterations, 4,096 timesteps and 80 comparisons: B1 at [128, 8].
19. pebble_pendulum: ``train_preference_comparisons with sac`` (8 envs,
   SAC lr 3e-4, train_freq 64, batch 64, learning_starts 100, (256, 256)
   nets, a ``NormalizedRewardNet`` over a ``BasicRewardNet``), cut to 2
   iterations, 4,000 timesteps and 80 comparisons: no kernel.
20. mceirl_random_mdp: benchmarking/run_small_algos.py's MCE IRL run in
   full (random_mdp(16, 4, horizon=16, seed=0), the expert's occupancy,
   ``MCEIRL(linf_eps=1e-4).train(max_iter=2000)``), logging through
   ``configure(tmpdir, ["stdout", "csv", "json", "log"])``: iterations,
   ms per iteration, the occupancy gap (asserted within 2e-2), the exact
   learned and expert returns, one progress.csv and progress.json row per
   ``log_interval`` (asserted); the first 50 iterations on the card
   against the CPU from the same weights; kernel launches and host reads
   per iteration; 3,000 sampled expert episodes against the occupancy.
21. mceirl_large: random_mdp(1024, 8, horizon=32) (T is 33.5 MB float32):
   the occupancy on the card against the CPU, then 200 iterations: ms per
   iteration, launches and host reads per iteration, T's bytes per second.
22. density_pendulum: run_small_algos.py's density run at its widths (16
   envs, the scripted expert's 20+ episodes, STATE_ACTION_DENSITY,
   bandwidth 0.5; PPO n_steps 64, 8 minibatches x 10 epochs, lr 3e-4,
   gamma 0.95), cut to 2,048 timesteps (2 PPO iterations, cut from 16 to
   make room for the host phases and the examples, then from 4 for the
   seals envs' phases): the KDE
   reward on the card against a CPU copy for each density type and for
   non-stationary density, expert above random transitions, B1 launched
   once per iteration at [64, 16], s per iteration, one profiled
   iteration, the true return over 50 episodes before and after.
23. checkpoint: ``save_state`` after one PPO iteration (the rl phase's
   configuration on 8 envs) and one SAC round, ``restore_state`` into a
   fresh ``init_state()``, one more step: the weights against the
   uninterrupted run's (bitwise equality printed).

24. gail_pixel_cartpole: GAIL on device ``PixelCartPole`` (the pixel
   tutorial's env, examples/tutorials/t05a_preference_comparisons_cnn.py,
   ported) at the gail phase's widths (1024 envs x 128 steps, PPO 32
   minibatches x 5 epochs, demo batch 2048, 2 disc updates) with the
   tutorial's (64, 64) MLP policy over the flattened pixels and a
   ``CnnRewardNet`` at its defaults; demos are the gail phase's 128
   scripted episodes (12,800 rows) drawn by the env's render. A warm-up
   round, two rounds of ``train``, the reward on the card against a CPU
   copy and one profiled round.
25. airl_pixel_cartpole: one AIRL round on 8 pixel envs x 256 steps at the
   JAX CLI's AIRL defaults (demo batch 1024, 4 disc updates) with
   ``ShapedRewardNet(CnnRewardNet, BasicPotentialCNN)`` on the same demos;
   the test reward against the train reward.
26. rlhf_pixel_cartpole: the ported tutorial's loop (``build``: 8 envs,
   ``CnnRewardNet(hid_channels=(8, 8))``, PPO n_steps 32) at an eighth of
   its ``__main__`` budget (4,000 of 30,000 timesteps, cut from 15,000 to
   make room for the examples; its 300 comparisons): B1 at [32, 8] once per PPO iteration (about 24; the
   examples run the tutorial's main as well); the reward's fit printed (CartPole's
   reward is 1 a step, so the synthetic preferences are coin flips), one
   reward update on the card against a CPU copy, and a 3-member
   ``RewardEnsemble`` of the tutorial's ``CnnRewardNet``s: fragment
   rewards and one update on the card against the CPU.
27. bc_nature_cnn: ``BC.train`` at the ``train_imitation bc`` defaults
   (batch 32, ent 1e-3, l2 0, lr 1e-3) for 1 epoch with a
   ``features="nature_cnn"`` policy on 10,000 uint8 frames [96, 96, 3]
   (CarRacing-v3's, 276 MB) made on the card from a seed, labelled
   Discrete(5) by the brightest of five vertical bands: host reads per
   epoch (asserted one), the loss falls and prob_true_act rises, 50
   profiled steps, the policy on the card against the CPU, the same net
   with ``compute_dtype=torch.bfloat16`` on 4,096 frames against float32
   (error over the largest float32 output, beside bf16's 2^-8; at most 16
   units), and a save/load round trip.
28. experts_seals: for each of the five seals envs, the JAX rounds' expert
   demos (output/experts/<env>/rollouts, HuggingFace Arrow files) through
   ``data.serialize.load`` (the port's own Arrow reader; episodes,
   transitions, MB and seconds printed) and the expert policy
   (output/experts/<env>/policy, flax msgpack: a ``sac_actor`` for
   HalfCheetah, ``actor_critic`` for the others) through
   ``load_policy_from_path`` onto the card; the expert's deterministic
   actions on every demo observation against a CPU copy (within 1e-5 of
   the largest action, or 4x the float32 floor of a one-ulp weight nudge),
   the mean log-probability of the demo actions, and the demos' mean return
   beside summary.json's evaluation return (not gated: the demos were
   sampled). The experts are found beside this script; without them it
   exits 1 before anything runs.
29. bc_seals_half_cheetah: ``BC.train`` on the 48 HalfCheetah episodes
   (48,000 transitions) at benchmarking/run_parity.py's settings
   (FeedForward32 with normalize_features, batch 64, l2 5.73e-3, lr
   8.06e-3), 2 epochs instead of 20: one host read per epoch, loss falling,
   steps/s, 50 profiled steps, a save/load round trip, and the BC policy's
   return on the port's HalfCheetah env (phase 49's protocol; printed).
30. bc_dict_obs: BC on 65,536 dict observations ``{"pos": 3, "vel": 2}``
   made on the card, as tests/algorithms/test_bc_dictobs.py (batch 256
   instead of 16), 2 epochs: accuracy above 0.9, the policy on the card
   against the CPU. Neither kernel is on phases 28-30.
31. cli_gail_cartpole: ``python -m imitation_tpu_torch train_adversarial gail
   with gail_cartpole total_timesteps=16384`` run in-process through
   ``ex.run_cli`` (every CLI phase logs under a temporary directory and
   takes the default device, CUDA): the tuned config at its widths (64
   envs x 128 steps, PPO batch 128 = 64 minibatches x 5 epochs, lr 1e-3,
   ent 0.01, demo batch 1024, 4 disc updates, 10 scripted demos), cut from
   500,000 timesteps to 2 rounds: s per round, B1 2 launches at [128, 64]
   and B2 8 (asserted), the run directory's files, imit_stats/return_mean;
   checkpoints/final's gen_policy and reward_test reloaded onto the card
   and held against the trainer on 4096 replay rows (within 1e-6).
32. cli_airl_pendulum: ``train_adversarial airl with env_name=Pendulum-v1
   total_timesteps=2048`` (1 round at the CLI defaults, 8 x 256: B1 1 at
   [256, 8], B2 4), then ``train_rl with pendulum
   reward_type=RewardNet_unshaped reward_path=<its reward_test>
   total_timesteps=2048`` (B1 1 at [256, 8]); the transferred reward on
   the card against the CPU.
33. cli_imitation_cartpole: ``train_imitation bc with bc_cartpole
   bc.n_epochs=2``, ``dagger with dagger_cartpole
   dagger.total_timesteps=2000``, ``sqil with sqil_cartpole
   sqil.total_timesteps=5000``, then ``eval_policy`` of the saved BC policy
   (``expert.policy_type=saved``), plain and with ``explore_kwargs``:
   returns printed, no kernel launched (asserted).
34. cli_preference_pendulum: ``train_preference_comparisons with active
   env_name=Pendulum-v1 num_iterations=2 total_timesteps=4096
   total_comparisons=80`` (rlhf_active_pendulum's cuts): B1 6 at [128, 8].
35. cli_main: ``python -m imitation_tpu_torch train_imitation bc with fast``
   in a subprocess from the checkout: exit 0, run.json COMPLETED, the
   kernel library in ``_build/`` untouched.
36. host_envs: the C++ host env engine (``imitation_tpu_torch/native``):
   its ``g++`` build at first use, timed; one step of each engine env type
   (CartPole, Pendulum, MountainCar, MountainCarContinuous) against
   ``envs/classic.py`` on the CPU from the same states at 64 envs, 50 steps,
   within 1e-6; env steps per second at 64 Pendulum envs on the engine's
   default threads (``min(8, cpu_count)``) and on one.
37. gail_host_pendulum: GAIL at bench.py:106-180's main-path learner
   configuration with benchmarking/run_parity.py:57's ("gail",
   "seals_half_cheetah") HPs over 64 host ``CppVectorEnv("Pendulum-v1")``
   envs (the physics swapped for Pendulum): a (32, 32) actor-critic with
   normalize_features, ``BasicRewardNet(normalize_input=True)``, PPO n_steps
   64, 64 minibatches x 5 epochs, lr 2.63e-4, clip 0.1, ent 3.99e-6,
   lambda 0.95, gamma 0.95, max_grad_norm 0.8, vf 0.115; demo batch 8192,
   replay 512 rows, 8 disc updates; 64 scripted episodes (12,800 rows)
   made through ``generate_trajectories_host``. Serialized only (its
   overlapped trainer cut to make room: phase 50 runs both modes on the
   real env): a warm-up round, 1 timed round (B1 once at [64, 64] and B2
   8 times, asserted), then 1 round under the generator's ``PhaseTimer``
   (host_collect, device_update, disc_update); s/round, the
   thread counts; parameters, buffers and every chunk field on cuda
   (asserted).
38. sac_host_pendulum: SAC on 16 host Pendulum envs (train_freq 16, batch
   256, (256, 256) nets, 16 gradient steps a round), 6 rounds serialized,
   then overlapped.
39. sqil_host_cartpole: SQIL (DQN) on 8 host CartPole envs with overlapped
   collection at sqil_cartpole's settings, 4,000 steps, demos made on host
   envs; the mixed batch half 0 then half 1.
40. dagger_host_cartpole: dagger_cartpole's run on 16 host CartPole envs
   with a 100-step horizon, 1,000 timesteps (one round, then the rebuilt
   trainer's; BC's evaluations roll out on the host env too).
41. rlhf_host_pendulum: ``PreferenceComparisons.train`` over 16 host
   Pendulum envs with ``exploration_frac`` 0.25 (the exploration wrapper's
   ``host_policy_fn``), 2 iterations, 4,096 timesteps, 60 comparisons: B1
   at [64, 16] once per PPO iteration. No kernel on phases 38-40.
42. dp_gail: data-parallel training (``imitation_tpu_torch.parallel``).
   GAIL ``train_fused`` at gail_cartpole's tuned widths (64 CartPole envs x
   128 steps, PPO batch 128 = 64 minibatches x 5 epochs, demo batch 1024,
   4 disc updates, 10 scripted demos), 1 of its 61 rounds: in one process
   (and once more from weights nudged by one ulp, for the float32 floor),
   then over 2 gloo ranks that share ``cuda:0``, started by the script
   itself with torchrun's variables (``chip_smoke.py --dp-rank <dir>
   <device>``) under a timeout: each rank steps 32 envs, runs B1 at
   [128, 32] once a round and B2 4 times a round (asserted on each rank),
   the ranks' generator and disc weights bitwise equal and within
   ``max(1e-5, 4 x floor)`` of the largest update of the one-process run,
   every rank's replay ring printed against the one-process ring; s per
   round for W = 1 and W = 2 (two processes sharing one card: not a
   scaling figure). Then the same run through ``initialize("nccl")`` at
   world size 1, against the one-process run.
43. dp_sac / dp_reward, on the same 2 ranks: SAC on 16 Pendulum-v1 envs
   (train_freq 16, 16 updates of batch 256 a round, (256, 256) nets, 4
   rounds, learning from the third) with the 4,096-row ring split (2,048
   rows a rank, asserted), and one ``BasicRewardTrainer.train`` (batch 32,
   3 epochs) on 250 synthetic comparisons with the batches split, each
   held against its one-process run as above (the reward net's output
   bias apart: its gradient is rounding noise).
44. tp_gail / tp_sac / tp_reward / tp_resume: tensor parallelism. The
   three runs of 42-43 over 4 gloo ranks sharing ``cuda:0`` at dp = 2 by
   tp = 2 (the rank script with ``ITT_TP=2``): every dense layer whose
   width divides by 2 split by output columns over the 2 ranks of a dp
   row (14 parameters of the GAIL policy and disc, 20 of SAC's actor,
   critic and target, 4 of the reward net, on the card: asserted), each
   held against the same one-process run and float32 floor as 42-43, the
   4 ranks bitwise equal, B1 at [128, 32] twice and B2 8 times on each
   rank, every chunk field on the card; s per round for each rank beside
   W = 1 (4 processes sharing one card: not a scaling figure). Then the
   generator state the ranks saved (columns gathered, rank 0 wrote)
   restored here at tp = 1: its policy bitwise the ranks' gathered one,
   and one more round (B1 once, B2 4 times).
45. sb3_expert (with the CLI phases): a Stable-Baselines3 PPO
   ``model.zip`` written here from a seeded generator, loaded by
   ``load_policy("ppo", ...)`` on the card and on the CPU (log-probs on
   4,096 seeded CartPole observations within 1e-5, actions equal but at
   ties), then ``train_imitation bc with bc_cartpole bc.n_epochs=1
   expert.policy_type=ppo`` from it through ``ex.run_cli`` (COMPLETED).
   The BC run of cli_imitation_cartpole also logs ``tensorboard``: its
   events file is read back record by record, each length's and data's
   masked CRC-32C checked by a bitwise CRC of this script's own.
46. examples (ex_t01_bc ... ex_rlhf_example, after the CLI phases): every
   ported example's ``main(device=cuda:0)`` (imitation_tpu_torch/examples:
   tutorials 1-10, 5a and 8a, the quickstart and the RLHF example; not 11,
   which the dp phases cover) at tests/test_examples.py's budgets (the
   quickstart's 30 fused GAIL and 10 AIRL rounds, the RLHF example's 20,000
   timesteps and 200 comparisons, whole), widths unchanged: seconds, PPO
   iterations and disc steps (``PPO.process_chunk`` and ``_disc_step``
   calls, counted here) and the kernels' launches, asserted one B1 per PPO
   iteration and one B2 per disc step (the GAIL and AIRL tutorials and the
   quickstart launch both, at [128, 8] and B = 256; the RLHF tutorials,
   density and the custom-env tutorial B1 only, at [64, 8], [32, 8] and
   [40, 16]); the line each prints.
47. interactive: ``cartpole_interactive_policy`` over 4 device CartPole envs
   through ``as_rollout_fn`` for 16 steps, fed scripted keys (an invalid
   one before every third answer): the actions int32 on the card and equal
   to the keys', one prompt per query and per invalid key.
48. hf_roundtrip: the scripted experts' card rollouts on CartPole (32
   episodes) and Pendulum (64) through ``data.serialize.save`` (the port's
   own HuggingFace writer) and ``load``: the three files, float64 rewards in
   the features, every array equal with its dtype; seconds and bytes.
49. halfcheetah_env, hopper_env, walker2d_env, swimmer_env (after
   experts_seals): the port's seals MuJoCo engine (``native/mjtree.cpp``,
   MuJoCo's mj_step for the compiled model: Euler for HalfCheetah; RK4,
   Hopper's frictionless capsule-capsule contacts and Swimmer's
   inertia-box fluid forces for the others): its ``g++`` build, timed;
   MuJoCo's own 64 env steps (the committed fixture
   imitation_tpu_torch/envs/assets/<model>_fixture.npz, written by
   tests/torch_mujoco_tools.py and read here with numpy) within 1e-8,
   rewards (the healthy reward included) within 1e-6; env steps per
   second at 64 envs on the default threads and on 1, 4 and 8; the repo's
   expert, deterministic on the card, over the fixture's envs (16 for
   HalfCheetah, 64 for the others) from reset seed 12345, one 1000-step
   episode each: the mean return within 2% of the JAX env's figure in the
   fixture.
50. gail_seals_half_cheetah (after bc_dict_obs): phase 37's trainer on the
   real env, bench.py:106-180's main path: 64 port HalfCheetah envs, the 48
   expert episodes (48,000 rows), serialized and overlapped, each a
   warm-up round, 2 timed rounds (B1 once at [64, 64] and B2 8 times a
   round at demo [48000], replay [512], B = 8192, asserted) and 2 under the
   ``PhaseTimer``; chunk [64, 64] float32 on cuda, finite losses.
51. cli_gail_seals_half_cheetah, cli_gail_seals_hopper,
   cli_gail_seals_walker, cli_gail_seals_swimmer (with the CLI phases):
   ``train_adversarial gail with <config> total_timesteps=...`` at the
   tuned widths on the card (asserted: 64 envs; Hopper 64 steps, 8 PPO
   minibatches x 20 epochs, demo batch 128, replay 4,096, 8 disc steps;
   Walker2d 256 steps, 128 x 20, 512, 16,384, 16; Swimmer 64 steps, 64 x
   5, 32, 4,096, 16), 2 rounds for HalfCheetah and Hopper (B1 2 and B2
   16, asserted), 1 for Walker2d and Swimmer (B1 1 and B2 16), then
   ``eval_policy with expert.policy_type=saved`` of the repo's expert on
   64 port envs.

The envs phase also steps ``TabularMDP`` (random_mdp(64, 4, horizon=32))
at 1024 envs through ``VectorEnv`` under random actions for 64 steps:
next-state frequencies within 5 binomial standard deviations of T, one
truncation per episode at the horizon.

The RLHF phases print seconds per iteration (the first holds the long
initial reward training), the last iteration under torch.profiler split by
the loop's ``pc.*`` ranges (host ms / kernels / kernel ms) and B1's
launches; they assert finite metrics and parameters, the dataset size the
schedule gives, fragment rewards equal to Pendulum's reward of their own
observations and actions, a fresh reward net fitted to the loop's
comparisons (200 epochs) at an accuracy of at least 0.5 on them (the
loop's own reward is printed beside it: the clamped BCE leaves pairs it
got confidently wrong without gradient, so at these depths it ends near
chance for some seeds), and one more reward-trainer update on the card
against the same update of a CPU copy (weights, optimizer moments, pairs).

The SQIL phases print steps and updates per second, the metrics of one
more step (losses asserted finite), returns over 64 episodes before and
after (not asserted), and assert that SQIL's sampled batch is half fresh
rows labelled 0, then half expert rows labelled 1.

The BC and DAgger phases print seconds per epoch, steps per second, host
reads per epoch (asserted one: BC reads an epoch's stacked metrics once),
DAgger seconds per round split into collection and BC, demo rows per round,
and returns over 64 episodes on 64 device envs before and after (not
asserted). They assert finite losses, that ``prob_true_act`` on the demos
rose, that every saved DAgger demo records the expert's actions on its
observations, and that the rebuilt trainer's policy equals the saved one.
Neither launches B1 or B2: their learner steps are eager PyTorch; nor do
the SAC and SQIL phases.

Every path (gail, airl, airl_fused, airl_cli, rl, airl_sac,
airl_sac_fused, gail_sac, rlhf_pendulum, rlhf_active_pendulum,
pebble_pendulum, mceirl_random_mdp, mceirl_large, density_pendulum,
gail_pixel_cartpole, airl_pixel_cartpole, rlhf_pixel_cartpole,
bc_nature_cnn, gail_seals_half_cheetah, cli_gail_cartpole,
cli_gail_seals_half_cheetah, cli_gail_seals_hopper, cli_gail_seals_walker,
cli_gail_seals_swimmer, cli_airl_pendulum, cli_rl_pendulum,
cli_preference_pendulum, the examples that launch a kernel (ex_t03_gail,
ex_t04_airl, ex_t05_rlhf, ex_t05a_rlhf_cnn, ex_t07_density,
ex_t10_custom_env, ex_quickstart, ex_rlhf_example), gail_host_pendulum,
rlhf_host_pendulum, dp_gail_w1,
dp_gail_w2_rank0, dp_gail_w2_rank1, dp_gail_nccl_w1, tp_gail_rank0-3,
tp_resume_w1; a rank counts its own launches and reports them) is driven
with the kernels' launch counts set to 0 just before it and read just after: B2 must launch once per disc step (never in
RLHF), and B1 once per round or iteration of a PPO path and never on a SAC
one. The reward
nets' forward on the card is held against a CPU copy on 4096 replay rows.

Then one JSON line listing the kernels, the nvidia-smi line, and the last
line ``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import copy
import datetime
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
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


def raw_events(prof):
    """A torch.profiler trace's raw kineto events, read once per trace:
    building torch's event tree of a long trace takes minutes on the host."""
    if not hasattr(prof, "raw_events"):
        prof.raw_events = list(prof.profiler.kineto_results.events())
    return prof.raw_events


def kernel_times(prof):
    """{kernel name: (count, device microseconds)} of a torch.profiler trace,
    kernels only (GPU-side user annotations such as ``Optimizer.step`` span
    kernels and would count them twice)."""
    from torch.autograd import DeviceType

    out = {}
    for e in raw_events(prof):
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        count, us = out.get(e.name(), (0, 0.0))
        out[e.name()] = (count + 1, us + e.duration_ns() / 1e3)
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

    def check_gae(T, B, p, flags=None, what=""):
        adv, ret = gae.gae(*(p if flags is None else p[:3] + flags), gamma, lam)
        adv_p, ret_p = gae.gae_plain(*p, gamma, lam)
        err = max((adv - adv_p).abs().max().item(), (ret - ret_p).abs().max().item())
        if not (torch.allclose(adv, adv_p, rtol=1e-5, atol=1e-5)
                and torch.allclose(ret, ret_p, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"GAE kernel disagrees with plain at T={T} B={B}{what}: {err}")
        log("kernels", f"gae T={T} B={B}{what}: max_abs_err {err:.3g} (allclose rtol=atol=1e-5); "
                       f"grid {gae.launch_shape(T, B)}")
        return err

    # main path, HalfCheetah path, large, the CLI's AIRL round, the RLHF preset's,
    # the RLHF CLI's, density's and the pixel tutorial's PPO iterations
    timed = ((128, 1024), (64, 64), (2048, 4096), (256, 8), (64, 32), (128, 8), (64, 16), (32, 8), (128, 64),
             (128, 32), (64, 8), (40, 16), (256, 64))
    kept, err_path = {}, None
    # The main paths' grids: [128, 1024] (gail, airl, airl_fused, rl,
    # gail_pixel_cartpole), [256, 8] (airl_cli, airl_pixel_cartpole), [64, 32]
    # (rlhf_pendulum), [128, 8] (rlhf_active_pendulum), [64, 16]
    # (density_pendulum), [32, 8] (rlhf_pixel_cartpole) and [128, 64]
    # (cli_gail_cartpole; the CLI's other PPO paths run [256, 8] and
    # [128, 8]) and [128, 32] (each rank of dp_gail's two and of tp_gail's
    # four), [64, 8] (the RLHF and density tutorials' and the RLHF
    # example's PPO; the GAIL and AIRL tutorials and the quickstart run
    # [128, 8]) and [40, 16] (the custom-env tutorial's PPO), [64, 64] (the
    # seals HalfCheetah, Hopper and Swimmer GAIL) and [256, 64]
    # (gail_seals_walker); then edge shapes and a large one.
    main = ((128, 1024), (256, 8), (64, 32), (128, 8), (64, 16), (32, 8), (128, 64), (128, 32), (64, 8),
            (40, 16), (64, 64), (256, 64))
    err_path = 0.0
    for T, B in main + ((1, 5), (17, 37), (32, 8), (2048, 4096)):
        p = panels(T, B)
        err = check_gae(T, B, p)
        if (T, B) in timed:
            kept[(T, B)] = p
        if (T, B) in main:
            err_path = max(err_path, err)
    # Bool flag panels, as a caller may pass them: gae casts them to float32
    # (the plain version is given the float32 panels), and truncations that
    # are not terminations, as Pendulum's horizon of 200 cuts 128-step chunks
    # (and the CLI's 256-step chunks).
    for T, B in main:
        p = panels(T, B)
        trunc = torch.rand((T, B), generator=g, device=dev) < 0.05
        p = p[:4] + (torch.maximum(p[3], trunc.float()),)
        err_path = max(err_path, check_gae(T, B, p, (p[3].bool(), p[4].bool()),
                                           " with bool terminated/dones panels"))
    gae_rows = {}
    for T, B in timed:
        p = kept[(T, B)]
        big = T * B > 10**6
        ms = cuda_ms(lambda: gae.gae(*p, gamma, lam), reps=20 if big else 200)
        dev_ms = device_ms(lambda: gae.gae(*p, gamma, lam), 10 if big else 50, "gae_kernel")
        # The plain version is a reverse Python loop of T steps.
        plain = cuda_ms(lambda: gae.gae_plain(*p, gamma, lam), reps=1 if big else 5, repeats=3 if big else 5)
        gae_bytes, gae_ops = 7 * T * B * 4, 10 * T * B
        bound = max(gae_bytes / HBM_BYTES_PER_S, gae_ops / F32_FLOP_PER_S) * 1e3
        share = f"{100 * bound / dev_ms:.1f}%" if dev_ms else "not measured"
        gae_rows[(T, B)] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound,
                                grid=gae.launch_shape(T, B))
        log("kernels", f"gae [{T},{B}]: call {ms:.4f} ms, device {dev_ms} ms, plain {plain:.4f} ms, "
                       f"bound {bound:.5f} ms (bytes {gae_bytes}), device time at {share} of the bound; "
                       f"grid {gae.launch_shape(T, B)}")
    T, B = 128, 1024
    gae_bytes, gae_ops = 7 * T * B * 4, 10 * T * B
    main_row = gae_rows[(T, B)]
    entries.append(dict(
        name="gae", route="cuda", source="imitation_tpu_torch/csrc/gae.cu",
        replaces="imitation_tpu/ops/gae_pallas.py:30", max_abs_err=err_path,
        **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms")},
        bound_by="bytes" if gae_bytes / HBM_BYTES_PER_S >= gae_ops / F32_FLOP_PER_S else "operations",
        library_ms=None, device_ms=main_row["device_ms"], shape=f"[{T}, {B}] f32 x5 -> x2",
        grid=main_row["grid"],
        airl_cli=dict(gae_rows[(256, 8)], shape="[256, 8] f32 x5 -> x2"),
        rlhf=dict(gae_rows[(64, 32)], shape="[64, 32] f32 x5 -> x2"),
        rlhf_cli=dict(gae_rows[(128, 8)], shape="[128, 8] f32 x5 -> x2"),
        density=dict(gae_rows[(64, 16)], shape="[64, 16] f32 x5 -> x2"),
        rlhf_pixel=dict(gae_rows[(32, 8)], shape="[32, 8] f32 x5 -> x2"),
        gail_cartpole=dict(gae_rows[(128, 64)], shape="[128, 64] f32 x5 -> x2"),
        dp_rank=dict(gae_rows[(128, 32)], shape="[128, 32] f32 x5 -> x2: one rank's columns of dp_gail's "
                                                "[128, 64] over 2 ranks, and of a dp row of tp_gail's 4 ranks "
                                                "(timed alone, not under the ranks)"),
        tutorials=dict(gae_rows[(64, 8)], shape="[64, 8] f32 x5 -> x2: the RLHF and density tutorials' and "
                                                "the RLHF example's PPO iterations"),
        custom_env=dict(gae_rows[(40, 16)], shape="[40, 16] f32 x5 -> x2: the custom-env tutorial's PPO"),
        halfcheetah=dict(gae_rows[(64, 64)], shape="[64, 64] f32 x5 -> x2: the GAIL rounds of seals/HalfCheetah, "
                                                   "gail_seals_hopper and gail_seals_swimmer"),
        walker=dict(gae_rows[(256, 64)], shape="[256, 64] f32 x5 -> x2: gail_seals_walker's round"),
        large=dict(gae_rows[(2048, 4096)], shape="[2048, 4096] f32 x5 -> x2"),
    ))

    # -- B2 disc-batch assembly: one launch for a disc step's fields ----------------
    def field(rows, trailing, dtype, offset=0):
        """[rows, *trailing] of ``dtype``; ``offset`` elements into a larger
        buffer, so the base is not aligned to the row when offset is odd."""
        n = rows * math.prod(trailing) + offset
        if dtype == torch.bool:
            flat = torch.rand((n,), generator=g, device=dev) < 0.5
        elif dtype.is_floating_point:
            flat = torch.randn((n,), generator=g, device=dev).to(dtype)
        else:
            flat = torch.randint(-100, 100, (n,), generator=g, device=dev).to(dtype)
        return flat[offset:].view((rows,) + tuple(trailing))

    def idx(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=torch.int32)

    errs = []  # max abs error of every assembled field

    def describe(kinds):
        return [(tuple(tr), str(dt).split(".")[-1], off) for tr, dt, off in kinds]

    def check_fused(name, n, c, b, kinds, spread=0):
        pairs = [(field(n, tr, dt, off), field(c, tr, dt, off)) for tr, dt, off in kinds]
        e = idx(b, -spread, n + spread) if spread else idx(b, 0, n)
        gi = idx(b, -spread, c + spread) if spread else idx(b, 0, c)
        outs = disc_assembly.assemble_fields(pairs, e, gi)
        for out, (d, gr) in zip(outs, pairs):
            want = disc_assembly.assemble_rows_plain(d, gr, e, gi)
            if out.dtype != want.dtype or not torch.equal(out, want):
                raise AssertionError(f"fused assembly disagrees with plain on {name}")
            if out.numel():
                errs.append((out.double() - want.double()).abs().max().item())
        log("kernels", f"assemble_fields {name} [{n}|{c}] B={b}, fields (row shape, dtype, offset) "
                       f"{describe(kinds)}: exact, one launch")
        return pairs, e, gi

    f32, i32 = torch.float32, torch.int32
    N, C, Bd = 12800, 131072, 2048  # demo rows, replay rows, demo_batch_size
    # GAIL CartPole: obs [., 4] f32, acts [.] int32, next_obs [., 4] f32, dones [.] f32.
    gail_kinds = (((4,), f32, 0), ((), i32, 0), ((4,), f32, 0), ((), f32, 0))
    # AIRL Pendulum: obs [., 3] f32 (12-byte rows: the word path), acts [., 1] f32,
    # next_obs [., 3] f32, dones [.] f32.
    airl_kinds = (((3,), f32, 0), ((1,), f32, 0), ((3,), f32, 0), ((), f32, 0))
    # Rows that are not whole words, and ranks above 2: the byte path.
    byte_kinds = (((2, 2), torch.uint8, 0), ((), torch.bool, 0), ((3,), torch.float16, 0),
                  ((2, 2), f32, 0))
    # Pixel CartPole's GAIL disc step: obs/next_obs [., 16, 16, 1] f32 (1,024-byte rows).
    pixel_kinds = (((16, 16, 1), f32, 0), ((), i32, 0), ((16, 16, 1), f32, 0), ((), f32, 0))
    # CarRacing-v3's uint8 frames [., 96, 96, 3] (27,648-byte rows), 2,048 demo
    # and replay rows, B = 1024: not on a main path.
    car_kinds = (((96, 96, 3), torch.uint8, 0), ((), i32, 0), ((96, 96, 3), torch.uint8, 0), ((), f32, 0))
    gail = check_fused("GAIL disc step", N, C, Bd, gail_kinds)
    pixel = check_fused("pixel GAIL disc step", N, C, Bd, pixel_kinds)
    car = check_fused("CarRacing-size uint8 rows (not on a main path)", 2048, 2048, 1024, car_kinds)
    airl = check_fused("AIRL disc step", N, C, Bd, airl_kinds)
    # The AIRL round at the CLI's defaults: 10 expert episodes of 200 rows, a
    # replay ring of 8 envs x 256 steps, demo batch 1024.
    airl_cli = check_fused("AIRL disc step at the CLI defaults", 2000, 2048, 1024, airl_kinds)
    byte = check_fused("byte path, disc-step size", N, C, Bd, byte_kinds)
    # train_adversarial gail with gail_cartpole: 10 scripted episodes of 500
    # rows, a replay ring of 64 envs x 128 steps, demo batch 1024.
    gail_cli = check_fused("GAIL disc step at gail_cartpole", 5000, 8192, 1024, gail_kinds)
    # GAIL at bench.py's main-path learner config over 64 host Pendulum-v1
    # envs: 64 scripted episodes of 200 rows, a replay ring of 512 rows, demo
    # batch 8192 (the AIRL Pendulum fields).
    host_gail = check_fused("GAIL disc step over host Pendulum", 12800, 512, 8192, airl_kinds)
    # GAIL at the same config over 64 seals/HalfCheetah-v1 envs: the 48
    # expert episodes (48,000 rows), obs/next_obs [., 18] f32 (72-byte rows),
    # acts [., 6] f32, dones [.] f32.
    hc_kinds = (((18,), f32, 0), ((6,), f32, 0), ((18,), f32, 0), ((), f32, 0))
    hc_gail = check_fused("GAIL disc step over seals/HalfCheetah", 48000, 512, 8192, hc_kinds)
    # The tuned GAIL configs of the other seals envs, each its expert
    # episodes, its replay ring and its demo batch: Hopper obs [., 12] f32
    # (48-byte rows: the uint4 path), acts [., 3]; Walker2d obs [., 18],
    # acts [., 6]; Swimmer obs [., 10] (40-byte rows), acts [., 2].
    seals_steps = {
        "hopper": ("GAIL disc step at gail_seals_hopper", 48000, 4096, 128, 12, 3),
        "walker": ("GAIL disc step at gail_seals_walker", 32000, 16384, 512, 18, 6),
        "swimmer": ("GAIL disc step at gail_seals_swimmer", 48000, 4096, 32, 10, 2),
    }
    seals_fused = {k: check_fused(what, n, c, b, (((o,), f32, 0), ((a,), f32, 0), ((o,), f32, 0), ((), f32, 0)))
                   for k, (what, n, c, b, o, a) in seals_steps.items()}
    # The GAIL and AIRL tutorials' and the quickstart's disc step: 24 scripted
    # CartPole episodes of 200 rows, a replay ring of 8 envs x 128 steps, demo
    # batch 256.
    tutorial = check_fused("GAIL disc step of the tutorials", 4800, 1024, 256, gail_kinds)
    for name, kinds, n, c, b, spread in (
        ("edge-1row", (((1,), f32, 0),), 5, 5, 1, 0),
        ("edge-out-of-range", (((3,), f32, 0),), 12, 9, 40, 30),
        ("edge-1d-out-of-range", (((), i32, 0),), 12, 9, 40, 30),
        ("edge-empty-rows beside a 1-D field", (((0,), f32, 0), ((), f32, 0)), 12, 9, 40, 30),
        ("F=3 word path", (((3,), f32, 0),), N, C, Bd, 0),
        ("1-D base offset by one element", (((), f32, 1),), N, C, Bd, 0),
        ("mixed: aligned F=4, F=3, offset 1-D, offset F=4",
         (((4,), f32, 0), ((3,), i32, 0), ((), f32, 1), ((4,), f32, 1)), 300, 700, 257, 40),
        ("byte path out of range: uint8 [., 2, 2], bool [.], f16 [., 3], f32 [., 2, 2]",
         byte_kinds, 12, 9, 40, 30),
        ("byte path mixed with words and offset bases",
         byte_kinds + (((4,), f32, 1), ((), torch.int64, 0), ((3,), torch.uint8, 1),
                       ((1,), torch.float64, 0)), 300, 700, 257, 40),
    ):
        check_fused(name, n, c, b, kinds, spread)

    gail_row = time_b2(torch, "kernels", "GAIL disc step (4 fields)", *gail, Bd)
    airl_row = time_b2(torch, "kernels", "AIRL disc step (4 fields)", *airl, Bd)
    byte_row = time_b2(torch, "kernels", "byte path (uint8 [., 2, 2], bool, f16 [., 3], f32 [., 2, 2])",
                       *byte, Bd)
    airl_cli_row = time_b2(torch, "kernels", "AIRL disc step at the CLI defaults (4 fields)", *airl_cli, 1024)
    gail_cli_row = time_b2(torch, "kernels", "GAIL disc step at gail_cartpole (4 fields)", *gail_cli, 1024)
    host_row = time_b2(torch, "kernels", "GAIL disc step over host Pendulum (4 fields)", *host_gail, 8192)
    hc_row = time_b2(torch, "kernels", "GAIL disc step over seals/HalfCheetah (4 fields)", *hc_gail, 8192)
    seals_rows = {k: time_b2(torch, "kernels", f"{seals_steps[k][0]} (4 fields)", *f, seals_steps[k][3])
                  for k, f in seals_fused.items()}
    del seals_fused
    tutorial_row = time_b2(torch, "kernels", "GAIL disc step of the tutorials (4 fields)", *tutorial, 256)
    pixel_row = time_b2(torch, "kernels", "pixel GAIL disc step (obs/next_obs [., 16, 16, 1] f32)", *pixel, Bd)
    car_row = time_b2(torch, "kernels", "CarRacing-size uint8 rows [., 96, 96, 3], not on a main path",
                      *car, 1024)
    del pixel, car
    dev_obs = device_ms(lambda: disc_assembly.assemble_rows(gail[0][0][0], gail[0][0][1], gail[1], gail[2]),
                        50, "assemble_fields_kernel")
    log("kernels", f"assemble_fields GAIL obs field alone: device {dev_obs} ms")
    entries.append(dict(
        name="assemble_rows", route="cuda", source="imitation_tpu_torch/csrc/disc_assembly.cu",
        replaces="imitation_tpu/ops/disc_assembly.py:36", max_abs_err=max(errs),
        **{k: gail_row[k] for k in ("ms", "plain_ms", "bound_ms")}, bound_by="bytes",
        library_ms=gail_row["library_ms"], device_ms=gail_row["device_ms"],
        library_device_ms=gail_row["library_device_ms"],
        shape=f"GAIL disc step, 4 fields in one launch: demo [{N}], replay [{C}], B={Bd}; "
              f"obs/next_obs [., 4] f32, acts [.] int32, dones [.] f32",
        grid={"ctas": -(-2 * Bd // 128), "threads": 128},
        airl_disc_step=dict(airl_row, shape="obs/next_obs [., 3] f32, acts [., 1] f32, dones [.] f32"),
        byte_path=dict(byte_row, shape="uint8 [., 2, 2], bool [.], f16 [., 3], f32 [., 2, 2]"),
        airl_cli=dict(airl_cli_row, shape="demo [2000], replay [2048], B=1024, the AIRL fields"),
        gail_cartpole=dict(gail_cli_row, shape="demo [5000], replay [8192], B=1024, the GAIL fields"),
        gail_host_pendulum=dict(host_row, shape="demo [12800], replay [512], B=8192; obs/next_obs [., 3] f32, "
                                                "acts [., 1] f32, dones [.] f32"),
        gail_seals_half_cheetah=dict(hc_row, shape="demo [48000], replay [512], B=8192; obs/next_obs [., 18] "
                                                    "f32, acts [., 6] f32, dones [.] f32"),
        **{f"gail_seals_{k}": dict(seals_rows[k], shape=f"demo [{n}], replay [{c}], B={b}; obs/next_obs [., {o}] "
                                                       f"f32, acts [., {a}] f32, dones [.] f32")
           for k, (_, n, c, b, o, a) in seals_steps.items()},
        tutorial_disc_step=dict(tutorial_row, shape="demo [4800], replay [1024], B=256, the GAIL fields: the GAIL "
                                                    "and AIRL tutorials' and the quickstart's disc step"),
        pixel_disc_step=dict(pixel_row, shape=f"demo [{N}], replay [{C}], B={Bd}; obs/next_obs "
                                              f"[., 16, 16, 1] f32, acts [.] int32, dones [.] f32"),
        carracing_rows=dict(car_row, main_path=False,
                            shape="demo [2048], replay [2048], B=1024; obs/next_obs [., 96, 96, 3] uint8, "
                                  "acts [.] int32, dones [.] f32"),
    ))
    return entries


def b2_bytes(pairs, b):
    """B2's least traffic: indices read once; each row read once and written once."""
    return 2 * b * 4 + sum(2 * 2 * b * d[0].numel() * d.element_size() for d, _ in pairs)


def time_b2(torch, phase, what, pairs, e, gi, b):
    """B2 on ``pairs`` timed beside its plain version, its bound and the
    yardstick of one ``index_select`` x 2 + ``cat`` per field."""
    from imitation_tpu_torch.ops import disc_assembly

    fused = lambda: disc_assembly.assemble_fields(pairs, e, gi)
    plain = lambda: [disc_assembly.assemble_rows_plain(d, gr, e, gi) for d, gr in pairs]
    yardstick = lambda: [torch.cat([torch.index_select(d, 0, e), torch.index_select(gr, 0, gi)])
                         for d, gr in pairs]  # one PyTorch call chain per field
    row = dict(ms=cuda_ms(fused, reps=200), plain_ms=cuda_ms(plain, reps=100),
               library_ms=cuda_ms(yardstick, reps=200),
               device_ms=device_ms(fused, 50, "assemble_fields_kernel"),
               library_device_ms=device_ms(yardstick, 50, ""),
               bound_ms=b2_bytes(pairs, b) / HBM_BYTES_PER_S * 1e3, bytes=b2_bytes(pairs, b))
    log(phase, f"assemble_fields {what} ({row['bytes']} bytes, grid {-(-2 * b // 128)} x 128): "
               f"call {row['ms']:.4f} ms, device {row['device_ms']} ms, plain {row['plain_ms']:.4f} ms, "
               f"{len(pairs)} x (index_select+index_select+cat) call {row['library_ms']:.4f} ms "
               f"device {row['library_device_ms']} ms, bound {row['bound_ms']:.6f} ms")
    return row


def run_envs(torch, dev, n=1024, steps=200):
    """Each newly registered env on the card: one step from the same states
    and actions as on the CPU, then ``steps`` steps under the scripted expert
    (random actions where there is none)."""
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.testing import experts

    tols = {"Pendulum": 1e-6, "MountainCar": 1e-6, "MountainCarContinuous": 1e-6, "Acrobot": 1e-5}
    for name in ("Pendulum-v1", "MountainCar-v0", "MountainCarContinuous-v0", "Acrobot-v1",
                 "seals/MountainCar-v0", "seals/Pendulum-v0"):
        t0 = time.perf_counter()
        venv = make_vec_env(name, num_envs=n, device=dev)
        env, space, horizon = venv.env, venv.action_space, venv.max_episode_steps
        g = torch.Generator(device=dev).manual_seed(0)

        def random_actions():
            if space.is_discrete:
                return torch.randint(0, space.n, (n,), generator=g, device=dev, dtype=torch.int32)
            lo, hi = float(space.low.min()), float(space.high.max())
            return lo + (hi - lo) * torch.rand((n,) + space.shape, generator=g, device=dev)

        state = venv.reset(g)
        acts = random_actions()
        new, ts = env.step(state.env_state, acts)
        new_c, ts_c = env.step(state.env_state.cpu(), acts.cpu())
        tol = tols[type(env).__name__]
        err = max((new.cpu() - new_c).abs().max().item(), (ts.obs.cpu() - ts_c.obs).abs().max().item(),
                  (ts.reward.cpu() - ts_c.reward).abs().max().item())
        if not (torch.allclose(new.cpu(), new_c, rtol=tol, atol=tol)
                and torch.allclose(ts.obs.cpu(), ts_c.obs, rtol=tol, atol=tol)
                and torch.allclose(ts.reward.cpu(), ts_c.reward, rtol=tol, atol=tol)
                and torch.equal(ts.terminated.cpu(), ts_c.terminated)):
            raise AssertionError(f"{name}: the card's step disagrees with the CPU's ({err})")
        expert = experts.EXPERTS.get(name)
        n_trunc, n_term, expected = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3))
        finite = torch.ones((), dtype=torch.bool, device=dev)
        returns = []
        for _ in range(steps):
            acts = expert(state.obs)[0] if expert is not None else random_actions()
            state, out = venv.step(state, acts)
            finite &= torch.isfinite(out.obs).all() & torch.isfinite(out.reward).all()
            n_trunc += out.truncated.sum()
            n_term += out.terminated.sum()
            expected += ((out.episode_length == horizon) & ~out.terminated).sum()
            returns.append(torch.where(out.done, out.episode_return, torch.nan))
        n_trunc, n_term, expected = n_trunc.item(), n_term.item(), expected.item()
        ret = torch.stack(returns)
        ret_mean = ret[~torch.isnan(ret)].mean().item() if (~torch.isnan(ret)).any() else float("nan")
        log("envs", f"{name} x{n}: step vs CPU max abs diff {err:.3g} (allclose {tol:g}); "
                    f"{steps} steps under {'the scripted expert' if expert else 'random actions'}: "
                    f"{n_term} terminations, {n_trunc} truncations (horizon {horizon}), "
                    f"episode return mean {ret_mean:.4g}, {time.perf_counter() - t0:.2f} s")
        if not bool(finite):
            raise AssertionError(f"{name}: non-finite observations or rewards")
        if n_trunc != expected:
            raise AssertionError(f"{name}: {n_trunc} truncations, expected {expected}")
        if horizon <= steps and name in ("Pendulum-v1", "seals/Pendulum-v0", "seals/MountainCar-v0") \
                and n_trunc != n * (steps // horizon):
            raise AssertionError(f"{name}: every env should truncate at its horizon")


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


def counts():
    """The kernels' launch counts, by the names of the ``kernels`` line."""
    from imitation_tpu_torch.ops import disc_assembly, gae

    return {"gae": gae.gae.launches, "assemble_rows": disc_assembly.assemble_fields.launches}


def zero_counts() -> None:
    from imitation_tpu_torch.ops import disc_assembly, gae

    gae.gae.launches = 0
    disc_assembly.assemble_fields.launches = 0


def make_logger():
    """A port logger that keeps every row it dumps (``logger.rows``)."""
    from imitation_tpu_torch.util.logger import KVWriter, configure

    class Capture(KVWriter):
        def __init__(self):
            self.rows = []

        def write(self, kvs, step):
            self.rows.append(dict(kvs))

    logger = configure(format_strs=())
    capture = Capture()
    logger.default_logger.output_formats.append(capture)
    logger.rows = capture.rows
    return logger


def expert_demos(torch, phase, env_name, num_envs, min_episodes, dev, **venv_kw):
    from imitation_tpu_torch.data.rollout import rollout_stats
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.testing import experts

    t0 = time.perf_counter()
    demo_venv = make_vec_env(env_name, num_envs=num_envs, device=dev, **venv_kw)
    demos = experts.generate_expert_trajectories(env_name, demo_venv, min_episodes=min_episodes, seed=0)
    stats = rollout_stats(demos)
    log(phase, f"expert demos: {stats['n_traj']} episodes, {sum(len(d) for d in demos)} rows, "
               f"return mean {stats['return_mean']:.6g} (min {stats['return_min']:.6g}) "
               f"in {time.perf_counter() - t0:.2f} s")
    return demos, stats


def train_rounds(torch, phase, trainer, rounds, fused=False):
    """``rounds`` rounds of ``train`` (or of ``train_fused`` with
    ``rounds_per_sync=rounds``) with the launch counts set to 0 just before
    and read just after: B2 must launch once per disc step, and GAE once per
    round with a PPO generator and never with a SAC one. Returns (launches,
    seconds per round)."""
    from imitation_tpu_torch.rl.sac import SAC

    sac = isinstance(trainer.gen_algo, SAC)
    round_ends = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    if fused:
        trainer.train_fused(rounds * trainer.gen_train_timesteps, rounds_per_sync=rounds)
    else:
        trainer.train(rounds * trainer.gen_train_timesteps,
                      callback=lambda r: round_ends.append(time.perf_counter()))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = counts()
    if fused:
        times = f"{elapsed / rounds:.3f} s per round, one host read"
    else:
        per_round = [round_ends[0] - t0] + [b - a for a, b in zip(round_ends, round_ends[1:])]
        times = f"{', '.join(f'{x:.3f}' for x in per_round)} s per round"
    log(phase, f"{rounds} rounds of {'train_fused' if fused else 'train'} in {elapsed:.3f} s "
               f"({times}; {trainer.gen_train_timesteps} env steps each); launches {launches}")
    gen_keys, losses = ((("critic_loss", "actor_loss", "alpha", "ep_return_mean"), ("critic_loss", "actor_loss"))
                        if sac else (("loss", "ep_return_mean", "true_rew_mean", "relabeled_rew_mean"),
                                     ("loss", "value_loss")))
    for row in trainer.logger.rows[-(1 if fused else rounds):]:
        log(phase, "logged: " + ", ".join(
            f"{k.split('/')[-1]} {row[k]:.4g}" for k in [f"mean/gen/{k}" for k in gen_keys] + [
                "mean/disc/disc_loss", "mean/disc/disc_acc", "mean/disc/disc_acc_expert",
                "mean/disc/disc_acc_gen"]))
        bad = [k for k in [f"mean/gen/{k}" for k in losses] + ["mean/disc/disc_loss"]
               if not math.isfinite(row[k])]
        if bad:
            raise AssertionError(f"{phase}: non-finite losses: {bad}")
    params = list(trainer.policy.parameters()) + list(trainer.reward_net.parameters())
    if sac:
        params += list(trainer.gen_algo.critic.parameters())
    if not all(bool(torch.isfinite(p).all()) for p in params):
        raise AssertionError(f"{phase}: non-finite parameters after training")
    want = {"gae": 0 if sac else rounds, "assemble_rows": rounds * trainer.n_disc_updates_per_round}
    if any(launches[k] <= 0 for k, n in want.items() if n):
        raise AssertionError(f"{phase}: a kernel of the path was not launched: {launches}")
    if launches != want:  # B2 once per disc step; GAE once per PPO round
        raise AssertionError(f"{phase}: launches {launches}, expected {want}")
    return launches, elapsed / rounds


def reward_cpu_check(torch, phase, trainer, fn_name="reward_train_fn"):
    """The reward the generator trains on, on the card and on a CPU copy of
    the net, over 4096 replay rows; returns the card's values."""
    data = trainer._gen_buffer_state.data
    batch = [x[:4096] for x in (data.obs, data.acts, data.next_obs, data.dones)]
    cpu_net = copy.deepcopy(trainer.reward_net).cpu()
    fn = getattr(trainer, fn_name)()
    with torch.no_grad():
        got = fn(trainer.reward_net, *batch)
        want = fn(cpu_net, *(x.cpu() for x in batch))
    err = (got.cpu() - want).abs().max().item()
    log("reference", f"{phase} {fn_name} GPU vs CPU forward on {batch[0].shape[0]} replay rows: "
                     f"max abs diff {err:.3g}")
    if err > 1e-4:
        raise AssertionError(f"{phase}: GPU reward forward disagrees with the CPU one")
    return got


def run_gail(torch, dev, num_envs=1024, n_steps=128, demo_batch_size=2048):
    from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.rl.ppo import PPOConfig

    demos, stats = expert_demos(torch, "gail", "CartPole-v1", 64, 64, dev, max_episode_steps=100)
    if stats["return_min"] != 100.0:
        raise AssertionError("the scripted expert should balance every 100-step episode")
    venv = make_vec_env("CartPole-v1", num_envs=num_envs, max_episode_steps=500, device=dev)
    trainer = GAIL(
        demonstrations=demos,
        demo_batch_size=demo_batch_size,
        venv=venv,
        gen_config=PPOConfig(n_steps=n_steps, n_minibatches=32, n_epochs=5),
        n_disc_updates_per_round=2,
        allow_variable_horizon=True,
        custom_logger=make_logger(),
        seed=0,
    )
    t0 = time.perf_counter()
    trainer.train(trainer.gen_train_timesteps)
    torch.cuda.synchronize()
    log("gail", f"warm-up round {time.perf_counter() - t0:.3f} s")
    launches, s_per_round = train_rounds(torch, "gail", trainer, 2)
    reward_cpu_check(torch, "gail", trainer)
    profile_round(torch, "gail", trainer, s_per_round)
    return {"gail": launches}, s_per_round


def run_airl(torch, dev, num_envs=1024, n_steps=128, demo_batch_size=2048):
    """AIRL on device Pendulum-v1 at the GAIL headline widths (``train`` and
    ``train_fused``, each with its launches counted), then one round at the
    JAX CLI's defaults (scripts/train_adversarial.py)."""
    from imitation_tpu_torch.algorithms.adversarial.airl import AIRL
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.rl.ppo import PPOConfig

    demos, stats = expert_demos(torch, "airl", "Pendulum-v1", 64, 64, dev)
    rows = sum(len(d) for d in demos)
    if stats["n_traj"] != 64 or rows != 12800 or not stats["return_mean"] > -400:
        raise AssertionError(f"expected 64 expert episodes of 200 steps scoring above -400: {stats}")
    def make_trainer():
        return AIRL(
            demonstrations=demos,
            demo_batch_size=demo_batch_size,
            venv=make_vec_env("Pendulum-v1", num_envs=num_envs, device=dev),
            gen_config=PPOConfig(n_steps=n_steps, n_minibatches=32, n_epochs=5),
            n_disc_updates_per_round=2,
            custom_logger=make_logger(),
            seed=0,
        )

    trainer = make_trainer()
    t0 = time.perf_counter()
    trainer.train(trainer.gen_train_timesteps)
    torch.cuda.synchronize()
    log("airl", f"warm-up round {time.perf_counter() - t0:.3f} s; the replay ring's acts "
                f"{tuple(trainer._gen_buffer_state.data.acts.shape)} "
                f"{str(trainer._gen_buffer_state.data.acts.dtype)}, demo acts "
                f"{tuple(trainer._demo_store.batch.acts.shape)}")
    launches = {}
    launches["airl"], s_round = train_rounds(torch, "airl", trainer, 2)
    # train_fused on a fresh trainer, as a user calls it: its replay ring is
    # sized from _example_transitions before the first round, on the card.
    fused = make_trainer()
    launches["airl_fused"], s_fused = train_rounds(torch, "airl", fused, 2, fused=True)
    ring, demo = fused._gen_buffer_state.data, fused._demo_store.batch
    log("airl", f"train_fused's ring: obs {tuple(ring.obs.shape)}, acts {tuple(ring.acts.shape)} "
                f"{str(ring.acts.dtype)}; demo acts {tuple(demo.acts.shape)} {str(demo.acts.dtype)}")
    if ring.acts.shape[1:] != demo.acts.shape[1:] or ring.acts.dtype != demo.acts.dtype:
        raise AssertionError("train_fused's replay ring does not match the demos' fields")

    train = reward_cpu_check(torch, "airl", trainer)
    test = reward_cpu_check(torch, "airl", trainer, "reward_test_fn")
    diff = (train - test).abs().max().item()
    log("airl", f"reward_test_fn (the base net) vs reward_train_fn (shaped) on 4096 replay rows: "
                f"max abs diff {diff:.4g}")
    if not diff > 0:
        raise AssertionError("AIRL's test reward should strip the potential shaping")
    profile_round(torch, "airl", trainer, s_round)

    # One round at the CLI's defaults: 8 envs x 256 steps, batch 64 (32
    # minibatches), 5 epochs, demo batch 1024, 4 disc updates, 10 expert episodes.
    cli_demos, _ = expert_demos(torch, "airl", "Pendulum-v1", 8, 10, dev)
    cli = AIRL(
        demonstrations=cli_demos[:10],  # the CLI's n_expert_demos
        demo_batch_size=1024,
        venv=make_vec_env("Pendulum-v1", num_envs=8, device=dev),
        gen_config=PPOConfig(n_steps=256, n_minibatches=32, n_epochs=5),
        n_disc_updates_per_round=4,
        custom_logger=make_logger(),
        seed=0,
    )
    launches["airl_cli"], s_cli = train_rounds(torch, "airl", cli, 1)
    return launches, s_round, s_fused


def run_rl(torch, dev, num_envs=1024, n_steps=128, iterations=2):
    """``PPO.learn`` on device Pendulum-v1 with the linear learning rate."""
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.models.policies import ActorCriticPolicy
    from imitation_tpu_torch.rl.ppo import PPO, PPOConfig

    venv = make_vec_env("Pendulum-v1", num_envs=num_envs, device=dev)
    cfg = PPOConfig(n_steps=n_steps, n_minibatches=32, n_epochs=5, lr_schedule="linear",
                    total_updates_hint=2 * iterations)
    ppo = PPO(venv, ActorCriticPolicy(venv.observation_space, venv.action_space), cfg, seed=0)
    state = ppo.init_state()
    ppo.train_step(state)  # warm-up iteration (also the first scheduled one)
    torch.cuda.synchronize()
    lrs = []

    def callback(s, metrics):
        lrs.append(s.optimizer.learning_rate)
        log("rl", f"iteration at {s.timesteps} steps: learning rate now {lrs[-1]:.6g}, "
                  f"loss {metrics['loss']:.4g}, ep_return_mean {metrics['ep_return_mean']:.4g}")
        if not math.isfinite(metrics["loss"]):
            raise AssertionError("rl: non-finite PPO loss")

    zero_counts()
    t0 = time.perf_counter()
    state = ppo.learn(state, iterations * n_steps * num_envs, callback=callback)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = counts()
    per_call = cfg.n_epochs * cfg.n_minibatches
    want_lr = [cfg.learning_rate * (1 - (k + 2) * per_call / (cfg.total_updates_hint * per_call))
               for k in range(iterations)]
    log("rl", f"PPO.learn: {iterations} iterations in {elapsed:.3f} s; launches {launches}; "
              f"learning rates {lrs} (linear to 0 over {cfg.total_updates_hint} iterations: {want_lr})")
    if launches["gae"] != iterations:
        raise AssertionError(f"rl: {launches['gae']} GAE launches for {iterations} iterations")
    if any(abs(a - b) > 1e-9 for a, b in zip(lrs, want_lr)) or len(lrs) != iterations:
        raise AssertionError(f"rl: learning rates {lrs}, expected {want_lr}")
    return {"rl": launches}


def eval_returns(torch, policy, venv, seed):
    """Mean return of the first 64 episodes the policy samples on ``venv``
    (64 envs), as BC's ``log_rollouts_venv`` evaluation rolls out."""
    from imitation_tpu_torch.data import rollout

    trajs = rollout.generate_trajectories(policy.sample_fn(), venv, rollout.make_min_episodes(64), rng=seed)
    return float(sum(t.rews.sum() for t in trajs[:64]) / 64)


def demo_metrics(torch, bc, policy=None):
    """BC's metrics (``BCTrainingMetrics`` names) of ``policy`` (default
    the trainer's) on all of the trainer's demos, in one forward."""
    from imitation_tpu_torch.algorithms.bc import METRIC_NAMES, loss_calculator

    fn = bc.loss_fn if policy is None else loss_calculator(policy, bc.ent_weight, bc.l2_weight)
    batch = bc._demo_store.batch
    with torch.no_grad():
        _, m = fn(batch.obs, batch.acts)
    return dict(zip(METRIC_NAMES, m.cpu().tolist()))


def count_syncs(torch, fn):
    """Runs ``fn()`` under ``torch.cuda``'s sync debug mode; returns its
    result and the ``file:line`` of each synchronizing CUDA call it saw."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                 if "synchronizing" in str(w.message)]


def timed_epochs(torch, phase, bc, **train_kw):
    """``bc.train(**train_kw)`` timed, with its host reads counted by the
    trainer and, as a cross-check, the synchronizing CUDA calls that
    ``torch.cuda``'s sync debug mode reports. Returns seconds."""
    epochs = train_kw["n_epochs"]
    reads0, batches0 = bc.host_reads, bc.num_batches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, sites = count_syncs(torch, lambda: bc.train(**train_kw))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    steps, reads = bc.num_batches - batches0, bc.host_reads - reads0
    log(phase, f"BC {epochs} epoch(s) at batch {bc.batch_size} (minibatch {bc.minibatch_size}): "
               f"{steps} steps in {secs:.3f} s = {secs / epochs:.3f} s per epoch, "
               f"{steps / secs:.1f} steps/s; host reads {reads} ({reads / epochs:g} per epoch); "
               f"sync debug mode saw {len(sites)} synchronizing calls, at {sorted(set(sites))}")
    if reads != epochs:
        raise AssertionError(f"{phase}: {reads} host reads in {epochs} epochs, expected one per epoch")
    return secs


def profile_bc(torch, phase, bc, n=50):
    """``n`` more BC steps under torch.profiler: kernels and kernel time
    per step against the profiled wall time per step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bc.train(n_batches=n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name = kernel_times(prof)
    count = sum(c for c, _ in per_name.values())
    busy = sum(us for _, us in per_name.values())
    log(phase, f"{n} BC steps under torch.profiler: {count / n:.1f} kernels and {busy / n:.1f} us of "
               f"kernel time per step, {1e3 * wall / n:.3f} ms of wall per step (profiled), "
               f"busy {100 * busy / 1e6 / wall:.1f}%")
    for name, (c, us) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(phase, f"  x{c / n:<5.1f} per step {us / c:7.2f} us each  {name[:80]}")


def check_learned(phase, before, after):
    log(phase, "demo metrics before -> after: " + ", ".join(
        f"{k} {before[k]:.4g} -> {after[k]:.4g}" for k in ("loss", "neglogp", "prob_true_act", "l2_norm")))
    if not all(math.isfinite(v) for v in list(before.values()) + list(after.values())):
        raise AssertionError(f"{phase}: non-finite BC metrics")
    if not after["prob_true_act"] > before["prob_true_act"]:
        raise AssertionError(f"{phase}: prob_true_act on the demos did not rise")


def run_bc(torch, dev, env_name, phase, demo_kw, bc_kw, epochs, accumulate=None):
    """BC through ``BC.train`` on device demos of the scripted expert, with
    a (32, 32) tanh policy with feature normalization; returns before and
    after, each the mean of 64 episodes on 64 device envs."""
    from imitation_tpu_torch.algorithms.bc import BC
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.models.policies import FeedForward32Policy

    demos, _ = expert_demos(torch, phase, env_name, 64, 64, dev, **demo_kw)
    eval_venv = make_vec_env(env_name, num_envs=64, device=dev)
    space = eval_venv.observation_space, eval_venv.action_space

    def make_bc(**kw):
        return BC(observation_space=space[0], action_space=space[1], demonstrations=demos,
                  policy=FeedForward32Policy(*space, normalize_features=True), rng=0,
                  custom_logger=make_logger(), device=dev, **kw)

    bc = make_bc(**bc_kw)
    ret0 = eval_returns(torch, bc.policy, eval_venv, seed=1)
    before = demo_metrics(torch, bc)
    timed_epochs(torch, phase, bc, n_epochs=epochs)
    after = demo_metrics(torch, bc)
    ret1 = eval_returns(torch, bc.policy, eval_venv, seed=2)
    log(phase, f"{bc._demo_store.num_samples} demo rows; return over 64 episodes before {ret0:.4g}, "
               f"after {ret1:.4g}")
    for row in bc.logger.rows:
        log(phase, f"logged at batch {row['mean/bc/batch']}: loss {row['mean/bc/loss']:.4g}, "
                   f"prob_true_act {row['mean/bc/prob_true_act']:.4g}")
    check_learned(phase, before, after)
    if not all(bool(torch.isfinite(p).all()) for p in bc.policy.parameters()):
        raise AssertionError(f"{phase}: non-finite parameters after training")
    profile_bc(torch, phase, bc)
    if accumulate is not None:
        acc = make_bc(**dict(bc_kw, **accumulate))
        before = demo_metrics(torch, acc)
        timed_epochs(torch, phase, acc, n_epochs=1)
        check_learned(phase, before, demo_metrics(torch, acc))


def run_dagger(torch, dev, env_name, phase, schedule, total_timesteps, host=False, bc_epochs=2, **venv_kw):
    """``SimpleDAggerTrainer.train`` on 16 device envs (with ``host``, 16
    host envs of the C++ engine), made with ``venv_kw``, with the scripted
    expert and ``bc_epochs`` BC epochs a round, then ``save_trainer``,
    ``reconstruct_trainer`` and one more round of the rebuilt trainer."""
    import tempfile

    import numpy as np

    from imitation_tpu_torch.algorithms import dagger
    from imitation_tpu_torch.algorithms.bc import BC
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.models.policies import FeedForward32Policy
    from imitation_tpu_torch.native import CppVectorEnv
    from imitation_tpu_torch.testing import experts

    if host:
        venv = CppVectorEnv(env_name, num_envs=16, seed=0, device=dev, **venv_kw)
    else:
        venv = make_vec_env(env_name, num_envs=16, device=dev, **venv_kw)
    eval_venv = make_vec_env(env_name, num_envs=64, device=dev)
    space = venv.observation_space, venv.action_space
    expert = experts.expert_for(env_name)

    def check_demos(trainer):
        for t in trainer._all_demos:
            # Copies: the loaded demos are read-only views of their Arrow file.
            want, _ = expert(torch.as_tensor(np.array(t.obs[:-1]), device=dev))
            if not torch.equal(torch.as_tensor(np.array(t.acts), device=dev), want):
                raise AssertionError(f"{phase}: a saved demo's actions are not the expert's")

    def drive(trainer, total, what):
        """Rounds of ``trainer.train(total)``, each split into collection and
        BC (``extend_and_update``), with its demo rows and beta."""
        rounds, bc_secs = [], []
        extend = trainer.extend_and_update

        def timed_extend(kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = extend(kwargs)
            torch.cuda.synchronize()
            bc_secs.append(time.perf_counter() - t)
            return out

        trainer.extend_and_update = timed_extend
        reads0, batches0 = trainer.bc_trainer.host_reads, trainer.bc_trainer.num_batches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks = [t0]

        def on_round_end(r, n):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            rounds.append((trainer.round_num, n, trainer.bc_trainer._demo_store.num_samples))

        trainer.train(total, rollout_round_min_episodes=3, rollout_round_min_timesteps=500,
                      bc_train_kwargs=dict(n_epochs=bc_epochs), on_round_end=on_round_end)
        del trainer.extend_and_update
        epochs = bc_epochs * len(rounds)
        reads = trainer.bc_trainer.host_reads - reads0
        for i, (r, n, rows) in enumerate(rounds):
            secs = marks[i + 1] - marks[i]
            log(phase, f"{what} round {r - 1} (beta {trainer.beta_schedule(r - 1):.4g}): {secs:.3f} s = "
                       f"collection {secs - bc_secs[i]:.3f} s + BC {bc_secs[i]:.3f} s; "
                       f"{n} env steps collected in this call, {rows} demo rows now")
        steps = trainer.bc_trainer.num_batches - batches0
        log(phase, f"{what}: {len(rounds)} round(s), {steps} BC steps ({steps / sum(bc_secs):.1f} steps/s "
                   f"inside BC, evaluations included), host reads {reads} ({reads / epochs:g} per epoch)")
        if reads != epochs:
            raise AssertionError(f"{phase}: {reads} host reads in {epochs} epochs")
        for row in trainer.logger.rows:
            if "mean/bc/loss" in row and not math.isfinite(row["mean/bc/loss"]):
                raise AssertionError(f"{phase}: non-finite BC loss")
        check_demos(trainer)

    bc = BC(observation_space=space[0], action_space=space[1],
            policy=FeedForward32Policy(*space, normalize_features=True), rng=0, batch_size=16,
            l2_weight=1e-4, optimizer_kwargs=dict(learning_rate=1e-3), custom_logger=make_logger(),
            device=dev)
    with tempfile.TemporaryDirectory(prefix="dagger_smoke_") as scratch:
        trainer = dagger.SimpleDAggerTrainer(venv=venv, scratch_dir=scratch, expert_policy_apply=expert,
                                             rng=0, beta_schedule=schedule, bc_trainer=bc,
                                             custom_logger=make_logger())
        # CartPole-v1 ends an episode when the pole falls, so its lengths
        # vary once the robot steps (Pendulum's are all 200).
        trainer.allow_variable_horizon = True
        init_policy = copy.deepcopy(trainer.policy)
        ret0 = eval_returns(torch, trainer.policy, eval_venv, seed=1)
        drive(trainer, total_timesteps, "train")
        check_learned(phase, demo_metrics(torch, trainer.bc_trainer, init_policy),
                      demo_metrics(torch, trainer.bc_trainer))
        t0 = time.perf_counter()
        ckpt, policy_path = trainer.save_trainer()
        loaded = dagger.reconstruct_trainer(scratch, venv, make_logger())
        saved = trainer.policy.state_dict()
        same = all(torch.equal(v, saved[k]) for k, v in loaded.policy.state_dict().items())
        log(phase, f"save_trainer + reconstruct_trainer {time.perf_counter() - t0:.3f} s "
                   f"({ckpt.name}, {policy_path.name}): round {loaded.round_num}, "
                   f"{len(loaded._all_demos)} demos, policy equal to the saved one: {same}")
        if not same or type(loaded) is not type(trainer) or loaded.round_num != trainer.round_num:
            raise AssertionError(f"{phase}: the reconstructed trainer differs from the saved one")
        drive(loaded, 1, "reconstructed")
        ret1 = eval_returns(torch, loaded.policy, eval_venv, seed=2)
    log(phase, f"return over 64 episodes before {ret0:.4g}, after {ret1:.4g}")


def profile_ranges(torch, fn, phases):
    """``fn()`` under torch.profiler, split by the port's own
    ``record_function`` ranges ``phases``: host microseconds of each, and
    the count and device microseconds of the kernels that ran inside each
    range's device span (None where the trace has no device spans). Returns
    (host, device, {kernel: (count, us)}, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host, dev = split_ranges(prof, phases)
    return host, dev, kernel_times(prof), wall


def split_ranges(prof, phases):
    """The host microseconds of each of the port's ``record_function``
    ranges ``phases`` in a torch.profiler trace, and the count and device
    microseconds of the kernels that ran inside each range's device span
    (None where the trace has no device spans)."""
    from torch.autograd import DeviceType

    host, spans, kernels = {p: 0.0 for p in phases}, [], []
    for e in raw_events(prof):
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name in phases:
                host[name] += e.duration_ns() / 1e3
        elif e.is_user_annotation():
            if name in phases:
                spans.append((e.start_ns(), e.end_ns(), name))
        else:
            kernels.append((e.start_ns(), e.duration_ns() / 1e3))
    dev = {p: [0, 0.0] for p in phases}
    for start, us in kernels:
        for lo, hi, name in spans:
            if lo <= start < hi:
                dev[name][0] += 1
                dev[name][1] += us
                break
    return host, dev if spans else None


def profile_round(torch, phase, trainer, s_per_round):
    """One more round under torch.profiler. Splits it by the port's own
    ``record_function`` ranges, named for the algorithm (``gail.disc_step``,
    ``airl.disc_step``, ...): host time of each, and the device time of the
    kernels that ran inside each range's device span. Busy share is kernel
    time over an unprofiled round (``s_per_round``), since the profiler slows
    the host loop down."""
    algo = trainer._range  # "gail", "airl": the trainer's own range prefix
    phases = ("ppo.collect", "ppo.process_chunk", f"{algo}.buffer_store", f"{algo}.disc_step",
              f"{algo}.metrics_to_host")
    host, dev, per_name, wall = profile_ranges(
        torch, lambda: trainer.train(trainer.gen_train_timesteps), phases)
    log("profile", f"one {phase} round by phase (host ms / kernel ms): " + ", ".join(
        f"{p} {host[p] / 1e3:.1f} / " + (f"{dev[p][1] / 1e3:.2f}" if dev else "not measured")
        for p in phases))
    busy = sum(t for _, t in per_name.values()) / 1e6
    n = sum(c for c, _ in per_name.values())
    log("profile", f"{phase}: kernel time {busy:.4f} s, {n} kernels = {100 * busy / s_per_round:.1f}% "
                   f"of an unprofiled round ({s_per_round:.3f} s); the profiled round took "
                   f"{wall:.3f} s ({wall / s_per_round:.2f}x)")
    for name, (count, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log("profile", f"  {us / 1e3:9.3f} ms  x{count:<6} {name[:90]}")


def finite_metrics(torch, phase, metrics, keys):
    """Reads ``metrics`` (device tensors) once and raises on a non-finite ``keys`` entry."""
    from imitation_tpu_torch.rl.common import metrics_to_host

    host = {k: float(v) for k, v in metrics_to_host(metrics).items()}
    bad = [k for k in keys if not math.isfinite(host[k])]
    if bad:
        raise AssertionError(f"{phase}: non-finite {bad}: {host}")
    return host


def run_sac(torch, dev, num_envs=16, masked_rounds=3, rounds=3):
    """``SAC.learn`` on device Pendulum-v1 at the expert-training settings
    (benchmarking/train_experts.py:200-212, the PEBBLE generator of
    benchmarking/run_rlhf.py:69): 16 envs, train_freq 16, 256 gradient steps
    of batch 256 a round, (256, 256) actor and critics, lr 3e-4;
    ``learning_starts`` cut from 10,000 to 768, so ``masked_rounds``
    rounds store 768 rows with masked updates before ``rounds`` rounds
    learn (1,536 rows in all). The learning rounds run with the CUDA sync debug mode on and
    must make no host read (nothing is logged)."""
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.rl.sac import SAC, SACConfig

    phase = "sac_pendulum"
    venv = make_vec_env("Pendulum-v1", num_envs=num_envs, device=dev)
    rows = 16 * num_envs
    cfg = SACConfig(train_freq=16, gradient_steps=256, batch_size=256,
                    learning_starts=masked_rounds * rows, learning_rate=3e-4)
    sac = SAC(venv, cfg, seed=0)
    state = sac.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = sac.learn(state, masked_rounds * rows)
    torch.cuda.synchronize()
    masked_s = (time.perf_counter() - t0) / masked_rounds
    if state.buffer_state.size != cfg.learning_starts or state.actor_opt.count != masked_rounds * 256:
        raise AssertionError(f"{phase}: {state.buffer_state.size} rows and {state.actor_opt.count} "
                             f"masked updates before learning")
    metrics = []
    t0 = time.perf_counter()
    state, sites = count_syncs(torch, lambda: sac.learn(state, rounds * rows,
                                                        callback=lambda s, m: metrics.append(m)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_updates = rounds * cfg.gradient_steps
    log(phase, f"{masked_rounds} masked rounds (losses only, no gradients) {masked_s:.3f} s each; "
               f"{rounds} learning rounds in {secs:.3f} s = {secs / rounds:.3f} s per round, "
               f"{n_updates / secs:.1f} updates/s, {rounds * rows / secs:.1f} env steps/s; "
               f"host reads {len(sites)} ({len(sites) / rounds:g} per round) at {sorted(set(sites))}")
    if sites:
        raise AssertionError(f"{phase}: SAC.learn read the device {len(sites)} times without logging")
    for i, m in enumerate(metrics):
        host = finite_metrics(torch, phase, m, ("critic_loss", "actor_loss", "alpha", "q_mean", "entropy"))
        log(phase, f"round {masked_rounds + i + 1}: " + ", ".join(
            f"{k} {host[k]:.4g}" for k in ("critic_loss", "actor_loss", "alpha", "q_mean", "entropy",
                                           "ep_return_mean", "buffer_size")))
    params = [*sac.actor.parameters(), *sac.critic.parameters(), *sac.target_critic.parameters()]
    if not all(bool(torch.isfinite(p).all()) for p in params):
        raise AssertionError(f"{phase}: non-finite parameters after training")

    # The actor's forward on the card against a CPU copy, on 4096 replay rows.
    obs = state.buffer_state.data.obs[:min(4096, state.buffer_state.size)]
    cpu_actor = copy.deepcopy(sac.actor).cpu()
    with torch.no_grad():
        got, want = sac.actor(obs), cpu_actor(obs.cpu())
    err = max((got.mean.cpu() - want.mean).abs().max().item(),
              (got.log_std.cpu() - want.log_std).abs().max().item())
    log("reference", f"{phase} actor GPU vs CPU forward on {obs.shape[0]} replay rows: "
                     f"max abs diff of mean and log_std {err:.3g}")
    if err > 1e-4:
        raise AssertionError(f"{phase}: the actor's forward on the card disagrees with the CPU's")

    # One more round under torch.profiler, split by the port's ranges.
    held = [state]

    def one_round():
        held[0] = sac.train_step(held[0])[0]

    phases = ("sac.collect", "sac.buffer_store", "sac.update")
    host, dev_t, per_name, wall = profile_ranges(torch, one_round, phases)
    log("profile", f"one {phase} round by range (host ms / kernels / kernel ms): " + ", ".join(
        f"{p} {host[p] / 1e3:.1f} / " + (f"{dev_t[p][0]} / {dev_t[p][1] / 1e3:.2f}" if dev_t else "not measured")
        for p in phases))
    busy = sum(t for _, t in per_name.values()) / 1e6
    n = sum(c for c, _ in per_name.values())
    if dev_t:
        per_update = dev_t["sac.update"]
        log("profile", f"{phase}: one update = {per_update[0] / cfg.gradient_steps:.1f} kernels, "
                       f"{per_update[1] / cfg.gradient_steps:.1f} us of kernel time, "
                       f"{host['sac.update'] / cfg.gradient_steps:.1f} us of host time (profiled)")
    log("profile", f"{phase}: round kernel time {busy:.4f} s in {n} kernels = "
                   f"{100 * busy / (secs / rounds):.1f}% of an unprofiled round ({secs / rounds:.3f} s); "
                   f"profiled {wall:.3f} s")
    for name, (count, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]:
        log("profile", f"  {us / 1e3:9.3f} ms  x{count:<6} {name[:90]}")


def run_sqil(torch, dev, env_name, phase, steps, n_demos, config_kw):
    """``SQIL.train`` on 8 device envs of ``env_name`` with scripted-expert
    demos (the learner ``auto`` picks: DQN on CartPole, SAC on Pendulum);
    returns over 64 episodes before and after (not asserted)."""
    from imitation_tpu_torch.algorithms.sqil import SQIL
    from imitation_tpu_torch.envs import make_vec_env

    demos, _ = expert_demos(torch, phase, env_name, 8, n_demos, dev)
    venv = make_vec_env(env_name, num_envs=8, device=dev)
    eval_venv = make_vec_env(env_name, num_envs=64, device=dev)
    sqil = SQIL(venv=venv, demonstrations=demos[:n_demos], allow_variable_horizon=True,
                custom_logger=make_logger(), seed=0, **config_kw)
    ret0 = eval_returns(torch, sqil.policy, eval_venv, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, sites = count_syncs(torch, lambda: sqil.train(total_timesteps=steps))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = sqil.state
    log(phase, f"SQIL ({sqil.rl_algo_name}) {st.timesteps} env steps, {st.n_updates} updates in {secs:.3f} s: "
               f"{st.timesteps / secs:.1f} steps/s, {st.n_updates / secs:.1f} updates/s; "
               f"{sqil._expert_batch.batch_size} expert rows; host reads {len(sites)}")
    # One more step, its metrics read once.
    sqil.state, metrics = sqil.rl.train_step(sqil.state)[:2]
    losses = ("loss",) if sqil.rl_algo_name == "dqn" else ("critic_loss", "actor_loss")
    host = finite_metrics(torch, phase, metrics, losses)
    log(phase, "metrics of one more step: " + ", ".join(f"{k} {v:.4g}" for k, v in host.items()))
    # SQIL's mixed sample on the card: batch // 2 fresh rows labelled 0,
    # then expert rows labelled 1.
    size = sqil.rl.config.batch_size
    batch = sqil.sample_hook(sqil.rl.replay, sqil.state.buffer_state,
                             torch.Generator(device=dev).manual_seed(3), size)
    rews, half = batch.rews.cpu(), size // 2
    log(phase, f"sampled batch of {size}: {int((rews == 0).sum())} rows labelled 0 "
               f"then {int((rews == 1).sum())} labelled 1")
    if not (batch.batch_size == size and (rews[:half] == 0).all() and (rews[half:] == 1).all()):
        raise AssertionError(f"{phase}: the sampled batch is not half fresh zeros then half expert ones")
    ret1 = eval_returns(torch, sqil.policy, eval_venv, seed=2)
    log(phase, f"return over 64 episodes before {ret0:.4g}, after {ret1:.4g}")


def run_adversarial_sac(torch, dev):
    """AIRL and GAIL with a SAC generator on device Pendulum-v1 at the JAX
    CLI's ``train_adversarial airl|gail with sac env_name=Pendulum-v1``
    (imitation_tpu/scripts/train_adversarial.py:21-57, 87-99): 8 envs,
    train_freq 256 (the CLI's n_steps), SAC batch 64, learning_starts 100, lr
    3e-4, one gradient step a round, demo batch 1024, 4 disc updates, 10
    scripted expert episodes. AIRL: 2 rounds of ``train``, then 2 of
    ``train_fused`` on a fresh trainer; GAIL: 1 round of ``train``. Then B2
    on the AIRL trainer's own demo store and replay ring, held exactly
    against its plain version and timed."""
    from imitation_tpu_torch.algorithms.adversarial.airl import AIRL
    from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.ops import disc_assembly
    from imitation_tpu_torch.rl.sac import SAC, SACConfig

    demos, _ = expert_demos(torch, "airl_sac", "Pendulum-v1", 8, 10, dev)

    def make(cls):
        venv = make_vec_env("Pendulum-v1", num_envs=8, device=dev)
        sac = SAC(venv, SACConfig(learning_rate=3e-4, train_freq=256, batch_size=64, learning_starts=100),
                  seed=0)
        return cls(demonstrations=demos[:10], demo_batch_size=1024, venv=venv, gen_algo=sac,
                   n_disc_updates_per_round=4, custom_logger=make_logger(), seed=0)

    launches = {}
    airl = make(AIRL)
    launches["airl_sac"], s_airl = train_rounds(torch, "airl_sac", airl, 2)
    launches["airl_sac_fused"], s_fused = train_rounds(torch, "airl_sac", make(AIRL), 2, fused=True)
    launches["gail_sac"], s_gail = train_rounds(torch, "gail_sac", make(GAIL), 1)
    log("airl_sac", f"{s_airl:.3f} s per round (train), {s_fused:.3f} (train_fused); "
                    f"gail_sac {s_gail:.3f} s per round; SAC replay {airl.gen_state.buffer_state.size} rows, "
                    f"the trainer's ring {airl._gen_buffer_state.size}")

    demo, ring = airl._demo_store.batch, airl._gen_buffer_state.data
    pairs = [(getattr(demo, f), getattr(ring, f)) for f in ("obs", "acts", "next_obs", "dones")]
    g = torch.Generator(device=dev).manual_seed(2)
    b = airl.demo_batch_size
    e = torch.randint(0, demo.batch_size, (b,), generator=g, device=dev, dtype=torch.int32)
    gi = torch.randint(0, airl._gen_buffer_state.size, (b,), generator=g, device=dev, dtype=torch.int32)
    for out, (d, gr) in zip(disc_assembly.assemble_fields(pairs, e, gi), pairs):
        if not torch.equal(out, disc_assembly.assemble_rows_plain(d, gr, e, gi)):
            raise AssertionError("airl_sac: B2 disagrees with its plain version on the path's fields")
    shape = (f"demo [{demo.batch_size}], SAC-generator ring [{airl._gen_buffer_state.size}], B={b}; "
             + ", ".join(f"{f} {list(x.shape[1:])} {str(x.dtype).split('.')[-1]}"
                         for f, x in zip(("obs", "acts", "next_obs", "dones"), (d for d, _ in pairs))))
    log("airl_sac", f"assemble_fields on the path's own fields ({shape}): exact")
    row = time_b2(torch, "airl_sac", "at the SAC-generator disc step (4 fields)", pairs, e, gi, b)
    # The same shapes from fresh random tensors, as the kernels phase makes
    # them, timed here too: separates the fields' layout from the card's
    # state at this point of the script.
    synthetic = [(torch.randn_like(d), torch.randn_like(gr)) for d, gr in pairs]
    fresh = time_b2(torch, "airl_sac", "on fresh random fields of the same shapes", synthetic, e, gi, b)
    return launches, dict(row, shape=shape, max_abs_err=0.0, synthetic_device_ms=fresh["device_ms"],
                          synthetic_ms=fresh["ms"])



# The loop's stages, as PreferenceComparisons.train names its ranges.
RLHF_RANGES = ("pc.sample", "pc.fragment", "pc.gather", "pc.reward_train", "pc.agent_train")


def rlhf_pendulum(dev):
    """benchmarking/run_rlhf.py's ``pendulum`` preset (:40-48, 233-256): 32
    envs; PPO n_steps 64, 32 minibatches, 10 epochs, lr 2e-3, ent_coef
    0.01, gamma 0.97, clip 0.1, a (32, 32) actor-critic with
    normalize_features; BasicRewardNet(normalize_input=True); fragments of
    100 steps, initial_epoch_multiplier 200, exploration_frac 0.05,
    transition_oversampling 1.5; the default reward trainer (batch 32, one
    epoch, lr 1e-3)."""
    import numpy as np

    from imitation_tpu_torch.algorithms import preference_comparisons as pc
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.models.policies import ActorCriticPolicy
    from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
    from imitation_tpu_torch.rl.ppo import PPO, PPOConfig

    venv = make_vec_env("Pendulum-v1", num_envs=32, device=dev)
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(32, 32),
                               normalize_features=True)
    ppo = PPO(venv, policy, PPOConfig(n_steps=64, n_minibatches=32, n_epochs=10, learning_rate=2e-3,
                                      ent_coef=0.01, gamma=0.97, gae_lambda=0.95, clip_range=0.1), seed=0)
    net = BasicRewardNet(venv.observation_space, venv.action_space, normalize_input=True)
    agent = pc.AgentTrainer(ppo, net, venv, rng=0, exploration_frac=0.05)
    return pc.PreferenceComparisons(
        agent, net, num_iterations=2, fragmenter=pc.RandomFragmenter(rng=0, warning_threshold=0),
        preference_gatherer=pc.SyntheticGatherer(rng=np.random.default_rng(0)), fragment_length=100,
        transition_oversampling=1.5, initial_comparison_frac=0.1, initial_epoch_multiplier=200.0,
        allow_variable_horizon=True, rng=0, seed=0, custom_logger=make_logger())


def rlhf_cli(dev, algo):
    """``train_preference_comparisons with active env_name=Pendulum-v1``
    (algo ``ppo``) or ``with sac env_name=Pendulum-v1`` (algo ``sac``),
    imitation_tpu/scripts/train_preference_comparisons.py:26-58, 84-117,
    174-182: 8 envs; fragments of 50 steps, initial_epoch_multiplier 4,
    the reward trainer's 3 epochs of batch 32 at lr 1e-3. ``ppo``: PPO
    n_steps 128, 16 minibatches, 4 epochs, lr 3e-4; a RewardEnsemble of 3
    BasicRewardNets with member RunningNorm; active selection on the logit,
    oversampling 2. ``sac``: SACConfig(lr 3e-4, train_freq 64, batch 64,
    learning_starts 100) with (256, 256) nets; a NormalizedRewardNet
    (RunningNorm) over a BasicRewardNet."""
    import numpy as np

    from imitation_tpu_torch.algorithms import preference_comparisons as pc
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.models.networks import RunningNorm
    from imitation_tpu_torch.models.policies import ActorCriticPolicy
    from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet, NormalizedRewardNet, RewardEnsemble
    from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
    from imitation_tpu_torch.rl.sac import SAC, SACConfig

    venv = make_vec_env("Pendulum-v1", num_envs=8, device=dev)
    obs, act = venv.observation_space, venv.action_space
    fragmenter = pc.RandomFragmenter(rng=0, warning_threshold=0)
    if algo == "ppo":
        net = RewardEnsemble(obs, act, member_cls=BasicRewardNet, num_members=3,
                             member_normalize_cls=RunningNorm)
        ppo = PPO(venv, ActorCriticPolicy(obs, act),
                  PPOConfig(n_steps=128, n_minibatches=16, n_epochs=4, learning_rate=3e-4), seed=0)
        agent = pc.AgentTrainer(ppo, net, venv, rng=0)
        preference_model = pc.PreferenceModel(net)
        fragmenter = pc.ActiveSelectionFragmenter(preference_model, fragmenter, 2.0, uncertainty_on="logit")
    else:
        net = NormalizedRewardNet(BasicRewardNet(obs, act), RunningNorm)
        sac = SAC(venv, SACConfig(learning_rate=3e-4, train_freq=64, batch_size=64, learning_starts=100), seed=0)
        agent = pc.SACAgentTrainer(sac, net, venv, rng=0)
        preference_model = pc.PreferenceModel(net)
    trainer = pc._make_reward_trainer(preference_model, rng=0,
                                      reward_trainer_kwargs=dict(epochs=3, batch_size=32, lr=1e-3))
    return pc.PreferenceComparisons(
        agent, net, num_iterations=2, fragmenter=fragmenter,
        preference_gatherer=pc.SyntheticGatherer(rng=np.random.default_rng(0)), reward_trainer=trainer,
        fragment_length=50, transition_oversampling=1.0, initial_comparison_frac=0.1,
        initial_epoch_multiplier=4.0, allow_variable_horizon=True, rng=0, seed=0, custom_logger=make_logger())


def reward_update_check(torch, phase, loop):
    """One more update of the loop's reward trainer on the card against the
    same update of a CPU copy (the net, its optimizer's moments and count)
    on the same pairs: the first ``batch_size`` pairs of the dataset (each
    member drawing its own with an ensemble). Adam divides each coordinate's
    step by its own gradient scale, so where that scale is rounding noise a
    last-bit difference moves the step far more than an ulp: the CPU update
    from weights nudged by about one float32 ulp gives the floor, and the
    card must agree within 1% of the learning rate or 4x that floor. The
    output bias is printed apart: it adds the same amount to both fragments
    of a pair, so its whole gradient is rounding noise (the CPU tests hold
    it the same way)."""
    import numpy as np

    from imitation_tpu_torch.algorithms import preference_comparisons as pc

    trainer = loop.reward_trainer
    pm = trainer.preference_model
    batch = loop.dataset.as_batch(loop.device)
    n, bs = batch.num_pairs, min(trainer.batch_size, batch.num_pairs)
    if hasattr(trainer, "num_members"):
        idx = torch.from_numpy(np.random.default_rng(0).integers(0, n, (trainer.num_members, bs)))
    else:
        idx = torch.arange(bs)
    idx = idx.to(loop.device)
    lam = trainer._lambda()
    moments = copy.deepcopy(trainer.optimizer.state_dict())

    def cpu_update(rel):
        net = copy.deepcopy(pm.model).cpu()
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(1 + rel)
        cpu_trainer = type(trainer)(
            pc.PreferenceModel(net, noise_prob=pm.noise_prob, discount_factor=pm.discount_factor,
                               threshold=pm.threshold),
            batch_size=trainer.batch_size, minibatch_size=trainer.minibatch_size,
            weight_decay=trainer.optimizer.weight_decay, custom_logger=make_logger())
        cpu_trainer.optimizer.load_state_dict(copy.deepcopy(moments))
        metrics = cpu_trainer._update(batch.map(lambda x: x[idx].cpu()), lam)
        return {k: p.detach() for k, p in net.named_parameters()}, float(metrics["loss"])

    want, want_loss = cpu_update(0.0)
    nudged = [cpu_update(rel)[0] for rel in (1.2e-7, -6e-8)]
    got_loss = float(trainer._update(batch.map(lambda x: x[idx]), lam)["loss"])
    got = {k: p.detach().cpu() for k, p in pm.model.named_parameters()}
    keys = [k for k in got if not k.endswith("dense_out.bias")]
    diff = {k: (got[k] - want[k]).abs().max().item() for k in got}
    floor = max((m[k] - want[k]).abs().max().item() for m in nudged for k in keys)
    worst = max(keys, key=diff.get)
    bias = max(diff[k] for k in got if k not in keys)
    lr = trainer.optimizer.param_groups[0]["lr"]
    tol = max(1e-2 * lr, 4 * floor)
    log("reference", f"{phase} reward-trainer update GPU vs CPU on {bs} pairs: max abs param diff "
                     f"{diff[worst]:.3g} ({worst}; limit {tol:.3g}: the CPU's float32 floor {floor:.3g}, "
                     f"lr {lr:g}), output bias {bias:.3g}; loss {got_loss:.6g} vs {want_loss:.6g}")
    if not (diff[worst] <= tol and bias <= 2 * lr and abs(got_loss - want_loss) <= 1e-4 * max(1.0, want_loss)):
        raise AssertionError(f"{phase}: the reward update on the card disagrees with the CPU's")


def pendulum_reward(obs, acts):
    """Pendulum-v1's reward of host observations ``[..., 3]`` and actions ``[..., 1]``."""
    import numpy as np

    th = np.arctan2(obs[..., 1], obs[..., 0])
    return -(th ** 2 + 0.1 * obs[..., 2] ** 2 + 0.001 * np.clip(acts[..., 0], -2.0, 2.0) ** 2)


def check_reward_fit(torch, phase, loop, true_reward=pendulum_reward, refit=True):
    """The learned reward on the loop's own comparisons: its accuracy and
    loss, and the share of pairs whose predicted probability is clamped to
    [1e-7, 1 - 1e-7], where the loss has no gradient (the JAX package's
    BCE clamps there too, so a pair the reward got confidently wrong stays
    wrong; CPU runs of these configurations over seeds 0-3 ended at
    0.50-0.98). So, with ``refit``, a reward net of the same kind,
    re-initialised, is also fitted afresh by a trainer of the same kind for
    200 epochs on the loop's comparisons, and that fit must reach an
    accuracy of at least 0.5 on them (0.64-1.0 on the CPU over seeds 0-3).
    Also each fragment's rewards must be ``true_reward`` of its own
    observations and actions (the env's reward)."""
    import numpy as np

    from imitation_tpu_torch.algorithms import preference_comparisons as pc

    batch = loop.dataset.as_batch(loop.device)
    obs, acts, rews = (x.cpu().numpy() for x in (batch.obs[:, :, :-1], batch.acts, batch.rews_gt))
    data_err = float(np.abs(true_reward(obs, acts) - rews).max())
    pm = loop.reward_trainer.preference_model

    def fit(model):
        with torch.no_grad():
            out = pc.CrossEntropyRewardLoss()(model, batch)
            probs = model(batch)
        clamped = float(((probs <= 1e-7) | (probs >= 1 - 1e-7)).float().mean())
        return float(out.metrics["accuracy"]), float(out.loss), clamped, float(out.metrics["gt_reward_loss"])

    accuracy, loss, clamped, gt_loss = fit(pm)
    if not refit:
        log(phase, f"the loop's reward on its own {batch.num_pairs} comparisons: accuracy {accuracy:.4g}, "
                   f"loss {loss:.4g} ({100 * clamped:.1f}% of pair predictions clamped), the ground-truth "
                   f"reward's loss {gt_loss:.4g}; fragment rewards against the env's reward of their "
                   f"observations and actions: max abs diff {data_err:.3g}")
        if not (data_err <= 1e-3 and math.isfinite(loss)):
            raise AssertionError(f"{phase}: fragment rewards off the env's by {data_err}, loss {loss}")
        return
    net = copy.deepcopy(pm.model)
    net.init(torch.Generator(device=loop.device).manual_seed(1))
    fresh = pc.PreferenceModel(net, noise_prob=pm.noise_prob, discount_factor=pm.discount_factor,
                               threshold=pm.threshold)
    trainer = type(loop.reward_trainer)(fresh, rng=0, batch_size=loop.reward_trainer.batch_size,
                                        epochs=200, custom_logger=make_logger())
    t0 = time.perf_counter()
    trainer.train(loop.dataset)
    refit_s = time.perf_counter() - t0
    refit, refit_loss, refit_clamped, _ = fit(fresh)
    log(phase, f"the loop's reward on its own {batch.num_pairs} comparisons: accuracy {accuracy:.4g}, loss "
               f"{loss:.4g} ({100 * clamped:.1f}% of pair predictions clamped, without gradient), the "
               f"ground-truth reward's loss {gt_loss:.4g}; refitted afresh for 200 epochs ({refit_s:.2f} s): "
               f"accuracy {refit:.4g}, loss {refit_loss:.4g} ({100 * refit_clamped:.1f}% clamped); fragment "
               f"rewards against Pendulum's reward of their observations and actions: max abs diff {data_err:.3g}")
    if not (refit >= 0.5 and data_err <= 1e-3 and math.isfinite(loss)):
        raise AssertionError(f"{phase}: a fresh reward fitted to the comparisons reached accuracy {refit} "
                             f"(data error {data_err})")


def run_rlhf(torch, phase, loop, total_timesteps, total_comparisons, cuts, true_reward=pendulum_reward,
             refit=True):
    """``PreferenceComparisons.train`` of ``loop`` on the card, with the
    kernels' launch counts set to 0 just before and read just after: B1
    once per PPO iteration (none with SAC), B2 never. Seconds per
    iteration (the first includes the long initial reward training), the
    last iteration under torch.profiler split by the ``pc.*`` ranges;
    metrics finite, the dataset as scheduled, the comparisons fitted
    (``check_reward_fit``), and one reward update held against the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from imitation_tpu_torch.algorithms import preference_comparisons as pc

    log(phase, "cut: " + "; ".join(cuts))
    n_iters = loop.num_iterations + 1  # the initial comparisons, then the schedule
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    ends = []

    def callback(i):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        if i == n_iters - 2:
            prof.start()

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    result = loop.train(total_timesteps, total_comparisons, callback=callback)
    prof.stop()
    elapsed = time.perf_counter() - t0
    launches = counts()
    per_iter = [ends[0] - t0] + [b - a for a, b in zip(ends, ends[1:])]
    agent = loop.trajectory_generator
    ppo_iterations = agent.state.n_updates if isinstance(agent, pc.AgentTrainer) else 0
    log(phase, f"{n_iters} iterations in {elapsed:.3f} s: " + ", ".join(f"{x:.3f}" for x in per_iter)
               + f" s (the last profiled); {agent.state.timesteps} agent env steps; launches {launches} "
                 f"for {ppo_iterations} PPO iterations; dataset {len(loop.dataset)} comparisons")
    accuracies = [r.get("mean/reward/final/train/accuracy", float("nan")) for r in loop.logger.rows[-n_iters:]]
    log(phase, "reward trainer's last-batch accuracy by iteration: " + ", ".join(f"{a:.4g}" for a in accuracies))
    row = loop.logger.rows[-1]
    keys = [k for k in sorted(row) if k.startswith(("mean/reward/final/", "mean/preferences/", "mean/agent/"))]
    log(phase, "last iteration logged: " + ", ".join(f"{k[5:]} {row[k]:.4g}" for k in keys
                                                      if isinstance(row[k], float)))
    finite = [result["reward_loss"], result["reward_accuracy"], row["mean/reward/final/train/loss"]]
    if isinstance(agent, pc.AgentTrainer):
        finite += [row["mean/agent/loss"], row["mean/agent/value_loss"]]
    params = list(loop.model.parameters()) + list(agent.policy.parameters())
    if not (all(math.isfinite(x) for x in finite) and all(bool(torch.isfinite(p).all()) for p in params)):
        raise AssertionError(f"{phase}: non-finite metrics or parameters: {finite}")
    queue = loop.dataset.fragments1.maxlen  # comparison_queue_size keeps the newest
    if len(loop.dataset) != min(total_comparisons, queue or total_comparisons):
        raise AssertionError(f"{phase}: {len(loop.dataset)} comparisons, {total_comparisons} scheduled "
                             f"(queue {queue})")
    if launches != {"gae": ppo_iterations, "assemble_rows": 0} or (ppo_iterations and not launches["gae"]):
        raise AssertionError(f"{phase}: launches {launches}, expected {ppo_iterations} GAE and no B2")
    check_reward_fit(torch, phase, loop, true_reward, refit)
    host, dev_t = split_ranges(prof, RLHF_RANGES)
    per_name = kernel_times(prof)
    n_kernels, kernel_us = sum(c for c, _ in per_name.values()), sum(us for _, us in per_name.values())
    log("profile", f"{phase} last iteration ({per_iter[-1]:.3f} s profiled) by range (host ms / kernels / "
                   f"kernel ms): " + ", ".join(
                       f"{p} {host[p] / 1e3:.1f} / " + (f"{dev_t[p][0]} / {dev_t[p][1] / 1e3:.2f}"
                                                        if dev_t else "not measured") for p in RLHF_RANGES)
                   + f"; kernel time {kernel_us / 1e6:.4f} s in {n_kernels} kernels = "
                     f"{100 * kernel_us / 1e6 / per_iter[-1]:.1f}% of the profiled iteration")
    reward_update_check(torch, phase, loop)
    return launches, per_iter


def run_tabular_env(torch, dev, n=1024, steps=64):
    """``TabularMDP`` through ``VectorEnv`` on the card: ``random_mdp(64, 4,
    horizon=32)`` at ``n`` envs under uniform random actions for ``steps``
    steps. Every (s, a, s') is counted; each next-state frequency must lie
    within 5 binomial standard deviations of ``T[s, a, s']`` (exactly 0
    where ``T`` is 0), and every env must truncate once per episode, at the
    horizon, and never terminate."""
    import numpy as np

    from imitation_tpu_torch.envs.tabular import random_mdp
    from imitation_tpu_torch.envs.vector import VectorEnv

    t0 = time.perf_counter()
    env = random_mdp(64, 4, horizon=32, seed=0)
    S, A, H = env.n_states, env.n_actions, env.horizon
    venv = VectorEnv(env, n, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    state = venv.reset(g)
    counts = torch.zeros(S * A * S, dtype=torch.float64, device=dev)
    ones = torch.ones(n, dtype=torch.float64, device=dev)
    n_trunc, n_term = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2))
    at_horizon = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(steps):
        s = state.env_state[:, 0]
        a = torch.randint(0, A, (n,), generator=g, device=dev)
        state, out = venv.step(state, a)
        s_next = out.terminal_obs.argmax(-1)  # one-hot observations
        counts.index_add_(0, (s * A + a) * S + s_next, ones)
        n_trunc += out.truncated.sum()
        n_term += out.terminated.sum()
        at_horizon &= (out.truncated == (out.episode_length == H)).all()
    counts = counts.view(S, A, S).cpu().numpy()
    n_sa = counts.sum(-1, keepdims=True)
    freq = counts / np.maximum(n_sa, 1)
    p = env.transition_matrix.astype(np.float64)
    sigma = np.sqrt(p * (1 - p) / np.maximum(n_sa, 1))
    seen = np.broadcast_to(n_sa > 0, p.shape)
    dev_abs = np.abs(freq - p)
    z = float((dev_abs[seen & (sigma > 0)] / sigma[seen & (sigma > 0)]).max())
    n_trunc, n_term = int(n_trunc), int(n_term)
    log("envs", f"TabularMDP random_mdp(64, 4, horizon=32) x{n}: {steps} steps under random actions, "
                f"{int(n_sa.sum())} transitions over {int((n_sa > 0).sum())} of {S * A} (s, a) pairs "
                f"(fewest {int(n_sa[n_sa > 0].min())}): next-state frequencies against T at most {z:.3f} "
                f"binomial standard deviations (limit 5), none where T is 0: "
                f"{bool((counts[p == 0] == 0).all())}; {n_term} terminations, {n_trunc} truncations "
                f"(horizon {H}); {time.perf_counter() - t0:.2f} s")
    if not (z <= 5.0 and (counts[p == 0] == 0).all()):
        raise AssertionError("TabularMDP: next-state frequencies disagree with the transition matrix")
    if n_term or n_trunc != n * (steps // H) or not bool(at_horizon):
        raise AssertionError(f"TabularMDP: {n_term} terminations, {n_trunc} truncations; expected "
                             f"none and {n * (steps // H)}, each at the horizon")


def expected_return(env, pi) -> float:
    """Exact expected true return of a time-dependent policy, in float64
    (benchmarking/run_small_algos.py ``expected_return``)."""
    import numpy as np

    d = env.initial_state_dist.astype(np.float64)
    T = env.transition_matrix.astype(np.float64)
    R = env.reward_matrix.astype(np.float64)
    pi = np.asarray(pi, np.float64)
    total = 0.0
    for t in range(env.horizon):
        total += float(d @ R)
        d = np.einsum("sa,sap->p", d[:, None] * pi[t], T)
    return total


def mce_iteration_costs(torch, dev, env, demo, n=10):
    """Host reads (synchronizing CUDA calls) and kernel launches per
    ``MCEIRL`` iteration: the counts of ``train(max_iter=2n)`` less those
    of ``train(max_iter=n)``, over n, so the final partition and copy to
    the host cancel. Thresholds are out of reach so no run stops early."""
    from torch.profiler import ProfilerActivity, profile

    from imitation_tpu_torch.algorithms.mce_irl import MCEIRL

    runs = []
    for iters in (n, 2 * n):
        probe = MCEIRL(demo, env, linf_eps=0.0, grad_l2_eps=0.0, log_interval=None,
                       custom_logger=make_logger(), device=dev)
        probe.train(max_iter=1)  # warm-up
        _, syncs = count_syncs(torch, lambda: probe.train(max_iter=iters))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            probe.train(max_iter=iters)
            torch.cuda.synchronize()
        runs.append((len(syncs), sum(c for c, _ in kernel_times(prof).values()), syncs))
    return (runs[1][0] - runs[0][0]) / n, (runs[1][1] - runs[0][1]) / n, sorted(set(runs[1][2]))


def mce_cpu_check(torch, phase, make, iters=50):
    """The first ``iters`` iterations of ``make(device)`` on the card and
    on the CPU from the same weights (the card's initial net), both
    thresholds out of reach and every iteration logged: the logged
    occupancy gap and gradient norm of every iteration within 1e-4
    relative, and the weights within 1e-4 of the largest update (the CPU
    tests' tolerances against the JAX package)."""
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = make(device)
        if device == "cpu":
            trainer.reward_net.load_state_dict(init)
        else:
            init = {k: v.detach().cpu().clone() for k, v in trainer.reward_net.state_dict().items()}
        trainer.train(max_iter=iters)
        rows = [(r["linf_delta"], r["grad_norm"]) for r in trainer.logger.rows]
        runs[device] = (rows, {k: v.detach().cpu() for k, v in trainer.reward_net.state_dict().items()})
    (card_rows, card_w), (cpu_rows, cpu_w) = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for x, y in zip(card_rows, cpu_rows) for a, b in zip(x, y))
    upd = max((cpu_w[k] - init[k]).abs().max().item() for k in init)
    err = max((card_w[k] - cpu_w[k]).abs().max().item() for k in init)
    log(phase, f"first {iters} iterations on the card against the CPU from the same weights: logged "
               f"linf/grad_norm max relative diff {rel:.3g} (limit 1e-4), weights max abs diff {err:.3g} "
               f"against the largest update {upd:.3g} (limit 1e-4 of it)")
    if len(card_rows) != iters or len(cpu_rows) != iters or rel > 1e-4 or err > 1e-4 * upd:
        raise AssertionError(f"{phase}: the card's MCE IRL iterations disagree with the CPU's")


def run_mceirl_random_mdp(torch, dev):
    """benchmarking/run_small_algos.py:108-146 in full: random_mdp(16, 4,
    horizon=16, seed=0), the expert's pi from ``mce_partition_fh``,
    ``MCEIRL(D_demo, env, linf_eps=1e-4).train(max_iter=2000)``, logging
    through ``configure(tmpdir, ["stdout", "csv", "json", "log"])``."""
    import csv
    import tempfile

    import numpy as np

    from imitation_tpu_torch.algorithms import mce_irl
    from imitation_tpu_torch.envs.tabular import random_mdp
    from imitation_tpu_torch.util.logger import configure

    phase = "mceirl_random_mdp"
    env = random_mdp(16, 4, horizon=16, seed=0)
    _, _, pi_expert = mce_irl.mce_partition_fh(env, device=dev)
    _, D_demo = mce_irl.mce_occupancy_measures(env, pi=pi_expert)
    with tempfile.TemporaryDirectory() as tmp:
        logger = configure(tmp, ["stdout", "csv", "json", "log"])
        trainer = mce_irl.MCEIRL(D_demo, env, linf_eps=1e-4, custom_logger=logger, device=dev)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        trainer.train(max_iter=2000)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = counts()
        logger.close()
        iters = trainer.optimizer.count
        with open(os.path.join(tmp, "progress.csv"), newline="") as f:
            csv_rows = list(csv.DictReader(f))
        with open(os.path.join(tmp, "progress.json")) as f:
            json_rows = [json.loads(line) for line in f]
        has_log = os.path.getsize(os.path.join(tmp, "log.txt")) > 0
    want_rows = len(range(0, iters, trainer.log_interval))
    _, D_learned = mce_irl.mce_occupancy_measures(env, pi=trainer.policy.pi, device=dev)
    gap = (D_learned - D_demo).abs().max().item()
    ret_learned, ret_expert = expected_return(env, trainer.policy.pi), expected_return(env, pi_expert.cpu())
    log(phase, f"{iters} iterations in {elapsed:.3f} s ({elapsed / iters * 1e3:.3f} ms per iteration); "
               f"OM linf gap {gap:.3g} (limit 2e-2); exact return learned {ret_learned:.6g}, expert "
               f"{ret_expert:.6g}; launches {launches}; progress.csv {len(csv_rows)} rows, progress.json "
               f"{len(json_rows)} rows (one per log_interval {trainer.log_interval}: {want_rows}), "
               f"log.txt written: {has_log}")
    if gap > 2e-2:
        raise AssertionError(f"{phase}: learned occupancy {gap} from the demonstrations'")
    if len(csv_rows) != want_rows or len(json_rows) != want_rows or not has_log:
        raise AssertionError(f"{phase}: {len(csv_rows)} csv and {len(json_rows)} json rows, expected {want_rows}")
    if [int(r["iteration"]) for r in csv_rows] != [r["iteration"] for r in json_rows] != list(
            range(0, iters, trainer.log_interval)):
        raise AssertionError(f"{phase}: logged iterations differ between progress.csv and progress.json")
    if any(launches.values()):
        raise AssertionError(f"{phase}: MCE IRL launched a kernel of the port: {launches}")

    mce_cpu_check(torch, phase, lambda device: mce_irl.MCEIRL(
        D_demo.to(device), env, linf_eps=0.0, grad_l2_eps=0.0, log_interval=1,
        custom_logger=make_logger(), device=device))
    reads, per_iter, where = mce_iteration_costs(torch, dev, env, D_demo)
    log(phase, f"per iteration: {per_iter:g} kernel launches, {reads:g} host reads ({', '.join(where)})")

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    trajs = mce_irl.sample_tabular_trajectories(env, pi_expert, 3000, g)
    visits = np.zeros(env.n_states)
    for t in trajs:
        np.add.at(visits, np.argmax(t.obs[:-1], axis=-1), 1)
    mc_gap = float(np.abs(visits / len(trajs) - D_demo.cpu().numpy()).max())
    log(phase, f"sample_tabular_trajectories: 3000 episodes of the expert in {time.perf_counter() - t0:.2f} s; "
               f"visit frequencies against D: max abs diff {mc_gap:.4g} (limit 0.15, the JAX package's test)")
    if mc_gap > 0.15:
        raise AssertionError(f"{phase}: sampled visits disagree with the occupancy measure")
    return elapsed / iters


def run_mceirl_large(torch, dev, iters=200):
    """MCE IRL at random_mdp(1024, 8, horizon=32): T[S, A, S] float32 is
    33.5 MB, read twice per horizon step of each iteration (the backward
    and the forward pass). The card's occupancy is held against the CPU's
    within 4x the CPU's own float32 floor (its distance from a float64
    forward pass)."""
    import numpy as np

    from imitation_tpu_torch.algorithms import mce_irl
    from imitation_tpu_torch.envs.tabular import random_mdp

    phase = "mceirl_large"
    t0 = time.perf_counter()
    env = random_mdp(1024, 8, horizon=32, seed=0)
    build = time.perf_counter() - t0
    _, _, pi = mce_irl.mce_partition_fh(env, device=dev)
    _, D_card = mce_irl.mce_occupancy_measures(env, pi=pi)
    pi_cpu = pi.cpu()
    _, D_cpu = mce_irl.mce_occupancy_measures(env, pi=pi_cpu)
    d = env.initial_state_dist.astype(np.float64)
    D64 = d.copy()
    T64, pi64 = env.transition_matrix.astype(np.float64), pi_cpu.numpy().astype(np.float64)
    for t in range(env.horizon - 1):
        d = np.einsum("sa,sat->t", d[:, None] * pi64[t], T64)
        D64 += d
    floor = float(np.abs(D_cpu.numpy() - D64).max())
    err = (D_card.cpu() - D_cpu).abs().max().item()
    tol = max(4 * floor, 1e-7)
    log(phase, f"random_mdp(1024, 8, horizon=32) built in {build:.2f} s (T {env.transition_matrix.nbytes / 1e6:.1f} MB); "
               f"occupancy card vs CPU max abs diff {err:.3g} (limit {tol:.3g}: 4x the CPU's float32 floor "
               f"{floor:.3g} against float64)")
    if err > tol:
        raise AssertionError(f"{phase}: the card's occupancy measure disagrees with the CPU's")
    trainer = mce_irl.MCEIRL(D_card, env, linf_eps=0.0, grad_l2_eps=0.0, custom_logger=make_logger(), device=dev)
    trainer.train(max_iter=1)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    trainer.train(max_iter=iters)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = counts()
    reads, per_iter, where = mce_iteration_costs(torch, dev, env, D_card)
    t_bytes = 2 * (env.horizon - 1) * env.transition_matrix.nbytes
    s_iter = elapsed / iters
    log(phase, f"{iters} iterations in {elapsed:.3f} s ({s_iter * 1e3:.3f} ms per iteration): {per_iter:g} "
               f"kernel launches and {reads:g} host reads per iteration ({', '.join(where)}); T read "
               f"{t_bytes / 1e9:.3f} GB per iteration = {t_bytes / s_iter / 1e9:.1f} GB/s "
               f"({100 * t_bytes / s_iter / HBM_BYTES_PER_S:.1f}% of HBM); launches {launches}; last gap "
               f"{trainer.logger.rows[-1]['linf_delta']:.3g}")
    if any(launches.values()) or not all(bool(torch.isfinite(p).all()) for p in trainer.reward_net.parameters()):
        raise AssertionError(f"{phase}: a port kernel launched ({launches}) or non-finite weights")
    return s_iter


def kde_cpu_check(torch, phase, demos, venv, cfg):
    """The KDE reward on the card against a CPU copy (same demonstrations,
    fitted alike) for each density type and for non-stationary density,
    on the demonstrations' own transitions (the first 4096): within 4x the
    CPU's own float32 floor (its distance from the same KDE in float64),
    or 1e-5."""
    import numpy as np

    from imitation_tpu_torch.algorithms import density
    from imitation_tpu_torch.data import rollout
    from imitation_tpu_torch.envs import make_vec_env

    flat = rollout.flatten_trajectories(demos)
    obs, acts, next_obs = (np.asarray(x[:4096]) for x in (flat.obs, flat.acts, flat.next_obs))
    dones = np.zeros(len(obs), np.float32)
    cpu_venv = make_vec_env("Pendulum-v1", num_envs=venv.num_envs, device="cpu")
    for kind, stationary in (("STATE_DENSITY", True), ("STATE_ACTION_DENSITY", True),
                             ("STATE_STATE_DENSITY", True), ("STATE_ACTION_DENSITY", False)):
        algos = [density.DensityAlgorithm(demonstrations=demos, venv=v, density_type=density.DensityType[kind],
                                          is_stationary=stationary, rl_config=cfg, custom_logger=make_logger())
                 for v in (venv, cpu_venv)]
        for a in algos:
            a.train()
        t0 = time.perf_counter()
        got = algos[0](obs, acts, next_obs, dones)
        card_s = time.perf_counter() - t0
        want = algos[1](obs, acts, next_obs, dones)
        p = algos[1]._reward_params()
        x = algos[1]._flatten(*(torch.from_numpy(v).double() for v in (obs, acts, next_obs)))
        x = (x - p["scale_mean"].double()) / p["scale_std"].double()
        logs = density.gaussian_kde_logpdf(x, p["data"].double(), algos[1].kernel_bandwidth)
        m = logs.shape[0]
        ref = logs[0] if m == 1 else torch.logsumexp(logs, dim=0) - math.log(m)
        floor = float(np.abs(want - ref.numpy()).max())
        err = float(np.abs(got - want).max())
        tol = max(4 * floor, 1e-5)
        log(phase, f"KDE {kind} {'stationary' if stationary else 'non-stationary'} (data "
                   f"{tuple(p['data'].shape)}): card vs CPU on {len(obs)} transitions max abs diff {err:.3g} "
                   f"(limit {tol:.3g}: 4x the CPU's float32 floor {floor:.3g}); card call {card_s * 1e3:.2f} ms; "
                   f"reward mean {float(got.mean()):.4g}")
        if not err <= tol:
            raise AssertionError(f"{phase}: the card's KDE reward disagrees with the CPU's ({kind})")


def run_density(torch, dev, num_envs=16, timesteps=2_048):
    """benchmarking/run_small_algos.py:79-105 at its widths: 16 envs, the
    scripted expert's episodes (``min_episodes=20``), STATE_ACTION_DENSITY,
    bandwidth 0.5, standardised, stationary; PPO n_steps 64, 8 minibatches x
    10 epochs, lr 3e-4, gamma 0.95, lambda 0.95. Cut to 2,048 timesteps."""
    import numpy as np

    from imitation_tpu_torch.algorithms import density
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.rl.ppo import PPOConfig

    phase = "density_pendulum"
    iterations = math.ceil(timesteps / (64 * num_envs))
    log(phase, f"cut: {timesteps:,} timesteps instead of 500,000 ({iterations} PPO iterations of 64 x {num_envs})")
    demos, _ = expert_demos(torch, phase, "Pendulum-v1", num_envs, 20, dev)
    venv = make_vec_env("Pendulum-v1", num_envs=num_envs, device=dev)
    cfg = PPOConfig(n_steps=64, n_minibatches=8, n_epochs=10, learning_rate=3e-4, gamma=0.95, gae_lambda=0.95)
    kde_cpu_check(torch, phase, demos, venv, cfg)
    algo = density.DensityAlgorithm(demonstrations=demos, venv=venv, rl_config=cfg,
                                    custom_logger=make_logger(), seed=0)
    algo.train()
    t = demos[0]
    expert = algo(t.obs[:-1], t.acts, t.obs[1:], np.zeros(len(t)))
    noise_obs = np.random.default_rng(0).uniform(-5, 5, (len(t), 3)).astype(np.float32)
    noise_act = np.random.default_rng(1).uniform(-2, 2, (len(t), 1)).astype(np.float32)
    noise = algo(noise_obs, noise_act, noise_obs, np.zeros(len(t)))
    log(phase, f"KDE reward of an expert episode {expert.mean():.4g}, of random transitions {noise.mean():.4g}")
    if not expert.mean() > noise.mean() + 1.0:
        raise AssertionError(f"{phase}: expert transitions should score above random ones")
    algo.rl_state = algo.rl_algo.init_state()
    before = algo.test_policy(n_trajectories=50)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    algo.train_policy(n_timesteps=timesteps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = counts()
    after = algo.test_policy(n_trajectories=50)
    log(phase, f"train_policy: {algo.rl_state.n_updates} PPO iterations in {elapsed:.3f} s "
               f"({elapsed / iterations:.3f} s per iteration); launches {launches}; true return over 50 "
               f"episodes before {before['return_mean']:.6g}, after {after['return_mean']:.6g}")
    if launches != {"gae": iterations, "assemble_rows": 0}:
        raise AssertionError(f"{phase}: launches {launches}, expected {iterations} GAE and no B2")
    if not all(bool(torch.isfinite(p).all()) for p in algo.policy.parameters()):
        raise AssertionError(f"{phase}: non-finite policy parameters")
    ranges = ("ppo.collect", "ppo.process_chunk")
    params = algo._reward_params()
    host, dev_t, per_name, wall = profile_ranges(
        torch, lambda: algo.rl_algo.train_step(algo.rl_state, params), ranges)
    busy = sum(us for _, us in per_name.values()) / 1e6
    log("profile", f"{phase} one more PPO iteration by range (host ms / kernels / kernel ms): " + ", ".join(
        f"{p} {host[p] / 1e3:.1f} / " + (f"{dev_t[p][0]} / {dev_t[p][1] / 1e3:.2f}" if dev_t else "not measured")
        for p in ranges) + f"; kernel time {busy:.4f} s in {sum(c for c, _ in per_name.values())} kernels = "
        f"{100 * busy / (elapsed / iterations):.1f}% of an unprofiled iteration (profiled {wall:.3f} s)")
    return launches, elapsed / iterations


def run_checkpoint(torch, dev):
    """``save_state`` after one PPO iteration (the rl phase's
    configuration on 8 envs) and after one SAC round (the sac phase's
    widths, learning_starts 0), ``restore_state`` into a fresh learner's
    ``init_state()``, one more step: the weights against the uninterrupted
    run's. They must agree within 1e-6 of the step's largest update; the
    line says whether they are equal bit for bit."""
    import tempfile

    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.models.policies import ActorCriticPolicy
    from imitation_tpu_torch.rl.ppo import PPO, PPOConfig
    from imitation_tpu_torch.rl.sac import SAC, SACConfig
    from imitation_tpu_torch.util import checkpoint

    def ppo():
        venv = make_vec_env("Pendulum-v1", num_envs=8, device=dev)
        return PPO(venv, ActorCriticPolicy(venv.observation_space, venv.action_space),
                   PPOConfig(n_steps=128, n_minibatches=32, n_epochs=5, lr_schedule="linear",
                             total_updates_hint=4), seed=0)

    def sac():
        venv = make_vec_env("Pendulum-v1", num_envs=8, device=dev)
        return SAC(venv, SACConfig(learning_starts=0, batch_size=256, train_freq=16, gradient_steps=16,
                                   buffer_size=100_000, learning_rate=3e-4), seed=0)

    def weights(state):
        mods = [state.policy] if hasattr(state, "policy") else [state.actor, state.critic, state.target_critic]
        return {f"{i}.{k}": v.detach().clone() for i, m in enumerate(mods) for k, v in m.state_dict().items()}

    for name, make in (("ppo", ppo), ("sac", sac)):
        algo = make()
        state = algo.train_step(algo.init_state())[0]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "state.pt")
            t0 = time.perf_counter()
            checkpoint.save_state(path, state)
            save_s, size = time.perf_counter() - t0, os.path.getsize(path)
            first = weights(state)
            want = weights(algo.train_step(state)[0])
            fresh = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restored = checkpoint.restore_state(path, fresh.init_state())
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            got = weights(fresh.train_step(restored)[0])
        bitwise = all(torch.equal(got[k], v) for k, v in want.items())
        err = max((got[k] - v).abs().max().item() for k, v in want.items())
        upd = max((v - first[k]).abs().max().item() for k, v in want.items())
        log("checkpoint", f"{name}: save {save_s * 1e3:.1f} ms ({size / 1e6:.2f} MB), restore "
                          f"{restore_s * 1e3:.1f} ms; one more step after the restore against the "
                          f"uninterrupted run: bitwise equal {bitwise}, max abs diff {err:.3g} "
                          f"(largest update {upd:.3g}, limit 1e-6 of it)")
        if restored.generator is not restored.env_state.generator or not err <= 1e-6 * upd:
            raise AssertionError(f"checkpoint: {name} resumed run differs from the uninterrupted one")


def pixel_demos(torch, phase, dev):
    """The GAIL phase's scripted CartPole episodes (128 of 100 steps, 12,800
    rows), each observation drawn by ``PixelCartPole``'s render on the card."""
    import dataclasses

    from imitation_tpu_torch.examples.tutorials.t05a_preference_comparisons_cnn import PixelCartPole

    demos, stats = expert_demos(torch, phase, "CartPole-v1", 64, 64, dev, max_episode_steps=100)
    if stats["return_min"] != 100.0:
        raise AssertionError("the scripted expert should balance every 100-step episode")
    pixel = [dataclasses.replace(t, obs=PixelCartPole.render(torch.as_tensor(t.obs, device=dev)).cpu().numpy())
             for t in demos]
    rows = sum(len(t) for t in pixel)
    log(phase, f"pixel demos: {len(pixel)} episodes, {rows} rows, obs {pixel[0].obs.shape[1:]} "
               f"{pixel[0].obs.dtype}, {sum(t.obs.nbytes for t in pixel) / 1e6:.1f} MB")
    return pixel


def pixel_setup(dev, num_envs, **venv_kw):
    """A device ``PixelCartPole`` vector env and the tutorial's (64, 64) MLP
    policy over its flattened pixels."""
    from imitation_tpu_torch.envs.vector import VectorEnv
    from imitation_tpu_torch.examples.tutorials.t05a_preference_comparisons_cnn import PixelCartPole
    from imitation_tpu_torch.models.policies import ActorCriticPolicy

    venv = VectorEnv(PixelCartPole(), num_envs=num_envs, device=dev, **venv_kw)
    return venv, ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(64, 64))


def run_gail_pixel(torch, dev, demos, num_envs=1024, n_steps=128, demo_batch_size=2048):
    """GAIL on device ``PixelCartPole`` at the GAIL headline's widths
    (bench.py:248-268) with a ``CnnRewardNet`` discriminator at its
    defaults: a warm-up round, two rounds of ``train``, the reward on the
    card against a CPU copy, one profiled round."""
    from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
    from imitation_tpu_torch.rewards.reward_nets import CnnRewardNet
    from imitation_tpu_torch.rl.ppo import PPOConfig

    phase = "gail_pixel_cartpole"
    venv, policy = pixel_setup(dev, num_envs)
    trainer = GAIL(
        demonstrations=demos, demo_batch_size=demo_batch_size, venv=venv,
        reward_net=CnnRewardNet(venv.observation_space, venv.action_space), policy=policy,
        gen_config=PPOConfig(n_steps=n_steps, n_minibatches=32, n_epochs=5), n_disc_updates_per_round=2,
        allow_variable_horizon=True, custom_logger=make_logger(), seed=0,
    )
    t0 = time.perf_counter()
    trainer.train(trainer.gen_train_timesteps)
    torch.cuda.synchronize()
    ring = trainer._gen_buffer_state.data
    log(phase, f"warm-up round {time.perf_counter() - t0:.3f} s; replay ring obs {tuple(ring.obs.shape)} "
               f"{str(ring.obs.dtype)} ({ring.obs.numel() * ring.obs.element_size() / 1e6:.1f} MB)")
    launches, s_per_round = train_rounds(torch, phase, trainer, 2)
    reward_cpu_check(torch, phase, trainer)
    profile_round(torch, phase, trainer, s_per_round)
    return launches, s_per_round


def run_airl_pixel(torch, dev, demos):
    """One AIRL round on device ``PixelCartPole`` at the JAX CLI's AIRL
    defaults (8 envs x 256 steps, demo batch 1024, 4 disc updates) with
    ``ShapedRewardNet(CnnRewardNet, BasicPotentialCNN)``; the test reward
    (the unshaped base) against the train reward."""
    from imitation_tpu_torch.algorithms.adversarial.airl import AIRL
    from imitation_tpu_torch.rewards.reward_nets import BasicPotentialCNN, CnnRewardNet, ShapedRewardNet
    from imitation_tpu_torch.rl.ppo import PPOConfig

    phase = "airl_pixel_cartpole"
    venv, policy = pixel_setup(dev, 8)
    o, a = venv.observation_space, venv.action_space
    trainer = AIRL(
        demonstrations=demos, demo_batch_size=1024, venv=venv,
        reward_net=ShapedRewardNet(CnnRewardNet(o, a), BasicPotentialCNN(o)), policy=policy,
        gen_config=PPOConfig(n_steps=256, n_minibatches=32, n_epochs=5), n_disc_updates_per_round=4,
        allow_variable_horizon=True, custom_logger=make_logger(), seed=0,
    )
    launches, s_round = train_rounds(torch, phase, trainer, 1)
    train = reward_cpu_check(torch, phase, trainer)
    test = reward_cpu_check(torch, phase, trainer, "reward_test_fn")
    diff = (train - test).abs().max().item()
    log(phase, f"reward_test_fn (CnnRewardNet alone) vs reward_train_fn (shaped by BasicPotentialCNN) on "
               f"{train.shape[0]} replay rows: max abs diff {diff:.4g}, test mean {test.mean().item():.4g}, "
               f"train mean {train.mean().item():.4g}")
    if not diff > 0:
        raise AssertionError(f"{phase}: the test reward should strip the potential shaping")
    return launches, s_round


def pixel_ensemble_check(torch, phase, loop):
    """A 3-member ``RewardEnsemble`` of the tutorial's ``CnnRewardNet``s on
    the loop's fragments: the members' fragment rewards on the card against
    a CPU copy, then one ensemble-trainer update against the CPU's
    (``reward_update_check``)."""
    import types

    from imitation_tpu_torch import make_generator
    from imitation_tpu_torch.algorithms import preference_comparisons as pc
    from imitation_tpu_torch.rewards.reward_nets import CnnRewardNet, RewardEnsemble

    o, a = loop.model.observation_space, loop.model.action_space
    ens = RewardEnsemble(o, a, member_cls=CnnRewardNet, num_members=3,
                         member_kwargs=dict(hid_channels=(8, 8), use_done=False)).to(loop.device)
    ens.init(make_generator(1, loop.device))
    pm = pc.PreferenceModel(ens)
    trainer = pc._make_reward_trainer(pm, rng=0, reward_trainer_kwargs=dict(batch_size=32))
    trainer.logger = make_logger()
    batch = loop.dataset.as_batch(loop.device)
    cpu = pc.PreferenceModel(copy.deepcopy(ens).cpu())
    with torch.no_grad():
        got, want = pm.fragment_rewards(batch), cpu.fragment_rewards(batch.map(lambda x: x.cpu()))
    err = (got.cpu() - want).abs().max().item()
    log("reference", f"{phase} 3-member CnnRewardNet ensemble: fragment rewards {tuple(got.shape)} on the "
                     f"card vs CPU max abs diff {err:.3g}")
    if err > 1e-4:
        raise AssertionError(f"{phase}: the ensemble's forward on the card disagrees with the CPU's")
    reward_update_check(torch, f"{phase} ensemble", types.SimpleNamespace(
        reward_trainer=trainer, dataset=loop.dataset, device=loop.device))


def run_rlhf_pixel(torch, dev):
    """The ported tutorial's loop (``build``) at an eighth of its ``__main__``
    timesteps, through ``run_rlhf``: CartPole's reward is 1 a step, so every fragment
    of 20 steps returns 20 and the synthetic preferences are coin flips; the
    reward's fit is printed, not asserted (no refit). Then the CNN
    ensemble's check."""
    import numpy as np

    from imitation_tpu_torch.examples.tutorials import t05a_preference_comparisons_cnn as tutorial

    phase = "rlhf_pixel_cartpole"
    loop = tutorial.build(dev, make_logger())
    launches, per_iter = run_rlhf(
        torch, phase, loop, 4_000, 300, ("4,000 timesteps instead of the tutorial's __main__ 30,000 "
                                         "(about 24 PPO iterations instead of 177), to keep the script within "
                                         "its time with the CLI and example phases; its 300 comparisons kept",),
        true_reward=lambda obs, acts: np.ones(acts.shape, np.float32), refit=False)
    pixel_ensemble_check(torch, phase, loop)
    return launches, per_iter


def run_bc_nature_cnn(torch, dev, n=10_000, bf16_rows=4096):
    """``BC.train`` at the ``train_imitation bc`` defaults (batch 32, ent
    1e-3, l2 0, lr 1e-3) for 1 epoch with a ``features="nature_cnn"`` policy
    on ``n`` uint8 frames [96, 96, 3] (CarRacing-v3's) made on the card from
    a seed, labelled Discrete(5) by the brightest of five vertical bands;
    50 steps profiled; the loss falls; the policy's forward on the card
    against the CPU; the same net in bfloat16 against float32; a save/load
    round trip."""
    import tempfile

    import numpy as np

    from imitation_tpu_torch import make_generator
    from imitation_tpu_torch.algorithms.bc import BC
    from imitation_tpu_torch.data.types import TransitionBatch
    from imitation_tpu_torch.envs.base import Space
    from imitation_tpu_torch.models.policies import ActorCriticNet, ActorCriticPolicy
    from imitation_tpu_torch.policies import serialize

    phase = "bc_nature_cnn"
    g = make_generator(0, dev)
    t0 = time.perf_counter()
    frames = torch.randint(0, 200, (n, 96, 96, 3), generator=g, device=dev, dtype=torch.uint8)
    band = torch.randint(0, 5, (n,), generator=g, device=dev, dtype=torch.int32)
    column_band = torch.arange(96, device=dev) * 5 // 96
    frames += (column_band[None, None, :, None] == band[:, None, None, None]).to(torch.uint8) * 55
    zeros = torch.zeros(n, device=dev)
    demos = TransitionBatch(obs=frames, acts=band, next_obs=frames, dones=zeros, rews=zeros)
    torch.cuda.synchronize()
    log(phase, f"{n} uint8 frames {tuple(frames.shape[1:])} made on the card in {time.perf_counter() - t0:.3f} s "
               f"({frames.numel() / 1e6:.1f} MB); labels by band: {torch.bincount(band).tolist()}")
    obs_space, act_space = Space.box(0, 255, (96, 96, 3), np.uint8), Space.discrete(5)
    bc = BC(observation_space=obs_space, action_space=act_space, demonstrations=demos,
            policy=ActorCriticPolicy(obs_space, act_space, features="nature_cnn"), rng=0, batch_size=32,
            ent_weight=1e-3, l2_weight=0.0, optimizer_kwargs=dict(learning_rate=1e-3),
            custom_logger=make_logger(), device=dev)
    if bc._demo_store.batch.obs.dtype != torch.uint8:
        raise AssertionError(f"{phase}: the demo store should keep the frames uint8")
    before = demo_metrics(torch, bc)
    timed_epochs(torch, phase, bc, n_epochs=1)
    after = demo_metrics(torch, bc)
    check_learned(phase, before, after)
    if not after["loss"] < before["loss"]:
        raise AssertionError(f"{phase}: the loss on the demos did not fall")
    profile_bc(torch, phase, bc)

    policy = bc.policy
    x = frames[:256]
    cpu = copy.deepcopy(policy).cpu()
    with torch.no_grad():
        (d, v), (dc, vc) = policy.dist_and_value(x), cpu.dist_and_value(x.cpu())
    err = max((d.logits.cpu() - dc.logits).abs().max().item(), (v.cpu() - vc).abs().max().item())
    log("reference", f"{phase} NatureCNN policy on 256 frames, card vs CPU: max abs diff {err:.3g}")
    if err > 1e-4:
        raise AssertionError(f"{phase}: the policy's forward on the card disagrees with the CPU's")

    bf16 = ActorCriticNet(obs_space.flat_dim, act_space, features="nature_cnn", obs_shape=obs_space.shape,
                          compute_dtype=torch.bfloat16).to(dev)
    bf16.load_state_dict(policy.net.state_dict())
    x = frames[:bf16_rows]
    with torch.no_grad():
        (d32, v32), (d16, v16) = policy.net(x), bf16(x)
        torch.cuda.synchronize()
        ms32 = cuda_ms(lambda: policy.net(x), reps=5)
        ms16 = cuda_ms(lambda: bf16(x), reps=5)
    unit = 2.0 ** -8
    rel = {name: (b.float() - a).abs().max().item() / a.abs().max().item()
           for name, a, b in (("logits", d32.logits, d16.logits), ("values", v32, v16))}
    log(phase, f"bfloat16 compute on {bf16_rows} frames against float32: max abs error / max |float32| "
               f"logits {rel['logits']:.4g}, values {rel['values']:.4g} (bf16's unit roundoff 2^-8 = "
               f"{unit:.4g}; limit 16 units); forward {ms16:.3f} ms in bf16, {ms32:.3f} ms in float32")
    if not max(rel.values()) <= 16 * unit:
        raise AssertionError(f"{phase}: bfloat16 compute is off float32 by {rel}")

    with tempfile.TemporaryDirectory(prefix="nature_cnn_") as path:
        serialize.save_policy(path, policy)
        loaded = serialize.load_policy_from_path(path, device=dev)
        with torch.no_grad():
            same = torch.equal(loaded.dist_and_value(frames[:64])[0].logits,
                               policy.dist_and_value(frames[:64])[0].logits)
    log(phase, f"save_policy + load_policy_from_path: features {loaded.features}, logits equal: {same}")
    if not same or loaded.features != "nature_cnn":
        raise AssertionError(f"{phase}: the reloaded policy differs from the saved one")


# The repo's seals experts (the JAX rounds' SAC and PPO experts and their
# demos), found beside this script: output/experts/<env>/{policy,rollouts}.
EXPERTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "output", "experts")
SEALS_ENVS = ("seals_ant", "seals_half_cheetah", "seals_hopper", "seals_swimmer", "seals_walker2d")


def nudged_floor(torch, fn, module, x):
    """How far float32 rounding alone moves ``fn(module, x)``: the largest
    change when every weight of ``module`` is scaled by 1 + 2^-23, over the
    output's largest magnitude (tests/torch_parity.py ``update_floors``)."""
    nudged = copy.deepcopy(module)
    with torch.no_grad():
        for p in nudged.parameters():
            p.mul_(1 + 2.0 ** -23)
        out = fn(module, x)
        return (fn(nudged, x) - out).abs().max().item() / max(out.abs().max().item(), 1e-30)


def run_experts_seals(torch, dev):
    """For each seals env: its demos through ``data.serialize.load`` (the
    port's Arrow reader), its expert through ``load_policy_from_path`` (the
    port's flax-msgpack reader), the expert's deterministic actions on every
    demo observation on the card against a CPU copy, the mean log-probability
    of the demo actions, and the demos' mean return beside the expert's
    evaluation return in summary.json (reported, not gated: the demos were
    sampled)."""
    import numpy as np

    from imitation_tpu_torch.data import serialize as data_serialize
    from imitation_tpu_torch.policies import serialize
    from imitation_tpu_torch.rl.sac import SACPolicy

    phase = "experts_seals"
    with open(os.path.join(EXPERTS, "summary.json")) as f:
        summary = json.load(f)
    for env in SEALS_ENVS:
        rollouts = os.path.join(EXPERTS, env, "rollouts")
        mb = sum(os.path.getsize(os.path.join(rollouts, n)) for n in os.listdir(rollouts)
                 if n.endswith(".arrow")) / 1e6
        t0 = time.perf_counter()
        demos = data_serialize.load(rollouts)
        t_read = time.perf_counter() - t0
        trajs = list(demos)  # every episode decoded (infos through json)
        t_decode = time.perf_counter() - t0 - t_read
        obs = torch.from_numpy(np.concatenate([t.obs[:-1] for t in trajs])).to(dev)
        acts = torch.from_numpy(np.concatenate([t.acts for t in trajs])).to(dev)
        n = obs.shape[0]
        log(phase, f"{env}: {len(trajs)} episodes, {n} transitions, {mb:.2f} MB of Arrow read in "
                   f"{t_read:.4f} s, decoded in {t_decode:.4f} s; obs {tuple(obs.shape)} {obs.dtype}")

        t0 = time.perf_counter()
        policy = serialize.load_policy_from_path(os.path.join(EXPERTS, env, "policy"), device=dev)
        cpu = copy.deepcopy(policy).cpu()
        kind = "sac_actor" if isinstance(policy, SACPolicy) else "actor_critic"

        def act(module, x):
            return module.deterministic_fn()(x)[0]

        def log_prob(module, x, a):
            if isinstance(module, SACPolicy):
                return module.log_prob(x, a)
            return module.distribution(x).log_prob(a.reshape(a.shape[0], -1))

        with torch.no_grad():
            a_dev = act(policy, obs)
            lp = log_prob(policy, obs, acts)
            torch.cuda.synchronize()
            t_fwd = time.perf_counter() - t0
            a_cpu = act(cpu, obs.cpu())
            lp_cpu = log_prob(cpu, obs.cpu(), acts.cpu())
        scale = a_cpu.abs().max().item()
        err = (a_dev.cpu() - a_cpu).abs().max().item()
        floor = nudged_floor(torch, act, cpu, obs.cpu()[:4096])
        limit = max(1e-5, 4 * floor) * scale
        finite = torch.isfinite(lp)
        lp_err = (lp.cpu() - lp_cpu).abs().max().item() / max(lp_cpu.abs().max().item(), 1.0)
        ret = float(np.mean([t.rews.sum() for t in trajs]))
        log(phase, f"{env}: {kind} {policy.hid_sizes if kind == 'sac_actor' else policy.net.hid_sizes} loaded "
                   f"and run on {n} demo observations in {t_fwd:.3f} s; deterministic actions card vs CPU max abs "
                   f"diff {err:.3g} (largest action {scale:.4g}, float32 floor {floor:.3g}, limit {limit:.3g}); "
                   f"mean log-prob of the demo actions {lp[finite].mean().item():.6g} ({int(finite.sum())} of {n} "
                   f"finite; card vs CPU {lp_err:.3g} of the largest); demo return mean {ret:.6g} against the "
                   f"expert's evaluation return {summary[env]:.6g} (summary.json)")
        if not (err <= limit and bool(torch.isfinite(a_dev).all())):
            raise AssertionError(f"{phase}: {env} expert's actions on the card disagree with the CPU's")
        if not (finite.any() and lp_err <= 1e-4):
            raise AssertionError(f"{phase}: {env} expert's log-probabilities on the card disagree with the CPU's")


def run_bc_seals_half_cheetah(torch, dev, epochs=2):
    """``BC.train`` on the 48 seals/HalfCheetah-v1 expert episodes (48,000
    transitions, read by the port's Arrow reader) at
    benchmarking/run_parity.py's HalfCheetah settings (FeedForward32 with
    normalize_features, batch 64, l2 5.73e-3, lr 8.06e-3), ``epochs`` epochs
    instead of 20: one host read per epoch, loss falling and prob_true_act
    rising on the demos, steps/s, 50 profiled steps, a save/load round
    trip, and the BC policy's return on the port's HalfCheetah env
    (deterministic, 16 envs from reset seed 12345, one 1000-step episode
    each; finite, printed, not gated: 2 epochs)."""
    import tempfile

    from imitation_tpu_torch.algorithms.bc import BC
    from imitation_tpu_torch.data import serialize as data_serialize
    from imitation_tpu_torch.models.policies import FeedForward32Policy
    from imitation_tpu_torch.policies import serialize

    phase = "bc_seals_half_cheetah"
    env = os.path.join(EXPERTS, "seals_half_cheetah")
    expert = serialize.load_policy_from_path(os.path.join(env, "policy"), device="cpu")
    space = expert.observation_space, expert.action_space
    t0 = time.perf_counter()
    demos = data_serialize.load(os.path.join(env, "rollouts"))
    bc = BC(observation_space=space[0], action_space=space[1], demonstrations=demos,
            policy=FeedForward32Policy(*space, normalize_features=True), rng=0, batch_size=64,
            l2_weight=5.73e-3, optimizer_kwargs=dict(learning_rate=8.06e-3), custom_logger=make_logger(),
            device=dev)
    torch.cuda.synchronize()
    log(phase, f"{len(demos)} episodes -> {bc._demo_store.num_samples} transitions on the card in "
               f"{time.perf_counter() - t0:.3f} s (read, decode, flatten, copy); run_parity's 20 epochs cut to "
               f"{epochs}")
    before = demo_metrics(torch, bc)
    timed_epochs(torch, phase, bc, n_epochs=epochs)
    after = demo_metrics(torch, bc)
    for row in bc.logger.rows:
        log(phase, f"logged at batch {row['mean/bc/batch']}: loss {row['mean/bc/loss']:.4g}, "
                   f"prob_true_act {row['mean/bc/prob_true_act']:.4g}")
    check_learned(phase, before, after)
    if not after["loss"] < before["loss"]:
        raise AssertionError(f"{phase}: the loss on the demos did not fall")
    profile_bc(torch, phase, bc)
    with tempfile.TemporaryDirectory(prefix="bc_seals_") as path:
        serialize.save_policy(path, bc.policy)
        loaded = serialize.load_policy_from_path(path, device=dev)
        same = all(torch.equal(loaded.state_dict()[k], v) for k, v in bc.policy.state_dict().items())
    log(phase, f"save_policy + load_policy_from_path: every weight and statistic equal: {same}")
    if not same:
        raise AssertionError(f"{phase}: the reloaded policy differs from the trained one")
    t0 = time.perf_counter()
    ret = seals_returns(torch, dev, HC_ENV, bc.policy.deterministic_fn())
    log(phase, f"the BC policy on the port's {HC_ENV}, deterministic, 16 envs x 1000 steps from seed 12345 in "
               f"{time.perf_counter() - t0:.2f} s: return mean {ret.mean():.6g} (std {ret.std():.4g}, min "
               f"{ret.min():.6g}, max {ret.max():.6g})")
    if not all(math.isfinite(x) for x in ret):
        raise AssertionError(f"{phase}: non-finite returns")


def run_bc_dict_obs(torch, dev, n=65_536, batch_size=256, epochs=2):
    """BC on dict observations made on the card, as
    tests/algorithms/test_bc_dictobs.py: ``{"pos": [n, 3], "vel": [n, 2]}``
    normal draws, Discrete(2) labels ``pos[:, 0] > 0``, a ``DictSpace``
    FeedForward32 policy; ``n`` transitions at ``batch_size`` (the test's 16
    would be 4,096 steps an epoch). Accuracy on the demos above 0.9, the
    policy on the card against the CPU."""
    from imitation_tpu_torch import make_generator
    from imitation_tpu_torch.algorithms.bc import BC
    from imitation_tpu_torch.data.types import TransitionBatch
    from imitation_tpu_torch.envs.base import DictSpace, Space

    phase = "bc_dict_obs"
    g = make_generator(0, dev)
    obs = {"pos": torch.randn(n, 3, generator=g, device=dev), "vel": torch.randn(n, 2, generator=g, device=dev)}
    acts = (obs["pos"][:, 0] > 0).to(torch.int32)
    zeros = torch.zeros(n, device=dev)
    demos = TransitionBatch(obs=obs, acts=acts, next_obs=obs, dones=zeros, rews=zeros)
    obs_space = DictSpace(spaces={"pos": Space.box(-10, 10, (3,)), "vel": Space.box(-10, 10, (2,))})
    act_space = Space.discrete(2)
    bc = BC(observation_space=obs_space, action_space=act_space, demonstrations=demos, rng=0,
            batch_size=batch_size, custom_logger=make_logger(), device=dev)
    before = demo_metrics(torch, bc)
    timed_epochs(torch, phase, bc, n_epochs=epochs)
    check_learned(phase, before, demo_metrics(torch, bc))
    with torch.no_grad():
        acc = (bc.policy.distribution(obs).mode() == acts).float().mean().item()
        cpu = copy.deepcopy(bc.policy).cpu()
        x = {k: v[:4096] for k, v in obs.items()}
        err = (bc.policy.distribution(x).logits.cpu()
               - cpu.distribution({k: v.cpu() for k, v in x.items()}).logits).abs().max().item()
    log(phase, f"{n} dict transitions {{pos: 3, vel: 2}} at batch {batch_size}: accuracy on the demos {acc:.4f} "
               f"(limit > 0.9); logits card vs CPU on 4096 rows max abs diff {err:.3g}; first layer "
               f"{bc.policy.net.pi0.in_features} wide ({sorted(obs)} concatenated)")
    if not acc > 0.9:
        raise AssertionError(f"{phase}: accuracy {acc:.4f} on the dict-observation demos")
    if not err <= 1e-4:
        raise AssertionError(f"{phase}: the dict-observation policy on the card disagrees with the CPU's")


# -- the CLI: python -m imitation_tpu_torch <script> ... ------------------------

def run_files(run_dir):
    """The run directory's files, relative, sorted."""
    return sorted(os.path.relpath(os.path.join(r, f), run_dir) for r, _, fs in os.walk(run_dir) for f in fs)


def cli_run(torch, phase, script, argv, root, formats="['csv','json']"):
    """One in-process ``ex.run_cli`` of the port's ``script`` on the default
    device (CUDA: no ``device`` key given), logging to ``formats`` (csv and
    json files by default) under a fresh ``log_root`` in ``root``; asserts
    ``run.json`` COMPLETED. Returns (result, run directory)."""
    import importlib

    ex = importlib.import_module(f"imitation_tpu_torch.scripts.{script}").ex
    log_root = tempfile.mkdtemp(prefix=f"{phase}_", dir=root)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = ex.run_cli(argv + [f"log_format_strs={formats}", f"log_root={log_root}"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    (env_dir,) = os.listdir(log_root)
    run_dir = os.path.realpath(os.path.join(log_root, env_dir, "latest"))
    with open(os.path.join(run_dir, "run.json")) as f:
        run = json.load(f)
    if run["status"] != "COMPLETED":
        raise AssertionError(f"{phase}: {script} {argv} ended {run['status']}")
    with open(os.path.join(run_dir, "config.json")) as f:
        if json.load(f)["device"] is not None:
            raise AssertionError(f"{phase}: the run should take the default device")
    files = run_files(run_dir)
    log(phase, f"python -m imitation_tpu_torch {script} {' '.join(argv)}: {seconds:.2f} s; run.json "
               f"COMPLETED; {len(files)} files: {', '.join(files)}")
    return result, run_dir


def stats_line(stats):
    return ", ".join(f"{k} {stats[k]:.6g}" for k in ("n_traj", "return_mean", "return_std", "len_mean"))


def finite_stats(phase, stats):
    if not all(math.isfinite(stats[k]) for k in ("return_mean", "return_std", "len_mean")):
        raise AssertionError(f"{phase}: non-finite evaluation: {stats}")


def run_cli_gail_cartpole(torch, dev, root):
    """``train_adversarial gail with gail_cartpole total_timesteps=16384``:
    the tuned config at its widths, 2 rounds. Rounds timed by wrapping the
    trainer's ``train`` (the run is the CLI's own); B1 once per round at
    [128, 64], B2 once per disc step (16); the final checkpoints reloaded on
    the card against the trainer's own outputs on its replay rows."""
    from imitation_tpu_torch.algorithms.adversarial import common
    from imitation_tpu_torch.policies import serialize as policy_serialize
    from imitation_tpu_torch.rewards import serialize as reward_serialize

    phase = "cli_gail_cartpole"
    log(phase, "cut: total_timesteps 16,384 instead of gail_cartpole.json's 500,000 (2 rounds); widths as tuned")
    trainers, ends = [], []
    train = common.AdversarialTrainer.train

    def timed_train(self, total_timesteps, callback=None):
        trainers.append(self)

        def round_end(r):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            if callback is not None:
                callback(r)

        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return train(self, total_timesteps, callback=round_end)

    common.AdversarialTrainer.train = timed_train
    try:
        zero_counts()
        result, run_dir = cli_run(torch, phase, "train_adversarial",
                                  ["gail", "with", "gail_cartpole", "total_timesteps=16384"], root)
        launches = counts()
    finally:
        common.AdversarialTrainer.train = train
    (trainer,) = trainers
    ppo = trainer.gen_algo.config
    got = (trainer.venv.num_envs, ppo.n_steps, ppo.n_minibatches, ppo.n_epochs, ppo.learning_rate, ppo.ent_coef,
           trainer.demo_batch_size, trainer.n_disc_updates_per_round, trainer.device.type)
    if got != (64, 128, 64, 5, 1e-3, 0.01, 1024, 4, torch.device(dev).type):
        raise AssertionError(f"{phase}: not gail_cartpole's widths on the card: {got}")
    per_round = [b - a for a, b in zip(ends, ends[1:])]
    log(phase, f"{len(per_round)} rounds of 64 envs x 128 steps: {', '.join(f'{x:.3f}' for x in per_round)} "
               f"s per round; launches {launches}")
    want = {"gae": 2, "assemble_rows": 8}
    if launches != want:  # B1 once per round, B2 once per disc step
        raise AssertionError(f"{phase}: launches {launches}, expected {want}")
    stats = result["imit_stats"]
    finite_stats(phase, stats)
    log(phase, f"imit_stats/return_mean {stats['return_mean']:.6g} ({stats_line(stats)})")

    ckpt = os.path.join(run_dir, "checkpoints", "final")
    policy = policy_serialize.load_policy_from_path(os.path.join(ckpt, "gen_policy"))
    net = reward_serialize.load_reward_net(os.path.join(ckpt, "reward_test"))
    data = trainer._gen_buffer_state.data
    batch = [x[:4096] for x in (data.obs, data.acts, data.next_obs, data.dones)]
    with torch.no_grad():
        dist, value = policy.dist_and_value(batch[0])
        want_dist, want_value = trainer.policy.dist_and_value(batch[0])
        errs = dict(log_prob=(dist.log_prob(batch[1]) - want_dist.log_prob(batch[1])).abs().max().item(),
                    value=(value - want_value).abs().max().item(),
                    reward=(net(*batch) - trainer.reward_net(*batch)).abs().max().item())
    log(phase, f"checkpoints/final reloaded on {next(policy.parameters()).device} against the trainer on "
               f"{batch[0].shape[0]} replay rows: max abs diff " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    if max(errs.values()) > 1e-6:
        raise AssertionError(f"{phase}: the reloaded checkpoint disagrees with the trainer: {errs}")
    return {phase: launches}


# phase -> (tuned config, env, expert under EXPERTS, total_timesteps, the
# widths (envs, n_steps, PPO minibatches, epochs, demo batch, replay, disc
# updates, demo rows), the launches of its rounds)
SEALS_CLI = {
    "cli_gail_seals_half_cheetah": ("gail_seals_half_cheetah", "seals/HalfCheetah-v1", "seals_half_cheetah", 8192,
                                    (64, 64, 64, 5, 8192, 512, 8, 48_000), {"gae": 2, "assemble_rows": 16}),
    "cli_gail_seals_hopper": ("gail_seals_hopper", "seals/Hopper-v1", "seals_hopper", 8192,
                              (64, 64, 8, 20, 128, 4096, 8, 48_000), {"gae": 2, "assemble_rows": 16}),
    "cli_gail_seals_walker": ("gail_seals_walker", "seals/Walker2d-v1", "seals_walker2d", 16384,
                              (64, 256, 128, 20, 512, 16384, 16, 32_000), {"gae": 1, "assemble_rows": 16}),
    "cli_gail_seals_swimmer": ("gail_seals_swimmer", "seals/Swimmer-v1", "seals_swimmer", 4096,
                               (64, 64, 64, 5, 32, 4096, 16, 48_000), {"gae": 1, "assemble_rows": 16}),
}


def run_cli_gail_seals(torch, dev, root, phase):
    """``train_adversarial gail with <config> total_timesteps=...``: a
    seals env's tuned config at its widths (``SEALS_CLI``: 64 envs of the
    port's engine, its PPO minibatches and epochs, demo batch, replay and
    disc updates, the repo's expert episodes), 1 or 2 rounds: s per round,
    the widths on the card and B1's and B2's launches (asserted),
    imit_stats; then ``eval_policy`` of the repo's expert on the port's env
    (``expert.policy_type=saved``, 64 envs, the CLI's 50 episodes): return
    printed, 1000-step episodes and a finite return asserted."""
    from imitation_tpu_torch.algorithms.adversarial import common
    from imitation_tpu_torch.envs.mujoco_native import MujocoLockstepVectorEnv

    config, env_id, expert_dir, timesteps, widths, want_launches = SEALS_CLI[phase]
    rounds = want_launches["gae"]
    log(phase, f"cut: total_timesteps {timesteps:,} instead of {config}.json's 10,000,000 ({rounds} "
               f"round{'s' if rounds > 1 else ''}); widths as tuned")
    trainers, ends = [], []
    train = common.AdversarialTrainer.train

    def timed_train(self, total_timesteps, callback=None):
        trainers.append(self)

        def round_end(r):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            if callback is not None:
                callback(r)

        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        return train(self, total_timesteps, callback=round_end)

    common.AdversarialTrainer.train = timed_train
    try:
        zero_counts()
        result, _ = cli_run(torch, phase, "train_adversarial",
                            ["gail", "with", config, f"total_timesteps={timesteps}"], root)
        launches = counts()
    finally:
        common.AdversarialTrainer.train = train
    (trainer,) = trainers
    ppo = trainer.gen_algo.config
    got = (type(trainer.venv).__name__, trainer.venv.env_id, trainer.venv.num_envs, ppo.n_steps, ppo.n_minibatches,
           ppo.n_epochs, trainer.demo_batch_size, trainer._gen_replay_buffer.capacity,
           trainer.n_disc_updates_per_round, trainer._demo_store.num_samples, trainer.device.type)
    want = (MujocoLockstepVectorEnv.__name__, env_id, *widths, torch.device(dev).type)
    if got != want:
        raise AssertionError(f"{phase}: not {config}'s widths on the card: {got}, expected {want}")
    per_round = [b - a for a, b in zip(ends, ends[1:])]
    log(phase, f"{len(per_round)} round{'s' if len(per_round) > 1 else ''} of {widths[0]} envs x {widths[1]} "
               f"steps ({widths[2]} minibatches x {widths[3]} epochs, {widths[6]} disc steps at B = {widths[4]}): "
               f"{', '.join(f'{x:.3f}' for x in per_round)} s per round; launches {launches}")
    if launches != want_launches:
        raise AssertionError(f"{phase}: launches {launches}, expected {want_launches}")
    stats = result["imit_stats"]
    finite_stats(phase, stats)
    log(phase, f"imit_stats ({stats_line(stats)})")
    zero_counts()
    eval_phase = phase.replace("cli_gail_seals", "cli_eval")
    stats, _ = cli_run(torch, eval_phase, "eval_policy", [
        "with", "expert.policy_type=saved", f"expert.loader_kwargs.path={os.path.join(EXPERTS, expert_dir, 'policy')}",
        f"env_name={env_id}", "num_envs=64"], root)
    finite_stats(phase, stats)
    log(phase, f"eval_policy of the repo's {expert_dir} expert (sampled actions): {stats_line(stats)}")
    if stats["len_mean"] != 1000 or stats["n_traj"] < 50 or any(counts().values()):
        raise AssertionError(f"{phase}: eval_policy {stats}, launches {counts()}")
    return {phase: launches}


def run_cli_airl_pendulum(torch, dev, root):
    """``train_adversarial airl with env_name=Pendulum-v1
    total_timesteps=2048`` (1 round at the CLI defaults, 8 envs x 256
    steps), then ``train_rl`` on its unshaped ``reward_test`` (the reward
    transfer of tests/scripts/test_scripts.py) for one PPO iteration: B1
    at [256, 8] once per round and per PPO iteration."""
    import numpy as np

    from imitation_tpu_torch.rewards import serialize as reward_serialize

    phase = "cli_airl_pendulum"
    log(phase, "cut: total_timesteps 2,048 instead of the CLI default 100,000 (1 round), and 2,048 for "
               "train_rl (1 PPO iteration)")
    zero_counts()
    result, run_dir = cli_run(torch, phase, "train_adversarial",
                              ["airl", "with", "env_name=Pendulum-v1", "total_timesteps=2048"], root)
    airl = counts()
    finite_stats(phase, result["imit_stats"])
    log(phase, f"airl: launches {airl}; imit_stats {stats_line(result['imit_stats'])}")
    if airl != {"gae": 1, "assemble_rows": 4}:
        raise AssertionError(f"{phase}: AIRL launches {airl}, expected 1 GAE and 4 B2")

    reward_path = os.path.join(run_dir, "checkpoints", "final", "reward_test")
    zero_counts()
    result, rl_dir = cli_run(torch, phase, "train_rl", [
        "with", "pendulum", "reward_type=RewardNet_unshaped", f"reward_path={reward_path}",
        "total_timesteps=2048"], root)
    rl = counts()
    finite_stats(phase, result)
    log(phase, f"train_rl on the AIRL reward: launches {rl}; eval {stats_line(result)}")
    if rl != {"gae": 1, "assemble_rows": 0}:
        raise AssertionError(f"{phase}: train_rl launches {rl}, expected 1 GAE")
    rng = np.random.default_rng(0)
    obs, next_obs = (rng.normal(size=(4096, 3)).astype(np.float32) for _ in range(2))
    acts = rng.uniform(-2, 2, (4096, 1)).astype(np.float32)
    dones = np.zeros(4096, np.float32)
    fns = [reward_serialize.load_reward("RewardNet_unshaped", reward_path, device=d) for d in (dev, "cpu")]
    got, want = (fn(obs, acts, next_obs, dones) for fn in fns)
    err = float(np.abs(got - want).max())
    log(phase, f"the transferred reward on the card against the CPU on 4096 rows: max abs diff {err:.3g}")
    if err > 1e-4:
        raise AssertionError(f"{phase}: the transferred reward disagrees between card and CPU")
    return {phase: airl, "cli_rl_pendulum": rl}


def run_cli_imitation_cartpole(torch, dev, root):
    """``train_imitation bc|dagger|sqil`` at the tuned CartPole configs (cut
    in depth), then ``eval_policy`` of the BC policy, plain and with
    ``explore_kwargs``. Neither kernel is on these paths."""
    phase = "cli_imitation_cartpole"
    log(phase, "cut: bc.n_epochs 2 instead of 15; dagger.total_timesteps 2,000 instead of 20,000; "
               "sqil.total_timesteps 5,000 instead of 50,000")
    zero_counts()
    returns = {}
    result, bc_dir = cli_run(torch, phase, "train_imitation", ["bc", "with", "bc_cartpole", "bc.n_epochs=2"], root,
                             formats="['csv','json','tensorboard']")
    returns["bc"] = result["imit_stats"]
    (events,) = [f for f in os.listdir(bc_dir) if f.startswith("events.out.tfevents.")]
    records = checked_tfrecords(os.path.join(bc_dir, events))
    if b"brain.Event:2" not in records[0] or not any(b"imit_stats/monitor_return_mean" in r for r in records):
        raise AssertionError(f"{phase}: the events file lacks its version record or the evaluation's scalars")
    log(phase, f"bc's {events}: {len(records)} records, every length and data CRC-32C checked (bitwise), "
               f"the first brain.Event:2")
    result, _ = cli_run(torch, phase, "train_imitation",
                        ["dagger", "with", "dagger_cartpole", "dagger.total_timesteps=2000"], root)
    returns["dagger"] = result["imit_stats"]
    result, _ = cli_run(torch, phase, "train_imitation",
                        ["sqil", "with", "sqil_cartpole", "sqil.total_timesteps=5000"], root)
    returns["sqil"] = result["imit_stats"]
    saved = ["with", "expert.policy_type=saved",
             f"expert.loader_kwargs.path={os.path.join(bc_dir, 'policies', 'final')}"]
    returns["eval_policy"], _ = cli_run(torch, phase, "eval_policy", saved, root)
    returns["eval_policy explore"], _ = cli_run(
        torch, phase, "eval_policy", saved + ["explore_kwargs={'random_prob': 0.5, 'switch_prob': 0.5}"], root)
    for name, stats in returns.items():
        finite_stats(phase, stats)
        log(phase, f"{name}: {stats_line(stats)}")
    launches = counts()
    log(phase, f"kernel launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"{phase}: BC, DAgger, SQIL and evaluation launch neither kernel: {launches}")


def sb3_zip(torch, path, seed=0):
    """A Stable-Baselines3 PPO ``model.zip`` for CartPole, written here from a
    seeded generator with ``torch.save`` and ``zipfile`` (SB3's layout: a
    (64, 64) tanh actor-critic's ``policy.pth`` and the ``data`` JSON)."""
    import io
    import zipfile

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for i, (din, dout) in enumerate(((4, 64), (64, 64))):
        for net in ("policy_net", "value_net"):
            sd[f"mlp_extractor.{net}.{2 * i}.weight"] = torch.randn(dout, din, generator=g) / din ** 0.5
            sd[f"mlp_extractor.{net}.{2 * i}.bias"] = 0.1 * torch.randn(dout, generator=g)
    for name, out in (("action_net", 2), ("value_net", 1)):
        sd[f"{name}.weight"] = torch.randn(out, 64, generator=g) / 8.0
        sd[f"{name}.bias"] = 0.1 * torch.randn(out, generator=g)
    buf = io.BytesIO()
    torch.save(sd, buf)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("policy.pth", buf.getvalue())
        zf.writestr("data", json.dumps({"activation_fn": "<class 'torch.nn.modules.activation.Tanh'>"}))


def run_sb3_expert(torch, dev, root):
    """An SB3 ``model.zip`` expert: loaded by ``load_policy("ppo", ...)`` on
    the card and on the CPU, its actions and log-probs on 4,096 seeded
    CartPole observations equal within 1e-5; then ``train_imitation bc
    with expert.policy_type=ppo`` from the zip through ``ex.run_cli``
    (COMPLETED). Neither kernel is on this path."""
    import numpy as np

    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.policies import serialize as policy_serialize

    phase = "sb3_expert"
    path = os.path.join(root, "sb3_model.zip")
    sb3_zip(torch, path)
    on_card = policy_serialize.load_policy("ppo", make_vec_env("CartPole-v1", num_envs=8, device=dev), path=path)
    on_cpu = policy_serialize.load_policy("ppo", make_vec_env("CartPole-v1", num_envs=8, device="cpu"), path=path)
    if {p.device.type for p in on_card.parameters()} != {"cuda"}:
        raise AssertionError(f"{phase}: the policy is not on the card")
    obs = np.random.default_rng(0).normal(scale=0.5, size=(4096, 4)).astype(np.float32)
    out = {}
    for name, policy, device in (("card", on_card, dev), ("cpu", on_cpu, "cpu")):
        x = torch.from_numpy(obs).to(device)
        with torch.no_grad():
            dist = policy.distribution(x)
            lp = torch.stack([dist.log_prob(torch.full((4096,), a, dtype=torch.int32, device=device))
                              for a in (0, 1)])
            acts = policy.deterministic_fn()(x)[0]
        out[name] = (acts.cpu().numpy(), lp.cpu().numpy())
    err = float(np.abs(out["card"][1] - out["cpu"][1]).max())
    same_acts = int((out["card"][0] == out["cpu"][0]).sum())
    # An action may flip only where its two log-probs tie within the tolerance.
    ties = int((np.abs(out["cpu"][1][0] - out["cpu"][1][1]) <= 2e-5).sum())
    if err > 1e-5 or same_acts + ties < 4096:
        raise AssertionError(f"{phase}: card vs CPU log-prob diff {err:.3g}, {same_acts} of 4096 actions equal")
    log(phase, f"load_policy('ppo', path=<model.zip>) on the card and on the CPU: log-probs max abs diff "
               f"{err:.3g} (limit 1e-5), actions equal {same_acts} of 4096 (both actions taken: "
               f"{0 < out['card'][0].sum() < 4096})")
    zero_counts()
    result, _ = cli_run(torch, phase, "train_imitation",
                        ["bc", "with", "bc_cartpole", "bc.n_epochs=1", "expert.policy_type=ppo",
                         f"expert.loader_kwargs.path={path}"], root)
    finite_stats(phase, result["imit_stats"])
    log(phase, f"bc from the SB3 expert: {stats_line(result['imit_stats'])}; kernel launches {counts()}")
    if any(counts().values()):
        raise AssertionError(f"{phase}: BC launches neither kernel: {counts()}")


def run_cli_preference_pendulum(torch, dev, root):
    """``train_preference_comparisons with active env_name=Pendulum-v1``,
    cut as rlhf_active_pendulum: B1 at [128, 8] once per PPO iteration
    (2 a training of the agent, 3 trainings)."""
    phase = "cli_preference_pendulum"
    log(phase, "cut: num_iterations 2 instead of 10; total_timesteps 4,096 instead of 20,000; "
               "total_comparisons 80 instead of 400")
    zero_counts()
    result, run_dir = cli_run(torch, phase, "train_preference_comparisons", [
        "with", "active", "env_name=Pendulum-v1", "num_iterations=2", "total_timesteps=4096",
        "total_comparisons=80"], root)
    launches = counts()
    finite_stats(phase, result["rollout"])
    log(phase, f"launches {launches}; reward_loss {result['reward_loss']:.4g}, reward_accuracy "
               f"{result['reward_accuracy']:.4g}; rollout {stats_line(result['rollout'])}")
    if not (math.isfinite(result["reward_loss"]) and math.isfinite(result["reward_accuracy"])):
        raise AssertionError(f"{phase}: non-finite reward metrics {result}")
    want = {"gae": 3 * 2, "assemble_rows": 0}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, expected {want}")
    return {phase: launches}


def run_cli_main(torch, root):
    """``python -m imitation_tpu_torch train_imitation bc with fast`` in a
    subprocess from the checkout: exit 0, run.json COMPLETED; the kernel
    library in ``_build/`` is left as it is (BC loads none of it)."""
    from imitation_tpu_torch.ops import kernels

    phase = "cli_main"
    here = os.path.dirname(os.path.abspath(__file__))
    build = kernels.library_path().parent

    def build_files():
        return {f: os.stat(os.path.join(build, f)).st_mtime_ns for f in os.listdir(build)}

    before = build_files()
    log_root = os.path.join(root, phase)
    cmd = [sys.executable, "-m", "imitation_tpu_torch", "train_imitation", "bc", "with", "fast",
           f"log_root={log_root}"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=here, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"{phase}: exit {out.returncode}: {out.stderr[-2000:]}")
    (env_dir,) = os.listdir(log_root)
    run_dir = os.path.realpath(os.path.join(log_root, env_dir, "latest"))
    with open(os.path.join(run_dir, "run.json")) as f:
        run = json.load(f)
    if run["status"] != "COMPLETED" or build_files() != before:
        raise AssertionError(f"{phase}: {run['status']}; _build changed: {before} -> {build_files()}")
    in_run = (datetime.datetime.fromisoformat(run["stop_time"])
              - datetime.datetime.fromisoformat(run["start_time"])).total_seconds()
    log(phase, f"{' '.join(cmd[1:-1])}: exit 0 in {seconds:.2f} s, {in_run:.2f} s of it between run.json's "
               f"start and stop (the rest: interpreter, imports, CUDA context); run.json "
               f"COMPLETED, imit_stats return_mean {run['result']['imit_stats']['return_mean']:.6g}; "
               f"_build/ unchanged ({', '.join(sorted(before))}); files {', '.join(run_files(run_dir))}")


# -- the examples, the interactive policy and the writers ------------------------

# Each ported example's main at tests/test_examples.py's budgets (the quickstart
# and the RLHF example take none): (phase, module under
# imitation_tpu_torch.examples, keyword arguments, a line it prints).
EXAMPLES = (
    ("ex_t01_bc", "tutorials.t01_train_bc", {}, "return after BC"),
    ("ex_t02_dagger", "tutorials.t02_train_dagger", {"total_timesteps": 1000}, "DAgger return"),
    ("ex_t03_gail", "tutorials.t03_train_gail", {"total_timesteps": 4096}, "GAIL return"),
    ("ex_t04_airl", "tutorials.t04_train_airl", {"total_timesteps": 4096}, "AIRL return"),
    ("ex_t05_rlhf", "tutorials.t05_preference_comparisons",
     {"total_timesteps": 4000, "total_comparisons": 40}, "reward loss"),
    ("ex_t05a_rlhf_cnn", "tutorials.t05a_preference_comparisons_cnn",
     {"total_timesteps": 2000, "total_comparisons": 30}, "CNN reward loss"),
    ("ex_t06_mce", "tutorials.t06_train_mce", {}, "occupancy gap"),
    ("ex_t07_density", "tutorials.t07_train_density", {"rl_timesteps": 1024}, "true-env return"),
    ("ex_t08_sqil", "tutorials.t08_train_sqil", {"total_timesteps": 1000}, "SQIL return"),
    ("ex_t08a_sqil_sac", "tutorials.t08a_train_sqil_sac", {"total_timesteps": 500}, "SQIL-SAC return"),
    ("ex_t09_baselines", "tutorials.t09_compare_baselines", {"n_seeds": 2, "n_epochs": 1}, "P(BC > random)"),
    ("ex_t10_custom_env", "tutorials.t10_train_custom_env", {"ppo_iters": 5}, "BC return"),
    ("ex_quickstart", "quickstart", {}, "AIRL return"),
    ("ex_rlhf_example", "rlhf_preference_comparisons", {}, "final reward loss"),
)


def run_example(torch, dev, phase, module, kwargs, expect):
    """``main(device=dev, **kwargs)`` of an example, its printed lines kept
    apart (the loggers' tables included) and its last lines printed, with
    the kernels' launch counts set to 0 just before and read just after:
    B1 once per PPO iteration (``PPO.process_chunk`` calls, counted here)
    and B2 once per disc step (``_disc_step`` calls). Returns (launches,
    seconds)."""
    import contextlib
    import importlib
    import io

    from imitation_tpu_torch.algorithms.adversarial.common import AdversarialTrainer
    from imitation_tpu_torch.rl.ppo import PPO

    calls = {"ppo_iterations": 0, "disc_steps": 0}
    originals = {(PPO, "process_chunk"): "ppo_iterations", (AdversarialTrainer, "_disc_step"): "disc_steps"}

    def counted(fn, key):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    saved = {(cls, name): getattr(cls, name) for cls, name in originals}
    for (cls, name), key in originals.items():
        setattr(cls, name, counted(saved[(cls, name)], key))
    out = io.StringIO()
    try:
        main = importlib.import_module(f"imitation_tpu_torch.examples.{module}").main
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main(device=dev, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts()
    finally:
        for (cls, name), fn in saved.items():
            setattr(cls, name, fn)
    lines = [line.strip() for line in out.getvalue().splitlines()
             if line.strip() and not line.startswith(("|", "---"))]
    if not any(expect in line for line in lines):
        raise AssertionError(f"{phase}: {module}.main printed no {expect!r} line: {lines[-5:]}")
    want = {"gae": calls["ppo_iterations"], "assemble_rows": calls["disc_steps"]}
    log(phase, f"{module}.main({', '.join(f'{k}={v}' for k, v in kwargs.items())}) on {dev}: {seconds:.2f} s; "
               f"{calls['ppo_iterations']} PPO iterations, {calls['disc_steps']} disc steps, launches {launches}; "
               f"printed: " + " / ".join(lines[-3:]))
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, expected one B1 per PPO iteration and one B2 "
                             f"per disc step: {want}")
    return launches, seconds


def run_examples(torch, dev):
    """Every example of ``EXAMPLES``; returns the launches of each path that
    launches a kernel."""
    paths, total = {}, 0.0
    for phase, module, kwargs, expect in EXAMPLES:
        launches, seconds = run_example(torch, dev, phase, module, kwargs, expect)
        total += seconds
        if any(launches.values()):
            paths[phase] = launches
    log("examples", f"{len(EXAMPLES)} mains in {total:.2f} s; kernel paths {sorted(paths)}")
    for phase in ("ex_t03_gail", "ex_t04_airl", "ex_quickstart"):
        if not (paths[phase]["gae"] and paths[phase]["assemble_rows"]):
            raise AssertionError(f"{phase}: both kernels should launch: {paths[phase]}")
    for phase in ("ex_t05_rlhf", "ex_t07_density", "ex_t10_custom_env", "ex_rlhf_example"):
        if not paths[phase]["gae"] or paths[phase]["assemble_rows"]:
            raise AssertionError(f"{phase}: B1 and no B2 should launch: {paths[phase]}")
    return paths


def run_interactive(torch, dev, num_envs=4, steps=16):
    """``cartpole_interactive_policy`` on device CartPole through its
    ``as_rollout_fn`` for ``steps`` steps, fed scripted keys (an invalid key
    before every third answer): the actions come back int32 on the card and
    equal the keys' actions; one prompt per query and per invalid key."""
    import builtins
    import contextlib
    import io

    import numpy as np

    from imitation_tpu_torch.data import rollout
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.policies.interactive import cartpole_interactive_policy

    phase = "interactive"
    venv = make_vec_env("CartPole-v1", num_envs=num_envs, max_episode_steps=steps, device=dev)
    policy = cartpole_interactive_policy(venv.observation_space, venv.action_space)
    want = np.random.default_rng(0).integers(0, 2, (steps, num_envs))
    keys = []
    for i, a in enumerate(want.reshape(-1)):
        keys += (["x"] if i % 3 == 0 else []) + ["ad"[a]]
    it = iter(keys)
    prompts = []
    original = builtins.input
    builtins.input = lambda prompt="": (prompts.append(prompt), next(it))[1]
    out = io.StringIO()
    generator = torch.Generator(device=dev).manual_seed(0)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            _, chunk = rollout.collect(venv, policy.as_rollout_fn(), venv.reset(generator), steps, generator)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        builtins.input = original
    invalid = out.getvalue().count("Invalid key")
    log(phase, f"{steps} steps x {num_envs} device CartPole envs through as_rollout_fn, {len(keys)} scripted "
               f"keys ({invalid} invalid, re-prompted): {seconds:.3f} s ({1e3 * seconds / steps:.2f} ms a step: "
               f"one host read of the observations and one copy of the actions back); actions "
               f"{chunk.acts.dtype} on {chunk.acts.device}")
    if chunk.acts.device != venv.device or chunk.acts.dtype != torch.int32:
        raise AssertionError(f"{phase}: actions {chunk.acts.dtype} on {chunk.acts.device}, not int32 on the card")
    if not np.array_equal(chunk.acts.cpu().numpy(), want) or len(prompts) != len(keys) or \
            invalid != len(keys) - want.size:
        raise AssertionError(f"{phase}: the actions or prompts differ from the scripted keys")


def run_hf_roundtrip(torch, dev):
    """Card rollouts (the scripted experts on CartPole and Pendulum) through
    ``data.serialize.save`` (the port's HuggingFace writer) and ``load``:
    the directory's files and features, every episode's arrays exactly,
    with their dtypes (rewards float64), sizes and seconds."""
    import numpy as np

    from imitation_tpu_torch.data import serialize

    phase = "hf_roundtrip"
    for env_name, num_envs, episodes in (("CartPole-v1", 16, 32), ("Pendulum-v1", 16, 64)):
        demos, _ = expert_demos(torch, phase, env_name, num_envs, episodes, dev)
        with tempfile.TemporaryDirectory(prefix="itt_hf_") as d:
            t0 = time.perf_counter()
            serialize.save(d, demos)
            t_save = time.perf_counter() - t0
            files = sorted(os.listdir(d))
            size = sum(os.path.getsize(os.path.join(d, f)) for f in files)
            t0 = time.perf_counter()
            loaded = serialize.load(d)
            loaded = [loaded[i] for i in range(len(loaded))]
            t_load = time.perf_counter() - t0
            with open(os.path.join(d, "dataset_info.json")) as f:
                features = json.load(f)["features"]
        if files != ["data-00000-of-00001.arrow", "dataset_info.json", "state.json"]:
            raise AssertionError(f"{phase}: files {files}")
        for got, want in zip(loaded, demos):
            for field in ("obs", "acts", "rews"):
                a, b = getattr(got, field), getattr(want, field)
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    raise AssertionError(f"{phase}: {env_name} {field} {a.dtype} differs from {b.dtype}")
            if bool(got.terminal) != bool(want.terminal) or len(got.infos) != len(want):
                raise AssertionError(f"{phase}: {env_name} terminal or infos differ")
        if len(loaded) != len(demos) or features["rews"]["feature"]["dtype"] != "float64":
            raise AssertionError(f"{phase}: {len(loaded)} of {len(demos)} episodes, features {features}")
        log(phase, f"{env_name}: {len(demos)} episodes, {sum(len(t) for t in demos)} steps from the card: save "
                   f"{t_save:.3f} s, load {t_load:.3f} s, {size} bytes ({', '.join(files)}); obs "
                   f"{features['obs']['feature']['feature']['dtype']}, acts {demos[0].acts.dtype}, rews float64; "
                   f"every array equal")


def crc32c_bitwise(data: bytes) -> int:
    """CRC-32C bit by bit, independent of the port's table-driven one."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 & -(crc & 1))
    return crc ^ 0xFFFFFFFF


def checked_tfrecords(path):
    """The records of a TFRecord file, each of its two masked CRCs checked."""
    def masked(data):
        crc = crc32c_bitwise(data)
        return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF

    with open(path, "rb") as f:
        data = f.read()
    records, pos = [], 0
    while pos < len(data):
        head = data[pos:pos + 8]
        (length,), (head_crc,) = struct.unpack("<Q", head), struct.unpack("<I", data[pos + 8:pos + 12])
        body = data[pos + 12:pos + 12 + length]
        (body_crc,) = struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])
        if masked(head) != head_crc or masked(body) != body_crc or len(body) != length:
            raise AssertionError(f"{path}: record at byte {pos} fails its CRC")
        records.append(body)
        pos += 16 + length
    return records


# -- the host-env path ---------------------------------------------------------

# bench.py:106-180's main-path GAIL learner at benchmarking/run_parity.py:57's
# ("gail", "seals_half_cheetah") HPs: (demo batch, replay capacity, disc
# updates, rl batch, minibatch, clip, ent, lambda, gamma, lr, max_grad_norm,
# epochs, vf).
HOST_GAIL_HPS = (8192, 512, 8, 4096, 64, 0.1, 3.99e-6, 0.95, 0.95, 2.63e-4, 0.8, 5, 0.115)


def thread_counts(torch, venv=None) -> str:
    engine = f"engine threads {venv.num_threads}, " if venv is not None else ""
    return f"{engine}torch intra-op threads {torch.get_num_threads()}, os.cpu_count() {os.cpu_count()}"


def run_host_envs(torch, dev, n=64, steps=2000):
    """The C++ host env engine: its ``g++`` build at first use; one step of
    each engine env type against ``envs/classic.py`` on the CPU from the
    same states (50 steps of random actions, 64 envs; Pendulum's state is
    atan2(sin, cos) and theta_dot), within 1e-6; env steps per second at
    ``n`` envs under random actions, on the engine's default threads and on
    one."""
    import numpy as np

    from imitation_tpu_torch.envs import classic
    from imitation_tpu_torch.native import ENV_TYPES, CppVectorEnv, build

    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    log("host_envs", f"g++ build + load {build_s:.2f} s -> {build.library_path().name}")
    classes = (classic.CartPole, classic.Pendulum, classic.MountainCar, classic.MountainCarContinuous)
    rng = np.random.default_rng(0)

    def actions(space, k):
        if space.is_discrete:
            return rng.integers(0, space.n, k)
        return rng.uniform(-1.2 * space.high, 1.2 * space.high, (k,) + space.shape).astype(np.float32)

    for name in ("CartPole-v1", "Pendulum-v1", "MountainCar-v0", "MountainCarContinuous-v0"):
        env_type, fixed = ENV_TYPES[name]
        venv = CppVectorEnv(name, num_envs=n, seed=3, device=dev)
        env = classes[env_type](fixed_horizon=fixed)
        obs, worst, ends = venv.reset(), 0.0, 0
        for _ in range(50):
            acts = actions(venv.action_space, n)
            state = np.stack([np.arctan2(obs[:, 1], obs[:, 0]), obs[:, 2]], -1) if env_type == 1 else obs
            a = torch.from_numpy(acts if acts.dtype == np.float32 else acts.astype(np.int32))
            _, ts = env.step(torch.from_numpy(state.astype(np.float32)), a)
            out = venv.step(acts)
            worst = max(worst, float(np.abs(ts.obs.numpy() - out["terminal_obs"]).max()),
                        float(np.abs(ts.reward.numpy() - out["reward"]).max()))
            if not (np.allclose(ts.obs.numpy(), out["terminal_obs"], rtol=1e-6, atol=1e-6)
                    and np.allclose(ts.reward.numpy(), out["reward"], rtol=1e-6, atol=1e-6)
                    and np.array_equal(ts.terminated.numpy(), out["terminated"])):
                raise AssertionError(f"host_envs: {name}: the engine's step disagrees with envs/classic.py")
            ends += int((out["terminated"] | out["truncated"]).sum())
            obs = out["obs"]
        log("host_envs", f"{name} x{n}: engine step vs envs/classic.py on the CPU, 50 steps: "
                         f"max abs diff {worst:.3g} (allclose 1e-6), {ends} episode ends")
        venv.close()
    rates = {}
    for threads in (None, 1):
        venv = CppVectorEnv("Pendulum-v1", num_envs=n, seed=0, num_threads=threads, device=dev)
        venv.reset()
        acts = rng.uniform(-2, 2, (steps, n, 1)).astype(np.float32)
        t0 = time.perf_counter()
        for a in acts:
            venv.step(a)
        secs = time.perf_counter() - t0
        rates[venv.num_threads] = n * steps / secs
        log("host_envs", f"Pendulum-v1 x{n}: {steps} steps in {secs:.3f} s = {n * steps / secs:.0f} env "
                         f"steps/s ({1e3 * secs / steps:.4f} ms a step call; {thread_counts(torch, venv)})")
        venv.close()
    return build_s, rates


def host_gail(torch, dev, demos, overlap, venv):
    """A GAIL trainer at ``HOST_GAIL_HPS`` over the host vector env ``venv``,
    a (32, 32) ``ActorCriticPolicy`` with ``normalize_features`` and
    ``BasicRewardNet(normalize_input=True)``. Its generator's
    ``process_chunk`` records each chunk's field devices."""
    from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
    from imitation_tpu_torch.data.rollout import CHUNK_FIELDS
    from imitation_tpu_torch.models.policies import ActorCriticPolicy
    from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
    from imitation_tpu_torch.rl.ppo import PPOConfig

    demo_bs, replay, n_disc, rl_batch, mb, clip, ent, lam, gamma, lr, mgn, epochs, vf = HOST_GAIL_HPS
    num_envs = venv.num_envs
    obs_space, act_space = venv.observation_space, venv.action_space
    trainer = GAIL(
        demonstrations=demos, demo_batch_size=demo_bs, venv=venv,
        policy=ActorCriticPolicy(obs_space, act_space, hid_sizes=(32, 32), normalize_features=True),
        reward_net=BasicRewardNet(obs_space, act_space, normalize_input=True),
        gen_config=PPOConfig(n_steps=rl_batch // num_envs, n_minibatches=rl_batch // mb, n_epochs=epochs,
                             learning_rate=lr, gamma=gamma, gae_lambda=lam, clip_range=clip, ent_coef=ent,
                             vf_coef=vf, max_grad_norm=mgn, overlap_collection=overlap),
        n_disc_updates_per_round=n_disc, gen_replay_buffer_capacity=replay,
        custom_logger=make_logger(), seed=0)
    gen = trainer.gen_algo
    process = gen.process_chunk
    trainer.chunk_devices = set()

    def recording(state, env_state, chunk, generator, reward_params=None):
        trainer.chunk_devices.update(getattr(chunk, f).device.type for f in CHUNK_FIELDS)
        trainer.chunk_devices.update(v.device.type for v in chunk.aux.values())
        trainer.chunk_dtypes = {f: getattr(chunk, f).dtype for f in ("obs", "next_obs")}
        trainer.chunk_shape = tuple(chunk.acts.shape[:2])
        return process(state, env_state, chunk, generator, reward_params)

    gen.process_chunk = recording
    return trainer


def close_host_trainer(trainer) -> None:
    """Joins and stops the generator's collection thread and closes the engine."""
    gen = trainer.gen_algo
    gen.discard_pending_collection()
    if gen._collect_pool is not None:
        gen._collect_pool.shutdown(wait=True)
        gen._collect_pool = None
    trainer.venv.close()


def host_gail_modes(torch, dev, phase, demos, make_venv, modes, rounds=2):
    """GAIL at bench.py's main-path learner configuration over the host env
    ``make_venv()`` (64 envs), in each of ``modes`` (``overlap_collection``
    False, True) on a fresh trainer (bench.py:187-196): a warm-up round,
    ``rounds`` timed rounds of ``train`` with the launch counts set to 0
    just before and read just after (B1 once and B2 8 times a round,
    asserted), then ``rounds`` more under the generator's ``PhaseTimer``
    (an overlapped ``train`` call collects its first chunk in the
    foreground and joins the rest). Parameters, buffers and every chunk
    field on CUDA, the chunk's observations float32 (asserted); the reward
    on the card against a CPU copy on the last mode's trainer. Returns the
    launches of the last mode's timed rounds and {mode: s per round}."""
    from imitation_tpu_torch.util.profiling import PhaseTimer

    n_disc = HOST_GAIL_HPS[2]
    results, launches = {}, None
    for overlap in modes:
        mode = "overlapped" if overlap else "serialized"
        trainer = host_gail(torch, dev, demos, overlap, make_venv())
        try:
            t0 = time.perf_counter()
            trainer.train(trainer.gen_train_timesteps)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            ends = []
            zero_counts()
            t0 = time.perf_counter()
            trainer.train(rounds * trainer.gen_train_timesteps, callback=lambda r: ends.append(time.perf_counter()))
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            got = counts()
            want = {"gae": rounds, "assemble_rows": n_disc * rounds}
            if got != want:
                raise AssertionError(f"{phase}: {mode} launches {got}, expected {want}")
            launches = got
            per = [ends[0] - t0] + [b - a for a, b in zip(ends, ends[1:])]
            timer = PhaseTimer()
            trainer.gen_algo.phase_timer = timer
            t1 = time.perf_counter()
            trainer.train(rounds * trainer.gen_train_timesteps)
            torch.cuda.synchronize()
            split = {k[5:-2]: v for k, v in timer.report().items() if not k.endswith("_mean_s")}
            results[overlap] = elapsed / rounds
            log(phase, f"{mode}: warm-up {warm:.3f} s; {rounds} rounds in {elapsed:.3f} s = "
                       f"{', '.join(f'{x:.3f}' for x in per)} s ({trainer.gen_train_timesteps} env steps "
                       f"each, {trainer.gen_train_timesteps * rounds / elapsed:.0f} env steps/s); launches {got}; "
                       f"{rounds} more under the PhaseTimer in {time.perf_counter() - t1:.3f} s: "
                       + ", ".join(f"{k} {v:.4f} s" for k, v in sorted(split.items()))
                       + f"; {thread_counts(torch, trainer.venv)}")
            row = trainer.logger.rows[-1]
            log(phase, "logged: " + ", ".join(f"{k.split('/')[-1]} {row[k]:.4g}" for k in (
                "mean/gen/loss", "mean/gen/ep_return_mean", "mean/gen/true_rew_mean",
                "mean/gen/relabeled_rew_mean", "mean/disc/disc_loss", "mean/disc/disc_acc")))
            if not all(math.isfinite(row[k]) for k in ("mean/gen/loss", "mean/disc/disc_loss")):
                raise AssertionError(f"{phase}: non-finite losses")
            tensors = (list(trainer.policy.parameters()) + list(trainer.policy.buffers())
                       + list(trainer.reward_net.parameters()) + list(trainer.reward_net.buffers())
                       + [getattr(trainer._demo_store.batch, f) for f in ("obs", "acts")])
            if not all(t.device == dev for t in tensors) or trainer.chunk_devices != {dev.type}:
                raise AssertionError(f"{phase}: parameters or chunks off the card: {trainer.chunk_devices}")
            if set(trainer.chunk_dtypes.values()) != {torch.float32}:
                raise AssertionError(f"{phase}: chunk observations {trainer.chunk_dtypes}, expected float32")
            if trainer.chunk_shape != (64, 64):
                raise AssertionError(f"{phase}: chunk {trainer.chunk_shape}, expected [64, 64]")
            if not all(bool(torch.isfinite(p).all()) for p in trainer.policy.parameters()):
                raise AssertionError(f"{phase}: non-finite policy parameters")
            if overlap == modes[-1]:
                reward_cpu_check(torch, phase, trainer)
        finally:
            close_host_trainer(trainer)
    log(phase, f"policy, reward net, demo store and every chunk field (aux included) on cuda; chunk [64, 64] "
               f"float32; s/round " + ", ".join(f"{'overlapped' if o else 'serialized'} {x:.4f}"
                                                for o, x in results.items()))
    return launches, results


def run_gail_host_pendulum(torch, dev, rounds=1):
    """GAIL at bench.py's main-path learner configuration over 64 host
    Pendulum-v1 envs (200-step horizon), serialized only (the HalfCheetah
    phase runs both modes on the real env): ``host_gail_modes``, on 64
    scripted episodes made through ``generate_trajectories_host``."""
    from imitation_tpu_torch.data import rollout
    from imitation_tpu_torch.native import CppVectorEnv
    from imitation_tpu_torch.testing import experts

    phase = "gail_host_pendulum"
    t0 = time.perf_counter()
    demo_venv = CppVectorEnv("Pendulum-v1", num_envs=64, seed=1, device=dev)
    demos = rollout.generate_trajectories(experts.pendulum_expert_fn, demo_venv,
                                          rollout.make_min_episodes(64), rng=0)[:64]
    stats = rollout.rollout_stats(demos)
    rows = sum(len(d) for d in demos)
    log(phase, f"expert demos through generate_trajectories_host: {len(demos)} episodes, {rows} rows, "
               f"return mean {stats['return_mean']:.6g} (min {stats['return_min']:.6g}) "
               f"in {time.perf_counter() - t0:.2f} s")
    if rows != 12_800:
        raise AssertionError(f"{phase}: {rows} demo rows, expected 64 episodes of 200")
    demo_venv.close()
    launches, results = host_gail_modes(
        torch, dev, phase, demos, lambda: CppVectorEnv("Pendulum-v1", num_envs=64, seed=0, device=dev),
        (False,), rounds)
    return {phase: launches}, results[False]


HC_ENV = "seals/HalfCheetah-v1"
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "imitation_tpu_torch", "envs", "assets")
# phase -> (env, model file under ASSETS, the repo's expert under EXPERTS)
SEALS_ENV_PHASES = {
    "halfcheetah_env": (HC_ENV, "half_cheetah", "seals_half_cheetah"),
    "hopper_env": ("seals/Hopper-v1", "hopper", "seals_hopper"),
    "walker2d_env": ("seals/Walker2d-v1", "walker2d_v5", "seals_walker2d"),
    "swimmer_env": ("seals/Swimmer-v1", "swimmer", "seals_swimmer"),
}


def seals_returns(torch, dev, env_id, act, num_envs=16, seed=12345):
    """Returns of one 1000-step episode in each of ``num_envs`` port
    ``env_id`` envs from reset ``seed``, under ``act`` (a rollout closure
    on ``dev``) fed float32 observations on the card. 256 envs or more
    step on every core (nothing else runs beside them), fewer on the env's
    default threads."""
    import numpy as np

    from imitation_tpu_torch.envs.mujoco_native import MujocoLockstepVectorEnv

    threads = (os.cpu_count() or 1) if num_envs >= 256 else None
    venv = MujocoLockstepVectorEnv(env_id, num_envs=num_envs, num_threads=threads, device=dev)
    try:
        obs, ret = venv.reset(seed=seed), np.zeros(num_envs)
        for _ in range(venv.max_episode_steps):
            with torch.inference_mode():
                acts = act(torch.from_numpy(obs.astype(np.float32)).to(dev))[0]
            if acts.device != dev:
                raise AssertionError(f"seals_returns: actions on {acts.device}, expected {dev}")
            out = venv.step(acts.cpu().numpy())
            ret += out["reward"]
            obs = out["obs"]
        if not out["truncated"].all():
            raise AssertionError("seals_returns: the episodes did not end at the horizon")
        return ret
    finally:
        venv.close()


def run_seals_env(torch, dev, phase, n=64, steps=300, threads=(None, 1, 4, 8)):
    """One seals env of the port's engine (``native/mjtree.cpp``; Euler for
    HalfCheetah, RK4 for Hopper, Walker2d and Swimmer): its ``g++`` build at
    first use, timed; MuJoCo's own 64 env steps of the committed fixture
    (``<model>_fixture.npz``: states in contact, Hopper's capsule-capsule
    ones among them, actions beyond the control range) stepped at once and
    held within 1e-8 of their scale (rewards, the healthy reward included,
    within 1e-6); env steps per second at ``n`` envs under random actions,
    on the env's default threads and on 1, 4 and 8; and the repo's expert,
    deterministic on the card, over the fixture's envs (16 or 64) from reset
    seed 12345 (one 1000-step episode each): the mean return within 2% of
    the JAX env's figure in the fixture, every return finite. Reads the
    fixture with numpy only: MuJoCo is not on this machine."""
    import numpy as np

    from imitation_tpu_torch.envs.mujoco_native import MujocoEngine, MujocoLockstepVectorEnv, load_model
    from imitation_tpu_torch.native import build
    from imitation_tpu_torch.policies import serialize

    env_id, name, expert_dir = SEALS_ENV_PHASES[phase]
    t0 = time.perf_counter()
    build.load_mjtree()
    build_s = time.perf_counter() - t0
    log(phase, f"g++ build + load {build_s:.2f} s -> {build.library_path(build.MJTREE_SOURCE).name}")
    model = load_model(name)
    env = model["env"]
    fs = env["frame_skip"]
    dt = model["opt"]["timestep"] * fs
    fx = np.load(os.path.join(ASSETS, f"{name}_fixture.npz"))
    engine = MujocoEngine(model)
    q, v = fx["qpos"].copy(), fx["qvel"].copy()
    engine.step(q, v, fx["act"], fs)
    engine.close()
    errs = {k: float(np.abs(got - fx[k]).max() / max(1.0, np.abs(fx[k]).max()))
            for k, got in (("next_qpos", q), ("next_qvel", v))}
    reward = (env["forward_reward_weight"] * (q[:, 0] - fx["qpos"][:, 0]) / dt
              - env["ctrl_cost_weight"] * np.sum(np.square(fx["act"].astype(np.float64)), 1) + env["healthy_reward"])
    errs["reward"] = float(np.abs(reward - fx["reward"]).max() / max(1.0, np.abs(fx["reward"]).max()))
    integrator = ("Euler", "RK4")[model["opt"]["integrator"]]
    log(phase, f"MuJoCo's fixture, {len(q)} env steps of {fs} {integrator} substeps "
               f"({int((fx['ncon'] > 0).sum())} starting in contact, up to {int(fx['ncon'].max())} contacts): "
               "max error over scale " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
               + " (limits 1e-8, 1e-8, 1e-6)")
    if max(errs["next_qpos"], errs["next_qvel"]) > 1e-8 or errs["reward"] > 1e-6:
        raise AssertionError(f"{phase}: the engine disagrees with MuJoCo's fixture: {errs}")
    rng = np.random.default_rng(0)
    rates = {}
    for th in threads:
        venv = MujocoLockstepVectorEnv(env_id, num_envs=n, num_threads=th, device=dev)
        if th is not None and venv.num_threads in rates:
            venv.close()
            continue
        venv.reset(seed=0)
        acts = rng.uniform(-1, 1, (steps, n) + venv.action_space.shape).astype(np.float32)
        t0 = time.perf_counter()
        for a in acts:
            venv.step(a)
        secs = time.perf_counter() - t0
        rates[venv.num_threads] = n * steps / secs
        log(phase, f"{env_id} x{n}: {steps} steps in {secs:.3f} s = {n * steps / secs:.0f} env steps/s "
                   f"({1e3 * secs / steps:.4f} ms a step call of {fs} substeps; "
                   f"{'default' if th is None else 'asked'} {thread_counts(torch, venv)})")
        venv.close()
    expert = serialize.load_policy_from_path(os.path.join(EXPERTS, expert_dir, "policy"), device=dev)
    if not all(p.device == dev for p in expert.parameters()):
        raise AssertionError(f"{phase}: the expert is off the card")
    want_all = fx["expert_returns"]
    t0 = time.perf_counter()
    ret = seals_returns(torch, dev, env_id, expert.deterministic_fn(), num_envs=len(want_all))
    secs = time.perf_counter() - t0
    want = float(want_all.mean())
    log(phase, f"{type(expert).__name__} expert, deterministic on the card, {len(want_all)} envs x 1000 steps "
               f"from seed 12345 ({'every core' if len(want_all) >= 256 else 'default threads'}) in {secs:.2f} s: return mean {ret.mean():.6g} (std {ret.std():.4g}, "
               f"min {ret.min():.6g}, max {ret.max():.6g}); the JAX env's {want:.6g} (fixture): "
               f"{100 * (ret.mean() / want - 1):+.3f}% (limit 2%)")
    if not np.isfinite(ret).all() or abs(ret.mean() - want) > 0.02 * abs(want):
        raise AssertionError(f"{phase}: expert return {ret.mean()} against the JAX env's {want}")
    return dict(build_s=build_s, rates=rates, fixture=errs, expert=float(ret.mean()))


def run_gail_seals_half_cheetah(torch, dev, rounds=2):
    """GAIL at bench.py:106-180's configuration on the real env: 64
    seals/HalfCheetah-v1 envs of the port's engine, run_parity.py:57's
    ("gail", "seals_half_cheetah") HPs (``HOST_GAIL_HPS``) and the repo's
    48 expert episodes (output/experts/seals_half_cheetah/rollouts, 48,000
    rows), serialized and overlapped (``host_gail_modes``): B1 at [64, 64]
    once and B2 8 times a round at demo [48000], replay [512], B = 8192."""
    from imitation_tpu_torch.data import serialize as data_serialize
    from imitation_tpu_torch.envs.mujoco_native import MujocoLockstepVectorEnv

    phase = "gail_seals_half_cheetah"
    t0 = time.perf_counter()
    demos = list(data_serialize.load(os.path.join(EXPERTS, "seals_half_cheetah", "rollouts")))
    rows = sum(len(d) for d in demos)
    log(phase, f"expert demos: {len(demos)} episodes, {rows} rows, read in {time.perf_counter() - t0:.2f} s")
    if (len(demos), rows) != (48, 48_000):
        raise AssertionError(f"{phase}: {len(demos)} episodes of {rows} rows, expected 48 of 1000")
    launches, results = host_gail_modes(
        torch, dev, phase, demos, lambda: MujocoLockstepVectorEnv(HC_ENV, num_envs=64, seed=0, device=dev),
        (False, True), rounds)
    return {phase: launches}, results


def run_sac_host(torch, dev, num_envs=16, rounds=6):
    """SAC on 16 host Pendulum-v1 envs at sac_pendulum's widths (train_freq
    16, batch 256, (256, 256) nets, lr 3e-4), cut to 16 gradient steps a
    round and ``learning_starts`` 256: ``rounds`` rounds serialized, then
    overlapped, after one warm-up round each; the actor and critics on
    cuda, no kernel launched."""
    from imitation_tpu_torch.native import CppVectorEnv
    from imitation_tpu_torch.rl.sac import SAC, SACConfig

    out = {}
    for overlap in (False, True):
        venv = CppVectorEnv("Pendulum-v1", num_envs=num_envs, seed=0, device=dev)
        sac = SAC(venv, SACConfig(learning_rate=3e-4, batch_size=256, train_freq=16, gradient_steps=16,
                                  learning_starts=256, overlap_collection=overlap), seed=0)
        state = sac.learn(sac.init_state(), 16 * num_envs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = sac.learn(state, rounds * 16 * num_envs)
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / rounds
        state, metrics = sac.train_step(state)
        sac.discard_pending_collection()
        host = finite_metrics(torch, "sac_host_pendulum", metrics, ("critic_loss", "actor_loss"))
        on_card = all(p.device == dev for m in (sac.actor, sac.critic, sac.target_critic)
                      for p in m.parameters()) and state.buffer_state.data.obs.device == dev
        if not on_card:
            raise AssertionError("sac_host_pendulum: parameters or replay off the card")
        out[overlap] = secs
        log("sac_host_pendulum", f"{'overlapped' if overlap else 'serialized'}: {secs:.4f} s a round "
                                 f"({16 * num_envs} env steps, 16 updates of batch 256); "
                                 f"{state.timesteps} env steps, buffer {state.buffer_state.size}; "
                                 f"critic_loss {host['critic_loss']:.4g}, ep_return_mean "
                                 f"{host['ep_return_mean']:.4g}; {thread_counts(torch, venv)}")
        if sac._collect_pool is not None:
            sac._collect_pool.shutdown(wait=True)
        venv.close()
    return out


def run_sqil_host(torch, dev, steps=4_000, n_demos=10):
    """SQIL (DQN) on 8 host CartPole-v1 envs with ``overlap_collection`` at
    sqil_cartpole's settings (benchmarking/run_small_algos.py:52-67),
    4,000 of its 300,000 steps, on 10 scripted episodes made on host envs:
    steps and updates per second, the mixed batch half 0 then half 1."""
    from imitation_tpu_torch.algorithms.sqil import SQIL
    from imitation_tpu_torch.data import rollout
    from imitation_tpu_torch.native import CppVectorEnv
    from imitation_tpu_torch.rl.dqn import DQNConfig
    from imitation_tpu_torch.testing import experts

    phase = "sqil_host_cartpole"
    demo_venv = CppVectorEnv("CartPole-v1", num_envs=8, seed=1, device=dev)
    demos = rollout.generate_trajectories(experts.cartpole_expert_fn, demo_venv,
                                          rollout.make_min_episodes(n_demos), rng=0)[:n_demos]
    venv = CppVectorEnv("CartPole-v1", num_envs=8, seed=0, device=dev)
    cfg = DQNConfig(learning_starts=500, train_freq=4, batch_size=64, gradient_steps=4, learning_rate=1e-4,
                    target_update_interval=2000, exploration_fraction=0.3, exploration_final_eps=0.05,
                    overlap_collection=True)
    sqil = SQIL(venv=venv, demonstrations=demos, dqn_config=cfg, allow_variable_horizon=True,
                custom_logger=make_logger(), seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sqil.train(total_timesteps=steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st = sqil.state
    if sqil.rl._pending_chunk is not None or st.timesteps < steps:
        raise AssertionError(f"{phase}: {st.timesteps} steps, pending collection {sqil.rl._pending_chunk}")
    size, half = cfg.batch_size, cfg.batch_size // 2
    rews = sqil.sample_hook(sqil.rl.replay, st.buffer_state, torch.Generator(device=dev).manual_seed(3),
                            size).rews.cpu()
    if not ((rews[:half] == 0).all() and (rews[half:] == 1).all()):
        raise AssertionError(f"{phase}: the sampled batch is not half fresh zeros then half expert ones")
    if not all(bool(torch.isfinite(p).all()) and p.device == dev for p in sqil.rl.q_net.parameters()):
        raise AssertionError(f"{phase}: non-finite or off-card Q-network")
    log(phase, f"SQIL (DQN, overlapped host collection) {st.timesteps} env steps, {st.n_updates} updates in "
               f"{secs:.3f} s: {st.timesteps / secs:.1f} steps/s, {st.n_updates / secs:.1f} updates/s; "
               f"{sum(len(d) for d in demos)} expert rows; batch half 0 then half 1; {thread_counts(torch, venv)}")
    sqil.rl._collect_pool.shutdown(wait=True)
    venv.close()


def rlhf_host_pendulum(dev):
    """Preference comparisons over 16 host Pendulum-v1 envs with exploration
    (``exploration_frac`` 0.25: the exploration wrapper's ``host_policy_fn``
    through the host rollout path): PPO n_steps 64, 8 minibatches x 4
    epochs, a (32, 32) actor-critic with normalize_features,
    ``BasicRewardNet(normalize_input=True)``, fragments of 50 steps."""
    import numpy as np

    from imitation_tpu_torch.algorithms import preference_comparisons as pc
    from imitation_tpu_torch.models.policies import ActorCriticPolicy
    from imitation_tpu_torch.native import CppVectorEnv
    from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
    from imitation_tpu_torch.rl.ppo import PPO, PPOConfig

    venv = CppVectorEnv("Pendulum-v1", num_envs=16, seed=0, device=dev)
    policy = ActorCriticPolicy(venv.observation_space, venv.action_space, hid_sizes=(32, 32),
                               normalize_features=True)
    ppo = PPO(venv, policy, PPOConfig(n_steps=64, n_minibatches=8, n_epochs=4, learning_rate=2e-3,
                                      ent_coef=0.01, gamma=0.97, clip_range=0.1), seed=0)
    net = BasicRewardNet(venv.observation_space, venv.action_space, normalize_input=True)
    agent = pc.AgentTrainer(ppo, net, venv, rng=0, exploration_frac=0.25)
    return pc.PreferenceComparisons(
        agent, net, num_iterations=2, fragmenter=pc.RandomFragmenter(rng=0, warning_threshold=0),
        preference_gatherer=pc.SyntheticGatherer(rng=np.random.default_rng(0)), fragment_length=50,
        transition_oversampling=1.0, initial_comparison_frac=0.1, initial_epoch_multiplier=4.0,
        allow_variable_horizon=True, rng=0, seed=0, custom_logger=make_logger())


# -- dp: data-parallel ranks ----------------------------------------------------------

DP_WORLD = 2
DP_ROUNDS = 1
DP_LAUNCH_TIMEOUT_S = 300  # the launch of the ranks, start to join
DP_GROUP_TIMEOUT = datetime.timedelta(seconds=120)  # any one collective
DP_NUDGE = 1.2e-7  # about one float32 ulp of the weights: the floor's nudge
TP_WORLD, TP_SIZE = 4, 2  # the tp phase: dp = 2 by tp = 2 gloo ranks on the one card
TP_LAUNCH_TIMEOUT_S = 420


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def dp_params(module):
    """The parameters, tp-split ones gathered whole (a collective where any is split)."""
    from imitation_tpu_torch.parallel import mesh as mesh_mod

    names = dict(module.named_parameters())
    return {k: v.float().cpu().numpy().copy() for k, v in mesh_mod.full_state_dict(module).items() if k in names}


def dp_nudge(torch, modules, rel) -> None:
    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                p.mul_(1 + rel)


def dp_gail_trainer(torch, dev):
    """GAIL at gail_cartpole's tuned widths (64 CartPole envs x 128 steps,
    PPO batch 128 = 64 minibatches x 5 epochs, lr 1e-3, ent 0.01, a (32, 32)
    actor-critic, demo batch 1024, 4 disc updates, 10 scripted demos, the
    CLI's seed 0), its generator state made."""
    from imitation_tpu_torch.algorithms.adversarial.gail import GAIL
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
    from imitation_tpu_torch.rl.ppo import PPOConfig
    from imitation_tpu_torch.testing import experts

    demo_venv = make_vec_env("CartPole-v1", num_envs=10, device=dev)
    demos = experts.generate_expert_trajectories("CartPole-v1", demo_venv, min_episodes=10, seed=0)
    venv = make_vec_env("CartPole-v1", num_envs=64, device=dev)
    trainer = GAIL(demonstrations=demos, venv=venv, demo_batch_size=1024, n_disc_updates_per_round=4,
                   gen_config=PPOConfig(n_steps=128, n_minibatches=64, n_epochs=5, learning_rate=1e-3,
                                        ent_coef=0.01),
                   reward_net=BasicRewardNet(venv.observation_space, venv.action_space, normalize_input=False),
                   allow_variable_horizon=True, seed=0, custom_logger=make_logger())
    trainer.gen_state = trainer.gen_algo.init_state()
    return trainer


def dp_gail(torch, dev, mesh=None, rel=0.0, ckpt=None):
    """``dp_gail_trainer``'s GAIL ``train_fused`` for ``DP_ROUNDS`` rounds;
    over ``mesh``'s ranks when given, every rank building the same trainer
    (at tp > 1 its dense layers split by columns). Records the devices of
    the parameters (tp-split ones apart) and of every chunk field; with
    ``ckpt`` the generator state is saved there afterwards (every rank
    gathers, rank 0 writes)."""
    from imitation_tpu_torch.data.rollout import CHUNK_FIELDS
    from imitation_tpu_torch.parallel import mesh as mesh_mod
    from imitation_tpu_torch.util.checkpoint import save_state

    trainer = dp_gail_trainer(torch, dev)
    dp_nudge(torch, [trainer.policy, trainer.reward_net], rel)
    if mesh is not None:
        mesh_mod.shard_adversarial_trainer(trainer, mesh)
    params = list(trainer.policy.parameters()) + list(trainer.reward_net.parameters())
    devices = {"split": sorted({p.device.type for p in params if mesh_mod.is_tp_split(p)}),
               "whole": sorted({p.device.type for p in params if not mesh_mod.is_tp_split(p)}), "chunk": set()}
    n_split = sum(mesh_mod.is_tp_split(p) for p in params)
    gen = trainer.gen_algo
    process = gen.process_chunk

    def recording(state, env_state, chunk, generator, reward_params=None):
        devices["chunk"].update(getattr(chunk, f).device.type for f in CHUNK_FIELDS)
        devices["chunk"].update(v.device.type for v in chunk.aux.values())
        return process(state, env_state, chunk, generator, reward_params)

    gen.process_chunk = recording
    init = {"policy": dp_params(trainer.policy), "disc": dp_params(trainer.reward_net)}
    dp_sync(torch, dev)
    zero_counts()
    t0 = time.perf_counter()
    trainer.train_fused(DP_ROUNDS * trainer.gen_train_timesteps, rounds_per_sync=DP_ROUNDS)
    dp_sync(torch, dev)
    s_round = (time.perf_counter() - t0) / DP_ROUNDS
    launches = counts()
    want = {"gae": DP_ROUNDS, "assemble_rows": DP_ROUNDS * trainer.n_disc_updates_per_round}
    if launches != want:  # B1 once a round on the rank's columns, B2 once per disc step
        raise AssertionError(f"dp_gail: launches {launches}, expected {want}")
    if ckpt is not None:
        save_state(ckpt, trainer.gen_state)
    devices["chunk"] = sorted(devices["chunk"])
    ring = trainer._gen_buffer_state
    return dict(init=init, policy=dp_params(trainer.policy), disc=dp_params(trainer.reward_net),
                ring_obs=ring.data.obs.cpu().numpy(), ring_size=ring.size, launches=launches, s_round=s_round,
                local_envs=trainer.gen_state.env_state.obs.shape[0], timesteps=trainer.gen_state.timesteps,
                disc_step=trainer.disc_state.step, logged=trainer.logger.rows[-1], devices=devices,
                n_split=n_split)


def dp_sac(torch, dev, mesh=None, rel=0.0, rounds=4):
    """SAC on 16 Pendulum-v1 envs (train_freq 16, 16 gradient steps of batch
    256 a round, (256, 256) nets, learning_starts 512, a 4,096-row ring):
    ``rounds`` rounds, the last 3 learning; over ``mesh``'s ranks with the
    ring split."""
    from imitation_tpu_torch.envs import make_vec_env
    from imitation_tpu_torch.parallel import mesh as mesh_mod
    from imitation_tpu_torch.rl.sac import SAC, SACConfig

    venv = make_vec_env("Pendulum-v1", num_envs=16, device=dev)
    sac = SAC(venv, SACConfig(train_freq=16, gradient_steps=16, batch_size=256, learning_starts=512,
                              buffer_size=4096), seed=0)
    state = sac.init_state()
    dp_nudge(torch, [sac.actor, sac.critic], rel)
    if mesh is not None:
        state = mesh_mod.shard_sac_state(state, mesh)
    init = {"actor": dp_params(sac.actor), "critic": dp_params(sac.critic)}
    n_split = sum(mesh_mod.is_tp_split(p) for m in (sac.actor, sac.critic, sac.target_critic)
                  for p in m.parameters() if p.device.type == torch.device(dev).type)
    local_rows = state.buffer_state.data.batch_size
    zero_counts()
    dp_sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(rounds):
        state, metrics = sac.train_step(state)
    dp_sync(torch, dev)
    return dict(init=init, actor=dp_params(sac.actor), critic=dp_params(sac.critic), local_rows=local_rows,
                local_size=state.buffer_state.size, global_size=state.buffer_state.global_size,
                timesteps=state.timesteps, launches=counts(), s_round=(time.perf_counter() - t0) / rounds,
                critic_loss=float(metrics["critic_loss"]), n_split=n_split)


def dp_reward(torch, dev, mesh=None, rel=0.0):
    """One ``BasicRewardTrainer.train`` (batch 32, 3 epochs, lr 1e-3) of a
    ``BasicRewardNet(normalize_input=True)`` on 250 synthetic comparisons of
    Pendulum-shaped fragments of 50 steps (a trailing batch of 26: 16 pairs
    on rank 0, 10 on rank 1); over ``mesh``'s ranks with the batches split."""
    import types as pytypes

    import numpy as np

    from imitation_tpu_torch.algorithms import preference_comparisons as pc
    from imitation_tpu_torch.data import types
    from imitation_tpu_torch.envs.base import Space
    from imitation_tpu_torch.parallel import mesh as mesh_mod
    from imitation_tpu_torch.rewards.reward_nets import BasicRewardNet
    from imitation_tpu_torch.util.logger import configure

    rng = np.random.default_rng(0)
    trajs = [types.TrajectoryWithRew(obs=rng.normal(size=(201, 3)).astype(np.float32),
                                     acts=rng.uniform(-2, 2, size=(200, 1)).astype(np.float32),
                                     rews=rng.normal(size=200), infos=None, terminal=False) for _ in range(16)]
    logger = configure(format_strs=())
    fragments = pc.RandomFragmenter(rng=0, warning_threshold=0, custom_logger=logger)(trajs, 50, 250)
    dataset = pc.PreferenceDataset()
    dataset.push(fragments, pc.SyntheticGatherer(rng=0, custom_logger=logger)(fragments))
    obs_space = Space.box(np.array([-1, -1, -8], np.float32), np.array([1, 1, 8], np.float32), (3,))
    net = BasicRewardNet(obs_space, Space.box(-2.0, 2.0, (1,)), normalize_input=True).to(dev)
    net.init(torch.Generator(device=dev).manual_seed(0))
    dp_nudge(torch, [net], rel)
    trainer = pc.BasicRewardTrainer(pc.PreferenceModel(net), rng=0, batch_size=32, epochs=3, lr=1e-3,
                                    custom_logger=logger)
    if mesh is not None:
        mesh_mod.shard_preference_comparisons(
            pytypes.SimpleNamespace(reward_trainer=trainer, trajectory_generator=None), mesh)
    init = dp_params(net)
    n_split = sum(mesh_mod.is_tp_split(p) for p in net.parameters() if p.device.type == torch.device(dev).type)
    zero_counts()
    metrics = trainer.train(dataset)
    dp_sync(torch, dev)
    return dict(init={"net": init}, net=dp_params(net), metrics=dict(metrics), launches=counts(), n_split=n_split)


def dp_floor(exact, nudged, key, skip=()):
    """How far a one-ulp nudge of the initial weights moves the update of
    ``key``, relative to its largest entry (tests/torch_parity.py's
    ``update_floors``, one nudge)."""
    keys = [k for k in exact[key] if k not in skip]
    upd = {k: exact[key][k] - exact["init"][key][k] for k in keys}
    scale = max(abs(v).max() for v in upd.values())
    return max(abs(nudged[key][k] - nudged["init"][key][k] - upd[k]).max() for k in keys) / scale


def dp_close(phase, what, got, want, key, floor, skip=()):
    """``got``'s ``key`` parameters within ``max(1e-5, 4 x floor)`` of the
    largest update of ``want``'s (tests/torch_parity.py's
    ``param_tolerance``)."""
    keys = [k for k in want[key] if k not in skip]
    upd = max(abs(want[key][k] - want["init"][key][k]).max() for k in keys)
    err = max(abs(got[key][k] - want[key][k]).max() for k in keys)
    tol = max(1e-5, 4 * floor)
    log(phase, f"{what} {key}: max abs diff {err:.3g}, {err / upd:.3g} of the largest update {upd:.3g} "
               f"(limit {tol:.3g}; float32 floor {floor:.3g})")
    if not (upd > 0 and err <= tol * upd):
        raise AssertionError(f"{phase}: {what} {key} off by {err:.3g} against an update of {upd:.3g}")


def dp_equal_ranks(phase, ranks, key):
    for r, res in enumerate(ranks[1:], 1):
        for k, v in ranks[0][key].items():
            if not (res[key][k] == v).all():
                raise AssertionError(f"{phase}: rank {r}'s {key}.{k} differs from rank 0's")


def dp_rank_main(out_dir: str, device: str) -> int:
    """One rank of the dp or tp phase (``chip_smoke.py --dp-rank <dir>
    <device>``, started with torchrun's variables and ``ITT_TP``): joins the
    gloo group on ``device`` (every rank on the one card), runs GAIL, SAC
    and the reward trainer over the ``dp x tp`` mesh and writes its results
    to ``<dir>/rank<r>.pt``; at tp > 1 the GAIL generator state is saved to
    ``<dir>/gen.ckpt`` too."""
    import torch

    from imitation_tpu_torch.ops import kernels
    from imitation_tpu_torch.parallel import distributed
    from imitation_tpu_torch.parallel import mesh as mesh_mod

    dev = distributed.initialize("gloo", device=device, timeout=DP_GROUP_TIMEOUT)
    if dev.type == "cuda":
        kernels.load()  # the parent's build, found by its hash
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tp = int(os.environ.get("ITT_TP", "1"))
    mesh = mesh_mod.make_mesh(tp=tp)
    out = {"gail": dp_gail(torch, dev, mesh, ckpt=os.path.join(out_dir, "gen.ckpt") if tp > 1 else None)}
    out["sac"] = dp_sac(torch, dev, mesh)
    out["reward"] = dp_reward(torch, dev, mesh)
    for key in ("sac", "reward"):
        if out[key]["launches"] != {"gae": 0, "assemble_rows": 0}:
            raise AssertionError(f"dp_{key}: kernel launches {out[key]['launches']} on a path without either")
    torch.save(out, os.path.join(out_dir, f"rank{distributed.process_index()}.pt"))
    distributed.shutdown()
    return 0


def dp_launch(torch, phase, out_dir, dev, world=DP_WORLD, tp=1):
    """Starts ``world`` ranks of this script with torchrun's variables (a
    ``world / tp`` by ``tp`` mesh) and waits for them (``DP_LAUNCH_TIMEOUT_S``
    or ``TP_LAUNCH_TIMEOUT_S`` in all; every rank is killed when one fails
    or time runs out). Returns each rank's results."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), ITT_TP=str(tp))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", out_dir, str(dev)],
                                      cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.perf_counter() + (DP_LAUNCH_TIMEOUT_S if tp == 1 else TP_LAUNCH_TIMEOUT_S)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        for line in text.strip().splitlines()[-40:]:
            log(f"{phase}/rank{rank}", line)
        if p.returncode != 0:
            raise AssertionError(f"{phase}: rank {rank} exited {p.returncode}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def tp_resume(torch, dev, ckpt, want):
    """The generator state the tp ranks saved, restored into a fresh
    one-process trainer (``tp = 1``): its policy must be the ranks' gathered
    policy bit for bit; then one more ``train_fused`` round (B1 once, B2 4
    times, finite weights). Returns the round's launches and seconds."""
    from imitation_tpu_torch.util.checkpoint import restore_state

    trainer = dp_gail_trainer(torch, dev)
    trainer.gen_state = restore_state(ckpt, trainer.gen_algo.init_state())
    got = dp_params(trainer.policy)
    if sorted(got) != sorted(want) or not all((got[k] == v).all() for k, v in want.items()):
        raise AssertionError("tp_resume: the restored policy differs from the ranks' gathered policy")
    dp_sync(torch, dev)
    zero_counts()
    t0 = time.perf_counter()
    trainer.train_fused(trainer.gen_train_timesteps, rounds_per_sync=1)
    dp_sync(torch, dev)
    seconds = time.perf_counter() - t0
    launches = counts()
    if launches != {"gae": 1, "assemble_rows": trainer.n_disc_updates_per_round}:
        raise AssertionError(f"tp_resume: launches {launches}")
    if not all(torch.isfinite(p).all() for p in trainer.policy.parameters()):
        raise AssertionError("tp_resume: non-finite weights after the resumed round")
    return launches, seconds, trainer.gen_state.n_updates


def run_dp(torch, dev):
    """Data-parallel training (``imitation_tpu_torch.parallel``): GAIL
    ``train_fused`` at gail_cartpole's widths in one process, then over
    ``DP_WORLD`` gloo ranks sharing the card (ranks bitwise equal, within
    tolerance of the one-process run, B1 and B2 counted on each rank), SAC
    with the split ring and one reward-trainer ``train`` against their
    one-process runs, and GAIL again through ``initialize`` at world size 1
    (NCCL on the card; gloo where ``dev`` is the CPU, for a rehearsal).
    Returns the launch counts of the driven paths."""
    from imitation_tpu_torch.parallel import distributed
    from imitation_tpu_torch.parallel import mesh as mesh_mod

    phase = "dp_gail"
    log(phase, f"cut: {DP_ROUNDS} rounds of gail_cartpole.json's 500,000 timesteps (61); widths as tuned")
    paths = {}
    one = dp_gail(torch, dev)
    paths["dp_gail_w1"] = one["launches"]
    floors = {k: dp_floor(one, dp_gail(torch, dev, rel=DP_NUDGE), k) for k in ("policy", "disc")}
    log(phase, f"W=1: {one['s_round']:.3f} s per round (one process alone on the card); launches "
               f"{one['launches']}; logged gen/loss {one['logged']['mean/gen/loss']:.4g}, "
               f"disc/disc_loss {one['logged']['mean/disc/disc_loss']:.4g}")
    one_sac = dp_sac(torch, dev)
    sac_floors = {k: dp_floor(one_sac, dp_sac(torch, dev, rel=DP_NUDGE), k) for k in ("actor", "critic")}
    one_rew = dp_reward(torch, dev)
    bias = [k for k in one_rew["net"] if k.endswith("dense_out.bias")]
    rew_floor = dp_floor(one_rew, dp_reward(torch, dev, rel=DP_NUDGE), "net", bias)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="itt_dp_") as out_dir:
        ranks = dp_launch(torch, phase, out_dir, dev)
    log(phase, f"{DP_WORLD} gloo ranks on {dev}: launched, ran GAIL, SAC and the reward trainer and joined "
               f"in {time.perf_counter() - t0:.2f} s")
    gail = [r["gail"] for r in ranks]
    for r, res in enumerate(gail):
        paths[f"dp_gail_w{DP_WORLD}_rank{r}"] = res["launches"]
        if res["local_envs"] != 64 // DP_WORLD or res["timesteps"] != one["timesteps"]:
            raise AssertionError(f"{phase}: rank {r} stepped {res['local_envs']} envs, {res['timesteps']} steps")
    for key in ("policy", "disc"):
        dp_equal_ranks(phase, gail, key)
        dp_close(phase, f"W={DP_WORLD} against W=1:", gail[0], one, key, floors[key])
    same_ring = all((g["ring_obs"] == one["ring_obs"]).all() for g in gail)
    log(phase, f"ranks bitwise equal (policy, disc); every rank's replay ring "
               f"{'equal to' if same_ring else 'differs from'} the one-process ring "
               f"({one['ring_size']} rows); B1 at [128, {64 // DP_WORLD}] and B2 per rank: "
               f"{[g['launches'] for g in gail]}")
    per_rank = ", ".join(f"{g['s_round']:.3f}" for g in gail)
    log(phase, f"s per round: W=1 {one['s_round']:.3f} (one process alone on the card), W={DP_WORLD} "
               f"{per_rank} (ranks 0, 1: {DP_WORLD} processes sharing one card over gloo; not a scaling figure)")

    phase = "dp_sac"
    sac = [r["sac"] for r in ranks]
    for r, res in enumerate(sac):
        if res["local_rows"] != 4096 // DP_WORLD or res["global_size"] != one_sac["global_size"]:
            raise AssertionError(f"{phase}: rank {r} holds {res['local_rows']} ring rows, "
                                 f"global fill {res['global_size']}")
    for key in ("actor", "critic"):
        dp_equal_ranks(phase, sac, key)
        dp_close(phase, f"W={DP_WORLD} against W=1:", sac[0], one_sac, key, sac_floors[key])
    log(phase, f"ring split: {sac[0]['local_rows']} of 4096 rows a rank, {sac[0]['local_size']} filled of "
               f"{sac[0]['global_size']}; s per round W=1 {one_sac['s_round']:.3f}, W={DP_WORLD} "
               f"{sac[0]['s_round']:.3f} (two processes sharing one card); critic_loss "
               f"{sac[0]['critic_loss']:.4g} vs {one_sac['critic_loss']:.4g}")

    phase = "dp_reward"
    rew = [r["reward"] for r in ranks]
    dp_equal_ranks(phase, rew, "net")
    dp_close(phase, f"W={DP_WORLD} against W=1:", rew[0], one_rew, "net", rew_floor, bias)
    for res in (rew[0], one_rew):  # the output bias: rounding noise that Adam turns into steps of lr
        moved = max(abs(res["net"][k] - res["init"]["net"][k]).max() for k in bias)
        if moved > 1e-3 * 24 * (1 + 1e-5):
            raise AssertionError(f"{phase}: the output bias moved {moved:.3g}, more than lr per step")
    for k, v in one_rew["metrics"].items():
        if not math.isclose(rew[0]["metrics"][k], v, rel_tol=1e-4, abs_tol=1e-5):
            raise AssertionError(f"{phase}: metric {k} {rew[0]['metrics'][k]} vs {v}")
    log(phase, "metrics " + ", ".join(f"{k} {v:.4g}" for k, v in rew[0]["metrics"].items()))

    backend_w1 = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    phase = f"dp_gail_{backend_w1}"
    distributed.initialize(backend_w1, rank=0, world_size=1, init_method=f"tcp://127.0.0.1:{free_port()}",
                           device=dev, timeout=DP_GROUP_TIMEOUT)
    try:
        mesh = mesh_mod.make_mesh()
        w1 = dp_gail(torch, dev, mesh)
    finally:
        distributed.shutdown()
    paths[f"dp_gail_{backend_w1}_w1"] = w1["launches"]
    for key in ("policy", "disc"):
        dp_close(phase, "world size 1 against one process:", w1, one, key, floors[key])
    bitwise = all((w1[key][k] == one[key][k]).all() for key in ("policy", "disc") for k in one[key])
    log(phase, f"initialize('{backend_w1}') at world size 1: mesh {mesh.shape}, launches {w1['launches']}, "
               f"{w1['s_round']:.3f} s per round; {'bitwise equal to' if bitwise else 'within tolerance of'} "
               f"the one-process run")

    paths.update(run_tp(torch, dev, one, floors, (one_sac, sac_floors), (one_rew, rew_floor, bias)))
    return paths


def run_tp(torch, dev, one, floors, sac_ref, rew_ref):
    """Tensor parallelism: the dp phase's GAIL, SAC and reward-trainer runs
    over ``TP_WORLD`` gloo ranks sharing the card at ``dp = 2`` by
    ``tp = 2`` (every dense layer whose width divides by 2 split by output
    columns over the 2 ranks of a dp row), each held against the dp phase's
    one-process run and its float32 floor; the ranks bitwise equal; B1 and
    B2 counted on each rank. Then the generator state the ranks saved,
    resumed in this process at ``tp = 1``. Returns the launch counts."""
    one_sac, sac_floors = sac_ref
    one_rew, rew_floor, bias = rew_ref
    dp = TP_WORLD // TP_SIZE
    phase = "tp_gail"
    log(phase, f"cut: {DP_ROUNDS} rounds of gail_cartpole.json's 500,000 timesteps (61), as dp_gail; widths as "
               f"tuned; dp={dp} x tp={TP_SIZE}")
    paths = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="itt_tp_") as out_dir:
        ranks = dp_launch(torch, phase, out_dir, dev, world=TP_WORLD, tp=TP_SIZE)
        launch_s = time.perf_counter() - t0
        gail = [r["gail"] for r in ranks]
        resume_launches, resume_s, resume_updates = tp_resume(
            torch, dev, os.path.join(out_dir, "gen.ckpt"), gail[0]["policy"])
    log(phase, f"{TP_WORLD} gloo ranks on {dev} (dp={dp} x tp={TP_SIZE}): launched, ran GAIL, SAC and the "
               f"reward trainer and joined in {launch_s:.2f} s")
    dev_type = torch.device(dev).type
    for r, res in enumerate(gail):
        paths[f"tp_gail_rank{r}"] = res["launches"]
        if res["local_envs"] != 64 // dp or res["timesteps"] != one["timesteps"]:
            raise AssertionError(f"{phase}: rank {r} stepped {res['local_envs']} envs, {res['timesteps']} steps")
        if res["n_split"] != 14 or any(v != [dev_type] for v in res["devices"].values()):
            # policy: pi0, pi1, pi_out, vf0, vf1 (weight, bias); disc: dense0, dense1
            raise AssertionError(f"{phase}: rank {r}: {res['n_split']} split parameters, devices {res['devices']}")
    for key in ("policy", "disc"):
        dp_equal_ranks(phase, gail, key)
        dp_close(phase, f"dp={dp} x tp={TP_SIZE} against W=1:", gail[0], one, key, floors[key])
    log(phase, f"ranks bitwise equal (policy, disc); 14 split parameters a rank (policy pi0, pi1, pi_out, vf0, "
               f"vf1; disc dense0, dense1), every split parameter, whole parameter and chunk field on "
               f"{dev_type}; B1 at [128, {64 // dp}] and B2 per rank: {[g['launches'] for g in gail]}")
    per_rank = ", ".join(f"{g['s_round']:.3f}" for g in gail)
    log(phase, f"s per round: W=1 {one['s_round']:.3f} (one process alone on the card), dp={dp} x tp={TP_SIZE} "
               f"{per_rank} (ranks 0-3: {TP_WORLD} processes sharing one card over gloo; not a scaling figure)")

    phase = "tp_sac"
    sac = [r["sac"] for r in ranks]
    for key in ("actor", "critic"):
        dp_equal_ranks(phase, sac, key)
        dp_close(phase, f"dp={dp} x tp={TP_SIZE} against W=1:", sac[0], one_sac, key, sac_floors[key])
    if sac[0]["n_split"] != 20 or sac[0]["global_size"] != one_sac["global_size"]:
        # actor dense0, dense1; critic and target critic q0/q1_dense0/1 (weight, bias)
        raise AssertionError(f"{phase}: {sac[0]['n_split']} split parameters, fill {sac[0]['global_size']}")
    log(phase, f"20 split parameters a rank (actor dense0-1, critic and target q0/q1 dense0-1); s per round "
               f"W=1 {one_sac['s_round']:.3f}, dp={dp} x tp={TP_SIZE} "
               f"{sac[0]['s_round']:.3f} ({TP_WORLD} processes sharing one card)")

    phase = "tp_reward"
    rew = [r["reward"] for r in ranks]
    dp_equal_ranks(phase, rew, "net")
    dp_close(phase, f"dp={dp} x tp={TP_SIZE} against W=1:", rew[0], one_rew, "net", rew_floor, bias)
    for k, v in one_rew["metrics"].items():
        if not math.isclose(rew[0]["metrics"][k], v, rel_tol=1e-4, abs_tol=1e-5):
            raise AssertionError(f"{phase}: metric {k} {rew[0]['metrics'][k]} vs {v}")
    if rew[0]["n_split"] != 4:
        raise AssertionError(f"{phase}: {rew[0]['n_split']} split parameters")
    log(phase, "4 split parameters a rank; metrics " + ", ".join(f"{k} {v:.4g}" for k, v in rew[0]["metrics"].items()))

    phase = "tp_resume"
    paths["tp_resume_w1"] = resume_launches
    log(phase, f"the generator saved at dp={dp} x tp={TP_SIZE} (columns gathered, rank 0 wrote) restored here at "
               f"tp=1: policy bitwise equal to the ranks' gathered one; one more round {resume_s:.3f} s, "
               f"launches {resume_launches}, {resume_updates} gen updates in all")
    return paths


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    if not os.path.isdir(EXPERTS):
        print(f"chip_smoke: the seals experts are missing ({EXPERTS}); the checkout is incomplete",
              file=sys.stderr)
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
    log("build", f"nvcc ({len(kernels.SOURCES)} sources in parallel, then link) + load "
                 f"{time.perf_counter() - t0:.2f} s -> {kernels.library_path().name}")

    t0 = time.perf_counter()
    entries = check_kernels(torch, dev)
    log("kernels", f"done in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    reference_check(torch, dev)
    log("reference", f"done in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    run_envs(torch, dev)
    run_tabular_env(torch, dev)
    log("envs", f"done in {time.perf_counter() - t0:.2f} s")

    paths = {}
    t0 = time.perf_counter()
    launches, s_gail = run_gail(torch, dev)
    paths.update(launches)
    log("gail", f"done in {time.perf_counter() - t0:.2f} s; {s_gail:.3f} s per round")

    t0 = time.perf_counter()
    launches, s_airl, s_fused = run_airl(torch, dev)
    paths.update(launches)
    log("airl", f"done in {time.perf_counter() - t0:.2f} s; {s_airl:.3f} s per round (train), "
                f"{s_fused:.3f} s per round (train_fused)")

    t0 = time.perf_counter()
    paths.update(run_rl(torch, dev))
    log("rl", f"done in {time.perf_counter() - t0:.2f} s")

    # BC and DAgger launch neither kernel: their learner steps are eager
    # PyTorch, as the JAX package computes them outside any Pallas kernel.
    from imitation_tpu_torch.algorithms import dagger
    from imitation_tpu_torch.rl.dqn import DQNConfig
    from imitation_tpu_torch.rl.sac import SACConfig

    for phase, fn in (
        ("bc_cartpole", lambda: run_bc(
            torch, dev, "CartPole-v1", "bc_cartpole", dict(max_episode_steps=100),
            dict(batch_size=32, ent_weight=1e-3, l2_weight=0.0, optimizer_kwargs=dict(learning_rate=1e-3)),
            epochs=2, accumulate=dict(batch_size=64, minibatch_size=16))),
        ("bc_pendulum", lambda: run_bc(
            torch, dev, "Pendulum-v1", "bc_pendulum", {},
            dict(batch_size=64, l2_weight=1e-4, optimizer_kwargs=dict(learning_rate=1e-3)), epochs=2)),
        ("dagger_cartpole", lambda: run_dagger(
            torch, dev, "CartPole-v1", "dagger_cartpole", dagger.LinearBetaSchedule(15), 2000,
            max_episode_steps=200)),
        ("dagger_pendulum", lambda: run_dagger(
            torch, dev, "Pendulum-v1", "dagger_pendulum", dagger.ExponentialBetaSchedule(0.7), 2000)),
    ):
        t0 = time.perf_counter()
        zero_counts()
        fn()
        log(phase, f"done in {time.perf_counter() - t0:.2f} s; kernel launches {counts()}")

    # Off-policy learners and SQIL launch neither kernel (eager PyTorch, as
    # the JAX package computes them outside any Pallas kernel).
    for phase, fn in (
        ("sac_pendulum", lambda: run_sac(torch, dev)),
        ("sqil_cartpole", lambda: run_sqil(
            torch, dev, "CartPole-v1", "sqil_cartpole", 5_000, 10,
            dict(dqn_config=DQNConfig(learning_starts=500, train_freq=4, batch_size=64, gradient_steps=4,
                                      learning_rate=1e-4, target_update_interval=2000,
                                      exploration_fraction=0.3, exploration_final_eps=0.05)))),
        ("sqil_pendulum", lambda: run_sqil(
            torch, dev, "Pendulum-v1", "sqil_pendulum", 3_000, 10,
            dict(sac_config=SACConfig(learning_starts=500, batch_size=64, learning_rate=3e-4)))),
    ):
        t0 = time.perf_counter()
        zero_counts()
        fn()
        log(phase, f"done in {time.perf_counter() - t0:.2f} s; kernel launches {counts()}")

    t0 = time.perf_counter()
    launches, b2_sac = run_adversarial_sac(torch, dev)
    paths.update(launches)
    next(e for e in entries if e["name"] == "assemble_rows")["sac_disc_step"] = b2_sac
    log("airl_sac", f"done in {time.perf_counter() - t0:.2f} s")

    # Preference comparisons: PPO generators launch B1 once per PPO
    # iteration, at [64, 32] and [128, 8]; PEBBLE's SAC launches neither.
    for phase, make, budget, cuts in (
        ("rlhf_pendulum", rlhf_pendulum, (8_192, 60), (
            "2 iterations instead of 20", "8,192 timesteps instead of 400,000 (two PPO iterations of "
            "64 x 32 per agent training)", "60 comparisons instead of 600 (the preset's ~30 per iteration)")),
        ("rlhf_active_pendulum", lambda d: rlhf_cli(d, "ppo"), (4_096, 80), (
            "2 iterations instead of 10", "4,096 timesteps instead of 20,000",
            "80 comparisons instead of 400")),
        ("pebble_pendulum", lambda d: rlhf_cli(d, "sac"), (4_000, 80), (
            "2 iterations instead of 10", "4,000 timesteps instead of 20,000",
            "80 comparisons instead of 400")),
    ):
        t0 = time.perf_counter()
        paths[phase], _ = run_rlhf(torch, phase, make(dev), *budget, cuts)
        log(phase, f"done in {time.perf_counter() - t0:.2f} s")

    # MCE IRL is dense products and reductions (no kernel of the port);
    # density trains PPO on its KDE reward, one B1 launch per iteration at
    # [64, 16].
    for phase, fn in (("mceirl_random_mdp", lambda: run_mceirl_random_mdp(torch, dev)),
                      ("mceirl_large", lambda: run_mceirl_large(torch, dev))):
        t0 = time.perf_counter()
        fn()
        log(phase, f"done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    paths["density_pendulum"], _ = run_density(torch, dev)
    log("density_pendulum", f"done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    run_checkpoint(torch, dev)
    log("checkpoint", f"done in {time.perf_counter() - t0:.2f} s")

    # Image observations: GAIL and AIRL on pixel CartPole (B1 once per round,
    # B2 once per disc step, 1 KB f32 rows), the pixel tutorial's RLHF (B1
    # once per PPO iteration at [32, 8]) and NatureCNN BC (neither kernel).
    t_image = time.perf_counter()
    demos = pixel_demos(torch, "gail_pixel_cartpole", dev)
    for phase, fn in (("gail_pixel_cartpole", lambda: run_gail_pixel(torch, dev, demos)),
                      ("airl_pixel_cartpole", lambda: run_airl_pixel(torch, dev, demos)),
                      ("rlhf_pixel_cartpole", lambda: run_rlhf_pixel(torch, dev))):
        t0 = time.perf_counter()
        paths[phase], _ = fn()
        log(phase, f"done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    zero_counts()
    run_bc_nature_cnn(torch, dev)
    log("bc_nature_cnn", f"done in {time.perf_counter() - t0:.2f} s; kernel launches {counts()}")
    log("image", f"the image phases took {time.perf_counter() - t_image:.2f} s")

    # The repo's seals experts and demos read by the port's own readers, BC
    # on them and BC on dict observations: neither kernel is on these paths.
    # The port's seals/HalfCheetah, Hopper, Walker2d and Swimmer engines
    # against MuJoCo's fixtures and the JAX env's expert figures (neither
    # kernel), then GAIL over 64 HalfCheetah envs
    # at bench.py's main path (B1 at [64, 64] once a round, B2 8 times a
    # round at 2 x 8192 rows), serialized and overlapped.
    t_seals = time.perf_counter()
    env_phases = tuple((phase, lambda phase=phase: run_seals_env(torch, dev, phase)) for phase in SEALS_ENV_PHASES)
    for phase, fn in (("experts_seals", lambda: run_experts_seals(torch, dev)),
                      *env_phases,
                      ("bc_seals_half_cheetah", lambda: run_bc_seals_half_cheetah(torch, dev)),
                      ("bc_dict_obs", lambda: run_bc_dict_obs(torch, dev))):
        t0 = time.perf_counter()
        zero_counts()
        fn()
        if any(counts().values()):
            raise AssertionError(f"{phase}: kernel launches {counts()} on a path without either kernel")
        log(phase, f"done in {time.perf_counter() - t0:.2f} s; kernel launches {counts()}")
    t0 = time.perf_counter()
    launches, s_hc = run_gail_seals_half_cheetah(torch, dev)
    paths.update(launches)
    log("gail_seals_half_cheetah", f"done in {time.perf_counter() - t0:.2f} s; s per round serialized "
                                   f"{s_hc[False]:.3f}, overlapped {s_hc[True]:.3f}")
    log("seals", f"the seals and dict-observation phases took {time.perf_counter() - t_seals:.2f} s")

    # The CLI: each command through ``ex.run_cli`` as ``python -m
    # imitation_tpu_torch`` runs it, on the default device (CUDA).
    t_cli = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="itt_cli_") as root:
        for phase, fn in (("cli_gail_cartpole", lambda: run_cli_gail_cartpole(torch, dev, root)),
                          *((phase, lambda phase=phase: run_cli_gail_seals(torch, dev, root, phase))
                            for phase in SEALS_CLI),
                          ("cli_airl_pendulum", lambda: run_cli_airl_pendulum(torch, dev, root)),
                          ("cli_imitation_cartpole", lambda: run_cli_imitation_cartpole(torch, dev, root)),
                          ("cli_preference_pendulum", lambda: run_cli_preference_pendulum(torch, dev, root)),
                          ("cli_main", lambda: run_cli_main(torch, root)),
                          ("sb3_expert", lambda: run_sb3_expert(torch, dev, root))):
            t0 = time.perf_counter()
            paths.update(fn() or {})
            log(phase, f"done in {time.perf_counter() - t0:.2f} s")
    log("cli", f"the CLI phases took {time.perf_counter() - t_cli:.2f} s")

    # The examples and tutorials, each main on the card at tests/test_examples.py's
    # budgets (B1 once per PPO iteration at [128, 8], [64, 8] and [40, 16]; B2
    # once per disc step at demo batch 256), the interactive policy over a
    # device env, and a card rollout through the HuggingFace writer and back.
    t_ex = time.perf_counter()
    paths.update(run_examples(torch, dev))
    for phase, fn in (("interactive", lambda: run_interactive(torch, dev)),
                      ("hf_roundtrip", lambda: run_hf_roundtrip(torch, dev))):
        t0 = time.perf_counter()
        zero_counts()
        fn()
        if any(counts().values()):
            raise AssertionError(f"{phase}: kernel launches {counts()} on a path without either kernel")
        log(phase, f"done in {time.perf_counter() - t0:.2f} s")
    log("examples", f"the examples, interactive and writer phases took {time.perf_counter() - t_ex:.2f} s")

    # The host-env path: the C++ engine on the card's host, GAIL at bench.py's
    # main-path learner configuration over 64 host Pendulum-v1 envs (B1 at
    # [64, 64] once a round, B2 8 times a round at 2 x 8192 rows), serialized
    # (gail_seals_half_cheetah runs both modes); then short host phases of
    # SAC, SQIL (DQN, overlapped), DAgger and RLHF with exploration.
    t_host = time.perf_counter()
    t0 = time.perf_counter()
    run_host_envs(torch, dev)
    log("host_envs", f"done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches, s_ser = run_gail_host_pendulum(torch, dev)
    paths.update(launches)
    log("gail_host_pendulum", f"done in {time.perf_counter() - t0:.2f} s; {s_ser:.3f} s per round serialized")
    for phase, fn in (("sac_host_pendulum", lambda: run_sac_host(torch, dev)),
                      ("sqil_host_cartpole", lambda: run_sqil_host(torch, dev)),
                      ("dagger_host_cartpole", lambda: run_dagger(
                          torch, dev, "CartPole-v1", "dagger_host_cartpole", dagger.LinearBetaSchedule(15),
                          1000, host=True, max_episode_steps=100))):
        t0 = time.perf_counter()
        zero_counts()
        fn()
        if counts() != {"gae": 0, "assemble_rows": 0}:
            raise AssertionError(f"{phase}: kernel launches {counts()} on a path without either kernel")
        log(phase, f"done in {time.perf_counter() - t0:.2f} s; kernel launches {counts()}")
    t0 = time.perf_counter()
    paths["rlhf_host_pendulum"], _ = run_rlhf(
        torch, "rlhf_host_pendulum", rlhf_host_pendulum(dev), 4_096, 60,
        ("2 iterations", "4,096 timesteps (4 PPO iterations of 64 x 16)", "60 comparisons"), refit=False)
    log("rlhf_host_pendulum", f"done in {time.perf_counter() - t0:.2f} s")
    log("host", f"the host-env phases took {time.perf_counter() - t_host:.2f} s")

    # Data-parallel training: GAIL train_fused at gail_cartpole's widths in one
    # process, over 2 gloo ranks sharing the card (B1 at [128, 32] once a
    # round and B2 4 times a round on each) and through NCCL at world size 1;
    # SAC with the split ring and the reward trainer over the 2 ranks. Then
    # the same three over 4 ranks at dp = 2 by tp = 2 (B1 at [128, 32] and B2
    # on each), and the tp ranks' generator resumed here at tp = 1.
    t0 = time.perf_counter()
    paths.update(run_dp(torch, dev))
    log("dp", f"the dp and tp phases took {time.perf_counter() - t0:.2f} s")

    for e in entries:  # the launches of every driven path, each counted from 0
        e["paths"] = {path: n[e["name"]] for path, n in paths.items() if n[e["name"]]}
        e["launches"] = sum(e["paths"].values())
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
    if len(sys.argv) == 4 and sys.argv[1] == "--dp-rank":  # one rank of the dp phase
        sys.exit(dp_rank_main(sys.argv[2], sys.argv[3]))
    sys.exit(main())
