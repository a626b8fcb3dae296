#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Runs from the repository root on a machine with one NVIDIA H100 (sm_90a)
and ``nvcc``. Phases, each printing its own lines:

1. build    -- compile every CUDA kernel from ``ray_tpu_torch/csrc``
               (one nvcc per source, started together);
2. gather   -- the row-gather kernel against its plain PyTorch version,
               bitwise, at the PPO bench geometry, at ragged widths,
               on byte rows (bool, uint8, 2-byte) at the DQN sample
               geometry and through ``build_stacks`` on uint8 frames;
               CUDA-event times of kernel, plain version and
               ``index_select``;
3. gae      -- the GAE kernel against its plain version, bitwise, at the
               device lane's (16, 128), at ragged shapes and several
               tiles with episode ends inside the fragment and a row done
               at every step, under two (gamma, lambda), and on unaligned
               inputs; times and the launch floor (``floor_device_ms``;
               no single PyTorch call computes this function, so there is
               no library time);
4. scatter  -- the row-scatter kernel against its plain version,
               bitwise: the replay insert (64 rows into a (50000, 1764)
               int32 ring, wrapping), duplicate positions, bool, 2-, 4-
               and odd-byte columns, int32 positions, the one-launch
               limit of rows and one past it, and a whole-ring
               ``set_state``; times of kernel, plain version and
               ``index_copy_``; the kernels one call at the insert
               launches (``torch.profiler``: exactly 1);
5. descent  -- the f64 prefix-descent kernel against its plain version
               and the host sum tree, bitwise, at capacity 65536 (1, 32,
               512 and 4096 draws, node boundaries, masses at and past
               the total, a NaN mass) and at capacities 1, 2, 32, 64,
               2048 and 131072; the device tree's leaf write (repeated
               indices) and draw against the host trees; times, the
               launch floor (``floor_device_ms``), and ``searchsorted``
               as a yardstick;
6. flash    -- the flash-attention kernel against its plain version
               (within 2e-5 abs/rel in f32, 3e-2 in bf16, rows that see
               no key exactly 0, the output in q's layout): the torso's
               path shapes (B·H = 2048, 4096, 128, 256, and the
               server's 8, 16, 32 and 64, at T = S = 8, D = 32) and
               GTrXL's act step (B·H = 8 and 2, T = 1, S = 51, D = 32,
               offset 50) in the models' (B, T, H, D) memory and
               contiguous, the reference test's shapes and offsets, D in
               {16, 32, 64, 128}, the query row per thread's edges (T of
               1, 3, 17, 32; D of 1, 33, 64; ragged heads; the chunk
               merge) and bf16; at each path shape, the kernel's and
               ``scaled_dot_product_attention``'s (same band mask) times
               and the bound; at the learner shape, the wrapper's time
               with and without autograd and the plain version's;
   flash_block -- ring attention's block kernel against its plain version
               on float64 copies of its inputs (acc, m and l within 2e-5
               abs/rel, 1e-4 over the hop's 4096 keys, in f32 and in bf16,
               whose inputs float64 holds exactly; rows that see no key
               exactly (0, -1e30, 0)): the
               ring's hop (B·H = 8, T = S = 4096, D = 32) on the diagonal,
               one and three shards behind and one ahead, the torso's
               shape, the reference test's shard, ragged T and S, D in
               {16, 32, 64, 128}, the 64-row, 64-key tile's edges (D of
               7, 8 and 40; T and S of 63, 65 and 129; offsets on and
               beside a tile edge), bf16 at the hop (diagonal and one
               shard behind), ragged and at tile edges; the plain
               version's own float32 error at each case beside the
               kernel's; times of kernel, wrapper, plain version and
               ``scaled_dot_product_attention`` at the hop (diagonal and
               every key visible) in f32 and in bf16, and the bounds
               (q·k held to the f32 rate for f32 inputs and to the bf16
               tensor-core rate for bf16 ones, p·v to the f32 rate);
7. learner  -- ``PPOTorchPolicy.learn_on_batch`` twice on a frame-pool
               batch at the bench geometry (84x84x4, 6 actions, B=4096,
               minibatch 512, 10 epochs, lr 5e-5): env-steps/s, finite
               stats, and the row-gather launches of that run;
8. lane     -- ``PPO`` from tuned_examples/ppo/ponglitejax-ppo.yaml for 2
               training iterations on the device lane (N=16, T=128,
               minibatch 512, 6 epochs) at K = auto (8 slots a call, one
               CUDA graph of the slot replayed): reward, env-steps/s, the
               GAE launches of that run (one a slot, replays counted),
               and that params, env state and batch live on the card;
               then the lane at K = 1 and K = auto, each for LANE_CALLS
               (1) call, also profiled: env-steps/s (median,
               min, max), the device's busy share and the card's peak
               memory;
   telemetry -- the telemetry layer on that lane (K = auto): two seeded
               runs of TELEMETRY_CALLS (2) calls, telemetry off (the lane
               phase's run) and ``telemetry(trace=True, device_ledger=True,
               metrics_port=0)``: params bitwise; the device ledger's
               ``rollout_superstep[...]`` program (executions = the
               runner's run calls after its capture, FLOPs > 0, MFU in
               (0, 1]) and its CUDA-event time against
               ``torch.profiler``'s span of the same replays (then one
               profiled superstep call of K slots on the lane's runner;
               within 10% or 20 µs); the rate of the
               second call with telemetry on and off; one scrape of
               ``/metrics`` with the program's series; an
               ``export_timeline`` file with the ``device:`` lanes. (In
               ppo_prefetch, traced calls after its window until one
               rolls up its workers' sampling: its ``info/telemetry``
               overlap fraction beside this script's own
               ``span_overlap`` over the same spans.)
9. dqn      -- ``DQN`` on the PongLite device lane at full width
               (:func:`dqn_config`: ``training_intensity`` 4, so a round
               owes 8 replay updates, one superstep at K = 8) for 16 fill
               rounds, the first update round (the capture) apart, then 6
               rounds: env-steps/s and updates/s, the gather, scatter and
               descent launches of that run, replay occupancy, that
               rings, trees and params live on the card, one
               synchronised eager split (fill, insert, sample, learn,
               priority update), the same update with the ring filled to
               50000 rows, then K = 1 (one eager update a round) and
               K = auto, LANE_CALLS (1) call each: updates/s, busy share, peak
               memory;
10. transformer_learner -- the decoder-transformer torso at the width of
               bench.py's model-parallel A/B (d_model 256, 4 layers, 8
               heads of 32, ff 1024, 8 tokens): ``PPOTorchPolicy.
               learn_on_batch`` twice on Box(64) obs and Discrete(8),
               batch 512, minibatch 256, 2 epochs, lr 3e-4, seed 0:
               env-steps/s, flash launches, finite stats, parameter
               count and peak memory; then the device activities of one
               forward at the minibatch (one short-head flash kernel a
               layer, and its copies);
11. transformer_lane -- ponglitejax-ppo.yaml with that torso for 2
               training iterations at K = auto: env-steps/s, flash and
               GAE launches, on-card checks; then K = 1 and K = auto as
               in the lane phase;
12. transformer_dqn -- :func:`dqn_config` with that torso, 16 fill and 2
               update rounds (8 at K = 1): updates/s and the flash,
               gather, scatter and descent launches; then K = 1 and K =
               auto as in the dqn phase;
    cartpole -- tuned_examples/ppo/cartpolejax-ppo.yaml as written (N=32,
               T=64, FCNet 256x256, 8 epochs x minibatch 256) at K = auto
               until episode_reward_mean >= 150 or 200000 env steps:
               the bar is required; reward against env steps, wall time;
    gridrooms -- 2 iterations of GridRoomsJax-v0 with that yaml's
               settings on the lane, launching the GAE kernel;
    graph_parity -- graphed slots against eager slots, bitwise in
               params, Adam state, env carry, generator states, stats
               and metrics: 2 PPO lane slots of ponglitejax-ppo.yaml
               (twice), 2 DQN prioritized replay slots of dqn_config()
               (twice, with the sum tree), 1 torso lane slot (twice);
    ponglite_learn -- ponglitejax-ppo.yaml at K = auto for its 2M env
               steps, or PONG_LEARN_S seconds if that comes first: reward
               against env steps and where it first reached the bar, 18;
    actor_lane -- tuned_examples/ppo/ponglite-ppo.yaml as written on the
               actor lane: 2 rollout worker processes of the port's
               runtime (CPU policies, the card hidden, one torch thread
               each) x 8 PongLite-v0 envs x T = 128, frame-pool
               fragments, the learner on the card rebuilding the stacks
               with the row-gather kernel; one warm, 3 timed and 2 busy-
               share calls: env-steps/s (median, range), the split
               (sample round, concat, transfer with bytes, learn,
               sync_weights), the busy share, pooled and stacked batch
               counts, the workers' act time per step and os.cpu_count();
               one row-gather launch per pooled learn call is required,
               and workers that report the CPU and CUDA uninitialized;
               then one more round's batch learned pooled and stacked by
               two fresh learners, bitwise equal, with each copy's bytes
               and seconds;
    actor_lane_local -- that yaml at num_workers 0 for one iteration: the
               local worker acts on the card;
    actor_learn -- that yaml for ACTOR_LEARN_S seconds: reward against
               env steps (its 2M steps do not fit; no bar is required);
    impala   -- IMPALA at bench_e2e.py's ``_impala_pong`` geometry
               (:func:`impala_config`: PongLite-v0, 2 worker processes x
               8 envs, fixed unrolls of T = 64, train batch 1024, the
               default bf16 Nature CNN) for IMPALA_WINDOW_S seconds after
               warm iterations until the learner has reported (at most
               ACTOR_LEARNER_WARM_S; a window without a learner step runs
               on, up to 4 windows): env-steps/s sampled and trained, the
               learner thread's steps, queue wait, grad and publish time,
               the main thread's harvest, concat and broadcast time, the
               feeder's bytes and copy times per batch, the busy share of
               one more call, the workers' act time per step and V-trace's
               device time at (16, 64); one row-gather launch per learner
               step and a live learner thread are required;
    impala_parity -- one round's pooled batch from that run learned twice
               through the learner thread (the feeder's pinned side-stream
               copy, deferred stats) and twice through ``learn_on_batch``
               by two fresh policies of one seed: bitwise equal; its
               (16, 65) unroll index rebuilt by the row gather on the card
               bitwise equal to the host's stacks, and the round learned
               pooled and stacked on the host by two fresh learners:
               bitwise equal;
    appo     -- APPO at the same geometry for APPO_WINDOW_S seconds: the
               impala phase's readings and the target refreshes (> 0
               required);
    impala_fused -- cartpole-impala.yaml's widths with 2 remote workers
               at superstep "auto" (K = 8) for ASYNC_BUDGET_S seconds: the
               learner thread's fused supersteps, rates, queue wait
               against grad time; a backlog (BACKLOG_S with the step lock
               held) that it must learn fused; the run's first fused
               superstep bitwise against K eager learns of a copy of the
               policy; then one aggregation actor for its budget: the
               train batches that came through it;
    ppo_prefetch -- ponglite-ppo.yaml with ``sample_prefetch: 1``: the
               first iteration's learner stats bitwise equal to a fresh
               synchronous run's, then PREFETCH_WINDOW_S seconds of calls:
               env-steps/s harvested and trained over the window, each
               call's split, the feeder's copies, one row-gather launch
               per learn; then ``sample_prefetch: 2`` with ``superstep:
               2`` (stacks shipped: frame pools demote the run to K = 1):
               the first step's graphed superstep bitwise against two
               eager learns, and PREFETCH_FUSED_S seconds of calls;
    sac_learner -- SAC's learner at HalfCheetah's published widths
               (bench_e2e.py's ``_sac_halfcheetah``: obs 17, act 6,
               256x256 towers, batch 256) on a 400000-row device ring of
               seeded rows: SAC_WINDOWS + 1 windows of K = 8 updates as
               one captured slot replayed (the first window captures),
               uniform and then prioritized replay: updates/s (median and
               range of the timed windows), busy share, capture and fill
               time; the row-gather, row-scatter and prefix-descent
               launches of each run must equal what the schedule implies
               (graph replays counted), the stats be finite, alpha > 0
               and the refreshed priorities finite; then 2 graphed
               windows against 16 eager updates on the same rows and
               draws, bitwise in every parameter, Adam moment, the target
               critic, the generator, the stats and the sum tree;
    sac_columns -- every SAC replay column (obs, new_obs, actions,
               rewards, dones) at Pendulum's (obs 3, act 1) and
               HalfCheetah's widths through the row gather (256 drawn
               rows) and the row scatter (one row, 1000 wrapping rows)
               bitwise against ``index_select`` and ``index_copy_``, and
               with repeated positions against the plain version; the
               HalfCheetah obs column's gather time and bound;
    sac      -- tuned_examples/sac/pendulum-sac.yaml as written on the
               port's own Pendulum-v1 (num_workers 0: the local worker
               acts on the card) for SAC_BUDGET_S seconds: env steps,
               updates, the reward's course and where it first reached
               the yaml's bar (recorded, not required), the last 10
               episodes' mean, the split (sample with act and env,
               insert, update, sync); one row gather per column an update
               and one row scatter per column an insert are required;
    pendulum_ppo -- tuned_examples/ppo/pendulum-ppo.yaml as written for 2
               iterations (8 envs x 256 on the local worker, acting on
               the card; a DiagGaussian under PPO): env-steps/s, finite
               stats;
    rainbow, ddpg, td3, ma_dqn -- the rest of off-policy on the actor
               lane, the local worker acting on the card, each for its
               budget (OFFPOLICY_BUDGET_S): cartpole-rainbow.yaml as
               written (C51, noisy dueling heads, double Q, n-step 3,
               prioritized replay), pendulum-ddpg.yaml (OU noise),
               pendulum-td3.yaml (Gaussian noise, the actor every 2nd
               update) and two DQN policies over a two-agent CartPole-v1
               (one ring each): env-steps/s, updates/s, the round's split
               and its per-step times, the gather (a column an update),
               descent (an update, prioritized) and scatter (a column an
               insert) launches against that schedule, every policy's
               captured replay slot, the reward's course, the busy share
               of OFFPOLICY_BUSY_CALLS more calls; then
               OFFPOLICY_WINDOWS graphed windows of OFFPOLICY_K slots on
               copies of the trained policy and its ring against eager
               updates, bitwise (parameters, Adam moments and counts,
               targets, TD3's step, generators, stats, the sum tree);
    apex     -- tuned_examples/apex_dqn/cartpole-apex.yaml as written (3
               CPU workers on the per-worker epsilon ladder, read back
               and required; two prioritized device shards of 25,000 rows;
               8 graphed updates a shard and learn pass) until learning
               starts and ASYNC_BUDGET_S["apex"] seconds after: env-steps/s
               sampled, updates/s, target updates, the busy share, one
               descent and a gather per column an update and more than a
               scatter per column an insert required; then each shard's
               kernels against their plain versions (``_ring_kernels``);
    sac_async -- bench_e2e.py's SAC geometry (:func:`sac_async_config`:
               one remote worker sampling on its thread, fragment 32,
               batch 256, ``training_intensity`` 256) on Pendulum-v1:
               STALE_ROUNDS rounds that must each insert the fragment
               requested in the round before, then ASYNC_BUDGET_S seconds:
               rates, the split, the launches against the schedule; graphed
               slots against eager updates and the ring's kernels against
               their plain versions;
    ma_ppo   -- multi-agent PPO at bench_e2e.py's ``_ma_cartpole`` width
               (:func:`ma_cartpole_config`: 4 CartPole-v1 agents of the
               port's own env on one shared policy, FCNet 128x128, 1
               remote worker, fragment 256, batch 2048, minibatch 256, 8
               epochs), built through ``config.build()`` with its
               lambdas: one warm and MA_TIMED_CALLS timed iterations
               (env- and agent-steps/s, the split, the busy share of one
               more learn; finite stats under ``info/learner/shared``
               and the worker's weights bitwise equal to the learner's
               are required), then MA_LEARN_S seconds of training: the
               course of ``policy_reward_mean["shared"]``;
    ma_ppo_independent -- that geometry with ``p0`` and ``p1`` (lr 1e-4)
               and num_workers 0 (the local worker acts on the card):
               one iteration with ``policies_to_train=["p0"]`` (p1
               bitwise unchanged), one with both (both move): act ms per
               env step;
    views    -- single-agent PPO on CartPole-v1 with ``use_prev_action``
               and ``use_prev_reward``: one sample of the local worker
               on the card, its ``prev_actions`` / ``prev_rewards`` the
               actions / rewards shifted by one within each episode;
    ckpt_ppo -- ponglite-ppo.yaml as written: one ``train()``, ``save()``,
               ``Algorithm.from_checkpoint``: the whole state bitwise (every
               parameter, Adam moment, count, coefficient, counter), each
               remote worker's weights bitwise the learner's right after
               the restore, greedy ``compute_single_action`` on 8 seeded
               frames equal on both; one ``train()`` of the restored
               algorithm must launch the row gather; save and load
               seconds, bytes;
    ckpt_dqn -- :func:`dqn_config` filled and trained until its superstep
               slot is captured, ``save()``, then ``restore()`` into that
               same algorithm (rings and tree rewritten in place, the
               captured graph kept) and ``from_checkpoint`` into a fresh
               one: rings, leaves and ``max_priority`` bitwise; the first
               graphed update after the restore against an eager update
               of the fresh one on the same draws, bitwise; one
               ``train()`` of each; the scatter, descent and gather
               launches, save and load seconds, bytes;
    chaos_ppo -- ponglite-ppo.yaml's learner on 4 rollout worker
               processes (T = 32, batch 1024, 2 epochs) under a fault
               spec that kills two workers and poisons one learn batch,
               with ``recreate_failed_workers`` and ``nan_guard``: 4
               ``train()`` calls; the recovery counts, the fleet back at
               4, the skipped learn leaving the learner on the card
               bitwise, row gathers one a pooled learn; the nan guard's
               graphed slot on the card bitwise a clean eager run;
               replacement seconds;
    stream_impala -- ``_impala_pong``'s geometry with
               ``checkpoint_streaming`` and ``crash_learner_thread`` (2
               restores into new learner threads): snapshots written
               while training goes on bitwise the state their capture
               saw, the parameters after each restore bitwise the
               snapshot's, the card's memory no higher after the second
               restore than after the first; the capture's main-thread
               ms, restore seconds, snapshot lag, row gathers;
    restore_dqn -- :func:`dqn_config` with ``checkpoint_frequency: 1``,
               ``restore_on_failure`` and ``crash_learner``: the restore
               writes the rings and the tree in place, its state bitwise
               the checkpoint's, the first graphed update after it bitwise
               an eager one; the crash iteration's scatter and descent
               launches, restore seconds;
    evaluate -- cartpole-ppo.yaml's model with ``evaluation_interval: 1``,
               ``evaluation_num_workers: 1``, ``evaluation_duration: 5``
               and a callbacks class: two ``train()`` calls with at least 5
               evaluation episodes each, ``custom_metrics`` and the
               ``on_train_result`` mark required; the evaluation's seconds;
    evaluate_cli -- ``python -m ray_tpu_torch.evaluate`` on the evaluate
               phase's checkpoint, 3 episodes on the card: exit 0 and the
               JSON line;
    serve    -- ckpt_ppo's checkpoint (ponglite-ppo.yaml's bf16 Nature CNN)
               behind an in-process ``PolicyDeployment`` on the card, max
               batch 32: one CUDA graph a bucket (6) captured at warmup and
               none after; 32 frames as one bucket bitwise against 32
               sequential ``compute_actions``; SERVE_CLIENTS client threads
               for SERVE_WINDOW_S seconds with a newer checkpoint landing
               in the watched root half-way (nothing dropped, versions
               monotone, one reload): requests/s, latency and queue-wait
               p50/p99, mean batch rows, batch fill;
    serve_torso -- a torso policy at the transformer phases' width in a
               ``BatchedPolicyServer`` (exploring, max batch 32), exact mode
               then vectorized, each for SERVE_TORSO_WINDOW_S seconds from
               32 client threads: 16 requests bitwise against sequential
               exploring calls, the flash launches equal to each policy's
               signature forward and the warmups' eager runs plus layers x
               bucket (exact) or layers (vectorized) a replay, vectorized
               within 1e-5 of exact;
    serve_replicas -- ``serve.run(policy_deployment(..., 2 replicas))``
               with replica actors that keep the card
               (``worker_env``) and the per-request HTTP proxy: both
               restore and capture on the card; one is killed, at most 2
               calls fail, the controller replaces it;
    ingress  -- ``PolicyIngress`` over real sockets in front of those
               replicas: INGRESS_CLIENTS keep-alive HTTP clients posting
               frames (requests/s, p50, p99, merged rows); the same
               clients and frames through the per-request proxy (one
               replica call a request): the A/B against the reference's
               4x bar, printed, with equal greedy actions required and
               one frame's JSON decode timed; then an overload
               burst of INGRESS_BURST requests against an in-flight budget
               of INGRESS_TIGHT_INFLIGHT: every request 200 or shed with
               Retry-After, the shed count;
    lstm_ppo -- cartpole-ppo.yaml as written on the local worker on the
               card (4 envs, fragment 256, batch 2048, minibatch 256, 8
               epochs) with ``use_lstm`` at the catalog's defaults
               (fcnet [256, 256], cell 256, max_seq_len 20): one warm and
               RECURRENT_CALLS timed ``train()`` calls: env-steps/s, act
               ms a step, the sampler's env and postprocess seconds, learn
               seconds, unrolls, minibatch rows (240) and optimizer steps
               a learn (required: epochs x minibatches); SINGLE_ACTIONS
               ``compute_single_action`` calls threading the state, each
               state out bitwise a batch-1 ``compute_actions``'s; no
               kernel launched (required);
    gtrxl_ppo -- the same with ``use_attention`` at the catalog's
               defaults (dim 64, 1 unit, 2 heads of 32, memory 50, MLP
               32): row 5's launches equal the units times the act
               path's forwards (sampler steps, GAE bootstraps, single
               actions and their checks; required); one act step on the
               card against the same weights on the CPU, within 1e-5;
    lstm_impala -- cartpole-impala.yaml with ``use_lstm`` for
               LSTM_IMPALA_WINDOW_S seconds (the local worker on the card),
               then cartpole-appo.yaml with ``use_lstm`` (one remote
               worker on the CPU), one warm and one timed iteration:
               sampled and trained env-steps/s, the learner's queue wait
               against its grad time, finite stats;
    recurrent_serve -- gtrxl_ppo's policy behind a ``BatchedPolicyServer``:
               the sequential fallback (no program), RSERVE_REQUESTS
               requests from RSERVE_THREADS threads, each answer bitwise
               ``compute_actions`` from the initial state, one flash
               launch a request and unit (required): requests/s;
    offline_io -- PPO on CartPole-v1 (8 envs x 256 on the local worker on
               the card, FCNet 256x256) with ``output`` set, for
               OFFLINE_IO_ITERS ``train()`` calls: every batch the worker
               sampled reads back from the JSON shards bitwise;
               env-steps/s, shard bytes, the host's encode and decode
               rates on those batches;
    offline_bc -- BC, then MARWIL, from those shards on the card (train
               batch 2000, lr 1e-4, FCNet 256x256): OFFLINE_PARITY_LEARNS
               learns each against the same learn of a CPU copy on the
               same batch and permutation (parameters within a tenth of
               lr, stats within 1e-4 relative: float32 sums in other
               orders through one Adam step), then OFFLINE_BC_ITERS timed
               ``train()`` calls: updates/s, rows/s, finite IS and WIS
               estimates, MARWIL's normaliser, and an offline step split
               between the host's draw (decode, postprocess, concat) and
               the card's learn;
    offline_cql_crr -- SAC writes Pendulum-v1 shards with learning held
               off (5 envs x 200 on the card's local worker,
               OFFLINE_SAC_ITERS calls; its replay inserts must launch the
               row scatter), then CQL (``bc_iters`` CQL_BC_ITERS) and CRR
               (a hard target sync every CRR_SYNC_INTERVAL updates) at
               SAC's defaults take OFFLINE_CQL_ITERS timed updates each:
               finite losses, CQL's warmup flag 1 for its first
               CQL_BC_ITERS updates and 0 after, updates/s, the split,
               then one update each against a CPU copy on the card's
               draws (the bound above);
    external_env -- PPO with no env: its input a ``PolicyServerInput``
               whose actions come from the policy on the card, while a
               ``PolicyClient`` thread drives CartPole-v1 over HTTP
               through EXTERNAL_ENV_S seconds of ``train()`` calls:
               env-steps/s through the server, the episodes the client
               ended and the server reported, GET_ACTION p50 and p99,
               finite stats; ``stop()`` shuts the server and the client
               thread ends;
    apex_ddpg -- ``ApexDDPGConfig()``'s own defaults on Pendulum-v1 (4
               CPU workers, two prioritized device shards of 50,000 rows,
               8 graphed DDPG updates a shard and pass) for
               APEX_DDPG_BUDGET_S seconds after learning starts: rates,
               the split, rows 1, 3 and 4 against the shards' schedule,
               no shard spilled; each shard's kernels against their plain
               versions;
    apex_host -- cartpole-apex.yaml plus ``replay_device_resident:
               False``: two ``ReplayActor`` processes over host rings, the
               learner on the card, for APEX_HOST_BUDGET_S seconds after
               learning starts: rates and the split (learning, routing,
               the wait for the replay actors);
    dqn_interleave -- bench.py:3889-3915's geometry (CartPoleJax-v0, 8
               envs x 8 steps, batch 256, a prioritized 16,384-row ring on
               the device tree, ``training_intensity`` 32, K = 8, FCNet
               64x64) serially, then under ``learn_while_rollout``, each
               for INTERLEAVE_WINDOW_S seconds: env-steps/s, updates/s,
               rows 1, 3 and 4 against the schedule, and from a profiler
               trace of INTERLEAVE_PROFILED_ROUNDS rounds the share of the
               fill's kernel time under the superstep graph's kernels;
               the interleaved ring's kernels against their plain
               versions;
    host_tree -- the same geometry with ``replay_device_tree: False``:
               two rings (host trees, device tree) on the same rows and
               priorities draw the same indices and IS weights, bitwise;
               REPLAY_PLANE_ROUNDS rounds of the lane (a gather per
               column an update, no descent); rows 1 and 3 against their
               plain versions on its ring;
    spill    -- the same geometry under a SPILL_CAP_BYTES cap: the ring
               spills, a spilled ring draws the unspilled ring's indices
               and IS weights bitwise, and REPLAY_PLANE_ROUNDS rounds run
               the host stacked superstep; the default cap printed;
    lane_eval -- cartpolejax-ppo.yaml on the lane with one evaluation
               worker on the card over ``TensorVectorEnvAdapter``, two
               iterations: each result's evaluation, the worker's weights
               bitwise the learner's, the lane's GAE launches;
    model_surface -- PPO policies on the card and on the CPU from one
               seed over MultiDiscrete([3, 4, 5]) (the catalog's FCNet),
               MultiBinary(6) (a registered custom model) and
               MultiDiscrete([3, 4, 5]) again with the custom model and a
               registered custom action distribution: greedy acts through
               ``compute_actions(explore=False)`` and sampled acts (the
               sample's uniforms drawn on the host and handed to both)
               equal, log-probabilities within SURFACE_TOL, and one
               ``learn_on_batch`` on a fixed batch with the same
               permutations within SURFACE_TOL in stats and parameters;
               then cartpole-ppo.yaml as written (``num_workers: 0``) with
               ``exploration_config`` Curiosity, then RND, at their
               default widths (feature_dim 288, embed_dim 128), for
               SURFACE_ITERS ``train()`` calls: the nets on the card, every
               fragment's intrinsic reward finite and above 0, and the
               exploration state bitwise through ``save`` and
               ``Algorithm.from_checkpoint``;
    actor_starts -- A3C's algorithm and ES's and ARS's, built before the
               next phases so their worker processes start while those
               run; then item 9.3's single-agent phases, each printing
               the card's name and power limit:
    pg_a2c   -- cartpole-pg.yaml and cartpole-a2c.yaml: one learn on a
               fixed train batch on the card and on a CPU copy (the learn
               contract), then PG_A2C_ITERS train() calls: env-steps/s
               and the split;
    simple_q -- cartpole-dqn.yaml as SimpleQ with prioritized replay:
               the off-policy run (rows 1, 3, 4 against the replay's
               schedule and their plain versions), graphed against eager;
    r2d2     -- cartpole-r2d2.yaml zero-init and stored-state: a budget
               of train() (target updates counted), one learn on card and
               CPU (``_r2d2_stats_close``);
    a3c      -- two CPU workers: one fixed gradient applied on card and
               CPU, a window with both workers' gradients applied and
               every worker's weights the learner's; gradients a second;
    rnnsac   -- Pendulum-v1: a window of updates, one update on card and
               CPU with injected normals (SAC's tolerances);
    es_ars   -- cartpole-es.yaml and cartpole-ars.yaml: theta bitwise a
               numpy recomputation each iteration, greedy actions on card
               and CPU equal;
    bandits  -- LinUCB and LinTS on ``LinearContextBandit``: statistics
               and scores on card and CPU, the late reward above a
               uniform policy's;
    ingress_bank -- ``IngressSupervisor(num_workers=2)`` started from
               this process, which holds a CUDA context: each worker is
               spawned, restores the serve phase's checkpoint root into a
               ``BatchedPolicyServer`` on the card (graphs captured at
               warmup, no AOT cache) behind a ``CoalescingRouter`` over a
               ``LocalReplica`` that follows the supervisor's forwarded
               membership. BANK_CLIENTS keep-alive clients post the serve
               phase's frames for BANK_WINDOW_S seconds, greedy: every
               answer equal to an in-process server's on the same frames,
               both workers served, no capture after warmup, and
               ``/metrics`` from the bank shows ``host="ingress-w0"`` and
               ``host="ingress-w1"`` whose request counters sum to the
               answers. Then one worker SIGKILLed: the replacement has the
               forwarded membership and merged text, answers as the
               in-process server does, and the respawn is counted; then
               ``drain()``: ``/healthz`` 503 from the whole bank. Each
               worker's cold start split into process start and imports,
               CUDA context, restore, warmup captures and the bind, and its
               device memory (the card's free memory before and after the
               bank came up, and torch's allocated and reserved bytes);
13. ring     -- ``ring_attention`` through ``parallel.distributed.initialize``
               and ``make_mesh``: 4 rank processes of this script
               (``--ring-rank gloo``) on the one card over a gloo group
               (NCCL refuses two ranks on one card; each hop is staged
               through host memory), tcp rendezvous on 127.0.0.1; every
               rank makes the same seeded B = 1, T = 16384, H = 8, D = 32
               arrays on the host and keeps its block of 4096 rows
               (``shard_sequence``) on the card, f32 causal, f32 full and
               bf16 causal, two calls each on the blocks: launches (4 per
               call), staged exchanges (3 per call) and no gather per
               rank, the card's peak memory over each call
               (``peak_mb``), second-call wall times; after the calls,
               the rows gathered (``gather_sequence``) and rank 0's
               against ``full_attention_reference`` on the card (2e-4 in
               f32; in bf16 one bf16 ulp, 2**-7, relative and 1e-5
               absolute); each rank's busiest-hop kernel time and one
               staged exchange's time;
               with two or more cards
               the same on NCCL, one rank per card; NCCL at world size 1
               in this process;
14. a ``{"kernels": [...]}`` line, the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``.

Times: ``ms`` is CUDA events around back-to-back raw launches on
prepared buffers (``cuda_ms``); where a kernel is shorter than its
Python launch, that times the host's launch loop. ``device_ms`` is the
kernel's own device duration from ``torch.profiler`` over the same
launches (``device_ms``), and ``library_device_ms`` the summed device
time of a library call's own kernels; every kernel phase prints both.
``wrapper_ms`` times the Python wrapper by events (host-bound).
``floor_device_ms`` is the ``device_ms`` of a one-element ``zero_()``,
the least a kernel launch shows by that timer.

Launch counts are set to 0 just before each of phases 7-13, the
actor phases, sac, each of sac_learner's two runs, the multi-agent
and views phases (whose paths run no kernel: host GAE, no frame pool,
as the reference's; they print their counts), the off-policy phases
(rainbow, ddpg, td3, ma_dqn: their budgets' runs, not the busy-share
calls or the parity windows after them), the resumed train of
ckpt_ppo, and ckpt_dqn's restores and its resumed rounds, chaos_ppo's
and stream_impala's runs and restore_dqn's crash iteration, the recurrent
phases' timed calls (lstm_impala's at its window's start, between two
learner steps) and recurrent_serve's requests, the offline phases' timed
calls and external_env's window (paths that run no kernel; they print
their counts) and the SAC writer of offline_cql_crr (its inserts are
the row scatter's ``offline_sac_writer`` path), the Ape-X phases' runs
(apex_host's plane runs no kernel), dqn_interleave's windows,
host_tree's and spill's rounds (the spill ring runs none) and
lane_eval's iterations, model_surface's card calls and its train()
calls, ingress_bank's client window (paths that run no kernel; they
print their counts), the single-agent phases' runs (only simple_q's
runs kernels; its replay parity windows do not count), and read just
after (on the learner-thread paths, between two learner steps) (the
ring's in each rank, before each call), the serve phase and
serve_torso (before its exact server is built; its exact-against-
vectorized comparison is read after the count); the comparison launches of
phases 2-6, of graph_parity, of sac_learner's parity windows, of
sac_columns, of the actor_lane's pooled-against-stacked learns and
ckpt_dqn's and restore_dqn's graphed-against-eager updates and
chaos_ppo's guarded slot do not count. The actor
phases stop their worker processes; serve_replicas starts the runtime
again with the card visible to its workers, and the ingress phase
shuts it down before the ring. Under a
superstep's graph a counter counts the card's launches: the runner adds
the captured slot's launches on each replay. Any failed check raises, and the
script exits non-zero without printing a result; a ring rank that fails
or outlives its timeout fails the script. Without a CUDA device it exits
1 at once.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
B, MB, ITERS = 4096, 512, 10  # the PPO learner bench geometry
H, W, C, NUM_ACTIONS = 84, 84, 4, 6
TUNED = os.path.join(REPO, "tuned_examples", "ppo", "ponglitejax-ppo.yaml")
# the DQN device lane at full width: DQNConfig's defaults on PongLite
REPLAY_CAPACITY, TREE_CAPACITY = 50000, 65536
TRAIN_BATCH, INSERT_ROWS = 32, 64  # one sample; 16 envs x 4 steps per insert
OBS_WORDS = 84 * 84 // 4  # one 84x84x1 uint8 frame as int32 words
F32_FLOPS_PER_S = 67e12  # H100 SXM published f32 rate outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM published dense bf16 tensor-core rate
# the decoder-transformer torso at the width of bench.py's --model-parallel A/B
TORSO = {
    "use_transformer": True, "transformer_dim": 256, "transformer_num_layers": 4,
    "transformer_num_heads": 8, "transformer_ff_dim": 1024, "transformer_seq_len": 8,
}
TF_B, TF_OBS, TF_ACTIONS = 512, 64, 8
# sequence-parallel ring attention at the torso's head width (8 heads of
# 32): 16384 tokens over 4 ranks on the one card, 4096 per rank and hop
RING_B, RING_T, RING_H, RING_D, RING_RANKS = 1, 16384, 8, 32, 4
RING_HOP = RING_T // RING_RANKS
RING_TIMEOUT_S = 300
# the flash block kernel against float64 copies of its inputs (f32 or
# bf16), abs/rel: 2e-5 up to a few hundred keys per row, as the forward;
# 1e-4 over the hop's 4096, where a float32 running sum drifts further
# (the plain version in float32 needs up to 4.1e-5 there on an H100)
BLOCK_TOL, BLOCK_TOL_HOP = 2e-5, 1e-4


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_busy(fn, n):
    """Device busy share of ``n`` calls of ``fn``: the device time of
    the kernels and copies that ``torch.profiler`` records over ``n``
    calls, divided by the host-clock time of ``n`` unprofiled calls
    (the profiler slows the host, not the kernels)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with profiled() as prof:
        for _ in range(n):
            fn()
    profiled_s = time.perf_counter() - t0 - 2 * PROFILE_PAD_S
    # the raw records, not prof.events(): a graphed lane call launches
    # about 10^5 kernels, whose function-event tree takes the host tens of
    # seconds to build
    device_us = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation()) / 1e3
    require(device_us > 0, "the profiler recorded no device time")
    return {"calls": n, "wall_s": round(wall, 6), "device_s": round(device_us / 1e6, 6),
            "busy_share": round(device_us / 1e6 / wall, 4), "profiled_s": round(profiled_s, 3)}


# idle host time at both ends of a profiler session, in seconds: the
# profiler drops device records that fall outside its window, and on an
# H100 its device timestamps can lie milliseconds before or after the
# host's, which lost the first or last records of back-to-back launches
PROFILE_PAD_S = 0.1


@contextlib.contextmanager
def profiled():
    """A ``torch.profiler`` session over the CPU and the card whose window
    reaches ``PROFILE_PAD_S`` past the work inside it on both sides; the
    card is synchronised before the session ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def _profiled_kernels(fn, calls, warmup):
    """Device activities (kernels, copies, sets) of ``calls`` back-to-back
    calls of ``fn``, by ``torch.profiler``: {name: [durations in ms]}.
    ``warmup`` calls run first, before the profiler starts."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profiled() as prof:
        for _ in range(calls):
            fn()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation",
                                                                             False):
            out.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    return out


def device_ms(fn, name=None, iters=50, warmup=5):
    """Device time per call of ``fn`` by ``torch.profiler``, unlike
    ``cuda_ms`` free of the host's launch loop. With ``name``: the mean
    duration of the kernel whose name contains it, over the launches the
    profiler recorded of ``iters`` back-to-back calls (it can miss some;
    at least half are required). Without: the sum over every kernel a
    call launches (e.g. a library call's own kernels), each at its mean
    duration and its launches a call."""
    per_name = _profiled_kernels(fn, iters, warmup)
    if name is not None:
        times = [t for n, ts in per_name.items() if name in n for t in ts]
        require(len(times) >= iters // 2, f"the profiler recorded {len(times)} kernels named "
                f"{name} in {iters} calls")
        return sum(times) / len(times)
    require(per_name, "the profiler recorded no device activity")
    return sum(sum(ts) / len(ts) * -(-len(ts) // iters) for ts in per_name.values())


def floor_device_ms():
    """The launch floor beside the µs-scale kernels: the ``device_ms`` of a
    one-element ``zero_()`` on the card (one fill kernel a call), timed
    as the kernels are."""
    import torch

    x = torch.empty(1, device="cuda")
    return device_ms(x.zero_, iters=200)


def device_kernels(fn, calls=3):
    """The device activities that one call of ``fn`` launches, by name,
    with their count a call (``torch.profiler`` over ``calls`` calls,
    rounded up, since it can miss some)."""
    return {n: -(-len(ts) // calls) for n, ts in _profiled_kernels(fn, calls, 1).items()}


def make_frames(rng, n, h=H, w=W):
    """Blocky 84x84 single frames approximating Atari content."""
    import numpy as np

    base = rng.integers(0, 255, (n, h // 4, w // 4, 1), dtype=np.uint8)
    return np.kron(base, np.ones((1, 4, 4, 1), np.uint8))


def make_batch(rng):
    """A PPO train batch in the frame-pool format: rows are sliding
    C-frame stacks over one contiguous stream of B + C - 1 frames."""
    import numpy as np

    from ray_tpu_torch.ops.framestack import frame_stream_columns

    return {
        **frame_stream_columns(make_frames(rng, B + C - 1), B, C),
        "actions": rng.integers(0, NUM_ACTIONS, B).astype(np.int64),
        "action_logp": np.full(B, -1.79, np.float32),
        "action_dist_inputs": rng.standard_normal((B, NUM_ACTIONS)).astype(np.float32),
        "advantages": rng.standard_normal(B).astype(np.float32),
        "value_targets": rng.standard_normal(B).astype(np.float32),
    }


def phase_build():
    from ray_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    built = _kernels.build()
    secs = time.perf_counter() - t0
    for name, info in built.items():
        usage = [ln.strip().replace("ptxas info    : ", "") for ln in info["log"].splitlines()
                 if "Used" in ln or "spill" in ln or "entry function" in ln]
        say("build", kernel=name, seconds=f"{info['seconds']:.2f}",
            cached=info["cached"], ptxas=json.dumps(usage))
    say("build", total_seconds=f"{secs:.2f}")


def phase_gather(rng):
    import numpy as np
    import torch

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.framestack import build_stacks, gather_rows, gather_rows_plain

    dev = torch.device("cuda")
    # bench geometry: a (4099, 1764) word view of the uint8 pool, 16384 rows
    frames = torch.as_tensor(make_frames(rng, B + C - 1)).to(dev)
    pool = frames.reshape(frames.shape[0], -1).view(torch.int32)
    first = torch.arange(B, device=dev)
    idx = (first[:, None] + torch.arange(C, device=dev)).reshape(-1)
    out_k, out_p = gather_rows(pool, idx), gather_rows_plain(pool, idx)
    torch.cuda.synchronize()
    require(torch.equal(out_k, out_p), "row gather differs at the bench geometry")
    checked = [("bench", tuple(pool.shape), idx.numel())]
    # ragged widths (not a multiple of 4 words) and random indices
    for m, d, r in ((1000, 1763, 5000), (4099, 7, 333), (17, 1, 64)):
        src = torch.randint(-2**31, 2**31 - 1, (m, d), dtype=torch.int32, device=dev)
        ridx = torch.randint(0, m, (r,), device=dev)
        require(torch.equal(gather_rows(src, ridx), gather_rows_plain(src, ridx)),
                f"row gather differs at ({m}, {d}) x {r}")
        checked.append(("ragged", (m, d), r))
    # f32 store, 2-D index shape
    srcf = torch.randn(513, 100, device=dev)
    idx2 = torch.randint(0, 513, (40, 3), device=dev)
    require(torch.equal(gather_rows(srcf, idx2), gather_rows_plain(srcf, idx2)),
            "row gather differs on an f32 store")
    # uint8 stacks through build_stacks against plain indexing and numpy
    stacks = build_stacks(frames, first.to(torch.int32), C)
    plain = gather_rows_plain(frames, first[:, None] + torch.arange(C, device=dev))[..., 0].movedim(1, -1)
    require(torch.equal(stacks, plain), "build_stacks differs from plain indexing")
    from ray_tpu_torch.ops.framestack import materialize_stacks_np

    host = materialize_stacks_np(frames[:64].cpu().numpy(), np.arange(60), C)
    require(np.array_equal(build_stacks(frames, first[:60], C).cpu().numpy(), host),
            "build_stacks differs from the numpy materialisation")
    # byte rows (the replay rings' bool, 2-byte and odd-width columns)
    # at the DQN sample geometry: 32 rows drawn from 50000
    ridx = torch.randint(0, REPLAY_CAPACITY, (TRAIN_BATCH,), device=dev)
    for dtype, row in ((torch.bool, ()), (torch.uint8, ()), (torch.float16, ()),
                       (torch.int16, (3,)), (torch.uint8, (7,))):
        src = torch.randint(0, 2 if dtype == torch.bool else 127,
                            (REPLAY_CAPACITY,) + row, device=dev).to(dtype)
        require(torch.equal(gather_rows(src, ridx), gather_rows_plain(src, ridx)),
                f"row gather differs on {dtype} rows of {row}")
        checked.append(("bytes", str(dtype), row, TRAIN_BATCH))
    say("gather", bitwise=True, checked=json.dumps(checked))

    # the kernel's own time: raw launches on prepared buffers; the
    # wrapper adds host-side checks and an allocation per call
    lib = _kernels.library("row_gather")
    stream = torch.cuda.current_stream().cuda_stream
    def raw():
        return lib.row_gather_launch(pool.data_ptr(), idx.data_ptr(), out_k.data_ptr(), idx.numel(),
                                     pool.shape[0], pool.shape[1] * 4, stream)

    ms = cuda_ms(raw)
    dev_ms = device_ms(raw, "word_kernel")
    wrapper_ms = cuda_ms(lambda: gather_rows(pool, idx))
    plain_ms = cuda_ms(lambda: gather_rows_plain(pool, idx))
    lib_ms = cuda_ms(lambda: torch.index_select(pool, 0, idx))
    lib_dev_ms = device_ms(lambda: torch.index_select(pool, 0, idx))
    stacks_ms = cuda_ms(lambda: build_stacks(frames, first, C))
    stacks_copy_ms = cuda_ms(lambda: build_stacks(frames, first, C).contiguous())
    # bytes the function must move: referenced pool rows read once, the
    # index read once, the output written once
    rows_read = int(torch.unique(idx).numel())
    nbytes = rows_read * pool.shape[1] * 4 + idx.numel() * 8 + out_k.numel() * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    say("gather", ms=f"{ms:.5f}", device_ms=f"{dev_ms:.5f}", wrapper_ms=f"{wrapper_ms:.5f}",
        plain_ms=f"{plain_ms:.5f}", index_select_ms=f"{lib_ms:.5f}",
        index_select_device_ms=f"{lib_dev_ms:.5f}",
        bound_ms=f"{bound_ms:.5f}", bytes=nbytes, gbps=f"{nbytes / ms / 1e6:.1f}")
    say("gather", build_stacks_ms=f"{stacks_ms:.5f}",
        build_stacks_contiguous_ms=f"{stacks_copy_ms:.5f}",
        note="build_stacks returns a permuted view; the _contiguous time adds a physical moveaxis")
    return {
        "name": "row_gather", "route": "cuda",
        "source": "ray_tpu_torch/csrc/row_gather.cu",
        "replaces": "ray_tpu/ops/framestack.py:65",
        "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
        "library_device_ms": lib_dev_ms,
        "passed": True,
    }


def phase_scatter():
    import torch

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.framestack import scatter_rows, scatter_rows_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def check(ring, pos, vals, what):
        k, p = ring.clone(), ring.clone()
        require(scatter_rows(k, pos, vals) is k, "scatter_rows did not write in place")
        scatter_rows_plain(p, pos, vals)
        torch.cuda.synchronize()
        require(torch.equal(k, p), f"row scatter differs from plain: {what}")
        checked.append(what)

    def words(m, d):
        return torch.randint(-2**31, 2**31 - 1, (m, d), dtype=torch.int32, device=dev, generator=gen)

    checked = []
    ring = words(REPLAY_CAPACITY, OBS_WORDS)
    vals = words(INSERT_ROWS, OBS_WORDS)
    # the insert: 64 rows at the write head, wrapping past the end
    pos = (REPLAY_CAPACITY - 20 + torch.arange(INSERT_ROWS, device=dev)) % REPLAY_CAPACITY
    check(ring, pos, vals, "insert obs words, wrapping")
    dup = torch.randint(0, REPLAY_CAPACITY, (INSERT_ROWS,), device=dev, generator=gen)
    dup[1::3] = dup[0]
    check(ring, dup, vals, "obs words, duplicate positions")
    small = words(100, OBS_WORDS)
    many = words(640, OBS_WORDS)
    check(small, torch.randint(0, 100, (640,), device=dev, generator=gen), many,
          "640 rows into 100, many duplicates")
    # scalar and narrow columns: bool, 4-byte, 2-byte, odd-width rows
    for dtype, row in ((torch.bool, ()), (torch.int32, ()), (torch.float32, ()),
                       (torch.float16, ()), (torch.uint8, (7,)), (torch.float32, (3,))):
        col = torch.randint(0, 2 if dtype == torch.bool else 100,
                            (REPLAY_CAPACITY,) + row, device=dev, generator=gen).to(dtype)
        v = torch.randint(0, 2 if dtype == torch.bool else 100,
                          (INSERT_ROWS,) + row, device=dev, generator=gen).to(dtype)
        check(col, pos, v, f"{dtype} rows of {row}, wrapping")
        check(col, dup, v, f"{dtype} rows of {row}, duplicates")
    # the one-launch limit and one past it (the three-launch path), and
    # int32 positions, which the one-launch path reads as given
    lib = _kernels.library("row_scatter")
    limit = lib.row_scatter_one_launch_rows()
    for r in (limit, limit + 1):
        rpos = torch.randint(0, 4 * limit, (r,), device=dev, generator=gen)
        rpos[1::7] = rpos[0]
        check(words(4 * limit, 7), rpos, words(r, 7), f"{r} rows of 7 words, duplicates")
        check(words(4 * limit, 7), rpos.to(torch.int32), words(r, 7),
              f"{r} rows of 7 words, int32 positions")
    check(ring, pos.to(torch.int32), vals, "insert obs words, int32 positions")
    check(torch.rand(REPLAY_CAPACITY, device=dev, generator=gen) < 0.5, dup.to(torch.int32),
          torch.rand(INSERT_ROWS, device=dev, generator=gen) < 0.5, "bool rows, int32 duplicates")
    # set_state: the whole ring in one scatter
    full = words(REPLAY_CAPACITY, OBS_WORDS)
    every = torch.arange(REPLAY_CAPACITY, device=dev)
    check(ring, every, full, f"set_state, {REPLAY_CAPACITY} obs rows")
    flags = torch.rand(REPLAY_CAPACITY, device=dev, generator=gen) < 0.5
    check(flags.clone(), every, ~flags, f"set_state, {REPLAY_CAPACITY} bool rows")
    say("scatter", bitwise=True, checked=json.dumps(checked))

    stream = torch.cuda.current_stream().cuda_stream
    def raw():
        return lib.row_scatter_launch(vals.data_ptr(), pos.data_ptr(), 8, ring.data_ptr(), None,
                                      INSERT_ROWS, REPLAY_CAPACITY, OBS_WORDS * 4, stream)

    ms = cuda_ms(raw, iters=200)
    dev_ms = device_ms(raw, "one_launch_word_kernel", iters=200)
    wrapper_ms = cuda_ms(lambda: scatter_rows(ring, pos, vals), iters=200)
    plain_ms = cuda_ms(lambda: scatter_rows_plain(ring, pos, vals), iters=50)
    lib_ms = cuda_ms(lambda: ring.index_copy_(0, pos, vals), iters=200)
    lib_dev_ms = device_ms(lambda: ring.index_copy_(0, pos, vals), iters=200)
    full_ms = cuda_ms(lambda: scatter_rows(ring, every, full), iters=20)
    # the CUDA kernels that one scatter_rows call at the insert launches
    # (int64 positions, as the replay buffer passes them, and int32)
    per_call = {str(p.dtype): device_kernels(lambda p=p: scatter_rows(ring, p, vals))
                for p in (pos, pos.to(torch.int32))}
    require(all(sum(names.values()) == 1 for names in per_call.values()),
            f"one scatter_rows call at the insert launched {per_call}")
    # bytes the function must move: each value row read once, each ring
    # row written once, the positions read once
    nbytes = 2 * vals.numel() * 4 + pos.numel() * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    full_bytes = 2 * full.numel() * 4 + every.numel() * 8
    say("scatter", ms=f"{ms:.5f}", device_ms=f"{dev_ms:.5f}", wrapper_ms=f"{wrapper_ms:.5f}",
        plain_ms=f"{plain_ms:.5f}", index_copy_ms=f"{lib_ms:.5f}",
        index_copy_device_ms=f"{lib_dev_ms:.5f}", bound_ms=f"{bound_ms:.6f}", bytes=nbytes,
        shape=f"{INSERT_ROWS} rows of {OBS_WORDS} words into {REPLAY_CAPACITY}",
        kernels_per_call=json.dumps(per_call), one_launch_rows=limit,
        note="one launch up to one_launch_rows rows; launch-bound at the insert")
    say("scatter", set_state_ms=f"{full_ms:.5f}",
        set_state_bound_ms=f"{full_bytes / HBM_BYTES_PER_S * 1e3:.5f}", set_state_bytes=full_bytes,
        note="three launches (reset, claim, copy) above one_launch_rows")
    return {
        "name": "row_scatter", "route": "cuda",
        "source": "ray_tpu_torch/csrc/row_scatter.cu",
        "replaces": "ray_tpu/ops/framestack.py:71",
        "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
        "library_device_ms": lib_dev_ms,
        "kernels_per_call": sum(per_call["torch.int64"].values()), "passed": True,
    }


def _boundary_masses(host, size):
    """Masses on exact node boundaries (the sums of the leftmost node of
    every level and a few leaf prefix sums, as the tree rounds them),
    zero, the total and past it."""
    import numpy as np

    total = host.sum(0, size)
    cap = host.capacity
    lefts = [host.value[1 << k] for k in range(cap.bit_length())]
    prefix = [host.sum(0, e) for e in (1, 2, 3, size // 3, size // 2, size - 1) if 0 < e <= size]
    return np.array(lefts + prefix + [0.0, total, np.nextafter(total, np.inf), 1.5 * total])


def phase_descent(rng):
    import numpy as np
    import torch

    from ray_tpu_torch.execution.replay_buffer import powered_priorities
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.segment_tree import (
        DeviceSumTree, MinSegmentTree, SumSegmentTree, find_prefixsum, find_prefixsum_plain,
    )

    dev = torch.device("cuda")
    checked = []

    def check(host, size, mass, what):
        tree = torch.as_tensor(host.value, device=dev)
        m = torch.as_tensor(mass, device=dev)
        k = find_prefixsum(tree, m, host.capacity)
        p = find_prefixsum_plain(tree, m, host.capacity)
        torch.cuda.synchronize()
        require(torch.equal(k, p), f"prefix descent differs from plain: {what}")
        require(np.array_equal(k.cpu().numpy(), host.find_prefixsum_idx(mass)),
                f"prefix descent differs from the host tree: {what}")
        checked.append(what)

    size = REPLAY_CAPACITY
    host = SumSegmentTree(TREE_CAPACITY)
    powered, _ = powered_priorities(rng.random(size) * 4, 0.6)
    host.set_items(np.arange(size), powered)  # leaves past size stay 0
    total = host.sum(0, size)
    for n in (TRAIN_BATCH, 512, 4096):
        check(host, size, (rng.random(n) + np.arange(n)) / n * total, f"{n} stratified draws")
    check(host, size, _boundary_masses(host, size), "node boundaries, total and past it")
    check(host, size, np.array([np.nan, total / 3]), "a NaN mass (leaf 0)")
    check(host, size, np.array([total / 3]), "one draw")
    # levels that are not a multiple of the kernel's 8-level chunk: 0, 1,
    # 5, 6, 11 and 17
    for cap in (1, 2, 32, 64, 2048, 131072):
        small = SumSegmentTree(cap)
        small.set_items(np.arange(cap), rng.random(cap) + 0.5)
        check(small, cap, np.concatenate([_boundary_masses(small, cap), rng.random(TRAIN_BATCH) * cap]),
              f"capacity {cap}")
    say("descent", bitwise=True, checked=json.dumps(checked))

    # the whole f64 draw and the leaf write on the card against the host
    # trees: repeated indices in one write, then the stratified draw
    dt = DeviceSumTree(TREE_CAPACITY, dev)
    hs, hm = SumSegmentTree(TREE_CAPACITY), MinSegmentTree(TREE_CAPACITY)
    for t in (hs, hm):
        t.set_items(np.arange(size), powered)
    dt.set_powered(np.arange(size), powered)
    upd = rng.integers(0, size, TRAIN_BATCH)
    upd[1::4] = upd[0]
    pv, _ = powered_priorities(rng.random(TRAIN_BATCH) * 9, 0.6)
    for t in (hs, hm):
        t.set_items(upd, pv)
    dt.set_powered(torch.as_tensor(upd, device=dev), pv)
    require(dt.sum_value.cpu().numpy().tobytes() == hs.value.tobytes()
            and dt.min_value.cpu().numpy().tobytes() == hm.value.tobytes(),
            "device trees differ from the host trees after a write with repeats")
    rand = rng.random(TRAIN_BATCH)
    idx, w = dt.draw(rand, size, 0.4)
    tot = hs.sum(0, size)
    hidx = np.clip(hs.find_prefixsum_idx((rand + np.arange(TRAIN_BATCH)) / TRAIN_BATCH * tot), 0, size - 1)
    hw = ((hs[hidx] / tot * size) ** -0.4 / (hm.min(0, size) / tot * size) ** -0.4).astype(np.float32)
    require(np.array_equal(idx.cpu().numpy(), hidx), "device draw indices differ from the host oracle")
    w_ulps = int(np.abs(w.cpu().numpy().view(np.int32) - hw.view(np.int32)).max())
    require(w_ulps <= 1, f"IS weights {w_ulps} f32 ulps from the host oracle")
    say("descent", device_tree_bitwise=True, draw_indices_bitwise=True, weight_max_ulps=w_ulps)

    tree = torch.as_tensor(host.value, device=dev)
    mass = torch.as_tensor((rng.random(TRAIN_BATCH) + np.arange(TRAIN_BATCH)) / TRAIN_BATCH * total,
                           device=dev)
    out = torch.empty(TRAIN_BATCH, dtype=torch.int64, device=dev)
    lib = _kernels.library("prefix_descent")
    stream = torch.cuda.current_stream().cuda_stream
    levels = TREE_CAPACITY.bit_length() - 1
    def raw():
        return lib.prefix_descent_launch(tree.data_ptr(), mass.data_ptr(), out.data_ptr(),
                                         TRAIN_BATCH, levels, TREE_CAPACITY, stream)

    ms = cuda_ms(raw, iters=200)
    dev_ms = device_ms(raw, "prefix_descent_kernel", iters=200)
    wrapper_ms = cuda_ms(lambda: find_prefixsum(tree, mass, TREE_CAPACITY), iters=200)
    plain_ms = cuda_ms(lambda: find_prefixsum_plain(tree, mass, TREE_CAPACITY), iters=50)
    cumsum = torch.cumsum(tree[TREE_CAPACITY:], 0)
    lib_ms = cuda_ms(lambda: torch.searchsorted(cumsum, mass, right=True), iters=200)
    lib_dev_ms = device_ms(lambda: torch.searchsorted(cumsum, mass, right=True), iters=200)
    # bytes the function needs: one left child per level per draw, the
    # masses read once, the indices written once
    nbytes = TRAIN_BATCH * levels * 8 + TRAIN_BATCH * 8 + TRAIN_BATCH * 8
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    floor_ms = floor_device_ms()
    say("descent", ms=f"{ms:.5f}", device_ms=f"{dev_ms:.6f}", floor_device_ms=f"{floor_ms:.6f}",
        wrapper_ms=f"{wrapper_ms:.5f}",
        plain_ms=f"{plain_ms:.5f}", searchsorted_ms=f"{lib_ms:.5f}",
        searchsorted_device_ms=f"{lib_dev_ms:.6f}", bound_ms=f"{bound_ms:.8f}", bytes=nbytes,
        shape=f"{TRAIN_BATCH} draws, {levels} levels",
        note="latency-bound: a warp a draw, 8 levels a round trip (2 at 16 levels); "
             "searchsorted over an f64 cumsum is a yardstick only, it does not round as the "
             "tree does")
    return {
        "name": "prefix_descent", "route": "cuda",
        "source": "ray_tpu_torch/csrc/prefix_descent.cu",
        "replaces": "ray_tpu/ops/segment_tree.py:176",
        "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "floor_device_ms": floor_ms,
        "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
        "passed": True,
    }


def _gae_inputs(n, t, gen):
    import torch

    dev = torch.device("cuda")
    rewards = torch.randn(n, t, generator=gen, device=dev)
    values = torch.randn(n, t, generator=gen, device=dev)
    next_values = torch.randn(n, t, generator=gen, device=dev)
    term = torch.rand(n, t, generator=gen, device=dev) < 0.05
    trunc = torch.rand(n, t, generator=gen, device=dev) < 0.05
    trunc[:, -1] |= torch.rand(n, generator=gen, device=dev) < 0.5
    return rewards, values, next_values, term, term | trunc


def phase_gae():
    import torch

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.gae import compute_gae_fragment, compute_gae_fragment_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    # several tiles of 128 steps, T = 1, rows not a multiple of 16, T not
    # a multiple of 4; every case has a row done at every step
    shapes = [(16, 128), (1, 1), (3, 1), (5, 7), (33, 200), (257, 64), (1, 129), (16, 256)]
    worst = 0.0

    def check(args, what):
        nonlocal worst
        for gamma, lam in ((0.99, 0.95), (0.9, 1.0)):
            ak, vk = compute_gae_fragment(*args, gamma, lam)
            ap, vp = compute_gae_fragment_plain(*args, gamma, lam)
            torch.cuda.synchronize()
            worst = max(worst, float((ak - ap).abs().max()), float((vk - vp).abs().max()))
            require(torch.equal(ak, ap) and torch.equal(vk, vp),
                    f"GAE kernel differs from plain at {what}, gamma={gamma}, lambda={lam}")

    for n, t in shapes:
        args = _gae_inputs(n, t, gen)
        args[4][0] = True
        check(args, f"({n}, {t})")
    # contiguous inputs off their 16-byte (flags: 4-byte) boundary take the
    # kernel's element-wise staging
    unaligned = []
    for x in _gae_inputs(16, 128, gen):
        base = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
        base[1:] = x.reshape(-1)
        unaligned.append(base[1:].view(x.shape))
    check(unaligned, "(16, 128) unaligned")
    say("gae", bitwise=True, shapes=json.dumps(shapes), unaligned=True, all_done_row=True,
        max_abs_err=worst)

    args = _gae_inputs(16, 128, gen)
    adv, vt = torch.empty_like(args[0]), torch.empty_like(args[0])
    lib = _kernels.library("gae_scan")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in args] + [adv.data_ptr(), vt.data_ptr()]
    def raw():
        return lib.gae_fragment_launch(*ptrs, 16, 128, 0.99, 0.99 * 0.95, stream)

    ms = cuda_ms(raw, iters=200)
    dev_ms = device_ms(raw, "gae_fragment_kernel", iters=200)
    wrapper_ms = cuda_ms(lambda: compute_gae_fragment(*args, 0.99, 0.95), iters=200)
    plain_ms = cuda_ms(lambda: compute_gae_fragment_plain(*args, 0.99, 0.95), iters=20)
    nt = 16 * 128
    nbytes = 3 * nt * 4 + 2 * nt + 2 * nt * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    floor_ms = floor_device_ms()
    say("gae", ms=f"{ms:.5f}", device_ms=f"{dev_ms:.6f}", floor_device_ms=f"{floor_ms:.6f}",
        wrapper_ms=f"{wrapper_ms:.5f}", plain_ms=f"{plain_ms:.5f}", bound_ms=f"{bound_ms:.7f}",
        bytes=nbytes, library="none: no single PyTorch call computes this function",
        note="latency-bound: 128 dependent steps of two operations on one thread a row")
    return {
        "name": "gae_scan", "route": "cuda",
        "source": "ray_tpu_torch/csrc/gae_scan.cu",
        "replaces": "ray_tpu/ops/gae.py:130",
        "max_abs_err": worst, "ms": ms, "device_ms": dev_ms, "floor_device_ms": floor_ms,
        "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
        "library_device_ms": None,
        "passed": True,
    }


def phase_learner(rng):
    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete
    from ray_tpu_torch.ops.framestack import gather_rows

    policy = PPOTorchPolicy(
        Box(0, 255, (H, W, C), np.uint8), Discrete(NUM_ACTIONS),
        {"train_batch_size": B, "sgd_minibatch_size": MB, "num_sgd_iter": ITERS, "lr": 5e-5},
    )
    require(policy.params[0].is_cuda, "policy params are not on the card")
    batch = make_batch(rng)
    gather_rows.launches = 0
    times, stats = [], None
    for _ in range(2):
        t0 = time.perf_counter()
        stats = policy.learn_on_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = gather_rows.launches
    require(launches >= 1, "learn_on_batch did not launch the row-gather kernel")
    require(all(math.isfinite(v) for v in stats.values()), f"non-finite learner stats {stats}")
    say("learner", env_steps_per_s=f"{B / times[1]:.1f}", call_s=json.dumps([round(t, 4) for t in times]),
        row_gather_launches=launches, peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    say("learner", stats=json.dumps({k: round(v, 6) for k, v in stats.items()}))
    return launches


def algo_from_yaml(path, config_cls, **over):
    """The algorithm of ``config_cls`` built from a tuned-example yaml as
    written, with the named overrides (``superstep``, ``model``, ``env``)."""
    from ray_tpu_torch.utils.tuned_example import load_tuned_example

    (exp,) = load_tuned_example(path).values()
    env = over.pop("env", exp["env"])
    cfg = config_cls().update_from_dict({**exp["config"], **over})
    cfg.env = env
    return cfg.build()


def ppo_from_yaml(path, **over):
    """``PPO`` from a tuned-example yaml (:func:`algo_from_yaml`)."""
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

    return algo_from_yaml(path, PPOConfig, **over)


def spread(values):
    """{"median", "min", "max"} of a list of readings."""
    import numpy as np

    return {"median": float(np.median(values)), "min": float(min(values)), "max": float(max(values))}


# timed calls of each K in the lane phases' K = 1 against K = auto
LANE_CALLS = 1  # 2 before PR 21


def lane_rates(algo, units_per_call, calls=LANE_CALLS):
    """The rate of ``calls`` unprofiled calls of ``algo.train`` and the
    device's busy share of the first (``device_busy``: that call, then one
    profiled call): ``{"rate": spread, "busy_share": spread, "wall_s":
    [...]}``, the rate in ``units_per_call`` a second of host clock. One
    profiled call a K: a graphed lane call records about 10^5 kernels,
    which the profiler takes seconds to gather."""
    import torch

    read = device_busy(algo.train, 1)
    walls = [read["wall_s"]]
    for _ in range(calls - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        algo.train()
        torch.cuda.synchronize()
        walls.append(round(time.perf_counter() - t0, 6))
    return {"rate": spread([units_per_call / w for w in walls]),
            "busy_share": spread([read["busy_share"]]),
            "wall_s": walls, "profiled_s": [read["profiled_s"]]}


def superstep_rates(phase, make, units_per_call, warm=1):
    """The lane ``make(superstep=K)`` builds, at K = 1 and K = auto in
    one call: after ``warm`` train calls (the first captures the slot's
    graph), the rate and busy share of LANE_CALLS calls (``lane_rates``) and the
    card's peak memory over the run; printed per K."""
    import torch

    out = {}
    for k in (1, "auto"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        algo = make(superstep=k)
        kk = algo._resolve_superstep_k()
        for _ in range(warm):
            algo.train()
        rates = lane_rates(algo, units_per_call * kk)
        rates["peak_mem_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
        rates["k"] = kk
        say(phase, superstep=k, k=kk, rate=json.dumps(rates["rate"]),
            busy_share=json.dumps(rates["busy_share"]), wall_s=json.dumps(rates["wall_s"]),
            profiled_s=json.dumps(rates["profiled_s"]), peak_mem_gb=rates["peak_mem_gb"])
        out[str(k)] = rates
        del algo
    return out


def phase_lane():
    import torch

    from ray_tpu_torch.ops.gae import compute_gae_fragment

    algo = ppo_from_yaml(TUNED)
    k = algo._resolve_superstep_k()
    compute_gae_fragment.launches = 0
    results, times = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        results.append(algo.train())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = compute_gae_fragment.launches
    require(launches == 2 * k, f"the device lane launched the GAE kernel {launches} times in "
            f"2 iterations of {k} slots (replays count)")
    policy = algo.get_policy()
    # the telemetry phase's run with telemetry off: this seeded run
    off = {"params": [p.detach().clone() for p in policy.params], "iter_s": times}
    eng = algo._rollout_engine
    # one more update, split into its two halves (host clock, synchronised)
    t0 = time.perf_counter()
    batch, bsize = eng.rollout()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    policy.learn_on_device_batch(eng.learn_batch(batch), bsize)
    torch.cuda.synchronize()
    split = {"rollout_s": round(t1 - t0, 4), "learn_s": round(time.perf_counter() - t1, 4)}
    on_card = (
        all(p.is_cuda for p in policy.params)
        and all(v.is_cuda for v in eng.carry["env"].values())
        and all(v.is_cuda for v in batch.values())
    )
    require(on_card, "params, env state or batch left the card")
    require(batch["obs"].shape == (bsize, 84, 84, 1), f"obs {tuple(batch['obs'].shape)}")
    for key in ("advantages", "value_targets", "vf_preds", "action_logp"):
        require(bool(torch.isfinite(batch[key]).all()), f"non-finite {key}")
    adv = batch["advantages"]
    require(abs(float(adv.mean())) < 1e-4 and abs(float(adv.std(unbiased=False)) - 1) < 1e-3,
            "advantages are not standardised")
    last = results[-1]
    learner = last["info"]["learner"]["default_policy"]
    require(all(math.isfinite(v) for v in learner.values()), f"non-finite learner stats {learner}")
    say("lane", superstep_k=k, episode_reward_mean=last["episode_reward_mean"],
        episodes=sum(r["episodes_this_iter"] for r in results),
        num_env_steps_sampled=last["num_env_steps_sampled"],
        env_steps_per_s=f"{k * bsize / times[1]:.1f}", iter_s=json.dumps([round(t, 4) for t in times]),
        gae_launches=launches, on_card=on_card, batch_size=bsize, split=json.dumps(split))
    say("lane", learner=json.dumps({key: round(v, 6) for key, v in learner.items()}))
    del algo
    rates = superstep_rates("lane", lambda **kw: ppo_from_yaml(TUNED, **kw), bsize)
    return compute_gae_fragment.launches, rates, off


# train() calls of each seeded run of the telemetry phase (the first
# captures the lane's graph); slots of the profiled call after them
TELEMETRY_CALLS = 2
# the ledger's event time against the profiler's span of the same replays
LEDGER_TOL, LEDGER_TOL_S = 0.10, 20e-6


@contextlib.contextmanager
def profiled_card():
    """:func:`profiled` over the card's activities alone (kernels,
    copies and the CUDA runtime's calls), which a graphed call's 10^5
    kernels gather faster without their CPU operators."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def _graph_kernel_span(prof):
    """The span (first start to last end, seconds) of the device
    activities that ``torch.profiler`` ties to ``cudaGraphLaunch`` calls
    (by correlation id), their count, the launches', and the seconds from
    the first launch call's start on the host to the first of them."""
    import torch

    events = prof.profiler.kineto_results.events()
    launches = {e.correlation_id(): e.start_ns() for e in events
                if e.name() == "cudaGraphLaunch" and e.device_type() != torch.autograd.DeviceType.CUDA}
    dev = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
           and not e.is_user_annotation() and e.correlation_id() in launches]
    require(dev, f"the profiler tied no device activity to the {len(launches)} graph launches")
    start = min(e.start_ns() for e in dev)
    end = max(e.start_ns() + e.duration_ns() for e in dev)
    return (end - start) / 1e9, len(dev), len(launches), (start - min(launches.values())) / 1e9


def phase_telemetry(off):
    """ponglitejax-ppo.yaml at K = auto from its seed with
    ``telemetry(trace=True, device_ledger=True, metrics_port=0)``,
    against the lane phase's run of it with telemetry off (``off``: its
    params after TELEMETRY_CALLS calls and its calls' seconds); see the
    module docstring. The profiled call is the lane's own superstep call
    (K slots on its runner), outside ``train()``, whose other kernels
    and the profiler's CPU records would only slow the gathering.
    Returns the GAE launches of the run."""
    import urllib.request

    import torch

    from ray_tpu_torch import telemetry
    from ray_tpu_torch.ops.gae import compute_gae_fragment
    from ray_tpu_torch.telemetry import device as device_ledger
    from ray_tpu_torch.util import tracing

    compute_gae_fragment.launches = 0
    algo = ppo_from_yaml(TUNED, telemetry_config={"metrics_port": 0, "trace": True,
                                                  "device_ledger": True})
    try:
        walls_on = []
        for _ in range(TELEMETRY_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            algo.train()
            torch.cuda.synchronize()
            walls_on.append(time.perf_counter() - t0)
        k, bsize = algo._resolve_superstep_k(), int(algo.config["train_batch_size"])
        walls_off = off["iter_s"]
        policy = algo.get_policy()
        require(all(torch.equal(a, b) for a, b in zip(policy.params, off["params"])),
                f"params after {TELEMETRY_CALLS} train() calls differ with telemetry on")
        (runner,) = [r for r in policy._superstep_runners.values()
                     if r.label.startswith("rollout_superstep[")]
        before = {p["label"]: p for p in device_ledger.snapshot()["programs"]}[runner.label]
        eng = algo._rollout_engine
        with profiled_card() as prof:
            _, carry, metrics, _ = policy.learn_rollout_superstep(
                k, eng.batch_size, eng.superstep_feed(), k_max=k)
        eng.advance(carry, metrics)
        span_s, n_dev, n_launch, launch_gap_s = _graph_kernel_span(prof)
        snap = device_ledger.snapshot()
        lane = {p["label"]: p for p in snap["programs"]}[runner.label]
        event_s = lane["device_time_s"] - before["device_time_s"]
        say("telemetry", superstep_k=k, params_equal_with_telemetry=True,
            env_steps_per_s_off=f"{k * bsize / walls_off[1]:.1f}",  # the lane phase's run
            env_steps_per_s_on=f"{k * bsize / walls_on[1]:.1f}",
            iter_s_off=json.dumps([round(w, 4) for w in walls_off]),
            iter_s_on=json.dumps([round(w, 4) for w in walls_on]))
        say("telemetry", program=runner.label, executions=lane["executions"],
            traces=lane["traces"], run_calls=runner.runs, flops=lane["flops"],
            bytes_accessed=lane["bytes_accessed"], mfu=lane["mfu"],
            bandwidth_util=lane["bandwidth_util"], device_time_s=lane["device_time_s"],
            capture_s=lane["compile_time_s"], memory=json.dumps(lane["memory"]))
        say("telemetry", call_event_s=f"{event_s:.6f}", profiler_span_s=f"{span_s:.6f}",
            ratio=f"{event_s / span_s:.4f}", first_launch_to_kernel_s=f"{launch_gap_s:.6f}",
            graph_launches=n_launch, graph_activities=n_dev)
        require(lane["executions"] == runner.runs - runner.captures,
                f"{lane['executions']} ledger executions for {runner.runs} run calls "
                f"and {runner.captures} capture")
        require(lane["flops"] and lane["flops"] > 0, f"no FLOPs counted: {lane}")
        require(lane["mfu"] is not None and 0 < lane["mfu"] <= 1, f"MFU {lane['mfu']}")
        require(n_launch == k, f"{n_launch} graph launches profiled for {k} slots")
        require(abs(event_s - span_s) <= max(LEDGER_TOL * span_s, LEDGER_TOL_S),
                f"ledger event time {event_s:.6f} s against the profiler's span {span_s:.6f} s")
        port = algo._telemetry.metrics_port
        blob = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        for series in ("ray_tpu_program_executions_total", "ray_tpu_program_device_seconds_total",
                       "ray_tpu_program_flops"):
            require(f'{series}{{program="{runner.label}"}}' in blob, f"no {series} in the scrape")
        tmp = tempfile.mkdtemp(prefix="chip_smoke_timeline_")
        try:
            path = algo.export_timeline(os.path.join(tmp, "timeline.json"), last_n=2)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
        device_spans = [e for e in events if e["ph"] == "X" and e["name"].startswith("device:")]
        require(f"device:{runner.label}" in lanes and device_spans,
                f"no device lane in the timeline ({sorted(lanes)})")
        say("telemetry", scrape_bytes=len(blob), timeline_events=len(events),
            device_lane_spans=len(device_spans),
            programs=json.dumps({p["label"]: p["executions"] for p in snap["programs"]}))
    finally:
        algo.stop()
        runtime = telemetry.runtime()
        if runtime is not None:
            runtime.shutdown()
        device_ledger.clear()
        tracing.clear()
    return compute_gae_fragment.launches


# traced calls of ppo_prefetch's algorithm, at most, until one rolls up
# its workers' sampling spans
PREFETCH_TRACED_CALLS = 8


def _prefetch_traced(algo):
    """Traced ``train()`` calls of the prefetch phase's algorithm (its
    workers up already) until one's ``info/telemetry`` holds sampling;
    its overlap fraction beside
    :func:`span_overlap` over the same spans and window (learn spans
    against the merged sampling spans, clipped to the window)."""
    from ray_tpu_torch import telemetry
    from ray_tpu_torch.util import tracing

    runtime = telemetry.init(trace=True, device_ledger=False)
    try:
        # the requests in flight and the batches queued were sent and
        # sampled untraced: calls until one's window holds the workers'
        # sampling spans (traced requests' replies)
        for calls in range(1, PREFETCH_TRACED_CALLS + 1):
            prev = algo._prev_iter_window
            r = algo.train()
            tel = r["info"]["telemetry"]
            if tel["sample_s"] > 0:
                break
        require(tel["sample_s"] > 0, f"no sampling span in {calls} traced calls")
        spans = tracing.get_spans()
        window = algo._prev_iter_window if tel["window_iterations_ago"] == 0 else prev

        def clipped(prefixes):
            out = []
            for s in spans:
                if s["name"].startswith(prefixes):
                    a, b = max(s["start"], window[0]), min(s["end"] or s["start"], window[1])
                    if b > a:
                        out.append((a, b))
            return sorted(out)

        merged = []
        for a, b in clipped(("rollout:", "sampler:")):
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(b, merged[-1][1]))
            else:
                merged.append((a, b))
        own = span_overlap(clipped(("learn:nest", "learn:superstep")), merged)
        require(abs(own - tel["overlap_fraction"]) < 1e-9,
                f"overlap_fraction {tel['overlap_fraction']} against span_overlap {own}")
        say("ppo_prefetch", traced_overlap_fraction=f"{tel['overlap_fraction']:.6f}",
            span_overlap=f"{own:.6f}", window_iterations_ago=tel["window_iterations_ago"],
            sample_s=f"{tel['sample_s']:.4f}", learn_s=f"{tel['learn_s']:.4f}",
            transfer_s=f"{tel['transfer_s']:.4f}", iteration_s=f"{tel['iteration_s']:.4f}",
            spans=len(spans), processes=len({s["pid"] for s in spans}), traced_calls=calls)
    finally:
        runtime.shutdown()
        tracing.clear()


# DQN's replay intensity on the lane: 64 sampled steps a round owe 8
# updates of 32 rows, one superstep of K = 8 (at K = 1 prioritized replay
# takes no debt and makes one update a round, as in the reference)
DQN_TRAINING_INTENSITY = 4


def dqn_config(superstep="auto"):
    """DQN on the PongLite device lane at full width: DQNConfig's own
    defaults (lr 5e-4, batch 32, grad clip 40, double-Q, dueling,
    n_step 1, learning starts 1000, target update 500, epsilon 1.0 ->
    0.02 over 10000 steps, Nature CNN with a 512 hidden layer), with
    these overrides named: the device lane with 16 envs (as the PPO
    lane), prioritized replay of 50000 rows with its rows and its sum
    tree on the card, ``training_intensity`` 4 (``DQN_TRAINING_INTENSITY``)
    and ``superstep``, seed 0."""
    from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig

    cfg = (
        DQNConfig()
        .environment("PongLiteJax-v0", env_backend="jax")
        .rollouts(num_envs_per_worker=16, rollout_fragment_length=4)
        .training(
            replay_buffer_config={
                "capacity": REPLAY_CAPACITY, "prioritized_replay": True,
                "prioritized_replay_alpha": 0.6, "prioritized_replay_beta": 0.4,
            },
            replay_device_resident=True, replay_device_tree=True,
            training_intensity=DQN_TRAINING_INTENSITY,
        )
        .debugging(seed=0)
    )
    cfg.superstep = superstep
    return cfg


def dqn_filled(superstep="auto", model=None, fill=16):
    """``dqn_config(superstep)`` (with ``model``) after ``fill`` rounds,
    up to learning starts (16 x 64 = 1024 steps)."""
    cfg = dqn_config(superstep)
    if model is not None:
        cfg.training(model=dict(model))
    algo = cfg.build()
    for _ in range(fill):
        algo.train()
    return algo


def phase_dqn():
    import numpy as np
    import torch

    from ray_tpu_torch.ops.framestack import gather_rows, scatter_rows
    from ray_tpu_torch.ops.segment_tree import find_prefixsum

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    algo = dqn_config().build()
    policy = algo.get_policy()
    kk = algo._resolve_superstep_k()
    kernels = (gather_rows, scatter_rows, find_prefixsum)
    for k in kernels:
        k.launches = 0
    warm, warm_s = 16, 0.0
    results = []
    for _ in range(warm):  # fill up to learning starts (16 x 64 = 1024 steps)
        r, dt = sync_time(algo.train)
        results.append(r)
        warm_s += dt
    # the first update pays the backward's cuDNN set-up and the capture
    # of the replay slot's graph: timed apart
    r, first_s = sync_time(algo.train)
    results.append(r)
    learn_iters = 23 if kk == 1 else 6
    r0 = results[-1]["info"]
    _, learn_s = sync_time(lambda: [results.append(algo.train()) for _ in range(learn_iters)])
    launches = {k.__name__: k.launches for k in kernels}
    last = results[-1]
    info = last["info"]
    updates = (info["num_env_steps_trained"] - r0.get("num_env_steps_trained", 0)) // TRAIN_BATCH
    for name, n in launches.items():
        require(n >= 1, f"the DQN lane did not launch {name}")
    require(info.get("num_target_updates", 0) >= 1, f"no target update: {info}")
    learner = info["learner"]["default_policy"]
    require(all(math.isfinite(v) for v in learner.values()), f"non-finite learner stats {learner}")
    buf = algo.local_replay_buffer.buffers["default_policy"]
    on_card = (
        not buf.spilled
        and all(r.is_cuda for r in buf._store.values())
        and buf._dtree.sum_value.is_cuda and buf._dtree.min_value.is_cuda
        and all(p.is_cuda for p in policy.params)
        and all(t.is_cuda for t in policy.aux_state["target_params"])
    )
    require(on_card, "ring columns, trees or params left the card")
    runners = list(policy._superstep_runners.values())
    require(kk == 1 or (len(runners) == 1 and runners[0].graph is not None),
            f"DQN at K = {kk} ran no captured replay slot")
    say("dqn", superstep_k=kk, iters=len(results),
        env_steps_per_s=f"{learn_iters * INSERT_ROWS / learn_s:.1f}",
        updates_per_s=f"{updates / learn_s:.2f}", fill_env_steps_per_s=f"{warm * INSERT_ROWS / warm_s:.1f}",
        first_update_iter_s=f"{first_s:.4f}",
        launches=json.dumps(launches), replay_size=len(buf), storage_bytes=buf.storage_bytes,
        num_target_updates=info["num_target_updates"],
        num_env_steps_sampled=info["num_env_steps_sampled"],
        num_env_steps_trained=info["num_env_steps_trained"],
        epsilon=f"{policy.coeff_values['epsilon']:.4f}", on_card=on_card,
        episode_reward_mean=last["episode_reward_mean"])
    say("dqn", learner=json.dumps({k: round(v, 6) for k, v in learner.items()}))
    # K = 1 against K = auto: each call of train() is one round, 1 or K
    # replay updates; the rate is updates a second
    superstep_rates("dqn", lambda superstep: dqn_filled(superstep), 1)

    eng = algo._jax_rollout_engine_get()

    def one_update():
        """sample -> learn -> priority update, each timed, synchronised."""
        b, t_sample = sync_time(lambda: buf.sample(TRAIN_BATCH, beta=0.4))
        _, t_learn = sync_time(lambda: policy.learn_on_device_batch(dict(b.tree), b.count))
        _, t_prio = sync_time(lambda: buf.update_priorities(
            b.indices, policy.compute_td_error(b) + 1e-6))
        return {"sample_s": t_sample, "learn_s": t_learn, "priority_update_s": t_prio}

    (tree, count), t_fill = sync_time(eng.rollout)
    _, t_insert = sync_time(lambda: algo._insert_rollout_tree(tree))
    split = {"rollout_fill_s": t_fill, "insert_s": t_insert, **one_update()}
    say("dqn", split=json.dumps({k: round(v, 6) for k, v in split.items()}),
        rows=count, replay_size=len(buf))

    # the ring at capacity: synthetic rows in the lane's columns and
    # types, 5000 at a time, then the update at 50000 rows
    gen = torch.Generator(device="cuda").manual_seed(2)
    chunk = 5000
    t_full = 0.0
    while len(buf) < REPLAY_CAPACITY:
        rows = {}
        for k, ring in buf._store.items():
            row_shape, dtype, _ = buf._meta[k]
            if dtype == torch.bool:
                rows[k] = torch.rand((chunk,) + row_shape, device="cuda", generator=gen) < 0.01
            elif dtype.is_floating_point:
                rows[k] = torch.randn((chunk,) + row_shape, device="cuda", generator=gen).to(dtype)
            else:
                hi = 255 if dtype == torch.uint8 else 3
                rows[k] = torch.randint(0, hi, (chunk,) + row_shape, device="cuda",
                                        generator=gen).to(dtype)
        _, dt = sync_time(lambda: buf.add_device_tree(rows))
        t_full += dt
    require(len(buf) == REPLAY_CAPACITY, f"ring holds {len(buf)} rows")
    full = [one_update() for _ in range(5)]
    med = {k: float(np.median([u[k] for u in full])) for k in full[0]}
    say("dqn", at_capacity=json.dumps({k: round(v, 6) for k, v in med.items()}),
        replay_size=len(buf), storage_bytes=buf.storage_bytes,
        fill_chunk_rows=chunk, fill_s=f"{t_full:.3f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    return launches


def _flash_inputs(gen, b, h, t, s, d, dtype, layout="bhtd"):
    """q (B, H, T, D), k and v (B, H, S, D): contiguous ("bhtd"), or
    (B, H, n, D) views over (B, n, H, D) memory ("bthd"), as the torso's
    projections come."""
    import torch

    if layout == "bhtd":
        return [torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype) for n in (t, s, s)]
    return [torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
            for n in (t, s, s)]


def flash_raw(lib, q, k, v, out, offset, stream):
    """A function that launches flash_fwd_launch once on prepared (B, H,
    T, D) tensors, read through their strides."""
    import torch

    b, h, t, d = q.shape
    strides = [x for y in (q, k, v, out) for x in y.stride()[:3]]
    banded = offset is not None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t, k.shape[2], d,
            *strides, int(q.dtype == torch.bfloat16), int(banded), offset if banded else 0, stream)
    return lambda: lib.flash_fwd_launch(*args)


def phase_flash():
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.flash_attention import flash_attention, reference_attention

    f32, bf16 = torch.float32, torch.bfloat16
    heads = TORSO["transformer_num_heads"]
    dh = TORSO["transformer_dim"] // heads
    gen = torch.Generator(device="cuda").manual_seed(5)
    # (name, B, H, T, S, D, offset, dtype, layout): the torso's path shapes
    # (B·H = 2048 learner minibatch, 4096 lane minibatch, 128 lane act
    # step, 256 DQN forward; the server's exact mode, a batch-1 body a row,
    # B·H = 8, and its vectorized buckets of 2, 4 and 8 rows, whose 16 and
    # 32 are the lane act and DQN shapes; GTrXL's act step, one query row
    # against its 50-step memory and itself, for the sampler's 4 envs and
    # a single action) in the layout the models give them (bthd) and
    # contiguous; the reference test's shapes and offsets; head widths
    # (D > 64 takes the warp-per-row stream); the short-head path's edges:
    # heads not a multiple of a warp's, T of 1, 3, 17 and 32, D of 1 and
    # 33, S past an 8-key chunk (the chunk merge), rows that see no key;
    # bf16 contiguous and in the torso's layout
    path = [("learner", TF_B // 2, heads, 8, 8, dh, 0), ("lane_learn", 512, heads, 8, 8, dh, 0),
            ("lane_act", 16, heads, 8, 8, dh, 0), ("dqn", TRAIN_BATCH, heads, 8, 8, dh, 0),
            ("serve_exact", 1, heads, 8, 8, dh, 0)] + [
        (f"serve_vec_{b}", b, heads, 8, 8, dh, 0) for b in (2, 4, 8)] + [
        ("gtrxl_act", 4, 2, 1, 51, 32, 50), ("gtrxl_single", 1, 2, 1, 51, 32, 50)]
    cases = [c + (f32, "bthd") for c in path] + [(f"{c[0]}_contiguous",) + c[1:] + (f32, "bhtd")
                                                 for c in path] + [
        ("full_24x40", 2, 2, 24, 40, 16, None, f32, "bhtd"),
        ("band16_24x40", 2, 2, 24, 40, 16, 16, f32, "bhtd"),
        ("causal_32x32", 2, 2, 32, 32, 16, 0, f32, "bhtd"),
        ("band7_130x200", 2, 2, 130, 200, 16, 7, f32, "bhtd"),
        ("zero_rows_8x8_m3", 2, 2, 8, 8, 16, -3, f32, "bhtd"),
    ] + [(f"d{d}", 64, 4, 16, 16, d, 0, f32, "bhtd") for d in (16, 32, 64, 128)] + [
        ("t3_9_heads", 3, 3, 3, 3, 32, 0, f32, "bthd"),
        ("t1_d1", 4, 5, 1, 9, 1, None, f32, "bhtd"),
        ("t17x40_band5", 2, 3, 17, 40, 16, 5, f32, "bthd"),
        ("t32x70_d64_m3", 1, 3, 32, 70, 64, -3, f32, "bthd"),
        ("d33", 2, 2, 8, 8, 33, 0, f32, "bhtd"),
        ("bf16_16x16", 2, 2, 16, 16, 16, None, bf16, "bhtd"),
        ("bf16_learner_bthd", 64, heads, 8, 8, dh, 0, bf16, "bthd"),
    ]
    errs = {}
    for name, b, h, t, s, d, off, dtype, layout in cases:
        q, k, v = _flash_inputs(gen, b, h, t, s, d, dtype, layout)
        got = flash_attention(q, k, v, causal_offset=off)
        want = reference_attention(q, k, v, off)
        torch.cuda.synchronize()
        require(got.dtype == dtype and got.shape == (b, h, t, d), f"flash output of {name}")
        require(got.stride() == q.stride(), f"flash output of {name} is not in q's layout")
        tol = 3e-2 if dtype == bf16 else 2e-5
        require(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
                f"flash kernel differs from plain at {name}")
        errs[name] = float((got.float() - want.float()).abs().max())
        if off is not None and off < 0:
            require(torch.equal(got[:, :, :-off], torch.zeros_like(got[:, :, :-off])),
                    "rows that see no key are not exactly 0")
            require(bool(got[:, :, -off:].abs().max() > 0), "rows that see keys are 0")
    worst = max(errs[c[0]] for c in cases if c[-2] == f32)
    worst_bf16 = max(errs[c[0]] for c in cases if c[-2] == bf16)
    say("flash", checked=json.dumps(errs), max_abs_err_f32=worst, max_abs_err_bf16=worst_bf16,
        zero_rows_exact=True, output_layout_is_q=True)

    # times at the path shapes, on inputs in the torso's layout:
    # the kernel by CUDA events over raw launches (ms) and by its own
    # device duration (device_ms); SDPA with the same band mask, both ways
    lib = _kernels.library("flash_fwd")
    stream = torch.cuda.current_stream().cuda_stream
    by_path = {}
    for name, b, h, t, s, d, off in path:
        q, k, v = _flash_inputs(gen, b, h, t, s, d, f32, "bthd")
        out = torch.empty_like(q)
        raw = flash_raw(lib, q, k, v, out, off, stream)
        mask = torch.arange(s, device="cuda")[None, :] <= torch.arange(t, device="cuda")[:, None] + off

        def sdpa(q=q, k=k, v=v, mask=mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        n = b * h
        nbytes = 4 * n * 2 * (t + s) * d  # q, k, v read once, o written once
        flops = 4 * n * int(mask.sum()) * d  # two multiply-adds per visible pair
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        by_path[name] = {
            "bh": n, "ms": cuda_ms(raw, iters=200),
            "device_ms": device_ms(raw, "flash_rows_kernel", iters=200),
            "sdpa_ms": cuda_ms(sdpa, iters=200), "sdpa_device_ms": device_ms(sdpa, iters=200),
            "bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops,
        }
        by_path[name]["bound_share"] = by_path[name]["bound_ms"] / by_path[name]["device_ms"]
        say("flash", path=name, shape=f"B*H={n} T={t} S={s} D={d} f32 band {off}, (B, T, H, D) memory",
            **{k_: (f"{v_:.6f}" if isinstance(v_, float) else v_) for k_, v_ in by_path[name].items()})
    # one long head on the warp-per-row stream (T > 32: GTrXL's memory of
    # keys), not on any main path, timed by device
    b, h, t, s, d, off = 64, heads, 130, 200, dh, 7
    q, k, v = _flash_inputs(gen, b, h, t, s, d, f32, "bthd")
    out = torch.empty_like(q)
    long_head = {"bh": b * h, "shape": f"T={t} S={s} D={d} f32 band {off}, (B, T, H, D) memory",
                 "device_ms": device_ms(flash_raw(lib, q, k, v, out, off, stream),
                                        "flash_fwd_kernel", iters=50)}
    say("flash", long_head=long_head["shape"], bh=long_head["bh"],
        device_ms=f"{long_head['device_ms']:.6f}")
    # the wrapper at the learner shape: a plain call (the act path and
    # the target forwards, under no_grad or with inputs that need no
    # gradient: a direct launch) and one through autograd (training)
    name, b, h, t, s, d, off = path[0]
    q, k, v = _flash_inputs(gen, b, h, t, s, d, f32, "bthd")
    wrapper_ms = cuda_ms(lambda: flash_attention(q, k, v, causal_offset=off), iters=200)
    gq, gk, gv = (x.detach().requires_grad_() for x in (q, k, v))
    wrapper_grad_ms = cuda_ms(lambda: flash_attention(gq, gk, gv, causal_offset=off), iters=200)
    plain_ms = cuda_ms(lambda: reference_attention(q, k, v, off), iters=200)
    mask = torch.arange(s, device="cuda")[None, :] <= torch.arange(t, device="cuda")[:, None] + off
    sdpa_err = float((F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
                      - flash_attention(q, k, v, causal_offset=off)).abs().max())
    row = by_path[name]
    say("flash", ms=f"{row['ms']:.5f}", device_ms=f"{row['device_ms']:.6f}",
        wrapper_ms=f"{wrapper_ms:.5f}", wrapper_autograd_ms=f"{wrapper_grad_ms:.5f}",
        plain_ms=f"{plain_ms:.5f}", sdpa_ms=f"{row['sdpa_ms']:.5f}",
        sdpa_device_ms=f"{row['sdpa_device_ms']:.6f}", sdpa_max_abs_diff=sdpa_err,
        bound_ms=f"{row['bound_ms']:.6f}", shape=f"B*H={b * h} T={t} S={s} D={d} f32 band 0")
    return {
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:117",
        "max_abs_err": worst, "max_abs_err_bf16": worst_bf16,
        "ms": row["ms"], "device_ms": row["device_ms"], "wrapper_ms": wrapper_ms,
        "wrapper_autograd_ms": wrapper_grad_ms, "plain_ms": plain_ms,
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["sdpa_ms"], "library_device_ms": row["sdpa_device_ms"],
        "times_by_path": by_path, "long_head": long_head, "passed": True,
    }


def _band_pairs(t, s, offset):
    """Visible (query, key) pairs of one head: j <= i + offset, j < s."""
    import torch

    return int((torch.arange(t) + offset + 1).clamp(0, s).sum())


def phase_flash_block():
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.flash_attention import (
        flash_block_attention_stats, reference_block_attention_stats,
    )

    f32, bf16 = torch.float32, torch.bfloat16
    n_hop = RING_B * RING_H
    gen = torch.Generator(device="cuda").manual_seed(6)
    # (name, B·H, T, S, D, offset, dtype): the ring's hop on the diagonal,
    # one and three shards behind (every key visible) and one ahead (none),
    # the torso's shape, the reference test's shard, ragged T and S, the
    # head widths, and bf16 at the hop and ragged
    cases = [
        ("hop_diagonal", n_hop, RING_HOP, RING_HOP, RING_D, 0, f32),
        ("hop_behind_1", n_hop, RING_HOP, RING_HOP, RING_D, RING_HOP, f32),
        ("hop_behind_3", n_hop, RING_HOP, RING_HOP, RING_D, 3 * RING_HOP, f32),
        ("hop_ahead_1", n_hop, RING_HOP, RING_HOP, RING_D, -RING_HOP, f32),
        ("torso", TF_B // 2 * TORSO["transformer_num_heads"], 8, 8, 32, 0, f32),
        ("shard_8x8", 4, 8, 8, 16, 0, f32),
        ("shard_8x8_behind", 4, 8, 8, 16, 8, f32),
        ("shard_8x8_ahead", 4, 8, 8, 16, -8, f32),
        ("ragged_130x200_7", 4, 130, 200, 16, 7, f32),
        ("ragged_130x200_m150", 4, 130, 200, 16, -150, f32),
    ] + [(f"d{d}", 64, 16, 16, d, 0, f32) for d in (16, 32, 64, 128)] + [
        # the tile's edges (64 rows, 64 keys): D short of or between the
        # mma's depths, T and S beside a tile edge, offsets on and beside it
        ("tile_63x65_d8", 4, 63, 65, 8, 0, f32),
        ("tile_65x63_d40_1", 4, 65, 63, 40, 1, f32),
        ("tile_129_63", 4, 129, 129, 16, 63, f32),
        ("tile_129_64", 4, 129, 129, 16, 64, f32),
        ("tile_129x65_d40_m64", 4, 129, 65, 40, -64, f32),
        ("tile_65x129_d7_2", 4, 65, 129, 7, 2, f32),
        ("bf16_hop_diagonal", n_hop, RING_HOP, RING_HOP, RING_D, 0, bf16),
        ("bf16_hop_behind_1", n_hop, RING_HOP, RING_HOP, RING_D, RING_HOP, bf16),
        ("bf16_130x200_7", 4, 130, 200, 16, 7, bf16),
        ("bf16_tile_129_d40_63", 4, 129, 129, 40, 63, bf16),
        ("bf16_tile_65x129_d7_2", 4, 65, 129, 7, 2, bf16),
        # the query row per thread (T <= 32, D <= 64): ragged heads, the
        # chunk merge past 32 and 16 keys, blind rows, D of 1 and 33, bf16
        ("rows_17x40_m5", 3, 17, 40, 16, -5, f32),
        ("rows_32x70_d64_3", 2, 32, 70, 64, 3, f32),
        ("rows_3x5_d1", 9, 3, 5, 1, 0, f32),
        ("rows_8x8_d33_m2", 5, 8, 8, 33, -2, f32),
        ("bf16_rows_8x8_m2", 64, 8, 8, 32, -2, bf16),
    ]

    def need(g, w):
        # the least t with |g - w| <= t + t·|w| everywhere: allclose's
        # tolerance that this pair needs
        return float(((g.double() - w).abs() / (1 + w.abs())).max())

    errs, needs, blind_rows, failed = {}, {}, 0, []
    for name, n, t, s, d, off, dtype in cases:
        q, k, v = (torch.randn(n, x, d, device="cuda", generator=gen).to(dtype) for x in (t, s, s))
        got = flash_block_attention_stats(q, k, v, off)
        # the plain version on float64 copies of the same inputs (bf16
        # inputs are exact there), so this measures the kernel's own
        # float32 error; the plain version in float32 beside it
        want = reference_block_attention_stats(q.double(), k.double(), v.double(), off)
        plain32 = reference_block_attention_stats(q, k, v, off)
        torch.cuda.synchronize()
        blind = torch.arange(t, device="cuda") + off < 0  # rows that see no key
        errs[name] = []  # max |kernel - plain| of acc, m, l over the rows that see keys
        needs[name] = {"kernel": [], "plain_f32": []}  # need() of acc, m, l
        for what, g, w, p32 in zip(("acc", "m", "l"), got, want, plain32):
            require(g.dtype == f32 and g.shape == w.shape, f"flash_block {what} of {name}")
            needs[name]["kernel"].append(need(g, w))
            needs[name]["plain_f32"].append(need(p32, w))
            tol = BLOCK_TOL_HOP if s >= RING_HOP else BLOCK_TOL
            if not torch.allclose(g.double(), w, atol=tol, rtol=tol):
                failed.append(f"{what} at {name}")
            errs[name].append(float((g.double() - w)[:, ~blind].abs().max()) if bool((~blind).any()) else 0.0)
        acc, m, l = got
        require(bool((m[:, blind] == -1e30).all()) and bool((l[:, blind] == 0).all())
                and bool((acc[:, blind] == 0).all()), f"rows that see no key are not exact at {name}")
        require(bool((l[:, ~blind] > 0).all()), f"rows that see keys have l = 0 at {name}")
        blind_rows += int(blind.sum()) * n
    worst = max(max(errs[c[0]]) for c in cases if c[-1] == f32)
    worst_bf16 = max(max(errs[c[0]]) for c in cases if c[-1] == bf16)
    say("flash_block", checked_acc_m_l=json.dumps(errs), max_abs_err_f32=worst,
        max_abs_err_bf16=worst_bf16, blind_rows_exact=blind_rows,
        plain="reference_block_attention_stats on float64 copies of the inputs")
    say("flash_block", tolerance_needed_acc_m_l=json.dumps(needs),
        tolerance=json.dumps({"hop": BLOCK_TOL_HOP, "other": BLOCK_TOL}),
        note="least atol = rtol that allclose against float64 needs: the kernel's, "
        "and the plain version's in float32 on the same inputs")
    require(not failed, f"flash_block kernel differs from plain (float64) in {failed}")

    # times at the ring's hop (B·H = 8, T = S = 4096, D = 32, f32 and
    # bf16): the diagonal hop and a hop with every key visible, and at
    # the torso's shape
    lib = _kernels.library("flash_block")
    stream = torch.cuda.current_stream().cuda_stream

    def raw(q, k, v, off):
        n, t, d = q.shape
        acc = torch.empty((n, t, d), device="cuda")
        ml = torch.empty((2, n, t), device="cuda")
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), ml[0].data_ptr(),
                ml[1].data_ptr(), n, t, k.shape[1], d, int(q.dtype == bf16), off, stream)
        return lambda: lib.flash_block_launch(*args)  # acc and ml stay alive in the closure

    def bound(n, t, s, d, off, dtype):
        # bytes: q, k, v read once, acc, m, l written once; operations: a
        # multiply-add for q·k and one for p·v per visible pair. The rate
        # each is held to: p·v at the f32 rate (p is float32 and the
        # function keeps float32 accuracy), q·k at the same for f32
        # inputs and at the bf16 tensor-core rate for bf16 inputs (whose
        # products are exact there)
        item = 2 if dtype == bf16 else 4
        nbytes = (n * t * d + 2 * n * s * d) * item + (n * t * d + 2 * n * t) * 4
        flops = 4 * d * n * _band_pairs(t, s, off)
        qk_rate = BF16_FLOPS_PER_S if dtype == bf16 else F32_FLOPS_PER_S
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = (flops / 2 / qk_rate + flops / 2 / F32_FLOPS_PER_S) * 1e3
        return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations"), nbytes, flops

    times = {}
    for dtype in (f32, bf16):
        q, k, v = (torch.randn(n_hop, RING_HOP, RING_D, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        for label, off in (("diagonal", 0), ("all_visible", RING_HOP)):
            mask = None
            if off < RING_HOP - 1:
                idx = torch.arange(RING_HOP, device="cuda")
                mask = idx[None, :] <= idx[:, None] + off
            b_ms, b_by, nbytes, flops = bound(n_hop, RING_HOP, RING_HOP, RING_D, off, dtype)
            key = label if dtype == f32 else f"bf16_{label}"
            def sdpa(q=q, k=k, v=v, mask=mask):
                return F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=mask)

            row = times[key] = {
                "ms": cuda_ms(raw(q, k, v, off), iters=20, warmup=3),
                "device_ms": device_ms(raw(q, k, v, off), "flash_block_kernel", iters=20, warmup=3),
                "wrapper_ms": cuda_ms(lambda: flash_block_attention_stats(q, k, v, off), iters=20, warmup=3),
                "plain_ms": cuda_ms(lambda: reference_block_attention_stats(q, k, v, off), iters=5, warmup=2),
                "sdpa_ms": cuda_ms(sdpa, iters=20, warmup=3),
                "sdpa_device_ms": device_ms(sdpa, iters=20, warmup=3),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
            }
            row["bound_share"] = row["bound_ms"] / row["ms"]
            say("flash_block", hop=key, offset=off, **{k_: (f"{v_:.5f}" if isinstance(v_, float) else v_)
                                                      for k_, v_ in row.items()},
                shape=f"B*H={n_hop} T=S={RING_HOP} D={RING_D} {str(dtype)[6:]}",
                sdpa="normalised output only (no m, l), same band mask" if mask is not None
                else "normalised output only (no m, l), no mask")
    name, n, t, s, d, off, _ = cases[4]
    tq, tk, tv = (torch.randn(n, x, d, device="cuda", generator=gen) for x in (t, s, s))
    torso_ms = cuda_ms(raw(tq, tk, tv, off), iters=200)
    torso_device_ms = device_ms(raw(tq, tk, tv, off), "flash_rows_kernel", iters=200)
    torso_bound = bound(n, t, s, d, off, f32)
    say("flash_block", torso_ms=f"{torso_ms:.5f}", torso_device_ms=f"{torso_device_ms:.6f}",
        torso_bound_ms=f"{torso_bound[0]:.6f}",
        torso_bound_by=torso_bound[1], shape=f"B*H={n} T=S={t} D={d} f32 band 0",
        note="operation-bound at the hop: tensor-core tiles of 64 rows x 64 keys, 3xTF32 for "
             "f32; the torso's shape (T <= 32, D <= 64) runs a query row per thread",
        rates=json.dumps({"f32": {"q.k": F32_FLOPS_PER_S, "p.v": F32_FLOPS_PER_S},
                          "bf16": {"q.k": BF16_FLOPS_PER_S, "p.v": F32_FLOPS_PER_S}}))
    hop = times["all_visible"]
    return {
        "name": "flash_block", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_block.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:131",
        "max_abs_err": worst, "max_abs_err_bf16": worst_bf16,
        "ms": hop["ms"], "device_ms": hop["device_ms"], "wrapper_ms": hop["wrapper_ms"],
        "plain_ms": hop["plain_ms"], "bound_ms": hop["bound_ms"], "bound_by": hop["bound_by"],
        "library_ms": hop["sdpa_ms"], "library_device_ms": hop["sdpa_device_ms"],
        "library": "scaled_dot_product_attention (normalised output only)",
        "shape": f"B*H={n_hop} T=S={RING_HOP} D={RING_D} f32, every key visible",
        "times_by_hop": times, "torso_ms": torso_ms, "torso_device_ms": torso_device_ms,
        "torso_bound_ms": torso_bound[0],
        "passed": True,
    }


def torso_forward_kernels(policy, obs):
    """The device activities of one torso forward under ``no_grad``
    (``torch.profiler``): their count, the copies among them, and the
    flash kernels by name."""
    import torch

    with torch.no_grad():
        names = device_kernels(lambda: policy.model(obs))
    flash = {k: sum(c for n, c in names.items() if k in n)
             for k in ("flash_rows_kernel", "flash_fwd_kernel")}
    return {"activities": sum(names.values()),
            "copies": sum(c for n, c in names.items() if "copy" in n.lower()),
            "flash": {k: c for k, c in flash.items() if c}}


def phase_transformer_learner():
    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete
    from ray_tpu_torch.ops.flash_attention import flash_attention

    policy = PPOTorchPolicy(
        Box(-1, 1, (TF_OBS,), np.float32), Discrete(TF_ACTIONS),
        {"train_batch_size": TF_B, "sgd_minibatch_size": TF_B // 2, "num_sgd_iter": 2,
         "lr": 3e-4, "seed": 0, "model": dict(TORSO)},
    )
    require(all(p.is_cuda for p in policy.params), "torso params are not on the card")
    rng = np.random.default_rng(0)  # the batch of bench.py's model-parallel A/B
    batch = {
        "obs": rng.standard_normal((TF_B, TF_OBS)).astype(np.float32),
        "actions": rng.integers(0, TF_ACTIONS, TF_B).astype(np.int64),
        "action_logp": np.full(TF_B, -2.0, np.float32),
        "action_dist_inputs": rng.standard_normal((TF_B, TF_ACTIONS)).astype(np.float32),
        "advantages": rng.standard_normal(TF_B).astype(np.float32),
        "value_targets": rng.standard_normal(TF_B).astype(np.float32),
    }
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    times, stats = [], None
    for _ in range(2):
        t0 = time.perf_counter()
        stats = policy.learn_on_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = flash_attention.launches
    require(launches >= 1, "the transformer learner did not launch the flash kernel")
    require(all(math.isfinite(v) for v in stats.values()), f"non-finite learner stats {stats}")
    say("transformer_learner", env_steps_per_s=f"{TF_B / times[1]:.1f}",
        call_s=json.dumps([round(t, 4) for t in times]), flash_launches=launches,
        num_params=policy.model.num_params(), params_total=sum(p.numel() for p in policy.params),
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}", on_card=True)
    say("transformer_learner", stats=json.dumps({k: round(v, 6) for k, v in stats.items()}))
    # one forward at the minibatch (B·H = 2048 heads of 8 tokens): every
    # attention call is the query row per thread, and no copy is launched
    # for q, k or v. The wrapper's count gives the launches (4 forwards:
    # a warmup and 3 profiled); the profiler, which can miss some records
    # of a ctypes library's kernels, names them
    before = flash_attention.launches
    fwd = torso_forward_kernels(policy, torch.as_tensor(batch["obs"][:TF_B // 2], device="cuda"))
    layers = TORSO["transformer_num_layers"]
    per_forward = (flash_attention.launches - before) / 4
    require(per_forward == layers and set(fwd["flash"]) == {"flash_rows_kernel"},
            f"a torso forward launched {per_forward} flash kernels ({fwd['flash']} recorded), "
            f"not {layers} short-head kernels")
    say("transformer_learner", forward_device_activities=fwd["activities"],
        forward_copies=fwd["copies"], forward_flash=json.dumps(fwd["flash"]))
    return launches


def phase_transformer_lane():
    import torch

    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.gae import compute_gae_fragment

    algo = ppo_from_yaml(TUNED, model=dict(TORSO))
    k = algo._resolve_superstep_k()
    flash_attention.launches = 0
    compute_gae_fragment.launches = 0
    results, times = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        results.append(algo.train())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {"flash": flash_attention.launches, "gae": compute_gae_fragment.launches}
    require(launches["gae"] == 2 * k and launches["flash"] >= 1,
            f"the transformer lane missed a kernel: {launches} in 2 iterations of {k} slots")
    policy, eng = algo.get_policy(), algo._rollout_engine
    batch, bsize = eng.rollout()
    on_card = (
        all(p.is_cuda for p in policy.params)
        and all(v.is_cuda for v in eng.carry["env"].values())
        and all(v.is_cuda for v in batch.values())
    )
    require(on_card, "params, env state or batch left the card")
    for key in ("advantages", "value_targets", "vf_preds", "action_logp"):
        require(bool(torch.isfinite(batch[key]).all()), f"non-finite {key}")
    learner = results[-1]["info"]["learner"]["default_policy"]
    require(all(math.isfinite(v) for v in learner.values()), f"non-finite learner stats {learner}")
    say("transformer_lane", superstep_k=k, episode_reward_mean=results[-1]["episode_reward_mean"],
        env_steps_per_s=f"{k * bsize / times[1]:.1f}", iter_s=json.dumps([round(t, 4) for t in times]),
        launches=json.dumps(launches), on_card=on_card, batch_size=bsize)
    say("transformer_lane", learner=json.dumps({key: round(v, 6) for key, v in learner.items()}))
    del algo
    superstep_rates("transformer_lane", lambda **kw: ppo_from_yaml(TUNED, model=dict(TORSO), **kw),
                    bsize)
    return {"flash": flash_attention.launches, "gae": compute_gae_fragment.launches}


def phase_transformer_dqn():
    import torch

    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.framestack import gather_rows, scatter_rows
    from ray_tpu_torch.ops.segment_tree import find_prefixsum

    algo = dqn_config().training(model=dict(TORSO)).build()
    policy = algo.get_policy()
    kk = algo._resolve_superstep_k()
    kernels = (flash_attention, gather_rows, scatter_rows, find_prefixsum)
    for k in kernels:
        k.launches = 0
    fill, learn_iters = 16, 8 if kk == 1 else 2
    for _ in range(fill):  # up to learning starts (16 x 64 = 1024 steps)
        algo.train()
    torch.cuda.synchronize()
    trained0 = algo._counters["num_env_steps_trained"]
    t0 = time.perf_counter()
    results = [algo.train() for _ in range(learn_iters)]
    torch.cuda.synchronize()
    learn_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    for name, n in launches.items():
        require(n >= 1, f"the transformer DQN lane did not launch {name}")
    info = results[-1]["info"]
    updates = (info["num_env_steps_trained"] - trained0) // TRAIN_BATCH
    require(updates >= 1, f"no replay update in {learn_iters} iterations: {info}")
    learner = info["learner"]["default_policy"]
    require(all(math.isfinite(v) for v in learner.values()), f"non-finite learner stats {learner}")
    on_card = (all(p.is_cuda for p in policy.params)
               and all(t.is_cuda for t in policy.aux_state["target_params"]))
    require(on_card, "torso or target params left the card")
    say("transformer_dqn", superstep_k=kk, iters=fill + learn_iters, updates=updates,
        updates_per_s=f"{updates / learn_s:.2f}",
        env_steps_per_s=f"{learn_iters * INSERT_ROWS / learn_s:.1f}",
        launches=json.dumps(launches), on_card=on_card,
        num_env_steps_trained=info["num_env_steps_trained"])
    say("transformer_dqn", learner=json.dumps({k: round(v, 6) for k, v in learner.items()}))
    superstep_rates("transformer_dqn", lambda superstep: dqn_filled(superstep, model=TORSO), 1)
    return launches


CARTPOLE = os.path.join(REPO, "tuned_examples", "ppo", "cartpolejax-ppo.yaml")
# the bars the two yamls state (their ``stop`` blocks), and the wall-clock
# budget of the PongLite learning run (the whole script must end within
# its time limit)
CARTPOLE_BAR, CARTPOLE_STEPS = 150.0, 200000
PONG_BAR, PONG_STEPS, PONG_LEARN_S = 18.0, 2000000, 6.0  # 30 s before PR 17, 10 before PR 21


# how many budgets learn_curve runs at most while the learner has not reported
LEARN_CURVE_MAX_BUDGETS = 4


def learn_curve(phase, algo, bar, max_steps, budget_s=None, pids=("default_policy",)):
    """Train until ``episode_reward_mean`` >= ``bar`` (when ``bar`` is not
    None), ``max_steps`` env steps or ``budget_s`` seconds: the (steps,
    reward, seconds) curve and the seconds; the last learner stats of
    each of ``pids`` must be finite. A budget that ends before the
    learner has reported (learning starts after a fill, which a slower
    machine samples more slowly) runs on until it has, up to
    LEARN_CURVE_MAX_BUDGETS budgets; with a budget, the phase's line
    ``learn_budget_s``, ``learn_wall_s`` and ``budget_extended`` says
    which window the phase's rates cover."""
    import torch

    curve = []
    extended = False
    t0 = time.perf_counter()
    while True:
        r = algo.train()
        curve.append((r["timesteps_total"], round(float(r["episode_reward_mean"]), 3),
                      round(time.perf_counter() - t0, 2)))
        if (bar is not None and r["episode_reward_mean"] >= bar) or r["timesteps_total"] >= max_steps:
            break
        elapsed = time.perf_counter() - t0
        if budget_s is not None and elapsed >= budget_s:
            if all(r["info"]["learner"].get(pid) for pid in pids):
                break
            if elapsed >= budget_s * LEARN_CURVE_MAX_BUDGETS:
                break
            extended = True
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for pid in pids:
        learner = r["info"]["learner"].get(pid)
        require(learner and all(math.isfinite(v) for v in learner.values()),
                f"no or non-finite {phase} stats of {pid}: {learner}")
    if budget_s is not None:
        say(phase, learn_budget_s=budget_s, learn_wall_s=f"{wall:.2f}", budget_extended=extended)
    return curve, wall


def phase_cartpole():
    """tuned_examples/ppo/cartpolejax-ppo.yaml as written, on the graphed
    lane at K = auto, until its own bar."""
    from ray_tpu_torch.ops.gae import compute_gae_fragment

    compute_gae_fragment.launches = 0
    algo = ppo_from_yaml(CARTPOLE)
    k = algo._resolve_superstep_k()
    curve, wall = learn_curve("cartpole", algo, CARTPOLE_BAR, CARTPOLE_STEPS)
    steps, reward, _ = curve[-1]
    launches = compute_gae_fragment.launches
    say("cartpole", superstep_k=k, reached=reward >= CARTPOLE_BAR, episode_reward_mean=reward,
        env_steps=steps, wall_s=f"{wall:.2f}", env_steps_per_s=f"{steps / wall:.1f}",
        gae_launches=launches, curve=json.dumps(curve))
    require(reward >= CARTPOLE_BAR and steps <= CARTPOLE_STEPS,
            f"cartpolejax-ppo reached {reward} by {steps} steps, not {CARTPOLE_BAR} by "
            f"{CARTPOLE_STEPS}")
    require(launches == len(curve) * k, f"{launches} GAE launches in {len(curve)} x {k} slots")
    return launches


def phase_gridrooms():
    """Two PPO iterations of GridRoomsJax-v0 on the lane, with
    cartpolejax-ppo.yaml's settings (N = 32, T = 64, FCNet 256x256)."""
    from ray_tpu_torch.ops.gae import compute_gae_fragment

    compute_gae_fragment.launches = 0
    algo = ppo_from_yaml(CARTPOLE, env="GridRoomsJax-v0")
    k = algo._resolve_superstep_k()
    results = [algo.train() for _ in range(2)]
    launches = compute_gae_fragment.launches
    learner = results[-1]["info"]["learner"]["default_policy"]
    require(all(math.isfinite(v) for v in learner.values()), f"non-finite stats {learner}")
    require(launches == 2 * k, f"{launches} GAE launches in 2 x {k} slots")
    obs = algo._rollout_engine.carry["obs"]
    require(tuple(obs.shape) == (32, 2) and bool(((obs >= 0) & (obs <= 1)).all()),
            f"gridrooms obs {tuple(obs.shape)}")
    say("gridrooms", superstep_k=k, episode_reward_mean=results[-1]["episode_reward_mean"],
        episodes=sum(r["episodes_this_iter"] for r in results),
        num_env_steps_sampled=results[-1]["num_env_steps_sampled"], gae_launches=launches)
    return launches


def phase_ponglite_learn():
    """ponglitejax-ppo.yaml as written at K = auto for its 2M env steps,
    or ``PONG_LEARN_S`` seconds of wall clock if that comes first: reward
    against env steps, and where it first reached the yaml's bar (18 by
    2M steps)."""
    from ray_tpu_torch.ops.gae import compute_gae_fragment

    compute_gae_fragment.launches = 0
    algo = ppo_from_yaml(TUNED)
    k = algo._resolve_superstep_k()
    curve, wall = learn_curve("ponglite_learn", algo, None, PONG_STEPS, PONG_LEARN_S)
    steps, reward, _ = curve[-1]
    first = next((c for c in curve if c[1] >= PONG_BAR), None)
    launches = compute_gae_fragment.launches
    every = max(1, len(curve) // 40)
    say("ponglite_learn", superstep_k=k, budget_s=PONG_LEARN_S, wall_s=f"{wall:.2f}",
        env_steps=steps, fit_2m_steps=steps >= PONG_STEPS, env_steps_per_s=f"{steps / wall:.1f}",
        episode_reward_mean=reward, first_at_bar=json.dumps(first),
        gae_launches=launches, curve=json.dumps(curve[::every] + curve[-1:]))
    require(launches == len(curve) * k, f"{launches} GAE launches in {len(curve)} x {k} slots")
    return launches


# the actor lane: ponglite-ppo.yaml as written (2 rollout workers x 8
# envs on the host's CPUs, T = 128, the learner on the card), and its
# learning run's wall budget
ACTOR_TUNED = os.path.join(REPO, "tuned_examples", "ppo", "ponglite-ppo.yaml")
ACTOR_LEARN_S = 4.0
ACTOR_TIMED_CALLS = 2  # 3 before PR 23


def _actor_report(worker):
    """What a rollout worker says of itself (run in its process through
    ``WorkerSet.foreach_worker``): its policy's device, whether CUDA is
    initialized there, its torch threads and its sampler's timers."""
    import torch

    return {
        "worker_index": worker.worker_index,
        "policy_device": str(worker.policy().device),
        "cuda_initialized": torch.cuda.is_initialized(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "torch_threads": torch.get_num_threads(),
        "num_envs": worker.vector_env.num_envs,
        "timers": dict(worker.sampler.timers),
    }


def _act_ms_per_step(reports):
    """Each remote worker's mean ``compute_actions`` time per step of
    its vector env, in ms, from its sampler's timers."""
    return [round(1e3 * r["timers"]["act_s"] / max(1, r["timers"]["steps"] / r["num_envs"]), 3)
            for r in reports]


def _pooled_against_stacked(algo, batch):
    """Two fresh learners of ``algo``'s config learn the same pooled
    train batch, one as shipped and one rebuilt into stacks on the host
    (its dedup off): bitwise the same stats and parameters on the same
    permutations; each one's copy to the card (seconds, bytes)."""
    import numpy as np

    from ray_tpu_torch.ops.framestack import materialize_fragment
    from ray_tpu_torch.data.sample_batch import SampleBatch

    cls = type(algo.get_policy())
    space, act = algo.get_policy().observation_space, algo.get_policy().action_space
    pooled_p = cls(space, act, dict(algo.config), device=algo.device)
    stacked_p = cls(space, act, {**algo.config, "dedup_framestack": False}, device=algo.device)
    stacked = SampleBatch(materialize_fragment(dict(batch), int(space.shape[-1])))
    perms = pooled_p.draw_permutations(batch.count)
    s_pooled = pooled_p.learn_on_batch(batch, perms=perms)
    s_stacked = stacked_p.learn_on_batch(stacked, perms=perms)
    require(s_pooled == s_stacked, f"pooled and stacked learns differ: {s_pooled} {s_stacked}")
    for (name, a), b in zip(pooled_p.get_weights().items(), stacked_p.get_weights().values()):
        require(np.array_equal(a, b), f"pooled and stacked learns differ in {name}")
    t_p, t_s = pooled_p.last_learn_timers, stacked_p.last_learn_timers
    require(t_p["learn_frame_pool"] == 1.0 and t_s["learn_frame_pool"] == 0.0,
            "the comparison did not learn one pooled and one stacked batch")
    return {"pooled_transfer_s": round(t_p["learn_transfer_s"], 5),
            "pooled_bytes": int(t_p["learn_transfer_bytes"]),
            "stacked_transfer_s": round(t_s["learn_transfer_s"], 5),
            "stacked_bytes": int(t_s["learn_transfer_bytes"])}


def phase_actor_lane():
    """ponglite-ppo.yaml as written on the actor lane: 2 remote rollout
    workers (CPU policies, the card hidden) x 8 PongLite-v0 envs, T =
    128, frame-pool fragments, the learner on the card rebuilding the
    stacks with the row-gather kernel. One warm ``train()``, then 3
    timed and 2 for the busy share (``device_busy``), with the launch
    count set to 0 before them: env-steps/s, the split, pooled and
    stacked batch counts, the workers' act time per step; then one more
    round's batch learned pooled and stacked by two fresh learners,
    bitwise."""
    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.ppo.ppo import _standardize_advantages
    from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample
    from ray_tpu_torch.ops.framestack import gather_rows

    algo = ppo_from_yaml(ACTOR_TUNED)
    try:
        policy = algo.get_policy()
        require(policy.device.type == "cuda" and all(p.is_cuda for p in policy.params),
                "the actor lane's learner is not on the card")
        nw = algo.workers.num_remote_workers()
        t0 = time.perf_counter()
        algo.train()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        results = []

        def train():
            results.append(algo.train())

        gather_rows.launches = 0
        walls = []
        for _ in range(ACTOR_TIMED_CALLS):
            t0 = time.perf_counter()
            train()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        busy = device_busy(train, 1)  # one unprofiled call and one profiled
        launches = gather_rows.launches
        calls = len(results)
        pooled = sum(int(r["info"]["timers"]["default_policy"]["learn_frame_pool"]) for r in results)
        splits = []
        for r in results[:ACTOR_TIMED_CALLS]:
            lt = r["info"]["timers"]["default_policy"]
            t = r["timers"]
            splits.append({"sample_s": round(t["sample_s"], 4), "concat_s": round(t["concat_s"], 4),
                           "transfer_s": round(lt["learn_transfer_s"], 4),
                           "transfer_bytes": int(lt["learn_transfer_bytes"]),
                           "learn_s": round(t["learn_on_batch_s"] - lt["learn_transfer_s"], 4),
                           "sync_weights_s": round(t["sync_weights_s"], 4)})
        require(launches == pooled and launches >= 1,
                f"{launches} row-gather launches for {pooled} pooled learn calls of {calls}")
        last = results[-1]
        learner = last["info"]["learner"]["default_policy"]
        require(all(math.isfinite(v) for v in learner.values()), f"non-finite learner stats {learner}")
        reports = algo.workers.foreach_worker(_actor_report)
        for rep in reports[1:]:
            require(rep["policy_device"] == "cpu" and rep["cuda_initialized"] is False
                    and rep["cuda_visible_devices"] == "",
                    f"rollout worker {rep['worker_index']} touched the card: {rep}")
        bsize = int(algo.config["train_batch_size"])
        say("actor_lane", workers=nw, envs_per_worker=algo.config["num_envs_per_worker"],
            fragment=algo.config["rollout_fragment_length"], cpu_count=os.cpu_count(),
            env_steps_per_s=json.dumps(spread([bsize / w for w in walls])),
            iter_s=json.dumps([round(w, 4) for w in walls]), warm_s=f"{warm_s:.2f}",
            busy_share=busy["busy_share"], busy_wall_s=busy["wall_s"],
            pooled_batches=pooled, stacked_batches=calls - pooled, row_gather_launches=launches,
            episode_reward_mean=last["episode_reward_mean"],
            num_env_steps_sampled=last["num_env_steps_sampled"])
        say("actor_lane", split=json.dumps(splits))
        say("actor_lane", act_ms_per_step=json.dumps(_act_ms_per_step(reports[1:])),
            worker_threads=json.dumps([rep["torch_threads"] for rep in reports[1:]]),
            worker_timers=json.dumps([{k: round(v, 3) for k, v in rep["timers"].items()}
                                      for rep in reports[1:]]))
        say("actor_lane", learner=json.dumps({k: round(v, 6) for k, v in learner.items()}))
        batch = synchronous_parallel_sample(worker_set=algo.workers, max_env_steps=bsize)
        _standardize_advantages(batch)
        cmp = _pooled_against_stacked(algo, batch)
        say("actor_lane", pooled_equals_stacked=True, **cmp)
        require(np.isfinite(batch["advantages"]).all(), "non-finite advantages")
        return launches
    finally:
        algo.stop()


def phase_actor_lane_local():
    """ponglite-ppo.yaml at ``num_workers: 0`` for one iteration: the
    local worker samples with the learner's policy on the card (two
    sample calls of 8 envs x 128 steps), then learns."""
    import torch

    from ray_tpu_torch.ops.framestack import gather_rows

    algo = ppo_from_yaml(ACTOR_TUNED, num_workers=0)
    try:
        gather_rows.launches = 0
        t0 = time.perf_counter()
        r = algo.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gather_rows.launches
        lt = r["info"]["timers"]["default_policy"]
        require(algo.workers.num_remote_workers() == 0, "num_workers 0 started rollout workers")
        require(algo.get_policy().device.type == "cuda", "the local worker does not act on the card")
        require(launches == int(lt["learn_frame_pool"]) and launches == 1,
                f"{launches} row-gather launches in one pooled learn call")
        learner = r["info"]["learner"]["default_policy"]
        require(all(math.isfinite(v) for v in learner.values()), f"non-finite learner stats {learner}")
        rep = _actor_report(algo.workers.local_worker())
        say("actor_lane_local", env_steps=r["timesteps_total"], iter_s=f"{wall:.3f}",
            env_steps_per_s=f"{r['timesteps_total'] / wall:.1f}",
            act_ms_per_step=json.dumps(_act_ms_per_step([rep])), row_gather_launches=launches,
            split=json.dumps({k: round(v, 4) for k, v in r["timers"].items()}))
        return launches
    finally:
        algo.stop()


def phase_actor_learn():
    """ponglite-ppo.yaml as written on the actor lane for
    ``ACTOR_LEARN_S`` seconds of wall clock (its 2M steps do not fit):
    reward against env steps; no bar is required."""
    from ray_tpu_torch.ops.framestack import gather_rows

    algo = ppo_from_yaml(ACTOR_TUNED)
    try:
        gather_rows.launches = 0
        curve, wall = learn_curve("actor_learn", algo, None, PONG_STEPS, ACTOR_LEARN_S)
        launches = gather_rows.launches
        steps, reward, _ = curve[-1]
        every = max(1, len(curve) // 40)
        say("actor_learn", budget_s=ACTOR_LEARN_S, wall_s=f"{wall:.2f}", env_steps=steps,
            iterations=len(curve), env_steps_per_s=f"{steps / wall:.1f}", episode_reward_mean=reward,
            row_gather_launches=launches, curve=json.dumps(curve[::every] + curve[-1:]))
        require(1 <= launches <= len(curve), f"{launches} row-gather launches in {len(curve)} learns")
        return launches
    finally:
        algo.stop()


# the workers' start and the learner's first steps come before these
# windows, in actor_learner_window's warm calls
IMPALA_WINDOW_S = 7.0  # 10 before PR 23
APPO_WINDOW_S = 4.0  # 6 before PR 23
ACTOR_LEARNER_WARM_S = 90.0
PREFETCH_WINDOW_S = 4.0  # 6 before PR 23
PREFETCH_FUSED_S = 2.0  # 3 before PR 23


def impala_config(config_cls, **over):
    """bench_e2e.py:93-111's ``_impala_pong`` as written: PongLite-v0, 2
    rollout worker processes x 8 envs, fixed unrolls of T = 64, train
    batch 1024, lr 4e-4, entropy 0.01, vf 0.5, grad clip 40, seed 0, the
    default bf16 Nature CNN on 84x84x4."""
    cfg = config_cls().update_from_dict({
        "num_workers": 2, "num_envs_per_worker": 8, "rollout_fragment_length": 64,
        "train_batch_size": 1024, "lr": 4e-4, "entropy_coeff": 0.01, "vf_loss_coeff": 0.5,
        "grad_clip": 40.0, "seed": 0, **over,
    })
    cfg.env = "PongLite-v0"
    return cfg


def _learner_snapshot(algo):
    """The learner thread's counters and the row-gather count, read
    between two of its steps (under its step lock)."""
    from ray_tpu_torch.ops.framestack import gather_rows

    lt = algo._learner_thread
    with lt.lock:
        return {"steps": lt.num_steps, "gathers": gather_rows.launches,
                "sampled": algo._counters["num_env_steps_sampled"],
                "trained": algo._counters["num_env_steps_trained"],
                "t": time.perf_counter(), **lt.stats(), **dict(algo._timers)}


def span_overlap(spans, others):
    """The share of the summed length of ``spans`` that some span of
    ``others`` covers ((start, end) pairs; ``others`` do not overlap
    each other)."""
    total = sum(b - a for a, b in spans)
    covered = sum(max(0.0, min(b, d) - max(a, c)) for a, b in spans for c, d in others
                  if c < b and d > a)
    return covered / total if total else 0.0


def actor_learner_window(phase, algo, window_s):
    """``algo.train()`` for ``window_s`` seconds after warm calls until
    the learner has reported stats (its workers' start and first steps
    stay out of the window; at most ACTOR_LEARNER_WARM_S), the row-gather
    count set to 0 at the window's start (between two learner steps); a
    window in which the learner took no step runs on until it has, up to
    LEARN_CURVE_MAX_BUDGETS windows (``budget_extended``). Rates, the
    learner's and the main thread's splits, the feeder's copies, the
    row-gather launches against learner steps (one each: every learn
    rebuilt a pooled batch) and the last learner stats."""
    import torch

    from ray_tpu_torch.ops.framestack import gather_rows

    lt = algo._learner_thread
    require(algo.get_policy().device.type == "cuda", f"the {phase} learner is not on the card")
    t0 = time.perf_counter()
    algo.train()
    while not lt.learner_info and time.perf_counter() - t0 < ACTOR_LEARNER_WARM_S:
        algo.train()
    warm_s = time.perf_counter() - t0
    require(lt.learner_info, f"the {phase} learner reported no stats in {warm_s:.1f} s of warm calls")
    with lt.lock:
        gather_rows.launches = 0
    a = _learner_snapshot(algo)
    iters, extended = 0, False
    while True:
        elapsed = time.perf_counter() - a["t"]
        if iters and elapsed >= window_s:
            if lt.num_steps > a["steps"] or elapsed >= window_s * LEARN_CURVE_MAX_BUDGETS:
                break
            extended = True
        r = algo.train()
        iters += 1
    torch.cuda.synchronize()
    b = _learner_snapshot(algo)
    wall = b["t"] - a["t"]
    d = {k: b.get(k, 0) - a.get(k, 0)
         for k in ("steps", "sampled", "trained", "queue_wait_time_s", "grad_time_s",
                   "weight_publish_time_s", "harvest_s", "concat_s", "broadcast_s")}
    d["gathers"] = b["gathers"]
    require(d["steps"] > 0, f"the {phase} learner took no step in {wall:.1f} s")
    require(d["gathers"] == d["steps"],
            f"{d['gathers']} row-gather launches for {d['steps']} {phase} learner steps")
    require(lt.healthy(), f"the {phase} learner thread is not alive: {lt.error!r}")
    copies = list(lt.feeder.copies)[-d["steps"]:]
    # how much of the learner's host time per step the main thread's own host
    # work (outside the harvest's wait) ran beside it, in the one
    # interpreter: the shared-lock exposure of the learner
    steps = [sp for sp in lt.step_spans if sp[0] >= a["t"]]
    main = [sp for sp in algo.main_spans if sp[0] >= a["t"]]
    d["overlap"] = span_overlap(steps, main)
    d["main_busy_share"] = sum(e - s_ for s_, e in main) / wall
    learner = lt.learner_info
    require(learner and all(math.isfinite(v) for v in learner.values()),
            f"non-finite {phase} learner stats {learner}")
    say(phase, window_s=f"{wall:.2f}", window_budget_s=window_s, budget_extended=extended,
        warm_s=f"{warm_s:.2f}", iterations=iters,
        env_steps_per_s_sampled=f"{d['sampled'] / wall:.1f}",
        env_steps_per_s_trained=f"{d['trained'] / wall:.1f}",
        learner_steps=d["steps"], row_gather_launches=d["gathers"],
        queue_wait_time_s=f"{d['queue_wait_time_s']:.4f}", grad_time_s=f"{d['grad_time_s']:.4f}",
        grad_s_per_step=f"{d['grad_time_s'] / d['steps']:.5f}",
        learner_time_beside_main_work=f"{d['overlap']:.4f}",
        main_busy_share=f"{d['main_busy_share']:.4f}",
        weight_publish_time_s=f"{d['weight_publish_time_s']:.4f}",
        main_thread=json.dumps({k: round(d[k], 4) for k in ("harvest_s", "concat_s", "broadcast_s")}),
        episode_reward_mean=r["episode_reward_mean"], timesteps_total=r["timesteps_total"])
    say(phase, feeder_bytes=json.dumps(sorted({c["bytes"] for c in copies})),
        feeder_copy_s=json.dumps(spread([c["copy_s"] for c in copies])),
        feeder_h2d_ms=json.dumps(spread([c["h2d_ms"] for c in copies])))
    say(phase, learner=json.dumps({k: round(v, 6) for k, v in learner.items()}))
    return d


def _vtrace_times():
    """V-trace (``ops/vtrace.py``, plain PyTorch) at the IMPALA learn's
    shape, 16 unrolls x 64 steps: events and the summed device time of
    its kernels a call."""
    import torch

    from ray_tpu_torch.ops.vtrace import vtrace_from_logits

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, t = 16, 64
    x = [torch.randn(b, t, device="cuda", generator=gen) for _ in range(4)]
    disc = 0.99 * (torch.rand(b, t, device="cuda", generator=gen) > 0.05)
    boot = torch.randn(b, device="cuda", generator=gen)

    def call():
        return vtrace_from_logits(x[0], x[1], disc, x[2], x[3], boot)

    return {"shape": [b, t], "ms": round(cuda_ms(call), 6), "device_ms": round(device_ms(call), 6),
            "kernels_per_call": sum(device_kernels(call).values())}


def phase_impala():
    """IMPALA at ``impala_config``'s geometry for IMPALA_WINDOW_S seconds
    of wall clock after its warm iterations (``actor_learner_window``),
    the busy share of one more call, the workers' act time per step and
    V-trace's device time; then one more round's batch (real PongLite
    unrolls, frame pools) for the impala_parity phase."""
    from ray_tpu_torch.algorithms.impala.impala import IMPALAConfig
    from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample
    from ray_tpu_torch.ops.framestack import FRAMES

    algo = impala_config(IMPALAConfig).build()
    try:
        d = actor_learner_window("impala", algo, IMPALA_WINDOW_S)
        busy = device_busy(algo.train, 1)
        reports = algo.workers.foreach_worker(_actor_report)
        for rep in reports[1:]:
            require(rep["policy_device"] == "cpu" and rep["cuda_initialized"] is False,
                    f"rollout worker {rep['worker_index']} touched the card: {rep}")
        say("impala", busy_share=busy["busy_share"], busy_wall_s=busy["wall_s"],
            act_ms_per_step=json.dumps(_act_ms_per_step(reports[1:])),
            worker_timers=json.dumps([{k: round(v, 3) for k, v in rep["timers"].items()}
                                      for rep in reports[1:]]))
        say("impala", vtrace=json.dumps(_vtrace_times()))
        batch = synchronous_parallel_sample(worker_set=algo.workers, max_env_steps=1024)
        require(FRAMES in batch and batch.count == 1024, "the IMPALA round is not a pooled batch")
        return d["gathers"], batch, dict(algo.config)
    finally:
        algo.stop()


def _impala_pooled_against_stacked(batch, config, space, act_space):
    """The row-gather kernel at IMPALA's index layout: (B, T + 1)
    unrolls over the round's pool, each bootstrap stack at idx[-1] + 1.
    The card's rebuild of the pooled train tree (``_with_stacks``, one
    launch) bitwise equal to the host's (``materialize_stacks_np``); then
    two fresh learners learn the round, one as shipped and one rebuilt
    into stacks on the host (``materialize_fragment``, the dedup off), on
    the same permutations: bitwise the same stats and parameters."""
    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.impala.impala import ImpalaTorchPolicy
    from ray_tpu_torch.data.sample_batch import SampleBatch
    from ray_tpu_torch.ops.framestack import (
        FRAME_IDX, FRAMES, gather_rows, materialize_fragment, materialize_stacks_np)

    k = int(space.shape[-1])
    pooled_p = ImpalaTorchPolicy(space, act_space, dict(config))
    stacked_p = ImpalaTorchPolicy(space, act_space, {**config, "dedup_framestack": False})
    tree, bsize = pooled_p.prepare_batch(batch)
    idx, frames = tree[FRAME_IDX], tree[FRAMES]
    want = materialize_stacks_np(frames, idx.reshape(-1), k).reshape(idx.shape + tuple(space.shape))
    n0 = gather_rows.launches
    got = pooled_p._with_stacks({FRAMES: torch.as_tensor(frames).cuda(),
                                 FRAME_IDX: torch.as_tensor(idx).cuda()})
    torch.cuda.synchronize()
    require(gather_rows.launches == n0 + 1, "the IMPALA rebuild did not launch the row gather once")
    require(np.array_equal(got["obs"].cpu().numpy(), want[:, :-1])
            and np.array_equal(got["bootstrap_obs"].cpu().numpy(), want[:, -1]),
            f"the card's rebuild of the {idx.shape} unroll index differs from the host's")
    stacked = SampleBatch(materialize_fragment(dict(batch), k))
    perms = pooled_p.draw_permutations(bsize)
    s_pooled = pooled_p.learn_on_batch(batch, perms=perms)
    s_stacked = stacked_p.learn_on_batch(stacked, perms=perms)
    require(s_pooled == s_stacked, f"pooled and stacked IMPALA learns differ: {s_pooled} {s_stacked}")
    for (name, a), b in zip(pooled_p.get_weights().items(), stacked_p.get_weights().values()):
        require(np.array_equal(a, b), f"pooled and stacked IMPALA learns differ in {name}")
    t_p, t_s = pooled_p.last_learn_timers, stacked_p.last_learn_timers
    require(t_p["learn_frame_pool"] == 1.0 and t_s["learn_frame_pool"] == 0.0,
            "the comparison did not learn one pooled and one stacked batch")
    return {"frame_idx_shape": list(idx.shape), "pool_frames": int(frames.shape[0]),
            "pooled_bytes": int(t_p["learn_transfer_bytes"]),
            "stacked_bytes": int(t_s["learn_transfer_bytes"])}


def phase_impala_parity(batch, config):
    """One pooled IMPALA train batch learned twice through the learner
    thread (prepare on the thread, the feeder's pinned side-stream copy,
    deferred stats) and twice through the synchronous ``learn_on_batch``
    by two fresh policies of the same seed and so the same permutations:
    bitwise the same stats and parameters; the thread's grad time per
    step with no sampling beside it. Then the round's rebuild on the card
    against the host's, and its pooled learn against its stacked learn
    (``_impala_pooled_against_stacked``)."""
    import numpy as np

    from ray_tpu_torch.algorithms.impala.impala import ImpalaTorchPolicy
    from ray_tpu_torch.env.registry import get_env_creator
    from ray_tpu_torch.execution.learner_thread import LearnerThread
    from ray_tpu_torch.models.catalog import ModelCatalog

    env = get_env_creator("PongLite-v0")({})
    space = ModelCatalog.get_preprocessor_for_space(env.observation_space).observation_space
    threaded, sync = (ImpalaTorchPolicy(space, env.action_space, dict(config)) for _ in range(2))
    lt = LearnerThread(threaded, publish_weights_every=1)
    lt.start()
    for _ in range(2):
        require(lt.add_batch(batch), "the learner thread refused the batch")
    deadline = time.perf_counter() + 120
    while lt.num_steps < 2 and time.perf_counter() < deadline:
        time.sleep(0.01)
    lt.stop()
    require(lt.error is None and lt.num_steps == 2, f"the learner thread failed: {lt.error!r}")
    infos = [lt.outqueue.get_nowait()[1] for _ in range(2)]
    want = [sync.learn_on_batch(batch) for _ in range(2)]
    require(infos == want, f"thread and sync learns differ: {infos} {want}")
    for (name, a), b in zip(threaded.get_weights().items(), sync.get_weights().values()):
        require(np.array_equal(a, b), f"thread and sync learns differ in {name}")
    stats = lt.stats()
    say("impala_parity", bitwise=True, learns=2, deferred=lt._defer,
        grad_s_per_step_alone=f"{stats['grad_time_s'] / 2:.5f}",
        feeder_copy_s=json.dumps([round(c["copy_s"], 6) for c in lt.feeder.copies]),
        feeder_h2d_ms=json.dumps([round(c["h2d_ms"], 6) for c in lt.feeder.copies]),
        sync_transfer_s=round(sync.last_learn_timers["learn_transfer_s"], 6),
        bytes=int(sync.last_learn_timers["learn_transfer_bytes"]))
    cmp = _impala_pooled_against_stacked(batch, config, space, env.action_space)
    say("impala_parity", rebuild_equals_host=True, pooled_equals_stacked=True, **cmp)


def phase_appo():
    """APPO at ``impala_config``'s geometry for APPO_WINDOW_S seconds:
    rates, target refreshes (required), finite losses."""
    from ray_tpu_torch.algorithms.appo.appo import APPOConfig

    algo = impala_config(APPOConfig).build()
    try:
        d = actor_learner_window("appo", algo, APPO_WINDOW_S)
        refreshes = algo._counters["num_target_updates"]
        require(refreshes > 0, "APPO refreshed no target")
        say("appo", target_refreshes=refreshes,
            kl_coeff=algo.get_policy().coeff_values["kl_coeff"])
        return d["gathers"]
    finally:
        algo.stop()


def phase_ppo_prefetch():
    """ponglite-ppo.yaml as written with ``sample_prefetch: 1``: its
    first iteration's learner stats bitwise equal to a fresh synchronous
    run's; then PREFETCH_WINDOW_S seconds of calls with the row-gather
    count set to 0 before them: env-steps/s harvested by the pipeline and
    trained over the window (a call's own rate overstates the pipeline's
    while it learns batches sampled ahead), each call's seconds and
    split (the wait for the prefetched batch, the learn, sync_weights),
    the feeder's copies; one row-gather launch per learn."""
    import torch

    from ray_tpu_torch.ops.framestack import gather_rows

    sync = ppo_from_yaml(ACTOR_TUNED)
    try:
        r_sync = sync.train()
    finally:
        sync.stop()
    algo = ppo_from_yaml(ACTOR_TUNED, sample_prefetch=1)
    try:
        require(algo._use_sample_prefetch(), "sample_prefetch: 1 did not take the prefetch path")
        r = algo.train()
        first, want = (x["info"]["learner"]["default_policy"] for x in (r, r_sync))
        require(first == want, f"the prefetched first step differs from the sync path: {first} {want}")
        pipe = algo._sample_pipeline
        gather_rows.launches = 0
        harvested0, trained0 = pipe.num_env_steps, algo._counters["num_env_steps_trained"]
        t_start = time.perf_counter()
        walls, splits = [], []
        while time.perf_counter() - t_start < PREFETCH_WINDOW_S:
            t0 = time.perf_counter()
            r = algo.train()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            splits.append({k: round(v, 4) for k, v in r["timers"].items()})
        wall = time.perf_counter() - t_start
        launches = gather_rows.launches
        require(launches == len(walls), f"{launches} row-gather launches in {len(walls)} prefetched learns")
        learner = r["info"]["learner"]["default_policy"]
        require(all(math.isfinite(v) for v in learner.values()), f"non-finite stats {learner}")
        copies = list(algo._prefetch_feeder.copies)
        bsize = int(algo.config["train_batch_size"])
        say("ppo_prefetch", first_step_equals_sync=True, window_s=f"{wall:.2f}", calls=len(walls),
            env_steps_per_s_harvested=f"{(pipe.num_env_steps - harvested0) / wall:.1f}",
            env_steps_per_s_trained=f"{(algo._counters['num_env_steps_trained'] - trained0) / wall:.1f}",
            call_env_steps_per_s=json.dumps(spread([bsize / w for w in walls])),
            iter_s=json.dumps([round(w, 4) for w in walls]), row_gather_launches=launches)
        say("ppo_prefetch", split=json.dumps(splits[:3] + splits[-3:]),
            pipeline=json.dumps(r["info"]["learner"]["sample_pipeline"]),
            feeder_bytes=json.dumps(sorted({c["bytes"] for c in copies})),
            feeder_copy_s=json.dumps(spread([c["copy_s"] for c in copies])),
            feeder_h2d_ms=json.dumps(spread([c["h2d_ms"] for c in copies])))
        _prefetch_traced(algo)
    finally:
        algo.stop()
    _ppo_prefetch_fused()
    return launches


def _ppo_prefetch_fused():
    """ponglite-ppo.yaml with ``sample_prefetch: 2`` and ``superstep: 2``
    (stacked batches, ``dedup_framestack`` off: frame pools demote the
    run to one update a step): the first step's graphed superstep against
    two eager learns of a copy of the policy on the same two prefetched
    batches (the KL coefficient held for both, then adapted on each
    update's stats in order), bitwise; then PREFETCH_FUSED_S seconds of
    calls: env-steps/s trained, supersteps."""
    import torch

    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy

    algo = ppo_from_yaml(ACTOR_TUNED, sample_prefetch=2, superstep=2, dedup_framestack=False,
                        compress_obs_shipping=False)
    try:
        policy = algo.get_policy()
        state, perm = copy.deepcopy(policy.get_state()), policy.perm_generator.get_state()
        taken = []
        real_next = algo._next_prefetched

        def recorded():
            dev, meta = real_next()
            if len(taken) < 2:
                taken.append(({k: v.clone() for k, v in dev.items()}, meta))
            return dev, meta

        algo._next_prefetched = recorded
        r = algo.train()
        require(algo._counters["num_prefetch_supersteps"] == 1 and algo._superstep_k == 2,
                "ppo_prefetch: the first K = 2 step took no superstep")
        got = r["info"]["learner"]["default_policy"]
        after = [p.detach().clone() for p in policy.params]
        eager = PPOTorchPolicy(policy.observation_space, policy.action_space, policy.config)
        eager.set_state(state)
        eager.perm_generator.set_state(perm)
        kl = eager.coeff_values["kl_coeff"]
        outs = []
        for dev, (bsize, _, _) in taken:
            eager.coeff_values["kl_coeff"] = kl
            out = eager.learn_on_device_batch(dev, bsize)
            out.pop("cur_kl_coeff")
            outs.append(out)
        eager.coeff_values["kl_coeff"] = kl
        for out in outs:
            out.update(eager.after_learn_on_batch(out))
        require(got == outs[-1], f"ppo_prefetch: fused stats {got} != eager {outs[-1]}")
        require(all(torch.equal(a, b) for a, b in zip(after, eager.params)),
                "ppo_prefetch: fused and eager parameters differ")
        trained0, s0 = algo._counters["num_env_steps_trained"], algo._counters["num_prefetch_supersteps"]
        t0 = time.perf_counter()
        walls = []
        while time.perf_counter() - t0 < PREFETCH_FUSED_S:
            t1 = time.perf_counter()
            algo.train()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        trained = algo._counters["num_env_steps_trained"] - trained0
        say("ppo_prefetch", k=2, fused_equals_two_eager_learns=True, bitwise=True,
            window_s=f"{wall:.2f}", calls=len(walls),
            supersteps=algo._counters["num_prefetch_supersteps"] - s0,
            env_steps_per_s_trained=f"{trained / wall:.1f}",
            iter_s=json.dumps(spread(walls)), kl_coeff=policy.coeff_values["kl_coeff"])
    finally:
        algo.stop()


def _graph_equal(what, pairs):
    """Every (graphed, eager) tensor pair bitwise equal, or raise."""
    import torch

    bad = [name for name, a, b in pairs if not torch.equal(a, b)]
    require(not bad, f"graph_parity {what}: graphed != eager in {bad}")
    return len(pairs)


def _lane_pairs(p1, e1, p2, e2):
    st1, st2 = p1.opt_state, p2.opt_state
    pairs = [(f"param {n}", a, b) for n, a, b in zip(p1.param_names, p1.params, p2.params)]
    pairs += [("mu", a, b) for a, b in zip(st1.mu, st2.mu)] + [("nu", a, b) for a, b in zip(st1.nu, st2.nu)]
    if e1 is not None:
        pairs += [(f"carry {k}", e1.carry["env"][k], e2.carry["env"][k]) for k in e1.carry["env"]]
        pairs += [(f"carry {k}", e1.carry[k], e2.carry[k]) for k in ("obs", "ep_ret", "ep_len")]
        pairs.append(("env generator", e1.env_generator.get_state(), e2.env_generator.get_state()))
    pairs.append(("action generator", p1.action_generator.get_state(), p2.action_generator.get_state()))
    pairs.append(("perm generator", p1.perm_generator.get_state(), p2.perm_generator.get_state()))
    require(st1.count == st2.count, f"Adam counts {st1.count} != {st2.count}")
    return pairs


def _lane_parity(what, make, k, calls):
    """``calls`` supersteps of ``k`` graphed slots (the first slot of the
    first call eager, the rest replays) against as many eager rollout-
    then-learn rounds, with the coefficients held per superstep."""
    a, b = make(), make()
    p1, e1, p2, e2 = a.get_policy(), a._engine(), b.get_policy(), b._engine()
    for _ in range(calls):
        kl = p1.coeff_values["kl_coeff"]
        seq = []
        for _ in range(k):
            p1.coeff_values["kl_coeff"] = kl
            batch, bsize = e1.rollout()
            out = p1.learn_on_device_batch(e1.learn_batch(batch), bsize)
            out.pop("cur_kl_coeff")
            seq.append(out)
        p1.coeff_values["kl_coeff"] = kl
        for out in seq:
            out.update(p1.after_learn_on_batch(out))
        infos, carry, metrics, _ = p2.learn_rollout_superstep(k, e2.batch_size, e2.superstep_feed())
        e2.advance(carry, metrics)
        for info in infos:
            info.update(p2.after_learn_on_batch(info))
        require(infos == seq, f"graph_parity {what}: stats {infos} != {seq}")
        m1 = [(m.episode_length, m.episode_reward) for m in e1.get_metrics()]
        m2 = [(m.episode_length, m.episode_reward) for m in e2.get_metrics()]
        require(m1 == m2, f"graph_parity {what}: episode metrics differ")
    n = _graph_equal(what, _lane_pairs(p1, e1, p2, e2))
    (runner,) = p2._superstep_runners.values()
    return {"slots": k * calls, "replays": runner.replays, "tensors": n}


def _dqn_parity(k, calls):
    """``calls`` prioritized replay supersteps of ``k`` graphed slots at
    ``dqn_config()`` against the eager updates on the same pre-drawn
    sets, with the per-update refresh in update order."""
    import torch

    from ray_tpu_torch.execution.train_ops import superstep_train_replay

    a, b = dqn_filled(superstep=k), dqn_filled(superstep=k)
    pa, ba = a.get_policy(), a.local_replay_buffer.buffers["default_policy"]
    pb, bb = b.get_policy(), b.local_replay_buffer.buffers["default_policy"]
    for _ in range(calls):
        idx, weights = ba.draw_prioritized_sets_device(k, k, TRAIN_BATCH, 0.4)
        seq = []
        for i in range(k):
            tree = ba._gather_columns(idx[i])
            tree["weights"] = weights[i]
            seq.append(pa.learn_on_device_batch(tree, TRAIN_BATCH))
            with torch.no_grad():
                td = torch.abs(pa._td_error(tree, pa.aux_state)[0]).cpu().numpy()
            ba.update_priorities(idx[i], td + 1e-6)
        info = superstep_train_replay(b, pb, bb, k, k, TRAIN_BATCH, prioritized=True, beta=0.4)
        require(info == seq[-1], f"graph_parity dqn: stats {info} != {seq[-1]}")
    pairs = _lane_pairs(pa, None, pb, None)
    pairs += [("sum tree", ba._dtree.sum_value, bb._dtree.sum_value),
              ("min tree", ba._dtree.min_value, bb._dtree.min_value)]
    pairs += [("target", x, y) for x, y in zip(pa.aux_state["target_params"], pb.aux_state["target_params"])]
    n = _graph_equal("dqn", pairs)
    require(ba._max_priority == bb._max_priority, "graph_parity dqn: max priority differs")
    (runner,) = pb._superstep_runners.values()
    return {"slots": k * calls, "replays": runner.replays, "tensors": n}


def phase_graph_parity():
    """Graphed slots against eager slots on the card, bitwise: 2 PPO lane
    slots at ponglitejax-ppo.yaml (twice), 2 DQN prioritized replay
    slots at dqn_config() (twice), 1 torso lane slot (twice: the second
    call is a replay)."""
    import torch

    out = {}
    for name, fn in (
        ("ppo_lane", lambda: _lane_parity("ppo_lane", lambda: ppo_from_yaml(TUNED, superstep=2), 2, 2)),
        ("dqn", lambda: _dqn_parity(2, 2)),
        ("torso_lane", lambda: _lane_parity(
            "torso_lane", lambda: ppo_from_yaml(TUNED, superstep=1, model=dict(TORSO)), 1, 2)),
    ):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[name] = fn()
        out[name]["peak_mem_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
        say("graph_parity", case=name, bitwise=True, **{k: v for k, v in out[name].items()})
    return out


# SAC at HalfCheetah's published widths (bench_e2e.py's _sac_halfcheetah:
# obs 17, act 6 in [-1, 1], 256x256 towers, batch 256, replay capacity
# 400000), K = 8 updates a graphed window, seeded rows put on the card
# in chunks; pendulum-sac.yaml's wall budget; the Pendulum PPO yaml
SAC_OBS, SAC_ACT, SAC_BATCH, SAC_CAPACITY, SAC_K = 17, 6, 256, 400_000, 8
SAC_FILL_CHUNK, SAC_WINDOWS = 50_000, 3
SAC_COLUMNS = 5  # obs, new_obs, actions, rewards, dones
SAC_TUNED = os.path.join(REPO, "tuned_examples", "sac", "pendulum-sac.yaml")
SAC_BUDGET_S = 4.0  # 8 before PR 21, 5 before PR 23
PENDULUM_PPO = os.path.join(REPO, "tuned_examples", "ppo", "pendulum-ppo.yaml")
# the replay columns' row widths: Pendulum (obs 3, act 1) and HalfCheetah
SAC_WIDTHS = {"pendulum": (3, 1, 100_000), "halfcheetah": (SAC_OBS, SAC_ACT, SAC_CAPACITY)}


def sac_policy(seed=0):
    """``SACTorchPolicy`` at HalfCheetah's widths with SACConfig's own
    defaults (256x256 relu towers, lr 3e-4 x 3, tau 5e-3, auto entropy)."""
    import numpy as np

    from ray_tpu_torch.algorithms.sac.sac import SACConfig, SACTorchPolicy
    from ray_tpu_torch.env.spaces import Box

    cfg = SACConfig().debugging(seed=seed).to_dict()
    return SACTorchPolicy(Box(-np.inf, np.inf, (SAC_OBS,), np.float64),
                          Box(-1.0, 1.0, (SAC_ACT,), np.float32), cfg)


def sac_rows(gen, n, obs=SAC_OBS, act=SAC_ACT):
    """``n`` seeded replay rows in SAC's columns and the ring's types
    (float64 observations stored as float32), made on the card."""
    import torch

    return {
        "obs": torch.randn((n, obs), device="cuda", generator=gen),
        "new_obs": torch.randn((n, obs), device="cuda", generator=gen),
        "actions": torch.rand((n, act), device="cuda", generator=gen) * 2 - 1,
        "rewards": torch.randn((n,), device="cuda", generator=gen),
        "dones": torch.rand((n,), device="cuda", generator=gen) < 0.001,
    }


def sac_ring(prioritized, seed=0, capacity=SAC_CAPACITY):
    """A device ring of ``capacity`` seeded rows, put in chunks of
    ``SAC_FILL_CHUNK`` (one scatter per column a chunk; the prioritized
    ring also writes each chunk's priorities into its sum tree)."""
    import torch

    from ray_tpu_torch.execution.replay_buffer import (
        DevicePrioritizedReplayBuffer,
        DeviceReplayBuffer,
    )

    buf = (DevicePrioritizedReplayBuffer(capacity, 0.6, seed) if prioritized
           else DeviceReplayBuffer(capacity, seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for start in range(0, capacity, SAC_FILL_CHUNK):
        buf.add_device_tree(sac_rows(gen, min(SAC_FILL_CHUNK, capacity - start)))
    return buf


def _sac_state_pairs(pa, pb):
    pairs = [(f"param {n}", a, b) for n, a, b in zip(pa.param_names, pa.params, pb.params)]
    for g in pa.opt_states:
        sa, sb = pa.opt_states[g], pb.opt_states[g]
        require(sa.count == sb.count, f"{g} Adam counts {sa.count} != {sb.count}")
        pairs += [(f"{g} mu", a, b) for a, b in zip(sa.mu, sb.mu)]
        pairs += [(f"{g} nu", a, b) for a, b in zip(sa.nu, sb.nu)]
    pairs += [("target", a, b) for a, b in zip(pa.aux_state["target_critic"], pb.aux_state["target_critic"])]
    pairs.append(("action generator", pa.action_generator.get_state(), pb.action_generator.get_state()))
    return pairs


def _sac_parity(prioritized, windows=2):
    """``windows`` graphed windows of SAC_K slots against as many eager
    updates on the same pre-drawn rows and draws, at HalfCheetah's
    widths: every parameter, Adam moment, the target critic, the
    generator, the stats (and the sum tree) bitwise."""
    import torch

    from ray_tpu_torch.execution.train_ops import superstep_train_replay

    pa, pb = sac_policy(1), sac_policy(1)
    ba, bb = sac_ring(prioritized, 1), sac_ring(prioritized, 1)
    for _ in range(windows):
        if prioritized:
            idx, weights = ba.draw_prioritized_sets_device(SAC_K, SAC_K, SAC_BATCH, 0.4)
        else:
            idx = torch.as_tensor(ba.draw_index_sets(SAC_K, SAC_BATCH), device="cuda")
        seq = []
        for i in range(SAC_K):
            tree = ba._gather_columns(idx[i])
            if prioritized:
                tree["weights"] = weights[i]
            seq.append(pa.learn_on_device_batch(tree, SAC_BATCH))
            if prioritized:
                with torch.no_grad():
                    td = torch.abs(pa._td_error(tree, pa.aux_state)[0]).cpu().numpy()
                ba.update_priorities(idx[i], td + 1e-6)
        info = superstep_train_replay(None, pb, bb, SAC_K, SAC_K, SAC_BATCH,
                                      prioritized=prioritized, beta=0.4)
        require(info == seq[-1], f"sac graph parity: stats {info} != {seq[-1]}")
    pairs = _sac_state_pairs(pa, pb)
    if prioritized:
        pairs += [("sum tree", ba._dtree.sum_value, bb._dtree.sum_value),
                  ("min tree", ba._dtree.min_value, bb._dtree.min_value)]
        require(ba._max_priority == bb._max_priority, "sac graph parity: max priority differs")
    n = _graph_equal("sac", pairs)
    (runner,) = pb._superstep_runners.values()
    return {"slots": SAC_K * windows, "replays": runner.replays, "tensors": n}


def _sac_learner_run(prioritized):
    """The main path at HalfCheetah's widths, its launch counts set to 0
    just before: the ring filled, then SAC_WINDOWS + 1 graphed windows
    of SAC_K updates (the first captures). Returns the readings."""
    import numpy as np
    import torch

    from ray_tpu_torch.execution.train_ops import superstep_train_replay
    from ray_tpu_torch.ops.framestack import gather_rows, scatter_rows
    from ray_tpu_torch.ops.segment_tree import find_prefixsum

    kernels = (gather_rows, scatter_rows, find_prefixsum)
    for k in kernels:
        k.launches = 0
    policy = sac_policy(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf = sac_ring(prioritized, 0)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0

    def window():
        return superstep_train_replay(None, policy, buf, SAC_K, SAC_K, SAC_BATCH,
                                      prioritized=prioritized, beta=0.4)

    times, infos = [], []
    for _ in range(SAC_WINDOWS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infos.append(window())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k.__name__: k.launches for k in kernels}
    chunks = -(-SAC_CAPACITY // SAC_FILL_CHUNK)
    windows = SAC_WINDOWS + 1
    want = {
        "gather_rows": windows * SAC_K * SAC_COLUMNS,
        # a scatter per column a chunk; prioritized: the sum and min trees'
        # leaf writes at each chunk and at each window's refresh
        "scatter_rows": chunks * SAC_COLUMNS + (2 * chunks + 2 * windows if prioritized else 0),
        "find_prefixsum": windows * SAC_K if prioritized else 0,
    }
    require(launches == want, f"sac_learner launches {launches}, the schedule implies {want}")
    for info in infos:
        require(all(math.isfinite(v) for v in info.values()), f"non-finite SAC stats {info}")
    require(infos[-1]["alpha_value"] > 0, f"alpha {infos[-1]['alpha_value']}")
    (runner,) = policy._superstep_runners.values()
    require(runner.graph is not None, "no captured SAC slot")
    out = {"launches": launches, "fill_s": fill_s, "capture_window_s": times[0],
           "updates_per_s": spread([SAC_K / t for t in times[1:]]), "stats": infos[-1],
           "busy": device_busy(window, 2), "replays": runner.replays}
    if prioritized:
        leaves = buf._dtree.leaf_values(len(buf))
        require(np.isfinite(leaves).all() and (leaves > 0).all(), "non-finite refreshed priorities")
        out["max_priority"] = buf._max_priority
    out["peak_mem_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
    return out


def phase_sac_learner():
    """SAC's learner at HalfCheetah's widths (obs 17, act 6, 256x256
    towers, batch 256) on a 400000-row device ring: uniform, then
    prioritized replay; each run's launches against the schedule, rates,
    busy share and capture time; then graphed windows against eager
    updates, bitwise."""
    out = {}
    for prioritized in (False, True):
        name = "prioritized" if prioritized else "uniform"
        r = _sac_learner_run(prioritized)
        out[name] = r["launches"]
        say("sac_learner", replay=name, superstep_k=SAC_K, windows=SAC_WINDOWS,
            updates_per_s=json.dumps({k: round(v, 1) for k, v in r["updates_per_s"].items()}),
            capture_window_s=f"{r['capture_window_s']:.4f}", fill_s=f"{r['fill_s']:.4f}",
            busy=json.dumps(r["busy"]), launches=json.dumps(r["launches"]), replays=r["replays"],
            ring_rows=SAC_CAPACITY, peak_mem_gb=r["peak_mem_gb"],
            **({"max_priority": f"{r['max_priority']:.6f}"} if prioritized else {}))
        say("sac_learner", replay=name, stats=json.dumps({k: round(v, 6) for k, v in r["stats"].items()}))
    for prioritized in (False, True):
        p = _sac_parity(prioritized)
        say("sac_learner", parity="prioritized" if prioritized else "uniform", bitwise=True,
            **{k: v for k, v in p.items()})
    return out


def phase_sac_columns():
    """Every SAC replay column at Pendulum's and HalfCheetah's widths
    through the row gather (256 drawn rows) and the row scatter (one row,
    the per-step insert, and 1000 rows, wrapping, duplicates included)
    bitwise against ``index_select`` and ``index_copy_``; times and the
    bound of the HalfCheetah obs column's gather."""
    import torch

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops.framestack import gather_rows, scatter_rows, scatter_rows_plain

    gen = torch.Generator(device="cuda").manual_seed(3)
    checked = []
    for env, (obs, act, cap) in SAC_WIDTHS.items():
        ring = sac_rows(gen, cap, obs, act)
        idx = torch.randint(0, cap, (SAC_BATCH,), device="cuda", generator=gen)
        new = sac_rows(gen, 1000, obs, act)
        pos_one = torch.tensor([cap - 1], device="cuda")
        pos = (cap - 300 + torch.arange(1000, device="cuda")) % cap
        dup = pos.clone()
        dup[1::5] = dup[0]
        for col, r in ring.items():
            require(torch.equal(gather_rows(r, idx), r.index_select(0, idx)),
                    f"row gather differs on {env} {col} ({tuple(r.shape[1:])} {r.dtype})")
            for p, v in ((pos_one, new[col][:1]), (pos, new[col])):
                a, b = r.clone(), r.clone()
                scatter_rows(a, p, v)
                b.index_copy_(0, p, v)
                require(torch.equal(a, b), f"row scatter differs on {env} {col} x {len(p)}")
            # repeated positions: index_copy_ leaves their order undefined;
            # the plain version's last write wins
            a, b = r.clone(), r.clone()
            scatter_rows(a, dup, new[col])
            scatter_rows_plain(b, dup, new[col])
            require(torch.equal(a, b), f"row scatter differs on {env} {col}, duplicates")
            checked.append((env, col, tuple(r.shape[1:]), str(r.dtype).replace("torch.", ""),
                            r.element_size() * max(1, r[0].numel())))
    say("sac_columns", bitwise=True, checked=json.dumps(checked))
    obs_ring = ring["obs"]  # HalfCheetah's, the last one built
    out = torch.empty((SAC_BATCH, SAC_OBS), device="cuda")
    lib = _kernels.library("row_gather")
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        return lib.row_gather_launch(obs_ring.data_ptr(), idx.data_ptr(), out.data_ptr(), SAC_BATCH,
                                     obs_ring.shape[0], SAC_OBS * 4, stream)

    ms = cuda_ms(raw, iters=200)
    dev_ms = device_ms(raw, "word_kernel", iters=200)
    lib_dev_ms = device_ms(lambda: torch.index_select(obs_ring, 0, idx), iters=200)
    rows_read = int(torch.unique(idx).numel())
    nbytes = rows_read * SAC_OBS * 4 + SAC_BATCH * 8 + SAC_BATCH * SAC_OBS * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    say("sac_columns", column="halfcheetah obs", rows=SAC_BATCH, row_bytes=SAC_OBS * 4,
        ring_rows=SAC_CAPACITY, ms=f"{ms:.5f}", device_ms=f"{dev_ms:.5f}",
        index_select_device_ms=f"{lib_dev_ms:.5f}", floor_device_ms=f"{floor_device_ms():.5f}",
        bound_ms=f"{bound_ms:.7f}", bytes=nbytes,
        note="launch-bound: the bound is under a launch's floor")
    return len(checked)


def phase_sac():
    """pendulum-sac.yaml as written (num_workers 0: the local worker acts
    on the card) on the port's own Pendulum-v1 for SAC_BUDGET_S seconds:
    env steps, the reward's course, updates, the split, launches (one
    gather per column an update)."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops.framestack import gather_rows, scatter_rows
    from ray_tpu_torch.utils.tuned_example import build_tuned_example

    algo, stop = build_tuned_example(SAC_TUNED)
    try:
        require(algo.workers.num_remote_workers() == 0 and algo.get_policy().device.type == "cuda",
                "pendulum-sac does not act on the card")
        for k in (gather_rows, scatter_rows):
            k.launches = 0
        curve, wall = learn_curve("sac", algo, None, stop["timesteps_total"] * 10, SAC_BUDGET_S)
        launches = {k.__name__: k.launches for k in (gather_rows, scatter_rows)}
        counters = algo._counters
        steps, updates = counters["num_env_steps_sampled"], counters["num_env_steps_trained"] // 256
        learner = algo.get_policy()
        require(launches["gather_rows"] == SAC_COLUMNS * updates,
                f"{launches['gather_rows']} row gathers in {updates} updates of {SAC_COLUMNS} columns")
        require(launches["scatter_rows"] == SAC_COLUMNS * steps,
                f"{launches['scatter_rows']} row scatters in {steps} one-row inserts")
        alpha = float(torch.exp(learner.model.log_alpha.detach()))
        require(alpha > 0 and math.isfinite(alpha), f"alpha {alpha}")
        sampler = algo.workers.local_worker().sampler
        first = next((c for c in curve if c[1] >= stop["episode_reward_mean"]), None)
        every = max(1, len(curve) // 30)
        last10 = float(np.mean([m.episode_reward for m in algo._episode_history[-10:]]))
        split = {k: round(v, 3) for k, v in algo._timers.items()}
        split.update(act_s=round(sampler.timers["act_s"], 3), env_s=round(sampler.timers["env_s"], 3))
        say("sac", budget_s=SAC_BUDGET_S, wall_s=f"{wall:.2f}", env_steps=steps, updates=updates,
            env_steps_per_s=f"{steps / wall:.1f}", updates_per_s=f"{updates / wall:.1f}",
            episode_reward_mean=curve[-1][1], last_10_episodes_mean=f"{last10:.3f}",
            first_at_bar=json.dumps(first),
            bar=stop["episode_reward_mean"], alpha=f"{alpha:.5f}", launches=json.dumps(launches),
            split=json.dumps(split), curve=json.dumps(curve[::every] + curve[-1:]))
        return launches
    finally:
        algo.stop()


def phase_pendulum_ppo():
    """pendulum-ppo.yaml as written (8 envs x 256 on the local worker,
    which acts on the card; minibatch 256, 10 epochs, MeanStdFilter) for
    2 iterations: DiagGaussian under PPO on the actor lane."""
    import torch

    algo = ppo_from_yaml(PENDULUM_PPO)
    try:
        times, results = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            results.append(algo.train())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        learner = results[-1]["info"]["learner"]["default_policy"]
        require(all(math.isfinite(v) for v in learner.values()), f"non-finite stats {learner}")
        steps = results[-1]["timesteps_total"]
        require(steps == 2 * 2048, f"{steps} env steps in 2 iterations")
        say("pendulum_ppo", env_steps=steps, iter_s=json.dumps([round(t, 3) for t in times]),
            env_steps_per_s=f"{2048 / times[-1]:.1f}",
            episode_reward_mean=results[-1]["episode_reward_mean"],
            split=json.dumps({k: round(v, 4) for k, v in results[-1]["timers"].items()}),
            stats=json.dumps({k: round(v, 5) for k, v in learner.items()}))
    finally:
        algo.stop()


MA_TIMED_CALLS = 1  # 3 before PR 17, 2 before PR 23
MA_LEARN_S = 4.0


# the rest of off-policy on the actor lane: the tuned examples as
# written (num_workers 0: the local worker acts on the card), each for
# its wall budget; two-policy DQN over the port's multi-agent CartPole-v1
RAINBOW_TUNED = os.path.join(REPO, "tuned_examples", "dqn", "cartpole-rainbow.yaml")
DDPG_TUNED = os.path.join(REPO, "tuned_examples", "ddpg", "pendulum-ddpg.yaml")
TD3_TUNED = os.path.join(REPO, "tuned_examples", "td3", "pendulum-td3.yaml")
# td3 runs on past its budget until its first update, whatever the budget
OFFPOLICY_BUDGET_S = {"rainbow": 7.0, "ddpg": 6.0, "td3": 10.0, "ma_dqn": 6.0}
# graphed windows of OFFPOLICY_K slots against as many eager updates
OFFPOLICY_K, OFFPOLICY_WINDOWS = 4, 3
# train() calls of the busy-share reading after each run
OFFPOLICY_BUSY_CALLS = 16


def _policy_state_pairs(pa, pb):
    """(name, a, b) for every tensor an update writes: parameters, each
    Adam state's moments (counts equal, required; not its index into the
    correction table, which each learn call sets back), the aux state
    (targets, TD3's step) and the generators."""
    pairs = [(f"param {n}", a, b) for n, a, b in zip(pa.param_names, pa.params, pb.params)]
    for i, (sa, sb) in enumerate(zip(pa._adam_states(), pb._adam_states())):
        require(sa.count == sb.count, f"Adam state {i} counts {sa.count} != {sb.count}")
        pairs += [(f"adam {i} mu", a, b) for a, b in zip(sa.mu, sb.mu)]
        pairs += [(f"adam {i} nu", a, b) for a, b in zip(sa.nu, sb.nu)]
    for key, va in pa.aux_state.items():
        vb = pb.aux_state[key]
        if isinstance(va, (list, tuple)):
            pairs += [(f"aux {key}", a, b) for a, b in zip(va, vb)]
        else:
            pairs.append((f"aux {key}", va, vb))
    pairs.append(("action generator", pa.action_generator.get_state(), pb.action_generator.get_state()))
    pairs.append(("perm generator", pa.perm_generator.get_state(), pb.perm_generator.get_state()))
    return pairs


def _replay_parity(phase, policy, buf, prioritized, batch_size):
    """Graphed replay slots against eager updates on the same rows and
    draws: two copies of the phase's trained policy (weights, Adam,
    targets, generators) and of its ring (contents, tree), then
    OFFPOLICY_WINDOWS windows of OFFPOLICY_K slots as one captured graph
    against as many eager ``learn_on_device_batch`` calls (and, with
    prioritized replay, their |TD| refreshes): every tensor an update
    writes, the stats (and the sum tree) bitwise."""
    import torch

    from ray_tpu_torch.execution.replay_buffer import (
        DevicePrioritizedReplayBuffer,
        DeviceReplayBuffer,
    )
    from ray_tpu_torch.execution.train_ops import superstep_train_replay

    state, ring = policy.get_state(), buf.get_state()

    def copy():
        p = type(policy)(policy.observation_space, policy.action_space, policy.config)
        p.set_state(state)
        p.action_generator.set_state(policy.action_generator.get_state())
        p.perm_generator.set_state(policy.perm_generator.get_state())
        b = (DevicePrioritizedReplayBuffer(buf.capacity, 0.6, 7) if prioritized
             else DeviceReplayBuffer(buf.capacity, 7))
        b.set_state(ring)
        return p, b

    (pa, ba), (pb, bb) = copy(), copy()
    k = OFFPOLICY_K
    for _ in range(OFFPOLICY_WINDOWS):
        if prioritized:
            idx, weights = ba.draw_prioritized_sets_device(k, k, batch_size, 0.4)
        else:
            idx = torch.as_tensor(ba.draw_index_sets(k, batch_size), device="cuda")
        seq = []
        for i in range(k):
            tree = ba._gather_columns(idx[i])
            if prioritized:
                tree["weights"] = weights[i]
            seq.append(pa.learn_on_device_batch(tree, batch_size))
            if prioritized:
                with torch.no_grad():
                    td = torch.abs(pa._td_error(tree, pa.aux_state)[0]).cpu().numpy()
                ba.update_priorities(idx[i], td + 1e-6)
        info = superstep_train_replay(None, pb, bb, k, k, batch_size, prioritized=prioritized,
                                      beta=0.4)
        require(info == seq[-1], f"{phase} graph parity: stats {info} != {seq[-1]}")
    pairs = _policy_state_pairs(pa, pb)
    if prioritized:
        pairs += [("sum tree", ba._dtree.sum_value, bb._dtree.sum_value),
                  ("min tree", ba._dtree.min_value, bb._dtree.min_value)]
        require(ba._max_priority == bb._max_priority, f"{phase} graph parity: max priority differs")
    n = _graph_equal(phase, pairs)
    (runner,) = pb._superstep_runners.values()
    return {"slots": k * OFFPOLICY_WINDOWS, "replays": runner.replays, "tensors": n,
            "prioritized": prioritized}


def _ring_kernels(phase, pid, buf, batch_size, insert_rows, prioritized):
    """The three kernels against their plain versions on the phase's
    trained ring, at its column layout: the row gather of every column at
    a batch's draw (``index_select``), the row scatter at the next
    insert's positions (``index_copy_``; with prioritized replay the
    trees' leaf write too), and the prefix descent on the ring's own sum
    tree with a batch's stratified masses (``find_prefixsum_plain``).
    All bitwise; draws from a generator of their own, so the ring's
    stream is left as it was. The ring must not have spilled: a main
    path's rings live on the card."""
    import numpy as np
    import torch

    from ray_tpu_torch.ops.framestack import gather_rows, scatter_rows
    from ray_tpu_torch.ops.segment_tree import draw_scalars, find_prefixsum, find_prefixsum_plain

    require(not buf.spilled, f"{phase} {pid}: the ring spilled to the host ({buf.stats()})")
    rng, dev = np.random.default_rng(11), buf.device
    size, cap = len(buf), buf.capacity
    if prioritized:
        tree = buf._dtree
        total, _ = draw_scalars(tree.sum_value, tree.min_value, size, 0.4, tree.capacity)
        rand = torch.as_tensor(rng.random(batch_size), device=dev)
        strata = torch.arange(batch_size, dtype=torch.float64, device=dev)
        mass = (rand + strata) / batch_size * total
        leaves = find_prefixsum(tree.sum_value, mass, tree.capacity)
        require(torch.equal(leaves, find_prefixsum_plain(tree.sum_value, mass, tree.capacity)),
                f"{phase} {pid}: prefix descent differs on {batch_size} masses, tree {tree.capacity}")
        idx = leaves.clamp(0, size - 1)
    else:
        idx = torch.as_tensor(rng.integers(0, size, batch_size), device=dev)
    pos = torch.as_tensor((buf._idx + np.arange(insert_rows)) % cap, device=dev)
    src = torch.as_tensor(rng.integers(0, size, insert_rows), device=dev)
    checked = []
    for col, ring in buf._store.items():
        require(torch.equal(gather_rows(ring, idx), ring.index_select(0, idx)),
                f"{phase} {pid}: row gather differs on {col} ({tuple(ring.shape[1:])} {ring.dtype})")
        rows = ring.index_select(0, src)
        a, b = ring.clone(), ring.clone()
        scatter_rows(a, pos, rows)
        b.index_copy_(0, pos, rows)
        require(torch.equal(a, b), f"{phase} {pid}: row scatter differs on {col} x {insert_rows}")
        checked.append((col, tuple(ring.shape[1:]), str(ring.dtype).replace("torch.", "")))
    if prioritized:
        vals = torch.as_tensor(rng.random((insert_rows, 1)), device=dev)
        for t in (tree.sum_value, tree.min_value):
            a, b = t.clone().view(-1, 1), t.clone().view(-1, 1)
            scatter_rows(a, pos + tree.capacity, vals)
            b.index_copy_(0, pos + tree.capacity, vals)
            require(torch.equal(a, b), f"{phase} {pid}: tree leaf write differs x {insert_rows}")
    say(phase, policy=pid, kernels_against_plain="equal", bitwise=True, gather_rows=batch_size,
        scatter_rows=insert_rows, descent_masses=batch_size if prioritized else 0,
        ring_rows=size, columns=json.dumps(checked))


def _offpolicy_run(phase, algo, pids=("default_policy",)):
    """The main path: the launch counts set to 0 just before, then
    ``algo.train()`` for OFFPOLICY_BUDGET_S[phase] seconds; rates, the
    round's split, the launches against the replay's schedule (a gather
    per column an update, a descent an update under prioritized replay,
    a scatter per column an insert at least: a prioritized ring also
    writes its trees with it) and the learning course; after the counts
    are read, each ring's kernels against their plain versions
    (``_ring_kernels``). Returns the launches."""
    import numpy as np

    from ray_tpu_torch.ops.framestack import gather_rows, scatter_rows
    from ray_tpu_torch.ops.segment_tree import find_prefixsum

    cfg = algo.config
    prioritized = bool((cfg.get("replay_buffer_config") or {}).get("prioritized_replay"))
    for p in pids:
        require(algo.get_policy(p).device.type == "cuda", f"{phase}: {p} is not on the card")
    require(algo.workers.num_remote_workers() == 0, f"{phase}: the local worker must act")
    # count the inserts: one a policy batch (the rings come at the first)
    rb = algo.local_replay_buffer
    inserts, insert_rows = [0], {}
    add = rb.add

    def counted_add(batch, policy_id="default_policy"):
        if not hasattr(batch, "policy_batches"):
            inserts[0] += 1
            insert_rows[policy_id] = batch.count
        return add(batch, policy_id)

    rb.add = counted_add
    kernels = (gather_rows, scatter_rows, find_prefixsum)
    for k in kernels:
        k.launches = 0
    budget = OFFPOLICY_BUDGET_S[phase]
    curve, wall = learn_curve(phase, algo, None, 10 ** 9, budget, pids)
    launches = {k.__name__: k.launches for k in kernels}
    counters = algo._counters
    steps = counters["num_env_steps_sampled"]
    updates = counters["num_env_steps_trained"] // int(cfg["train_batch_size"])
    bufs = algo.local_replay_buffer.buffers
    columns = {len(b._store) for b in bufs.values()}
    require(len(columns) == 1 and set(bufs) == set(pids), f"{phase}: rings {sorted(bufs)}")
    (cols,) = columns
    require(updates >= 1, f"{phase}: no replay update in {budget} s")
    require(launches["gather_rows"] == cols * updates,
            f"{phase}: {launches['gather_rows']} row gathers in {updates} updates of {cols} columns")
    require(launches["find_prefixsum"] == (updates if prioritized else 0),
            f"{phase}: {launches['find_prefixsum']} descents in {updates} updates")
    scatters = launches["scatter_rows"]
    require(scatters > cols * inserts[0] if prioritized else scatters == cols * inserts[0],
            f"{phase}: {scatters} row scatters in {inserts[0]} inserts of {cols} columns")
    for p in pids:
        runners = list(algo.get_policy(p)._superstep_runners.values())
        require(len(runners) == 1 and runners[0].graph is not None,
                f"{phase}: {p} ran no captured replay slot")
    sampler = algo.workers.local_worker().sampler
    split = {k: round(v, 3) for k, v in algo._timers.items()}
    split.update(act_s=round(sampler.timers["act_s"], 3), env_s=round(sampler.timers["env_s"], 3))
    per = {"act_ms_a_step": 1e3 * sampler.timers["act_s"] / max(1, sampler.timers["steps"]),
           "insert_ms_a_round": 1e3 * algo._timers["insert_s"] / len(curve),
           "update_ms_an_update": 1e3 * algo._timers["update_s"] / updates}
    # after the counts are read: the main path's busy share (its launches
    # are not counted)
    busy = device_busy(algo.train, OFFPOLICY_BUSY_CALLS)
    every = max(1, len(curve) // 30)
    rewards = [m.episode_reward for m in algo._episode_history[-10:]]
    say(phase, budget_s=budget, wall_s=f"{wall:.2f}", env_steps=steps, updates=updates,
        env_steps_per_s=f"{steps / wall:.1f}", updates_per_s=f"{updates / wall:.1f}",
        episode_reward_mean=curve[-1][1],
        last_10_episodes_mean=f"{float(np.mean(rewards)):.3f}" if rewards else None,
        launches=json.dumps(launches), inserts=inserts[0], replay_columns=cols,
        replay_rows=json.dumps({p: len(b) for p, b in bufs.items()}),
        split=json.dumps(split), per=json.dumps({k: round(v, 4) for k, v in per.items()}),
        busy=json.dumps(busy), curve=json.dumps(curve[::every] + curve[-1:]))
    for p, buf in bufs.items():
        _ring_kernels(phase, p, buf, int(cfg["train_batch_size"]), insert_rows[p], prioritized)
    return launches


def phase_rainbow():
    """cartpole-rainbow.yaml as written (C51 over 51 atoms in [0, 500],
    noisy dueling heads, double Q, n-step 3, prioritized replay of 50000
    rows; the local worker acts on the card): the main path for its
    budget, then graphed slots against eager updates on its ring."""
    from ray_tpu_torch.utils.tuned_example import build_tuned_example

    algo, _ = build_tuned_example(RAINBOW_TUNED)
    try:
        policy = algo.get_policy()
        require(policy.model.noisy and policy.model.num_atoms == 51, "not the Rainbow model")
        launches = _offpolicy_run("rainbow", algo)
        buf = algo.local_replay_buffer.buffers["default_policy"]
        require("n_steps" in buf._store, "the n-step column is not in the ring")
        p = _replay_parity("rainbow", policy, buf, True, int(algo.config["train_batch_size"]))
        say("rainbow", parity="graphed = eager", bitwise=True, **p)
        return launches
    finally:
        algo.stop()


def _ddpg_phase(phase, path, explore):
    from ray_tpu_torch.utils.tuned_example import build_tuned_example

    algo, _ = build_tuned_example(path)
    try:
        policy = algo.get_policy()
        require(type(policy.exploration).__name__ == explore, f"{phase} explores by {explore}")
        launches = _offpolicy_run(phase, algo)
        require(policy.opt_states["actor"].count == -(-policy.num_updates // policy.policy_delay),
                f"{phase}: {policy.opt_states['actor'].count} actor steps in {policy.num_updates}")
        if explore == "OrnsteinUhlenbeckNoise":
            require(policy._expl_state[0].is_cuda, "the OU state is not on the card")
        p = _replay_parity(phase, policy, algo.local_replay_buffer.buffers["default_policy"], False,
                           int(algo.config["train_batch_size"]))
        say(phase, parity="graphed = eager", bitwise=True, policy_delay=policy.policy_delay,
            actor_steps=policy.opt_states["actor"].count, updates=policy.num_updates, **p)
        return launches
    finally:
        algo.stop()


def phase_ddpg():
    """pendulum-ddpg.yaml as written (64x64 nets, OU noise, batch 64, one
    update an env step) on the port's Pendulum-v1."""
    return _ddpg_phase("ddpg", DDPG_TUNED, "OrnsteinUhlenbeckNoise")


def phase_td3():
    """pendulum-td3.yaml as written (twin critics, target smoothing, the
    actor every 2nd update, Gaussian noise, batch 100, learning from
    5000 steps) on the port's Pendulum-v1."""
    return _ddpg_phase("td3", TD3_TUNED, "GaussianNoise")


def phase_ma_dqn():
    """Two DQN policies (p0, p1: DQNConfig's defaults, fcnet 256x256)
    over the port's multi-agent CartPole-v1 (2 agents, agent i to
    p{i % 2}), one device ring each; learning from 1000 steps, the
    targets every 500 trained steps."""
    import numpy as np

    from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig
    from ray_tpu_torch.env.multi_agent_env import make_multi_agent
    from ray_tpu_torch.env.registry import register_env
    from ray_tpu_torch.env.spaces import Box, Discrete

    register_env("ma_cartpole_dqn", lambda cfg: make_multi_agent("CartPole-v1")({"num_agents": 2}))
    space, act = Box(-np.inf, np.inf, (4,), np.float64), Discrete(2)
    pids = ("p0", "p1")
    algo = (DQNConfig().environment("ma_cartpole_dqn")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=8)
            .multi_agent(policies={p: (None, space, act, {}) for p in pids},
                         policy_mapping_fn=lambda aid, *a, **kw: f"p{aid % 2}")
            .debugging(seed=0).build())
    try:
        launches = _offpolicy_run("ma_dqn", algo, pids)
        require(algo._counters["num_target_updates"] >= 1, "ma_dqn: no target sync")
        p = _replay_parity("ma_dqn", algo.get_policy("p1"),
                           algo.local_replay_buffer.buffers["p1"], False,
                           int(algo.config["train_batch_size"]))
        say("ma_dqn", parity="graphed = eager (p1)", bitwise=True,
            num_target_updates=algo._counters["num_target_updates"], **p)
        return launches
    finally:
        algo.stop()


# the asynchronous actor-learner loop: Ape-X over device shards, SAC with
# a sampling thread on its remote worker, IMPALA's fused learner
# superstep and its aggregation actor
APEX_TUNED = os.path.join(REPO, "tuned_examples", "apex_dqn", "cartpole-apex.yaml")
ASYNC_BUDGET_S = {"apex": 10.0, "sac_async": 6.0, "impala_fused": 10.0, "impala_agg": 6.0}
# train() calls of apex's busy-share reading (profiled, 16 graphed
# updates each)
APEX_BUSY_CALLS = 4
# the stale-round check's rounds before sac_async's timed window
STALE_ROUNDS = 4
# seconds impala_fused's main thread holds the learner's lock while
# batches queue
BACKLOG_S = 4.0
# the longest wait for the first batch through the aggregation actor
AGG_WARM_TIMEOUT_S = 60.0


def phase_apex():
    """cartpole-apex.yaml as written (3 CPU workers on the epsilon ladder,
    n-step 3, two prioritized device shards of 25,000 rows, batch 64,
    the target every 500 trained steps; superstep "auto": 8 graphed
    updates a shard and learn pass): the launch counts set to 0 just
    before the main path, then train() until learning starts and
    ASYNC_BUDGET_S["apex"] seconds after it; rates, target updates, the
    workers' epsilons against the ladder, the launches against the
    schedule (a descent and a gather per column an update, a scatter per
    column an insert and the trees' writes), the busy share; then each
    shard's kernels against their plain versions (``_ring_kernels``)."""
    import numpy as np

    from ray_tpu_torch.utils.tuned_example import build_tuned_example

    algo, _ = build_tuned_example(APEX_TUNED)
    try:
        cfg = algo.config
        policy = algo.get_policy()
        n = algo.workers.num_remote_workers()
        require(policy.device.type == "cuda" and n == 3, f"apex: {n} workers, {policy.device}")
        eps = algo.workers.foreach_worker(
            lambda w: w.policy().exploration.config.get("final_epsilon"))[1:]
        ladder = [0.4 ** (1 + 7 * (i - 1) / (n - 1)) for i in range(1, n + 1)]
        require(eps == ladder, f"apex: worker epsilons {eps} are not the ladder {ladder}")
        bs = int(cfg["train_batch_size"])
        shards = algo.replay_shards
        inserts = [0]
        route = algo._route_to_replay

        def counted_route(batch):
            inserts[0] += 1
            return route(batch)

        algo._route_to_replay = counted_route
        zero_kernel_counts()
        t0 = time.perf_counter()
        while algo._counters["num_env_steps_sampled"] < cfg["num_steps_sampled_before_learning_starts"]:
            algo.train()
        fill_s = time.perf_counter() - t0
        sampled0 = algo._counters["num_env_steps_sampled"]
        curve, wall = learn_curve("apex", algo, None, 10 ** 9, ASYNC_BUDGET_S["apex"])
        launches = read_kernel_counts()
        counters = algo._counters
        sampled = counters["num_env_steps_sampled"] - sampled0
        updates = counters["num_env_steps_trained"] // bs
        cols = {len(s._store) for s in shards}
        require(len(cols) == 1, f"apex: shards hold other columns {cols}")
        (cols,) = cols
        require(updates >= 1, "apex: no update")
        require(launches["find_prefixsum"] == updates,
                f"apex: {launches['find_prefixsum']} descents in {updates} updates")
        require(launches["gather_rows"] == cols * updates,
                f"apex: {launches['gather_rows']} row gathers in {updates} updates of {cols} columns")
        require(launches["scatter_rows"] > cols * inserts[0],
                f"apex: {launches['scatter_rows']} row scatters in {inserts[0]} inserts")
        runners = list(policy._superstep_runners.values())  # one a shard's feed
        require(len(runners) == len(shards) and all(r.graph is not None for r in runners),
                f"apex: {len(runners)} replay slots for {len(shards)} shards, not all captured")
        require(counters["num_target_updates"] >= 1, "apex: no target update")
        split = {k: round(v, 3) for k, v in algo._timers.items()}
        busy = device_busy(algo.train, APEX_BUSY_CALLS)
        rewards = [m.episode_reward for m in algo._episode_history[-10:]]
        say("apex", budget_s=ASYNC_BUDGET_S["apex"], fill_s=f"{fill_s:.2f}", wall_s=f"{wall:.2f}",
            env_steps_per_s_sampled=f"{sampled / wall:.1f}", updates=updates,
            updates_per_s=f"{updates / wall:.1f}", target_updates=counters["num_target_updates"],
            worker_epsilons=json.dumps(eps), inserts=inserts[0], replay_columns=cols,
            shard_rows=json.dumps([len(s) for s in shards]),
            shard_capacity=json.dumps([s.capacity for s in shards]),
            tree_leaves=json.dumps([s._dtree.capacity for s in shards]),
            launches=json.dumps(launches), split=json.dumps(split), busy=json.dumps(busy),
            episode_reward_mean=curve[-1][1],
            last_10_episodes_mean=f"{float(np.mean(rewards)):.3f}" if rewards else None)
        for i, shard in enumerate(shards):
            _ring_kernels("apex", f"shard_{i}", shard, bs, int(cfg["rollout_fragment_length"]), True)
        return launches
    finally:
        algo.stop()


def sac_async_config():
    """bench_e2e.py:114-142's ``_sac_halfcheetah`` geometry on the
    port's Pendulum-v1 (the card's machine has no MuJoCo): one remote
    worker with a sampling thread (``sample_async``), fragment 32, batch
    256, ``training_intensity`` 256 (one update an env step, K = 8
    graphed windows), tau 0.005, lr 3e-4, a 400,000-row ring, the 256x256
    nets; learning from 1,000 steps (cut from 10,000)."""
    from ray_tpu_torch.algorithms.sac.sac import SACConfig

    return (SACConfig().environment("Pendulum-v1")
            .rollouts(num_rollout_workers=1, rollout_fragment_length=32)
            .training(train_batch_size=256, gamma=0.99, tau=0.005, training_intensity=256,
                      num_steps_sampled_before_learning_starts=1000, sample_async=True,
                      optimization={"actor_learning_rate": 3e-4, "critic_learning_rate": 3e-4,
                                    "entropy_learning_rate": 3e-4},
                      replay_buffer_config={"capacity": 400000})
            .debugging(seed=0))


def phase_sac_async():
    """``sac_async_config`` for ASYNC_BUDGET_S["sac_async"] seconds, the
    launch counts set to 0 just before: STALE_ROUNDS rounds first, each
    holding that round r inserts the fragment requested in round r - 1;
    rates and the split, the launches against the schedule (a gather per
    column an update, a scatter per column an insert), then graphed
    slots against eager updates on its ring (``_replay_parity``) and the
    ring's kernels against their plain versions."""
    import numpy as np

    from ray_tpu_torch import core

    algo = sac_async_config().build()
    try:
        policy = algo.get_policy()
        require(policy.device.type == "cuda" and algo.workers.num_remote_workers() == 1,
                "sac_async: the learner is not on the card beside one worker")
        worker = algo.workers.remote_workers()[0]
        sampler = core.get(worker.apply.remote(lambda w: type(w.sampler).__name__))
        require(sampler == "AsyncSampler", f"sac_async: the worker samples with {sampler}")
        rb = algo.local_replay_buffer
        inserted = []
        add = rb.add

        def counted_add(batch, policy_id="default_policy"):
            inserted.append(np.asarray(batch["obs"]).copy())
            return add(batch, policy_id)

        rb.add = counted_add
        zero_kernel_counts()
        t0 = time.perf_counter()
        requested = []
        for _ in range(STALE_ROUNDS):
            algo.train()
            (ref,) = algo._pending_sample_refs
            requested.append(np.asarray(core.get(ref)["obs"]).copy())
        for r, (want, got) in enumerate(zip(requested[:-1], inserted[1:STALE_ROUNDS])):
            require(np.array_equal(want, got),
                    f"sac_async: round {r + 2} did not insert the fragment requested in round {r + 1}")
        curve, wall = learn_curve("sac_async", algo, None, 10 ** 9, ASYNC_BUDGET_S["sac_async"])
        wall = time.perf_counter() - t0
        launches = read_kernel_counts()
        counters = algo._counters
        steps, updates = counters["num_env_steps_sampled"], counters["num_env_steps_trained"] // 256
        cols = len(rb.buffers["default_policy"]._store)
        require(updates >= 1, "sac_async: no update")
        require(launches["gather_rows"] == cols * updates,
                f"sac_async: {launches['gather_rows']} row gathers in {updates} updates")
        require(launches["scatter_rows"] == cols * len(inserted),
                f"sac_async: {launches['scatter_rows']} row scatters in {len(inserted)} inserts")
        split = {k: round(v, 3) for k, v in algo._timers.items()}
        say("sac_async", budget_s=ASYNC_BUDGET_S["sac_async"], wall_s=f"{wall:.2f}",
            stale_rounds_checked=STALE_ROUNDS - 1, env_steps=steps, updates=updates,
            env_steps_per_s=f"{steps / wall:.1f}", updates_per_s=f"{updates / wall:.1f}",
            launches=json.dumps(launches), split=json.dumps(split),
            update_ms_an_update=f"{1e3 * algo._timers['update_s'] / updates:.4f}",
            episode_reward_mean=curve[-1][1])
        buf = rb.buffers["default_policy"]
        p = _replay_parity("sac_async", policy, buf, False, 256)
        say("sac_async", parity="graphed = eager", bitwise=True, **p)
        _ring_kernels("sac_async", "default_policy", buf, 256, 32, False)
        return launches
    finally:
        algo.stop()


def _impala_cartpole(**over):
    """cartpole-impala.yaml's widths and batch (4 envs a worker, T = 64,
    batch 512, lr 5e-4, entropy 0.01, vf 0.5, grad clip 40) with 2
    remote workers instead of its 0, superstep "auto" (8 on the card)."""
    from ray_tpu_torch.algorithms.impala.impala import IMPALAConfig

    return algo_from_yaml(CARTPOLE_IMPALA, IMPALAConfig, num_workers=2, **over)


def _fused_parity(record, config, space, act_space):
    """The first fused superstep against K eager learns of a copy of the
    policy (its state and generators just before) on the same K stacked
    batches: the stats and every parameter bitwise."""
    import torch

    from ray_tpu_torch.algorithms.impala.impala import ImpalaTorchPolicy

    eager = ImpalaTorchPolicy(space, act_space, dict(config))
    eager.set_state(record["state"])
    eager.perm_generator.set_state(record["perm"])
    k, bs = record["k"], record["bs"]
    want = [eager.learn_on_device_batch({c: v[i] for c, v in record["stacked"].items()}, bs)
            for i in range(k)]
    require(want == record["infos"], f"impala_fused: fused stats {record['infos']} != eager {want}")
    bad = [n for n, a, b in zip(eager.param_names, eager.params, record["after"])
           if not torch.equal(a, b)]
    require(not bad, f"impala_fused: fused and eager parameters differ in {bad}")
    return {"k": k, "batch_unrolls": bs, "params": len(record["after"])}


def phase_impala_fused():
    """``_impala_cartpole`` for ASYNC_BUDGET_S["impala_fused"] seconds:
    rates, the learner thread's fused supersteps and updates, its queue
    wait against its grad time; then a backlog (the main thread holds
    the thread's step lock while train() queues batches) that the
    thread must learn as fused supersteps; the first fused superstep of
    the run bitwise against K eager learns (``_fused_parity``); then the
    same geometry with one aggregation actor for
    ASYNC_BUDGET_S["impala_agg"] seconds: the train batches that came
    through it."""
    import torch

    algo = _impala_cartpole()
    try:
        lt = algo._learner_thread
        policy = algo.get_policy()
        require(policy.device.type == "cuda" and lt._superstep_k == 8,
                f"impala_fused: K {lt._superstep_k} on {policy.device}")
        record = {}
        real = policy.learn_superstep

        def recorded(k, bs, **kw):
            if record:
                return real(k, bs, **kw)
            record.update(state=copy.deepcopy(policy.get_state()),
                          perm=policy.perm_generator.get_state(),
                          stacked={c: v.clone() for c, v in kw["stacked"].items()}, k=k, bs=bs)
            out = real(k, bs, **kw)
            record.update(infos=out[0], after=[p.detach().clone() for p in policy.params])
            return out

        policy.learn_superstep = recorded
        zero_kernel_counts()
        a = _learner_snapshot(algo)
        s0, t0 = lt.num_supersteps, time.perf_counter()
        while time.perf_counter() - t0 < ASYNC_BUDGET_S["impala_fused"]:
            r = algo.train()
        torch.cuda.synchronize()
        b = _learner_snapshot(algo)
        wall = b["t"] - a["t"]
        fused_in_window = lt.num_supersteps - s0
        # a backlog: the thread waits for its lock while batches queue
        t_hold = time.perf_counter()
        with lt.lock:
            while time.perf_counter() - t_hold < BACKLOG_S:
                algo.train()
        deadline = time.perf_counter() + 30
        while lt.num_supersteps == s0 + fused_in_window and time.perf_counter() < deadline:
            algo.train()
        require(lt.num_supersteps > s0 + fused_in_window,
                "impala_fused: the thread learned its backlog without a fused superstep")
        require(lt.healthy(), f"impala_fused: the learner thread died: {lt.error!r}")
        launches = read_kernel_counts()
        with lt.lock:
            policy.learn_superstep = real
            parity = _fused_parity(record, algo.config, policy.observation_space,
                                   policy.action_space)
        d = {k: b[k] - a[k] for k in ("steps", "sampled", "trained", "queue_wait_time_s",
                                       "grad_time_s")}
        say("impala_fused", window_s=f"{wall:.2f}", k=lt._superstep_k,
            fused_supersteps_in_window=fused_in_window, fused_supersteps=lt.num_supersteps,
            learner_steps=d["steps"],
            env_steps_per_s_sampled=f"{d['sampled'] / wall:.1f}",
            env_steps_per_s_trained=f"{d['trained'] / wall:.1f}",
            queue_wait_time_s=f"{d['queue_wait_time_s']:.4f}", grad_time_s=f"{d['grad_time_s']:.4f}",
            grad_s_per_update=f"{d['grad_time_s'] / max(1, d['steps']):.5f}",
            launches=json.dumps(launches), episode_reward_mean=r["episode_reward_mean"])
        say("impala_fused", parity="fused graph = eager learns", bitwise=True, **parity)
    finally:
        algo.stop()
    agg = _impala_cartpole(num_aggregation_workers=1)
    try:
        require(len(agg._aggregators) == 1, "impala_fused: no aggregation actor")
        # warm until the first batch came through (the actor processes start)
        t0 = time.perf_counter()
        while agg.num_aggregated_batches == 0 and time.perf_counter() - t0 < AGG_WARM_TIMEOUT_S:
            agg.train()
        warm_s = time.perf_counter() - t0
        require(agg.num_aggregated_batches >= 1,
                f"impala_fused: nothing came through the aggregator in {warm_s:.1f} s")
        n0, sampled0 = agg.num_aggregated_batches, agg._counters["num_env_steps_sampled"]
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ASYNC_BUDGET_S["impala_agg"]:
            r = agg.train()
        wall = time.perf_counter() - t0
        require(agg.num_aggregated_batches > n0, "impala_fused: the aggregator stopped answering")
        require(agg._learner_thread.healthy(), "impala_fused: the learner thread died")
        say("impala_agg", warm_s=f"{warm_s:.2f}", window_s=f"{wall:.2f}",
            aggregated_batches=agg.num_aggregated_batches - n0,
            env_steps_per_s_sampled=f"{(agg._counters['num_env_steps_sampled'] - sampled0) / wall:.1f}",
            learner_steps=agg._learner_thread.num_steps,
            fused_supersteps=agg._learner_thread.num_supersteps,
            episode_reward_mean=r["episode_reward_mean"])
    finally:
        agg.stop()
    return launches


# the rest of replay and the device lane: Ape-X DDPG on device shards,
# Ape-X's object plane of replay actors, learn_while_rollout, host trees
# beside device rows, the memory-cap spill, device-lane evaluation
APEX_DDPG_BUDGET_S = 4.0
APEX_HOST_BUDGET_S = 4.0
INTERLEAVE_WINDOW_S = 3.0
# rounds profiled per cadence for the fill's overlap with the graph
INTERLEAVE_PROFILED_ROUNDS = 3
# rounds from the seed in which the two cadences' counters, and two
# interleaved runs' states, are held equal (the cadence engages at the
# fifth)
INTERLEAVE_FIXED_ROUNDS = 12
INTERLEAVE_COUNTERS = ("num_env_steps_sampled", "num_env_steps_trained", "num_target_updates")
# rounds of host_tree's and spill's main paths after the lane is warm
REPLAY_PLANE_ROUNDS = 8
# the spill phase's cap: below the 16,384-row ring's projection (its
# five columns' rows take 41 bytes)
SPILL_CAP_BYTES = 1 << 18


def _apex_window(phase, algo, budget_s):
    """Ape-X's main path: the launch counts set to 0 just before, then
    ``train()`` until learning starts and ``budget_s`` seconds after it.
    Returns the launches, the fragments routed, the env steps sampled and
    the updates (in the window), the fill's and the window's seconds and
    the reward curve."""
    cfg = algo.config
    inserts = [0]
    route = algo._route_to_replay

    def counted_route(batch):
        inserts[0] += 1
        return route(batch)

    algo._route_to_replay = counted_route
    zero_kernel_counts()
    t0 = time.perf_counter()
    while algo._counters["num_env_steps_sampled"] < cfg["num_steps_sampled_before_learning_starts"]:
        algo.train()
    fill_s = time.perf_counter() - t0
    sampled0 = algo._counters["num_env_steps_sampled"]
    curve, wall = learn_curve(phase, algo, None, 10 ** 9, budget_s)
    return {"launches": read_kernel_counts(), "inserts": inserts[0], "fill_s": fill_s,
            "wall": wall, "curve": curve,
            "sampled": algo._counters["num_env_steps_sampled"] - sampled0,
            "updates": algo._counters["num_env_steps_trained"] // int(cfg["train_batch_size"])}


def phase_apex_ddpg():
    """``ApexDDPGConfig()``'s own defaults on the port's Pendulum-v1 (4 CPU
    workers with OU noise, n-step 3, two prioritized device shards of
    50,000 rows on the device tree, batch 256, fragment 50, learning from
    1000 steps; superstep "auto": 8 graphed updates a shard and pass):
    the main path for APEX_DDPG_BUDGET_S seconds after learning starts;
    rates, the split, the launches against the shards' schedule (a
    descent and a gather per column an update, more scatters than
    columns x inserts: the trees' writes), no shard spilled; then each
    shard's three kernels against their plain versions."""
    from ray_tpu_torch.algorithms.apex_dqn.apex_dqn import ApexDDPGConfig

    algo = ApexDDPGConfig().environment("Pendulum-v1").build()
    try:
        policy, shards = algo.get_policy(), algo.replay_shards
        n = algo.workers.num_remote_workers()
        require(type(policy).__name__ == "DDPGTorchPolicy" and policy.device.type == "cuda",
                f"apex_ddpg: {type(policy).__name__} on {policy.device}")
        require(n == 4 and all(s.tree_plane == "device" for s in shards),
                f"apex_ddpg: {n} workers, trees {[s.tree_plane for s in shards]}")
        w = _apex_window("apex_ddpg", algo, APEX_DDPG_BUDGET_S)
        launches, updates = w["launches"], w["updates"]
        cols = {len(s._store) for s in shards}
        require(len(cols) == 1, f"apex_ddpg: shards hold other columns {cols}")
        (cols,) = cols
        require(updates >= 1, "apex_ddpg: no update")
        require(launches["find_prefixsum"] == updates,
                f"apex_ddpg: {launches['find_prefixsum']} descents in {updates} updates")
        require(launches["gather_rows"] == cols * updates,
                f"apex_ddpg: {launches['gather_rows']} row gathers in {updates} updates of {cols}")
        require(launches["scatter_rows"] > cols * w["inserts"],
                f"apex_ddpg: {launches['scatter_rows']} row scatters in {w['inserts']} inserts")
        require(not any(s.spilled for s in shards), "apex_ddpg: a shard spilled")
        runners = list(policy._superstep_runners.values())
        require(len(runners) == len(shards) and all(r.graph is not None for r in runners),
                f"apex_ddpg: {len(runners)} replay slots for {len(shards)} shards")
        say("apex_ddpg", budget_s=APEX_DDPG_BUDGET_S, fill_s=f"{w['fill_s']:.2f}",
            wall_s=f"{w['wall']:.2f}", env_steps_per_s_sampled=f"{w['sampled'] / w['wall']:.1f}",
            updates=updates, updates_per_s=f"{updates / w['wall']:.1f}", inserts=w["inserts"],
            replay_columns=cols, shard_rows=json.dumps([len(s) for s in shards]),
            shard_capacity=json.dumps([s.capacity for s in shards]),
            spilled=json.dumps([s.spilled for s in shards]), launches=json.dumps(launches),
            split=json.dumps({k: round(v, 3) for k, v in algo._timers.items()}),
            episode_reward_mean=w["curve"][-1][1])
        frag = int(algo.config["rollout_fragment_length"])
        for i, shard in enumerate(shards):
            _ring_kernels("apex_ddpg", f"shard_{i}", shard, int(algo.config["train_batch_size"]),
                          frag, True)
        return launches
    finally:
        algo.stop()


def phase_apex_host():
    """cartpole-apex.yaml as written plus ``replay_device_resident:
    False``: 3 CPU workers on the epsilon ladder and two 25,000-row
    ``ReplayActor`` processes over host rings; the learner on the card
    takes one upload a batch and sends its priorities back to the actor
    that drew it. The main path for APEX_HOST_BUDGET_S seconds after
    learning starts: rates and the split (learning, routing, the wait for
    the replay actors' batches); no replay kernel runs on this plane."""
    from ray_tpu_torch import core as ray_core
    from ray_tpu_torch.utils.tuned_example import build_tuned_example

    algo, _ = build_tuned_example(APEX_TUNED, replay_device_resident=False)
    try:
        policy = algo.get_policy()
        require(policy.device.type == "cuda" and not algo._apex_device
                and len(algo.replay_actors) == 2 and algo.replay_shards == [],
                f"apex_host: plane {algo._apex_device}, {len(algo.replay_actors)} actors")
        w = _apex_window("apex_host", algo, APEX_HOST_BUDGET_S)
        require(w["updates"] >= 1 and algo._counters["num_target_updates"] >= 1,
                f"apex_host: {w['updates']} updates, no target update")
        sizes = ray_core.get([a.size.remote() for a in algo.replay_actors])
        require(all(s > 0 for s in sizes), f"apex_host: actor rows {sizes}")
        split = {k: round(v, 3) for k, v in algo._timers.items()}
        say("apex_host", budget_s=APEX_HOST_BUDGET_S, fill_s=f"{w['fill_s']:.2f}",
            wall_s=f"{w['wall']:.2f}", env_steps_per_s_sampled=f"{w['sampled'] / w['wall']:.1f}",
            updates=w["updates"], updates_per_s=f"{w['updates'] / w['wall']:.1f}",
            target_updates=algo._counters["num_target_updates"], inserts=w["inserts"],
            actor_rows=json.dumps(sizes), launches=json.dumps(w["launches"]),
            learning_s=split.get("update_s"), routing_s=split.get("insert_s"),
            replay_wait_s=split.get("replay_wait_s"), split=json.dumps(split),
            episode_reward_mean=w["curve"][-1][1])
        return w["launches"]
    finally:
        algo.stop()


def interleave_config(**over):
    """bench.py:3889-3915's geometry on the port: CartPoleJax-v0 on the
    device lane, 8 envs x 8 steps a round, batch 256, a prioritized
    16,384-row ring on the device tree, ``training_intensity`` 32 (8
    updates a round: one superstep of K = 8), FCNet 64x64, learning from
    256 steps, the target every 2048 trained steps, seed 0; ``over``
    names what a phase changes."""
    from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig

    cfg = (DQNConfig().environment("CartPoleJax-v0", env_backend="jax")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=8, num_envs_per_worker=8)
           .training(train_batch_size=256, num_steps_sampled_before_learning_starts=256,
                     replay_buffer_config={"prioritized_replay": True, "capacity": 1 << 14},
                     training_intensity=32.0, replay_device_resident=True,
                     replay_device_tree=True, target_network_update_freq=2048,
                     model={"fcnet_hiddens": [64, 64]})
           .debugging(seed=0))
    cfg.superstep = 8
    return cfg.update_from_dict(over)


def _warm_lane(algo):
    """Rounds until learning has started and the first superstep ran (its
    capture), and, under ``learn_while_rollout``, until the cadence is
    engaged."""
    import torch

    while not (algo._counters["num_env_steps_trained"] > 0
               and (not algo.config.get("learn_while_rollout") or algo._interleave_ready())):
        algo.train()
    algo.train()
    torch.cuda.synchronize()


def _fill_overlap(algo, rounds):
    """The share of the fill's device time that the superstep's graph
    covers, from one ``torch.profiler`` trace of ``rounds`` rounds: the
    fill's kernels are those launched inside the rollout (a
    ``record_function`` range around ``engine.rollout``) and not by a
    graph launch, the graph's those whose launch is a graph launch
    (CUPTI reports a graph's kernels under the graph launch's
    correlation id); with the streams each ran on."""
    import torch

    eng = algo._rollout_engine
    rollout = eng.rollout

    def marked(*a, **kw):
        with torch.profiler.record_function("dqn_fill"):
            return rollout(*a, **kw)

    eng.rollout = marked
    try:
        with profiled() as prof:
            for _ in range(rounds):
                algo.train()
    finally:
        eng.rollout = rollout
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = list(prof.profiler.kineto_results.events())
    fills = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.device_type() == cpu and e.name() == "dqn_fill")
    launches = {e.correlation_id(): (e.name(), e.start_ns()) for e in events
                if e.device_type() == cpu and "aunch" in e.name()}
    fill_k, graph_k, streams = [], [], {"fill": set(), "graph": set()}
    # per round (the fill ranges in order): the graph kernels launched
    # before its fill began and after the previous fill ended, its fill's
    rounds_k = [([], []) for _ in fills]
    for e in events:
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        launch = launches.get(e.linked_correlation_id()) or launches.get(e.correlation_id())
        if launch is None:
            continue
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        r = sum(1 for a, _ in fills if a <= launch[1])  # fills begun by the launch
        if "Graph" in launch[0]:
            graph_k.append(span)
            streams["graph"].add(e.device_resource_id())
            if r < len(fills):
                rounds_k[r][0].append(span)
        elif r and launch[1] <= fills[r - 1][1]:
            fill_k.append(span)
            streams["fill"].add(e.device_resource_id())
            rounds_k[r - 1][1].append(span)
    share = span_overlap(fill_k, sorted(graph_k)) if fill_k and graph_k else None
    # how long the round's graph ran past its fill's first kernel (<= 0:
    # it was done before the fill reached the card)
    past = [round((max(b for _, b in g) - min(a for a, _ in f)) / 1e3, 1)
            for g, f in rounds_k if g and f]
    return {"rounds": rounds, "fill_kernels": len(fill_k), "graph_kernels": len(graph_k),
            "fill_device_ms": round(sum(b - a for a, b in fill_k) / 1e6, 4),
            "graph_device_ms": round(sum(b - a for a, b in graph_k) / 1e6, 4),
            "overlap_share": None if share is None else round(share, 4),
            "fill_host_ms": [round((b - a) / 1e6, 3) for a, b in fills],
            "graph_past_first_fill_kernel_us": past,
            "fill_streams": sorted(streams["fill"]), "graph_streams": sorted(streams["graph"])}


def _lane_window(algo, window_s):
    """``algo.train()`` for ``window_s`` seconds after warming: env
    steps a second and updates a second of host clock."""
    import torch

    bs = int(algo.config["train_batch_size"])
    s0, t0_ = algo._counters["num_env_steps_sampled"], algo._counters["num_env_steps_trained"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rounds = 0
    while time.perf_counter() - t0 < window_s:
        algo.train()
        rounds += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = algo._counters["num_env_steps_sampled"] - s0
    updates = (algo._counters["num_env_steps_trained"] - t0_) // bs
    return {"rounds": rounds, "wall_s": round(wall, 3), "env_steps_per_s": round(steps / wall, 1),
            "updates_per_s": round(updates / wall, 1), "updates": updates}


def _interleave_fixed_rounds(interleave):
    """INTERLEAVE_FIXED_ROUNDS rounds of :func:`interleave_config` from
    its seed: the algorithm and each round's counters. Under
    ``learn_while_rollout`` the last round is watched: its superstep's
    draws are made before its fill's rows are in (the ring's count at
    each draw is the round's start count), the fill acts through the
    acting copy, which holds the parameters the round started from
    when the fill begins and after the round, bitwise, while the
    policy's moved (the fill read no updated weight)."""
    import torch

    algo = interleave_config(learn_while_rollout=interleave).build()
    counters = []
    for i in range(INTERLEAVE_FIXED_ROUNDS):
        last = interleave and i == INTERLEAVE_FIXED_ROUNDS - 1
        if last:
            require(algo._interleave_ready(), "dqn_interleave: the cadence did not engage")
            buf = algo.local_replay_buffer.buffers["default_policy"]
            start, seen, feed = buf.num_added, [], buf.superstep_feed
            before = [p.detach().clone() for p in algo.get_policy().params]
            eng, acted = algo._rollout_engine, []

            def recorded(*a, _feed=feed, **kw):
                seen.append(buf.num_added)
                return _feed(*a, **kw)

            def watched(*a, _rollout=eng.rollout, **kw):
                model = algo.get_policy().model
                acted.append(model is algo._acting_model and all(
                    torch.equal(x, y) for x, y in zip(model.parameters(), before)))
                return _rollout(*a, **kw)

            buf.superstep_feed, eng.rollout = recorded, watched
        algo.train()
        counters.append(tuple(algo._counters[k] for k in INTERLEAVE_COUNTERS))
        if last:
            del buf.superstep_feed, eng.rollout
            torch.cuda.synchronize()
            acting = list(algo._acting_model.parameters())
            require(seen == [start] and buf.num_added == start + 64,
                    f"dqn_interleave: draws at ring counts {seen}, round start {start}")
            require(acted == [True], "dqn_interleave: the fill did not act on the round's "
                    f"starting weights through the acting copy ({acted})")
            require(all(torch.equal(a, b) for a, b in zip(acting, before)),
                    "dqn_interleave: the acting copy is not the round's starting weights")
            require(not all(torch.equal(a, b) for a, b in zip(algo.get_policy().params, before)),
                    "dqn_interleave: the round's updates left the weights as they were")
    return algo, counters


def _interleave_parity():
    """The cadence's semantics on the card: :func:`_interleave_fixed_rounds`
    serially and twice under ``learn_while_rollout``. The sampled, trained
    and target-update counters equal the serial cadence's round by round;
    the two interleaved runs end bitwise equal (parameters, the device
    sum tree, the ring's and the action generator's states). Returns the
    serial and the first interleaved algorithm, and what was checked."""
    import torch

    serial, c0 = _interleave_fixed_rounds(False)
    a, c1 = _interleave_fixed_rounds(True)
    b, c2 = _interleave_fixed_rounds(True)
    try:
        require(c0[-1][1] > 0 and c1 == c0, f"dqn_interleave: counters {c1} against serial {c0}")
        require(c2 == c1, f"dqn_interleave: two interleaved runs' counters {c1}, {c2}")
        pa, pb = a.get_policy(), b.get_policy()
        require(all(torch.equal(x, y) for x, y in zip(pa.params, pb.params)),
                "dqn_interleave: two fixed-seed interleaved runs' parameters differ")
        ba, bb = (x.local_replay_buffer.buffers["default_policy"] for x in (a, b))
        require(torch.equal(ba._dtree.sum_value, bb._dtree.sum_value)
                and ba._rng.bit_generator.state == bb._rng.bit_generator.state
                and torch.equal(pa.action_generator.get_state(), pb.action_generator.get_state()),
                "dqn_interleave: two fixed-seed interleaved runs' trees or generators differ")
    finally:
        b.stop()
    return serial, a, {"fixed_rounds": INTERLEAVE_FIXED_ROUNDS,
                       "counters_equal_serial": True, "runs_bitwise": True,
                       "acting_copy_is_round_start": True,
                       "final_counters": dict(zip(INTERLEAVE_COUNTERS, c1[-1]))}


def phase_dqn_interleave():
    """:func:`interleave_config` serially and under
    ``learn_while_rollout`` (the fill on the acting copy, on the same
    stream, launched while the superstep's graph runs): first the
    cadence's semantics (:func:`_interleave_parity`); then each run for
    INTERLEAVE_WINDOW_S seconds (the interleaved one's main path, with
    the launch counts set to 0 just before: a descent and a gather per
    column an update, a scatter per column an insert and the trees'
    writes), then INTERLEAVE_PROFILED_ROUNDS rounds under the profiler
    for the fill's overlap with the graph. Then rows 1, 3 and 4 against
    their plain versions on the interleaved run's ring."""
    serial, interleaved, parity = _interleave_parity()
    say("dqn_interleave", **{k: json.dumps(v) if isinstance(v, dict) else v
                             for k, v in parity.items()})
    out = {}
    for cadence, algo in (("serial", serial), ("interleaved", interleaved)):
        _warm_lane(algo)
        buf = algo.local_replay_buffer.buffers["default_policy"]
        inserts = [0]
        add = buf.add_device_tree

        def counted(tree, *a, _add=add, **kw):
            inserts[0] += 1
            return _add(tree, *a, **kw)

        buf.add_device_tree = counted
        zero_kernel_counts()
        rates = _lane_window(algo, INTERLEAVE_WINDOW_S)
        launches = read_kernel_counts()
        cols, updates = len(buf._store), rates["updates"]
        require(not buf.spilled and buf._store["obs"].is_cuda, "dqn_interleave: the ring left the card")
        require(launches["find_prefixsum"] == updates and launches["gather_rows"] == cols * updates,
                f"dqn_interleave {cadence}: {launches} in {updates} updates of {cols} columns")
        require(launches["scatter_rows"] > cols * inserts[0],
                f"dqn_interleave {cadence}: {launches['scatter_rows']} scatters, {inserts[0]} inserts")
        overlap = _fill_overlap(algo, INTERLEAVE_PROFILED_ROUNDS)
        say("dqn_interleave", cadence=cadence, **{k: v for k, v in rates.items() if k != "updates"},
            updates=updates, inserts=inserts[0], launches=json.dumps(launches),
            counters=json.dumps({k: algo._counters[k] for k in (
                "num_env_steps_sampled", "num_env_steps_trained", "num_target_updates")}),
            overlap=json.dumps(overlap))
        out[cadence] = {"launches": launches, "algo": algo, "rates": rates, "overlap": overlap}
    algo = out["interleaved"]["algo"]
    _ring_kernels("dqn_interleave", "default_policy", algo.local_replay_buffer.buffers["default_policy"],
                  256, 64, True)
    for v in out.values():
        v["algo"].stop()
    return out["interleaved"]["launches"]


def _draw_of(batch):
    """(indices, IS weights) of a draw as host arrays: a device batch's,
    or a spilled ring's host ``SampleBatch``'s."""
    import numpy as np

    if isinstance(batch, dict):
        return np.asarray(batch["batch_indexes"]), np.asarray(batch["weights"])
    idx = batch.indices
    return (idx.cpu().numpy() if hasattr(idx, "cpu") else np.asarray(idx),
            batch.tree["weights"].cpu().numpy())


def _same_draws(phase, a, b, rounds, rows):
    """``rounds`` times: the next 64 of ``rows`` into buffers ``a`` and
    ``b`` (the same seed), a draw of 256 from each, whose indices and IS
    weights must be bitwise equal, then the same priorities at them."""
    import numpy as np

    gen = np.random.default_rng(5)
    for r in range(rounds):
        tree = {k: v[r * 64:(r + 1) * 64] for k, v in rows.items()}
        a.add_device_tree(dict(tree))
        b.add_device_tree(dict(tree))
        (ia, wa), (ib, wb) = _draw_of(a.sample(256, beta=0.4)), _draw_of(b.sample(256, beta=0.4))
        require(np.array_equal(ia, ib) and wa.tobytes() == wb.tobytes(),
                f"{phase}: draw {r} differs from the device tree's")
        pri = gen.random(256) * 3
        a.update_priorities(ia, pri)
        b.update_priorities(ib, pri)
    return rounds


def _lane_rows(algo, rounds):
    """``rounds`` rollouts of the lane's engine, concatenated on the card."""
    import torch

    trees = [algo._jax_rollout_engine_get().rollout()[0] for _ in range(rounds)]
    return {k: torch.cat([t[k] for t in trees]) for k in trees[0]}


def _replay_plane_run(algo):
    """REPLAY_PLANE_ROUNDS rounds of a warmed lane with the launch counts
    set to 0 just before: the launches, updates and rates."""
    _warm_lane(algo)
    zero_kernel_counts()
    bs = int(algo.config["train_batch_size"])
    t0, tr0 = time.perf_counter(), algo._counters["num_env_steps_trained"]
    for _ in range(REPLAY_PLANE_ROUNDS):
        algo.train()
    wall = time.perf_counter() - t0
    return read_kernel_counts(), (algo._counters["num_env_steps_trained"] - tr0) // bs, wall


def phase_host_tree():
    """:func:`interleave_config` with ``replay_device_tree: False``: the
    sum and min trees in host numpy beside rows on the card. Two rings of
    that geometry and seed, one per tree plane, take the same lane rows
    and priorities: every draw's indices and IS weights bitwise equal.
    Then the main path (REPLAY_PLANE_ROUNDS rounds with the counts set to
    0 just before: a gather per column an update, no descent: the draw
    is on the host) and rows 1 and 3 against their plain versions on its
    ring."""
    from ray_tpu_torch.execution.replay_buffer import DevicePrioritizedReplayBuffer

    algo = interleave_config(replay_device_tree=False).build()
    try:
        rows = _lane_rows(algo, 8)
        host = DevicePrioritizedReplayBuffer(1 << 14, 0.6, 3, device_tree=False)
        dev = DevicePrioritizedReplayBuffer(1 << 14, 0.6, 3)
        draws = _same_draws("host_tree", host, dev, 8, rows)
        launches, updates, wall = _replay_plane_run(algo)
        buf = algo.local_replay_buffer.buffers["default_policy"]
        cols = len(buf._store)
        require(buf.tree_plane == "host" and buf._store["obs"].is_cuda, "host_tree: not host trees")
        require(updates >= 1 and launches["find_prefixsum"] == 0
                and launches["gather_rows"] == cols * updates and launches["scatter_rows"] >= cols,
                f"host_tree: {launches} in {updates} updates of {cols} columns")
        say("host_tree", draws_equal_device_tree=draws, bitwise=True, rounds=REPLAY_PLANE_ROUNDS,
            updates=updates, updates_per_s=f"{updates / wall:.1f}", launches=json.dumps(launches))
        _ring_kernels("host_tree", "default_policy", buf, 256, 64, False)
        return launches
    finally:
        algo.stop()


def phase_spill():
    """:func:`interleave_config` under ``replay_memory_cap_bytes`` below
    the ring's projection (SPILL_CAP_BYTES): the ring spills to its host
    ring at the first insert, and a spilled ring of that geometry draws
    the unspilled ring's indices and IS weights, bitwise, on the same
    rows and priorities. The main path then runs REPLAY_PLANE_ROUNDS
    rounds, its supersteps on the host stacked path (one upload of K
    stacked draws), with the counts set to 0 just before; the default
    cap (60% of the card's memory) is printed beside."""
    from ray_tpu_torch.execution.replay_buffer import DevicePrioritizedReplayBuffer

    algo = interleave_config(replay_memory_cap_bytes=SPILL_CAP_BYTES).build()
    try:
        rows = _lane_rows(algo, 8)
        sp = DevicePrioritizedReplayBuffer(1 << 14, 0.6, 3, memory_cap_bytes=SPILL_CAP_BYTES)
        dev = DevicePrioritizedReplayBuffer(1 << 14, 0.6, 3)
        draws = _same_draws("spill", sp, dev, 8, rows)
        require(sp.spilled and not dev.spilled, "spill: the capped ring did not spill")
        launches, updates, wall = _replay_plane_run(algo)
        buf = algo.local_replay_buffer.buffers["default_policy"]
        require(buf.spilled and buf.stats()["device_resident"] is False and updates >= 1,
                f"spill: {buf.stats()}, {updates} updates")
        say("spill", spilled=True, cap_bytes=SPILL_CAP_BYTES, draws_equal_unspilled=draws,
            bitwise=True, default_cap_bytes=dev._memory_limit(), rounds=REPLAY_PLANE_ROUNDS,
            updates=updates, updates_per_s=f"{updates / wall:.1f}", stats=json.dumps(buf.stats()),
            launches=json.dumps(launches))
        return launches
    finally:
        algo.stop()


def phase_lane_eval():
    """cartpolejax-ppo.yaml on the device lane (K = auto) with
    ``evaluation_interval: 1``: the evaluation set's one worker, on the
    card, drives CartPoleJax-v0 through ``TensorVectorEnvAdapter`` with
    the learner's weights. Two iterations, the launch counts set to 0
    just before: the lane's GAE launches, each result's ``evaluation``
    summary, and the evaluation worker's weights bitwise the learner's."""
    import numpy as np

    algo = ppo_from_yaml(CARTPOLE, evaluation_interval=1, evaluation_duration=10)
    try:
        lw = algo.evaluation_workers.local_worker()
        require(type(lw.vector_env).__name__ == "TensorVectorEnvAdapter"
                and lw.vector_env.device.type == "cuda", "lane_eval: no adapter on the card")
        zero_kernel_counts()
        t0 = time.perf_counter()
        results = [algo.train() for _ in range(2)]
        wall = time.perf_counter() - t0
        launches = read_kernel_counts()
        ev = [r["evaluation"] for r in results]
        require(all(e["episodes_this_iter"] >= 10 and math.isfinite(e["episode_reward_mean"])
                    for e in ev), f"lane_eval: {ev}")
        got, want = lw.policy().get_weights(), algo.policy.get_weights()
        require(all(np.array_equal(got[k], want[k]) for k in want), "lane_eval: weights differ")
        require(launches["compute_gae_fragment"] >= 1, "lane_eval: the lane launched no GAE")
        say("lane_eval", iterations=2, wall_s=f"{wall:.2f}", launches=json.dumps(launches),
            evaluation=json.dumps([{k: e[k] for k in ("episode_reward_mean", "episode_len_mean",
                                                      "episodes_this_iter")} for e in ev]),
            timesteps_total=results[-1]["timesteps_total"])
        return launches
    finally:
        algo.stop()


def kernel_counters():
    """The launch counter of every kernel wrapper."""
    from ray_tpu_torch.ops.flash_attention import flash_attention, flash_block_attention_stats
    from ray_tpu_torch.ops.framestack import gather_rows, scatter_rows
    from ray_tpu_torch.ops.gae import compute_gae_fragment
    from ray_tpu_torch.ops.segment_tree import find_prefixsum

    return (gather_rows, compute_gae_fragment, scatter_rows, find_prefixsum, flash_attention,
            flash_block_attention_stats)


def zero_kernel_counts():
    for k in kernel_counters():
        k.launches = 0


def read_kernel_counts():
    return {k.__name__: k.launches for k in kernel_counters()}


def ma_cartpole_config(**over):
    """bench_e2e.py's ``_ma_cartpole`` as written, lambdas included, on
    the port's CartPole-v1: 4 agents on one shared policy, FCNet
    128x128, 1 remote worker, fragment 256, batch 2048, minibatch 256, 8
    epochs, lr 3e-4, entropy 0.01, seed 0. ``over``: rollout keys."""
    import numpy as np

    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
    from ray_tpu_torch.env.multi_agent_env import make_multi_agent
    from ray_tpu_torch.env.registry import register_env
    from ray_tpu_torch.env.spaces import Box, Discrete

    register_env("ma_cartpole4", lambda cfg: make_multi_agent("CartPole-v1")({"num_agents": 4}))
    obs_sp = Box(-np.inf, np.inf, (4,), np.float64)
    act_sp = Discrete(2)
    return (
        PPOConfig()
        .environment("ma_cartpole4")
        .rollouts(**{"num_rollout_workers": 1, "rollout_fragment_length": 256, **over})
        .training(
            train_batch_size=2048, sgd_minibatch_size=256,
            num_sgd_iter=8, lr=3e-4, entropy_coeff=0.01,
            model={"fcnet_hiddens": [128, 128]},
        )
        .multi_agent(
            policies={"shared": (None, obs_sp, act_sp, {})},
            policy_mapping_fn=lambda aid, **kw: "shared",
        )
        .debugging(seed=0)
    )


def _finite_learner(phase, result, pids):
    learner = result["info"]["learner"]
    require(set(learner) == set(pids), f"{phase}: info/learner holds {sorted(learner)}, not {pids}")
    for pid in pids:
        require(all(math.isfinite(v) for v in learner[pid].values()),
                f"{phase}: non-finite {pid} stats {learner[pid]}")
    return learner


def phase_ma_ppo():
    """Multi-agent PPO at ``_ma_cartpole``'s full width
    (:func:`ma_cartpole_config`): the remote worker samples 4 agents on
    the CPU, the shared policy learns on the card. One warm iteration,
    then MA_TIMED_CALLS timed: env-steps/s and agent-steps/s (median,
    range), the split, the busy share of one more learn; finite stats
    under ``info/learner/shared`` and the worker's ``shared`` weights
    bitwise equal to the learner's after the sync are required; then
    MA_LEARN_S seconds of training: the course of
    ``policy_reward_mean["shared"]`` (recorded, not required). The
    kernel launch counts of the run are printed (the path runs host GAE
    and no frame pool, as the reference's does)."""
    import numpy as np
    import torch

    from ray_tpu_torch import core as ray_core
    from ray_tpu_torch.algorithms.ppo.ppo import _standardize_advantages
    from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample

    algo = ma_cartpole_config().build()
    try:
        policy = algo.get_policy("shared")
        require(policy.device.type == "cuda" and all(p.is_cuda for p in policy.params),
                "the multi-agent learner is not on the card")
        zero_kernel_counts()
        t0 = time.perf_counter()
        algo.train()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        walls, results, agent_steps = [], [], []
        for _ in range(MA_TIMED_CALLS):
            before = algo._counters["num_agent_steps_trained"]
            t0 = time.perf_counter()
            results.append(algo.train())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            agent_steps.append(algo._counters["num_agent_steps_trained"] - before)
        last = results[-1]
        learner = _finite_learner("ma_ppo", last, ["shared"])
        bsize = int(algo.config["train_batch_size"])
        require(all(r["timesteps_total"] == bsize * (i + 2) for i, r in enumerate(results)),
                f"env steps {[r['timesteps_total'] for r in results]}")
        learned = algo.workers.local_worker().get_weights()
        (remote,) = ray_core.get([w.get_weights.remote() for w in algo.workers.remote_workers()])
        for name, w in learned["shared"].items():
            require(np.array_equal(remote["shared"][name], w),
                    f"the remote worker's shared {name} differs from the learner's")
        splits = [{k: round(v, 4) for k, v in r["timers"].items()} for r in results]
        batch = synchronous_parallel_sample(worker_set=algo.workers, max_env_steps=bsize)
        _standardize_advantages(batch)
        local = algo.workers.local_worker()
        busy = device_busy(lambda: local.learn_on_batch(batch), 1)
        say("ma_ppo", agents=4, policies=1, workers=algo.workers.num_remote_workers(),
            fragment=algo.config["rollout_fragment_length"], warm_s=f"{warm_s:.2f}",
            env_steps_per_s=json.dumps(spread([bsize / w for w in walls])),
            agent_steps_per_s=json.dumps(spread([a / w for a, w in zip(agent_steps, walls)])),
            agent_steps_per_iter=json.dumps(agent_steps), iter_s=json.dumps([round(w, 4) for w in walls]),
            learn_busy_share=busy["busy_share"], learn_wall_s=busy["wall_s"],
            learn_agent_steps=batch.agent_steps(), weights_synced_bitwise=True)
        say("ma_ppo", split=json.dumps(splits))
        say("ma_ppo", learner=json.dumps({k: round(v, 6) for k, v in learner["shared"].items()}),
            counters=json.dumps({k: algo._counters[k] for k in (
                "num_env_steps_sampled", "num_agent_steps_sampled",
                "num_env_steps_trained", "num_agent_steps_trained")}))
        curve, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < MA_LEARN_S:
            r = algo.train()
            curve.append((r["timesteps_total"], round(float(r["policy_reward_mean"].get("shared", math.nan)), 3),
                          round(time.perf_counter() - t0, 2)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _finite_learner("ma_ppo", r, ["shared"])
        counts = read_kernel_counts()
        every = max(1, len(curve) // 30)
        say("ma_ppo", learn_budget_s=MA_LEARN_S, learn_wall_s=f"{wall:.2f}", iterations=len(curve),
            env_steps=curve[-1][0], env_steps_per_s=f"{(curve[-1][0] - curve[0][0] + bsize) / wall:.1f}",
            policy_reward_mean_shared=curve[-1][1], episode_len_mean=r["episode_len_mean"],
            curve=json.dumps(curve[::every] + curve[-1:]), launches=json.dumps(counts))
        return counts
    finally:
        algo.stop()


def phase_ma_ppo_independent():
    """The ma_ppo geometry with two policies, ``p0`` and ``p1`` (lr 1e-4),
    agents mapped by ``aid % 2``, and ``num_workers: 0``: the local
    worker acts on the card, one batched forward per policy per env
    step. One iteration with ``policies_to_train=["p0"]`` (p1 bitwise
    unchanged, info/learner holds p0 alone), then one with both (both
    move, info/learner holds both): act ms per env step, the split."""
    import numpy as np
    import torch

    from ray_tpu_torch.env.spaces import Box, Discrete

    space, act = Box(-np.inf, np.inf, (4,), np.float64), Discrete(2)
    cfg = ma_cartpole_config(num_rollout_workers=0).multi_agent(
        policies={"p0": (None, space, act, {}), "p1": (None, space, act, {"lr": 1e-4})},
        policy_mapping_fn=lambda aid, **kw: f"p{aid % 2}", policies_to_train=["p0"])
    algo = cfg.build()
    try:
        worker = algo.workers.local_worker()
        require(algo.workers.num_remote_workers() == 0
                and all(p.device.type == "cuda" for p in worker.policy_map.values()),
                "the local worker does not act on the card")

        def weights():
            return {pid: {n: w.copy() for n, w in p.get_weights().items()}
                    for pid, p in worker.policy_map.items()}

        zero_kernel_counts()
        w0 = weights()
        walls = []
        t0 = time.perf_counter()
        r1 = algo.train()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        _finite_learner("ma_ppo_independent", r1, ["p0"])
        w1 = weights()
        require(all(np.array_equal(w1["p1"][n], w) for n, w in w0["p1"].items()),
                "p1 moved outside policies_to_train")
        require(any(not np.array_equal(w1["p0"][n], w) for n, w in w0["p0"].items()), "p0 did not move")
        worker.config["policies_to_train"] = None
        t0 = time.perf_counter()
        r2 = algo.train()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        learner = _finite_learner("ma_ppo_independent", r2, ["p0", "p1"])
        w2 = weights()
        for pid in ("p0", "p1"):
            require(any(not np.array_equal(w2[pid][n], w) for n, w in w1[pid].items()), f"{pid} did not move")
        counts = read_kernel_counts()
        t = worker.sampler.timers
        say("ma_ppo_independent", policies=2, iter_s=json.dumps([round(w, 3) for w in walls]),
            env_steps_per_s=f"{2 * int(algo.config['train_batch_size']) / sum(walls):.1f}",
            act_ms_per_env_step=f"{1e3 * t['act_s'] / max(1, t['steps']):.3f}",
            env_ms_per_env_step=f"{1e3 * t['env_s'] / max(1, t['steps']):.3f}",
            split=json.dumps({k: round(v, 4) for k, v in r2["timers"].items()}),
            cur_lr=json.dumps({pid: learner[pid]["cur_lr"] for pid in learner}),
            policy_reward_mean=json.dumps(r2["policy_reward_mean"]), launches=json.dumps(counts))
        return counts
    finally:
        algo.stop()


def phase_views():
    """Single-agent PPO on the port's CartPole-v1 with ``use_prev_action``
    and ``use_prev_reward``, the local worker acting on the card: one
    sample of 4 envs x 128 steps, whose ``prev_actions`` and
    ``prev_rewards`` must be the actions and rewards shifted by one
    within each episode, zero at each episode's start; then one
    iteration with finite stats."""
    import numpy as np

    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
    from ray_tpu_torch.data.sample_batch import SampleBatch

    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=4, rollout_fragment_length=128)
            .training(train_batch_size=512, sgd_minibatch_size=128, num_sgd_iter=2,
                      model={"fcnet_hiddens": [128, 128], "use_prev_action": True,
                             "use_prev_reward": True})
            .debugging(seed=0).build())
    try:
        require(algo.get_policy().device.type == "cuda", "the views phase does not act on the card")
        zero_kernel_counts()
        t0 = time.perf_counter()
        batch = algo.workers.local_worker().sample()
        sample_s = time.perf_counter() - t0
        t, eps = batch[SampleBatch.T], batch[SampleBatch.EPS_ID]
        acts, rews = batch[SampleBatch.ACTIONS], batch[SampleBatch.REWARDS]
        pa, pr = batch[SampleBatch.PREV_ACTIONS], batch[SampleBatch.PREV_REWARDS]
        start = t == 0
        require(batch.count == 512 and start.sum() >= 4, f"{batch.count} rows, {start.sum()} starts")
        require(np.all(pa[start] == 0) and np.all(pr[start] == 0), "a view reached across an episode start")
        inner = np.flatnonzero(~start)
        require(np.all(inner > 0) and np.all(eps[inner] == eps[inner - 1])
                and np.all(t[inner] == t[inner - 1] + 1), "rows of an episode are not in order")
        require(np.array_equal(pa[inner], acts[inner - 1]) and np.array_equal(pr[inner], rews[inner - 1]),
                "prev_actions / prev_rewards are not the actions / rewards shifted by one")
        r = algo.train()
        _finite_learner("views", r, ["default_policy"])
        say("views", rows=batch.count, episode_starts=int(start.sum()), sample_s=f"{sample_s:.3f}",
            prev_dtypes=json.dumps([str(pa.dtype), str(pr.dtype)]), shifted_bitwise=True,
            launches=json.dumps(read_kernel_counts()))
    finally:
        algo.stop()


# recurrent models on the actor lane: cartpole-ppo.yaml with an
# LSTM and with GTrXL, cartpole-impala.yaml and cartpole-appo.yaml with an
# LSTM, and GTrXL's policy behind the server's sequential fallback
CARTPOLE_IMPALA = os.path.join(REPO, "tuned_examples", "impala", "cartpole-impala.yaml")
CARTPOLE_APPO = os.path.join(REPO, "tuned_examples", "appo", "cartpole-appo.yaml")
RECURRENT_CALLS = 2  # 3 before PR 23
SINGLE_ACTIONS = 8
LSTM_IMPALA_WINDOW_S = 7.0
RSERVE_REQUESTS, RSERVE_THREADS = 64, 8


def _count_calls(policy, names):
    """Count the calls of the policy's ``names`` methods (the act path's
    entry points) from now on: {name: calls}, cleared by the caller."""
    counts = {n: 0 for n in names}
    for name in names:
        method = getattr(policy, name)

        def counted(*args, _name=name, _method=method, **kwargs):
            counts[_name] += 1
            return _method(*args, **kwargs)

        setattr(policy, name, counted)
    return counts


def _single_action_round_trip(algo, policy, rng):
    """SINGLE_ACTIONS ``Algorithm.compute_single_action`` calls threading
    a recurrent state, each one's state out against a batch-1
    ``compute_actions`` from the same state (greedy, on the card):
    bitwise. Returns the call's mean ms."""
    import numpy as np
    import torch

    state = policy.get_initial_state()
    ms = []
    for _ in range(SINGLE_ACTIONS):
        obs = rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        t0 = time.perf_counter()
        action, out, _ = algo.compute_single_action(obs, state, explore=False)
        ms.append(1e3 * (time.perf_counter() - t0))
        want, want_state, _ = policy.compute_actions(obs[None], [s[None] for s in state],
                                                     explore=False)
        require(action == want[0] and len(out) == len(want_state)
                and all(np.array_equal(a, b[0]) for a, b in zip(out, want_state)),
                "compute_single_action's state out differs from a batch-1 compute_actions")
        state = out
    torch.cuda.synchronize()
    return sum(ms) / len(ms)


def _recurrent_ppo(phase, model):
    """cartpole-ppo.yaml as written (the local worker on the card, 4
    envs, fragment 256, batch 2048, minibatch 256, 8 epochs), its model
    with ``model`` merged in: one warm ``train()``, then RECURRENT_CALLS
    timed ones and the single-action round trip, with the launch counts
    and the act path's calls counted from 0 just before. Prints the
    rates and the split; returns (algo, counts, launches)."""
    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
    from ray_tpu_torch.utils.tuned_example import load_tuned_example

    (exp,) = load_tuned_example(CARTPOLE_ACTOR).values()
    algo = algo_from_yaml(CARTPOLE_ACTOR, PPOConfig, model={**exp["config"]["model"], **model})
    policy = algo.get_policy()
    require(policy.device.type == "cuda" and policy.model.is_recurrent
            and all(p.is_cuda for p in policy.params), f"the {phase} policy is not on the card")
    sampler = algo.workers.local_worker().sampler
    n_envs = sampler.env.num_envs
    t0 = time.perf_counter()
    algo.train()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counts = _count_calls(policy, ("compute_actions", "value_batch"))
    before, steps0 = dict(sampler.timers), policy.opt_state.count
    zero_kernel_counts()
    walls, results = [], []
    for _ in range(RECURRENT_CALLS):
        t0 = time.perf_counter()
        results.append(algo.train())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    sampled = {k: sampler.timers[k] - before[k] for k in before}
    act_steps = counts["compute_actions"]
    single_ms = _single_action_round_trip(algo, policy, np.random.default_rng(1))
    launches = read_kernel_counts()
    learner = results[-1]["info"]["learner"]["default_policy"]
    require(all(math.isfinite(v) for v in learner.values()), f"non-finite {phase} stats {learner}")
    T = policy._unroll_T
    rows = sampled["steps"] // RECURRENT_CALLS  # env steps an iteration
    trimmed = (rows // T) * T
    mb, num_mb = policy._nest_shape(trimmed)
    opt_steps = (policy.opt_state.count - steps0) / RECURRENT_CALLS
    require(opt_steps == policy.num_sgd_iter * num_mb,
            f"{opt_steps} optimizer steps a learn, not {policy.num_sgd_iter} x {num_mb}")
    require(act_steps == sampled["steps"] // n_envs,
            f"{act_steps} act calls for {sampled['steps']} env steps of {n_envs} envs")
    learn_s = [r["timers"]["learn_on_batch_s"] - r["info"]["timers"]["default_policy"]["learn_transfer_s"]
               for r in results]
    per_call = {k: round(v / RECURRENT_CALLS, 4) for k, v in sampled.items() if k != "steps"}
    say(phase, env_steps_per_s=json.dumps(spread([rows / w for w in walls])),
        iter_s=json.dumps([round(w, 4) for w in walls]), warm_s=f"{warm_s:.2f}",
        act_ms_per_step=f"{1e3 * sampled['act_s'] / act_steps:.4f}",
        sampler_s_per_iter=json.dumps(per_call), learn_s=json.dumps(spread(learn_s)),
        sample_s=json.dumps(spread([r["timers"]["sample_s"] for r in results])),
        rows_per_learn=trimmed, max_seq_len=T, unrolls_per_learn=trimmed // T,
        minibatch_rows=mb, minibatches=num_mb, optimizer_steps_per_learn=opt_steps,
        gae_bootstraps=counts["value_batch"], single_action_ms=f"{single_ms:.4f}",
        single_action_state_out_bitwise=True, launches=json.dumps(launches),
        episode_reward_mean=results[-1]["episode_reward_mean"])
    say(phase, learner=json.dumps({k: round(v, 6) for k, v in learner.items()}))
    return algo, counts, launches


def phase_lstm_ppo():
    """``_recurrent_ppo`` with ``use_lstm`` at the catalog's defaults
    (fcnet [256, 256], cell 256, max_seq_len 20): no kernel on its path
    (host GAE; the cell's step loop is plain torch, as the reference's is
    XLA)."""
    algo, _, launches = _recurrent_ppo("lstm_ppo", {"use_lstm": True})
    algo.stop()
    require(not any(launches.values()), f"the LSTM path launched kernels: {launches}")
    return launches


def phase_gtrxl_ppo():
    """``_recurrent_ppo`` with ``use_attention`` at the catalog's
    defaults (dim 64, 1 unit, 2 heads of 32, memory 50, MLP 32,
    max_seq_len 20): every act-path forward (the sampler's steps, GAE's
    bootstraps, the single actions and their batch-1 checks) launches row
    5 once a unit, T = 1 against S = 51 keys; the learn path's masked
    attention launches none. Then one act step on the card against the
    same weights on the CPU (the plain version), within 1e-5. Returns
    the flash launches and the policy (for the serve phase)."""
    import torch

    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy

    algo, counts, launches = _recurrent_ppo("gtrxl_ppo", {"use_attention": True})
    algo.stop()
    policy = algo.get_policy()
    units = policy.model.num_transformer_units
    forwards = counts["compute_actions"] + counts["value_batch"]
    flash = launches["flash_attention"]
    require(flash == units * forwards,
            f"{flash} flash launches for {forwards} act-path forwards of {units} unit(s)")
    require(sum(launches.values()) == flash, f"GTrXL's path launched other kernels: {launches}")
    host = PPOTorchPolicy(policy.observation_space, policy.action_space, dict(algo.config),
                          device="cpu")
    host.set_weights(policy.get_weights())
    gen = torch.Generator().manual_seed(2)
    obs = torch.randn(4, 4, generator=gen)
    mem = torch.randn(4, policy.model.memory_len, policy.model.attention_dim, generator=gen)
    with torch.no_grad():
        got = policy._act_forward(obs.cuda(), [mem.cuda()])
        want = host._act_forward(obs, [mem])
    outs = list(zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])))
    err = max(float((g.cpu() - w).abs().max()) for g, w in outs)
    require(all(torch.allclose(g.cpu(), w, atol=1e-5, rtol=1e-5) for g, w in outs),
            f"GTrXL's act step on the card differs from its CPU run by {err}")
    say("gtrxl_ppo", flash_launches=flash, act_path_forwards=forwards, units=units,
        single_action_calls=2 * SINGLE_ACTIONS, card_vs_cpu_max_abs_err=err)
    return flash, policy


def _impala_snapshot(algo):
    lt = algo._learner_thread
    with lt.lock:
        return {"steps": lt.num_steps, "sampled": algo._counters["num_env_steps_sampled"],
                "trained": algo._counters["num_env_steps_trained"], "t": time.perf_counter(),
                **lt.stats()}


VTRACE_WARM_S = 60.0


def _vtrace_window(phase, algo, window_s):
    """``train()`` for ``window_s`` seconds (at least one call) after
    warm calls until the learner has reported stats (they arrive some
    steps late; at most VTRACE_WARM_S): sampled and trained env-steps/s,
    learner steps, the learner's queue wait against its grad time,
    launch counts (from 0 at the window's start)."""
    import torch

    lt = algo._learner_thread
    require(algo.get_policy().device.type == "cuda" and algo.get_policy().model.is_recurrent,
            f"the {phase} learner is not a recurrent policy on the card")
    t0 = time.perf_counter()
    algo.train()
    while not lt.learner_info and time.perf_counter() - t0 < VTRACE_WARM_S:
        algo.train()
    warm_s = time.perf_counter() - t0
    with lt.lock:
        zero_kernel_counts()
    a = _impala_snapshot(algo)
    iters = 0
    while iters == 0 or time.perf_counter() - a["t"] < window_s:
        algo.train()
        iters += 1
    torch.cuda.synchronize()
    b = _impala_snapshot(algo)
    launches = read_kernel_counts()
    wall = b["t"] - a["t"]
    d = {k: b[k] - a[k] for k in ("steps", "sampled", "trained", "queue_wait_time_s",
                                   "grad_time_s")}
    learner = lt.learner_info
    require(lt.healthy() and learner and all(math.isfinite(v) for v in learner.values()),
            f"the {phase} learner is unhealthy or its stats are not finite: {learner}")
    say(phase, window_s=f"{wall:.2f}", warm_s=f"{warm_s:.2f}", iterations=iters,
        env_steps_per_s_sampled=f"{d['sampled'] / wall:.1f}",
        env_steps_per_s_trained=f"{d['trained'] / wall:.1f}", learner_steps=d["steps"],
        queue_wait_time_s=f"{d['queue_wait_time_s']:.4f}", grad_time_s=f"{d['grad_time_s']:.4f}",
        grad_s_per_step=f"{d['grad_time_s'] / max(1, d['steps']):.5f}",
        launches=json.dumps(launches), learner=json.dumps({k: round(v, 6) for k, v in learner.items()}))
    return d


def phase_lstm_impala():
    """cartpole-impala.yaml as written (the local worker on the card, 4
    envs, T = 64, batch 512) with ``use_lstm`` at the catalog's defaults
    for LSTM_IMPALA_WINDOW_S seconds; then cartpole-appo.yaml as written
    (1 remote worker acting on the CPU, T = 50, batch 200) with
    ``use_lstm``, one warm iteration and one timed: the same lines.
    The T + 1 forward of each unroll runs the cell's step loop; no
    kernel is on this path (host V-trace inputs, no frame pool)."""
    from ray_tpu_torch.algorithms.appo.appo import APPOConfig
    from ray_tpu_torch.algorithms.impala.impala import IMPALAConfig

    algo = algo_from_yaml(CARTPOLE_IMPALA, IMPALAConfig, model={"use_lstm": True})
    try:
        d = _vtrace_window("lstm_impala", algo, LSTM_IMPALA_WINDOW_S)
        require(d["steps"] > 0, "the LSTM IMPALA learner took no step")
    finally:
        algo.stop()
    algo = algo_from_yaml(CARTPOLE_APPO, APPOConfig, model={"use_lstm": True})
    try:
        require(algo.workers.num_remote_workers() == 1, "cartpole-appo.yaml runs one worker")
        d = _vtrace_window("lstm_appo", algo, 0.0)
        say("lstm_appo", target_refreshes=algo._counters["num_target_updates"])
    finally:
        algo.stop()


def phase_recurrent_serve(policy):
    """gtrxl_ppo's policy in a ``BatchedPolicyServer`` (greedy): the
    sequential fallback (no program, no capture), RSERVE_REQUESTS
    requests from RSERVE_THREADS client threads, each answer bitwise
    the policy's ``compute_actions`` from the initial state; requests/s,
    latency, and one flash launch a request and unit."""
    import threading

    import numpy as np

    from ray_tpu_torch.serve.policy_server import BatchedPolicyServer

    server = BatchedPolicyServer(policy, name="gtrxl", max_batch_size=RSERVE_THREADS,
                                 explore=False, start=False)
    require(not server.fused and server.warmup() == 0, "a recurrent policy built a program")
    rows = np.random.default_rng(3).uniform(-0.05, 0.05, (RSERVE_REQUESTS, 4)).astype(np.float32)
    answers = [None] * RSERVE_REQUESTS
    zero_kernel_counts()
    server.start()

    def client(k):
        for i in range(k, RSERVE_REQUESTS, RSERVE_THREADS):
            answers[i] = server.submit(rows[i]).result()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(RSERVE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    st = server.stats()
    server.stop()
    launches = read_kernel_counts()["flash_attention"]
    units = policy.model.num_transformer_units
    require(launches == units * RSERVE_REQUESTS,
            f"{launches} flash launches for {RSERVE_REQUESTS} sequential requests")
    init = [s[None] for s in policy.get_initial_state()]
    for row, (action, extra) in zip(rows, answers):
        want, _, want_extra = policy.compute_actions(row[None], init, explore=False)
        require(np.array_equal(action, want[0])
                and all(np.array_equal(extra[k], v[0]) for k, v in want_extra.items()),
                "a served answer differs from compute_actions from the initial state")
    say("recurrent_serve", requests=RSERVE_REQUESTS, threads=RSERVE_THREADS,
        requests_per_s=f"{RSERVE_REQUESTS / wall:.1f}", wall_s=f"{wall:.4f}",
        latency_p50_ms=f"{1e3 * st['latency_p50_s']:.3f}",
        latency_p99_ms=f"{1e3 * st['latency_p99_s']:.3f}",
        mean_batch_rows=f"{st['mean_batch_rows']:.2f}", captures=st["captures"],
        answers_bitwise=True, flash_launches=launches)
    return launches


# offline data and external envs: JSON shards written on the actor lane,
# BC and MARWIL trained from them, CQL and CRR from SAC's Pendulum shards,
# PPO trained through the policy server from an HTTP client thread
OFFLINE_IO_ITERS = 3  # PPO train() calls with output set
OFFLINE_PARITY_LEARNS = 3  # card learns held against a CPU copy, a policy
OFFLINE_BC_ITERS = 15  # timed train() calls of BC and of MARWIL each
OFFLINE_SPLIT_CALLS = 5  # draws and learns timed apart
OFFLINE_SAC_ITERS = 4  # SAC train() calls that write Pendulum shards
OFFLINE_CQL_ITERS = 40  # timed train() calls (one update each) of CQL and CRR
CQL_BC_ITERS = 10
CRR_SYNC_INTERVAL = 10
EXTERNAL_ENV_S = 4.0
# a card learn against the same learn of a CPU copy: float32 reductions
# in other orders, through one Adam step a learn whose size is at most
# about lr per element; a tenth of that step is the parameters' bound,
# and the stats (means over the batch) hold to 1e-4 relative
OFFLINE_PARAM_TOL_LR = 0.1
OFFLINE_STAT_RTOL = 1e-4


def _cpu_twin(policy):
    """A CPU copy of a card policy, state and all."""
    twin = type(policy)(policy.observation_space, policy.action_space, dict(policy.config),
                        device="cpu")
    twin.set_state(copy.deepcopy(policy.get_state()))
    return twin


def _against_cpu(phase, got, want, policy, twin, lr):
    """The card's learn stats and parameters against the CPU copy's:
    the largest parameter difference, required within
    ``OFFLINE_PARAM_TOL_LR * lr``."""
    for k, v in want.items():
        if isinstance(v, float):
            require(abs(got[k] - v) <= OFFLINE_STAT_RTOL * abs(v) + 1e-6,
                    f"{phase}: stat {k} card {got[k]} cpu {v}")
    cw, tw = policy.get_weights(), twin.get_weights()
    diff = max(float(abs(cw[n] - tw[n]).max()) for n in cw)
    require(diff <= OFFLINE_PARAM_TOL_LR * lr, f"{phase}: parameters part by {diff} (lr {lr})")
    return diff


def _equal_columns(got, want):
    keys = {k for k, v in want.items() if v.dtype != object}
    return set(got.keys()) == keys and all(
        got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        and got[k].tobytes() == want[k].tobytes() for k in keys)


def phase_offline_io(tmp):
    """PPO on the port's CartPole-v1 (8 envs x 256 on the local worker,
    which acts on the card; FCNet 256x256, minibatch 256, 4 epochs) with
    ``output`` set, for OFFLINE_IO_ITERS ``train()`` calls: every batch
    the worker's ``sample()`` returned reads back from the shards bitwise
    (the object ``infos`` column dropped). The shards' bytes, and the
    host's JSON encode and decode rates on those batches. Returns the
    shards' directory."""
    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
    from ray_tpu_torch.offline import JsonReader, JsonWriter

    out_dir = os.path.join(tmp, "cartpole")
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=8, rollout_fragment_length=256)
            .training(train_batch_size=2048, sgd_minibatch_size=256, num_sgd_iter=4,
                      model={"fcnet_hiddens": [256, 256]})
            .offline_data(output=out_dir).debugging(seed=0).build())
    try:
        require(algo.get_policy().device.type == "cuda", "offline_io does not act on the card")
        worker = algo.workers.local_worker()
        seen = []
        sample = worker.sampler.sample
        worker.sampler.sample = lambda: seen.append(sample()) or seen[-1]
        zero_kernel_counts()
        t0 = time.perf_counter()
        for _ in range(OFFLINE_IO_ITERS):
            r = algo.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = read_kernel_counts()
        _finite_learner("offline_io", r, ["default_policy"])
    finally:
        algo.stop()
    reader = JsonReader(out_dir, shuffle=False)
    require(len(reader._lines) == len(seen) == OFFLINE_IO_ITERS,
            f"{len(reader._lines)} lines for {len(seen)} samples")
    t0 = time.perf_counter()
    back = [reader.next() for _ in seen]
    decode_s = time.perf_counter() - t0
    require(all(_equal_columns(b, s) for b, s in zip(back, seen)),
            "a shard does not read back bitwise as its sampled batch")
    scratch = os.path.join(tmp, "encode")
    writer = JsonWriter(scratch)
    t0 = time.perf_counter()
    for s in seen:
        writer.write(s)
    encode_s = time.perf_counter() - t0
    writer.close()
    rows = sum(s.count for s in seen)
    shard_bytes = _dir_bytes(out_dir)
    column_bytes = sum(v.nbytes for s in seen for v in s.values() if v.dtype != object)
    say("offline_io", samples=len(seen), rows=rows, shards=len(reader.files),
        shard_bytes=shard_bytes, column_bytes=column_bytes,
        env_steps_per_s=f"{rows / train_s:.1f}", encode_rows_per_s=f"{rows / encode_s:.1f}",
        decode_rows_per_s=f"{rows / decode_s:.1f}", bitwise=True,
        launches=json.dumps(launches))
    return out_dir


def _offline_split(algo, draw):
    """Seconds of ``draw()`` (read, decode, postprocess and concat on the
    host) and of the learn on the card, each summed over
    OFFLINE_SPLIT_CALLS calls."""
    import torch

    policy = algo.get_policy()
    draw_s = learn_s = 0.0
    for _ in range(OFFLINE_SPLIT_CALLS):
        t0 = time.perf_counter()
        batch = draw()
        t1 = time.perf_counter()
        policy.learn_on_batch(batch)
        torch.cuda.synchronize()
        draw_s += t1 - t0
        learn_s += time.perf_counter() - t1
    return draw_s, learn_s


def phase_offline_bc(shards):
    """BC, then MARWIL, from offline_io's shards on the card (the
    defaults: train batch 2000, lr 1e-4, one SGD step a learn; FCNet
    256x256). OFFLINE_PARITY_LEARNS learns each against the same learn
    of a CPU copy (the same batch and permutation; bound above); then
    OFFLINE_BC_ITERS timed ``train()`` calls: updates/s and rows/s, the
    IS and WIS estimates (finite), MARWIL's normaliser; then the split of
    an offline step between the host's draw and the card's learn."""
    import torch

    from ray_tpu_torch.algorithms.marwil.marwil import BCConfig, MARWILConfig

    out = {}
    for name, config in (("bc", BCConfig()), ("marwil", MARWILConfig())):
        algo = (config.environment("CartPole-v1").rollouts(num_rollout_workers=0)
                .training(model={"fcnet_hiddens": [256, 256]})
                .offline_data(input_=shards).debugging(seed=0).build())
        try:
            policy = algo.get_policy()
            require(policy.device.type == "cuda", f"{name} does not learn on the card")
            diffs = []
            for _ in range(OFFLINE_PARITY_LEARNS):
                batch = algo._next_offline_batch()
                twin = _cpu_twin(policy)
                perms = policy.draw_permutations(batch.count)
                got = policy.learn_on_batch(batch, perms=perms)
                want = twin.learn_on_batch(batch, perms=perms.cpu())
                diffs.append(_against_cpu(name, got, want, policy, twin, policy.config["lr"]))
            zero_kernel_counts()
            t0 = time.perf_counter()
            for _ in range(OFFLINE_BC_ITERS):
                r = algo.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = read_kernel_counts()
            info = r["info"]["learner"]["default_policy"]
            est = {k.split("/")[1]: v for k, v in info.items()
                   if k.startswith("off_policy_estimation/")}
            require(set(est) == {"ImportanceSampling", "WeightedImportanceSampling"},
                    f"{name}: estimators {sorted(est)}")
            require(all(math.isfinite(v["v_behavior"]) and math.isfinite(v["v_target"])
                        for v in est.values())
                    and all(math.isfinite(v) for v in info.values() if isinstance(v, float)),
                    f"{name}: non-finite stats {info}")
            draw_s, learn_s = _offline_split(algo, algo._next_offline_batch)
            rows = r["info"]["num_env_steps_trained"]
            say(f"offline_{name}", updates=OFFLINE_BC_ITERS,
                updates_per_s=f"{OFFLINE_BC_ITERS / train_s:.2f}",
                rows_per_s=f"{rows / train_s:.1f}",
                max_param_diff_vs_cpu=json.dumps(diffs), policy_loss=info["policy_loss"],
                estimates=json.dumps({k: {m: round(x, 5) for m, x in v.items()}
                                      for k, v in est.items()}),
                ma_sqd_adv_norm=info.get("moving_average_sqd_adv_norm"),
                draw_ms=f"{1e3 * draw_s / OFFLINE_SPLIT_CALLS:.3f}",
                learn_ms=f"{1e3 * learn_s / OFFLINE_SPLIT_CALLS:.3f}",
                launches=json.dumps(launches))
            out[name] = OFFLINE_BC_ITERS / train_s
        finally:
            algo.stop()
    return out


def phase_offline_cql_crr(tmp):
    """SAC writes Pendulum-v1 shards with learning held off (the
    reference's ``_pendulum_offline_data``, at 5 envs x 200 on the local
    worker on the card, OFFLINE_SAC_ITERS ``train()`` calls; its replay
    inserts launch the row scatter, required, and its ring then holds the
    row gather and scatter against their plain versions at the 1000-row
    insert: ``_ring_kernels``); CQL (``bc_iters``
    CQL_BC_ITERS) and CRR (``weight_type`` "bin", a hard sync every
    CRR_SYNC_INTERVAL updates) at SAC's defaults (256x256, batch 256)
    each take OFFLINE_CQL_ITERS timed updates from them: finite losses,
    CQL's warmup flag 1 for its first CQL_BC_ITERS updates and 0 after,
    updates/s, the split of a step between the host's draw and the
    card's learn; then one update of each against a CPU copy with the
    card's draws (bound above). Returns the SAC writer's scatter
    launches."""
    import torch

    from ray_tpu_torch.algorithms.cql.cql import CQLConfig
    from ray_tpu_torch.algorithms.crr.crr import CRRConfig
    from ray_tpu_torch.algorithms.sac.sac import SACConfig
    from ray_tpu_torch.offline import JsonReader
    from ray_tpu_torch.offline.offline_ops import sample_offline_batch

    shards = os.path.join(tmp, "pendulum")
    sac = (SACConfig().environment("Pendulum-v1")
           .rollouts(num_rollout_workers=0, num_envs_per_worker=5, rollout_fragment_length=200)
           .training(num_steps_sampled_before_learning_starts=10 ** 9)
           .offline_data(output=shards).debugging(seed=0).build())
    try:
        zero_kernel_counts()
        for _ in range(OFFLINE_SAC_ITERS):
            sac.train()
        writer_launches = read_kernel_counts()
        _ring_kernels("offline_sac_writer", "default_policy",
                      sac.local_replay_buffer.buffers["default_policy"], 256, 1000, False)
    finally:
        sac.stop()
    require(writer_launches["scatter_rows"] > 0, "the SAC writer's inserts launched no row scatter")
    rows = JsonReader(shards).read_all().count
    require(rows == OFFLINE_SAC_ITERS * 1000, f"{rows} Pendulum rows written")
    for name, config in (
        ("cql", CQLConfig().training(bc_iters=CQL_BC_ITERS)),
        ("crr", CRRConfig().training(target_update_grad_intervals=CRR_SYNC_INTERVAL)),
    ):
        algo = (config.environment("Pendulum-v1").rollouts(num_rollout_workers=0)
                .offline_data(input_=shards).debugging(seed=0).build())
        try:
            policy = algo.get_policy()
            require(policy.device.type == "cuda", f"{name} does not learn on the card")
            zero_kernel_counts()
            infos = []
            t0 = time.perf_counter()
            for _ in range(OFFLINE_CQL_ITERS):
                infos.append(algo.train()["info"]["learner"]["default_policy"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = read_kernel_counts()
            require(all(math.isfinite(v) for i in infos for v in i.values()),
                    f"{name}: non-finite stats {infos[-1]}")
            extra = {}
            if name == "cql":
                flags = [i["in_bc_warmup"] for i in infos]
                want = [1.0] * CQL_BC_ITERS + [0.0] * (OFFLINE_CQL_ITERS - CQL_BC_ITERS)
                require(flags == want, f"cql: warmup flags {flags}")
                extra = dict(cql_penalty=infos[-1]["cql_penalty"], warmup_flips_at=CQL_BC_ITERS)
            else:
                extra = dict(mean_weight=infos[-1]["mean_weight"],
                             syncs=OFFLINE_CQL_ITERS // CRR_SYNC_INTERVAL)
            bsize = int(algo.config["train_batch_size"])
            draw_s, learn_s = _offline_split(algo, lambda: sample_offline_batch(
                algo._reader, bsize, require_next_obs=True))
            batch = sample_offline_batch(algo._reader, bsize, require_next_obs=True, seed=1)
            twin = _cpu_twin(policy)
            draws = policy.draw_update(bsize)
            got = policy.learn_on_batch(batch, draws=draws)
            want = twin.learn_on_batch(batch, draws=tuple(d.cpu() for d in draws))
            lr = policy.config["optimization"]["critic_learning_rate"]
            diff = _against_cpu(name, got, want, policy, twin, lr)
            say(f"offline_{name}", updates=OFFLINE_CQL_ITERS,
                updates_per_s=f"{OFFLINE_CQL_ITERS / train_s:.2f}",
                critic_loss=infos[-1]["critic_loss"], actor_loss=infos[-1]["actor_loss"],
                max_param_diff_vs_cpu=diff, draw_ms=f"{1e3 * draw_s / OFFLINE_SPLIT_CALLS:.3f}",
                learn_ms=f"{1e3 * learn_s / OFFLINE_SPLIT_CALLS:.3f}",
                launches=json.dumps(launches), **extra)
        finally:
            algo.stop()
    say("offline_sac_writer", rows=rows, shard_bytes=_dir_bytes(shards),
        launches=json.dumps(writer_launches))
    return writer_launches["scatter_rows"]


def _external_client(address, stop, counts):
    """An external env process's loop in a thread: the port's CartPole-v1
    driven through a ``PolicyClient`` until ``stop``; env steps,
    episodes and each GET_ACTION's seconds into ``counts``."""
    from ray_tpu_torch.env.cartpole import CartPoleEnv
    from ray_tpu_torch.env.policy_client import PolicyClient

    env = CartPoleEnv()
    client = PolicyClient(address, timeout=60)
    seed = 0
    try:
        while not stop.is_set():
            obs, _ = env.reset(seed=seed)
            seed += 1
            eid = client.start_episode()
            done = trunc = False
            while not done:
                t0 = time.perf_counter()
                action = client.get_action(eid, obs)
                counts["get_action_s"].append(time.perf_counter() - t0)
                obs, reward, term, trunc, _ = env.step(int(action))
                client.log_returns(eid, reward)
                counts["steps"] += 1
                done = term or trunc
            client.end_episode(eid, obs, truncated=trunc)
            counts["episodes"] += 1
    except (RuntimeError, OSError) as e:
        if not stop.is_set():
            counts["error"] = repr(e)


def phase_external_env():
    """PPO with no env: its local worker's input is a
    ``PolicyServerInput`` on 127.0.0.1 (an ephemeral port), whose
    actions come from the policy on the card; a ``PolicyClient`` thread
    drives the port's CartPole-v1 over HTTP while ``train()`` runs for
    EXTERNAL_ENV_S seconds (batch 1000, minibatch 250, 4 epochs, FCNet
    64x64): env-steps/s through the server, the episodes the client ended
    and the ones the server reported, GET_ACTION's p50 and p99, finite
    stats; ``stop()`` shuts the server and the client thread ends."""
    import threading

    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
    from ray_tpu_torch.env.policy_server_input import PolicyServerInput
    from ray_tpu_torch.env.spaces import Box, Discrete

    algo = (PPOConfig()
            .environment(None, observation_space=Box(-np.inf, np.inf, (4,)),
                         action_space=Discrete(2))
            .rollouts(num_rollout_workers=0)
            .training(train_batch_size=1000, sgd_minibatch_size=250, num_sgd_iter=4, lr=1e-3,
                      model={"fcnet_hiddens": [64, 64]})
            .offline_data(input_=lambda ioctx: PolicyServerInput(ioctx, "127.0.0.1", 0))
            .debugging(seed=0).build())
    stop = threading.Event()
    counts = {"steps": 0, "episodes": 0, "get_action_s": []}
    server = algo.workers.local_worker().input_reader
    client = threading.Thread(target=_external_client, daemon=True,
                              args=(f"127.0.0.1:{server.port}", stop, counts))
    results = []
    try:
        require(server.policy.device.type == "cuda", "the server's policy is not on the card")
        zero_kernel_counts()
        client.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < EXTERNAL_ENV_S:
            results.append(algo.train())
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_kernel_counts()
        steps = counts["steps"]
        require(steps > 0, "the client took no step")
    finally:
        stop.set()
        algo.stop()
        client.join(timeout=60)
    require(not client.is_alive(), "the client thread outlived the server")
    require("error" not in counts, f"the client failed: {counts.get('error')}")
    _finite_learner("external_env", results[-1], ["default_policy"])
    reported = sum(r["episodes_this_iter"] for r in results)
    require(results[-1]["timesteps_total"] >= 1000 * len(results) and reported > 0,
            f"{results[-1]['timesteps_total']} steps, {reported} episodes reported")
    lat = sorted(counts["get_action_s"])
    say("external_env", iterations=len(results), env_steps=steps,
        env_steps_per_s=f"{steps / elapsed:.1f}", trained_steps=results[-1]["timesteps_total"],
        episodes_client=counts["episodes"], episodes_reported=reported,
        get_action_p50_ms=f"{1e3 * _pct(lat, 50):.3f}", get_action_p99_ms=f"{1e3 * _pct(lat, 99):.3f}",
        episode_reward_mean=results[-1]["episode_reward_mean"], launches=json.dumps(launches))
    return steps / elapsed


# the Algorithm's own surface: checkpoints of the actor lane and of DQN's
# device replay, evaluation workers with callbacks, the evaluate CLI
CARTPOLE_ACTOR = os.path.join(REPO, "tuned_examples", "ppo", "cartpole-ppo.yaml")
EVAL_DURATION, CLI_EPISODES, CLI_TIMEOUT_S = 5, 3, 300


def _tree_mismatches(a, b, path="state"):
    """The paths where two checkpoint state trees differ (arrays by
    their bytes, filters by their statistics, everything else by ==)."""
    import numpy as np

    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [path]
        return [m for k in a for m in _tree_mismatches(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return [] if (a.dtype, a.shape, a.tobytes()) == (b.dtype, b.shape, b.tobytes()) else [path]
    if hasattr(a, "rs"):
        same = all(getattr(a.rs, f).tobytes() == getattr(b.rs, f).tobytes() for f in ("mean_", "s"))
        return [] if same and a.rs.num == b.rs.num else [path]
    if type(a).__name__.endswith("Filter"):
        return [] if type(a) is type(b) else [path]
    return [] if a == b else [path]


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def phase_ckpt_ppo(tmp):
    """ponglite-ppo.yaml as written (2 worker processes x 8 PongLite-v0
    envs, the bf16 Nature CNN, frame-pool fragments): one ``train()``,
    ``save()`` into ``tmp/ckpts/checkpoint_000001``,
    ``Algorithm.from_checkpoint(path)``; every parameter, Adam
    moment, count, coefficient and counter bitwise equal to the
    original's; each remote worker's weights bitwise the learner's right
    after the restore; ``compute_single_action(explore=False)`` on 8
    seeded frames the same on both (and the first frame's logits,
    bitwise); then one ``train()`` of the restored
    algorithm, counted: it must launch the row gather (its frame pool)
    and give finite stats; that algorithm saved as
    ``tmp/newer/checkpoint_000002``. Save and load seconds, checkpoint
    bytes. Returns the gather launches, the root and the newer
    checkpoint (the serve phase's)."""
    import numpy as np

    from ray_tpu_torch import core as ray_core
    from ray_tpu_torch.algorithms.algorithm import Algorithm

    algo, back = ppo_from_yaml(ACTOR_TUNED), None
    root = os.path.join(tmp, "ckpts")
    try:
        algo.train()
        t0 = time.perf_counter()
        path = algo.save(os.path.join(root, "checkpoint_000001"))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = Algorithm.from_checkpoint(path)
        load_s = time.perf_counter() - t0
        bad = _tree_mismatches(algo.__getstate__(), back.__getstate__())
        require(not bad, f"ckpt_ppo: restored state differs at {bad[:5]}")
        require(back.iteration == algo.iteration == 1, "ckpt_ppo: iteration not restored")
        policy = back.get_policy()
        require(policy.device.type == "cuda" and all(p.is_cuda for p in policy.params),
                "ckpt_ppo: the restored learner is not on the card")
        learner = back.workers.local_worker().get_weights()
        remote = ray_core.get([w.get_weights.remote() for w in back.workers.remote_workers()])
        require(len(remote) == 2 and all(not _tree_mismatches(learner, r) for r in remote),
                "ckpt_ppo: a remote worker's weights differ from the learner's after the restore")
        frames = np.random.default_rng(7).integers(0, 256, (8, H, W, C), dtype=np.uint8)
        acts = [(int(algo.compute_single_action(f, explore=False)),
                 int(back.compute_single_action(f, explore=False))) for f in frames]
        require(all(a == b for a, b in acts), f"ckpt_ppo: greedy actions differ {acts}")
        logits = [p.compute_single_action(frames[0], explore=False)[2]["action_dist_inputs"]
                  for p in (algo.get_policy(), policy)]
        require(logits[0].tobytes() == logits[1].tobytes(), "ckpt_ppo: greedy logits differ")
        zero_kernel_counts()
        r = back.train()
        counts = read_kernel_counts()
        _finite_learner("ckpt_ppo", r, ["default_policy"])
        require(counts["gather_rows"] >= 1, f"ckpt_ppo: the resumed learn launched no row gather {counts}")
        newer = back.save(os.path.join(tmp, "newer", "checkpoint_000002"))
        say("ckpt_ppo", save_s=f"{save_s:.3f}", load_s=f"{load_s:.3f}", bytes=_dir_bytes(path),
            state_bitwise=True, remote_weights_bitwise=len(remote),
            greedy_actions=json.dumps([a for a, _ in acts]),
            resumed_loss=f"{r['info']['learner']['default_policy']['total_loss']:.6f}",
            launches=json.dumps(counts))
        return counts["gather_rows"], root, newer
    finally:
        algo.stop()
        if back is not None:
            back.stop()


def phase_ckpt_dqn():
    """:func:`dqn_config` on the device lane, filled as :func:`dqn_filled`
    fills it, trained until its superstep slot is captured, then
    ``save()``; ``restore()`` into that same algorithm (its graph
    captured before: the rings and the tree are written in place) and
    ``from_checkpoint`` into a fresh one, counted: ring rows, sum-tree
    leaves and ``max_priority`` bitwise the saved ones; then the first
    graphed update of the restored algorithm (one replay of its captured
    slot) against an eager update of the fresh one on the same draws,
    bitwise in stats, parameters, Adam moments, target, trees and
    generators (``graph_parity``'s method; not counted); then one
    ``train()`` of each, counted. Save and load seconds, bytes,
    launches."""
    from ray_tpu_torch.algorithms.algorithm import Algorithm

    algo, back = dqn_filled(), None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        pa = algo.get_policy()
        for _ in range(4):
            algo.train()
            if any(r.graph is not None for r in pa._superstep_runners.values()):
                break
        (runner,) = pa._superstep_runners.values()
        require(runner.graph is not None, "ckpt_dqn: the superstep slot was not captured")
        K = runner.k_max
        ba = algo.local_replay_buffer.buffers["default_policy"]
        rings = {k: v.data_ptr() for k, v in ba._store.items()}
        trees = (ba._dtree.sum_value.data_ptr(), ba._dtree.min_value.data_ptr())
        t0 = time.perf_counter()
        path = algo.save(os.path.join(tmp, "checkpoint_000001"))
        save_s = time.perf_counter() - t0
        saved = algo.__getstate__()
        zero_kernel_counts()
        t0 = time.perf_counter()
        algo.restore(path)
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = Algorithm.from_checkpoint(path)
        load_s = time.perf_counter() - t0
        restore_counts = read_kernel_counts()
        for what, other in (("same", algo), ("fresh", back)):
            bad = _tree_mismatches(saved, other.__getstate__())
            require(not bad, f"ckpt_dqn: {what} restore differs at {bad[:5]}")
        require({k: v.data_ptr() for k, v in ba._store.items()} == rings
                and (ba._dtree.sum_value.data_ptr(), ba._dtree.min_value.data_ptr()) == trees,
                "ckpt_dqn: the restore replaced the rings the captured graph reads")
        rb = saved["replay_buffer"]["default_policy"]
        n = _graphed_update_equals_eager("ckpt_dqn", algo, back)
        zero_kernel_counts()
        infos = [a.train()["info"]["learner"] for a in (algo, back)]
        counts = read_kernel_counts()
        for info in infos:
            stats = info.get("default_policy", {})
            require(all(math.isfinite(v) for v in stats.values()), f"ckpt_dqn: non-finite {stats}")
        require(all(counts[k] >= 1 for k in ("gather_rows", "scatter_rows", "find_prefixsum")),
                f"ckpt_dqn: the resumed rounds missed a kernel {counts}")
        require(restore_counts["scatter_rows"] >= 1, f"ckpt_dqn: the restore scattered nothing {restore_counts}")
        say("ckpt_dqn", superstep_k=K, ring_rows=rb["size"], save_s=f"{save_s:.3f}",
            restore_same_s=f"{restore_s:.3f}", load_fresh_s=f"{load_s:.3f}", bytes=_dir_bytes(path),
            rings_in_place=True, graphed_equals_eager=True, tensors=n,
            restore_launches=json.dumps(restore_counts), train_on_launches=json.dumps(counts))
        return {k: restore_counts[k] + counts[k] for k in counts}
    finally:
        algo.stop()
        if back is not None:
            back.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def _graphed_update_equals_eager(phase, algo, back):
    """The first update after a restore: one replay of ``algo``'s captured
    superstep slot against an eager update of ``back`` (restored from the
    same state) on the same draws, bitwise in stats, parameters, Adam
    moments, target, trees and generators; the number of tensors
    compared. Its launches are not a path's: the caller sets the counts
    to 0 after it."""
    import torch

    from ray_tpu_torch.execution.train_ops import superstep_train_replay

    pa, pb = algo.get_policy(), back.get_policy()
    (runner,) = pa._superstep_runners.values()
    require(runner.graph is not None, f"{phase}: the superstep slot was not captured")
    K = runner.k_max
    ba = algo.local_replay_buffer.buffers["default_policy"]
    bb = back.local_replay_buffer.buffers["default_policy"]
    bb._rng.bit_generator.state = ba._rng.bit_generator.state
    pb.perm_generator.set_state(pa.perm_generator.get_state())
    pb.action_generator.set_state(pa.action_generator.get_state())
    idx, weights = bb.draw_prioritized_sets_device(1, K, TRAIN_BATCH, 0.4)
    tree = bb._gather_columns(idx[0])
    tree["weights"] = weights[0]
    eager = pb.learn_on_device_batch(tree, TRAIN_BATCH)
    with torch.no_grad():
        td = torch.abs(pb._td_error(tree, pb.aux_state)[0]).cpu().numpy()
    bb.update_priorities(idx[0], td + 1e-6)
    replays = runner.replays
    graphed = superstep_train_replay(algo, pa, ba, 1, K, TRAIN_BATCH, prioritized=True, beta=0.4)
    require(runner.replays == replays + 1, f"{phase}: the first update after the restore was not a replay")
    require(graphed == eager, f"{phase}: graphed {graphed} != eager {eager}")
    pairs = _lane_pairs(pa, None, pb, None)
    pairs += [("sum tree", ba._dtree.sum_value, bb._dtree.sum_value),
              ("min tree", ba._dtree.min_value, bb._dtree.min_value)]
    pairs += [("target", x, y) for x, y in zip(pa.aux_state["target_params"], pb.aux_state["target_params"])]
    n = _graph_equal(phase, pairs)
    require(ba._max_priority == bb._max_priority, f"{phase}: max priority differs")
    return n


# -- fault tolerance on the training loop ------------------------------------------

CHAOS_WORKERS, CHAOS_ITERS = 4, 4
CHAOS_FAULTS = {
    "kill_worker": [{"worker_index": 2, "on_call": 2}, {"worker_index": 3, "on_call": 2}],
    "nan_batch": {"on_learn_call": 2},
}
CHAOS_COUNTS = {"failures": 1, "worker_restarts": 2, "recoveries": {"workers": 1},
                "skipped_batches": 1}
STREAM_RESTORES, STREAM_CHECKED_SNAPSHOTS, STREAM_DEADLINE_S = 2, 3, 120.0
STREAM_CRASH_STEP = 3
RESTORE_DQN_CRASH_CALL = 3


def _learner_tensors(policy):
    return [t.detach().clone() for t in policy._learner_tensors()]


def _guarded_slot_on_card():
    """The nan guard's graphed slot on the card: two PPO policies of one
    seed (FCNet 64x64, CartPole's spaces); one learns two stacked
    supersteps of K = 2 (the first captures the slot, the second, whose
    second batch the fault injector poisoned, replays it), the other the
    same clean updates eagerly, slot 4's permutations drawn and dropped.
    Parameters and Adam moments bitwise equal, the poisoned slot
    skipped. Returns the number of tensors compared."""
    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete
    from ray_tpu_torch.resilience.faults import FaultInjector

    cfg = {"seed": 0, "model": {"fcnet_hiddens": [64, 64]}, "lr": 1e-3, "train_batch_size": 256,
           "sgd_minibatch_size": 64, "num_sgd_iter": 2, "kl_coeff": 0.0, "nan_guard": True}
    space, acts = Box(-10, 10, (4,), np.float32), Discrete(2)
    pg, pe = (PPOTorchPolicy(space, acts, cfg) for _ in range(2))
    gen = np.random.default_rng(3)
    batches = [{
        "obs": gen.standard_normal((256, 4)).astype(np.float32),
        "actions": gen.integers(0, 2, 256), "action_logp": np.full(256, -0.69, np.float32),
        "action_dist_inputs": gen.standard_normal((256, 2)).astype(np.float32),
        "advantages": gen.standard_normal(256).astype(np.float32),
        "value_targets": gen.standard_normal(256).astype(np.float32),
    } for _ in range(4)]
    inj = FaultInjector({"nan_batch": {"on_learn_call": 4}})
    for b in batches:
        inj.on_learn(b)
    require(not np.isfinite(batches[3]["obs"]).all(), "guarded_slot: the injector poisoned nothing")
    dev = [{c: torch.as_tensor(v).to(pg.device) for c, v in b.items()} for b in batches]
    skipped = []
    for pair in (dev[:2], dev[2:]):
        stacked = {c: torch.stack([d[c] for d in pair]) for c in pair[0]}
        skipped += pg.learn_superstep(2, 256, stacked=stacked, k_max=2)[2]
    (runner,) = pg._superstep_runners.values()
    require(runner.graph is not None and runner.replays >= 2,
            f"guarded_slot: the poisoned slot was no replay ({runner.replays} replays)")
    require(skipped == [False, False, False, True], f"guarded_slot: skipped {skipped}")
    for i, d in enumerate(dev):
        perms = pe.draw_permutations(256)
        if i < 3:
            pe.learn_on_device_batch(d, 256, perms=perms)
    return _graph_equal("guarded_slot", _lane_pairs(pg, None, pe, None))


def phase_chaos_ppo():
    """ponglite-ppo.yaml's learner (PongLite-v0 frame pools, the bf16 Nature
    CNN at full width, lr, clip, entropy) with these cuts named: 4 rollout
    worker processes x 8 envs, T = 32, a 1024-step train batch, 2 epochs;
    ``recreate_failed_workers``, ``nan_guard`` and a fault spec that kills
    workers 2 and 3 at their 2nd sample call (one recreate starts both
    replacements together) and poisons the 2nd learn batch. CHAOS_ITERS
    ``train()`` calls, counted: the recovery counts (the reference's run
    of the same spec on CartPole-v1, tests/test_torch_resilience.py's
    ``test_chaos_ppo_counts_equal_the_reference_run[same_call]``), the
    replacements numbered as their dead workers, the fleet back at 4 and every worker
    answering a probe, the skipped learn leaving the parameters and Adam
    moments on the card bitwise as they were, finite stats, row-gather
    launches (one a pooled learn). Then the graphed slot's guard
    (:func:`_guarded_slot_on_card`). Replacement seconds: a recreate
    until every replacement answers a ping."""
    from ray_tpu_torch import core as ray_core

    algo = ppo_from_yaml(ACTOR_TUNED, num_workers=CHAOS_WORKERS, rollout_fragment_length=32,
                         train_batch_size=1024, num_sgd_iter=2, recreate_failed_workers=True,
                         nan_guard=True, max_failures=10, fault_injection=CHAOS_FAULTS)
    try:
        ws = algo.workers
        real = ws.recreate_failed_workers
        replace_s = []

        def recreate():
            t0 = time.perf_counter()
            n = real()
            ray_core.get([w.ping.remote() for w in ws.remote_workers()[-n:]], timeout=300)
            replace_s.append(time.perf_counter() - t0)
            return n

        ws.recreate_failed_workers = recreate
        policy = algo.get_policy()
        zero_kernel_counts()
        walls, results, skipped_same = [], [], None
        for i in range(CHAOS_ITERS):
            before = _learner_tensors(policy) if i == 1 else None
            t0 = time.perf_counter()
            results.append(algo.train())
            walls.append(time.perf_counter() - t0)
            if before is not None:
                skipped_same = all(a.equal(b) for a, b in zip(before, _learner_tensors(policy)))
        counts = read_kernel_counts()
        rec = results[-1]["info"]["recovery"]
        got = {k: rec[k] for k in CHAOS_COUNTS}
        require(got == CHAOS_COUNTS, f"chaos_ppo: recovery counts {got} != {CHAOS_COUNTS}")
        require(skipped_same, "chaos_ppo: the skipped learn changed the learner on the card")
        require(results[1]["info"]["num_nan_batches_skipped"] == 1, "chaos_ppo: no batch skipped")
        require(ws.num_remote_workers() == CHAOS_WORKERS and ws.probe_unhealthy_workers() == [],
                "chaos_ppo: the fleet is not back to full health")
        reports = ws.foreach_worker(_actor_report)[1:]
        indices = sorted(r["worker_index"] for r in reports)
        require(indices == list(range(1, CHAOS_WORKERS + 1)),
                f"chaos_ppo: worker indices {indices} (a replacement takes its dead worker's)")
        require(not any(r["cuda_initialized"] for r in reports),
                "chaos_ppo: a rollout worker initialised CUDA")
        for r in results[2:]:
            _finite_learner("chaos_ppo", r, ["default_policy"])
        # the skipped learn (iteration 2) leaves the previous learn's timers
        pooled = sum(int(r["info"]["timers"]["default_policy"]["learn_frame_pool"])
                     for i, r in enumerate(results) if i != 1)
        require(counts["gather_rows"] >= 1 and counts["gather_rows"] == pooled,
                f"chaos_ppo: {counts['gather_rows']} row gathers for {pooled} pooled learns")
        slot_tensors = _guarded_slot_on_card()
        say("chaos_ppo", workers=CHAOS_WORKERS, iter_s=json.dumps([round(w, 3) for w in walls]),
            replacement_s=json.dumps([round(t, 3) for t in replace_s]),
            time_lost_s=rec["time_lost_s"], recovery=json.dumps(got),
            skipped_learn_bitwise=True, guarded_slot_bitwise=slot_tensors,
            launches=json.dumps(counts))
        return counts["gather_rows"]
    finally:
        algo.stop()


def phase_stream_impala():
    """bench_e2e.py's ``_impala_pong`` geometry (:func:`impala_config`:
    PongLite-v0 frame pools, 2 workers x 8 envs, T = 64, batch 1024, the
    bf16 Nature CNN) with ``checkpoint_streaming`` (a capture every
    round) and ``restore_on_failure``; once a learner thread has learned,
    it is armed with ``crash_learner_thread`` at its STREAM_CRASH_STEP-th
    step from then (the rebuilt thread too), for STREAM_RESTORES
    restores. Checks: each
    of the first STREAM_CHECKED_SNAPSHOTS snapshots, written by the writer
    thread while the learner thread trains on, is bitwise the state the
    capture saw (read under the learner's lock); the parameters right
    after each restore are the restored snapshot's, bitwise; the card's
    allocated memory after the second restore is no more than after the
    first (each read after the restore's new thread started); the learn
    path's row gathers counted. Reports the capture's main-thread ms a
    round (with the learner's lock wait), the restore seconds and the
    snapshot lag."""
    import gc
    import pickle

    import torch

    from ray_tpu_torch.algorithms.impala.impala import IMPALAConfig
    from ray_tpu_torch.resilience.faults import FaultInjector

    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    algo = impala_config(
        IMPALAConfig, checkpoint_streaming=True, checkpoint_root=tmp, restore_on_failure=True,
        max_failures=5,
    ).build()
    try:
        st = algo._ckpt_streamer
        seen = {}
        real_capture = st._capture

        def capture():
            header, tensors = real_capture()
            if len(seen) < STREAM_CHECKED_SNAPSHOTS:
                # under the learner's lock: the state the copies saw
                seen[header["superstep"]] = pickle.loads(pickle.dumps(algo.get_policy().get_state()))
            return header, tensors

        st._capture = capture
        restores = []
        real_restore = algo._recovery.restore_latest

        def restore_latest():
            t0 = time.perf_counter()
            path = real_restore()
            dt = time.perf_counter() - t0
            with open(path, "rb") as f:
                snap = pickle.load(f)["policy_states"]["default_policy"]
            bad = _tree_mismatches(snap, algo.get_policy().get_state())
            require(not bad, f"stream_impala: the restore differs from its snapshot at {bad[:5]}")
            restores.append({"path": os.path.basename(path), "restore_s": round(dt, 4)})
            return path

        algo._recovery.restore_latest = restore_latest
        # each captured snapshot against its capture's state, on the writer
        # thread just after it is written (before the pruning takes it)
        checked, mismatched = [], []
        real_prune = st._prune

        def prune():
            for superstep, state in list(seen.items()):
                path = os.path.join(st.root, f"snapshot_{superstep:010d}.pkl")
                if superstep in checked or not os.path.exists(path):
                    continue
                with open(path, "rb") as f:
                    snap = pickle.load(f)["policy_states"]["default_policy"]
                checked.append(superstep)
                mismatched.extend(_tree_mismatches(snap, state)[:5])
            real_prune()

        st._prune = prune
        memory = []
        real_recovery = algo.on_recovery

        def arm():
            # the thread counts every step call, idle polls of its queue
            # too (as the reference's), so it is armed once it learns
            algo._learner_thread._fault_injector = FaultInjector(
                {"crash_learner_thread": {"on_step": STREAM_CRASH_STEP}})

        def on_recovery(kind):
            real_recovery(kind)
            gc.collect()
            torch.cuda.synchronize()
            memory.append(torch.cuda.memory_allocated())

        algo.on_recovery = on_recovery
        zero_kernel_counts()
        deadline = time.perf_counter() + STREAM_DEADLINE_S
        rounds, armed = 0, 0
        while len(restores) < STREAM_RESTORES and time.perf_counter() < deadline:
            steps = algo._learner_thread.num_steps
            r = algo.train()
            rounds += 1
            if armed == len(restores) and algo._learner_thread.num_steps > steps:
                arm()
                armed += 1
        with algo._learner_thread.lock:
            counts = read_kernel_counts()
        require(len(restores) == STREAM_RESTORES, f"stream_impala: {len(restores)} restores in {rounds} iterations")
        stats = r["info"]["recovery"]
        require(stats["recoveries"] == {"restore": STREAM_RESTORES}, f"stream_impala: {stats['recoveries']}")
        require(memory[1] <= memory[0], f"stream_impala: memory after the restores {memory}")
        require(st.flush(60) and st.error is None, f"stream_impala: the writer failed {st.error}")
        st._capture, st._prune = real_capture, real_prune
        require(not mismatched, f"stream_impala: a snapshot differs from its capture at {mismatched}")
        # a capture replaced while pending is never written
        require(len(checked) >= 1, f"stream_impala: no snapshot was checked against its capture {seen.keys()}")
        require(counts["gather_rows"] >= 1, f"stream_impala: the learn path gathered nothing {counts}")
        ms, wait = list(st.capture_ms), list(st.lock_wait_ms)
        stream = st.stats()
        say("stream_impala", iterations=rounds, restores=json.dumps(restores),
            memory_after_restores=json.dumps(memory), snapshots_checked_bitwise=len(checked),
            capture_ms=json.dumps(spread(ms)), lock_wait_ms=json.dumps(spread(wait)),
            copy_ms=json.dumps(spread([a - b for a, b in zip(ms, wait)])), captures=len(ms),
            snapshots_written=stream["snapshots_written"], lag_supersteps=stream["lag_supersteps"],
            launches=json.dumps(counts))
        return counts["gather_rows"]
    finally:
        algo.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_restore_dqn():
    """:func:`dqn_config` (prioritized DQN on the PongLite device lane,
    full width, K = auto) with ``checkpoint_frequency`` 1 (kept: 2),
    ``restore_on_failure`` and ``crash_learner`` at the replay phase's
    RESTORE_DQN_CRASH_CALL-th learn call. Filled to learning starts, then
    trained until the crash: the restore of the newest periodic
    checkpoint writes the rings and the sum tree in place (their storage
    unchanged under the captured slot's graph; the state bitwise the
    checkpoint's), and the first update after it, one replay of the
    captured slot, is bitwise an eager update of a fresh algorithm
    restored from the same checkpoint (:func:`_graphed_update_equals_eager`,
    not counted); the crash's iteration (its restore and the retried
    round) counted: row scatters and prefix descents on the restored rings
    and tree. Restore seconds."""
    import pickle

    from ray_tpu_torch.algorithms.algorithm import Algorithm

    tmp = tempfile.mkdtemp(prefix="chip_smoke_restore_")
    cfg = dqn_config().fault_tolerance(
        checkpoint_frequency=1, checkpoint_root=tmp, keep_checkpoints_num=2,
        restore_on_failure=True, max_failures=3,
        fault_injection={"crash_learner": {"on_learn_call": RESTORE_DQN_CRASH_CALL}})
    algo, back = cfg.build(), None
    try:
        # the fill (learning starts at 1000 steps), then learn calls up to
        # the one before the crash
        while algo._fault_injector._learn_calls < RESTORE_DQN_CRASH_CALL - 1:
            algo.train()
        pa = algo.get_policy()
        require(any(r.graph is not None for r in pa._superstep_runners.values()),
                "restore_dqn: the superstep slot was not captured before the crash")
        ba = algo.local_replay_buffer.buffers["default_policy"]
        rings = {k: v.data_ptr() for k, v in ba._store.items()}
        trees = (ba._dtree.sum_value.data_ptr(), ba._dtree.min_value.data_ptr())
        checks = {}
        real_recovery = algo.on_recovery

        def on_recovery(kind):
            nonlocal back
            real_recovery(kind)
            restored = read_kernel_counts()
            path = algo._recovery.latest_checkpoint
            with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
                saved = pickle.load(f)
            bad = _tree_mismatches(saved, algo.__getstate__())
            require(not bad, f"restore_dqn: the restore differs from its checkpoint at {bad[:5]}")
            require({k: v.data_ptr() for k, v in ba._store.items()} == rings
                    and (ba._dtree.sum_value.data_ptr(), ba._dtree.min_value.data_ptr()) == trees,
                    "restore_dqn: the restore replaced the rings the captured graph reads")
            back = Algorithm.from_checkpoint(path)
            checks["tensors"] = _graphed_update_equals_eager("restore_dqn", algo, back)
            checks["path"] = os.path.basename(path)
            zero_kernel_counts()
            for k, v in restored.items():
                setattr(next(c for c in kernel_counters() if c.__name__ == k), "launches", v)

        algo.on_recovery = on_recovery
        zero_kernel_counts()
        t0 = time.perf_counter()
        r = algo.train()
        wall = time.perf_counter() - t0
        counts = read_kernel_counts()
        rec = r["info"]["recovery"]
        require(rec["recoveries"] == {"restore": 1} and rec["failures"] == 1,
                f"restore_dqn: recovery {rec}")
        require("tensors" in checks, "restore_dqn: the crash was not recovered")
        _finite_learner("restore_dqn", r, ["default_policy"])
        require(counts["scatter_rows"] >= 1 and counts["find_prefixsum"] >= 1,
                f"restore_dqn: the restore and the retried round missed a kernel {counts}")
        say("restore_dqn", restored_from=checks["path"], restore_s=rec["time_lost_s"],
            crash_iteration_s=f"{wall:.3f}", rings_in_place=True, graphed_equals_eager=True,
            tensors=checks["tensors"], launches=json.dumps(counts))
        return counts
    finally:
        algo.stop()
        if back is not None:
            back.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_evaluate(ckpt_dir):
    """cartpole-ppo.yaml (its model: FCNet 256x256; the local worker acts
    on the card) with ``evaluation_interval: 1``, ``evaluation_num_workers:
    1`` and ``evaluation_duration: 5`` and a callbacks class that records
    ``custom_metrics`` and marks the result: two ``train()`` calls, each
    with at least 5 evaluation episodes, ``custom_metrics/<k>_mean|min|max``
    and the callbacks' mark in the result; the evaluation's seconds; then
    a checkpoint into ``ckpt_dir`` for the evaluate CLI."""
    from ray_tpu_torch.algorithms.callbacks import DefaultCallbacks

    class SmokeCallbacks(DefaultCallbacks):
        # defined here: plain pickle refuses a local class, so it reaches
        # the evaluation worker by value (core/serialization.py)
        def on_episode_step(self, *, episode=None, **kwargs):
            episode.user_data["steps"] = episode.user_data.get("steps", 0) + 1

        def on_episode_end(self, *, episode=None, **kwargs):
            episode.custom_metrics["steps"] = float(episode.user_data["steps"])

        def on_train_result(self, *, result=None, **kwargs):
            result["smoke_callbacks"] = result["training_iteration"]

    algo = ppo_from_yaml(CARTPOLE_ACTOR, evaluation_interval=1, evaluation_num_workers=1,
                         evaluation_duration=EVAL_DURATION, callbacks_class=SmokeCallbacks)
    try:
        require(algo.get_policy().device.type == "cuda", "the evaluate phase does not learn on the card")
        require(algo.evaluation_workers.num_remote_workers() == 1, "no evaluation worker")
        eval_s, real = [], algo.evaluate

        def timed_evaluate():
            t0 = time.perf_counter()
            out = real()
            eval_s.append(round(time.perf_counter() - t0, 3))
            return out

        algo.evaluate = timed_evaluate
        results = [algo.train() for _ in range(2)]
        for i, r in enumerate(results, 1):
            ev = r.get("evaluation", {})
            require(ev.get("episodes_this_iter", 0) >= EVAL_DURATION,
                    f"evaluate: iteration {i} has {ev.get('episodes_this_iter')} evaluation episodes")
            cm = r.get("custom_metrics", {})
            require({"steps_mean", "steps_min", "steps_max"} <= set(cm), f"evaluate: custom metrics {cm}")
            require(cm["steps_mean"] == r["episode_len_mean"], "evaluate: custom metric != episode length")
            require(r.get("smoke_callbacks") == i, "evaluate: on_train_result's mark is missing")
        path = algo.save(ckpt_dir)
        last = results[-1]
        say("evaluate", evaluation_s=json.dumps(eval_s),
            evaluation_episodes=json.dumps([r["evaluation"]["episodes_this_iter"] for r in results]),
            evaluation_reward_mean=json.dumps([r["evaluation"]["episode_reward_mean"] for r in results]),
            custom_metrics=json.dumps(last["custom_metrics"]),
            episode_reward_mean=last["episode_reward_mean"], iter_s=json.dumps(
                [round(r["time_this_iter_s"], 3) for r in results]))
        return path
    finally:
        algo.stop()


def phase_evaluate_cli(ckpt_dir):
    """``python -m ray_tpu_torch.evaluate <the evaluate phase's checkpoint>
    --run PPO --env CartPole-v1 --episodes 3`` as a subprocess on the
    card: exit 0 and its JSON line last."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.evaluate", ckpt_dir, "--run", "PPO", "--env",
         "CartPole-v1", "--episodes", str(CLI_EPISODES)],
        cwd=REPO, capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
    )
    wall = time.perf_counter() - t0
    require(proc.returncode == 0, f"evaluate CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    require(out.get("episodes") == CLI_EPISODES and math.isfinite(out.get("mean_reward", math.nan)),
            f"evaluate CLI printed {out}")
    say("evaluate_cli", wall_s=f"{wall:.2f}", result=json.dumps(out))


# serving: the ponglite-ppo.yaml checkpoint behind the batched
# server, a torso server, replica actors on the card and the front door
SERVE_MAX_BATCH = 32
SERVE_CLIENTS = 64
SERVE_WINDOW_S = 6.0
SERVE_TORSO_WINDOW_S = 3.0  # 4 before PR 23
INGRESS_CLIENTS = 16
INGRESS_WINDOW_S = 4.0
INGRESS_BURST = 64
INGRESS_TIGHT_INFLIGHT = 8
REPLICA_TIMEOUT_S = 180
# vectorized (one batched body) against exact (batch-1 bodies) extras
SERVE_VEC_RTOL, SERVE_VEC_ATOL = 1e-5, 1e-6


def _pct(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values), q)) if values else None


def _closed_loop(call, make_input, clients, window_s, on_half=None):
    """``clients`` threads calling ``call(make_input(client, i))`` for
    ``window_s`` seconds; ``on_half()`` once, half-way. Returns
    ``(requests/s, [latency s], [(client, i, result)], [errors])``."""
    import threading

    stop = threading.Event()
    lock = threading.Lock()
    lat, results, errors = [], [], []

    def client(c):
        i = 0
        while not stop.is_set():
            x = make_input(c, i)
            t0 = time.perf_counter()
            try:
                out = call(x)
            except Exception as e:  # every failure is a dropped request
                with lock:
                    errors.append(repr(e))
                return
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                results.append((c, i, out))
            i += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if on_half is not None:
        time.sleep(window_s / 2)
        on_half()
        time.sleep(window_s / 2)
    else:
        time.sleep(window_s)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "a serving client did not finish")
    return len(lat) / wall, lat, results, errors


def _server_line(st):
    keys = ("requests_total", "batches_total", "mean_batch_rows", "batch_fill_fraction",
            "latency_p50_s", "latency_p99_s", "queue_wait_p50_s", "queue_wait_p99_s",
            "captures", "captures_after_warmup", "params_version")
    return {k: st.get(k) for k in keys}


def phase_serve(root, newer):
    """The ckpt_ppo phase's checkpoint (ponglite-ppo.yaml's bf16 Nature
    CNN on 84x84x4 uint8 frames, 6 actions) behind an in-process
    ``PolicyDeployment`` on the card: max batch 32 (buckets 1-32, one
    CUDA graph each, captured at warmup), greedy. 32 seeded frames as one
    bucket against 32 sequential ``compute_actions`` of the same
    checkpoint restored again: actions and every extra bitwise. Then
    SERVE_CLIENTS client threads for SERVE_WINDOW_S seconds; half-way, the
    newer checkpoint lands in the watched root (one rename): every
    request answered, each client's versions non-decreasing, the last
    version 2, one reload. Requests/s, client latency p50/p99, the
    server's latency and queue-wait p50/p99, mean batch rows, fill,
    captures at and after warmup."""
    import numpy as np
    import torch

    from ray_tpu_torch.serve.policy_server import PolicyDeployment, restore_policy

    zero_kernel_counts()
    t0 = time.perf_counter()
    dep = PolicyDeployment(root, name="ponglite", max_batch_size=SERVE_MAX_BATCH,
                           poll_interval_s=0.2)
    start_s = time.perf_counter() - t0
    try:
        server = dep.server
        require(server.policy.device.type == "cuda", "serve: the policy is not on the card")
        require(server.captures == len(server.buckets) == 6
                and all(p.graph is not None for p in server._programs.values()),
                f"serve: {server.captures} captures at warmup for buckets {server.buckets}")
        frames = np.random.default_rng(14).integers(0, 256, (64, H, W, C), dtype=np.uint8)
        ref = restore_policy(root)[0]
        futs = server.submit_many(list(frames[:32]), explore=False)
        got = [f.result(60.0) for f in futs]
        for j, (a, ex) in enumerate(got):
            a_ref, _, ex_ref = ref.compute_actions(frames[j][None], explore=False)
            require(a.tobytes() == a_ref[0].tobytes()
                    and all(ex[k].tobytes() == v[0].tobytes() for k, v in ex_ref.items()),
                    f"serve: request {j} of a 32-row bucket differs from a batch-1 call")
        del ref
        torch.cuda.empty_cache()

        def land():
            staged = os.path.join(os.path.dirname(root), "landing")
            shutil.copytree(newer, staged)
            os.rename(staged, os.path.join(root, "checkpoint_000002"))

        rate, lat, results, errors = _closed_loop(
            lambda x: dep(x), lambda c, i: {"obs": frames[(c + i) % len(frames)]},
            SERVE_CLIENTS, SERVE_WINDOW_S, on_half=land)
        st = dep.stats()
        require(not errors, f"serve: {len(errors)} requests failed: {errors[:3]}")
        versions = {}
        for c, i, out in sorted(results):
            require(out["params_version"] >= versions.get(c, 1),
                    f"serve: client {c}'s versions went back")
            versions[c] = out["params_version"]
        require(st["reload"]["num_reloads"] == 1 and st["params_version"] == 2
                and max(versions.values()) == 2,
                f"serve: the hot reload did not land ({st['reload']}, {st['params_version']})")
        require(st["captures_after_warmup"] == 0, f"serve: captured after warmup {st['captures']}")
        say("serve", start_s=f"{start_s:.2f}", requests=len(lat), requests_per_s=f"{rate:.1f}",
            client_p50_ms=f"{_pct(lat, 50) * 1e3:.3f}", client_p99_ms=f"{_pct(lat, 99) * 1e3:.3f}",
            parity_rows=32, parity_bitwise=True, reloads=st["reload"]["num_reloads"],
            dropped=len(errors), server=json.dumps(_server_line(st)),
            hbm_headroom=f"{st['device']['hbm_headroom']:.4f}",
            launches=json.dumps(read_kernel_counts()))
    finally:
        dep.stop()


def phase_serve_torso():
    """A torso policy at the transformer phases' width (d_model 256, 4
    layers, 8 heads of 32, ff 1024, 8 tokens; Box(64), Discrete(8)) in a
    ``BatchedPolicyServer`` on the card, exploring, max batch 32: exact
    mode (a graph of batch-1 bodies a bucket) driven by 32 client threads
    for SERVE_TORSO_WINDOW_S seconds; its flash launches must equal the
    policy's signature forward (one) and the warmup's eager runs (one a
    bucket), plus layers x bucket a replay. 16 requests bitwise
    against sequential exploring ``compute_actions`` of a policy of the
    same seed. Then the vectorized server: the same window, and its
    extras within 1e-5 relative of the exact server's on 32 rows. The
    launches are counted from zero before the exact server is built."""
    import numpy as np

    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete
    from ray_tpu_torch.serve.policy_server import BatchedPolicyServer

    def policy():
        return PPOTorchPolicy(Box(-1, 1, (TF_OBS,), np.float32), Discrete(TF_ACTIONS),
                              {"seed": 0, "model": dict(TORSO)})

    layers = TORSO["transformer_num_layers"]
    obs = np.random.default_rng(15).standard_normal((64, TF_OBS)).astype(np.float32)
    ref = policy()
    want = [ref.compute_actions(o[None], explore=True) for o in obs[:16]]
    out = {}
    zero_kernel_counts()
    expected = 0
    for vectorized in (False, True):
        server = BatchedPolicyServer(policy(), max_batch_size=SERVE_MAX_BATCH, explore=True,
                                     vectorized=vectorized, start=False)
        server.warmup()
        server.start()
        try:
            if not vectorized:
                futs = [server.submit(o) for o in obs[:16]]
                for j, f in enumerate(futs):
                    a, ex = f.result(60.0)
                    a_ref, _, ex_ref = want[j]
                    require(a.tobytes() == a_ref[0].tobytes()
                            and all(ex[k].tobytes() == v[0].tobytes() for k, v in ex_ref.items()),
                            f"serve_torso: request {j} differs from a sequential call")
            rate, lat, _, errors = _closed_loop(
                lambda x: server.submit(x).result(60.0), lambda c, i: obs[(c * 7 + i) % 64],
                32, SERVE_TORSO_WINDOW_S)
        finally:
            server.stop()
        require(not errors, f"serve_torso: {errors[:3]}")
        st = server.stats()
        require(st["captures_after_warmup"] == 0, "serve_torso: captured after warmup")
        per_replay = {b: layers * (1 if vectorized else b) for b in server.buckets}
        replayed = sum(per_replay[b] * p.replays for (b, _), p in server._programs.items())
        # the eager run before each capture, and the one forward of a zero
        # observation that gives the policy's act signature (its draws' shapes)
        warm = sum(per_replay.values()) + layers
        expected += warm + replayed
        launches = read_kernel_counts()["flash_attention"]
        require(launches == expected,
                f"serve_torso: {launches} flash launches, not {expected} ({warm} eager + "
                f"{replayed} replayed in the {'vectorized' if vectorized else 'exact'} server)")
        name = "vectorized" if vectorized else "exact"
        say("serve_torso", mode=name, requests_per_s=f"{rate:.1f}",
            client_p50_ms=f"{_pct(lat, 50) * 1e3:.3f}", client_p99_ms=f"{_pct(lat, 99) * 1e3:.3f}",
            flash_per_replay=json.dumps(per_replay), server=json.dumps(_server_line(st)))
        out[name] = server
    # exact against vectorized on one bucket of 32 rows, greedy (no draw)
    a_e, ex_e = out["exact"].forward_padded(obs[:32], explore=False)
    a_v, ex_v = out["vectorized"].forward_padded(obs[:32], explore=False)
    for k in ex_e:
        require(np.allclose(ex_v[k], ex_e[k], rtol=SERVE_VEC_RTOL, atol=SERVE_VEC_ATOL),
                f"serve_torso: vectorized {k} beyond {SERVE_VEC_RTOL} relative of exact")
    logits = np.sort(ex_e["action_dist_inputs"], axis=-1)
    clear = logits[:, -1] - logits[:, -2] > SERVE_VEC_RTOL * np.abs(logits[:, -1]) + SERVE_VEC_ATOL
    require((a_e[clear] == a_v[clear]).all(), "serve_torso: vectorized actions differ")
    worst = max(float(np.max(np.abs(ex_v[k] - ex_e[k]))) for k in ex_e)
    say("serve_torso", sequential_bitwise=16, flash_launches=launches,
        vectorized_max_abs_err=f"{worst:.3g}", vectorized_actions_equal=int((a_e == a_v).sum()))
    return launches


def phase_serve_replicas(root):
    """``serve.run(policy_deployment(root, num_replicas=2))``: two
    replica actors of the port's runtime, which keeps the card visible
    in them (``init(worker_env={"RAY_TPU_WORKER_PLATFORM": "cuda"})``),
    each restoring the checkpoint on the card and capturing its graphs.
    32 requests through the handle; one replica killed: at most 2 calls
    fail, the controller's health pass replaces it, and the replacement
    answers. Start and replacement seconds. Returns the deployment's
    name for the ingress phase (left running, with the serve core's
    per-request HTTP proxy)."""
    import numpy as np

    from ray_tpu_torch import core as ray_core
    from ray_tpu_torch.serve import serve
    from ray_tpu_torch.serve.policy_server import policy_deployment

    ray_core.shutdown()
    ray_core.init(num_cpus=2, worker_env={"RAY_TPU_WORKER_PLATFORM": "cuda"})
    t0 = time.perf_counter()
    handle = serve.run(policy_deployment(
        root, name="pong", max_batch_size=SERVE_MAX_BATCH, watch=False,
        autoscaling_config={"min_replicas": 2, "max_replicas": 2, "interval_s": 0.25,
                            "health_check_interval_s": 0.5, "stats_timeout_s": 60.0}),
        http_host="127.0.0.1")
    running = serve.get_running("pong")
    stats = ray_core.get([r.stats.remote() for r in running.replicas], timeout=REPLICA_TIMEOUT_S)
    start_s = time.perf_counter() - t0
    for st in stats:
        require(st["captures"] == 6 and st["captures_after_warmup"] == 0
                and st["device"] is not None, f"serve_replicas: a replica reported {st}")
    frames = np.random.default_rng(16).integers(0, 256, (32, H, W, C), dtype=np.uint8)
    outs = ray_core.get([handle.remote({"obs": f}) for f in frames], timeout=REPLICA_TIMEOUT_S)
    require(all(0 <= o["action"] < NUM_ACTIONS and o["params_version"] == 1 for o in outs),
            f"serve_replicas: answers {outs[:3]}")
    victim = running.replicas[0]
    t0 = time.perf_counter()
    ray_core.kill(victim)
    failures = 0
    for f in frames[:8]:
        try:
            ray_core.get(handle.remote({"obs": f}), timeout=REPLICA_TIMEOUT_S)
        except ray_core.RayActorError:
            failures += 1
    require(failures <= 2, f"serve_replicas: {failures} calls failed after the kill")
    deadline = time.time() + REPLICA_TIMEOUT_S
    while time.time() < deadline and running.num_replaced < 1:
        time.sleep(0.1)
    require(running.num_replaced >= 1, "serve_replicas: the killed replica was not replaced")
    fresh = [r for r in running.replicas if r is not victim]
    stats = ray_core.get([r.stats.remote() for r in fresh], timeout=REPLICA_TIMEOUT_S)
    replace_s = time.perf_counter() - t0
    require(len(fresh) == 2 and all(s["captures_after_warmup"] == 0 for s in stats),
            "serve_replicas: the membership after the replacement is wrong")
    outs = ray_core.get([handle.remote({"obs": f}) for f in frames[:8]], timeout=REPLICA_TIMEOUT_S)
    say("serve_replicas", replicas=2, start_s=f"{start_s:.2f}", failed_after_kill=failures,
        replaced=running.num_replaced, replace_s=f"{replace_s:.2f}",
        answers_after=len(outs), hbm_headroom=json.dumps(
            [round(s["device"]["hbm_headroom"], 4) for s in stats]))
    return "pong"


def phase_ingress(name):
    """``PolicyIngress`` over real sockets in front of the serve_replicas
    phase's two replica actors (``serve_deployment``: one coalescing
    router over the controller's membership feed): INGRESS_CLIENTS
    keep-alive HTTP clients posting 84x84x4 frames for INGRESS_WINDOW_S
    seconds (requests/s, latency p50/p99, mean merged rows). The same
    clients and frames through the serve core's per-request HTTP proxy
    (one replica-actor call a request) for the same window: the A/B that
    the reference holds to a 4x bar (printed, not required; the same
    greedy actions are required), and the host's cost to decode one
    frame's JSON body, which bounds both paths' rate. Then an
    overload burst of INGRESS_BURST concurrent requests at the same
    router mounted behind an in-flight budget of INGRESS_TIGHT_INFLIGHT:
    the shed count (429/503 with Retry-After), and every request
    answered 200 or shed. Stops the ingress, the deployment and the
    runtime."""
    import http.client
    import threading

    import numpy as np

    from ray_tpu_torch import core as ray_core
    from ray_tpu_torch.ingress import AdmissionController, PolicyIngress
    from ray_tpu_torch.serve import serve

    frames = np.random.default_rng(17).integers(0, 256, (16, H, W, C), dtype=np.uint8)
    bodies = [json.dumps({"obs": f.tolist()}).encode() for f in frames]
    ingress = PolicyIngress(max_inflight=256).start()
    try:
        ingress.serve_deployment(name, max_batch_size=SERVE_MAX_BATCH, batch_wait_timeout_s=0.002)
        router, _ = ingress._policies[name]
        ingress.add_policy("tight", router, AdmissionController(max_inflight=INGRESS_TIGHT_INFLIGHT))
        local = threading.local()
        proxy_port = serve.http_port()

        def post(port, path, body):
            # one keep-alive connection a thread and port (the proxy
            # answers HTTP/1.0 and closes; http.client opens anew)
            conns = local.__dict__.setdefault("conns", {})
            if port not in conns:
                conns[port] = http.client.HTTPConnection(ingress.host, port,
                                                         timeout=REPLICA_TIMEOUT_S)
            conn = conns[port]
            conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, resp.getheader("Retry-After"), data

        def call(body):
            status, _, data = post(ingress.port, f"/v1/policy/{name}/actions", body)
            require(status == 200, f"ingress: status {status} {data[:200]}")
            return json.loads(data)

        def call_proxy(body):
            status, _, data = post(proxy_port, f"/{name}", body)
            require(status == 200, f"ingress: the proxy answered {status} {data[:200]}")
            return json.loads(data)["result"]

        rate, lat, results, errors = _closed_loop(
            call, lambda c, i: bodies[(c + i) % len(bodies)], INGRESS_CLIENTS, INGRESS_WINDOW_S)
        require(not errors, f"ingress: {len(errors)} requests failed: {errors[:3]}")
        require(all(0 <= out["action"] < NUM_ACTIONS for _, _, out in results),
                "ingress: an action out of range")
        rst = router.stats()
        proxy_rate, proxy_lat, _, errors = _closed_loop(
            call_proxy, lambda c, i: bodies[(c + i) % len(bodies)], INGRESS_CLIENTS,
            INGRESS_WINDOW_S)
        require(not errors, f"ingress: {len(errors)} proxy requests failed: {errors[:3]}")
        same = [call(b)["action"] == call_proxy(b)["action"] for b in bodies]
        require(all(same), f"ingress: the front door and the proxy disagree on {same.count(False)} "
                "greedy actions")
        decode_s = []
        for b in bodies:
            t0 = time.perf_counter()
            np.asarray(json.loads(b)["obs"], np.uint8)
            decode_s.append(time.perf_counter() - t0)
        say("ingress", ab_clients=INGRESS_CLIENTS, batched_requests_per_s=f"{rate:.1f}",
            per_request_proxy_requests_per_s=f"{proxy_rate:.1f}",
            ratio=f"{rate / proxy_rate:.3f}", reference_bar=4.0,
            meets_bar=rate >= 4.0 * proxy_rate,
            proxy_p50_ms=f"{_pct(proxy_lat, 50) * 1e3:.3f}",
            proxy_p99_ms=f"{_pct(proxy_lat, 99) * 1e3:.3f}", greedy_actions_equal=len(same),
            body_bytes=len(bodies[0]), decode_ms_p50=f"{_pct(decode_s, 50) * 1e3:.3f}")
        statuses, retry = [], []
        lock = threading.Lock()
        gate = threading.Barrier(INGRESS_BURST)

        def burst(i):
            gate.wait()
            conn = http.client.HTTPConnection(ingress.host, ingress.port, timeout=REPLICA_TIMEOUT_S)
            conn.request("POST", "/v1/policy/tight/actions", body=bodies[i % len(bodies)],
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            with lock:
                statuses.append(resp.status)
                if resp.status in (429, 503):
                    retry.append(resp.getheader("Retry-After"))
            conn.close()

        threads = [threading.Thread(target=burst, args=(i,)) for i in range(INGRESS_BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=REPLICA_TIMEOUT_S)
        shed = [s for s in statuses if s in (429, 503)]
        require(len(statuses) == INGRESS_BURST and statuses.count(200) + len(shed) == INGRESS_BURST
                and shed and all(r for r in retry),
                f"ingress: the overload burst answered {sorted(set(statuses))}")
        say("ingress", clients=INGRESS_CLIENTS, requests=len(lat), requests_per_s=f"{rate:.1f}",
            p50_ms=f"{_pct(lat, 50) * 1e3:.3f}", p99_ms=f"{_pct(lat, 99) * 1e3:.3f}",
            mean_merged_rows=f"{rst['mean_merged_rows']:.2f}", replicas=rst["replicas"],
            burst=INGRESS_BURST, served=statuses.count(200), shed=len(shed),
            shed_by_status=json.dumps({s: statuses.count(s) for s in sorted(set(shed))}))
    finally:
        ingress.stop()
        serve.shutdown()
        ray_core.shutdown()


BANK_WORKERS = 2
BANK_CLIENTS = 8
BANK_WINDOW_S = 2.0
BANK_FRAMES = 16
BANK_TIMEOUT_S = 180


class _BankFeed:
    """The bank's membership: one local replica a worker (a static
    controller feed the supervisor forwards)."""

    def current(self):
        return 1, ["local"]


def _bank_worker_init(root, ctx):
    """An ingress bank worker's init, inside the spawned worker: the
    checkpoint root restored into a ``BatchedPolicyServer`` on the card
    (its bucket graphs captured at warmup), mounted behind a router over
    a ``LocalReplica`` that follows the forwarded membership; the cold
    start's split and the worker's counters shipped home on its
    heartbeat (``extra_stats``). Raises where the card is out of reach:
    the bank then fails to start."""
    t0 = time.time()
    import torch

    from ray_tpu_torch.ingress import CoalescingRouter, LocalReplica
    from ray_tpu_torch.serve.policy_server import BatchedPolicyServer, restore_policy
    from ray_tpu_torch.telemetry import fleetview

    t_import = time.time()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_ctx = time.time()
    policy, prep, obs_filter, _ = restore_policy(root)
    require(policy.device.type == "cuda", f"ingress_bank: a worker restored onto {policy.device}")
    t_restore = time.time()
    server = BatchedPolicyServer(policy, name="pong", max_batch_size=SERVE_MAX_BATCH,
                                 explore=False, obs_filter=obs_filter, preprocessor=prep,
                                 start=False)
    server.warmup()
    torch.cuda.synchronize()
    t_warm = time.time()
    server.start()
    feed = ctx.membership("pong")
    router = CoalescingRouter("pong", membership=feed, wrap=lambda m, i: LocalReplica(server),
                              max_batch_size=SERVE_MAX_BATCH, batch_wait_timeout_s=0.002)
    ctx.ingress.add_policy("pong", router)
    split = {"init_imports_s": t_import - t0, "cuda_context_s": t_ctx - t_import,
             "restore_s": t_restore - t_ctx, "warmup_captures_s": t_warm - t_restore}

    def extra():
        st = server.stats()
        return {"split": split, "captures": st["captures"],
                "captures_after_warmup": st["captures_after_warmup"],
                "served": st["requests_total"], "device": str(policy.device),
                "allocated_mb": torch.cuda.memory_allocated() / 2 ** 20,
                "reserved_mb": torch.cuda.memory_reserved() / 2 ** 20,
                "membership_version": feed.current()[0],
                "merged": fleetview.render_installed() is not None}

    ctx.ingress.extra_stats = extra


def _bank_scrape(url, path="/metrics"):
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=30) as r:
        return r.status, r.read().decode()


def _actions_200(text):
    """``{host: count}`` of the merged text's answered action requests."""
    out = {}
    for line in text.splitlines():
        if line.startswith("ray_tpu_ingress_requests_total{") and 'route="actions"' in line \
                and 'status="200"' in line:
            host = line.split('host="', 1)[1].split('"', 1)[0]
            out[host] = out.get(host, 0.0) + float(line.rsplit(" ", 1)[1])
    return out


def _wait_for(cond, what, timeout=BANK_TIMEOUT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"ingress_bank: {what} within {timeout} s")


def phase_ingress_bank(root):
    """The front-door fleet on the card (module docstring). Returns the
    kernel counts of its client window."""
    import functools
    import http.client
    import signal
    import threading
    import urllib.error

    import numpy as np
    import torch

    from ray_tpu_torch.ingress import IngressSupervisor
    from ray_tpu_torch.serve.policy_server import BatchedPolicyServer, restore_policy
    from ray_tpu_torch.telemetry import metrics as catalog

    require(torch.cuda.is_initialized(), "ingress_bank: this process holds no CUDA context")
    frames = np.random.default_rng(14).integers(0, 256, (64, H, W, C), dtype=np.uint8)[:BANK_FRAMES]
    bodies = [json.dumps({"obs": f.tolist(), "explore": False}).encode() for f in frames]
    policy, prep, obs_filter, _ = restore_policy(root)
    local = BatchedPolicyServer(policy, name="pong_local", max_batch_size=SERVE_MAX_BATCH,
                                explore=False, obs_filter=obs_filter, preprocessor=prep)
    try:
        want = [int(f.result(60.0)[0]) for f in local.submit_many(list(frames), explore=False)]
    finally:
        local.stop()
    del policy, local
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the card's free memory before and after the bank came up: what the
    # workers hold, CUDA contexts included (nvidia-smi lists no process
    # inside the machine's sandbox)
    free0 = torch.cuda.mem_get_info()[0]
    respawns0 = catalog.counter_total(catalog.INGRESS_WORKER_RESPAWNS_TOTAL)
    sup = IngressSupervisor(num_workers=BANK_WORKERS,
                            worker_init=functools.partial(_bank_worker_init, root),
                            heartbeat_s=0.25, metrics_interval_s=0.5)
    sup.follow_membership("pong", feed=_BankFeed())
    t0 = time.perf_counter()
    sup.start(timeout_s=BANK_TIMEOUT_S)
    start_s = time.perf_counter() - t0
    try:
        stats = _wait_for(lambda: (lambda st: st if all(v is not None and v["extra"]
                                                        for v in st.values()) else None)(
            sup.worker_stats()), "a heartbeat from each worker")
        pids = sup.worker_pids()
        require(sorted(v["pid"] for v in stats.values()) == sorted(pids),
                f"ingress_bank: heartbeat pids {[v['pid'] for v in stats.values()]} != {pids}")
        bank_mb = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 20
        path = "/v1/policy/pong/actions"
        tls = threading.local()

        def post(body, fresh=False):
            conn = None if fresh else getattr(tls, "conn", None)
            if conn is None:
                conn = http.client.HTTPConnection(sup.host, sup.port, timeout=BANK_TIMEOUT_S)
                if not fresh:
                    tls.conn = conn
            conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if fresh:
                conn.close()
            require(resp.status == 200, f"ingress_bank: status {resp.status} {data[:200]}")
            return json.loads(data)

        zero_kernel_counts()
        answers = 0
        # fresh connections first: the kernel spreads them over the bank
        for rnd in range(2):
            for i, b in enumerate(bodies):
                require(post(b, fresh=True)["action"] == want[i],
                        f"ingress_bank: frame {i} answered unlike the in-process server")
                answers += 1
        rate, lat, results, errors = _closed_loop(
            lambda i: (i, post(bodies[i])), lambda c, i: (c + i) % BANK_FRAMES, BANK_CLIENTS,
            BANK_WINDOW_S)
        launches = read_kernel_counts()
        require(not errors, f"ingress_bank: {len(errors)} requests failed: {errors[:3]}")
        require(all(out["action"] == want[i] for _, _, (i, out) in results),
                "ingress_bank: a greedy action differs from the in-process server's")
        answers += len(results)

        def served_by_both():
            st = sup.worker_stats()
            return st if all(v["extra"]["served"] > 0 for v in st.values()) else None

        # where the kernel gave one worker every connection, fresh ones
        # until both have served (their heartbeats report it)
        time.sleep(4 * sup.heartbeat_s)
        for rnd in range(10):
            if served_by_both():
                break
            for i, b in enumerate(bodies):
                require(post(b, fresh=True)["action"] == want[i],
                        f"ingress_bank: frame {i} answered unlike the in-process server")
                answers += 1
            time.sleep(4 * sup.heartbeat_s)
        stats = _wait_for(served_by_both, "answers from both workers")

        def merged_counts():
            text = _bank_scrape(sup.url)[1]
            counts = _actions_200(text)
            return (text, counts) if (set(counts) == {"ingress-w0", "ingress-w1"}
                                      and sum(counts.values()) == answers) else None

        text, counts = _wait_for(merged_counts, f"a merged /metrics summing {answers} answers")
        for i, v in stats.items():
            require(v["extra"]["captures_after_warmup"] == 0 and v["extra"]["captures"] == 6
                    and v["extra"]["device"].startswith("cuda"),
                    f"ingress_bank: worker {i} reported {v['extra']}")
        boots = {}
        for i, v in sorted(stats.items()):
            b, x = v["boot"], v["extra"]
            boots[i] = {"pid": v["pid"],
                        "process_start_and_import_s": round(b["entered_at"] - b["spawned_at"], 4),
                        "init_imports_s": round(x["split"]["init_imports_s"], 4),
                        "cuda_context_s": round(x["split"]["cuda_context_s"], 4),
                        "restore_s": round(x["split"]["restore_s"], 4),
                        "warmup_captures_s": round(x["split"]["warmup_captures_s"], 4),
                        "bind_s": round(b["ready_at"] - b["init_done_at"], 4),
                        "total_s": round(b["ready_at"] - b["spawned_at"], 4),
                        "allocated_mb": round(x["allocated_mb"], 1),
                        "reserved_mb": round(x["reserved_mb"], 1)}
        say("ingress_bank", workers=BANK_WORKERS, start_s=f"{start_s:.2f}", clients=BANK_CLIENTS,
            requests=len(lat), requests_per_s=f"{rate:.1f}",
            p50_ms=f"{_pct(lat, 50) * 1e3:.3f}", p99_ms=f"{_pct(lat, 99) * 1e3:.3f}",
            greedy_bitwise=answers, served_by_worker=json.dumps(
                {i: v["extra"]["served"] for i, v in sorted(stats.items())}),
            merged_actions_200=json.dumps(counts), captures_after_warmup=0,
            launches=json.dumps(launches))
        for i, b in boots.items():
            say("ingress_bank", cold_start_worker=i, **{k: json.dumps(v) for k, v in b.items()})
        say("ingress_bank", bank_device_mb=f"{bank_mb:.1f}",
            per_worker_device_mb=f"{bank_mb / BANK_WORKERS:.1f}")
        # one worker SIGKILLed: the replacement converges onto the bank
        victim = pids[0]
        t0 = time.perf_counter()
        os.kill(victim, signal.SIGKILL)

        def replaced():
            st = sup.worker_stats()[0]
            return (st if sup.respawned_total >= 1 and sup.num_live() == BANK_WORKERS
                    and st is not None and st["pid"] != victim and st["extra"]
                    and st["extra"]["membership_version"] == 1 and st["extra"]["merged"]
                    else None)

        fresh = _wait_for(replaced, "a replacement with the forwarded membership and metrics")
        respawn_s = time.perf_counter() - t0
        posts = 0
        while sup.worker_stats()[0]["extra"]["served"] == 0:
            require(posts < 400, "ingress_bank: the replacement never answered")
            i = posts % BANK_FRAMES
            require(post(bodies[i], fresh=True)["action"] == want[i],
                    f"ingress_bank: frame {i} answered unlike the in-process server after the respawn")
            posts += 1
        fresh = sup.worker_stats()[0]
        require(catalog.counter_total(catalog.INGRESS_WORKER_RESPAWNS_TOTAL) == respawns0 + 1
                and sup.respawned_total == 1, "ingress_bank: the respawn was not counted")
        require(fresh["extra"]["captures_after_warmup"] == 0,
                f"ingress_bank: the replacement captured after warmup {fresh['extra']}")
        b, x = fresh["boot"], fresh["extra"]
        say("ingress_bank", respawned_pid=fresh["pid"], killed_pid=victim,
            respawn_s=f"{respawn_s:.2f}", respawns_counted=sup.respawned_total,
            membership_version=x["membership_version"], merged_text=x["merged"],
            posts_until_answer=posts + 1,
            cold_start=json.dumps({"process_start_and_import_s": round(b["entered_at"] - b["spawned_at"], 4),
                                   **{k: round(v, 4) for k, v in x["split"].items()},
                                   "total_s": round(b["ready_at"] - b["spawned_at"], 4)}))
        sup.drain(grace_s=5.0)
        time.sleep(0.5)
        codes = []
        for _ in range(8):  # fresh connections: the whole bank
            try:
                codes.append(_bank_scrape(sup.url, "/healthz")[0])
            except urllib.error.HTTPError as e:
                codes.append(e.code)
        require(codes == [503] * 8, f"ingress_bank: healthz after drain() answered {codes}")
        say("ingress_bank", drained=True, healthz=json.dumps(codes))
        return launches
    finally:
        sup.stop()


SURFACE_TOL = 1.5e-5  # the port's learn contract
SURFACE_ITERS = 2  # train() calls of each exploration run


def _surface_policies():
    """(name, action space, model config) of the model_surface phase's
    three PPO policies."""
    from ray_tpu_torch.env.spaces import MultiBinary, MultiDiscrete

    return [("multi_discrete", MultiDiscrete([3, 4, 5]), {"fcnet_hiddens": [64, 64]}),
            ("multi_binary", MultiBinary(6), {"custom_model": "smoke_mlp",
                                              "custom_model_config": {"hidden": 64}}),
            ("custom_dist", MultiDiscrete([3, 4, 5]), {"custom_model": "smoke_mlp",
                                                       "custom_action_dist": "smoke_tempered"})]


def _register_surface():
    """The phase's custom model and action distribution, registered."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import distributions as dists
    from ray_tpu_torch.models.base import Dense, TorchModel
    from ray_tpu_torch.models.catalog import ModelCatalog

    class SmokeMLP(TorchModel):
        def __init__(self, obs_shape, num_outputs, generator=None, hidden=32):
            super().__init__()
            n = int(np.prod(obs_shape))
            self.torso = Dense(n, hidden, generator=generator)
            self.head = Dense(hidden, num_outputs, kernel_scale=0.01, generator=generator)
            self.vf = Dense(hidden, 1, generator=generator)

        def forward(self, obs):
            h = torch.tanh(self.torso(obs.reshape(obs.shape[0], -1).float()))
            return self.head(h), self.vf(h).squeeze(-1), ()

    base = dists.MultiCategorical.with_lens((3, 4, 5))

    class SmokeTempered(base):
        def __init__(self, inputs):
            super().__init__(inputs * 0.5)

        @staticmethod
        def required_model_output_shape(action_space):
            return int(np.sum(action_space.nvec))

    ModelCatalog.register_custom_model("smoke_mlp", SmokeMLP)
    ModelCatalog.register_custom_action_dist("smoke_tempered", SmokeTempered)


def phase_model_surface():
    """MultiDiscrete, MultiBinary, a custom model and a custom action
    distribution under PPO on the card against the CPU, then Curiosity
    and RND in cartpole-ppo.yaml (module docstring). Returns the kernel
    counts of its card calls."""
    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.algorithm import Algorithm
    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box

    _register_surface()
    obs_space = Box(-1.0, 1.0, (16,), np.float32)
    rng = np.random.default_rng(22)
    obs = rng.standard_normal((256, 16)).astype(np.float32)
    cfg = {"train_batch_size": 256, "sgd_minibatch_size": 64, "num_sgd_iter": 2, "lr": 5e-4,
           "kl_coeff": 0.2, "entropy_coeff": 0.01, "grad_clip": 40.0, "seed": 5}
    zero_kernel_counts()
    report = {}
    for name, space, model in _surface_policies():
        card = PPOTorchPolicy(obs_space, space, {**cfg, "model": model})
        cpu = PPOTorchPolicy(obs_space, space, {**cfg, "model": model}, device="cpu")
        require(card.device.type == "cuda", f"model_surface {name}: the policy is on {card.device}")
        width = card.num_outputs
        out = {}
        for tag, pol in (("card", card), ("cpu", cpu)):
            # greedy through the user's entry point; sampled with one set
            # of draws injected into both (their generators differ)
            greedy, _, g_extra = pol.compute_actions(obs, explore=False)
            x = torch.as_tensor(obs, device=pol.device)
            u = torch.rand((len(obs), width), generator=torch.Generator().manual_seed(3))
            with torch.no_grad():
                sampled, _, s_extra = pol._action_step_body(x, None, True, draws=(u.to(pol.device),))
            out[tag] = [torch.from_numpy(greedy), torch.from_numpy(g_extra["action_logp"]),
                        sampled.cpu(), s_extra["action_logp"].cpu(),
                        s_extra["action_dist_inputs"].cpu()]
        g, gl, a, al, di = out["card"]
        require(g.dtype == torch.int64 and tuple(g.shape) == (len(obs), space.shape[0]),
                f"model_surface {name}: greedy actions {g.dtype} {tuple(g.shape)}")
        require(torch.equal(g, out["cpu"][0]) and torch.equal(a, out["cpu"][2]),
                f"model_surface {name}: card and CPU actions differ")
        err = max(float((x - y).abs().max())
                  for x, y in ((gl, out["cpu"][1]), (al, out["cpu"][3]), (di, out["cpu"][4])))
        require(err <= SURFACE_TOL, f"model_surface {name}: act outputs differ by {err}")
        batch = {"obs": obs, "actions": a.numpy(), "action_logp": al.numpy(),
                 "action_dist_inputs": di.numpy(),
                 "advantages": rng.standard_normal(len(obs)).astype(np.float32),
                 "value_targets": rng.standard_normal(len(obs)).astype(np.float32)}
        perms = cpu.draw_permutations(len(obs))
        s_card = card.learn_on_batch(batch, perms=perms.to(card.device))
        s_cpu = cpu.learn_on_batch(batch, perms=perms)
        stat_err = max(abs(s_card[k] - s_cpu[k]) / max(1.0, abs(s_cpu[k])) for k in s_cpu)
        w_card, w_cpu = card.get_weights(), cpu.get_weights()
        w_err = max(float(np.abs(w_card[k] - w_cpu[k]).max()) for k in w_cpu)
        require(stat_err <= 1e-4 and w_err <= SURFACE_TOL,
                f"model_surface {name}: the learn differs (stats {stat_err}, weights {w_err})")
        report[name] = {"space": repr(space), "model": type(card.model).__name__,
                        "dist": card.dist_class.__name__, "act_max_abs_err": err,
                        "learn_stat_rel_err": stat_err, "learn_weight_max_abs_err": w_err}
        say("model_surface", policy=name, **{k: json.dumps(v) for k, v in report[name].items()})
    for typ in ("Curiosity", "RND"):  # at the reference's default widths
        algo = ppo_from_yaml(CARTPOLE_ACTOR, exploration_config={"type": typ})
        back = None
        tmp = tempfile.mkdtemp(prefix="chip_smoke_surface_")
        try:
            pol = algo.get_policy()
            expl = pol.exploration
            require(type(expl).__name__ == typ and algo.workers.num_remote_workers() == 0,
                    f"model_surface: {typ} on {algo.workers.num_remote_workers()} workers")
            intrinsic = []
            real = expl.postprocess_trajectory

            def recorded(policy, batch, real=real):
                before = np.array(batch["rewards"], np.float32)
                out = real(policy, batch)
                intrinsic.append(np.asarray(out["rewards"], np.float32) - before)
                return out

            expl.postprocess_trajectory = recorded
            t0 = time.perf_counter()
            results = [algo.train() for _ in range(SURFACE_ITERS)]
            wall = time.perf_counter() - t0
            _finite_learner(f"model_surface {typ}", results[-1], ["default_policy"])
            nets = expl.icm if typ == "Curiosity" else expl.predictor
            require(nets.lr.device.type == "cuda" and all(p.is_cuda for p in nets.params),
                    f"model_surface: {typ}'s nets are not on the card")
            flat = np.concatenate(intrinsic)
            require(len(intrinsic) > 0 and bool(np.isfinite(flat).all()) and bool((flat > 0).all()),
                    f"model_surface: {typ}'s intrinsic rewards {flat.min()} .. {flat.max()}")
            del expl.postprocess_trajectory
            path = algo.save(os.path.join(tmp, "checkpoint_000001"))
            back = Algorithm.from_checkpoint(path)
            state = expl.get_state()
            again = back.get_policy().exploration.get_state()
            bad = _tree_mismatches(state, again)
            require(not bad and set(state) == set(again),
                    f"model_surface: {typ}'s state differs after the checkpoint at {bad[:5]}")
            say("model_surface", exploration=typ, iterations=SURFACE_ITERS,
                wall_s=f"{wall:.2f}", fragments=len(intrinsic),
                intrinsic_min=f"{flat.min():.6g}", intrinsic_mean=f"{flat.mean():.6g}",
                intrinsic_max=f"{flat.max():.6g}", nets_on=str(nets.lr.device),
                state_bitwise=True, state_keys=json.dumps(sorted(state)),
                episode_reward_mean=results[-1]["episode_reward_mean"])
        finally:
            algo.stop()
            if back is not None:
                back.stop()
            shutil.rmtree(tmp, ignore_errors=True)
    launches = read_kernel_counts()
    say("model_surface", launches=json.dumps(launches))
    return launches


# item 9.3's single-agent algorithms: PG, A2C, A3C, SimpleQ, R2D2, RNNSAC,
# ES, ARS and the linear bandits
PG_TUNED = os.path.join(REPO, "tuned_examples", "pg", "cartpole-pg.yaml")
A2C_TUNED = os.path.join(REPO, "tuned_examples", "a2c", "cartpole-a2c.yaml")
DQN_CARTPOLE = os.path.join(REPO, "tuned_examples", "dqn", "cartpole-dqn.yaml")
R2D2_TUNED = os.path.join(REPO, "tuned_examples", "r2d2", "cartpole-r2d2.yaml")
ES_TUNED = os.path.join(REPO, "tuned_examples", "es", "cartpole-es.yaml")
ARS_TUNED = os.path.join(REPO, "tuned_examples", "ars", "cartpole-ars.yaml")
LEARN_RTOL, LEARN_ATOL = 1e-5, 1.5e-5  # the port's learn contract
PG_A2C_ITERS = 3  # timed train() calls of PG and of A2C each
A3C_WINDOW_S = 4.0
OFFPOLICY_BUDGET_S["simple_q"] = 3.0
R2D2_BUDGET_S = 3.0  # each state strategy
RNNSAC_WINDOW_S = 3.0
RNNSAC_LEARN_STARTS = 400  # env steps before RNNSAC's first update
ES_ITERS = 2
BANDIT_ITERS = 40  # train() calls of each bandit, 32 env steps each
BANDIT_LAST = 10  # the calls whose mean reward is held above a uniform policy's
BANDIT_ENV = {"dim": 16, "num_arms": 8, "noise": 0.1}


def _learn_close(phase, what, got, want):
    """Two weight dicts within the learn contract; the largest
    difference."""
    import numpy as np

    worst = 0.0
    for n, w in want.items():
        g = np.asarray(got[n], np.float64)
        w = np.asarray(w, np.float64)
        d = np.abs(g - w)
        require((d <= LEARN_RTOL * np.abs(w) + LEARN_ATOL).all(),
                f"{phase}: {what} {n} part by {float(d.max())}")
        worst = max(worst, float(d.max()))
    return worst


def _stats_close(phase, got, want, rtol=1e-4, atol=1e-6):
    for k, v in want.items():
        if isinstance(v, float):
            require(abs(got[k] - v) <= rtol * abs(v) + atol, f"{phase}: stat {k} card {got[k]} cpu {v}")


def phase_pg_a2c():
    """cartpole-pg.yaml's PG and cartpole-a2c.yaml's A2C as written (the
    local worker samples, the learner on the card): one learn on a fixed
    train batch on the card and on a CPU copy with the same permutation
    (stats within 1e-4 relative, parameters and Adam moments within the
    learn contract), then PG_A2C_ITERS train() calls each with the launch
    counts at 0: env-steps/s and the iteration's split."""
    import torch

    from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample
    from ray_tpu_torch.utils.tuned_example import build_tuned_example

    out = {}
    for name, path in (("pg", PG_TUNED), ("a2c", A2C_TUNED)):
        algo, _ = build_tuned_example(path)
        try:
            policy = algo.get_policy()
            require(policy.device.type == "cuda", f"{name}: the learner is not on the card")
            batch = synchronous_parallel_sample(worker_set=algo.workers,
                                                max_env_steps=algo.config["train_batch_size"])
            twin = _cpu_twin(policy)
            perms = policy.draw_permutations(batch.count).cpu()
            got = policy.learn_on_batch(batch.copy(), perms=perms)
            want = twin.learn_on_batch(batch.copy(), perms=perms)
            _stats_close(name, got, want)
            diff = _learn_close(name, "parameter", policy.get_weights(), twin.get_weights())
            st, tw = policy.get_state()["opt_state"], twin.get_state()["opt_state"]
            _learn_close(name, "Adam mu", st["mu"], tw["mu"])
            _learn_close(name, "Adam nu", st["nu"], tw["nu"])
            zero_kernel_counts()
            t0 = time.perf_counter()
            for _ in range(PG_A2C_ITERS):
                r = algo.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_kernel_counts()
            learner = r["info"]["learner"]["default_policy"]
            require(all(math.isfinite(v) for v in learner.values()), f"{name}: {learner}")
            sampler = algo.workers.local_worker().sampler
            say(name, card=card_line(), learn_card_vs_cpu="within contract", rows=batch.count,
                max_param_diff=diff, calls=PG_A2C_ITERS, wall_s=f"{wall:.3f}",
                env_steps=r["timesteps_total"], env_steps_per_s=f"{r['timesteps_total'] / wall:.1f}",
                episode_reward_mean=r["episode_reward_mean"],
                split=json.dumps({"learn_on_batch_s": round(algo._timers["learn_on_batch_s"], 4),
                                  "act_s": round(sampler.timers["act_s"], 3),
                                  "env_s": round(sampler.timers["env_s"], 3)}),
                launches=json.dumps(launches))
            out[name] = launches
        finally:
            algo.stop()
    return out


def _a3c_algo():
    from ray_tpu_torch.utils.tuned_example import build_tuned_example

    return build_tuned_example(A2C_TUNED, run="A3C", num_workers=2)[0]


def _es_algos():
    from ray_tpu_torch.utils.tuned_example import build_tuned_example

    return {"es": build_tuned_example(ES_TUNED)[0], "ars": build_tuned_example(ARS_TUNED)[0]}


def phase_actor_starts():
    """A3C's algorithm (two remote workers) and ES's and ARS's (two ES
    actors each), built before the single-agent phases, so their worker
    processes start while those phases run; a3c and es_ars take them."""
    return {"a3c": _a3c_algo(), **_es_algos()}


def phase_a3c(algo=None):
    """A3C on cartpole-a2c.yaml's config with two remote CPU workers:
    one fixed numpy gradient (a CPU copy's gradient of a sampled batch)
    applied on the card and on the CPU copy, weights and Adam state
    within the learn contract; then A3C_WINDOW_S seconds of train() with
    the launch counts at 0: gradients of both workers applied, one call in
    flight a worker, and every worker's weights afterwards bitwise the
    learner's; gradients applied a second."""
    import numpy as np
    import torch

    from ray_tpu_torch import core as ray_core

    algo = algo or _a3c_algo()
    try:
        require(type(algo).__name__ == "A3C", "not A3C")
        policy, local = algo.get_policy(), algo.workers.local_worker()
        twin = _cpu_twin(policy)
        grads, _ = twin.compute_gradients(local.sample())
        local.apply_gradients(grads)
        twin.apply_gradients(grads)
        diff = _learn_close("a3c", "parameter", policy.get_weights(), twin.get_weights())
        _learn_close("a3c", "Adam mu", policy.get_state()["opt_state"]["mu"],
                     twin.get_state()["opt_state"]["mu"])
        algo.train()  # the workers' first calls: their processes start
        zero_kernel_counts()
        before = dict(algo.grads_applied)
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < A3C_WINDOW_S:
            r = algo.train()
            steps += 1
            require(len(algo._grad_refs) == 2, f"a3c: {len(algo._grad_refs)} calls in flight")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_kernel_counts()
        applied = {i: n - before.get(i, 0) for i, n in algo.grads_applied.items()}
        require(set(applied) == {1, 2} and min(applied.values()) >= 1,
                f"a3c: gradients applied by worker {applied}")
        learner = policy.get_weights()
        remote = ray_core.get([w.get_weights.remote() for w in algo.workers.remote_workers()],
                              timeout=120)
        for w in remote:
            require(all(np.array_equal(w["default_policy"][k], v) for k, v in learner.items()),
                    "a3c: a worker's weights are not the learner's")
        total = sum(applied.values())
        say("a3c", card=card_line(), apply_card_vs_cpu="within contract", max_param_diff=diff,
            window_s=A3C_WINDOW_S, wall_s=f"{wall:.3f}", train_calls=steps,
            grads_applied=json.dumps(applied), grads_per_s=f"{total / wall:.1f}",
            env_steps_per_s=f"{r['timesteps_total'] / max(wall, 1e-9):.1f}",
            workers_synced=len(remote), launches=json.dumps(launches))
        return launches
    finally:
        algo.stop()


def phase_simple_q():
    """cartpole-dqn.yaml run as SimpleQ (no double Q, no dueling, n-step
    1) with prioritized replay on the device rings, the local worker
    acting on the card: the main path for its budget (``_offpolicy_run``:
    launches against the replay's schedule, each ring's gather, scatter
    and descent against their plain versions), then graphed slots against
    eager updates on its ring, bitwise."""
    from ray_tpu_torch.utils.tuned_example import build_tuned_example

    algo, _ = build_tuned_example(DQN_CARTPOLE, run="SimpleQ", replay_buffer_config={
        "capacity": 50000, "prioritized_replay": True, "prioritized_replay_alpha": 0.6,
        "prioritized_replay_beta": 0.4})
    try:
        policy = algo.get_policy()
        require(type(algo).__name__ == "SimpleQ" and not policy.config["double_q"]
                and "value_head.weight" not in policy.param_names, "not SimpleQ's model")
        launches = _offpolicy_run("simple_q", algo)
        p = _replay_parity("simple_q", policy, algo.local_replay_buffer.buffers["default_policy"],
                           True, int(algo.config["train_batch_size"]))
        say("simple_q", card=card_line(), parity="graphed = eager", bitwise=True, **p)
        return launches
    finally:
        algo.stop()


def _r2d2_stats_close(name, got, want, twin, seqs):
    """R2D2's learn stats, card against CPU. ``mean_q`` within 1e-4
    relative. The TD-error stats pass through ``h_inverse``, the
    reference's closed form, whose float32 cancellation moves in steps of
    ``ulp(2 eps |y| + 2 eps + 1) / (2 eps^2)`` (0.0596 at eps 1e-3 and |y|
    < 500): the card's and the CPU's target Q values, a rounding apart,
    can land one step apart, and ``h_function`` (slope at most 0.5 + eps)
    then moves that element's target by up to ``reach = gamma (0.5 + eps)
    step``. ``mean_td_error`` and the Huber ``total_loss`` (slope at most
    1) are held within 1e-4 relative plus that reach; ``grad_gnorm``'s
    difference is printed: no bound on it follows from the stats."""
    import numpy as np
    import torch

    cfg = twin.config
    eps, gamma = float(cfg.get("h_function_epsilon", 1e-3)), float(cfg.get("gamma", 0.99))
    with torch.no_grad():
        tq = twin.functional_forward(
            twin.aux_state["target_params"], torch.as_tensor(seqs["obs"]),
            (torch.as_tensor(seqs["state_in_0"]), torch.as_tensor(seqs["state_in_1"])),
            resets=torch.as_tensor(seqs["resets"]))[0]
    lead = np.float32(2 * eps * float(tq.abs().max()) + 2 * eps + 1)
    reach = gamma * (0.5 + eps) * float(np.spacing(lead)) / (2 * eps ** 2)
    for k, extra in (("mean_q", 0.0), ("mean_td_error", reach), ("total_loss", reach)):
        require(abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) + 1e-6 + extra,
                f"{name}: stat {k} card {got[k]} cpu {want[k]} (h_inverse reach {reach})")
    return {"h_inverse_reach": reach,
            "grad_gnorm_rel_diff": abs(got["grad_gnorm"] - want["grad_gnorm"])
            / max(abs(want["grad_gnorm"]), 1e-12)}


def phase_r2d2():
    """cartpole-r2d2.yaml (LSTM 64 over fcnet 64, burn-in 4, sequences of
    20, 16 sequences a learn), zero-init and stored-state: R2D2_BUDGET_S
    of train() each with the launch counts at 0 (env-steps/s, updates/s,
    target updates counted: at least one), then one learn on 16 sequences
    from its buffer on the card and on a CPU copy with one permutation:
    parameters and Adam moments within the learn contract, the stats as
    ``_r2d2_stats_close`` holds them."""
    import numpy as np
    import torch

    from ray_tpu_torch.data.sample_batch import SampleBatch
    from ray_tpu_torch.utils.tuned_example import build_tuned_example

    out = {}
    for zero_init in (True, False):
        name = f"r2d2_{'zero' if zero_init else 'stored'}"
        algo, _ = build_tuned_example(R2D2_TUNED, zero_init_states=zero_init)
        try:
            policy = algo.get_policy()
            require(policy.device.type == "cuda" and policy.model.is_recurrent,
                    f"{name}: the recurrent learner is not on the card")
            zero_kernel_counts()
            t0 = time.perf_counter()
            while True:
                r = algo.train()
                if (time.perf_counter() - t0 >= R2D2_BUDGET_S
                        and algo._counters["num_target_updates"] >= 1):
                    break
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_kernel_counts()
            c = algo._counters
            updates = policy.num_grad_updates
            require(c["num_target_updates"] >= 1 and updates >= 1, f"{name}: {dict(c)}")
            seqs = algo.seq_buffer.sample(int(algo.config["train_batch_size"]))
            starts = np.abs(seqs["state_in_0"]).sum()
            require((starts == 0) == zero_init, f"{name}: stored states {starts}")
            twin = _cpu_twin(policy)
            perms = policy.draw_permutations(len(seqs["mask"])).cpu()
            got = policy.learn_on_batch(SampleBatch(dict(seqs)), perms=perms)
            want = twin.learn_on_batch(SampleBatch(dict(seqs)), perms=perms)
            diff = _learn_close(name, "parameter", policy.get_weights(), twin.get_weights())
            st, tw = policy.get_state()["opt_state"], twin.get_state()["opt_state"]
            _learn_close(name, "Adam mu", st["mu"], tw["mu"])
            _learn_close(name, "Adam nu", st["nu"], tw["nu"])
            stats = _r2d2_stats_close(name, got, want, twin, seqs)
            say(name, card=card_line(), learn_card_vs_cpu="within contract", max_param_diff=diff,
                **stats,
                budget_s=R2D2_BUDGET_S, wall_s=f"{wall:.3f}", env_steps=c["num_env_steps_sampled"],
                env_steps_per_s=f"{c['num_env_steps_sampled'] / wall:.1f}", updates=updates,
                updates_per_s=f"{updates / wall:.2f}", target_updates=c["num_target_updates"],
                trained=c["num_env_steps_trained"], sequences=len(algo.seq_buffer),
                episode_reward_mean=r["episode_reward_mean"], launches=json.dumps(launches))
            out[name] = launches
        finally:
            algo.stop()
    return out


def phase_rnnsac():
    """RNNSAC on the port's Pendulum-v1 at its defaults (actor and twin Q
    nets 256x256 into LSTMs of 64; 12 sequences of 20 a learn), fragments
    of 20, learning from RNNSAC_LEARN_STARTS env steps: RNNSAC_WINDOW_S
    of train() after learning starts with the launch counts at 0
    (updates/s), then one update on 12 sequences from its buffer with
    host-drawn (B, T, 1) normals on the card and on a CPU copy: every
    parameter, target and Adam moment within SAC's 1e-6 plus 1e-5
    relative (``tests/test_torch_sac.py``), the stats within 1e-4
    relative (the other phases' card against CPU)."""
    import torch

    from ray_tpu_torch.algorithms.sac.rnnsac import RNNSACConfig
    from ray_tpu_torch.data.sample_batch import SampleBatch

    algo = (RNNSACConfig().environment("Pendulum-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=20)
            .training(num_steps_sampled_before_learning_starts=RNNSAC_LEARN_STARTS)
            .debugging(seed=0).build())
    try:
        policy = algo.get_policy()
        require(policy.device.type == "cuda", "rnnsac: the learner is not on the card")
        while policy.num_grad_updates == 0:
            algo.train()
        zero_kernel_counts()
        u0 = policy.num_grad_updates
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < RNNSAC_WINDOW_S:
            r = algo.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_kernel_counts()
        updates = policy.num_grad_updates - u0
        seqs = algo.seq_buffer.sample(int(algo.config["train_batch_size"]) // 20)
        twin = _cpu_twin(policy)
        g = torch.Generator().manual_seed(5)
        shape = seqs["actions"].shape
        normals = (torch.randn(shape, generator=g), torch.randn(shape, generator=g))
        got = policy.learn_on_batch(SampleBatch(dict(seqs)),
                                    normals=tuple(n.cuda() for n in normals))
        want = twin.learn_on_batch(SampleBatch(dict(seqs)), normals=normals)
        _stats_close("rnnsac", got, want)
        worst = 0.0
        for name, a, b in _policy_state_pairs(policy, twin):
            if isinstance(a, torch.Tensor) and a.is_floating_point():
                a64, b64 = a.detach().cpu().double(), b.detach().cpu().double()
                d = (a64 - b64).abs()
                require(bool((d <= 1e-5 * b64.abs() + 1e-6).all()),
                        f"rnnsac: {name} part by {float(d.max())}")
                worst = max(worst, float(d.max()))
        say("rnnsac", card=card_line(), update_card_vs_cpu="within SAC's tolerances",
            max_state_diff=worst, window_s=RNNSAC_WINDOW_S, wall_s=f"{wall:.3f}",
            updates=updates, updates_per_s=f"{updates / wall:.2f}",
            env_steps=r["timesteps_total"], sequences=len(algo.seq_buffer),
            stats=json.dumps({k: round(v, 5) for k, v in got.items()}),
            launches=json.dumps(launches))
        return launches
    finally:
        algo.stop()


def _es_recompute(algo, agg, theta0, opt0):
    """The driver's update recomputed in numpy from the indices and
    returns the iteration gathered."""
    import numpy as np
    from ray_tpu_torch.algorithms.es.es import ARS, compute_centered_ranks

    cfg = algo.config
    rows = np.stack([algo.noise.get(i, theta0.size) for i in agg["indices"]])
    pos, neg = np.asarray(agg["pos"], np.float32), np.asarray(agg["neg"], np.float32)
    if isinstance(algo, ARS):
        k = min(int(cfg["rollouts_used"]), len(pos))
        order = np.argsort(-np.maximum(pos, neg))[:k]
        std = max(float(np.concatenate([pos[order], neg[order]]).std()), 1e-6)
        return theta0 + float(cfg["sgd_stepsize"]) * ((pos[order] - neg[order]) @ rows[order]
                                                       / (k * std))
    ranks = compute_centered_ranks(np.stack([pos, neg], axis=1))
    grad = (ranks[:, 0] - ranks[:, 1]) @ rows / (len(pos) * float(cfg["noise_stdev"]))
    return opt0.update(theta0, -grad + float(cfg["l2_coeff"]) * theta0)


def phase_es_ars(algos=None):
    """cartpole-es.yaml and cartpole-ars.yaml as written (two ES actors
    each, on the CPU; noise tables of 5,000,000; both built before either
    trains, by ``phase_actor_starts`` in the smoke's run, so their actors
    start together and early): ES_ITERS iterations each with
    the launch counts at 0, each iteration's new theta bitwise a numpy
    recomputation from its gathered indices and returns; then the card
    policy's greedy actions on 256 observations equal to a CPU rollout
    engine's for the same theta. Iteration seconds and env-steps/s."""
    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.es.es import _RolloutEngine

    algos = algos or _es_algos()
    out = {}
    try:
        for name, algo in algos.items():
            policy = algo.get_policy()
            require(policy.device.type == "cuda", f"{name}: the policy is not on the card")
            require(len(algo._es_workers) == 2, f"{name}: {len(algo._es_workers)} ES actors")
            zero_kernel_counts()
            secs, steps0 = [], algo._counters["num_env_steps_sampled"]
            for _ in range(ES_ITERS):
                theta0, opt0 = algo._theta.copy(), copy.deepcopy(algo._optimizer)
                t0 = time.perf_counter()
                r = algo.train()
                secs.append(round(time.perf_counter() - t0, 3))
                require(np.array_equal(algo._theta, _es_recompute(algo, algo.last_iteration,
                                                                  theta0, opt0)),
                        f"{name}: theta is not the numpy recomputation")
            launches = read_kernel_counts()
            steps = algo._counters["num_env_steps_sampled"] - steps0
            engine = _RolloutEngine(algo.config, algo.config["env"])
            engine.flat.set(algo._theta)
            obs = np.random.default_rng(3).standard_normal((256, 4)).astype(np.float32)
            card = policy.compute_actions(obs, explore=False)[0]
            require(np.array_equal(card, engine.act(obs)), f"{name}: greedy actions differ")
            torch.cuda.synchronize()
            say(name, card=card_line(), theta="numpy recomputation, bitwise",
                greedy_card_vs_cpu="equal", observations=len(obs), iteration_s=json.dumps(secs),
                env_steps=steps, env_steps_per_s=f"{steps / sum(secs):.1f}",
                episodes_this_iter=r["episodes_this_iter"],
                episode_reward_mean=r["episode_reward_mean"], params=int(algo._theta.size),
                launches=json.dumps(launches))
            out[name] = launches
    finally:
        for algo in algos.values():
            algo.stop()
    return out


def phase_bandits():
    """LinUCB and LinTS on the port's linear-context bandit
    (BANDIT_ENV: 16-dim contexts, 8 arms; numpy): after 6 updates of 64
    rows, the precision and moment on the card and on a CPU copy within
    1e-5 relative plus 1e-6, and the scores of 64 contexts with one
    injected draw within 1e-5 relative plus 1e-5, greedy and exploring;
    then BANDIT_ITERS train() calls of 32 steps with the launch counts at
    0: the mean reward of the last BANDIT_LAST calls above a uniform
    random policy's expected reward."""
    import numpy as np
    import torch

    from ray_tpu_torch.algorithms.bandit.bandit import (
        BanditLinTSConfig,
        BanditLinUCBConfig,
        LinearContextBandit,
    )
    from ray_tpu_torch.data.sample_batch import SampleBatch

    env = LinearContextBandit(BANDIT_ENV)
    rng = np.random.default_rng(0)
    uniform = float(env.expected_rewards(
        rng.standard_normal((100_000, env.dim)).astype(np.float32)).mean())
    out = {}
    for name, cfg_cls in (("lin_ucb", BanditLinUCBConfig), ("lin_ts", BanditLinTSConfig)):
        algo = (cfg_cls().environment(LinearContextBandit, env_config=BANDIT_ENV)
                .rollouts(num_rollout_workers=0, rollout_fragment_length=32)
                .training(train_batch_size=32).debugging(seed=0).build())
        try:
            policy = algo.get_policy()
            require(policy.precision.is_cuda, f"{name}: the statistics are not on the card")
            twin = type(policy)(policy.observation_space, policy.action_space,
                                dict(policy.config), device="cpu")
            probe = type(policy)(policy.observation_space, policy.action_space,
                                 dict(policy.config))
            for _ in range(6):
                ctx = rng.standard_normal((64, env.dim)).astype(np.float32)
                act = rng.integers(0, env.arms, 64)
                b = {"obs": ctx, "actions": act, "rewards": (env.expected_rewards(ctx)[
                    np.arange(64), act]).astype(np.float32)}
                probe.learn_on_batch(SampleBatch(dict(b)))
                twin.learn_on_batch(SampleBatch(dict(b)))
            for a, w in ((probe.precision, twin.precision), (probe.moment, twin.moment)):
                require(bool(torch.allclose(a.cpu(), w, rtol=1e-5, atol=1e-6)),
                        f"{name}: statistics part by {float((a.cpu() - w).abs().max())}")
            ctx = torch.as_tensor(rng.standard_normal((64, env.dim)).astype(np.float32))
            noise = torch.randn((env.arms, env.dim), generator=torch.Generator().manual_seed(1))
            worst = 0.0
            for explore in (False, True):
                s = probe.scores(ctx.cuda(), explore, noise.cuda()).cpu()
                w = twin.scores(ctx, explore, noise)
                require(bool(torch.allclose(s, w, rtol=1e-5, atol=1e-5)),
                        f"{name}: scores part by {float((s - w).abs().max())}")
                worst = max(worst, float((s - w).abs().max()))
            zero_kernel_counts()
            t0 = time.perf_counter()
            rewards = []
            for _ in range(BANDIT_ITERS):
                r = algo.train()
                rewards.append(r["info"]["learner"]["default_policy"]["mean_reward"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_kernel_counts()
            late = float(np.mean(rewards[-BANDIT_LAST:]))
            require(late > uniform, f"{name}: late mean reward {late} <= uniform {uniform}")
            say(name, card=card_line(), card_vs_cpu="statistics and scores within 1e-5",
                max_score_diff=worst, calls=BANDIT_ITERS, wall_s=f"{wall:.3f}",
                env_steps_per_s=f"{r['timesteps_total'] / wall:.1f}",
                first_mean_reward=round(rewards[0], 4), last_mean_reward=round(late, 4),
                uniform_expected_reward=round(uniform, 4), launches=json.dumps(launches))
            out[name] = launches
        finally:
            algo.stop()
    return out


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ring_ranks(n, backend):
    """Start ``n`` rank processes of this script (``--ring-rank``) over a
    ``tcp://127.0.0.1`` rendezvous and wait for them. A rank that fails,
    or a phase that outlives RING_TIMEOUT_S, raises with every rank's
    output, after every rank has been killed."""
    import tempfile

    env = {**os.environ, "RAY_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "RAY_TPU_NUM_PROCESSES": str(n)}
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(n)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ring-rank", backend],
                                  env={**env, "RAY_TPU_PROCESS_ID": str(r)}, cwd=REPO,
                                  stdout=logs[r], stderr=subprocess.STDOUT, text=True)
                 for r in range(n)]
        deadline = time.monotonic() + RING_TIMEOUT_S
        try:
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes) or any(c not in (None, 0) for c in codes):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                p.kill()
                p.wait()
        out = []
        for log in logs:
            log.seek(0)
            out.append(log.read())
            log.close()
    codes = [p.returncode for p in procs]
    require(all(c == 0 for c in codes),
            f"ring ranks ({backend}) exited {codes} (a negative code: killed at the "
            f"{RING_TIMEOUT_S} s timeout or after another rank failed):\n"
            + "\n".join(f"--- rank {r}\n{o[-3000:]}" for r, o in enumerate(out)))
    results = []
    for text in out:  # each rank's report is its last JSON line
        lines = text.strip().splitlines()
        last = max(i for i, line in enumerate(lines) if line.startswith("{"))
        for line in lines[:last] + lines[last + 1:]:
            print(line, flush=True)
        results.append(json.loads(lines[last]))
    return results


def ring_rank_main(backend):
    """One rank of the ring phase: the same seeded whole arrays on every
    rank, in three cases; each rank keeps its own block of T on the card
    and calls ``ring_attention`` on it twice, timed, with the card's peak
    memory over each call; the rows wait in host memory and are gathered
    for the golden check only after every timed call."""
    import torch

    sys.path.insert(0, REPO)
    from ray_tpu_torch.ops.flash_attention import flash_block_attention_stats
    from ray_tpu_torch.parallel.collectives import send_recv_shift
    from ray_tpu_torch.parallel.distributed import initialize, shutdown, sync_global
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.ring_attention import (
        full_attention_reference, gather_sequence, ring_attention, shard_sequence,
    )

    dev = initialize(backend=backend)
    mesh = make_mesh([("sp", torch.distributed.get_world_size())])
    n, rank = mesh.size("sp"), mesh.index("sp")
    shape = (RING_B, RING_T, RING_H, RING_D)
    gen = torch.Generator().manual_seed(7)  # the same arrays on every rank
    report = {"rank": rank, "backend": backend, "device": str(dev), "calls": {}}
    cases = (("f32_causal", torch.float32, True), ("f32_full", torch.float32, False),
             ("bf16_causal", torch.bfloat16, True))
    held = {}  # each case's whole arrays and this rank's rows, in host memory
    for name, dtype, causal in cases:
        whole = [torch.randn(shape, generator=gen).to(dtype) for _ in range(3)]
        q, k, v = (shard_sequence(x, mesh, "sp").to(dev) for x in whole)
        calls = []
        rows = None
        for _ in range(2):
            rows = None
            flash_block_attention_stats.launches = 0
            send_recv_shift.staged = 0
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            sync_global()
            t0 = time.perf_counter()
            rows = ring_attention(q, k, v, mesh, axis_name="sp", causal=causal)
            torch.cuda.synchronize()
            calls.append({"wall_s": time.perf_counter() - t0,
                          "launches": flash_block_attention_stats.launches,
                          "staged": send_recv_shift.staged,
                          "resident_mb": resident / 2 ** 20,
                          "peak_mb": torch.cuda.max_memory_allocated(dev) / 2 ** 20})
        require(all(c["launches"] == n for c in calls), f"rank {rank}: launches per call {calls}")
        require(rows.shape == (RING_B, RING_T // n, RING_H, RING_D) and rows.dtype == dtype
                and bool(torch.isfinite(rows).all()), f"rank {rank}: ring rows of {name}")
        held[name] = (whole, rows.cpu())
        report["calls"][name] = {"calls": calls}
        del rows, q, k, v
    # after every timed call (the golden's matrix products keep a cuBLAS
    # workspace on the card): the rows gathered, and rank 0's against the
    # golden on the card, 1024 query rows at a time
    for name, dtype, causal in cases:
        whole, rows = held.pop(name)
        out = gather_sequence(rows.to(dev), mesh, "sp")  # NCCL gathers CUDA tensors only
        if rank == 0:
            require(out.shape == shape, f"gathered rows of {name}: {tuple(out.shape)}")
            want = full_attention_reference(*(x.to(dev).float() for x in whole), causal, query_chunk=1024)
            out = out.float()
            # f32: the reference test's 2e-4. bf16: the golden runs in f32
            # on the same bf16 values, so the two differ by the output's
            # rounding to bf16 (at most half a bf16 ulp, 2**-8 relative)
            # and float32 drift: one ulp (2**-7) relative, 1e-5 absolute
            atol, rtol = (1e-5, 2 ** -7) if dtype == torch.bfloat16 else (2e-4, 2e-4)
            entry = report["calls"][name]
            entry["max_abs_err"] = float((out - want).abs().max())
            entry["tol_used"] = float(((out - want).abs() / (atol + rtol * want.abs())).max())
            require(torch.allclose(out, want, atol=atol, rtol=rtol),
                    f"ring {name} differs from full attention by {entry['max_abs_err']}")
    # the kernel's time at this rank's busiest causal hop, ranks in turn
    busiest = RING_HOP if rank > 0 else 0
    qf, kf, vf = (torch.randn(RING_B * RING_H, RING_HOP, RING_D, generator=gen).to(dev) for _ in range(3))
    for r in range(n):
        sync_global()
        if r == rank:
            def hop():
                return flash_block_attention_stats(qf, kf, vf, busiest)

            report["busiest_hop"] = {"offset": busiest, "kernel_ms": cuda_ms(hop, iters=10, warmup=2),
                                     "device_ms": device_ms(hop, "flash_block_kernel", iters=10,
                                                            warmup=2)}
    # one hop's exchange of the stacked f32 K/V (2, B·H, 4096, 32), every
    # rank together, host clock
    kv = torch.stack([kf, vf])
    send_recv_shift(kv, mesh.group("sp"))
    torch.cuda.synchronize()
    sync_global()
    t0 = time.perf_counter()
    for _ in range(5):
        kv = send_recv_shift(kv, mesh.group("sp"))
    torch.cuda.synchronize()
    report["hop_exchange_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    sync_global()
    shutdown()
    print(f"[ring] rank={rank} backend={backend} device={dev} " + " ".join(
        f"{name}_s={json.dumps([round(c['wall_s'], 5) for c in e['calls']])} "
        f"{name}_peak_mb={json.dumps([round(c['peak_mb'], 3) for c in e['calls']])}"
        for name, e in report["calls"].items()), flush=True)
    print(json.dumps(report), flush=True)
    return 0


def ring_nccl(n):
    """The ring on NCCL with ``n`` ranks, one per card (``n`` >= 2 cards):
    every hop moves the CUDA K/V directly, none is staged. Returns the
    kernel launches of every rank's calls."""
    ranks = _run_ring_ranks(n, "nccl")
    for r in ranks:
        for e in r["calls"].values():
            require(all(c["launches"] == n and c["staged"] == 0 for c in e["calls"]),
                    f"rank {r['rank']}: NCCL launches and staged exchanges {e['calls']}")
    errs = {name: e["max_abs_err"] for name, e in ranks[0]["calls"].items()}
    say("ring", backend="nccl", ranks=n, cards=n, staged_per_call=0, max_abs_err=json.dumps(errs),
        second_call_s_by_rank=json.dumps({k: [round(r["calls"][k]["calls"][1]["wall_s"], 5) for r in ranks]
                                          for k in errs}),
        peak_mb_by_rank=json.dumps({k: [round(r["calls"][k]["calls"][1]["peak_mb"], 3) for r in ranks]
                                    for k in errs}),
        busiest_hop_kernel_ms=json.dumps({r["rank"]: round(r["busiest_hop"]["kernel_ms"], 5) for r in ranks}))
    return sum(c["launches"] for r in ranks for e in r["calls"].values() for c in e["calls"])


def phase_ring():
    """Ring attention through its entry points: RING_RANKS ranks on the
    one card over gloo (NCCL refuses two ranks on one card), each hop
    staged through host memory; NCCL with one rank per card where there
    are several cards; and NCCL at world size 1 in this process."""
    import torch

    from ray_tpu_torch.ops.flash_attention import flash_block_attention_stats
    from ray_tpu_torch.parallel.distributed import initialize, shutdown
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.ring_attention import ring_attention, shard_sequence

    t0 = time.perf_counter()
    ranks = _run_ring_ranks(RING_RANKS, "gloo")
    wall = time.perf_counter() - t0
    launches = {"gloo": sum(c["launches"] for r in ranks for e in r["calls"].values() for c in e["calls"])}
    for r in ranks:
        for e in r["calls"].values():
            require(all(c["staged"] == RING_RANKS - 1 for c in e["calls"]),
                    f"rank {r['rank']}: staged exchanges {e['calls']}")
    errs = {name: e["max_abs_err"] for name, e in ranks[0]["calls"].items()}
    second = {name: [round(r["calls"][name]["calls"][1]["wall_s"], 5) for r in ranks] for name in errs}
    # one f32 (B, T, H, D) array, and one rank's block of it
    array_mb = RING_B * RING_T * RING_H * RING_D * 4 / 2 ** 20
    say("ring", backend="gloo", ranks=RING_RANKS, device="one card",
        shape=f"B={RING_B} T={RING_T} H={RING_H} D={RING_D}", launches_per_call=RING_RANKS,
        staged_per_call=RING_RANKS - 1, gathers_in_call=0, max_abs_err=json.dumps(errs),
        tol_used=json.dumps({name: e["tol_used"] for name, e in ranks[0]["calls"].items()}),
        second_call_s_by_rank=json.dumps(second),
        peak_mb_by_rank=json.dumps({name: [round(r["calls"][name]["calls"][1]["peak_mb"], 3)
                                           for r in ranks] for name in errs}),
        resident_mb_by_rank=json.dumps({name: [round(r["calls"][name]["calls"][1]["resident_mb"], 3)
                                               for r in ranks] for name in errs}),
        f32_array_mb=array_mb, f32_block_mb=array_mb / RING_RANKS,
        busiest_hop_kernel_ms=json.dumps({r["rank"]: round(r["busiest_hop"]["kernel_ms"], 5) for r in ranks}),
        busiest_hop_device_ms=json.dumps({r["rank"]: round(r["busiest_hop"]["device_ms"], 5) for r in ranks}),
        hop_exchange_ms=json.dumps({r["rank"]: round(r["hop_exchange_ms"], 4) for r in ranks}),
        phase_s=f"{wall:.2f}")
    cards = torch.cuda.device_count()
    if cards >= 2:
        launches["nccl"] = ring_nccl(RING_RANKS if cards >= RING_RANKS else 2)  # T divides by either
    else:
        say("ring", backend="nccl", ranks=1, note="one card: the NCCL hop was not exercised "
            "(NCCL refuses two ranks on one card); a world of one runs without exchange")
    # NCCL at world size 1 in this process: no exchange, one launch, and
    # the result is that launch's acc / l
    dev = initialize(backend="nccl")
    try:
        mesh = make_mesh([("sp", 1)])
        gen = torch.Generator().manual_seed(8)
        q, k, v = (shard_sequence(torch.randn(1, 512, RING_H, RING_D, generator=gen), mesh, "sp").to(dev)
                   for _ in range(3))
        flash_block_attention_stats.launches = 0
        out = ring_attention(q, k, v, mesh, axis_name="sp", causal=True)
        launches["nccl_world_1"] = flash_block_attention_stats.launches
        flat = [x.transpose(1, 2).reshape(RING_H, 512, RING_D).contiguous() for x in (q, k, v)]
        acc, _, l = flash_block_attention_stats(*flat, 0)
        want = (acc / l.clamp(min=1e-30)[..., None]).reshape(1, RING_H, 512, RING_D).transpose(1, 2)
        torch.cuda.synchronize()
        require(launches["nccl_world_1"] == 1 and torch.equal(out, want),
                "the NCCL ring of one is not its one block")
    finally:
        shutdown()
    say("ring", backend="nccl", world=1, launches=launches["nccl_world_1"], equal_to_one_block=True)
    return launches


PHASE_SECONDS = []  # each timed phase's wall time, for the run's sum


def timed(phase, *args):
    """``phase(*args)``, with a line of its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    seconds = time.perf_counter() - t0
    PHASE_SECONDS.append(seconds)
    say("timing", name=phase.__name__[len("phase_"):], seconds=f"{seconds:.1f}")
    return out


def budget_cuts():
    """(knob, old value, value now, unit) of the run budgets, windows
    and timed calls cut to pay for the ingress_bank and model_surface
    phases (PR 22) and for item 9.3's seven phases (PR 23)."""
    pr22 = [
        ("OFFPOLICY_BUDGET_S[rainbow]", 10.0, OFFPOLICY_BUDGET_S["rainbow"]),
        ("OFFPOLICY_BUDGET_S[ddpg]", 8.0, OFFPOLICY_BUDGET_S["ddpg"]),
        ("OFFPOLICY_BUDGET_S[ma_dqn]", 8.0, OFFPOLICY_BUDGET_S["ma_dqn"]),
        ("ASYNC_BUDGET_S[apex]", 15.0, ASYNC_BUDGET_S["apex"]),
        ("ASYNC_BUDGET_S[impala_fused]", 15.0, ASYNC_BUDGET_S["impala_fused"]),
        ("ASYNC_BUDGET_S[sac_async]", 8.0, ASYNC_BUDGET_S["sac_async"]),
        ("ASYNC_BUDGET_S[impala_agg]", 8.0, ASYNC_BUDGET_S["impala_agg"]),
        ("LSTM_IMPALA_WINDOW_S", 10.0, LSTM_IMPALA_WINDOW_S),
        ("EXTERNAL_ENV_S", 6.0, EXTERNAL_ENV_S),
        ("ACTOR_LEARN_S", 5.0, ACTOR_LEARN_S),
        ("MA_LEARN_S", 5.0, MA_LEARN_S),
        ("SERVE_WINDOW_S", 8.0, SERVE_WINDOW_S),
        ("INGRESS_WINDOW_S", 6.0, INGRESS_WINDOW_S),
    ]
    pr23 = [
        ("ACTOR_TIMED_CALLS", 3, ACTOR_TIMED_CALLS, "calls"),
        ("MA_TIMED_CALLS", 2, MA_TIMED_CALLS, "calls"),
        ("RECURRENT_CALLS", 3, RECURRENT_CALLS, "calls"),
        ("IMPALA_WINDOW_S", 10.0, IMPALA_WINDOW_S, "s"),
        ("APPO_WINDOW_S", 6.0, APPO_WINDOW_S, "s"),
        ("PREFETCH_WINDOW_S", 6.0, PREFETCH_WINDOW_S, "s"),
        ("PREFETCH_FUSED_S", 3.0, PREFETCH_FUSED_S, "s"),
        ("SAC_BUDGET_S", 5.0, SAC_BUDGET_S, "s"),
        ("SERVE_TORSO_WINDOW_S[exact and vectorized]", 4.0, SERVE_TORSO_WINDOW_S, "s"),
    ]
    return [(k, old, new, "s") for k, old, new in pr22] + pr23


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable: {e}"
    return out


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--ring-rank"]:
        return ring_rank_main(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from ray_tpu_torch import core as ray_core
    from ray_tpu_torch.device import resolve_device

    resolve_device()
    say("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))
    rng = np.random.default_rng(0)
    for knob, old, new, unit in budget_cuts():
        say("cut", knob=knob, old=old, new=new, unit=unit)
    timed(phase_build)
    gather = timed(phase_gather, rng)
    gae = timed(phase_gae)
    scatter = timed(phase_scatter)
    descent = timed(phase_descent, rng)
    flash = timed(phase_flash)
    flash_block = timed(phase_flash_block)
    # the main paths, each with its launch counts set to 0 just before
    learner_gathers = timed(phase_learner, rng)
    lane_gaes, _, lane_off = timed(phase_lane)
    telemetry_gaes = timed(phase_telemetry, lane_off)
    dqn = timed(phase_dqn)
    tf_learner = timed(phase_transformer_learner)
    tf_lane = timed(phase_transformer_lane)
    tf_dqn = timed(phase_transformer_dqn)
    cartpole = timed(phase_cartpole)
    gridrooms = timed(phase_gridrooms)
    timed(phase_graph_parity)
    pong_learn = timed(phase_ponglite_learn)
    actor = timed(phase_actor_lane)
    actor_local = timed(phase_actor_lane_local)
    actor_learn = timed(phase_actor_learn)
    impala, impala_batch, impala_cfg = timed(phase_impala)
    timed(phase_impala_parity, impala_batch, impala_cfg)
    appo = timed(phase_appo)
    impala_fused = timed(phase_impala_fused)
    prefetch = timed(phase_ppo_prefetch)
    sac_learner = timed(phase_sac_learner)
    timed(phase_sac_columns)
    sac = timed(phase_sac)
    timed(phase_pendulum_ppo)
    rainbow = timed(phase_rainbow)
    ddpg = timed(phase_ddpg)
    td3 = timed(phase_td3)
    ma_dqn = timed(phase_ma_dqn)
    apex = timed(phase_apex)
    sac_async = timed(phase_sac_async)
    apex_ddpg = timed(phase_apex_ddpg)
    timed(phase_apex_host)
    interleave = timed(phase_dqn_interleave)
    host_tree = timed(phase_host_tree)
    timed(phase_spill)
    lane_eval = timed(phase_lane_eval)
    timed(phase_ma_ppo)
    timed(phase_ma_ppo_independent)
    timed(phase_views)
    timed(phase_lstm_ppo)
    gtrxl, gtrxl_policy = timed(phase_gtrxl_ppo)
    timed(phase_lstm_impala)
    recurrent_serve = timed(phase_recurrent_serve, gtrxl_policy)
    offline_tmp = tempfile.mkdtemp(prefix="chip_smoke_offline_")
    try:
        shards = timed(phase_offline_io, offline_tmp)
        timed(phase_offline_bc, shards)
        offline_sac_writer = timed(phase_offline_cql_crr, offline_tmp)
    finally:
        shutil.rmtree(offline_tmp, ignore_errors=True)
    timed(phase_external_env)
    timed(phase_model_surface)
    # item 9.3's single-agent algorithms; only simple_q's path runs
    # kernels. A3C's workers and the ES actors start first: their process
    # starts overlap the phases before theirs
    started = timed(phase_actor_starts)
    try:
        timed(phase_pg_a2c)
        simple_q = timed(phase_simple_q)
        timed(phase_r2d2)
        timed(phase_a3c, started.pop("a3c"))
        timed(phase_rnnsac)
        timed(phase_es_ars, {k: started.pop(k) for k in ("es", "ars")})
        timed(phase_bandits)
    finally:
        for algo in started.values():  # a phase before theirs failed
            algo.stop()
    serve_tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        ckpt_ppo, serve_root, serve_newer = timed(phase_ckpt_ppo, serve_tmp)
        ckpt_dqn = timed(phase_ckpt_dqn)
        chaos_ppo = timed(phase_chaos_ppo)
        stream_impala = timed(phase_stream_impala)
        restore_dqn = timed(phase_restore_dqn)
        cli_tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
        try:
            cli_ckpt = timed(phase_evaluate, os.path.join(cli_tmp, "checkpoint_000002"))
            timed(phase_evaluate_cli, cli_ckpt)
        finally:
            shutil.rmtree(cli_tmp, ignore_errors=True)
        # the serving paths, each with its launch counts set to 0 just before
        timed(phase_serve, serve_root, serve_newer)
        timed(phase_ingress_bank, serve_root)
        serve_torso = timed(phase_serve_torso)
        served = timed(phase_serve_replicas, serve_root)
        timed(phase_ingress, served)
    finally:
        shutil.rmtree(serve_tmp, ignore_errors=True)
    ray_core.shutdown()
    ring = timed(phase_ring)
    offpolicy = {"rainbow": rainbow, "ddpg": ddpg, "td3": td3, "ma_dqn": ma_dqn}
    gather["launches_by_path"] = {"learner": learner_gathers, "dqn": dqn["gather_rows"],
                                  "transformer_dqn": tf_dqn["gather_rows"], "actor_lane": actor,
                                  "actor_lane_local": actor_local, "actor_learn": actor_learn,
                                  "impala": impala, "appo": appo, "ppo_prefetch": prefetch,
                                  "sac_learner": sac_learner["uniform"]["gather_rows"],
                                  "sac_learner_prioritized": sac_learner["prioritized"]["gather_rows"],
                                  "sac": sac["gather_rows"], "ckpt_ppo": ckpt_ppo,
                                  "ckpt_dqn": ckpt_dqn["gather_rows"],
                                  "chaos_ppo": chaos_ppo, "stream_impala": stream_impala,
                                  "restore_dqn": restore_dqn["gather_rows"],
                                  **{name: run["gather_rows"] for name, run in offpolicy.items()},
                                  "apex": apex["gather_rows"], "sac_async": sac_async["gather_rows"],
                                  "impala_fused": impala_fused["gather_rows"],
                                  "apex_ddpg": apex_ddpg["gather_rows"],
                                  "dqn_interleave": interleave["gather_rows"],
                                  "host_tree": host_tree["gather_rows"],
                                  "simple_q": simple_q["gather_rows"]}
    gae["launches_by_path"] = {"lane": lane_gaes, "telemetry": telemetry_gaes,
                               "transformer_lane": tf_lane["gae"],
                               "cartpole": cartpole, "gridrooms": gridrooms,
                               "ponglite_learn": pong_learn,
                               "lane_eval": lane_eval["compute_gae_fragment"]}
    scatter["launches_by_path"] = {"dqn": dqn["scatter_rows"],
                                   "transformer_dqn": tf_dqn["scatter_rows"],
                                   "sac_learner": sac_learner["uniform"]["scatter_rows"],
                                   "sac_learner_prioritized": sac_learner["prioritized"]["scatter_rows"],
                                   "sac": sac["scatter_rows"], "ckpt_dqn": ckpt_dqn["scatter_rows"],
                                   "restore_dqn": restore_dqn["scatter_rows"],
                                   **{name: run["scatter_rows"] for name, run in offpolicy.items()},
                                   "apex": apex["scatter_rows"],
                                   "sac_async": sac_async["scatter_rows"],
                                   "offline_sac_writer": offline_sac_writer,
                                   "apex_ddpg": apex_ddpg["scatter_rows"],
                                   "dqn_interleave": interleave["scatter_rows"],
                                   "host_tree": host_tree["scatter_rows"],
                                   "simple_q": simple_q["scatter_rows"]}
    descent["launches_by_path"] = {"dqn": dqn["find_prefixsum"],
                                   "transformer_dqn": tf_dqn["find_prefixsum"],
                                   "sac_learner_prioritized": sac_learner["prioritized"]["find_prefixsum"],
                                   "ckpt_dqn": ckpt_dqn["find_prefixsum"],
                                   "restore_dqn": restore_dqn["find_prefixsum"],
                                   "rainbow": rainbow["find_prefixsum"],
                                   "apex": apex["find_prefixsum"],
                                   "apex_ddpg": apex_ddpg["find_prefixsum"],
                                   "dqn_interleave": interleave["find_prefixsum"],
                                   "simple_q": simple_q["find_prefixsum"]}
    flash["launches_by_path"] = {"transformer_learner": tf_learner,
                                 "transformer_lane": tf_lane["flash"],
                                 "transformer_dqn": tf_dqn["flash_attention"],
                                 "serve_torso": serve_torso, "gtrxl_ppo": gtrxl,
                                 "recurrent_serve": recurrent_serve}
    flash_block["launches_by_path"] = {"ring": ring["gloo"], "ring_nccl_world_1": ring["nccl_world_1"],
                                       **({"ring_nccl": ring["nccl"]} if "nccl" in ring else {})}
    kernels = [gather, gae, scatter, descent, flash, flash_block]
    for k in kernels:
        k["launches"] = sum(k["launches_by_path"].values())
    say("timing", sum_seconds=f"{sum(PHASE_SECONDS):.1f}", phases=len(PHASE_SECONDS),
        cut_seconds=f"{sum(old - new for _, old, new, unit in budget_cuts() if unit == 's'):.1f}",
        cut_calls=sum(old - new for _, old, new, unit in budget_cuts() if unit == "calls"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
