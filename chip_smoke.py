#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one card

Phases, in order; any failure exits non-zero before the result line:

1. Device: the card's name, capability and power limit; needs sm_90.
2. Build: every hand-written kernel from the sources in the checkout, one
   nvcc per source, all started together; registers and spills of every
   instantiation, and the tensor-core and bulk-copy instructions in the
   SASS (every wgmma instantiation must contain HGMMA).
3. Forward kernel vs plain: the flash forward's wrapper on the card, held
   against its plain PyTorch version on the same inputs (the main paths'
   shapes included, the context window with and without episode resets),
   with the kernel's, the plain version's and a library call's times
   (CUDA events and profiler device time), the card's least time for the
   same work, and the wrapper's host time per call by part.
4. Backward vs plain: the flash backward on o and lse from the forward
   kernel and a seeded dO, each case through the design its shape picks
   (the fused one-tile kernel at Tq, Tk <= 64, the dQ and dK/dV kernels
   past it), over the forward's segment layouts; times as in phase 3,
   with SDPA's backward as the library call.
5. Serve: the full-width TransformerNet behind two Replicas (the act
   step at T=1 and a 2048-step context window), a few requests each,
   replies held against the same forward with plain dense attention
   on the CPU; the forward kernel's launch count must rise during each
   service. Telemetry (the phase's own Telemetry): each replica's
   serving_admitted_total == serving_completed_total == the requests
   sent, no rejection, shed or failure, serving_batch_rows_total equal
   to the fill histogram's sum times the batch size, one replica step a
   batch. Those first requests warm the replica; then STEADY_WAVES more
   waves of 4 requests each, two waves in flight, every reply held as
   above, give the steady {service}_replica ledger (queue_wait, linger,
   infer, other): the difference of the scope's cumulative counters
   from the warm-up's, and per-batch medians, beside the requests a
   second and the batch forward's CUDA-event time. The registry's
   Prometheus text parsed by the port's parse_prometheus into the
   values of snapshot().
5b. Serve over the RPC: a child process (this script with --rpc-child)
   holds two Rpc peers, replica-0 and replica-1, each with an act
   Replica of phase 5's TransformerNet on the card, replica-0 also the
   context Replica. This process's Rpc reaches them: 64 act batches'
   worth of requests through a Router over both replicas, 32 context
   batches' worth by direct call_with_deadline to replica-0, two waves
   of 4 in flight, every reply held against phase 5's dense forward on
   the CPU at SERVE_TOL; then 8 context batches again with this
   process's sends pinned to the shm lane, and 8 with both peers on tcp
   only; then publish_weights of a second seeded state_dict
   (tensors on the wire) to every replica, after which the replies
   follow the new weights and every .health reports version 2. The
   child's flash forward launch count is reset before each run and
   must be above 0 after it. Each replica peer's __telemetry (JSON
   and Prometheus) must count every request it was sent as admitted
   and completed; estimate_offset against replica-0; crawl_cohort over
   both peers, each bundle validated. [rpc] lines: both native codecs'
   paths, the lanes, and per service and transport the requests a
   second, request median and p90, MB a request and MB/s beside phase
   5's local numbers; the child exits 0 when its stdin closes.
6. Train: 3 IMPALA/V-trace steps of the full-width TransformerNet on
   learn batches [T+1=21, B=32], held against the same steps with dense
   attention on the CPU; each step must launch the forward and the fused
   backward kernel twice (once per layer), the dQ and dK/dV kernels and
   the two-kernel design's delta ops never; the grad-step / apply-step
   split must give the same result; steady-state step time and one step
   under torch.profiler, with the CUDA API calls (cuda* and cu*) the
   host made in it (those that can block it counted apart: synchronizes,
   allocations, frees). Then the StepScope ledgers (the phase's own
   Telemetry): 8 steps of the fused step built with stepscope= (staging
   the learn batch from the host, fwd_bwd, host_sync reading the metrics
   back), still two forward and two fused backward launches a step, and
   8 of the grad/apply split (fwd_bwd, optimizer), every scoped call
   under CUDA's sync debug mode "error" (a scoped step must not wait
   for the device); each phase's median, other and the host-blocked
   fraction beside the profiler's device-busy time; every ledger must
   close (overrun gauge 0, phases summing to the wall time); and
   telemetry's cost, stepscope=None against a live scope in (plain,
   scoped, scoped, plain) turns, reported, not gated.
7. Context backward: autograd through attention(backend="auto") at the
   context shape with the repo's resets, held against dense attention's
   autograd on the card; the dQ and dK/dV kernels launch once each.
8. Impala learner: the full-width ImpalaNet (experiment.py's default
   model on pixel envs) trained 3 steps on learn batches [T+1=21, B=32]
   with experiment.py's RMSprop chain, in f32 and in bf16, held against
   the same steps on the CPU; the grad-step / apply-step split; the
   steady step's time and one step profiled (device time by kernel
   class, the forward's, V-trace's and the optimizer's spans); the LSTM
   variant's act step for 32 envs, its state threaded over 4 steps,
   against the CPU; then bench_torch.py at B=256 (its JSON line) and one
   of its steps profiled. No flash kernel runs on this path. The f32
   and bf16 train steps get phase 6's ledgers and cost, and the act
   step its own (act, then host_sync reading the actions and logits
   back).
9. Accumulate: the elastic gradient plane. A port Broker and learner-0
   here, learner-1 in a child (this script with --acc-child), each with
   the full-width TransformerNet as phase 5 builds it, experiment.py's
   RMSprop chain, make_grad_step(grad_scale=32) on a seeded learn batch
   of its own and an Accumulator(virtual_batch_size=64,
   parallel_gradients=1) over a Group of the two (get_state/set_state
   under a state lock; cuDNN deterministic). 6 updates, each learner
   contributing once an update under CUDA's sync debug mode "error"
   (reduce_gradients must not wait for the card), the mean going back
   onto the card pinned and non-blocking before the apply; update 1's
   mean held against the same peers' grad steps on the CPU with dense
   attention (phase 6's gradient tolerance); after every update every
   learner's params hold the same bits (per-tensor checksums of the raw
   bits, compared over the control channel). Then learner-2 (another
   seed) joins in the child, takes the leader's state (its params and
   nu equal the leader's bits), and the three train 4 more updates; the
   GlobalStatsAccumulator sums every learner's env_steps exactly. The
   two-learner part again with MOOLIB_TPU_ALLREDUCE_CHUNK=1048576 (the
   child's environment; learner-0 passes the same chunk_bytes): the
   2.93 MB bundle goes chunked, and the params equal the first run's
   at every version. Then 3 updates of the full-width f32 ImpalaNet
   over two learners, under the same checks and with no flash kernel.
   flash_fwd and flash_bwd_tile must launch in both processes. [acc]
   lines: updates/s; per update the grad step (CUDA events),
   reduce_gradients (host), the acc_grad_round ledger and the apply
   (CUDA events); wire MB per gradient round by lane; the leader;
   group_rounds_total; then bench_allreduce_torch.py's JSON lines (4
   peers, the reference's three sizes) from a process of its own.
10. Flight bundles: one incident bundle per phase's Telemetry (serve,
   train, impala), captured through the api trigger into
   build/flightrec/; each must load and validate, record only MOOLIB,
   TORCH, PYTORCH, CUDA and NCCL environment keys, and (train and
   impala) carry a step_phases event of every scoped loop.
11. E2E: the acting plane and experiment.py's loop. (a) A port EnvPool
   of 2 workers x 16 SyntheticAtari envs (episodes of 7 steps, seeded
   by index) stepped with a fixed action script through two
   EnvBatchStates and a learn Batcher(32, dim=1, dims={"core_state":
   0}) up to two learn batches [21, 32], each equal bit for bit to the
   same envs stepped here by a plain loop; the first batch through
   stage_batch onto the card, the full-width TransformerNet's grad step
   on it held against the same step on the CPU at phase 6's
   tolerances; a pool with device="cuda" whose staged step equals the
   plain loop's. (b) train() of experiment.py, model=transformer, for
   E2E_SECONDS with its defaults (32 envs, 2 workers, T=20, learn batch
   32, ClippedRMSprop, bf16), checkpointing at every chance into
   build/e2e/, then an E2E_RESUME_SECONDS resume from it, then the same
   loop for E2E_PLAIN_SECONDS
   without a savedir, its updates [10, 13) traced by profile_dir
   (torch.profiler). Checks: at least 10 updates, finite losses, global
   env steps counted, model_version carried over, flash_fwd and
   flash_bwd_tile launched ("e2e transformer" in launches_by_path, over
   the three runs), no env worker died (train() would retry the step).
   Readings: env-steps/s and updates/s from the first logged row to the
   last, skips and dropped unrolls, the vtrace_learner ledger (median
   and mean ms per phase, other, the host-blocked share), the windows'
   mean episode return beside a uniform policy's 200/6; for the run
   without a savedir, its rates and ledger, the device's busy time and
   idle share in the traced window, and the
   host's heaviest CUDA runtime calls and operators there. (c)
   bench_e2e_torch.py (the bf16 ImpalaNet loop at B=64,
   E2E_BENCH_SECONDS) in a
   process of its own: its JSON line, its ledger and its env worker
   deaths (none allowed) from the JSON line it prints on stderr, and its
   rate beside phase 8's bench_torch.py learner-only rate. [e2e] lines.
12. Zoo: the remaining model families and example entry points. (a)
   The MoE TransformerNet (phase 5's width, transformer_mlp=moe: 8
   experts, top-2, capacity factor 1.25) behind an act and a context
   Replica: the checked batches' stacked inputs, padding included (an
   MoE reply depends on its batch: capacity is over the call's tokens),
   go through the same model with dense attention on the CPU, first
   holding the router probabilities against the card's (the tokens
   whose top-2 set differs counted with their margins), then seating
   with the card's probabilities, outputs at SERVE_TOL; flash_fwd
   launches in both services; steady requests a second and latency,
   the drop fraction, peak device memory at the context shape. (b)
   Three V-trace steps of it with the aux folded in on [21, 32] against
   the CPU on the card's routing (phase 6's tolerances); two flash_fwd
   and two flash_bwd_tile launches a step, dQ and dK/dV none; the step's
   time and one profiled step. (c) experiment.py's train() with
   transformer_mlp=moe, no savedir, ZOO_E2E_SECONDS: at least 10
   updates, finite
   losses, moe_drop_fraction logged. (d) NetHackNet's f32 grad step on
   a learn batch of config_nethack.yaml's shape against an f64 step
   (each tensor within the larger of 1e-3 and 3x the CPU f32 step's own
   distance), the same bounds failed by a trunk with TF32 convolutions
   and by a bf16 trunk; then
   train() at config_nethack.yaml's settings for NETHACK_SECONDS (4 actor
   processes, not 8): updates, finite losses, no env worker death, the
   LSTM state carried into the unrolls. (e) examples/a2c.py on CartPole
   at LEARNING_r04.json's settings (80,000 steps; bench_a2c_torch.py
   --seeds 0 in a child process): return > 100 in at
   least 10 of the last 20 windows and the last 10 windows' entropy in
   (0.05, 0.69); its curve; then the pixel A2C smoke (bf16 ImpalaNet).
   (f) examples/remote_actors.py: run_learner on the card (synthetic
   env, the f32 ImpalaNet; then CartPole) fed by three run_actor child
   processes for REMOTE_ACTOR_SECONDS each, stopped once they have
   exited: updates, and
   an infer forward stacking more than
   one actor call (the learner Rpc's rpc_batch_fill_fraction); then the
   synthetic learner fed by two (each with one call in flight, they may
   convoy and never stack): updates. No flash
   kernel may launch on the nethack, a2c and remote actors paths. [zoo]
   lines; readings carry the card's name and power limit.
13. Durable state and the fleet. (a) A port Broker here and three
   learner processes (this script with --acc-child BROKER CTL_NAME),
   each one phase 9's learner of the full-width TransformerNet on learn
   batches [21, 32] through an Accumulator (virtual batch 64, group
   timeout 8 s) with a StateStore under build/statestore/ (1 MiB chunks)
   on its Rpc. 4 updates with no Replicator (the updates/s without
   durability), then a Replicator(followers=2) on each, whose state_fn
   is train_state_to_host under the sync-mode and state locks, for 12
   more (latest-wins: a version may be skipped, none published without
   the store's and both followers' acks); training pauses until the
   leader's last version is on all three stores. The leader's process is SIGKILLed and its store
   deleted; a fresh process on the same name restores with quorum 2
   from the two survivors onto the card (load_train_state), seeds
   set_model_version and rejoins. Checks: the restored version is the
   leader's last, its manifest hash is the one the leader published,
   the sha256 of the state read back off the card equals that of the
   host copy the leader's state_fn produced for that version, the
   holders are the survivors, and the cohort commits 3 more versions.
   (b) Two act Replicas of the TransformerNet on the card behind a
   Router; publish_from_statestore(router, store, peers=survivors,
   quorum=2) from a fresh store here loads the newest version (its sha
   the publisher's) into both; every reply after it is held against the
   dense CPU forward with that version's parameters at SERVE_TOL, and
   both replicas' health reports the version. (c) A fleet Controller
   (FleetSpec.small(replicas=2, routers=1), in-process) whose replicas
   serve the act step on the card from the restored version, with a
   standby controller sharing its cohort: 4 closed-loop clients drive
   act requests through ctl.router() (budget 8 s each, tests/
   test_fleet.py's) during a rollout of the parameters of one more
   train step (must end "promoted"; the promoted replies held against
   the CPU) and of a poisoned build that raises on the canary (must end
   "rolled_back", its incident bundle validated by load_bundle, both
   replicas back on the promoted version), then across ctl.kill()
   until the standby has adopted (epoch 2) and 48 more requests were
   served; no request may fail. flash_fwd and flash_bwd_tile must
   launch on the learners' and the fleet's paths, flash_fwd on the
   serve path. [statestore] and [fleet] lines: bundle MB and chunks,
   publish ms (local write, push to one follower), versions published
   per committed version, updates/s with the Replicators off and on,
   restore ms (negotiate; restore = a second negotiation, the pull and
   decode, and the local write of the pulled bundle, that write apart;
   upload onto the card), the
   rejoin, materialize, promote, rollback and adoption seconds, and
   requests/s and failed requests during each rollout.
14. Chaos and parity. (a) The port's chaos soak in a child process,
    ``python -m moolib_tpu_torch.tools.chaos_soak --smoke --restrack
    --locktrace --device cuda``: all 18 scenarios must pass with no
    leaked thread, shm segment, Rpc or gauge, the serving and fleet
    scenarios' replicas on the card (its stderr in
    build/chaos_soak.log), and the observed lock-order edges must be
    above 0, acyclic and inside static_package_edges() (phase 17 (e)). (b) Three Replicas of phase
    5's act step (32 envs at T=1, BATCH 4) on the card behind a port
    Router; after two warm-up waves of 8 requests through the Router
    (replies checked, not counted), 8 closed-loop clients send 240
    requests (budget 8 s each)
    and after 60 completed ones a FaultPlan seeded 101 kills one
    replica's connections, then closes its peer. Every request must
    return or fail explicitly within budget + 5 s, none before the kill
    may fail and 80% after it must be served, the p99 after the kill
    must stay within 3x the p99 before (the baseline floored at 0.1 s,
    as scenario_replica_kill floors it), the injected log must be
    {"conn_kill": 1}, every reply must be within SERVE_TOL of the dense
    CPU forward and flash_fwd must launch. (c) ParityWatch (3 runs,
    bitwise) over each kernel at the main paths' shapes (flash_fwd at
    act, train, the context shape with resets and [8,4,2048,32] bf16;
    flash_bwd_tile at train; flash_bwd_dq and flash_bwd_dkdv at the
    context shape) and over phase 6's train step from one seeded state
    and batch (parameters, RMSprop's state, metrics); then the time of
    that step and of bench_torch.py's ImpalaNet step (B=256) with and
    without cuDNN's deterministic algorithms, in turns.
    [chaos] and [parity] lines.
15. Multi-device (every comparison at full width). (a) An NCCL world
    of one in this process, a mesh of five axes of size 1: phase 6's
    train step (learn batch [21, 32], bf16 compute, ClippedRMSprop)
    through make_impala_train_step(mesh=...) must equal the plain step
    from the same seeded state bit for bit (parameters, RMSprop's nu,
    metrics); ring_attention at sp=1 against the flash forward at the
    context shape [4, 4, 2048, 32] f32 with resets (1e-4); the psum
    plane of bench_allreduce_torch.py prints its single-device note.
    (b) A gloo world of 2 child processes sharing the card (this script
    with --md-child RANK STORE; a child that dies fails the phase):
    dp=2, the same step on halves of the batch, its parameter changes
    within phase 6's gradient tolerance of (a)'s plain step and the two
    ranks bitwise equal; sp=2, ring_attention and
    zigzag_sharded_attention at the context shape against the flash
    forward (o within 1e-4) and backward (dq, dk, dv within 1e-4 of each
    one's max), and TransformerNet(attention_backend="ring"/"zigzag")
    forward at the context shape within SERVE_TOL of the flash model;
    tp=2, the full-width forward at the act shape within SERVE_TOL of
    tp=1 and one train step within phase 6's gradient tolerance of
    (a)'s; pp=2, pipeline_apply (with and without remat) and
    pipeline_train_1f1b at the dry run's stage tanh(x @ w), F=128,
    against the sequential model (1e-5 of max; remat against stashing
    1e-6); ep=2, moe_ffn_sharded at 128->512->128, 8 experts, top-2,
    capacity factor 1.25, on the act's 128 tokens and the context's
    8192, against moe_ffn on each rank's tokens at its seats and on all
    of them where nothing drops (1e-5 of max). [md] lines: each leg's
    ms on each rank (a second call, synchronized, host clock), the bytes
    it handed to the collectives, peak card memory, and the card's name
    and power limit; each says that the ranks share one card and gloo's
    transport goes through the host: no interconnect measurement.
    flash_fwd and flash_bwd_tile must launch on "md dp".
15b. The experiment's data-parallel learner ([dp] lines):
    train(model=transformer) at experiment.py's defaults (32 envs, T=20,
    learn batch 32, bf16) on devices=["cuda:0", "cuda:0"], a dp world of
    two ranks sharing the card (parallel/local_dp.py, gloo, the second
    rank a spawned follower), for DP_SECONDS. (a) Its first GRAD: rank
    0's dp-mean gradients held against the dp=1 grad step on the same
    learn batch [21, 32] and parameters at phase 6's gradient
    tolerances (rank 0's launches of that check are not counted). (b)
    The run: env-steps/s and
    updates/s beside phase 11's dp=1 loop without a savedir, each
    command's send ms (GRAD, APPLY, STATE, STOP), each rank's flash_fwd
    and flash_bwd_tile launches (both ranks must launch both; their sum
    is the "dp train" path), the follower's updates equal to rank 0's
    and the ranks' parameter checksums equal (difference exactly 0).
    Every [dp] line says the ranks share one card: no figure there is an
    interconnect figure.
16. Perfwatch (about 90 s). (a) attn_bench's flash validation at
    [2, 2, 512, 128] bf16 causal against the dense oracle (its
    tolerances: forward 0.05, gradients 1.0) and its rows: dense at
    T=2048, blockwise and flash at T=2048 and 8192, (B, H, D) = (1, 8,
    128), bf16, causal, a training-shaped step timed by time_chained
    (--budget 60 s); flash_fwd, flash_bwd_dq and flash_bwd_dkdv must
    launch ("attn bench"). Then the three kernels at those shapes with no
    segments against their plain versions (phases 3-4's tolerances), with
    device ms, the bound, plain and SDPA (is_causal, the same function)
    times. (g) perf_sweep's B=256 bf16 config (env-steps/s, MFU). (b)
    the perf CLI's suite (python -m moolib_tpu_torch.tools.perf --suite
    cpu-proxy --smoke, a child process) on the card: all 15 rows
    non-null, e2e_learner_step_s with steady_d2h 0 and compile_delta 0
    under its Hotwatch, no budget breach, no flash launch ("suite", the
    child's counts). (c) --check-trends over the store that (a), (g) and
    (b) wrote must pass, and over a copy with a planted regression must
    fail. (d) find_batch_size over phase 5's act step, 32 to 4096 envs,
    the knee printed; flash_fwd must launch ("bsf act"); then the act
    step once more at each measured batch size, every flash_fwd call's
    inputs and outputs kept at the wrapper and held against the plain
    version (phase 3's tolerances). (e) the
    roofline's attainable MFU beside phase 8's measured one. (f)
    telemetry_smoke's checks: the scrape round trip, trace propagation,
    the disabled recorder's silence and the disabled-mode overhead under
    5% of the RPC echo. [perf] lines carry the card's name and power
    limit; the phase prints its seconds.
17. The operator plane (target 150 s). (a) ``python -m
    moolib_tpu_torch.examples.launch local --peers 2`` starts the port's
    broker and two experiment.py peers of the full-width TransformerNet
    on the card (experiment.py's transformer width, phase 6's learn
    batch [21, 32] in bf16, the synthetic env, tracing on), each bounded
    by OPS_LAUNCH_SECONDS: both exit 0 with updates in one group, every
    window that holds a local gradient step (its grad_steps column)
    logs a finite loss and every window without one logs NaN (an empty
    mean), at least two windows with steps a peer, and the flash_fwd
    and flash_bwd_tile launches each peer prints at its end summed into
    "launch transformer" (both must be above 0; the kernels' agreement
    with their plain versions at these shapes is phases 3, 4 and 6's).
    (b) While they train, telemetry_dump (--spans --prometheus
    --bundle), incident_report and stepscope_report --connect dial the
    broker's address alone: both peers found by each, the Prometheus
    texts parse, every bundle validates, the merged timeline is in time
    order with no handle span before its call, and each peer's
    vtrace_learner ledger closes on its wall time (5%). (c) elastic_soak
    with card peers, 102 s, a kill every 15 s (the reference's 25 s in
    five minutes, scaled to fit), a 45 s stall window (the reference's):
    its three criteria, which these settings make bite: the tool exempts
    a replacement born within its last kill interval and 30 s, and the
    replacement born at the second kill (the third kill takes the
    other original peer) is born before that, so it must train; this
    phase also requires that every replacement born before that line
    and never killed reached its first update while the soak ran (its
    seconds to it, rejoin_s, are a reading).
    (d) config_matrix --seconds 10 on the card: all five configs with env
    steps, updates and a finite loss (a child a config, all five at
    once). (e) chaos_soak --smoke --locktrace --device cuda: phase 14's
    soak, which runs under the lock tracer on a quiet host (beside this
    phase's other parts two of its timed gates failed once): 18
    scenarios, observed edges above 0, acyclic and inside
    static_package_edges(). (c) starts with (a), (d) and (f) once (a)'s
    peers have updated. (f) On the card
    machine's host, beside the other parts: allreduce_decomp at its
    defaults (the host's cpu_count reported), allreduce_latency_ab --mb
    8 and env_packages_report (no network probe); gen_api_docs --check
    and learning_curve's artifact keys need no card and are the CPU
    tests' (tests/test_torch_tools_ops.py). [ops] lines carry the card's
    name and power limit; outputs go under build/ops/; the phase prints
    its seconds.
18. The kernels line (with the ledgers, the bundles' summaries and the
    RPC, accumulate, e2e, zoo, statestore and chaos phases' readings;
    launches_by_path includes "rpc act" and "rpc context", the child's
    launches, "acc", both processes' launches in the accumulate phase's
    transformer runs, "e2e transformer", the transformer loop's, the
    zoo's "moe act", "moe context", "moe train", "e2e moe", "nethack",
    "a2c" and "remote actors", phase 13's "statestore learners",
    "statestore serve" and "fleet", and phase 14's "chaos replica
    kill", "parity kernels" and "parity train", and phase 15's "md dp
    nccl", "md sp nccl", "md dp", "md sp", "md tp", "md pp" and "md
    ep", phase 15b's "dp train" (both ranks' sum), phase 16's "attn bench", "bsf act" and "suite", and phase 17's
    "launch transformer", the launched peers' sum; each attention
    kernel's row carries its phase 16 rows at D=128), the card line, and
    the result line.

Lines tagged [telemetry], [stepscope] and [flightrec] carry the
observability checks and readings, [rpc] lines the RPC phase's, [acc]
lines the accumulate phase's, [e2e] lines the e2e phase's, [zoo] lines
the zoo phase's, [statestore] and [fleet] lines phase 13's, [chaos] and
[parity] lines phase 14's, [md] lines phase 15's, [dp] lines phase
15b's, [perf] lines phase 16's, [ops] lines phase 17's; a [total] line
gives the script's seconds.

    python3 chip_smoke.py --races N

repeats two harness races' paths N times each, every other time beside
a CPU hog (one busy process for every other core): phase 9's
bench_allreduce_torch.py (its tree peers leave only once all have their
last result) and phase 12 (f)'s remote actor runs (the learner stops
once its actors have exited). It prints a [races] line for each run and
a JSON line of the pass counts, and exits non-zero unless every run
passed.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
# f32 on the CUDA cores, bf16 and TF32 on the tensor cores.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, "tf32": 495e12}

ACT_ENVS = 32          # environments per act request
CONTEXT_T = 2048       # steps per context request (the model's max_len)
BATCH = 4              # Replica batch_size for both services
# Replies vs the same forward with dense attention on the CPU: f32
# summation order only (the model keeps cuDNN's TF32 off).
SERVE_TOL = 1e-4
# The repo's traffic: experiment.py's synthetic env ends every episode
# after exactly 200 steps (VtraceConfig.episode_length at
# moolib_tpu/examples/vtrace/experiment.py:56, SyntheticAtari.step in
# moolib_tpu/examples/envs.py), so each env resets once every 200 steps,
# at a phase of its own.
EPISODE_LENGTH = 200
ACT_SHAPE = (BATCH * ACT_ENVS, 4, 1, 32)     # [B, H, T, D] of the act step
CONTEXT_SHAPE = (BATCH, 4, CONTEXT_T, 32)    # [B, H, T, D] of a context batch
# The learn batch of moolib_tpu/examples/vtrace/experiment.py:61-63:
# learn_batch_size 32 envs, unroll_length 20 (+1 bootstrap frame).
LEARN_B, UNROLL = 32, 20
TRAIN_SHAPE = (LEARN_B, 4, UNROLL + 1, 32)   # [B, H, T, D] of a train step
TRAIN_STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel, iters: int = 20, floor_ms: float = 0.0,
              takes: int = 1):
    """Mean device time of the CUDA kernels whose name holds ``kernel``
    (every kernel when ``kernel`` is None) over ``iters`` calls of ``fn``,
    from torch.profiler traces (host gaps between launches excluded): the
    highest of ``takes`` traces that read more than ``floor_ms`` (pass the
    work's bound: no reading below it is possible). None if no trace
    does."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A trace now and then comes back without some or all of the kernels'
    # records, never with more: such a trace is taken again (eight tries:
    # three in a row came back empty once on an H100 80GB HBM3), and of
    # several the highest is kept (SDPA's backward at [1,8,2048,128] bf16
    # read 0.0136 and 0.0228 ms, below and just above its bound of 0.0217
    # ms, where whole traces read 0.092 ms).
    kept = []
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if kernel is None or kernel in e.key)
        if us and us / iters / 1e3 > floor_ms:
            kept.append(us / iters / 1e3)
            if len(kept) == takes:
                break
        elif us:
            log(f"[profiler] a trace of {kernel or 'every kernel'} read "
                f"{us / iters / 1e3:.4f} ms, below the bound {floor_ms:.4f} "
                f"ms (records lost): taken again")
    if len(kept) > 1 and max(kept) > 1.5 * min(kept):
        log(f"[profiler] traces of {kernel or 'every kernel'} read "
            + ", ".join(f"{ms:.4f}" for ms in kept)
            + " ms: the highest kept (records lost in the others)")
    return max(kept) if kept else None


def episode_segments(gen: torch.Generator, B: int, T: int,
                     every: int = EPISODE_LENGTH) -> torch.Tensor:
    """[B, T] int32 segment ids of lanes that reset every ``every`` steps
    (EPISODE_LENGTH, the repo's traffic, unless given), each at a random
    phase."""
    phase = torch.randint(0, every, (B, 1), generator=gen, device="cuda")
    done = (torch.arange(T, device="cuda") + phase) % every == 0
    return torch.cumsum(done.int(), dim=1, dtype=torch.int32)


def visible_pairs(seg_q, seg_k, H: int, causal: bool) -> int:
    """(query, key) pairs the function must compute: same segment and,
    when causal, key <= query; counted from this run's segment ids."""
    total = 0
    Tq, Tk = seg_q.shape[1], seg_k.shape[1]
    for b in range(seg_q.shape[0]):
        vis = seg_q[b][:, None] == seg_k[b][None, :]
        if causal:
            vis &= (torch.arange(Tq, device=vis.device)[:, None]
                    >= torch.arange(Tk, device=vis.device)[None, :])
        total += int(vis.sum())
    return total * H


def flash_bound_ms(q, k, seg_q, seg_k, causal: bool):
    """Least time for the flash forward on this card: bytes (q, k, v, o
    and segment ids read or written once, lse written once) over HBM
    bandwidth, against 4*D FLOPs per visible pair at the fastest rate
    that keeps the input type's accuracy: bf16 on the tensor cores; f32
    either on the CUDA cores or as 3xTF32 (three TF32 products for each)
    on the tensor cores, whichever is faster. Returns
    (ms, "bytes" | "operations")."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    item = q.element_size()
    nbytes = (2 * B * H * Tq * D + 2 * B * H * Tk * D) * item
    nbytes += B * H * Tq * 4 + (B * Tq + B * Tk) * 4
    flops = 4 * D * visible_pairs(seg_q, seg_k, H, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    if q.dtype == torch.float32:
        t_ops = min(t_ops, 3 * flops / PEAK_FLOPS["tf32"])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bwd_bounds_ms(q, k, seg_q, seg_k, causal: bool):
    """Least times of the backward kernels on this card: bytes (each input
    read once: q, k, v, dO, lse and segment ids, with delta for the dQ and
    dK/dV kernels or o for the fused one; the outputs written once) over
    HBM bandwidth, against FLOPs per visible pair (dQ 6*D: s, dp, dQ; dK/dV
    8*D: s, dp, dV, dK; the fused kernel 10*D: s and dp once, then dQ, dK
    and dV, plus 2*D a row for delta) at the fastest rate that keeps the
    input type's accuracy, as for the forward: bf16 on the tensor cores;
    f32 the faster of the CUDA cores and 3xTF32. Returns {kernel: (ms,
    by)}."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    item = q.element_size()
    rows_q, rows_k = B * H * Tq * D * item, B * H * Tk * D * item
    ins = 2 * rows_q + 2 * rows_k + B * H * Tq * 4 + (B * Tq + B * Tk) * 4
    pairs = visible_pairs(seg_q, seg_k, H, causal)
    out = {}
    for name, nbytes, flops in (
        ("flash_bwd_dq", ins + B * H * Tq * 4 + rows_q, 6 * D * pairs),
        ("flash_bwd_dkdv", ins + B * H * Tq * 4 + 2 * rows_k, 8 * D * pairs),
        ("flash_bwd_tile", ins + rows_q + rows_q + 2 * rows_k,
         10 * D * pairs + 2 * D * B * H * Tq),
    ):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[q.dtype]
        if q.dtype == torch.float32:
            t_ops = min(t_ops, 3 * flops / PEAK_FLOPS["tf32"])
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def layout_segments(layout: str, gen: torch.Generator, B: int, Tq: int,
                    Tk: int):
    """(seg_q, seg_k) int32 of a segment layout: "episodes" (a reset every
    EPISODE_LENGTH steps), "none" (no reset in the window), "kv masked"
    (the second half of the queries has a segment no key has),
    "alternating" (ids that go back and forth: no tile can be skipped),
    "boundaries" (at a multiple of 64 and one step either side of one),
    "disjoint" (kv ids no query shares: every row fully masked) and
    "tq_ne_tk" (resets every 70 steps, Tq != Tk)."""
    t = torch.arange(Tq, device="cuda")
    if layout == "episodes":
        seg_q = episode_segments(gen, B, Tq)
    elif layout == "none":
        seg_q = torch.zeros((B, Tq), dtype=torch.int32, device="cuda")
    elif layout == "kv masked":
        seg_q = episode_segments(gen, B, Tq)
        seg_q[:, Tq // 2:] = 7
        return seg_q, torch.zeros((B, Tk), dtype=torch.int32, device="cuda")
    elif layout == "alternating":
        seg_q = ((t // 37) % 2).int().expand(B, Tq).contiguous()
    elif layout == "boundaries":
        seg_q = ((t >= 128).int() + (t >= 191).int() + (t >= 257).int())
        seg_q = seg_q.expand(B, Tq).contiguous()
    elif layout == "disjoint":
        return (episode_segments(gen, B, Tq, 40),
                episode_segments(gen, B, Tk, 40) + 1000)
    elif layout == "tq_ne_tk":
        return (episode_segments(gen, B, Tq, 70),
                episode_segments(gen, B, Tk, 70))
    else:
        raise ValueError(layout)
    return seg_q, seg_q


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    log(f"[device] {name} capability {cap} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"needs an sm_90 card (H100); got {cap}")
    return name, smi


def _ptxas_lines(log: str):
    """(kernel, line) for each register, spill, warning or performance
    line of ptxas -v (C7515-C7520 say that the wgmmas were serialized)."""
    name = "?"
    for line in log.splitlines():
        m = re.search(r"(flash_[a-z_]+_kernel)ILi(\d+)E(f|13__nv_bfloat16)",
                      line)
        if m and ("Compiling entry" in line or "Function properties" in line):
            dtype = "f32" if m.group(3) == "f" else "bf16"
            name = f"{m.group(1)}<D={m.group(2)},{dtype}>"
        elif any(w in line for w in ("registers", "spill", "warning",
                                     "Performance Loss")):
            yield name, line.strip()


def _sass_counts(library) -> dict:
    """{kernel<D,dtype>: {instruction: count}} of the tensor-core and
    bulk-copy instructions in each kernel of a built library, from
    cuobjdump -sass (the toolkit's)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(flash_[a-z_]+_kernel)ILi(\d+)E(f|13__nv_bfloat16)",
                          line)
            name = None
            if m:
                dtype = "f32" if m.group(3) == "f" else "bf16"
                name = f"{m.group(1)}<D={m.group(2)},{dtype}>"
                counts[name] = {}
        elif name is not None:
            for ins in ("HGMMA", "HMMA", "UBLKCP"):
                if re.search(rf"\b{ins}\b", line):
                    counts[name][ins] = counts[name].get(ins, 0) + 1
    return counts


def phase_build():
    from moolib_tpu_torch.analysis import RecompileGuard, guarded_jit
    from moolib_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    # recompile_guard on the kernel builds: building every source must
    # be exactly one first-use build per library (none was built before).
    build_all = guarded_jit(_kernels.build_all)
    with RecompileGuard(build_all, max_compiles=len(_kernels.LIBRARIES),
                        label="build_all") as guard:
        build_all()
    if guard.compiles != len(_kernels.LIBRARIES):
        raise RuntimeError(f"build_all made {guard.compiles} library builds; "
                           f"want one per source "
                           f"({len(_kernels.LIBRARIES)})")
    log(f"[build] {len(_kernels.KERNELS)} kernels from "
        f"{len(_kernels.LIBRARIES)} sources ready in "
        f"{time.perf_counter() - t0:.1f}s (nvcc in parallel: "
        + ", ".join(f"{lib.source.name} {lib.build_seconds}s"
                    for lib in _kernels.LIBRARIES) + ")")
    for lib in _kernels.LIBRARIES:
        lines = list(_ptxas_lines(lib.build_log))
        for name, line in lines:
            log(f"[build] {lib.source.name} {name}: {line}")
        entries = set(re.findall(
            r"Compiling entry function '\S*?(flash_\w+_kernelILi\d+E\w+?)E",
            lib.build_log))
        with_regs = {name for name, line in lines if "registers" in line}
        if not entries or len(with_regs) < len(entries):
            raise RuntimeError(f"{lib.source.name}: ptxas register lines "
                               f"for {len(with_regs)} of {len(entries)} "
                               f"kernels")
    counts = {}
    for lib in _kernels.LIBRARIES:
        lib_counts = _sass_counts(lib.library_path())
        for name, c in sorted(lib_counts.items()):
            log(f"[build] {lib.source.name} {name} SASS: {c.get('HGMMA', 0)} "
                f"HGMMA, {c.get('HMMA', 0)} HMMA, {c.get('UBLKCP', 0)} UBLKCP")
        counts.update(lib_counts)
    # Every wgmma design's instantiation (3 head dims x 2 dtypes) must
    # contain tensor-core instructions.
    for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_kernel",
                   "flash_bwd_dkdv_kernel"):
        found = [n for n in counts if n.startswith(kernel + "<")]
        if len(found) != 6 or any(not counts[n].get("HGMMA") for n in found):
            raise RuntimeError(f"{kernel}'s instantiations lack tensor-core "
                               f"instructions: "
                               f"{ {n: counts[n] for n in found} }")
    return counts, guard.compiles


def _compare(o, lse, o_ref, lse_ref, o_tol_fn):
    if not torch.equal(torch.isinf(lse), torch.isinf(lse_ref)):
        raise RuntimeError("kernel and plain disagree on fully masked rows")
    fin = torch.isfinite(lse_ref)
    lse_err = float((lse[fin] - lse_ref[fin]).abs().max()) if fin.any() else 0.0
    o_err_t = (o.float() - o_ref.float()).abs()
    ok = bool((o_err_t <= o_tol_fn(o_ref.float().abs())).all())
    return float(o_err_t.max()), lse_err, ok


def wrapper_host_us(q, k, v, sq, sk, causal, iters: int = 200) -> dict:
    """Host time per call of the forward's wrapper (no synchronize in the
    loop, the launches queue) and of its parts: the input checks, the two
    output allocations, the stream lookup and the ctypes call with the
    launch itself."""
    from moolib_tpu_torch.ops import _kernels

    B, H, Tq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B * H, 1, Tq), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), sq.data_ptr(),
            sk.data_ptr(), o.data_ptr(), lse.data_ptr(), B * H, H, Tq,
            k.shape[2], D, int(causal), 0 if q.dtype == torch.float32 else 1,
            stream)
    def switch():
        with torch.cuda.device(q.device):
            pass

    parts = {
        "wrapper": lambda: _kernels.flash_fwd(q, k, v, sq, sk, causal),
        "checks": lambda: _kernels._check_attention("flash_fwd", q, k, v, sq,
                                                    sk),
        "allocations": lambda: (torch.empty_like(q), torch.empty(
            (B * H, 1, Tq), dtype=torch.float32, device="cuda")),
        "stream": lambda: torch.cuda.current_stream(q.device).cuda_stream,
        "ctypes call + launch": lambda: _kernels.FLASH_FWD._fn(*args),
        # What the wrapper no longer pays when the card is already the
        # current device: entering and leaving torch.cuda.device.
        "device switch (skipped)": switch,
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t0) / iters
        torch.cuda.synchronize()
    return out


def phase_kernel_vs_plain():
    from moolib_tpu_torch.ops import _kernels
    from moolib_tpu_torch.ops.attention import _flash_forward_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32_tol = lambda ref: 1e-4  # noqa: E731  summation order only
    # bf16 output: one rounding of the f32 result, 2**-7 relative.
    bf16_tol = lambda ref: 2.0 ** -7 * ref + 1e-5  # noqa: E731
    cases = [
        # name, (B, H, Tq, D), Tk, dtype, causal, segment ids: "episodes"
        # (resets every EPISODE_LENGTH steps), "none" (no reset in the
        # window) or "kv masked" (some query rows see no key)
        ("context (main path)", CONTEXT_SHAPE, CONTEXT_T, torch.float32,
         True, "episodes"),
        ("context (no resets)", CONTEXT_SHAPE, CONTEXT_T, torch.float32,
         True, "none"),
        ("act (main path)", ACT_SHAPE, 1, torch.float32, True, "episodes"),
        ("train (main path)", TRAIN_SHAPE, UNROLL + 1, torch.float32, True,
         "episodes"),
        ("B*H=32 T=2048 f32", (8, 4, 2048, 32), 2048, torch.float32, True,
         "episodes"),
        ("B*H=32 T=2048 bf16", (8, 4, 2048, 32), 2048, torch.bfloat16,
         True, "episodes"),
        ("T=20 unroll", (32, 4, 20, 32), 20, torch.float32, True,
         "episodes"),
        ("non-causal masked rows D=64", (2, 4, 256, 64), 384,
         torch.float32, False, "kv masked"),
        ("causal D=128 bf16", (2, 2, 512, 128), 512, torch.bfloat16, True,
         "episodes"),
        ("causal D=128 f32 ragged", (2, 2, 300, 128), 300, torch.float32,
         True, "episodes"),
    ]
    results = {}
    for name, (B, H, Tq, D), Tk, dtype, causal, segs in cases:
        q = torch.randn((B, H, Tq, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, H, Tk, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, H, Tk, D), generator=gen, device="cuda").to(dtype)
        seg_q = episode_segments(gen, B, Tq)
        if segs == "none":
            seg_q = torch.zeros_like(seg_q)
        if segs == "kv masked":
            # Keys carry segments no query of the second half has.
            seg_k = torch.zeros((B, Tk), dtype=torch.int32, device="cuda")
            seg_q[:, Tq // 2:] = 7
        else:
            seg_k = seg_q
        o, lse = _kernels.flash_fwd(q, k, v, seg_q, seg_k, causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = _flash_forward_plain(q, k, v, seg_q, seg_k, causal)
        tol = bf16_tol if dtype == torch.bfloat16 else f32_tol
        o_err, lse_err, ok = _compare(o, lse, o_ref, lse_ref, tol)
        if segs == "kv masked" and not torch.isinf(lse).any():
            raise RuntimeError("masked-rows case produced no masked row")
        if lse_err > 1e-4:
            ok = False
        tol_txt = ("2^-7*|o|+1e-5" if dtype == torch.bfloat16 else "1e-4")
        design = _kernels.flash_fwd_design(Tq, Tk)
        log(f"[kernel] flash_fwd {name}: q {tuple(q.shape)} Tk {Tk} "
            f"{str(dtype)[6:]} causal={causal} design {design} | "
            f"max|o-plain| {o_err:.3e} (tol {tol_txt}) max|lse-plain| "
            f"{lse_err:.3e} (tol 1e-4) | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash_fwd disagrees with plain on {name}")
        results[name] = dict(q=q, k=k, v=v, seg_q=seg_q, seg_k=seg_k,
                             causal=causal, o_err=o_err, lse_err=lse_err,
                             design=design)

    timings = {}
    for name in ("context (main path)", "context (no resets)",
                 "act (main path)", "train (main path)", "B*H=32 T=2048 f32",
                 "B*H=32 T=2048 bf16"):
        r = results[name]
        q, k, v, sq, sk, causal = (r["q"], r["k"], r["v"], r["seg_q"],
                                   r["seg_k"], r["causal"])

        def kernel():
            return _kernels.flash_fwd(q, k, v, sq, sk, causal)

        ms = cuda_ms(kernel, 20)
        dev_ms = device_ms(kernel, "flash_fwd_")
        plain_ms = cuda_ms(
            lambda: _flash_forward_plain(q, k, v, sq, sk, causal), 5)
        Tq, Tk = q.shape[2], k.shape[2]
        mask = sq[:, None, :, None] == sk[:, None, None, :]
        if causal:
            mask = mask & torch.ones((Tq, Tk), dtype=torch.bool,
                                     device="cuda").tril()

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask)

        lib_ms = cuda_ms(library, 20)
        lib_dev_ms = device_ms(library, None)
        if dev_ms is None or lib_dev_ms is None:
            raise RuntimeError(f"no profiler device time for {name}: kernel "
                               f"{dev_ms}, sdpa {lib_dev_ms}")
        bound_ms, bound_by = flash_bound_ms(q, k, sq, sk, causal)
        # The same work with no episode reset in the window: the whole
        # causal triangle is visible.
        no_reset_ms, _ = flash_bound_ms(q, k, torch.zeros_like(sq),
                                        torch.zeros_like(sk), causal)
        timings[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                             library_ms=lib_ms, library_device_ms=lib_dev_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_ms_no_resets=no_reset_ms,
                             design=r["design"])
        log(f"[kernel] flash_fwd {name} timing ({r['design']}): kernel "
            f"{ms:.4f} ms (profiler device time {dev_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device {lib_dev_ms:.4f}"
            f" ms), bound {bound_ms:.4f} ms ({bound_by}), bound with no "
            f"resets {no_reset_ms:.4f} ms; device/bound "
            f"{dev_ms / bound_ms:.1f}x")
    r = results["train (main path)"]
    host = wrapper_host_us(r["q"], r["k"], r["v"], r["seg_q"], r["seg_k"],
                           r["causal"])
    timings["train (main path)"]["host_us"] = host
    log("[kernel] flash_fwd wrapper host time per call at the train shape "
        "(us): " + ", ".join(f"{n} {us:.2f}" for n, us in host.items()))
    return results, timings


def phase_backward_vs_plain():
    """The backward against the plain backward on the same inputs, each
    case through the design its shape picks (one fused launch at Tq, Tk
    <= 64, the dQ and dK/dV kernels past it): o and lse from the forward
    kernel, dO from a seeded generator, the forward's segment layouts.
    Tolerance: f32, 1e-4 of the gradient's largest entry (summation order
    over up to 2048 terms); bf16 gradients, one rounding of the f32 result
    on top (2**-7 relative); dq exactly 0 on fully masked rows."""
    from moolib_tpu_torch.ops import _kernels
    from moolib_tpu_torch.ops.attention import (
        _flash_backward,
        _flash_backward_plain,
        _flash_delta,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, (B, H, Tq, D), Tk, dtype, causal, segment layout
        ("train (main path)", TRAIN_SHAPE, UNROLL + 1, f32, True, "episodes"),
        ("train bf16", TRAIN_SHAPE, UNROLL + 1, bf16, True, "episodes"),
        ("one tile T=64 D=128 masked rows", (2, 4, 64, 128), 64, f32, False,
         "kv masked"),
        ("context (main path)", CONTEXT_SHAPE, CONTEXT_T, f32, True,
         "episodes"),
        ("context (no resets)", CONTEXT_SHAPE, CONTEXT_T, f32, True, "none"),
        ("B*H=32 T=2048 bf16", (8, 4, 2048, 32), 2048, bf16, True,
         "episodes"),
        ("ragged T=100 D=64", (2, 4, 100, 64), 100, f32, True, "episodes"),
        ("ragged T=100 D=128", (2, 4, 100, 128), 100, f32, True, "episodes"),
        ("ragged T=100 D=128 bf16", (2, 4, 100, 128), 100, bf16, True,
         "episodes"),
        ("non-causal masked rows D=64", (2, 4, 256, 64), 384, f32, False,
         "kv masked"),
        ("alternating T=300", (2, 4, 300, 32), 300, f32, True, "alternating"),
        ("boundaries T=320", (2, 4, 320, 32), 320, f32, True, "boundaries"),
        ("disjoint T=100", (2, 4, 100, 32), 100, f32, False, "disjoint"),
        ("tq_ne_tk 200/333", (2, 4, 200, 32), 333, f32, False, "tq_ne_tk"),
    ]
    design_kernels = {
        "tile": (_kernels.FLASH_BWD_TILE,),
        "wgmma": (_kernels.FLASH_BWD_DQ, _kernels.FLASH_BWD_DKDV),
    }
    results = {}
    for name, (B, H, Tq, D), Tk, dtype, causal, layout in cases:
        q, do = (torch.randn((B, H, Tq, D), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((B, H, Tk, D), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        seg_q, seg_k = layout_segments(layout, gen, B, Tq, Tk)
        o, lse = _kernels.flash_fwd(q, k, v, seg_q, seg_k, causal)
        design = _kernels.flash_bwd_design(Tq, Tk)
        before = [kern.launches for kern in design_kernels[design]]
        got = _flash_backward(q, k, v, seg_q, seg_k, o, lse, do, causal)
        torch.cuda.synchronize()
        if [kern.launches - n for kern, n in
                zip(design_kernels[design], before)] != [1] * len(before):
            raise RuntimeError(f"{name}: the {design} design's kernels did "
                               f"not launch once each")
        want = _flash_backward_plain(q, k, v, seg_q, seg_k, o, lse, do,
                                     causal)
        errs, ok = {}, True
        rel = 2.0 ** -7 if dtype == bf16 else 0.0
        for gname, g, ref in zip(("dq", "dk", "dv"), got, want):
            ref = ref.float()
            tol = 1e-4 * float(ref.abs().max()) + rel * ref.abs()
            err = (g.float() - ref).abs()
            ok &= bool((err <= tol).all())
            errs[gname] = (float(err.max()), float(tol.max()))
        masked = torch.isinf(lse).reshape(B, H, Tq)
        if layout in ("kv masked", "disjoint") and not masked.any():
            raise RuntimeError(f"{name} produced no fully masked row")
        if masked.any():
            ok &= bool((got[0][masked] == 0).all())
            errs["dq on masked rows"] = (float(got[0][masked].abs().max()),
                                         0.0)
        log(f"[backward] {name}: q {tuple(q.shape)} Tk {Tk} "
            f"{str(dtype)[6:]} causal={causal} {layout} design {design} | "
            + " ".join(f"max|{g}-plain| {e:.3e} (tol {t:.3e})"
                       for g, (e, t) in errs.items())
            + f" | {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"the backward disagrees with plain on {name}")
        results[name] = dict(q=q, k=k, v=v, do=do, seg_q=seg_q, seg_k=seg_k,
                             causal=causal, o=o, lse=lse, errs=errs,
                             design=design)

    timings = {}
    for name in ("train (main path)", "context (main path)",
                 "context (no resets)", "B*H=32 T=2048 bf16"):
        r = results[name]
        q, k, v, do, sq, sk, causal = (r["q"], r["k"], r["v"], r["do"],
                                       r["seg_q"], r["seg_k"], r["causal"])
        o, lse = r["o"], r["lse"]
        if r["design"] == "tile":
            fns = {"flash_bwd_tile": lambda: _kernels.flash_bwd_tile(
                q, k, v, sq, sk, o, lse, do, causal)}
        else:
            delta = _flash_delta(o, do)
            fns = {
                "flash_bwd_dq": lambda: _kernels.flash_bwd_dq(
                    q, k, v, sq, sk, lse, delta, do, causal),
                "flash_bwd_dkdv": lambda: _kernels.flash_bwd_dkdv(
                    q, k, v, sq, sk, lse, delta, do, causal),
            }
        ms = {kname: cuda_ms(fn, 20) for kname, fn in fns.items()}
        dev = {kname: device_ms(fn, kname + "_kernel")
               for kname, fn in fns.items()}
        plain_ms = cuda_ms(lambda: _flash_backward_plain(
            q, k, v, sq, sk, o, lse, do, causal), 5)
        # Yardstick: SDPA's backward with the same boolean mask, on CUDA
        # events and as profiler device time (all of its kernels).
        Tq, Tk = q.shape[2], k.shape[2]
        mask = sq[:, None, :, None] == sk[:, None, None, :]
        if causal:
            mask = mask & torch.ones((Tq, Tk), dtype=torch.bool,
                                     device="cuda").tril()
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask)

        def library():
            return torch.autograd.grad(out, (qg, kg, vg), do,
                                       retain_graph=True)

        lib_ms = cuda_ms(library, 20)
        lib_dev_ms = device_ms(library, None)
        if None in dev.values() or lib_dev_ms is None:
            raise RuntimeError(f"no profiler device time for {name}: {dev}, "
                               f"sdpa {lib_dev_ms}")
        bounds = flash_bwd_bounds_ms(q, k, sq, sk, causal)
        no_resets = flash_bwd_bounds_ms(q, k, torch.zeros_like(sq),
                                        torch.zeros_like(sk), causal)
        timings[name] = {}
        for kname in fns:
            timings[name][kname] = dict(
                ms=ms[kname], device_ms=dev[kname], plain_ms=plain_ms,
                library_ms=lib_ms, library_device_ms=lib_dev_ms,
                bound_ms=bounds[kname][0], bound_by=bounds[kname][1],
                bound_ms_no_resets=no_resets[kname][0], design=r["design"])
            log(f"[backward] {kname} {name} timing: kernel {ms[kname]:.4f} "
                f"ms (profiler device time {dev[kname]:.4f} ms), bound "
                f"{bounds[kname][0]:.4f} ms ({bounds[kname][1]}), bound with "
                f"no resets {no_resets[kname][0]:.4f} ms; device/bound "
                f"{dev[kname] / bounds[kname][0]:.1f}x")
        log(f"[backward] {name} timing ({r['design']}): kernels "
            f"{sum(dev.values()):.4f} ms device ({sum(ms.values()):.4f} ms "
            f"events), plain backward (dq, dk, dv together) {plain_ms:.4f} "
            f"ms, sdpa backward {lib_dev_ms:.4f} ms device ({lib_ms:.4f} ms "
            f"events)")
    return results, timings


def phase_context_backward():
    """The long-T backward on its path: autograd through
    attention(backend="auto") at the context shape with the repo's resets,
    launch counts from 0, gradients held against dense attention's
    autograd on the card (no row is fully masked, so the two agree)."""
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.ops.attention import attention, dense_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(CONTEXT_SHAPE, generator=gen, device="cuda")
               .requires_grad_() for _ in range(3))
    w = torch.randn(CONTEXT_SHAPE, generator=gen, device="cuda")
    seg = episode_segments(gen, CONTEXT_SHAPE[0], CONTEXT_T)
    for kern in KERNELS:
        kern.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = attention(q, k, v, backend="auto", causal=True, segment_ids=seg)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    end.record()
    end.synchronize()
    launches = {kern.name: kern.launches for kern in KERNELS}
    ref = dense_attention(q, k, v, causal=True, segment_ids=seg)
    want = torch.autograd.grad((ref * w).sum(), (q, k, v))
    errs = {n: float((g - r).abs().max()) / float(r.abs().max())
            for n, g, r in zip(("dq", "dk", "dv"), got, want)}
    log(f"[context backward] attention(auto) + autograd at "
        f"{CONTEXT_SHAPE} f32, resets every {EPISODE_LENGTH}: "
        f"{start.elapsed_time(end):.3f} ms (CUDA events, forward and "
        f"backward) | max error vs dense autograd, relative to each "
        f"gradient's max: "
        + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol 1e-4) | launches {launches}")
    if max(errs.values()) > 1e-4:
        raise RuntimeError(f"context backward differs from dense: {errs}")
    want_launches = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1,
                     "flash_bwd_tile": 0}
    if launches != want_launches:
        raise RuntimeError(f"context backward launches {launches}, want "
                           f"{want_launches}")
    return launches


def _serve(rep, reqs, waves):
    """Submit the requests in waves (lists of indices), each wave at once;
    returns replies and per-request host and CUDA-event latencies (ms)."""
    replies = [None] * len(reqs)
    host_ms, event_ms = [], []
    for wave in waves:
        started = []
        for i in wave:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            started.append((i, time.perf_counter(), ev, rep.submit(reqs[i])))
        for i, t0, ev, fut in started:
            replies[i] = fut.result(timeout=300)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - t0))
            event_ms.append(ev.elapsed_time(end))
    return replies, host_ms, event_ms


def _check(name, got, want, shape):
    """Shape and finiteness of a reply; returns its max error."""
    got = np.asarray(got)
    if got.shape != shape:
        raise RuntimeError(f"{name}: shape {got.shape}, want {shape}")
    if not np.isfinite(got).all():
        raise RuntimeError(f"{name}: non-finite values")
    return float(np.abs(got - want).max())


def _serve_steady(submit, reqs, order):
    """``submit(reqs[i])`` (a future) for ``i`` in ``order`` in waves
    of BATCH, keeping two waves in flight so the replica always has a
    full batch queued; returns (index, reply) pairs, each request's
    latency on the host clock (submit to reply, ms) and the requests
    served a second."""
    out, host_ms, in_flight = [], [], []

    def stamp(t0):
        return lambda fut: host_ms.append(1e3 * (time.perf_counter() - t0))

    def collect(wave):
        for i, fut in wave:
            out.append((i, fut.result(timeout=300)))

    t_start = time.perf_counter()
    for w in range(0, len(order), BATCH):
        wave = []
        for i in order[w:w + BATCH]:
            fut = submit(reqs[i])
            fut.add_done_callback(stamp(time.perf_counter()))
            wave.append((i, fut))
        in_flight.append(wave)
        if len(in_flight) == 2:
            collect(in_flight.pop(0))
    for wave in in_flight:
        collect(wave)
    rate = len(order) / (time.perf_counter() - t_start)
    return out, host_ms, rate


def _settle(tel, kind: str, sent: int, timeout: float = 30.0) -> None:
    """Wait until the replica's worker has recorded every batch served so
    far: its rows add up to ``sent`` and its scope holds one step a
    batch (the worker records the step after the replies go out)."""
    reg, t_end = tel.registry, time.monotonic() + timeout
    while not (reg.value("serving_batch_rows_total", service=kind) == sent
               and reg.value("stepscope_steps_total", loop=f"{kind}_replica")
               == reg.value("serving_batches_total", service=kind)):
        if time.monotonic() > t_end:
            raise RuntimeError(f"{kind}: the replica did not record its "
                               f"{sent} requests within {timeout} s")
        time.sleep(0.001)


def _replica_ledger(tel, kind: str) -> dict:
    from moolib_tpu_torch.telemetry import summarize_stepscope

    return summarize_stepscope(tel.snapshot())[f"{kind}_replica"]


# Steady serving after the warm-up: STEADY_WAVES[kind] waves of BATCH
# requests, two in flight, cycling over the checked requests.
STEADY_WAVES = {"act": 64, "context": 32}
REPLICA_PHASES = ("queue_wait", "linger", "infer", "other")


def _serve_net(seed: int = 0):
    """experiment.py's transformer at full width: d_model 128, 2 layers,
    4 heads, mlp_ratio 4, max_len 2048, 6 actions, bf16 compute dtype,
    the flash forward on attention(backend="auto"); weights from a
    seeded generator on the card."""
    from moolib_tpu_torch import TransformerNet

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                          attention_backend="auto", device="cuda",
                          generator=gen).eval()


def _dense_copy(state_dict):
    """The reference for every reply: the same weights, plain dense
    attention, on the CPU (no kernel, no cuDNN)."""
    from moolib_tpu_torch import TransformerNet

    dense = TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                           attention_backend="dense", device="cpu").eval()
    dense.load_state_dict(state_dict)
    return dense


def _service_fns(batch_ms):
    """The act and context services' model functions; each batch
    forward is timed by CUDA events into ``batch_ms[kind]``."""
    from moolib_tpu_torch import make_act_step

    def timed(kind, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        batch_ms[kind].append(start.elapsed_time(end))
        return out

    act_gen = torch.Generator(device="cuda").manual_seed(1)

    def act_fn(model, batch):
        n = batch["done"].shape[0]

        def run():
            a, logits, _ = make_act_step(model)(batch["obs"].reshape(n * ACT_ENVS, 84, 84, 4),
                               batch["done"].reshape(n * ACT_ENVS), (),
                               act_gen)
            return {"action": a.reshape(n, ACT_ENVS),
                    "logits": logits.reshape(n, ACT_ENVS, 6)}

        return timed("act", run)

    def context_fn(model, batch):
        def run():
            (logits, baseline), _ = model(batch["obs"].transpose(0, 1),
                                          batch["done"].transpose(0, 1), ())
            return {"logits": logits.transpose(0, 1),
                    "baseline": baseline.transpose(0, 1)}

        return timed("context", run)

    return {"act": act_fn, "context": context_fn}


def _serve_requests():
    """Act request r is step r of 32 envs; a context request is a window
    of one env. Resets follow EPISODE_LENGTH, each env at its phase."""
    rng = np.random.default_rng(0)
    act_phase = rng.integers(0, EPISODE_LENGTH, ACT_ENVS)
    act_reqs = [{"obs": rng.integers(0, 256, (ACT_ENVS, 84, 84, 4), np.uint8),
                 "done": (r + act_phase) % EPISODE_LENGTH == 0}
                for r in range(7)]
    ctx_reqs = [{"obs": rng.integers(0, 256, (CONTEXT_T, 84, 84, 4),
                                     np.uint8),
                 "done": (np.arange(CONTEXT_T) + rng.integers(EPISODE_LENGTH))
                 % EPISODE_LENGTH == 0} for _ in range(6)]
    return {"act": act_reqs, "context": ctx_reqs}


def _dense_ref(dense, kind, req):
    """The dense-attention forward of one request on the CPU."""
    obs = torch.from_numpy(req["obs"])
    done = torch.from_numpy(req["done"])
    with torch.no_grad():
        if kind == "act":
            (logits, _), _ = dense(obs[None], done[None], ())
            return {"logits": logits[0].numpy()}
        (logits, baseline), _ = dense(obs[:, None], done[:, None], ())
        return {"logits": logits[:, 0].numpy(),
                "baseline": baseline[:, 0].numpy()}


def _reply_err(kind, out, ref):
    """A reply's shape, finiteness and actions; its max error."""
    if kind == "act":
        a = np.asarray(out["action"])
        if a.shape != (ACT_ENVS,) or not ((a >= 0) & (a < 6)).all():
            raise RuntimeError(f"bad actions {a}")
        return _check("act logits", out["logits"], ref["logits"],
                      (ACT_ENVS, 6))
    return max(_check("context logits", out["logits"], ref["logits"],
                      (CONTEXT_T, 6)),
               _check("context baseline", out["baseline"],
                      ref["baseline"], (CONTEXT_T,)))


def phase_serve(tel):
    from moolib_tpu_torch import Replica
    from moolib_tpu_torch.ops._kernels import FLASH_FWD, KERNELS

    net = _serve_net()
    dense = _dense_copy(net.state_dict())
    batch_ms = {"act": [], "context": []}
    fns = _service_fns(batch_ms)
    reqs_by_kind = _serve_requests()
    served = {"refs": {}, "steady": {}}
    launches = {}
    for kind, waves in (("act", [[0, 1, 2], [3, 4, 5, 6]]),
                        ("context", [[0, 1], [2, 3, 4, 5]])):
        fn, reqs = fns[kind], reqs_by_kind[kind]
        rep = Replica(None, fn, net, service=kind, batch_size=BATCH,
                      pad=True, linger_s=0.05, device="cuda", telemetry=tel)
        # Each served batch's ledger row, as the replica's worker hands
        # it to its {service}_replica scope.
        rows, observe = [], rep._scope.observe_step

        def tap(wall_s, phases, ts_us=None, rows=rows, observe=observe):
            rows.append(dict(phases, wall=wall_s))
            observe(wall_s, phases, ts_us)

        rep._scope.observe_step = tap
        order = [j % len(reqs) for j in range(STEADY_WAVES[kind] * BATCH)]
        try:
            for kern in KERNELS:
                kern.launches = 0
            replies, host_ms, event_ms = _serve(rep, reqs, waves)
            launches[kind] = {kern.name: kern.launches for kern in KERNELS}
            # Hold every reply against the dense-attention forward on
            # the CPU.
            refs = [_dense_ref(dense, kind, req) for req in reqs]
            served["refs"][kind] = refs
            errs = [_reply_err(kind, out, ref)
                    for out, ref in zip(replies, refs)]
            # The requests above warm the replica (its first batch is
            # cold); the steady ledger counts from here.
            _settle(tel, kind, len(reqs))
            warm, n_warm = _replica_ledger(tel, kind), len(rows)
            n_cold_fwd = len(batch_ms[kind])
            steady, steady_ms, rate = _serve_steady(rep.submit, reqs, order)
            steady_errs = [_reply_err(kind, out, refs[i])
                           for i, out in steady]
        finally:
            rep.close()
        log(f"[serve] {kind}: {len(reqs)} requests in waves "
            f"{[len(w) for w in waves]} | max|reply-dense on CPU| "
            f"{max(errs):.3e} (tol {SERVE_TOL}) | launches {launches[kind]}")
        if max(errs + steady_errs) > SERVE_TOL:
            raise RuntimeError(f"{kind} replies differ from the CPU forward "
                               f"by {max(errs + steady_errs):.3e} > "
                               f"{SERVE_TOL}")
        log(f"[serve] {kind}: request latency ms (host clock) "
            f"{[round(x, 3) for x in host_ms]}")
        log(f"[serve] {kind}: request latency ms (CUDA events) "
            f"{[round(x, 3) for x in event_ms]}")
        log(f"[serve] {kind}: batch forward ms (CUDA events) "
            f"{[round(x, 3) for x in batch_ms[kind][:n_cold_fwd]]}")
        if launches[kind][FLASH_FWD.name] == 0:
            raise RuntimeError(f"{FLASH_FWD.name} was never launched by the "
                               f"{kind} service")
        fwd = batch_ms[kind][n_cold_fwd:]
        log(f"[serve] {kind} steady: {len(order)} more requests in waves of "
            f"{BATCH}, two waves in flight | max|reply-dense on CPU| "
            f"{max(steady_errs):.3e} | {rate:.3f} requests/s | request "
            f"latency ms (host clock) median {np.median(steady_ms):.3f}, p90 "
            f"{np.percentile(steady_ms, 90):.3f} | batch forward ms (CUDA "
            f"events) median {np.median(fwd):.3f} of {len(fwd)}")
        _serve_telemetry(tel, kind, len(reqs) + len(order), warm,
                         rows[:n_warm], rows[n_warm:])
        served["steady"][kind] = dict(
            rate=rate, median_ms=float(np.median(steady_ms)),
            p90_ms=float(np.percentile(steady_ms, 90)))
    _check_prometheus(tel, "serve")
    return launches, served


def _serve_telemetry(tel, kind: str, sent: int, warm: dict, warm_rows,
                     steady_rows) -> None:
    """The serving series of one closed replica (its worker joined, so
    every count is in): every request admitted and completed, nothing
    rejected or shed, the batch rows equal to the fill histogram's sum
    times the batch size, one replica step a batch; then the
    {service}_replica ledger: the warm-up's (``warm``, the scope's
    cumulative summary when the steady run began) and the steady run's,
    as the difference of the cumulative counters and as per-batch
    medians."""
    reg = tel.registry
    counts = {name: reg.value(f"serving_{name}_total", service=kind)
              for name in ("admitted", "completed", "shed", "failed",
                           "batches", "batch_rows")}
    counts.update({f"rejected_{r}": reg.value("serving_rejected_total",
                                              service=kind, reason=r)
                   for r in ("capacity", "draining")})
    snap = tel.snapshot()
    fill = snap[f'serving_batch_fill_fraction{{service="{kind}"}}']
    led = _replica_ledger(tel, kind)
    log(f"[telemetry] {kind}: sent {sent} | " + " ".join(
        f"{k} {v:g}" for k, v in counts.items())
        + f" | fill histogram count {fill['count']} sum {fill['sum']:g} "
        f"(x batch {BATCH} = {fill['sum'] * BATCH:g} rows)")

    def ledger_txt(steps, wall, phases):
        return (f"{steps} steps, wall {1e3 * wall:.3f} ms | " + ", ".join(
            f"{ph} {1e3 * phases.get(ph, 0.0):.3f} ms "
            f"({phases.get(ph, 0.0) / wall:.3f})" for ph in REPLICA_PHASES))

    log(f"[stepscope] {kind}_replica warm-up (its first batch cold): "
        + ledger_txt(warm["steps"], warm["wall_s"], warm["phases"])
        + " | per batch ms " + str([
            {k: round(1e3 * v, 3) for k, v in r.items()} for r in warm_rows]))
    phases = {ph: led["phases"].get(ph, 0.0) - warm["phases"].get(ph, 0.0)
              for ph in REPLICA_PHASES}
    median = {ph: 1e3 * float(np.median([r.get(ph, 0.0)
                                         for r in steady_rows]))
              for ph in REPLICA_PHASES[:-1] + ("wall",)}
    median["other"] = 1e3 * float(np.median(
        [r["wall"] - sum(r.get(ph, 0.0) for ph in REPLICA_PHASES[:-1])
         for r in steady_rows]))
    log(f"[stepscope] {kind}_replica steady: "
        + ledger_txt(led["steps"] - warm["steps"],
                     led["wall_s"] - warm["wall_s"], phases)
        + " | per batch median ms " + ", ".join(
            f"{ph} {median[ph]:.3f}" for ph in REPLICA_PHASES + ("wall",)))
    bad = []
    if not counts["admitted"] == counts["completed"] == sent:
        bad.append("admitted == completed == sent")
    if counts["rejected_capacity"] or counts["rejected_draining"] or \
            counts["shed"] or counts["failed"]:
        bad.append("no rejection, shed or failure")
    if counts["batch_rows"] != fill["sum"] * BATCH or \
            counts["batches"] != fill["count"]:
        bad.append("batch rows and batches equal the fill histogram's")
    if not led["steps"] == counts["batches"] == \
            len(warm_rows) + len(steady_rows):
        bad.append("one replica step per batch")
    if bad:
        raise RuntimeError(f"serving telemetry of {kind}: failed {bad}: "
                           f"{counts}, fill {fill}")


def _check_prometheus(tel, tag: str) -> None:
    """The registry's Prometheus text, read back by the port's strict
    parser, holds the values snapshot() holds: every counter and gauge,
    and every histogram's count, sum and +Inf bucket."""
    from moolib_tpu_torch.telemetry import parse_prometheus

    snap, parsed = tel.snapshot(), parse_prometheus(tel.prometheus())
    want = {}
    for sid, series in snap.items():
        if series["type"] != "histogram":
            want[sid] = series["value"]
            continue
        name, _, labels = sid.partition("{")
        inner = labels[:-1]
        want[f"{name}_count" + (f"{{{inner}}}" if inner else "")] = \
            series["count"]
        want[f"{name}_sum" + (f"{{{inner}}}" if inner else "")] = \
            series["sum"]
        want[f"{name}_bucket{{" + (f"{inner}," if inner else "")
             + 'le="+Inf"}'] = series["buckets"][-1]
    bad = {sid: (parsed.get(sid), v) for sid, v in want.items()
           if not (parsed.get(sid) == v
                   or (v != v and parsed.get(sid) != parsed.get(sid)))}
    log(f"[telemetry] {tag}: Prometheus text parses into the snapshot's "
        f"values: {len(snap)} series, {len(want)} samples checked, "
        f"{len(bad)} differ")
    if bad:
        raise RuntimeError(f"{tag}: Prometheus text and snapshot differ: "
                           f"{bad}")


# Phase 5b: the same services served from a child process to this one
# over the port's RPC. STEADY batches of BATCH requests, two waves in
# flight, as phase 5; LANE_BATCHES context batches again pinned to the shm
# lane, and LANE_BATCHES with both peers on tcp only; V2_BATCHES per
# service (cycling over V2_REQUESTS distinct requests) after publishing
# the second weights.
RPC_REPLICAS = ("replica-0", "replica-1")
RPC_STEADY = {"act": 64, "context": 32}
RPC_LANE_BATCHES = 8
RPC_V2_BATCHES = {"act": 8, "context": 1}
RPC_V2_REQUESTS = {"act": 7, "context": 2}  # distinct, checked on the CPU
RPC_BUDGET_S = 300.0
RPC_CHILD_FLAG = "--rpc-child"


def rpc_child() -> int:
    """The replica process of the RPC phase (``chip_smoke.py
    --rpc-child``): two Rpc peers, each with an act Replica of the
    full-width TransformerNet (phase 5's seed and params), replica-0
    also with the context Replica, all on the card. replica-0 defines
    ``chip_child(op)``, its one extra endpoint: the process's kernel
    launch counts (``reset``, ``kernels``), its batch forwards' CUDA-event
    times (``forward_ms``), ``tcp`` (both peers to tcp only) and ``info``
    (its native codec, /dev/shm's free bytes). Prints one JSON line of
    the peers' addresses, then serves until its stdin closes."""
    from moolib_tpu_torch import Replica
    from moolib_tpu_torch.native import native_path
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.rpc import Rpc

    if not torch.cuda.is_available():
        raise RuntimeError("the RPC phase's replicas need the card")
    batch_ms = {"act": [], "context": []}
    fns = _service_fns(batch_ms)
    peers, reps = [], []
    for name in RPC_REPLICAS:
        rpc = Rpc(name)
        rpc.set_timeout(RPC_BUDGET_S)
        rpc.listen("127.0.0.1:0")
        peers.append(rpc)
        net = _serve_net()
        for kind in (("act", "context") if name == RPC_REPLICAS[0]
                     else ("act",)):
            reps.append(Replica(rpc, fns[kind], net, service=kind,
                                batch_size=BATCH, pad=True, linger_s=0.05,
                                device="cuda"))

    def control(op):
        if op == "reset":
            for kern in KERNELS:
                kern.launches = 0
            return None
        if op == "kernels":
            return {kern.name: kern.launches for kern in KERNELS}
        if op == "forward_ms":
            return {k: list(v) for k, v in batch_ms.items()}
        if op == "tcp":
            for rpc in peers:
                rpc.set_transports({"tcp"})
            return "tcp"
        if op == "info":
            st = os.statvfs("/dev/shm")
            return {"native": native_path(),
                    "shm_free_bytes": st.f_bavail * st.f_frsize}
        raise ValueError(f"unknown op {op!r}")

    peers[0].define("chip_child", control)
    print(json.dumps({rpc.get_name(): rpc.debug_info()["listen"][0]
                      for rpc in peers}), flush=True)
    sys.stdin.read()  # until the parent closes the pipe (or exits)
    for rep in reps:
        rep.close()
    for rpc in peers:
        rpc.close()
    return 0


def _child_addresses(proc, timeout: float = 600.0) -> dict:
    """The child's address line; raises if it dies or stays silent."""
    got = {}
    reader = threading.Thread(
        target=lambda: got.setdefault("line", proc.stdout.readline()),
        daemon=True)
    reader.start()
    reader.join(timeout)
    if not got.get("line"):
        raise RuntimeError(f"the RPC child printed no addresses within "
                           f"{timeout} s (exit code {proc.poll()})")
    return json.loads(got["line"])


def _lane_bytes(rpc) -> dict:
    reg = rpc.telemetry.registry
    return {t: (reg.value("rpc_bytes_out_total", transport=t) or 0)
            + (reg.value("rpc_bytes_in_total", transport=t) or 0)
            for t in ("shm", "unix", "tcp")}


def _wait_lanes(rpc, peers, timeout: float = 30.0) -> dict:
    """The transports of ``rpc``'s connection to each peer, once every
    lane that will mount has (shm mounts a moment after the greeting)."""
    t_end = time.monotonic() + timeout
    while True:
        conns = {p: sorted(rpc.debug_info()["peers"].get(p, {}).get(
            "connections", {})) for p in peers}
        if all("shm" in c for c in conns.values()) or \
                time.monotonic() > t_end:
            return conns
        time.sleep(0.05)


def _remote_ledgers(client, peer: str, timeout: float = 30.0) -> dict:
    """``peer``'s ``{service}_replica`` ledgers from its __telemetry, once
    every served batch's step is recorded (the worker records it just
    after the replies go out)."""
    from moolib_tpu_torch.telemetry import summarize_stepscope

    t_end = time.monotonic() + timeout
    while True:
        m = client.async_(peer, "__telemetry").result(
            timeout=RPC_BUDGET_S)["metrics"]
        kinds = [sid.split('"')[1] for sid in m
                 if sid.startswith("serving_batches_total{")]
        if all(m.get(f'stepscope_steps_total{{loop="{k}_replica"}}', {})
               .get("value") == m[f'serving_batches_total{{service="{k}"}}']
               ["value"] for k in kinds):
            return summarize_stepscope(m)
        if time.monotonic() > t_end:
            raise RuntimeError(f"{peer}: replica steps not recorded")
        time.sleep(0.01)


@contextlib.contextmanager
def _sends_pinned_to_shm():
    """This process's sends pinned to a peer's shm lane where one is
    mounted. The transport bandit otherwise picks the lane of the lowest
    whole-call latency (queueing and cold batches included): a
    measuring instrument for the lane, not the product's policy."""
    from moolib_tpu_torch.rpc import rpc as rpc_mod

    best = rpc_mod._best_conn
    rpc_mod._best_conn = lambda peer: peer.conns.get("shm") or best(peer)
    try:
        yield
    finally:
        rpc_mod._best_conn = best


def phase_rpc(served) -> dict:
    """Phase 5b: the two services on the card behind the RPC, answered to
    this process by the replica child (see :func:`rpc_child`)."""
    from moolib_tpu_torch.flightrec import (crawl_cohort, estimate_offset,
                                            validate_bundle)
    from moolib_tpu_torch.native import native_path
    from moolib_tpu_torch.ops._kernels import FLASH_FWD
    from moolib_tpu_torch.rpc import Rpc
    from moolib_tpu_torch.serving import Router
    from moolib_tpu_torch.telemetry import parse_prometheus

    if native_path() is None:
        raise RuntimeError("the native codec did not load (g++ build)")
    reqs = _serve_requests()
    refs = served["refs"]
    mb = {kind: sum(v.nbytes for v in reqs[kind][0].values()) / 1e6
          for kind in reqs}
    # The second version of the weights (publish_weights), and its
    # references on the CPU.
    net2 = _serve_net(seed=2)
    dense2 = _dense_copy(net2.state_dict())
    refs2 = {k: [_dense_ref(dense2, k, r)
                 for r in reqs[k][:RPC_V2_REQUESTS[k]]] for k in reqs}
    out = {"native": native_path(), "services": {}}
    sent = {p: {"act": 0, "context": 0} for p in RPC_REPLICAS}
    here = os.path.dirname(os.path.abspath(__file__))
    child = subprocess.Popen(
        [sys.executable, os.path.join(here, "chip_smoke.py"),
         RPC_CHILD_FLAG], cwd=here, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True)
    client = tcp_client = router = None
    try:
        addrs = _child_addresses(child)
        client = Rpc("chip-client")
        client.set_timeout(RPC_BUDGET_S)
        for addr in addrs.values():
            client.connect(addr)

        def ctl(op):
            return client.async_(RPC_REPLICAS[0], "chip_child", op).result(
                timeout=RPC_BUDGET_S)

        info = ctl("info")
        out["child"] = info
        log(f"[rpc] native codec: here {out['native']} | child "
            f"{info['native']} | /dev/shm free {info['shm_free_bytes']} B")
        if info["native"] is None:
            raise RuntimeError("the child's native codec did not load")
        out["lanes"] = _wait_lanes(client, RPC_REPLICAS)
        log(f"[rpc] lanes to the replicas: {out['lanes']}")
        router = Router(client, list(RPC_REPLICAS), service="act",
                        default_budget_s=RPC_BUDGET_S, probe_interval_s=0.05,
                        seed=0)
        t_end = time.monotonic() + 60
        while len(router.routable()) < len(RPC_REPLICAS):
            if time.monotonic() > t_end:
                raise RuntimeError(f"replicas not routable: {router.stats()}")
            time.sleep(0.05)

        def direct(peer, kind):
            def submit(req):
                sent[peer][kind] += 1
                return client.call_with_deadline(
                    peer, f"{kind}.infer", RPC_BUDGET_S, req)
            return submit

        def check(kind, replies, want):
            errs = [_reply_err(kind, r, want[i]) for i, r in replies]
            if max(errs) > SERVE_TOL:
                raise RuntimeError(f"rpc {kind} replies differ from the CPU "
                                   f"forward by {max(errs):.3e} > "
                                   f"{SERVE_TOL}")
            return max(errs)

        def run(tag, kind, submit, n_batches, want, rpc):
            """Serve n_batches over the RPC with the counts reset just
            before and read just after; every reply checked."""
            order = [j % len(want) for j in range(n_batches * BATCH)]
            lanes0, fwd0 = _lane_bytes(rpc), len(ctl("forward_ms")[kind])
            ctl("reset")
            replies, host_ms, rate = _serve_steady(submit, reqs[kind], order)
            counts = ctl("kernels")
            err = check(kind, replies, want)
            lanes = {t: b - lanes0[t] for t, b in _lane_bytes(rpc).items()}
            fwd = ctl("forward_ms")[kind][fwd0:]
            row = dict(requests=len(order), rate=rate,
                       median_ms=float(np.median(host_ms)),
                       p90_ms=float(np.percentile(host_ms, 90)),
                       mb_request=mb[kind], mb_per_s=rate * mb[kind],
                       lane_mb={t: b / 1e6 for t, b in lanes.items()},
                       lane=max(lanes, key=lanes.get),
                       forward_median_ms=float(np.median(fwd)),
                       max_abs_err=err, launches=counts)
            local = served["steady"][kind]
            log(f"[rpc] {tag}: {row['requests']} requests over "
                f"{row['lane']} (MB each lane carried "
                f"{ {t: round(v, 1) for t, v in row['lane_mb'].items()} }) |"
                f" {rate:.3f} requests/s | request ms median "
                f"{row['median_ms']:.3f}, p90 {row['p90_ms']:.3f} | "
                f"{mb[kind]:.3f} MB a request, {row['mb_per_s']:.1f} MB/s |"
                f" batch forward ms (CUDA events, child) median "
                f"{row['forward_median_ms']:.3f} | phase 5 local: "
                f"{local['rate']:.3f} requests/s, median "
                f"{local['median_ms']:.3f}, p90 {local['p90_ms']:.3f} | "
                f"max|reply-dense on CPU| {err:.3e} | launches {counts}")
            if counts[FLASH_FWD.name] == 0:
                raise RuntimeError(f"{FLASH_FWD.name} was never launched "
                                   f"in the child by {tag}")
            out["services"][tag] = row
            return row

        # Warm every replica (its first batch is cold), each reply held
        # against the CPU.
        for peer in RPC_REPLICAS:
            kinds = ("act", "context") if peer == RPC_REPLICAS[0] \
                else ("act",)
            for kind in kinds:
                n = len(reqs[kind])
                got, _, _ = _serve_steady(direct(peer, kind), reqs[kind],
                                       list(range(n)))
                check(kind, got, refs[kind])
        log("[rpc] warmed: act on both replicas, context on "
            f"{RPC_REPLICAS[0]}")
        warm = {p: _remote_ledgers(client, p) for p in RPC_REPLICAS}

        def routed(req):
            return router.infer_async(req, budget_s=RPC_BUDGET_S)

        act = run("act (Router, 2 replicas)", "act", routed,
                  RPC_STEADY["act"], refs["act"], client)
        ctx = run("context (direct calls)", "context",
                  direct(RPC_REPLICAS[0], "context"), RPC_STEADY["context"],
                  refs["context"], client)
        # The context service again, pinned to the shm lane, then with
        # both peers on tcp only.
        with _sends_pinned_to_shm():
            shm = run("context pinned to shm", "context",
                      direct(RPC_REPLICAS[0], "context"), RPC_LANE_BATCHES,
                      refs["context"], client)
        if shm["lane"] != "shm":
            raise RuntimeError(f"the shm-pinned run rode {shm['lane']}")
        ctl("tcp")
        tcp_client = Rpc("chip-client-tcp")
        tcp_client.set_transports({"tcp"})
        tcp_client.set_timeout(RPC_BUDGET_S)
        tcp_client.connect(addrs[RPC_REPLICAS[0]])
        tcp_client.async_(RPC_REPLICAS[0], "context.health").result(
            timeout=RPC_BUDGET_S)
        conns = sorted(tcp_client.debug_info()["peers"][RPC_REPLICAS[0]][
            "connections"])
        if conns != ["tcp"]:
            raise RuntimeError(f"the tcp-only client has lanes {conns}")

        def tcp_submit(req):
            sent[RPC_REPLICAS[0]]["context"] += 1
            return tcp_client.call_with_deadline(
                RPC_REPLICAS[0], "context.infer", RPC_BUDGET_S, req)

        tcp = run("context over tcp only", "context", tcp_submit,
                  RPC_LANE_BATCHES, refs["context"], tcp_client)
        if tcp["lane"] != "tcp":
            raise RuntimeError(f"tcp run rode {tcp['lane']}")

        # Weights over the wire: version 2's state_dict travels as
        # tensors, to both act replicas through the router and to the
        # context replica through a router of its own.
        state2 = dict(net2.state_dict())
        acks = router.publish_weights(state2, version=2,
                                      timeout_s=RPC_BUDGET_S)
        ctx_router = Router(client, [RPC_REPLICAS[0]], service="context",
                            probe_interval_s=0.05, seed=0)
        try:
            acks.update({f"{p} context": ok for p, ok in
                         ctx_router.publish_weights(
                             state2, version=2,
                             timeout_s=RPC_BUDGET_S).items()})
        finally:
            ctx_router.close()
        if not all(acks.values()):
            raise RuntimeError(f"publish_weights failed: {acks}")
        health = {f"{p} {k}": client.async_(p, f"{k}.health").result(
            timeout=RPC_BUDGET_S)["model_version"]
            for p in RPC_REPLICAS for k in ("act", "context")
            if k == "act" or p == RPC_REPLICAS[0]}
        if set(health.values()) != {2}:
            raise RuntimeError(f"health after publish: {health}")
        v2 = {kind: run(f"{kind} on version 2", kind,
                        routed if kind == "act"
                        else direct(RPC_REPLICAS[0], "context"),
                        RPC_V2_BATCHES[kind], refs2[kind], client)
              for kind in ("act", "context")}
        log(f"[rpc] publish_weights v2: acks {acks} | health model_version "
            f"{health} | max|reply-dense v2 on CPU| "
            f"{max(r['max_abs_err'] for r in v2.values()):.3e}")

        # Observability over the wire.
        creg = client.telemetry.registry
        for peer in RPC_REPLICAS:
            sent[peer]["act"] += int(creg.value(
                "serving_dispatch_total", service="act", replica=peer) or 0)
        retried = creg.value("serving_retried_total", service="act") or 0
        out["telemetry"] = {}
        for peer in RPC_REPLICAS:
            js = client.async_(peer, "__telemetry").result(
                timeout=RPC_BUDGET_S)
            prom = parse_prometheus(client.async_(
                peer, "__telemetry", fmt="prometheus").result(
                    timeout=RPC_BUDGET_S))
            ledgers = _remote_ledgers(client, peer)
            for kind, n in sent[peer].items():
                if not n:
                    continue
                sid = {n2: f'serving_{n2}_total{{service="{kind}"}}'
                       for n2 in ("admitted", "completed")}
                vals = [js["metrics"][sid["admitted"]]["value"],
                        js["metrics"][sid["completed"]]["value"],
                        prom[sid["admitted"]], prom[sid["completed"]]]
                led = ledgers[f"{kind}_replica"]
                w = warm[peer][f"{kind}_replica"]
                steady = dict(
                    steps=led["steps"] - w["steps"],
                    wall_s=led["wall_s"] - w["wall_s"],
                    phases={ph: v - w["phases"].get(ph, 0.0)
                            for ph, v in led["phases"].items()})
                log(f"[stepscope] rpc {peer} {kind}_replica since the "
                    f"warm-up: {steady['steps']} steps, wall "
                    f"{1e3 * steady['wall_s']:.3f} ms | " + ", ".join(
                        f"{ph} {1e3 * v:.3f} ms ({v / steady['wall_s']:.3f})"
                        for ph, v in sorted(steady["phases"].items()))
                    + f" | warm-up {w['steps']} steps, wall "
                    f"{1e3 * w['wall_s']:.3f} ms")
                log(f"[telemetry] rpc {peer} {kind}: sent {n} | admitted, "
                    f"completed (JSON, Prometheus) {vals} | router retries "
                    f"{retried}")
                if retried or vals != [n] * 4:
                    raise RuntimeError(f"{peer} {kind}: serving counters "
                                       f"{vals} != requests sent {n}")
                out["telemetry"][f"{peer} {kind}"] = dict(
                    sent=n, ledger=led, steady=steady)
        offset, rtt = estimate_offset(client, RPC_REPLICAS[0])
        out["offset_us"], out["rtt_us"] = offset, rtt

        def scrape(peer):
            reply = client.async_(peer, "__flightrec").result(
                timeout=RPC_BUDGET_S)
            return validate_bundle(reply["bundle"]), reply["peers"]

        bundles, failed = crawl_cohort(client, [], scrape)
        out["crawl"] = {p: len(b["events"]) for p, b in bundles.items()}
        log(f"[flightrec] rpc: estimate_offset({RPC_REPLICAS[0]}) "
            f"{offset} us (rtt {rtt} us) | crawl_cohort: "
            f"{sorted(bundles)} validated ({out['crawl']} events), "
            f"failed {failed}")
        if failed or not set(RPC_REPLICAS) <= set(bundles):
            raise RuntimeError(f"crawl_cohort: got {sorted(bundles)}, "
                               f"failed {failed}")
        out["launches"] = {
            "rpc act": {k: act["launches"][k] + v2["act"]["launches"][k]
                        for k in act["launches"]},
            "rpc context": {k: ctx["launches"][k] + shm["launches"][k]
                            + tcp["launches"][k]
                            + v2["context"]["launches"][k]
                            for k in ctx["launches"]}}
    finally:
        for peer_rpc in (router, tcp_client, client):
            if peer_rpc is not None:
                peer_rpc.close()
        child.stdin.close()
        try:
            code = child.wait(timeout=60)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait(timeout=30)
            raise RuntimeError("the RPC child did not exit") from None
    if code != 0:
        raise RuntimeError(f"the RPC child exited with code {code}")
    return out


def _learn_batches(gen: torch.Generator, n: int):
    """``n`` consecutive learn batches of experiment.py's shape on the
    card: uint8 frames [T+1, B, 84, 84, 4]; an episode reset every
    EPISODE_LENGTH steps per env at a phase of its own (batch i starts
    where batch i-1 ended, as unrolls overlap by the bootstrap frame);
    rewards ~ N(0, 1), so reward_clip (1.0) cuts about a third of them;
    behaviour logits ~ N(0, 1) and actions sampled from them."""
    T, B, A = UNROLL, LEARN_B, 6
    phase = torch.randint(0, EPISODE_LENGTH, (1, B), generator=gen,
                          device="cuda")
    batches = []
    for i in range(n):
        t = torch.arange(T + 1, device="cuda")[:, None] + i * T
        logits = torch.randn((T, B, A), generator=gen, device="cuda")
        actions = torch.multinomial(torch.softmax(logits, -1).reshape(-1, A),
                                    1, generator=gen).reshape(T, B)
        batches.append({
            "obs": torch.randint(0, 256, (T + 1, B, 84, 84, 4),
                                 generator=gen, device="cuda",
                                 dtype=torch.uint8),
            "done": (t + phase) % EPISODE_LENGTH == 0,
            "rewards": torch.randn((T + 1, B), generator=gen,
                                   device="cuda"),
            "actions": actions,
            "behavior_logits": logits,
            "core_state": (),
        })
    return batches


def _to_cpu(batch):
    return {k: v.cpu() if torch.is_tensor(v) else v for k, v in batch.items()}


# Train steps on the card vs the same steps with dense attention on the
# CPU: everything is f32 but the two bf16 roundings both sides make alike
# (scaled pixels, pos_emb), so the difference is summation order (the
# kernels, cuDNN's f32 convolutions, cuBLAS). Metrics: 1e-4 relative.
# Gradients of step 1: 1e-3 of each tensor's largest entry; the conv
# torso's gradients are sums over up to 672*441 positions whose terms
# cancel, which amplifies the order's error (6.8e-5 at conv1.bias on an
# H100 80GB HBM3). pos_emb's gradient is rounded to bf16 on its way back
# through the compute-dtype cast, where one rounding may fall the other
# way: 2**-7. Parameters after the last step: a step moves a parameter
# by lr*g/sqrt(nu+eps), at most 10*lr = 6e-3 on the first step, so a
# 1e-4 relative gradient difference moves it by < 6e-7 a step: 2e-6
# absolute after three.
TRAIN_METRIC_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
BF16_GRAD_TOL = {"pos_emb.weight": 2.0 ** -7}
TRAIN_PARAM_TOL = 2e-6
CONV_PARAMS = ("conv0.weight", "conv0.bias", "conv1.weight", "conv1.bias")
METRICS = ("total_loss", "pg_loss", "baseline_loss", "entropy", "grad_norm")


def _kernel_class(name: str) -> str:
    """The part of the step a device work item belongs to, from its name
    (cuDNN's convolution kernels name their pass: fprop, dgrad, wgrad)."""
    n = name.lower()
    if "wgrad" in n:
        return "conv weight gradient"
    if "dgrad" in n:
        return "conv data gradient"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "conv layout transposes"
    if "fft" in n or "cf32" in n:  # cuDNN's FFT algorithm, any pass
        return "conv via FFT"
    if "fprop" in n or "convolve" in n or re.search(r"\bconv", n):
        return "conv forward"
    if "flash_" in n:
        return "flash kernels"
    if "gemm" in n or "gemv" in n or "cublas" in n or "cutlass" in n:
        return "dense (cuBLAS)"
    if "max_pool" in n:
        return "max-pool"
    if "memcpy" in n or "memset" in n:
        return "copies and fills"
    return "elementwise and other"


# The profiled step's range, and the CUDA API calls that may
# block the host: synchronizes, allocations and frees (cudaFree waits for
# the device), host registration, and the synchronous copies and fills.
STEP_RANGE = "chip_smoke step"


def _blocking_api(name: str) -> bool:
    return bool(re.search(r"Synchronize|Malloc|MemAlloc|Free|HostAlloc|"
                          r"HostRegister", name)) or name in (
        "cudaMemcpy", "cudaMemset", "cudaMemcpy2D", "cuMemcpy",
        "cuMemcpyHtoD_v2", "cuMemcpyDtoH_v2")


def _profile_step(run_step, tag: str = "train") -> dict:
    """One train step under torch.profiler: its wall time, the number of
    work items on the card (kernels, copies, fills), their summed device
    time (one stream, so no overlap), the device time by kernel class
    (_kernel_class), the largest items, the spans that record_function
    ranges (the optimizer's step, and whatever the caller marks) cover on
    the device timeline, and the device time of the work items that
    start inside each span. Also the CUDA API calls (cuda* and cu*) the
    host made inside the step itself (before its read back), by name:
    those that can block it (synchronizes, allocations and frees, which
    CUDA's sync debug mode does not all see), and the longest call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(STEP_RANGE):
            _, m = run_step()
        float(m["total_loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, spans, items = {}, {}, []
    step_range, api_calls = None, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            if e.name == STEP_RANGE:
                step_range = (e.time_range.start, e.time_range.end)
            elif re.match(r"cu[A-Z]|cuda[A-Z]", e.name):
                api_calls.append((e.name, e.time_range.start,
                                  e.time_range.elapsed_us()))
            continue
        r = e.time_range
        if e.name == STEP_RANGE:
            continue
        if e.is_user_annotation:  # a range over other work, not work
            spans.setdefault(e.name, []).append((r.start, r.end))
            continue
        items.append((e.name, r.start, r.elapsed_us()))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + r.elapsed_us())
    busy_ms = sum(us for _, us in by_name.values()) / 1e3
    by_class = {}
    for name, (n, us) in by_name.items():
        c = _kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
    span_ms = {name: sum(r1 - r0 for r0, r1 in rs) / 1e3
               for name, rs in spans.items()}
    span_work_ms = {
        name: sum(us for _, t, us in items
                  if any(r0 <= t < r1 for r0, r1 in rs)) / 1e3
        for name, rs in spans.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    log(f"[{tag}] profiled step: {wall_ms:.3f} ms wall (profiler on), "
        f"{len(items)} device work items, {busy_ms:.3f} ms device busy "
        f"({100 * busy_ms / wall_ms:.1f}% of the wall time)")
    log(f"[{tag}]   device ms by class: " + ", ".join(
        f"{c} {ms:.3f}" for c, ms in sorted(by_class.items(),
                                             key=lambda kv: -kv[1])))
    for name, (n, us) in top:
        log(f"[{tag}]   {us / 1e3:.3f} ms in {n} x {name[:90]}")
    for name in spans:
        log(f"[{tag}]   span {name}: {span_ms[name]:.3f} ms on the device "
            f"timeline, {span_work_ms[name]:.3f} ms of device work in it")
    if step_range is None:
        raise RuntimeError(f"{tag}: the profile holds no {STEP_RANGE!r} "
                           f"range")
    in_step = [(n, us) for n, t, us in api_calls
               if step_range[0] <= t < step_range[1]]
    api = {}
    for n, _ in in_step:
        api[n] = api.get(n, 0) + 1
    blocking = {n: c for n, c in api.items() if _blocking_api(n)}
    longest = max(in_step, key=lambda c: c[1], default=("none", 0.0))
    log(f"[{tag}]   host API calls in the step (to its read back): "
        f"{sum(api.values())}, "
        + ", ".join(f"{n} {c}" for n, c in sorted(api.items(),
                                                  key=lambda kv: -kv[1]))
        + f" | that can block the host: {blocking or 'none'} | longest "
        f"{longest[0]} {longest[1]:.1f} us, all "
        f"{sum(us for _, us in in_step) / 1e3:.3f} ms")
    return dict(wall_ms=wall_ms, device_items=len(items),
                host_api_calls=api, blocking_api_calls=blocking,
                longest_api_call=dict(name=longest[0], us=longest[1]),
                device_busy_ms=busy_ms, by_class_ms=by_class,
                spans_ms=span_ms, span_work_ms=span_work_ms,
                top=[dict(name=name[:90], count=n, ms=us / 1e3)
                     for name, (n, us) in top[:5]])


# StepScope ledgers of the scoped loops (phases 6 and 8): LEDGER_STEPS
# steps a loop, a step_phases flight event every FLIGHT_EVERY steps, and
# COST_ROUNDS rounds of (plain, scoped, scoped, plain) steps for
# telemetry's cost on the step.
LEDGER_STEPS = 8
FLIGHT_EVERY = 4
COST_ROUNDS = 3
LEDGER_PHASES = ("staging", "act", "fwd_bwd", "optimizer", "host_sync",
                 "other")


def _telemetry(name: str):
    """A fresh Telemetry for one phase: metrics and spans on."""
    from moolib_tpu_torch.telemetry import Telemetry

    return Telemetry(name, enabled=True, tracing=True)


def _no_sync(fn, *args):
    """``fn(*args)`` with CUDA's sync debug mode at "error": a scoped
    step only enqueues, so any call in it that waits for the device
    (a read back, a synchronize) raises here."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _read_metrics(m):
    """host_sync: the step's metrics on the host, in one copy."""
    return torch.stack([m[k].float() for k in METRICS]).cpu()


def _ledger(tel, scope, step_fn, steps: int = LEDGER_STEPS) -> dict:
    """Run ``steps`` steps of ``step_fn(i)`` (which opens its own phases)
    inside ``scope.step()``; returns the per-step ledgers in ms (from the
    scope's cumulative counters), each phase's median, and the loop's
    summary. Fails if the ledger does not close: the overrun gauge must
    read 0 (no phase claimed more than the step's wall time) and the
    phases, ``other`` included, must sum to the wall time."""
    per_step = []
    prev = scope.summary()
    for i in range(steps):
        with scope.step():
            step_fn(i)
        cur = scope.summary()
        row = {ph: 1e3 * (secs - prev["phases"].get(ph, 0.0))
               for ph, secs in cur["phases"].items()}
        row["wall"] = 1e3 * (cur["wall_s"] - prev["wall_s"])
        per_step.append(row)
        prev = cur
    summary = scope.summary()
    overrun = tel.registry.value("stepscope_ledger_overrun_fraction",
                                 loop=scope.loop)
    gap = abs(sum(summary["phases"].values()) - summary["wall_s"])
    if overrun != 0.0 or gap > 1e-9 * summary["wall_s"] or any(
            v < 0.0 for v in summary["phases"].values()):
        raise RuntimeError(f"{scope.loop}: the ledger does not close: "
                           f"overrun {overrun}, |phases - wall| {gap} s, "
                           f"phases {summary['phases']}")
    names = [ph for ph in LEDGER_PHASES if ph in summary["phases"]]
    names += sorted(set(summary["phases"]) - set(names))
    median = {ph: float(np.median([r.get(ph, 0.0) for r in per_step]))
              for ph in names + ["wall"]}
    return dict(loop=scope.loop, steps=summary["steps"], median_ms=median,
                per_step_ms=per_step,
                host_blocked=summary["fractions"]["host_blocked"],
                phases_s=summary["phases"], wall_s=summary["wall_s"],
                overrun=overrun)


def _log_ledger(tag: str, led: dict, breakdown=None, step_ms=None) -> None:
    """One ledger line; with the profiled step's ``breakdown`` and the
    steady step's time (CUDA events), the device's busy time beside it,
    as a share of both (the profiler slows the host, so the profiled
    step is the longer)."""
    m = led["median_ms"]
    busy_txt = ""
    if breakdown is not None:
        busy = breakdown["device_busy_ms"]
        busy_txt = (f" | profiler (same run): device busy {busy:.3f} ms, "
                    f"{100 * busy / breakdown['wall_ms']:.1f}% of the "
                    f"profiled step, {100 * busy / step_ms:.1f}% of the "
                    f"steady step")
    log(f"[stepscope] {tag} loop {led['loop']}: {led['steps']} steps, "
        f"median ms " + ", ".join(f"{ph} {m[ph]:.3f}" for ph in m
                                  if ph != "wall")
        + f" | wall {m['wall']:.3f} | host-blocked fraction "
        f"{led['host_blocked']:.3f} | overrun {led['overrun']}" + busy_txt)


def _train_ledgers(tag: str, tel, cfg, state, batches, optimizer,
                   count_launches=None) -> dict:
    """The scoped loops of one learner: the fused train step (staging the
    learn batch from the host, the step as ``fwd_bwd``, the metrics read
    back as ``host_sync``), the grad/apply split (``fwd_bwd``,
    ``optimizer``) on a copy of the model, and telemetry's cost: plain
    and scoped steps in (plain, scoped, scoped, plain) turns, each to its
    metrics on the host. Every scoped call of the two ledgers runs under
    _no_sync. ``count_launches()``, when given, is called after each
    fused step. Returns the ledgers and the cost."""
    from moolib_tpu_torch import (
        make_apply_step,
        make_grad_step,
        make_impala_train_step,
        make_train_state,
    )
    from moolib_tpu_torch.ops import stage_batch
    from moolib_tpu_torch.telemetry import StepScope

    host = [_to_cpu(b) for b in batches]
    scope = StepScope(f"{tag}_train", telemetry=tel,
                      flight_every=FLIGHT_EVERY)
    step = make_impala_train_step(config=cfg, stepscope=scope)
    box = [state]

    def fused(i):
        with scope.phase("staging"):
            batch = stage_batch(host[i % len(host)], "cuda")
        box[0], m = _no_sync(step, box[0], batch)
        with scope.phase("host_sync"):
            _read_metrics(m)
        if count_launches is not None:
            count_launches()

    fused_led = _ledger(tel, scope, fused)

    split_scope = StepScope(f"{tag}_split", telemetry=tel,
                            flight_every=FLIGHT_EVERY)
    twin = copy.deepcopy(box[0].model)
    split_state = [make_train_state(twin, optimizer(twin))]
    grad_step = make_grad_step(config=cfg, stepscope=split_scope)
    apply_step = make_apply_step(stepscope=split_scope)

    def split(i):
        with split_scope.phase("staging"):
            batch = stage_batch(host[i % len(host)], "cuda")
        grads, m = _no_sync(grad_step, split_state[0].model, batch)
        split_state[0] = _no_sync(apply_step, split_state[0], grads)
        with split_scope.phase("host_sync"):
            _read_metrics(m)

    split_led = _ledger(tel, split_scope, split)
    del twin, split_state

    cost_scope = StepScope(f"{tag}_cost", telemetry=tel,
                           flight_every=FLIGHT_EVERY)
    plain = make_impala_train_step(config=cfg)
    scoped = make_impala_train_step(config=cfg, stepscope=cost_scope)
    times = {"plain": [], "scoped": []}
    for i in range(4 * COST_ROUNDS):
        kind = ("plain", "scoped", "scoped", "plain")[i % 4]
        batch = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "plain":
            box[0], m = plain(box[0], batch)
            _read_metrics(m)
        else:
            with cost_scope.step():
                box[0], m = scoped(box[0], batch)
                with cost_scope.phase("host_sync"):
                    _read_metrics(m)
        times[kind].append(1e3 * (time.perf_counter() - t0))
    cost = {k: float(np.median(v)) for k, v in times.items()}
    cost["ratio"] = cost["scoped"] / cost["plain"]
    log(f"[telemetry] {tag}: train step to its metrics on the host, "
        f"{2 * COST_ROUNDS} steps each in (plain, scoped, scoped, plain) "
        f"turns: stepscope=None median {cost['plain']:.3f} ms, live scope "
        f"(spans on) {cost['scoped']:.3f} ms, ratio {cost['ratio']:.4f} "
        f"| all ms plain {[round(x, 3) for x in times['plain']]} scoped "
        f"{[round(x, 3) for x in times['scoped']]}")
    return dict(train=fused_led, split=split_led, cost=cost,
                state=box[0])


def phase_train(tel):
    from moolib_tpu_torch import (
        ClippedRMSprop,
        ImpalaConfig,
        TransformerNet,
        impala_loss,
        make_apply_step,
        make_grad_step,
        make_impala_train_step,
        make_train_state,
    )
    from moolib_tpu_torch.analysis import guarded_jit, recompile_budget
    from moolib_tpu_torch.learner import call_model
    from moolib_tpu_torch.ops import attention as attention_ops
    from moolib_tpu_torch.ops._kernels import KERNELS

    gen = torch.Generator(device="cuda").manual_seed(2)

    def model(device, backend, generator=None):
        # experiment.py's transformer at full width (as in phase 5).
        return TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                              attention_backend=backend, device=device,
                              generator=generator)

    def optimizer(net):
        # experiment.py:240-243: clip_by_global_norm(40), then
        # rmsprop(6e-4, decay=0.99, eps=0.01).
        return ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                              max_norm=40.0)

    # experiment.py:246-251's values (discounting 0.99, baseline_cost
    # 0.5, entropy_cost 0.0006, reward_clip 1.0).
    cfg = ImpalaConfig(discounting=0.99, baseline_cost=0.5,
                       entropy_cost=0.0006, reward_clip=1.0)
    net = model("cuda", "auto", gen)
    cpu = model("cpu", "dense")
    cpu.load_state_dict(net.state_dict())
    twin = copy.deepcopy(net)
    batches = _learn_batches(gen, TRAIN_STEPS)
    clipped = float(torch.stack([(b["rewards"][1:].abs() > 1).float().mean()
                                 for b in batches]).mean())
    resets = int(sum(int(b["done"][1:].sum()) for b in batches))
    log(f"[train] learn batches obs {tuple(batches[0]['obs'].shape)} u8 x "
        f"{TRAIN_STEPS}; {resets} resets; reward_clip cuts "
        f"{100 * clipped:.0f}% of rewards")

    # Gradients of step 1, card vs CPU.
    g_card, _ = make_grad_step(config=cfg)(net, batches[0])
    g_cpu, _ = make_grad_step(config=cfg)(cpu, _to_cpu(batches[0]))

    def rel_errs(grads):
        return {n: float((grads[n].cpu() - g_cpu[n]).abs().max())
                / float(g_cpu[n].abs().max()) for n in g_cpu}

    errs = rel_errs(g_card)
    worst = max((n for n in errs if n not in BF16_GRAD_TOL), key=errs.get)
    grad_err = errs[worst]
    log(f"[train] step-1 gradients vs CPU: max relative error {grad_err:.3e}"
        f" at {worst} (tol {TRAIN_GRAD_TOL}); "
        + " ".join(f"{n} {errs[n]:.3e} (tol {t:.3e})"
                   for n, t in BF16_GRAD_TOL.items())
        + "; conv torso " + " ".join(f"{n} {errs[n]:.3e}" for n in CONV_PARAMS))
    bad = [n for n, e in errs.items()
           if not e <= BF16_GRAD_TOL.get(n, TRAIN_GRAD_TOL)]
    if bad:
        raise RuntimeError(f"step-1 gradients differ from the CPU's at "
                           f"{bad}")
    # Control: the same gradients with cuDNN's TF32 left on (PyTorch's
    # default) for the backward, as the port computed them before the
    # train steps held it off there too.
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        total, _ = impala_loss(net, call_model, batches[0], cfg)
        names = [n for n, _ in net.named_parameters()]
        tf32 = dict(zip(names, torch.autograd.grad(total,
                                                   list(net.parameters()))))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    tf32_errs = rel_errs(tf32)
    log("[train] control, TF32 in the backward: conv torso "
        + " ".join(f"{n} {tf32_errs[n]:.3e}" for n in CONV_PARAMS)
        + f"; max over all {max(tf32_errs.values()):.3e}")
    del g_card, g_cpu, tf32

    # The main path: 3 fused train steps, launch counts from 0.
    step = make_impala_train_step(config=cfg)
    state = make_train_state(net, optimizer(net))
    ref_step = make_impala_train_step(config=cfg)
    ref_state = make_train_state(cpu, optimizer(cpu))
    metrics, ref_metrics, per_step = [], [], []
    # delta is the fused kernel's own work at T = 21: count any call of
    # the two-kernel design's delta ops on this path.
    plain_delta, delta_calls = attention_ops._flash_delta, []

    def counted_delta(o, do):
        delta_calls.append(tuple(o.shape))
        return plain_delta(o, do)

    attention_ops._flash_delta = counted_delta
    try:
        for kern in KERNELS:
            kern.launches = 0
        for i, batch in enumerate(batches):
            before = [kern.launches for kern in KERNELS]
            state, m = step(state, batch)
            metrics.append({k: float(m[k]) for k in METRICS})  # hotlint: sync -- the smoke reads each step's metrics to hold them to the CPU's
            per_step.append([kern.launches - n for kern, n in
                             zip(KERNELS, before)])
            if i == 0:
                after_one = {k: v.clone()
                             for k, v in net.state_dict().items()}
        launches = {kern.name: kern.launches for kern in KERNELS}
    finally:
        attention_ops._flash_delta = plain_delta
    log(f"[train] launches per step {per_step} "
        f"({[kern.name for kern in KERNELS]}); total {launches}; "
        f"_flash_delta calls {len(delta_calls)}")
    # Per layer per step: one forward and one fused backward launch.
    want = [2 if kern.name in ("flash_fwd", "flash_bwd_tile") else 0
            for kern in KERNELS]
    if any(row != want for row in per_step) or delta_calls:
        raise RuntimeError(f"each train step must launch {want} "
                           f"({[kern.name for kern in KERNELS]}) and no "
                           f"delta op; got {per_step}, {delta_calls}")
    for batch in batches:
        ref_state, m = ref_step(ref_state, _to_cpu(batch))
        ref_metrics.append({k: float(m[k]) for k in METRICS})  # hotlint: sync -- the CPU reference's metrics, read to compare
    for i, (m, r) in enumerate(zip(metrics, ref_metrics)):
        errs = {k: abs(m[k] - r[k]) / max(abs(r[k]), 1e-30) for k in METRICS}
        log(f"[train] step {i + 1}: "
            + " ".join(f"{k} {m[k]:.6g}" for k in METRICS)
            + f" | max relative error vs CPU {max(errs.values()):.3e} "
            f"(tol {TRAIN_METRIC_TOL})")
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"non-finite metrics at step {i + 1}: {m}")
        if max(errs.values()) > TRAIN_METRIC_TOL:
            raise RuntimeError(f"step {i + 1} metrics differ from the CPU "
                               f"steps: {errs}")
    ref_params = cpu.state_dict()
    param_err = max(float((p.cpu() - ref_params[n]).abs().max())
                    for n, p in net.state_dict().items())
    finite = all(bool(torch.isfinite(p).all())
                 for p in net.state_dict().values())
    log(f"[train] parameters after step {TRAIN_STEPS}: max|card-CPU| "
        f"{param_err:.3e} (tol {TRAIN_PARAM_TOL}); finite {finite}")
    if not finite or param_err > TRAIN_PARAM_TOL:
        raise RuntimeError("parameters after the train steps differ from "
                           "the CPU steps")

    # experiment.py's split: grads x learn_batch_size, the one-peer
    # Accumulator mean (divide by the count), then the apply step.
    grads, _ = make_grad_step(config=cfg, grad_scale=float(LEARN_B))(
        twin, batches[0])
    grads = {n: g / LEARN_B for n, g in grads.items()}
    twin_state = make_apply_step()(make_train_state(twin, optimizer(twin)),
                                   grads)
    split_err = max(float((p - after_one[n]).abs().max())
                    for n, p in twin.state_dict().items())
    bitwise = all(torch.equal(p, after_one[n])
                  for n, p in twin.state_dict().items())
    # cuDNN's weight gradients may sum in another order from call to
    # call; anything else is the same arithmetic.
    log(f"[train] grad step x{LEARN_B} / {LEARN_B} + apply step vs fused "
        f"step 1: max|diff| {split_err:.3e} (tol 1e-7), bitwise {bitwise}; "
        f"step {twin_state.step}")
    if split_err > 1e-7 or twin_state.step != 1:
        raise RuntimeError("the grad/apply split differs from the fused "
                           "train step")

    # Steady state: more steps on the same batches, timed. The steps
    # after the first are under recompile_guard: none may build a kernel
    # library (every one was built before the first step).
    event_ms, host_ms = [], []
    steady_step = guarded_jit(step)
    with recompile_budget(steady_step, max_compiles=0,
                          label="steady train steps") as steady_guard:
        for i in range(8):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()  # hotlint: sync -- a timing barrier: each step is timed alone
            t0 = time.perf_counter()
            start.record()
            state, m = steady_step(state, batches[i % TRAIN_STEPS])
            end.record()
            float(m["total_loss"])  # hotlint: sync -- the step's result, on the host: the host clock's end
            end.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - t0))
            event_ms.append(start.elapsed_time(end))
    log(f"[train] recompile_budget(max_compiles=0) over the 8 steady steps: "
        f"{steady_guard.compiles} kernel-library builds")
    log(f"[train] step time ms (CUDA events) "
        f"{[round(x, 3) for x in event_ms]}")
    log(f"[train] step time ms (host clock, to the loss on the host) "
        f"{[round(x, 3) for x in host_ms]}")
    steady = event_ms[2:]
    log(f"[train] steady-state step: {float(np.median(steady)):.3f} ms "
        f"(CUDA events, median of steps 3-8), "
        f"{float(np.median(host_ms[2:])):.3f} ms (host clock)")
    breakdown = _profile_step(lambda: step(state, batches[0]))

    # The scoped loops. Each fused step must still launch the forward and
    # the fused backward twice (once per layer) with the scope on.
    scoped_launches, last = [], [kern.launches for kern in KERNELS]

    def count_launches():
        nonlocal last
        now = [kern.launches for kern in KERNELS]
        scoped_launches.append([a - b for a, b in zip(now, last)])
        last = now

    ledgers = _train_ledgers("transformer", tel, cfg, state, batches,
                             optimizer, count_launches)
    state = ledgers.pop("state")
    step_ms = float(np.median(steady))
    _log_ledger("transformer", ledgers["train"], breakdown, step_ms)
    _log_ledger("transformer", ledgers["split"], breakdown, step_ms)
    log(f"[stepscope] transformer: launches per scoped step "
        f"{scoped_launches} ({[kern.name for kern in KERNELS]})")
    if any(row != want for row in scoped_launches):
        raise RuntimeError(f"each scoped train step must launch {want}; "
                           f"got {scoped_launches}")
    return dict(launches=launches, metrics=metrics, grad_err=grad_err,
                breakdown=breakdown, ledgers=ledgers,
                tf32_grad_err={n: tf32_errs[n] for n in CONV_PARAMS},
                param_err=param_err, split_err=split_err,
                steady_builds=steady_guard.compiles,
                step_ms=float(np.median(steady)),
                step_host_ms=float(np.median(host_ms[2:])))


# The impala learner path (experiment.py's default model="auto" on pixel
# envs builds ImpalaNet). The card's steps against the same steps on the
# CPU, which differ by more than summation order: f32 convolutions round
# otherwise on the two, and where a max-pool window's two largest inputs
# (or a relu's input and zero) lie within that rounding the two pick
# differently and a position's gradient goes elsewhere; over 672 frames
# some windows do, and three steps of training carry the difference on.
# bf16 rounds every conv's product and bias add, so its flips are many.
# Proxy on the CPU before the first card run (the port against the
# reference jitted, which rounds otherwise too, same shapes and chain):
# f32 step-1 gradients 2.1e-3 of a tensor's largest entry, metrics
# within 1.4e-3 relative over 3 steps, parameters 5.4e-6 absolute; bf16
# gradients 2.6e-2 in norm over all of them (a tensor whose gradient
# nearly cancels, such as the baseline head's bias, can differ wholly:
# bf16 is held only by the norm over all), metrics 5.8e-2, parameters
# 4.8e-5. Tolerances: a few times that. Measured on an H100 80GB HBM3
# (700 W): f32 1.1e-3, 3.4e-4, 1.7e-6; bf16 3.0e-2, 2.5e-2, 2.8e-5.
IMPALA_TOL = {
    torch.float32: dict(metric=5e-3, grad=1e-2, param=2e-5),
    torch.bfloat16: dict(metric=0.15, grad_global=0.1, param=2e-4),
}
# Act step: a forward only, no gradient to send elsewhere: f32 summation
# order (1e-4 of the largest entry; measured 1.6e-6 on an H100 80GB
# HBM3); bf16 rounds every layer and the state carries the flips on over
# the steps (measured 1.05e-2 there): 3e-2.
IMPALA_ACT_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
IMPALA_ACT_STEPS = 4
BENCH_B = 256


def _impala_train(dtype, tel) -> dict:
    from torch.profiler import record_function

    from moolib_tpu_torch import (
        ClippedRMSprop,
        ImpalaConfig,
        ImpalaNet,
        make_apply_step,
        make_grad_step,
        make_impala_train_step,
        make_train_state,
    )
    from moolib_tpu_torch.ops import vtrace as vtrace_ops
    from moolib_tpu_torch.optim import global_norm

    tag = f"impala {str(dtype)[6:]}"
    tol = IMPALA_TOL[dtype]
    gen = torch.Generator(device="cuda").manual_seed(4)
    net = ImpalaNet(6, compute_dtype=dtype, device="cuda", generator=gen)
    cpu = ImpalaNet(6, compute_dtype=dtype, device="cpu")
    cpu.load_state_dict(net.state_dict())
    twin = copy.deepcopy(net)

    def optimizer(model):  # experiment.py's chain, as in phase 6
        return ClippedRMSprop(model.parameters(), 6e-4, decay=0.99,
                              eps=0.01, max_norm=40.0)

    cfg = ImpalaConfig(discounting=0.99, baseline_cost=0.5,
                       entropy_cost=0.0006, reward_clip=1.0)
    batches = _learn_batches(gen, TRAIN_STEPS)
    log(f"[{tag}] full-width ImpalaNet (16/32/32, hidden 256, 6 actions, "
        f"{sum(p.numel() for p in net.parameters())} parameters), learn "
        f"batches obs {tuple(batches[0]['obs'].shape)} u8 x {TRAIN_STEPS}, "
        f"{int(sum(int(b['done'][1:].sum()) for b in batches))} resets")

    g_card, _ = make_grad_step(config=cfg)(net, batches[0])
    g_cpu, _ = make_grad_step(config=cfg)(cpu, _to_cpu(batches[0]))
    diff = {n: (g_card[n].cpu() - g_cpu[n]) for n in g_cpu}
    max_rel = {n: float(d.abs().max()) / float(g_cpu[n].abs().max())
               for n, d in diff.items()}
    worst = max(max_rel, key=max_rel.get)
    global_rel = float(global_norm(diff.values())
                       / global_norm(g_cpu.values()))
    log(f"[{tag}] step-1 gradients vs CPU: largest error relative to the "
        f"tensor's largest entry {max_rel[worst]:.3e} at {worst} (its "
        f"norm {float(g_cpu[worst].norm()):.3e}); all gradients together, "
        f"|card-CPU| / |CPU| {global_rel:.3e} (|CPU| "
        f"{float(global_norm(g_cpu.values())):.3e})")
    if "grad" in tol and max_rel[worst] > tol["grad"]:
        raise RuntimeError(f"{tag} step-1 gradients differ from the CPU's "
                           f"by {max_rel[worst]:.3e} > {tol['grad']}")
    if "grad_global" in tol and global_rel > tol["grad_global"]:
        raise RuntimeError(f"{tag} step-1 gradients differ from the CPU's "
                           f"by {global_rel:.3e} in norm > "
                           f"{tol['grad_global']}")
    grad_errs = dict(max_rel=max_rel[worst], global_rel=global_rel)
    del g_card, g_cpu

    step = make_impala_train_step(config=cfg)
    state = make_train_state(net, optimizer(net))
    ref_step = make_impala_train_step(config=cfg)
    ref_state = make_train_state(cpu, optimizer(cpu))
    metric_errs, param_errs = [], []
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        ref_state, r = ref_step(ref_state, _to_cpu(batch))
        m = {k: float(m[k]) for k in METRICS}  # hotlint: sync -- the smoke reads each step's metrics to hold them to the CPU's
        r = {k: float(r[k]) for k in METRICS}  # hotlint: sync -- the CPU reference's metrics, read to compare
        errs = {k: abs(m[k] - r[k]) / max(abs(r[k]), 1e-2) for k in METRICS}
        ref_params = cpu.state_dict()
        param_err = max(float((p.cpu() - ref_params[n]).abs().max())
                        for n, p in net.state_dict().items())
        metric_errs.append(max(errs.values()))
        param_errs.append(param_err)
        log(f"[{tag}] step {i + 1}: "
            + " ".join(f"{k} {m[k]:.6g}" for k in METRICS)  # hotlint: sync -- logged once per checked step
            + f" | max error vs CPU (relative to max(|value|, 0.01)) "
            f"{max(errs.values()):.3e} (tol {tol['metric']}) | parameters "
            f"max|card-CPU| {param_err:.3e} (tol {tol['param']})")
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"{tag}: non-finite metrics at step {i + 1}")
        if max(errs.values()) > tol["metric"] or param_err > tol["param"]:
            raise RuntimeError(f"{tag} step {i + 1} differs from the CPU's")
        if i == 0:
            after_one = {k: v.clone() for k, v in net.state_dict().items()}
    if not all(bool(torch.isfinite(p).all()) for p in net.parameters()):
        raise RuntimeError(f"{tag}: parameters not finite")

    # experiment.py's split, as in phase 6: grads x B, the one-peer mean,
    # then the apply step, against the fused step 1.
    grads, _ = make_grad_step(config=cfg, grad_scale=float(LEARN_B))(
        twin, batches[0])
    make_apply_step()(make_train_state(twin, optimizer(twin)),
                      {n: g / LEARN_B for n, g in grads.items()})
    split_err = max(float((p - after_one[n]).abs().max())
                    for n, p in twin.state_dict().items())
    log(f"[{tag}] grad step x{LEARN_B} / {LEARN_B} + apply step vs fused "
        f"step 1: max|diff| {split_err:.3e} (tol 1e-6)")
    if split_err > 1e-6:
        raise RuntimeError(f"{tag}: the grad/apply split differs from the "
                           f"fused train step")
    del grads, twin

    event_ms, host_ms = [], []
    for i in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()  # hotlint: sync -- a timing barrier: each step is timed alone
        t0 = time.perf_counter()
        start.record()
        state, m = step(state, batches[i % TRAIN_STEPS])
        end.record()
        float(m["total_loss"])  # hotlint: sync -- the host clock times the step to its loss on the host
        end.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        event_ms.append(start.elapsed_time(end))
    log(f"[{tag}] step time ms (CUDA events) "
        f"{[round(x, 3) for x in event_ms]}")
    log(f"[{tag}] step time ms (host clock, to the loss on the host) "
        f"{[round(x, 3) for x in host_ms]}")
    step_ms = float(np.median(event_ms[2:]))
    step_host_ms = float(np.median(host_ms[2:]))
    log(f"[{tag}] steady-state step: {step_ms:.3f} ms (CUDA events, median "
        f"of steps 3-8), {step_host_ms:.3f} ms (host clock); "
        f"{UNROLL * LEARN_B / step_ms * 1e3:.0f} env-steps/s")

    # One step profiled, with the model's forward and V-trace marked.
    def forward(model, obs, done, core_state):
        with record_function("impala forward"):
            return model(obs, done, core_state)

    plain_vtrace = vtrace_ops.from_logits

    def traced_vtrace(*args, **kwargs):
        with record_function("vtrace"):
            return plain_vtrace(*args, **kwargs)

    marked = make_impala_train_step(apply_fn=forward, config=cfg)
    vtrace_ops.from_logits = traced_vtrace
    try:
        breakdown = _profile_step(lambda: marked(state, batches[0]), tag)
    finally:
        vtrace_ops.from_logits = plain_vtrace
    ledgers = _train_ledgers(f"impala_{str(dtype)[6:]}", tel, cfg, state,
                             batches, optimizer)
    del ledgers["state"]
    _log_ledger(tag, ledgers["train"], breakdown, step_ms)
    _log_ledger(tag, ledgers["split"], breakdown, step_ms)
    return dict(grad_err=grad_errs, metric_err=metric_errs,
                param_err=param_errs, split_err=split_err, step_ms=step_ms,
                step_host_ms=step_host_ms, breakdown=breakdown,
                ledgers=ledgers)


def _impala_act(dtype, tel) -> dict:
    """The act step of the LSTM ImpalaNet for ACT_ENVS envs at T=1, its
    state threaded over IMPALA_ACT_STEPS steps (a reset at step 2 for a
    quarter of the envs), against the same steps on the CPU."""
    from moolib_tpu_torch import ImpalaNet, make_act_step
    from moolib_tpu_torch.telemetry import StepScope

    tag = f"impala act {str(dtype)[6:]}"
    gen = torch.Generator(device="cuda").manual_seed(5)
    net = ImpalaNet(6, use_lstm=True, compute_dtype=dtype, device="cuda",
                    generator=gen).eval()
    cpu = ImpalaNet(6, use_lstm=True, compute_dtype=dtype,
                    device="cpu").eval()
    cpu.load_state_dict(net.state_dict())
    act, ref_act = make_act_step(net), make_act_step(cpu)
    sample = torch.Generator(device="cuda").manual_seed(6)
    ref_sample = torch.Generator().manual_seed(6)  # numlint: prng-key-reuse -- the CPU reference must draw the card's samples
    state, ref_state = net.initial_state(ACT_ENVS), cpu.initial_state(ACT_ENVS)
    errs, ms = [], []
    for t in range(IMPALA_ACT_STEPS):
        obs = torch.randint(0, 256, (ACT_ENVS, 84, 84, 4), generator=gen,
                            device="cuda", dtype=torch.uint8)
        done = torch.zeros(ACT_ENVS, dtype=torch.bool, device="cuda")  # hotlint: sync -- a fresh mask each step: step 2 writes resets into it
        if t == 2:
            done[: ACT_ENVS // 4] = True
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        actions, logits, state = act(obs, done, state, sample)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        _, ref_logits, ref_state = ref_act(obs.cpu(), done.cpu(), ref_state,
                                           ref_sample)
        if actions.shape != (ACT_ENVS,) or not bool(  # hotlint: sync -- the smoke checks every step's actions
                ((actions >= 0) & (actions < 6)).all()):
            raise RuntimeError(f"{tag}: bad actions {actions}")  # hotlint: sync -- only on the failure path
        for got, want in ((logits, ref_logits), *zip(state, ref_state)):
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{tag}: non-finite output")
            errs.append(float((got.cpu() - want).abs().max())
                        / float(want.abs().max()))
    log(f"[{tag}] LSTM ImpalaNet, {ACT_ENVS} envs x {IMPALA_ACT_STEPS} "
        f"steps, state threaded: max error vs CPU (logits, c, h; relative "
        f"to the largest entry) {max(errs):.3e} (tol "
        f"{IMPALA_ACT_TOL[dtype]}) | act step ms (CUDA events) "
        f"{[round(x, 3) for x in ms]}")
    if max(errs) > IMPALA_ACT_TOL[dtype]:
        raise RuntimeError(f"{tag} differs from the CPU by {max(errs):.3e}")

    # The actor's loop, scoped: the act step as ``act``, the actions and
    # behaviour logits read back as ``host_sync``.
    scope = StepScope(f"impala_{str(dtype)[6:]}_actor", telemetry=tel,
                      flight_every=FLIGHT_EVERY)
    scoped_act = make_act_step(net, stepscope=scope)
    frames = [torch.randint(0, 256, (ACT_ENVS, 84, 84, 4), generator=gen,
                            device="cuda", dtype=torch.uint8)
              for _ in range(LEDGER_STEPS)]
    done = torch.zeros(ACT_ENVS, dtype=torch.bool, device="cuda")
    box = [net.initial_state(ACT_ENVS)]

    def actor(i):
        actions, logits, box[0] = _no_sync(scoped_act, frames[i], done,
                                           box[0], sample)
        with scope.phase("host_sync"):
            actions.cpu()
            logits.cpu()

    led = _ledger(tel, scope, actor)
    _log_ledger(tag, led)
    return dict(max_err=max(errs), act_ms=ms, ledger=led)


def phase_impala(tel):
    """The impala learner path: full-width ImpalaNet trained on
    experiment.py's learn batch in f32 and in bf16 against the CPU, the
    LSTM variant's act step, then bench_torch.py at B=256 and one of its
    steps profiled."""
    import bench_torch

    out = {str(dtype)[6:]: _impala_train(dtype, tel)
           for dtype in (torch.float32, torch.bfloat16)}
    out["act"] = {str(dtype)[6:]: _impala_act(dtype, tel)
                  for dtype in (torch.float32, torch.bfloat16)}
    line = bench_torch.main(batch=BENCH_B)
    if not line["value"] or line["mfu"] is None:
        raise RuntimeError(f"bench_torch.py gave no throughput or MFU: "
                           f"{line}")
    step, state, batch = bench_torch.build("cuda", BENCH_B)
    for _ in range(2):  # cuDNN's choice of algorithms, first allocations
        state, _ = step(state, batch)
    out["bench"] = dict(line=line, breakdown=_profile_step(
        lambda: step(state, batch), f"bench B={BENCH_B}"))
    return out


# The accumulate phase: the elastic gradient plane on the card.
ACC_CHILD_FLAG = "--acc-child"
ACC_VBS = 2 * LEARN_B     # virtual batch: one learn batch from each of 2 peers
ACC_UPDATES = 6           # two peers
ACC_JOIN_UPDATES = 4      # then three, after learner-2 joins
ACC_IMPALA_UPDATES = 3
ACC_CHUNK = 1 << 20       # MOOLIB_TPU_ALLREDUCE_CHUNK of the chunked run
ACC_GROUP_TIMEOUT = 60.0
ACC_BUDGET_S = 300.0
ACC_BENCH_TIMEOUT_S = 240.0
# One learner thread at a time runs under CUDA's sync debug mode, which
# is one setting of the whole process.
_SYNC_MODE_LOCK = threading.Lock()


def _checksums(tensors) -> torch.Tensor:
    """Per tensor, two int64 sums over its raw bits (plain, and weighted by
    position), on the card: equal rows mean equal bytes, up to a collision
    of both sums. Integer sums do not depend on the order of addition."""
    rows = []
    for t in tensors:
        flat = t.detach().reshape(-1)
        bits = flat.view(torch.int16 if flat.element_size() == 2
                         else torch.int32).to(torch.int64)
        w = torch.arange(1, bits.numel() + 1, device=bits.device)
        rows.append(torch.stack([bits.sum(), (bits * w).sum()]))
    return torch.stack(rows)


class _Learner:
    """One elastic learner of the accumulate phase: its own Rpc (and
    Telemetry), a Group at sort order ``rank`` (its place in the reduce
    tree), an Accumulator(virtual_batch_size=64, parallel_gradients=1)
    whose get_state/set_state take the state lock, a model with
    experiment.py's RMSprop chain, make_grad_step(grad_scale=32) and
    make_apply_step, one seeded learn batch of its own, and a
    GlobalStatsAccumulator of its env_steps. Its thread owns the
    Accumulator: it calls update(), contributes one gradient an update
    (skipping the count rounds that poll it again before the virtual
    batch fills) while its params are below ``target``, and applies every
    result: the mean goes onto the card pinned and non-blocking, the
    apply runs under the state lock, and the params' checksums are
    recorded on the card for every version. A subclass may set up more
    in ``_before_join`` (the model and optimizer are built, the group not
    joined yet) and ``_before_run`` (the Accumulator exists, its thread
    not started yet)."""

    GROUP_TIMEOUT = ACC_GROUP_TIMEOUT

    def __init__(self, name: str, rank: int, broker_addr: str, group: str,
                 kind: str, seed: int = 0, chunk_bytes=None):
        from moolib_tpu_torch import (ClippedRMSprop, ImpalaConfig, ImpalaNet,
                                      make_apply_step, make_grad_step,
                                      make_train_state)
        from moolib_tpu_torch.parallel import (Accumulator,
                                               GlobalStatsAccumulator)
        from moolib_tpu_torch.rpc import Group, Rpc
        from moolib_tpu_torch.telemetry import Telemetry
        from moolib_tpu_torch.utils import StatSum, Stats

        self.name = name
        self.rpc = Rpc(name, telemetry=Telemetry(name, enabled=True))
        self.rpc.set_timeout(ACC_BUDGET_S)
        self.rpc.listen("127.0.0.1:0")
        self.rpc.connect(broker_addr)
        if kind == "transformer":
            net = _serve_net(seed).train()
        else:  # experiment.py's default pixel model, f32
            net = ImpalaNet(6, compute_dtype=torch.float32, device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(4 + seed))
        self.state = make_train_state(net, ClippedRMSprop(
            net.parameters(), 6e-4, decay=0.99, eps=0.01, max_norm=40.0))
        cfg = ImpalaConfig(discounting=0.99, baseline_cost=0.5,
                           entropy_cost=0.0006, reward_clip=1.0)
        self.grad_step = make_grad_step(config=cfg,
                                        grad_scale=float(LEARN_B))
        self.apply_step = make_apply_step()
        self.batch = _learn_batches(torch.Generator(
            device="cuda").manual_seed(100 + rank), 1)[0]
        self.lock = threading.Lock()  # the state lock
        self._before_join()
        self.group = Group(self.rpc, group_name=group, sort_order=rank,
                           timeout=self.GROUP_TIMEOUT)
        self.acc = Accumulator(
            self.rpc, group=self.group, virtual_batch_size=ACC_VBS,
            parallel_gradients=1, get_state=self._get_state,
            set_state=self._set_state, chunk_bytes=chunk_bytes)
        self.stats = Stats(env_steps=StatSum())
        self.gsa = GlobalStatsAccumulator(self.group, self.stats)
        self.target = 0
        self.done_step = 0  # the step of the last update fully recorded
        self.sent = False
        self.t_sent = None  # when the last contribution was handed over
        self.first_mean = None
        self.contribs, self.applies = [], []
        self.error = None
        self.stop = threading.Event()
        self._before_run()
        self.thread = threading.Thread(target=self._run, daemon=True,  # lifelint: intentional -- close() stops and joins it; a learner lives for one phase
                                       name=f"learner {name}")
        self.thread.start()

    def _before_join(self):
        pass

    def _before_run(self):
        pass

    def _get_state(self):
        from moolib_tpu_torch.learner import train_state_to_host

        try:
            with self.lock:
                return train_state_to_host(self.state)
        except Exception as e:  # reported by status(), fails the phase
            self.error = f"get_state: {type(e).__name__}: {e}"
            raise

    def _set_state(self, payload):
        from moolib_tpu_torch.learner import load_train_state

        try:
            with self.lock:
                self.state = load_train_state(self.state, payload)
                self.done_step = self.state.step
        except Exception as e:  # reported by status(), fails the phase
            self.error = f"set_state: {type(e).__name__}: {e}"
            raise

    def _run(self):
        try:
            while not self.stop.is_set():
                self.acc.update()
                busy = False
                if (self.state.step < self.target  # racelint: unguarded -- this thread is the state's only writer but for set_state, which the Accumulator runs before the learner contributes
                        and self.acc.wants_gradients()):
                    if self.sent:
                        self.acc.skip_gradients()
                    else:
                        self._contribute()
                        busy = True
                if self.acc.has_gradients():
                    self._apply()
                    busy = True
                if not busy:
                    time.sleep(0.0005)
        except BaseException as e:  # moolint: disable=swallow-cancelled -- reported by status(), fails the phase
            self.error = f"{type(e).__name__}: {e}"

    def _contribute(self):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        grads, _ = self.grad_step(self.state.model, self.batch)  # racelint: unguarded -- this thread is the state's only writer but for set_state, which the Accumulator runs before the learner contributes
        ev[1].record()
        t0 = time.perf_counter()
        with _SYNC_MODE_LOCK:
            _no_sync(self.acc.reduce_gradients, grads, LEARN_B)
        self.t_sent = time.perf_counter()
        self.contribs.append(dict(
            events=ev, step=self.state.step, wall=time.time(),
            allreduce_ms=1e3 * (self.t_sent - t0)))
        self.stats["env_steps"] += UNROLL * LEARN_B
        self.sent = True

    def _apply(self):
        from moolib_tpu_torch.ops import stage_batch

        t_result = time.perf_counter()
        mean, count = self.acc.result_gradients()
        if self.first_mean is None:
            self.first_mean = {k: np.array(v) for k, v in mean.items()}
        grads = stage_batch(mean, "cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with self.lock:
            ev[0].record()
            self.state = self.apply_step(self.state, grads)
            ev[1].record()
        version = self.acc.result_model_version()
        self.acc.zero_gradients()
        self.sent = False
        self.applies.append(dict(
            version=version, step=self.state.step, count=count, events=ev,
            t=time.perf_counter(), wall=time.time(), reduce_ms=(
                None if self.t_sent is None
                else 1e3 * (t_result - self.t_sent)),
            checksum=_checksums(self.state.model.parameters())))  # racelint: unguarded -- this thread is the state's only writer but for set_state, which the Accumulator runs before the learner contributes
        self.done_step = self.state.step  # racelint: unguarded -- this thread is the state's only writer but for set_state, which the Accumulator runs before the learner contributes

    def state_checksum(self) -> list:
        """Checksums of the params and the optimizer's nu, read back."""
        with self.lock:
            params = list(self.state.model.parameters())
            nu = [self.state.optimizer.state[p]["nu"] for p in params]
            return _checksums(params + nu).cpu().tolist()

    def status(self) -> dict:
        stats = self.acc.get_gradient_stats()
        return dict(step=self.done_step, version=self.acc.model_version,
                    connected=self.acc.connected(), synced=stats["synced"],
                    leader=self.acc.get_leader(),
                    members=self.group.members, error=self.error,
                    count_rounds=stats["count_rounds"],
                    gradient_rounds=stats["gradient_rounds"],
                    ops=sorted(self.group._active),
                    state_request=self.acc._state_req_inflight)

    def counters(self) -> dict:
        """The cumulative readings that report() subtracts a base of."""
        from moolib_tpu_torch.telemetry import summarize_stepscope

        reg = self.rpc.telemetry.registry
        return dict(
            acc_grad_round=summarize_stepscope(reg.snapshot()).get(
                "acc_grad_round"),
            lanes=_lane_bytes(self.rpc),
            gradient_rounds=int(reg.value("acc_gradient_rounds_total") or 0),
            count_rounds=int(reg.value("acc_count_rounds_total") or 0))

    def report(self) -> dict:
        """What the learner recorded (read once it is idle): per applied
        update its version, count and params' checksums; the medians of
        its grad step, reduce_gradients and apply; the Accumulator's
        acc_grad_round ledger; its group's rounds and its lanes' bytes."""
        torch.cuda.synchronize()
        reg = self.rpc.telemetry.registry
        stats = self.acc.get_gradient_stats()
        return dict(**self.counters(),
            updates=[dict(version=a["version"], step=a["step"],
                          count=a["count"], t=a["t"], wall=a["wall"],
                          reduce_ms=a["reduce_ms"],
                          checksum=a["checksum"].cpu().tolist(),
                          apply_ms=a["events"][0].elapsed_time(
                              a["events"][1]))
                     for a in self.applies],
            contribs=[dict(step=c["step"], allreduce_ms=c["allreduce_ms"],
                           wall=c["wall"],
                           grad_ms=c["events"][0].elapsed_time(
                               c["events"][1]))
                      for c in self.contribs],
            group_rounds_total=reg.value("group_rounds_total",
                                         group=self.group.group_name),
            chunked_rounds=stats["chunked_gradient_rounds"],
            negotiated_chunk=stats["negotiated_chunk_bytes"],
            leader=stats["leader"], env_steps=self.stats["env_steps"].result(),
            params=sum(p.numel() for p in self.state.model.parameters()))

    def close(self):
        self.stop.set()
        self.thread.join(timeout=30)  # lifelint: intentional -- a second join of a finished thread returns at once
        self.acc.close()
        self.group.close()
        self.rpc.close()


def acc_child(broker_addr: str, ctl_name: str = "acc-child") -> int:
    """The second process of the accumulate phase (``chip_smoke.py
    --acc-child BROKER``), and each learner process of phase 13
    (``--acc-child BROKER CTL_NAME``): learners created, driven and read
    by the parent through one control endpoint, ``chip_acc(op, ...)`` on
    the peer ``ctl_name``: the process's kernel launch counts (``reset``,
    ``kernels``), ``learner`` (a new _Learner), ``durable`` (a new
    _DurableLearner), ``replicator`` (attach its Replicator),
    ``durable_report``, ``addr`` (the learners' listen addresses),
    ``target``, ``status``, ``state_checksum``, ``stats`` (start each
    learner's global stats round), ``stats_result``, ``report`` and
    ``close``. Prints its address, then serves until its stdin closes.
    Its chunk size is its environment's MOOLIB_TPU_ALLREDUCE_CHUNK."""
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.rpc import Rpc

    if not torch.cuda.is_available():
        raise RuntimeError("the accumulate phase's learners need the card")
    torch.backends.cudnn.deterministic = True
    _log_accumulators()
    learners = {}

    def control(op, *args):
        if op == "reset":
            for kern in KERNELS:
                kern.launches = 0
            return None
        if op == "kernels":
            return {kern.name: kern.launches for kern in KERNELS}
        if op == "learner":
            name, rank, group, kind, seed = args
            learners[name] = _Learner(name, rank, broker_addr, group, kind,
                                      seed)
            return True
        if op == "durable":
            name, rank, group, seed, root, restore_from = args
            learners[name] = _DurableLearner(name, rank, broker_addr, group,
                                             seed, root, restore_from)
            return learners[name].restored
        if op == "replicator":
            learners[args[0]].replicate()
            return True
        if op == "durable_report":
            return {n: lr.durable_report() for n, lr in learners.items()}
        if op == "addr":
            return {n: lr.rpc.debug_info()["listen"][0]
                    for n, lr in learners.items()}
        if op == "target":
            learners[args[0]].target = int(args[1])
            return True
        if op == "status":
            return {n: lr.status() for n, lr in learners.items()}
        if op == "stacks":
            return _thread_stacks()
        if op == "state_checksum":
            return learners[args[0]].state_checksum()
        if op == "stats":
            return {n: lr.gsa.enqueue_global_stats()
                    for n, lr in learners.items()}
        if op == "stats_result":
            return {n: dict(busy=lr.gsa.busy,
                            local=lr.stats["env_steps"].result(),
                            global_=lr.gsa.global_stats.results())
                    for n, lr in learners.items()}
        if op == "report":
            return {n: lr.report() for n, lr in learners.items()}
        if op == "close":
            for lr in learners.values():
                lr.close()
            learners.clear()
            return True
        raise ValueError(f"unknown op {op!r}")

    ctl = Rpc(ctl_name)
    ctl.set_timeout(ACC_BUDGET_S)
    ctl.listen("127.0.0.1:0")
    ctl.define("chip_acc", control)
    print(json.dumps({"addr": ctl.debug_info()["listen"][0]}), flush=True)
    sys.stdin.read()  # until the parent closes the pipe (or exits)
    for lr in learners.values():
        lr.close()
    ctl.close()
    return 0


@contextlib.contextmanager
def _counting_split_reduces(calls: list):
    """Record this process's allreduces that the Group splits into chunk
    sub-ops (the name and chunk floor of each): a measuring instrument,
    since neither package counts them."""
    from moolib_tpu_torch.rpc.group import Group

    split = Group._all_reduce_chunked

    def counted(self, name, data, leaves, op_fn, floor):
        calls.append((name, floor))
        return split(self, name, data, leaves, op_fn, floor)

    Group._all_reduce_chunked = counted
    try:
        yield
    finally:
        Group._all_reduce_chunked = split


def _until(cond, what: str, describe=None, timeout: float = ACC_BUDGET_S,
           poll=0.01):
    t_end = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > t_end:
            raise RuntimeError(f"accumulate phase: {what} not reached "
                               f"within {timeout} s"
                               + (f"; {describe()}" if describe else ""))
        time.sleep(poll)


def _thread_stacks() -> str:
    """Every thread's stack in this process (a stalled run's evidence)."""
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    return "\n".join(
        f"--- thread {names.get(ident, ident)}\n"
        + "".join(traceback.format_stack(frame))
        for ident, frame in sys._current_frames().items())


def _log_accumulators() -> None:
    """The accumulators' elections, state syncs and failed rounds on
    stderr (their info and debug lines)."""
    import logging

    from moolib_tpu_torch.utils import get_logger

    acc_log = get_logger("accumulator")
    if not acc_log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(process)d %(name)s: %(message)s"))
        acc_log.addHandler(handler)
        acc_log.setLevel(logging.DEBUG)


class _AccRun:
    """The processes of the accumulate phase's runs: a fresh Broker and
    each run's learner-0 here, the other learners in a child process
    (this script with --acc-child) with ``env`` added to its
    environment."""

    def __init__(self, env=None):
        from moolib_tpu_torch.rpc import Rpc
        from moolib_tpu_torch.rpc.broker import Broker

        self.broker_rpc = Rpc("broker")
        self.broker_rpc.listen("127.0.0.1:0")
        self.addr = self.broker_rpc.debug_info()["listen"][0]
        self.broker = Broker(self.broker_rpc)
        self.stop = threading.Event()
        self.pump = threading.Thread(target=self._pump, daemon=True)  # lifelint: intentional -- close() stops and joins it; the run lives for one phase
        self.pump.start()
        here = os.path.dirname(os.path.abspath(__file__))
        self.child = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             ACC_CHILD_FLAG, self.addr], cwd=here, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True,
            env={**os.environ, **(env or {})})
        self.client = None
        self.learners = []
        try:
            addr = _child_addresses(self.child)["addr"]
            self.client = Rpc("acc-client")
            self.client.set_timeout(ACC_BUDGET_S)
            self.client.connect(addr)
        except BaseException:
            self.close()
            raise

    def _pump(self):
        while not self.stop.is_set():
            self.broker.update()
            time.sleep(0.02)

    def dump(self) -> str:
        """Every learner's status and both processes' thread stacks."""
        here = _thread_stacks()
        try:
            there = self.ctl("stacks")
        except Exception as e:  # moolint: disable=swallow-cancelled -- the evidence is best effort; no event loop in this thread
            there = f"(the child's stacks: {type(e).__name__}: {e})"
        print(f"=== status {self.status()}\n=== stacks here\n{here}\n"
              f"=== stacks in the child\n{there}", file=sys.stderr,
              flush=True)
        return "status and stacks on stderr"

    def ctl(self, op, *args):
        return self.client.async_("acc-child", "chip_acc", op, *args).result(
            timeout=ACC_BUDGET_S)

    def learner(self, *args, **kw) -> "_Learner":
        lr = _Learner(*args, **kw)
        self.learners.append(lr)
        return lr

    def status(self) -> dict:
        st = {lr.name: lr.status() for lr in self.learners}
        st.update(self.ctl("status"))
        bad = {n: s["error"] for n, s in st.items() if s["error"]}
        if bad:
            raise RuntimeError(f"accumulate phase: learner failed: {bad}")
        return st

    def train_to(self, target: int, names) -> float:
        """Every learner trains until its params reach version ``target``;
        returns the seconds it took."""
        t0 = time.perf_counter()
        for lr in self.learners:
            lr.target = target
        for name in names:
            self.ctl("target", name, target)
        _until(lambda: all(s["step"] >= target
                           for s in self.status().values()),
               f"version {target} on every learner", self.dump)
        return time.perf_counter() - t0

    def reports(self) -> dict:
        out = {lr.name: lr.report() for lr in self.learners}
        out.update(self.ctl("report"))
        return out

    def close_learners(self):
        """Close every learner, here and in the child."""
        try:
            for lr in self.learners:
                lr.close()
        finally:
            self.learners = []
            self.ctl("close")

    def close(self):
        try:
            if self.client is not None:
                try:
                    self.close_learners()
                finally:
                    self.client.close()
        finally:
            self.child.stdin.close()
            try:
                code = self.child.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.child.kill()  # lifelint: intentional -- killing an exited child is a no-op
                self.child.wait(timeout=30)
                raise RuntimeError("the accumulate child did not exit") \
                    from None
            finally:
                self.stop.set()
                self.pump.join(timeout=5)
                self.broker_rpc.close()
        if code != 0:
            raise RuntimeError(f"the accumulate child exited with {code}")


def _check_versions(reps: dict, tag: str) -> dict:
    """Every learner's params hold the same bits at every version that
    more than one learner applied; returns {version: checksum rows}."""
    by_version = {}
    for name, rep in reps.items():
        for u in rep["updates"]:
            by_version.setdefault(u["version"], {})[name] = u["checksum"]
    for v, rows in sorted(by_version.items()):
        if len({json.dumps(r) for r in rows.values()}) != 1:
            raise RuntimeError(f"{tag}: the learners' params differ after "
                               f"update {v} ({sorted(rows)})")
    return {v: next(iter(rows.values())) for v, rows in by_version.items()}


def _acc_readings(tag: str, rep: dict, since: int, seconds: float,
                  base=None) -> dict:
    """The [acc] line of one learner's report, over the updates past
    version ``since``; ``base``, the same learner's counters() taken
    earlier, is subtracted from the cumulative readings."""
    def minus(a, b):
        return a - (b or 0)

    updates = [u for u in rep["updates"] if u["version"] > since]
    contribs = [c for c in rep["contribs"] if c["step"] >= since]
    rounds = rep["acc_grad_round"] or {"steps": 0, "wall_s": 0.0,
                                       "phases": {}}
    b_rounds = (base or {}).get("acc_grad_round") or {
        "steps": 0, "wall_s": 0.0, "phases": {}}
    n = max(rounds["steps"] - b_rounds["steps"], 1)
    per_round = {ph: 1e3 * minus(v, b_rounds["phases"].get(ph)) / n
                 for ph, v in rounds["phases"].items()}
    grad_rounds = max(minus(rep["gradient_rounds"],
                            (base or {}).get("gradient_rounds")), 1)
    count_rounds = minus(rep["count_rounds"], (base or {}).get("count_rounds"))
    lane_mb = {t: minus(b, (base or {}).get("lanes", {}).get(t)) / 1e6
               / grad_rounds for t, b in rep["lanes"].items()}
    ts = [u["t"] for u in updates]
    reduce_ms = [u["reduce_ms"] for u in updates
                 if u["reduce_ms"] is not None]
    steady = (len(ts) - 1) / (ts[-1] - ts[0]) if len(ts) > 1 else 0.0
    out = dict(updates=len(updates), seconds=seconds,
               updates_per_s=len(updates) / seconds,
               steady_updates_per_s=steady,
               reduce_ms=float(np.median(reduce_ms)) if reduce_ms else None,
               reduce_share=(float(np.median(reduce_ms)) * steady / 1e3
                             if reduce_ms and steady else None),
               grad_ms=float(np.median([c["grad_ms"] for c in contribs])),
               allreduce_ms=float(np.median([c["allreduce_ms"]
                                             for c in contribs])),
               apply_ms=float(np.median([u["apply_ms"] for u in updates])),
               acc_grad_round_ms=1e3 * minus(rounds["wall_s"],
                                             b_rounds["wall_s"]) / n,
               acc_grad_round_phases_ms=per_round,
               wire_mb_per_grad_round=lane_mb, leader=rep["leader"],
               group_rounds_total=rep["group_rounds_total"],
               gradient_rounds=grad_rounds, count_rounds=count_rounds,
               chunked_rounds=rep["chunked_rounds"],
               negotiated_chunk=rep["negotiated_chunk"],
               counts=[u["count"] for u in updates], params=rep["params"])
    log(f"[acc] {tag}: {out['updates']} updates in {seconds:.3f} s "
        f"({out['updates_per_s']:.3f} updates/s; from the first to the "
        f"last apply {out['steady_updates_per_s']:.3f}) | per update, "
        f"medians: the reduce (reduce_gradients' return to the result) "
        f"{out['reduce_ms']} ms, share of an update {out['reduce_share']};"
        f" grad step {out['grad_ms']:.3f} ms (CUDA events), "
        f"grad_allreduce (reduce_gradients, host) "
        f"{out['allreduce_ms']:.3f} ms, acc_grad_round "
        f"{out['acc_grad_round_ms']:.3f} ms a round ("
        + ", ".join(f"{ph} {v:.3f}" for ph, v in sorted(per_round.items()))
        + f"), apply {out['apply_ms']:.3f} ms (CUDA events) | wire MB per "
        f"gradient round by lane "
        f"{ {t: round(v, 3) for t, v in lane_mb.items()} } | leader "
        f"{rep['leader']} | group_rounds_total {rep['group_rounds_total']} |"
        f" count rounds {count_rounds} "
        f"({count_rounds / max(len(updates), 1):.1f} an update) | gradient "
        f"rounds {grad_rounds} "
        f"(chunked wire format in the run "
        f"{rep['chunked_rounds']}, negotiated chunk "
        f"{rep['negotiated_chunk']}), counts {out['counts']} | "
        f"{rep['params']} parameters")
    return out


def _cpu_mean_ref(state_dict, ranks) -> dict:
    """The first update's mean on the CPU: the same peers' grad steps
    (grad_scale 32, their own learn batches) on the same params with
    dense attention, summed and divided by the virtual batch."""
    from moolib_tpu_torch import ImpalaConfig, TransformerNet, make_grad_step

    cpu = TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                         attention_backend="dense", device="cpu")
    cpu.load_state_dict(state_dict)
    cfg = ImpalaConfig(discounting=0.99, baseline_cost=0.5,
                       entropy_cost=0.0006, reward_clip=1.0)
    step = make_grad_step(config=cfg, grad_scale=float(LEARN_B))
    total = None
    for r in ranks:
        batch = _learn_batches(torch.Generator(
            device="cuda").manual_seed(100 + r), 1)[0]
        g, _ = step(cpu, _to_cpu(batch))
        total = g if total is None else {n: total[n] + g[n] for n in g}
    return {n: (v / ACC_VBS).numpy() for n, v in total.items()}


def _transformer_run(run: "_AccRun", chunked: bool) -> dict:
    """Two learners (learner-0 here, learner-1 in the child) train the
    full-width TransformerNet ACC_UPDATES updates; in the unchunked run a
    third, learner-2 (the child, another seed), then joins, takes the
    leader's state, and the three train ACC_JOIN_UPDATES more; global
    stats close the run."""
    from moolib_tpu_torch.ops._kernels import FLASH_BWD_TILE, FLASH_FWD, KERNELS

    tag = "chunked" if chunked else "whole"
    out = {}
    try:
        group = f"acc-{tag}"
        for kern in KERNELS:
            kern.launches = 0
        run.ctl("reset")
        l0 = run.learner("learner-0", 0, run.addr, group, "transformer",
                         chunk_bytes=ACC_CHUNK if chunked else None)
        run.ctl("learner", "learner-1", 1, group, "transformer", 0)
        _until(lambda: all(s["connected"] and s["synced"]
                           for s in run.status().values()),
               "two connected learners")
        initial = _checksums(l0.state.model.parameters()).cpu().tolist()
        ref = None if chunked else _cpu_mean_ref(
            {k: v.cpu() for k, v in l0.state.model.state_dict().items()},
            (0, 1))
        splits = []
        start, before = time.time(), l0.counters()
        with _counting_split_reduces(splits):
            seconds = run.train_to(ACC_UPDATES, ["learner-1"])
        grads_split = [f for n, f in splits if n.startswith("acc.grads.")]
        log(f"[acc] transformer {tag}: learner-0's gradient reduces split "
            f"into chunk sub-ops: {len(grads_split)} of {ACC_UPDATES} "
            f"(chunk floor {sorted(set(grads_split))})")
        if len(grads_split) != (ACC_UPDATES if chunked else 0) or any(
                f != ACC_CHUNK for f in grads_split):
            raise RuntimeError(f"transformer {tag}: split reduces {splits}")
        out["split_reduces"] = len(grads_split)
        if not chunked:
            got = l0.first_mean
            errs = {n: float(np.abs(got[n] - ref[n]).max())
                    / float(np.abs(ref[n]).max()) for n in ref}
            worst = max((n for n in errs if n not in BF16_GRAD_TOL),
                        key=errs.get)
            log(f"[acc] update 1's mean gradient vs the CPU's (dense "
                f"attention, the same two learn batches): max relative "
                f"error {errs[worst]:.3e} at {worst} (tol {TRAIN_GRAD_TOL})"
                "; " + " ".join(f"{n} {errs[n]:.3e} (tol {t:.3e})"
                                for n, t in BF16_GRAD_TOL.items()))
            bad = [n for n, e in errs.items()
                   if not e <= BF16_GRAD_TOL.get(n, TRAIN_GRAD_TOL)]
            if bad:
                raise RuntimeError(f"update 1's mean gradient differs from "
                                   f"the CPU's at {bad}")
            out["mean_grad_err"] = errs[worst]
        two = run.reports()
        log(f"[acc] transformer {tag}: seconds from the targets to each "
            f"learner's first contribution "
            f"{ {n: round(r['contribs'][0]['wall'] - start, 3) for n, r in two.items()} }"
            f", to its first apply "
            f"{ {n: round(r['updates'][0]['wall'] - start, 3) for n, r in two.items()} }")
        versions = _check_versions(two, f"transformer {tag}")
        if sorted(versions) != list(range(1, ACC_UPDATES + 1)) or any(
                u["count"] != ACC_VBS for rep in two.values()
                for u in rep["updates"]):
            raise RuntimeError(f"transformer {tag}: updates "
                               f"{sorted(versions)}, counts "
                               f"{[u['count'] for u in two['learner-0']['updates']]}")
        out["versions"] = {0: initial, **versions}
        out["two"] = _acc_readings(f"transformer {tag}, 2 learners",
                                   two["learner-0"], 0, seconds, before)
        if chunked:
            neg = {n: r["negotiated_chunk"] for n, r in two.items()}
            if set(neg.values()) != {ACC_CHUNK}:
                raise RuntimeError(f"the chunked run negotiated {neg}")
        else:
            # The joiner: another seed, so only the leader's state can
            # make it equal.
            run.ctl("learner", "learner-2", 2, group, "transformer", 7)
            _until(lambda: (lambda st: len(st) == 3 and all(
                s["connected"] and s["synced"] and len(s["members"]) == 3
                for s in st.values()))(run.status()), "the joiner's sync",
                run.dump, timeout=120.0)
            st = run.status()
            leader = st["learner-2"]["leader"]
            want = (l0.state_checksum() if leader == "learner-0"
                    else run.ctl("state_checksum", leader))
            got = run.ctl("state_checksum", "learner-2")
            log(f"[acc] learner-2 joined at version "
                f"{st['learner-2']['step']}; leader {leader}; its params "
                f"and nu equal the leader's: {got == want}")
            if got != want or st["learner-2"]["step"] != ACC_UPDATES:
                raise RuntimeError("the joiner's state differs from the "
                                   "leader's")
            target = ACC_UPDATES + ACC_JOIN_UPDATES
            seconds3 = run.train_to(target, ["learner-1", "learner-2"])
            three = run.reports()
            _check_versions(three, "transformer, 3 learners")
            out["three"] = _acc_readings(
                "transformer whole, 3 learners", three["learner-0"],
                ACC_UPDATES, seconds3, base=two["learner-0"])
            out["leader"] = leader
            # Global stats: every learner's env_steps, summed exactly.
            started = [l0.gsa.enqueue_global_stats(),
                       *run.ctl("stats").values()]
            if not all(started):
                raise RuntimeError("a global stats round did not start")
            _until(lambda: not l0.gsa.busy and not any(
                s["busy"] for s in run.ctl("stats_result").values()),
                "the global stats round")
            res = run.ctl("stats_result")
            local = l0.stats["env_steps"].result() + sum(
                s["local"] for s in res.values())
            seen = [l0.gsa.global_stats.results()["env_steps"]] + [
                s["global_"]["env_steps"] for s in res.values()]
            log(f"[acc] GlobalStatsAccumulator env_steps on each learner "
                f"{seen}; the learners' own sum {local}")
            if any(v != local for v in seen):
                raise RuntimeError(f"global env_steps {seen} != {local}")
            out["env_steps"] = local
        here = {kern.name: kern.launches for kern in KERNELS}
        there = run.ctl("kernels")
        out["launches"] = {k: here[k] + there[k] for k in here}
        log(f"[acc] transformer {tag}: launches here {here}, in the child "
            f"{there}")
        for counts in (here, there):
            if not (counts[FLASH_FWD.name] and counts[FLASH_BWD_TILE.name]):
                raise RuntimeError(f"transformer {tag}: a process launched "
                                   f"no flash_fwd or flash_bwd_tile: {counts}")
    finally:
        run.close_learners()
    return out


def _impala_run(run: "_AccRun") -> dict:
    """Two learners of the full-width f32 ImpalaNet, ACC_IMPALA_UPDATES
    updates, under the same checks; no flash kernel may launch."""
    from moolib_tpu_torch.ops._kernels import KERNELS

    try:
        for kern in KERNELS:
            kern.launches = 0
        run.ctl("reset")
        i0 = run.learner("impala-0", 0, run.addr, "acc-impala", "impala",
                         chunk_bytes=ACC_CHUNK)
        run.ctl("learner", "impala-1", 1, "acc-impala", "impala", 0)
        _until(lambda: all(s["connected"] and s["synced"]
                           for s in run.status().values()),
               "two connected impala learners")
        splits, before = [], i0.counters()
        with _counting_split_reduces(splits):
            seconds = run.train_to(ACC_IMPALA_UPDATES, ["impala-1"])
        log(f"[acc] impala: learner impala-0's gradient reduces split into "
            f"chunk sub-ops: "
            f"{sum(n.startswith('acc.grads.') for n, _ in splits)} of "
            f"{ACC_IMPALA_UPDATES}")
        reps = run.reports()
        _check_versions(reps, "impala")
        out = _acc_readings("impala f32, 2 learners", reps["impala-0"], 0,
                            seconds, before)
        launches = [{k.name: k.launches for k in KERNELS}, run.ctl("kernels")]
        if any(any(c.values()) for c in launches):
            raise RuntimeError(f"the impala learners launched a flash "
                               f"kernel: {launches}")
    finally:
        run.close_learners()
    return out


def _bench_allreduce() -> list:
    """bench_allreduce_torch.py (4 peers, the reference's sizes) in a
    process of its own, with a time limit: its three dcn_rpc_tree rows,
    then its psum plane's (on one card, the single-device note)."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    # A session of its own, so that a timeout also stops its workers.
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "bench_allreduce_torch.py"),
         "--peers", "4"], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=ACC_BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"bench_allreduce_torch.py did not finish in "
                           f"{ACC_BENCH_TIMEOUT_S} s") from None
    if proc.returncode != 0:
        raise RuntimeError(f"bench_allreduce_torch.py exited with "
                           f"{proc.returncode}: {stderr[-2000:]}")
    rows = [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]
    for row in rows:
        log(f"[acc] bench_allreduce_torch: {json.dumps(row)}")
    tree = [r for r in rows if r.get("plane") == "dcn_rpc_tree"]
    psum = [r for r in rows if r.get("plane") == "nccl_psum"]
    cards = torch.cuda.device_count()
    if (len(tree) != 3 or len(tree) + len(psum) != len(rows)
            or len(psum) != (1 if cards < 2 else 3)
            or (cards < 2 and "note" not in psum[0])):
        raise RuntimeError(f"bench_allreduce_torch.py printed {rows}")
    return rows


def phase_acc() -> dict:
    """Phase 9: the elastic gradient plane on the card (see the module
    docstring)."""
    _log_accumulators()
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        run = _AccRun()
        try:
            whole = _transformer_run(run, chunked=False)
        finally:
            run.close()
        run = _AccRun({"MOOLIB_TPU_ALLREDUCE_CHUNK": str(ACC_CHUNK)})
        try:
            chunked = _transformer_run(run, chunked=True)
            same = [v for v in range(ACC_UPDATES + 1)
                    if whole["versions"][v] == chunked["versions"][v]]
            log(f"[acc] the chunked run's params equal the whole run's at "
                f"versions {same} of 0-{ACC_UPDATES}")
            if len(same) != ACC_UPDATES + 1:
                raise RuntimeError("the chunked run's params differ from "
                                   "the whole run's")
            impala = _impala_run(run)
        finally:
            run.close()
    finally:
        torch.backends.cudnn.deterministic = prev
    bench = _bench_allreduce()
    launches = {k: whole["launches"][k] + chunked["launches"][k]
                for k in whole["launches"]}
    for result in (whole, chunked):
        result.pop("versions")
        result.pop("launches")
    return dict(whole=whole, chunked=chunked, impala=impala, bench=bench,
                launches={"acc": launches})


# The e2e phase: the acting plane and the experiment loop on the card.
E2E_ENVS, E2E_WORKERS = 32, 2   # the data path's pool: 2 workers x 16 envs
# The data path's episode length: odd, so that the resets fall in both
# buffers (the two buffers step the same envs in turn).
E2E_EPISODE = 7
# The loops of phases 11 and 12 are short enough to pay for phase 15b's
# seconds inside the script's time limit.
E2E_SECONDS = 10.0   # the transformer loop's run
E2E_RESUME_SECONDS = 4.0
E2E_PLAIN_SECONDS = 6.0  # the same loop without a savedir, profiled
E2E_PROFILE_DIR = os.path.join("build", "e2e_profile")
# Short: the whole script must stay well inside its 1200 s limit as it
# grows, and the rate needs no longer window.
E2E_BENCH_SECONDS = 8.0
E2E_BENCH_TIMEOUT_S = 300.0
E2E_SAVEDIR = os.path.join("build", "e2e")
# A uniform policy's episode return on the synthetic env: 200 steps, one
# rewarded action in 6.
E2E_UNIFORM_RETURN = 200 / 6


def _e2e_actions(b: int, j: int) -> np.ndarray:
    """The data path's action script: buffer ``b``'s ``j``-th step."""
    return (7 * j + 3 * np.arange(E2E_ENVS) + b) % 6


def _e2e_logits(b: int, j: int) -> np.ndarray:
    """The behaviour logits recorded with ``_e2e_actions(b, j)``."""
    return np.random.default_rng(1000 * b + j).standard_normal(
        (E2E_ENVS, 6)).astype(np.float32)


def _e2e_env_fn():
    import functools

    from moolib_tpu_torch.examples.envs import create_synthetic_atari

    return functools.partial(create_synthetic_atari, num_actions=6,
                             episode_length=E2E_EPISODE)


def _plain_frames(n: int) -> dict:
    """The same envs stepped in this process by a plain loop, in the
    pool's dispatch order (buffer 0's step j, then buffer 1's): per
    buffer, the n step results with the worker's auto-reset and episode
    stats."""
    env_fn = _e2e_env_fn()
    envs = [env_fn(i) for i in range(E2E_ENVS)]
    for env in envs:
        env.reset()
    ep_step = np.zeros(E2E_ENVS, np.int64)
    ep_ret = np.zeros(E2E_ENVS, np.float64)
    frames = {0: [], 1: []}
    for j in range(n):
        for b in (0, 1):
            obs, rew, done, steps, rets = [], [], [], [], []
            for i, (env, a) in enumerate(zip(envs, _e2e_actions(b, j))):
                o, r, term, trunc, _ = env.step(int(a))
                d = bool(term or trunc)
                ep_step[i] += 1
                ep_ret[i] += float(r)
                if d:
                    o, _ = env.reset()
                obs.append(o)
                rew.append(r)
                done.append(d)
                steps.append(ep_step[i])
                rets.append(ep_ret[i])
                if d:
                    ep_step[i], ep_ret[i] = 0, 0.0
            frames[b].append(dict(
                obs=np.stack(obs), reward=np.array(rew, np.float32),
                done=np.array(done), episode_step=np.array(steps, np.int64),
                episode_return=np.array(rets, np.float64)))
    return frames


def _plain_unroll(frames, b: int) -> dict:
    """Buffer ``b``'s first learn unroll, built from the plain frames."""
    f = frames[b][:UNROLL + 1]
    return {
        "obs": np.stack([x["obs"] for x in f]),
        "done": np.stack([x["done"] for x in f]),
        "rewards": np.stack([x["reward"] for x in f]),
        "actions": np.stack([_e2e_actions(b, j + 1)
                             for j in range(UNROLL)]).astype(np.int32),
        "behavior_logits": np.stack([_e2e_logits(b, j + 1)
                                     for j in range(UNROLL)]),
        "core_state": (),
    }


def _same_bits(got, want, what: str) -> None:
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, tuple):
            if g != w:
                raise RuntimeError(f"{what}: {k} is {g!r}, want {w!r}")
            continue
        g = g.cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(
                g.view(np.uint8), w.view(np.uint8)):
            raise RuntimeError(f"{what}: {k} differs ({g.dtype} {g.shape} "
                               f"vs {w.dtype} {w.shape})")


def _e2e_data_path() -> dict:
    """(a) EnvPool -> two EnvBatchStates -> the learn Batcher, against
    the plain loop bit for bit; the batch's grad step on the card against
    the CPU's; a device="cuda" pool's staged step against the host."""
    from moolib_tpu_torch import (Batcher, EnvPool, ImpalaConfig,
                                  make_grad_step, stage_batch)
    from moolib_tpu_torch.examples.common import EnvBatchState

    t0 = time.perf_counter()
    frames = _plain_frames(UNROLL + 1)
    want = [_plain_unroll(frames, b) for b in (0, 1)]
    with EnvPool(_e2e_env_fn(), num_processes=E2E_WORKERS,
                 batch_size=E2E_ENVS, num_batches=2) as pool:
        states = [EnvBatchState(UNROLL, ()) for _ in (0, 1)]
        batcher = Batcher(LEARN_B, dim=1, dims={"core_state": 0})
        futs = [pool.step(b, _e2e_actions(b, 0)) for b in (0, 1)]
        for j in range(UNROLL + 1):
            for b in (0, 1):
                # A worker death raises here: the smoke retries nothing.
                unroll = states[b].observe(futs[b].result(timeout=60))
                if unroll is not None:
                    batcher.cat(unroll)
                if j < UNROLL:
                    states[b].record_action(_e2e_actions(b, j + 1),
                                            _e2e_logits(b, j + 1))
                    futs[b] = pool.step(b, _e2e_actions(b, j + 1))
        got = [batcher.get(timeout=10) for _ in (0, 1)]
        batcher.close()
    for b in (0, 1):
        _same_bits(got[b], want[b], f"learn batch {b}")
    resets = [int(w["done"].sum()) for w in want]
    if not all(resets):
        raise RuntimeError(f"the data path's batches hold {resets} resets")
    log(f"[e2e] data path: EnvPool {E2E_WORKERS} workers x "
        f"{E2E_ENVS // E2E_WORKERS} SyntheticAtari envs (episodes of "
        f"{E2E_EPISODE} steps), 2 EnvBatchStates, Batcher({LEARN_B}, "
        f"dim=1): learn batches obs {want[0]['obs'].shape} equal the plain "
        f"loop's bit for bit on every key ({resets} resets); "
        f"{time.perf_counter() - t0:.1f} s")

    # The first learn batch's grad step on the card vs the CPU's.
    cfg = ImpalaConfig(discounting=0.99, baseline_cost=0.5,
                       entropy_cost=0.0006, reward_clip=1.0)
    net = _serve_net(3).train()
    cpu = _dense_copy(net.state_dict()).train()
    g_card, m_card = make_grad_step(config=cfg)(net, stage_batch(got[0],
                                                                 "cuda"))
    g_cpu, m_cpu = make_grad_step(config=cfg)(cpu, stage_batch(got[0],
                                                               "cpu"))
    errs = {n: float((g_card[n].cpu() - g_cpu[n]).abs().max())
            / max(float(g_cpu[n].abs().max()), 1e-30) for n in g_cpu}
    worst = max((n for n in errs if n not in BF16_GRAD_TOL), key=errs.get)
    merrs = {k: abs(float(m_card[k]) - float(m_cpu[k]))
             / max(abs(float(m_cpu[k])), 1e-30) for k in METRICS}
    log(f"[e2e] grad step on the loop's batch, card vs CPU: gradients max "
        f"relative error {errs[worst]:.3e} at {worst} (tol "
        f"{TRAIN_GRAD_TOL}); metrics max relative error "
        f"{max(merrs.values()):.3e} (tol {TRAIN_METRIC_TOL})")
    bad = [n for n, e in errs.items()
           if not e <= BF16_GRAD_TOL.get(n, TRAIN_GRAD_TOL)]
    if bad or not max(merrs.values()) <= TRAIN_METRIC_TOL:
        raise RuntimeError(f"the grad step on the loop's batch differs "
                           f"from the CPU's: gradients {bad}, metrics "
                           f"{merrs}")

    # A pool that stages to the card: its first step equals the host's.
    with EnvPool(_e2e_env_fn(), num_processes=E2E_WORKERS,
                 batch_size=E2E_ENVS, device="cuda") as pool:
        out = pool.step(0, _e2e_actions(0, 0)).result(timeout=60)
        torch.cuda.synchronize()
    if any(v.device.type != "cuda" for v in out.values()):
        raise RuntimeError("EnvPool(device='cuda') returned host tensors")
    _same_bits(out, frames[0][0], "EnvPool(device='cuda') step")
    log(f"[e2e] EnvPool(device='cuda'): a staged step equals the host's "
        f"bit for bit ({sorted(out)})")
    return dict(grad_err=errs[worst], metric_err=max(merrs.values()),
                resets=resets)


class _KeptStats:
    """Stand-in for the experiment's ``Stats`` that keeps each instance,
    so the smoke can read the loop's dropped-unroll count, which its
    logged rows do not carry."""

    made: list = []

    def __new__(cls, **stats):
        from moolib_tpu_torch.utils import Stats

        inst = Stats(**stats)
        if "dropped_unrolls" in stats:  # the cumulative one, not the window
            cls.made.append(inst)
        return inst


def _recording_scope_class():
    """A StepScope that also keeps every step's ledger (wall, phases),
    for the per-phase medians of the loop's run."""
    from moolib_tpu_torch.telemetry import StepScope

    class RecordingScope(StepScope):
        made: list = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.ledgers = []
            RecordingScope.made.append(self)

        def _finish_step(self, wall, ledger, ts_us):
            super()._finish_step(wall, ledger, ts_us)
            self.ledgers.append((wall, dict(ledger)))

    return RecordingScope


def _median_ledger(scope) -> dict:
    """Median ms per phase (``other`` the step's unattributed rest) over
    the scope's recorded steps, the median step, and the host-blocked
    share of the whole run."""
    rows = []
    for wall, led in scope.ledgers:
        row = {k: 1e3 * v for k, v in led.items()}
        row["other"] = 1e3 * max(wall - sum(led.values()), 0.0)
        row["wall"] = 1e3 * wall
        rows.append(row)
    names = sorted({k for r in rows for k in r} - {"other", "wall"})
    summary = scope.summary()
    return dict(
        steps=len(rows),
        median_ms={k: float(np.median([r.get(k, 0.0) for r in rows]))
                   for k in names + ["other", "wall"]},
        total_s=summary["phases"], wall_s=summary["wall_s"],
        host_blocked=summary["fractions"]["host_blocked"])


def _log_e2e_ledger(tag: str, led: dict) -> None:
    """Median and mean ms a loop step per phase (a phase that runs once an
    update, as fwd_bwd does, has a median of 0 and shows in the mean)."""
    m, n = led["median_ms"], led["steps"]
    log(f"[e2e] {tag} vtrace_learner ledger: {n} steps, median ms "
        + ", ".join(f"{k} {m[k]:.3f}" for k in m if k != "wall")
        + f" | step {m['wall']:.3f} | mean ms "
        + ", ".join(f"{k} {1e3 * v / n:.3f}"
                    for k, v in led["total_s"].items())
        + f" | step {1e3 * led['wall_s'] / n:.3f} | host-blocked share "
        f"{led['host_blocked']:.3f}")


def _rates(rows) -> dict:
    """Env steps and updates a second from the first logged row to the
    last (the warm-up before the first row excluded), as bench_e2e.py
    counts them."""
    span = rows[-1]["time"] - rows[0]["time"]
    return dict(
        env_steps_per_s=(rows[-1]["env_steps"] - rows[0]["env_steps"]) / span,
        updates_per_s=(rows[-1]["updates"] - rows[0]["updates"]) / span)


def _trace_summary(path: str) -> dict:
    """The profiled window of a train() run (its Chrome trace): the span
    from the first recorded event to the last, the device's busy time (the
    union of its kernels' intervals) and idle share, and the host's
    heaviest CUDA runtime calls and operators by total time (operators
    inclusive of those they call)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    busy, end = 0.0, float("-inf")
    for a, b in kernels:
        if b > end:
            busy += b - max(a, end)
            end = b
    t0 = min(e["ts"] for e in events)
    span = max(e["ts"] + e["dur"] for e in events) - t0

    def top(cat, n):
        tot = {}
        for e in events:
            if e.get("cat") == cat:
                tot[e["name"]] = tot.get(e["name"], 0.0) + e["dur"]
        return {k: v / 1e3 for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]}

    return dict(window_ms=span / 1e3, device_busy_ms=busy / 1e3,
                device_idle_share=1.0 - busy / span,
                kernels=len(kernels), runtime_ms=top("cuda_runtime", 6),
                ops_ms=top("cpu_op", 8))


def _e2e_transformer() -> dict:
    """(b) train() of experiment.py with model=transformer on the card for
    E2E_SECONDS, then a resume of E2E_RESUME_SECONDS from its checkpoint."""
    from bench_e2e_torch import _worker_deaths
    from moolib_tpu_torch.examples.vtrace import experiment
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.telemetry import global_telemetry

    shutil.rmtree(E2E_SAVEDIR, ignore_errors=True)
    scope_cls = _recording_scope_class()
    saved = experiment.StepScope, experiment.Stats
    experiment.StepScope, experiment.Stats = scope_cls, _KeptStats
    for kern in KERNELS:
        kern.launches = 0
    lines = []
    try:
        cfg = experiment.VtraceConfig(
            env="synthetic", model="transformer", seed=0,
            max_seconds=E2E_SECONDS, log_interval_steps=2000,
            savedir=E2E_SAVEDIR, checkpoint_interval=0.0,
            stats_interval=2.0)
        t0 = time.perf_counter()
        rows = experiment.train(cfg, log_fn=lines.append)
        wall = time.perf_counter() - t0
        launches = {kern.name: kern.launches for kern in KERNELS}
        stats = _KeptStats.made[-1]
        led = _median_ledger(scope_cls.made[-1])
        resume_cfg = experiment.VtraceConfig(**{
            **cfg.__dict__, "max_seconds": E2E_RESUME_SECONDS,
            "log_interval_steps": 640})
        rows2 = experiment.train(resume_cfg, log_fn=lines.append)
        # The same loop without a savedir (no checkpoint at every chance),
        # updates [10, 13) traced into E2E_PROFILE_DIR.
        shutil.rmtree(E2E_PROFILE_DIR, ignore_errors=True)
        plain_cfg = experiment.VtraceConfig(**{
            **cfg.__dict__, "savedir": None, "max_seconds": E2E_PLAIN_SECONDS,
            "profile_dir": E2E_PROFILE_DIR})
        rows3 = experiment.train(plain_cfg, log_fn=lines.append)
        led3 = _median_ledger(scope_cls.made[-1])
        launches = {kern.name: kern.launches for kern in KERNELS}
    finally:
        experiment.StepScope, experiment.Stats = saved
    for line in lines:
        log(f"[e2e] transformer: {line}")
    if len(rows) < 2:
        raise RuntimeError(f"the transformer loop logged {len(rows)} rows")
    rates = _rates(rows)
    updates = rows[-1]["updates"]
    losses = [r["total_loss"] for r in rows]
    returns = [r["episode_returns"] for r in rows
               if np.isfinite(r["episode_returns"])]
    ckpt = os.path.join(E2E_SAVEDIR, "checkpoint.ckpt")
    log(f"[e2e] transformer loop ({E2E_SECONDS:g} s, 32 envs, 2 workers, "
        f"T={UNROLL}, learn batch {LEARN_B}, bf16): {len(rows)} rows in "
        f"{wall:.1f} s; {rates['env_steps_per_s']:.1f} env-steps/s, "
        f"{rates['updates_per_s']:.2f} updates/s (first to last row); "
        f"{updates:g} updates, skips {stats['skips'].result():g}, dropped "
        f"unrolls {stats['dropped_unrolls'].result():g}; global env steps "
        f"{rows[-1]['global_env_steps']:g}")
    _log_e2e_ledger("transformer", led)
    log(f"[e2e] transformer: the windows' mean episode return "
        f"{float(np.mean(returns)) if returns else float('nan'):.2f} beside "
        f"a uniform policy's {E2E_UNIFORM_RETURN:.1f} (a reading, not a "
        f"gate); per window {[round(r, 2) for r in returns]}")
    log(f"[e2e] transformer: resume from {ckpt}: first row's model_version "
        f"{rows2[0]['model_version'] if rows2 else None} vs the run's last "
        f"{rows[-1]['model_version']}; flash launches of the three runs "
        f"{launches}")
    rates3 = _rates(rows3)
    trace = _trace_summary(os.path.join(E2E_PROFILE_DIR, "trace.json"))
    log(f"[e2e] transformer loop without a savedir ({E2E_PLAIN_SECONDS:g} "
        f"s): {rates3['env_steps_per_s']:.1f} env-steps/s, "
        f"{rates3['updates_per_s']:.2f} updates/s; "
        f"{rows3[-1]['updates']:g} updates")
    _log_e2e_ledger("transformer without a savedir", led3)
    log(f"[e2e] transformer without a savedir, updates [10, 13) profiled: "
        f"window {trace['window_ms']:.1f} ms, device busy "
        f"{trace['device_busy_ms']:.1f} ms ({trace['kernels']} kernels), "
        f"idle share {trace['device_idle_share']:.3f}; CUDA runtime ms "
        f"{ {k: round(v, 2) for k, v in trace['runtime_ms'].items()} }; "
        f"host operators ms (inclusive) "
        f"{ {k: round(v, 2) for k, v in trace['ops_ms'].items()} }")
    if updates < 10 or not all(np.isfinite(losses)):
        raise RuntimeError(f"the transformer loop made {updates} updates, "
                           f"losses {losses}")
    if not rows[-1]["global_env_steps"] > 0:
        raise RuntimeError("the stats allreduce never counted env steps")
    if not os.path.exists(ckpt) or not rows2:
        raise RuntimeError(f"no checkpoint at {ckpt} or no row resumed")
    if rows2[0]["model_version"] < rows[-1]["model_version"]:
        raise RuntimeError("the resumed run did not carry model_version "
                           "over")
    if not (launches["flash_fwd"] and launches["flash_bwd_tile"]):
        raise RuntimeError(f"the transformer loop did not launch the "
                           f"flash kernels: {launches}")
    deaths = _worker_deaths(global_telemetry().snapshot())
    if deaths:  # train() retries a step that lost its worker; here, fail
        raise RuntimeError(f"the transformer loop lost {deaths:g} env "
                           f"workers")
    return dict(rows=len(rows), wall_s=wall, updates=updates, **rates,
                skips=stats["skips"].result(),
                dropped_unrolls=stats["dropped_unrolls"].result(),
                mean_return=float(np.mean(returns)) if returns else None,
                ledger=led, resumed_version=rows2[0]["model_version"],
                without_savedir=dict(**rates3, updates=rows3[-1]["updates"],
                                     ledger=led3, trace=trace),
                launches=launches)


def _e2e_bench(learner_only: float) -> dict:
    """(c) bench_e2e_torch.py in a process of its own: its JSON line, and
    its loop's ledger from the JSON line it prints on stderr."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(here, "bench_e2e_torch.py"),
         f"{E2E_BENCH_SECONDS:g}"], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=E2E_BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"bench_e2e_torch.py did not finish in "
                           f"{E2E_BENCH_TIMEOUT_S} s") from None
    if proc.returncode != 0:
        raise RuntimeError(f"bench_e2e_torch.py exited with "
                           f"{proc.returncode}: {stderr[-2000:]}")
    line = json.loads(stdout.strip().splitlines()[-1])
    child = [json.loads(s) for s in stderr.splitlines()
             if s.startswith('{"vtrace_learner"')][-1]
    ledger = child["vtrace_learner"]
    if child["envpool_worker_deaths"]:
        raise RuntimeError(f"bench_e2e_torch.py's loop lost "
                           f"{child['envpool_worker_deaths']:g} env workers")
    log(f"[e2e] bench_e2e_torch.py: {json.dumps(line)}")
    steps = ledger["steps"]
    log(f"[e2e] ImpalaNet loop ledger (bench_e2e_torch.py's stderr; mean "
        f"ms a step over its {steps} steps): "
        + ", ".join(f"{k} {1e3 * v / steps:.3f}"
                    for k, v in ledger["phases"].items())
        + f" | step {1e3 * ledger['wall_s'] / steps:.3f} | host-blocked "
        f"share {ledger['fractions']['host_blocked']:.3f}")
    log(f"[e2e] ImpalaNet: end to end {line['value']:.1f} env-steps/s "
        f"(B=64, bf16) against bench_torch.py's learner-only "
        f"{learner_only:.1f} at B={BENCH_B} in this run: the gap "
        f"learner_only_gap_note names, {learner_only / line['value']:.1f}x")
    if not line["value"] > 0 or not line["total_env_steps"] > 0:
        raise RuntimeError(f"bench_e2e_torch.py measured nothing: {line}")
    return dict(line=line, ledger=ledger, learner_only=learner_only)


def phase_e2e(learner_only: float) -> dict:
    """Phase 11: the acting plane and the experiment loop (see the module
    docstring)."""
    data = _e2e_data_path()
    transformer = _e2e_transformer()
    bench = _e2e_bench(learner_only)
    launches = transformer.pop("launches")
    return dict(data=data, transformer=transformer, bench=bench,
                launches={"e2e transformer": launches})


# Phase 12, the remaining model families and example entry points. The
# MoE transformer at experiment.py's width with transformer_mlp=moe (8
# experts, top-2, capacity factor 1.25: TransformerNet's defaults).
MOE_KW = dict(mlp="moe", num_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
# Route check: the card's router probabilities against the CPU's (f32,
# summation order only), then the CPU forward on the card's routing at
# SERVE_TOL (replies) or phase 6's tolerances (train steps).
ROUTE_PROB_TOL = 1e-5
ZOO_ACT_WAVES = [[0, 1, 2, 3], [4, 5, 6, 0]]   # checked act batches
ZOO_CONTEXT_WAVES = [[0, 1, 2, 3]]             # the checked context batch
ZOO_STEADY_WAVES = {"act": 16, "context": 4}   # unchecked, for the rates
ZOO_E2E_SECONDS = 8.0
NETHACK_SECONDS = 10.0  # short, as E2E_BENCH_SECONDS
NETHACK_COND = 3.0  # the card's f32 gradients against the f64 step's
# config_nethack.yaml asks for 8 actor processes; the card machine has 8
# cores for them, the learner and the actor loop: 4.
NETHACK_ACTOR_PROCESSES = 4
# Each actor steps for REMOTE_ACTOR_SECONDS of its own clock (from its
# EnvPool's start); the learner runs until every actor has exited (at
# most REMOTE_LEARNER_CAP_S), since an actor whose call is in flight when
# the learner closes waits out the RPC timeout and exits 1. A fixed
# learner window (20 s, the actors stopping 8 s before it) lost that race
# to the actors' start-up (interpreter, imports, the pool's spawn) on a
# loaded host.
REMOTE_ACTOR_SECONDS = 5.0
REMOTE_LEARNER_CAP_S = 150.0
# (env, num_actions, actor processes, whether a forward must stack two
# calls). Each actor has one call in flight, so two convoy against the
# infer forward (the server pops one while the other's reply is on its
# way back) and no forward need stack two calls (one chip run: 1.00 calls
# a forward over 1186 forwards); three must stack.
REMOTE_RUNS = (("synthetic", 6, 3, True), ("cartpole", 2, 3, True),
               ("synthetic", 6, 2, False))
REMOTE_CHILD_TIMEOUT_S = 120.0
A2C_CHILD_TIMEOUT_S = 400.0  # bench_a2c_torch.py --seeds 0: 32-80 s seen


def zlog(msg: str, smi: str) -> None:
    """A [zoo] line, with the card's name and power limit."""
    log(f"[zoo] {msg} | card: {smi}")


def _routes():
    """A RouteReplay of the MoE calls' routes on the card, to replay into
    the CPU's calls of the same batch."""
    from moolib_tpu_torch.parallel.moe import RouteReplay

    return RouteReplay()


def _routes_summary(routes) -> str:
    return (f"router probabilities max|card-CPU| {routes.prob_err:.3e} "
            f"(tol {ROUTE_PROB_TOL}); top-2 sets differ on "
            f"{routes.flipped} of {routes.tokens} tokens, CPU margins "
            f"{[f'{m:.2e}' for m in routes.margins[:8]]}")


def _routes_check(routes, what: str) -> None:
    if routes.recorded:
        raise RuntimeError(f"{what}: {len(routes.recorded)} recorded MoE "
                           "calls were not replayed")
    if not routes.prob_err <= ROUTE_PROB_TOL:
        raise RuntimeError(f"{what}: router probabilities differ from "
                           f"the CPU's by {routes.prob_err:.3e}")


def _moe_net(device, backend, generator=None):
    """experiment.py's transformer at full width (phase 5's) with
    transformer_mlp=moe."""
    from moolib_tpu_torch import TransformerNet

    return TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                          attention_backend=backend, device=device,
                          generator=generator, **MOE_KW)


def _zoo_moe_serve(tel, smi) -> dict:
    """(a) The MoE transformer behind an act and a context Replica. The
    checked batches' stacked inputs (padding included) go through the CPU
    forward on the card's routing; their outputs, the batch as served,
    must agree at SERVE_TOL."""
    from moolib_tpu_torch import Replica
    from moolib_tpu_torch.ops._kernels import FLASH_FWD, KERNELS

    net = _moe_net("cuda", "auto",
                   torch.Generator(device="cuda").manual_seed(3)).eval()
    cpu = _moe_net("cpu", "dense").eval()
    cpu.load_state_dict(net.state_dict())
    batch_ms = {"act": [], "context": []}
    fns = _service_fns(batch_ms)
    reqs_by_kind = _serve_requests()
    out, launches = {}, {}
    for kind, waves in (("act", ZOO_ACT_WAVES),
                        ("context", ZOO_CONTEXT_WAVES)):
        routes, seen, checking = _routes(), [], [True]

        def fn(model, batch, kind=kind, routes=routes, seen=seen,
               checking=checking):
            if not checking[0]:
                return fns[kind](model, batch)
            with routes.record():
                res = fns[kind](model, batch)
            seen.append(({k: v.cpu() for k, v in batch.items()},
                         {k: v.float().cpu() for k, v in res.items()
                          if k != "action"}))
            return res

        reqs = reqs_by_kind[kind]
        rep = Replica(None, fn, net, service=f"moe_{kind}",
                      batch_size=BATCH, pad=True, linger_s=0.05,
                      device="cuda", telemetry=tel)
        order = [j % len(reqs)
                 for j in range(ZOO_STEADY_WAVES[kind] * BATCH)]
        try:
            for kern in KERNELS:
                kern.launches = 0
            if kind == "context":
                torch.cuda.reset_peak_memory_stats()
            _serve(rep, reqs, waves)
            launches[f"moe {kind}"] = {k.name: k.launches for k in KERNELS}
            checking[0] = False
            _, steady_ms, rate = _serve_steady(rep.submit, reqs, order)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            rep.close()
        errs = []
        for batch, res in seen:
            n = batch["done"].shape[0]
            with torch.no_grad(), routes.replay():
                if kind == "act":
                    (logits, _), _ = cpu(
                        batch["obs"].reshape(1, n * ACT_ENVS, 84, 84, 4),
                        batch["done"].reshape(1, n * ACT_ENVS))
                    want = {"logits": logits[0].reshape(n, ACT_ENVS, 6)}
                else:
                    (logits, baseline), _ = cpu(batch["obs"].transpose(0, 1),
                                                batch["done"].transpose(0, 1))
                    want = {"logits": logits.transpose(0, 1),
                            "baseline": baseline.transpose(0, 1)}
            for k, w in want.items():
                if not torch.isfinite(res[k]).all():
                    raise RuntimeError(f"moe {kind}: non-finite {k}")
                errs.append(float((res[k] - w).abs().max()))
        _routes_check(routes, f"moe {kind}")
        fwd = batch_ms[kind][-ZOO_STEADY_WAVES[kind]:]
        out[kind] = dict(
            batches_checked=len(seen), max_err=max(errs), rate=rate,
            median_ms=float(np.median(steady_ms)),
            batch_forward_ms=float(np.median(fwd)),
            drop_fraction=float(np.mean(routes.drops)),
            route_flips=routes.flipped, route_tokens=routes.tokens,
            flip_margins=routes.margins, prob_err=routes.prob_err,
            launches=launches[f"moe {kind}"])
        zlog(f"(a) moe {kind}: {len(seen)} stacked batches of {BATCH} "
             f"checked | {_routes_summary(routes)} | max|batch output - CPU "
             f"on the card's routing| {max(errs):.3e} (tol {SERVE_TOL}) | "
             f"launches {launches[f'moe {kind}']}", smi)
        zlog(f"(a) moe {kind} steady ({len(order)} requests, two waves in "
             f"flight): {rate:.3f} requests/s, request latency ms median "
             f"{np.median(steady_ms):.3f}, p90 "
             f"{np.percentile(steady_ms, 90):.3f}; batch forward ms (CUDA "
             f"events) median {np.median(fwd):.3f}; the checked batches' "
             f"drop_fraction {out[kind]['drop_fraction']:.4f}"
             + (f"; peak device memory {peak:.2f} GiB"
                if kind == "context" else ""), smi)
        if kind == "context":
            out[kind]["peak_gib"] = peak
        if max(errs) > SERVE_TOL:
            raise RuntimeError(f"moe {kind} replies differ from the CPU "
                               f"forward by {max(errs):.3e}")
        if launches[f"moe {kind}"][FLASH_FWD.name] == 0:
            raise RuntimeError(f"moe {kind}: flash_fwd never launched")
    return out


def _zoo_moe_train(smi) -> dict:
    """(b) Three V-trace steps of the MoE transformer with the aux folded
    in, on [T+1=21, B=32], against the CPU (dense attention) on the
    card's routing: metrics, the step-1 gradients and the parameters
    after the last step at phase 6's tolerances; two flash_fwd and two
    flash_bwd_tile launches a step, dQ and dK/dV none."""
    from moolib_tpu_torch import (
        ClippedRMSprop,
        ImpalaConfig,
        make_grad_step,
        make_impala_train_step,
        make_train_state,
    )
    from moolib_tpu_torch.ops._kernels import KERNELS

    def apply(model, obs, done, core_state):
        return model(obs, done, core_state, return_aux=True)

    def optimizer(net):
        return ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                              max_norm=40.0)

    cfg = ImpalaConfig(discounting=0.99, baseline_cost=0.5,
                       entropy_cost=0.0006, reward_clip=1.0)
    gen = torch.Generator(device="cuda").manual_seed(4)
    net = _moe_net("cuda", "auto", gen)
    cpu = _moe_net("cpu", "dense")
    cpu.load_state_dict(net.state_dict())
    batches = _learn_batches(gen, TRAIN_STEPS)
    names = METRICS + ("moe_lb_loss", "moe_z_loss", "moe_drop_fraction")

    routes = _routes()
    with routes.record():
        g_card, _ = make_grad_step(apply, config=cfg)(net, batches[0])
    with routes.replay():
        g_cpu, _ = make_grad_step(apply, config=cfg)(cpu,
                                                     _to_cpu(batches[0]))
    errs = {n: float((g_card[n].cpu() - g_cpu[n]).abs().max())
            / float(g_cpu[n].abs().max()) for n in g_cpu}
    worst = max(errs, key=errs.get)
    bad = [n for n, e in errs.items()
           if not e <= BF16_GRAD_TOL.get(n, TRAIN_GRAD_TOL)]
    zlog(f"(b) moe train, step-1 gradients vs the CPU on the card's "
         f"routing: max relative error {errs[worst]:.3e} at {worst} (tol "
         f"{TRAIN_GRAD_TOL}; pos_emb {BF16_GRAD_TOL['pos_emb.weight']:.3e}); "
         f"router {max(errs[n] for n in errs if n.endswith('router')):.3e} "
         f"| {_routes_summary(routes)}", smi)
    _routes_check(routes, "moe train gradients")
    if bad:
        raise RuntimeError(f"moe step-1 gradients differ at {bad}")
    del g_card, g_cpu

    step = make_impala_train_step(apply, config=cfg)
    state = make_train_state(net, optimizer(net))
    ref_state = make_train_state(cpu, optimizer(cpu))
    routes, per_step, metric_err = _routes(), [], 0.0
    for kern in KERNELS:
        kern.launches = 0
    for batch in batches:
        before = {k.name: k.launches for k in KERNELS}
        with routes.record():
            state, m = step(state, batch)
            m = {k: float(m[k]) for k in names}  # hotlint: sync -- the smoke reads each step's metrics to hold them to the CPU's
        per_step.append({k.name: k.launches - before[k.name]
                         for k in KERNELS})
        with routes.replay():
            ref_state, rm = step(ref_state, _to_cpu(batch))
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"moe train: non-finite metrics {m}")  # hotlint: sync -- only on the failure path
        metric_err = max(metric_err, max(
            abs(m[k] - float(rm[k])) / max(abs(float(rm[k])), 1.0)  # hotlint: sync -- the CPU reference's metrics, read to compare
            for k in names))
    launches = {k.name: k.launches for k in KERNELS}
    param_err = max(float((p.cpu() - cpu.state_dict()[n]).abs().max())
                    for n, p in net.state_dict().items())
    _routes_check(routes, "moe train steps")
    zlog(f"(b) moe train: {TRAIN_STEPS} steps, metrics {m} | max relative "
         f"metric error vs the CPU {metric_err:.3e} (tol "
         f"{TRAIN_METRIC_TOL}) | params after the last step max|card-CPU| "
         f"{param_err:.3e} (tol {TRAIN_PARAM_TOL}) | "
         f"{_routes_summary(routes)} | launches per step {per_step}", smi)
    if metric_err > TRAIN_METRIC_TOL or param_err > TRAIN_PARAM_TOL:
        raise RuntimeError("moe train steps differ from the CPU's")
    for counts in per_step:
        if (counts["flash_fwd"], counts["flash_bwd_tile"],
                counts["flash_bwd_dq"], counts["flash_bwd_dkdv"]) \
                != (2, 2, 0, 0):
            raise RuntimeError(f"moe train step launches {counts}; want "
                               "flash_fwd 2, flash_bwd_tile 2, dq/dkdv 0")
    # Steady step time (CUDA events) and one profiled step.
    step_ms = cuda_ms(lambda: step(state, batches[0]), iters=5)
    prof = _profile_step(lambda: step(state, batches[0]),
                         tag=f"zoo | card: {smi}")
    zlog(f"(b) moe train step: {step_ms:.3f} ms (CUDA events, mean of 5) | "
         f"profiled: wall {prof['wall_ms']:.3f} ms, {prof['device_items']} "
         f"device items, busy {prof['device_busy_ms']:.3f} ms; by class "
         f"{ {k: round(v, 3) for k, v in prof['by_class_ms'].items()} }",
         smi)
    return dict(step_ms=step_ms, grad_err=errs[worst], metric_err=metric_err,
                param_err=param_err, route_flips=routes.flipped,
                route_tokens=routes.tokens, flip_margins=routes.margins,
                launches_per_step=per_step, launches=launches,
                profile={k: prof[k] for k in ("wall_ms", "device_items",
                                              "device_busy_ms",
                                              "by_class_ms")})


def _zoo_moe_e2e(smi) -> dict:
    """(c) experiment.py's train() with model=transformer and
    transformer_mlp=moe, without a savedir, for ZOO_E2E_SECONDS."""
    from bench_e2e_torch import _worker_deaths
    from moolib_tpu_torch.examples.vtrace import experiment
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.telemetry import global_telemetry

    deaths0 = _worker_deaths(global_telemetry().snapshot())
    for kern in KERNELS:
        kern.launches = 0
    cfg = experiment.VtraceConfig(
        env="synthetic", model="transformer", transformer_mlp="moe", seed=0,
        max_seconds=ZOO_E2E_SECONDS, log_interval_steps=2000,
        stats_interval=2.0)
    t0 = time.perf_counter()
    rows = experiment.train(cfg, log_fn=lambda *a: None)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    deaths = _worker_deaths(global_telemetry().snapshot()) - deaths0
    if len(rows) < 2:
        raise RuntimeError(f"the moe loop logged {len(rows)} rows")
    rates = _rates(rows)
    drops = [r["moe_drop_fraction"] for r in rows
             if np.isfinite(r["moe_drop_fraction"])]
    losses = [r["total_loss"] for r in rows if np.isfinite(r["total_loss"])]
    zlog(f"(c) moe e2e ({ZOO_E2E_SECONDS:g} s, experiment.py's defaults, "
         f"no savedir): {len(rows)} rows in {wall:.1f} s; "
         f"{rates['env_steps_per_s']:.1f} env-steps/s, "
         f"{rates['updates_per_s']:.2f} updates/s (first to last row); "
         f"{rows[-1]['updates']:g} updates; moe_drop_fraction per window "
         f"{[round(d, 4) for d in drops]}; launches {launches}", smi)
    if rows[-1]["updates"] < 10 or not losses \
            or not all(np.isfinite(r["total_loss"]) for r in rows[1:]):
        raise RuntimeError(f"the moe loop: {rows[-1]['updates']} updates, "
                           f"losses {[r['total_loss'] for r in rows]}")
    if not drops:
        raise RuntimeError("the moe loop never logged moe_drop_fraction")
    if not (launches["flash_fwd"] and launches["flash_bwd_tile"]):
        raise RuntimeError(f"the moe loop launched {launches}")
    if deaths:
        raise RuntimeError(f"the moe loop lost {deaths:g} env workers")
    return dict(rows=len(rows), wall_s=wall, updates=rows[-1]["updates"],
                drop_fraction=float(np.mean(drops)), launches=launches,
                **rates)


def _nethack_config():
    """config_nethack.yaml's settings, read as experiment.py's --config."""
    from moolib_tpu_torch.examples.vtrace import experiment

    return experiment._load_config(os.path.join(
        os.path.dirname(experiment.__file__), "config_nethack.yaml"))


def _nethack_wrong_trunks(net, batch, state_dict, ratios) -> dict:
    """NetHackNet's grad step on the card with a deliberately wrong trunk:
    its convolutions in TF32 (the f32 lock lifted in the learner and the
    model), then a bf16 trunk (compute_dtype) with the same weights.
    ``ratios`` maps a gradient dict to each tensor's error over its tol;
    returns {what: (the worst tensor, its ratio)}."""
    import moolib_tpu_torch.learner as learner_mod
    import moolib_tpu_torch.models.nethack as nethack_mod
    from moolib_tpu_torch import NetHackNet, make_grad_step

    @contextlib.contextmanager
    def tf32_convolutions():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    saved = learner_mod.f32_convolutions, nethack_mod.f32_convolutions
    learner_mod.f32_convolutions = tf32_convolutions
    nethack_mod.f32_convolutions = tf32_convolutions
    try:
        g_tf32, _ = make_grad_step()(net, batch)
    finally:
        learner_mod.f32_convolutions, nethack_mod.f32_convolutions = saved
    bf16 = NetHackNet(net.num_actions, compute_dtype=torch.bfloat16,
                      device="cuda")
    bf16.load_state_dict(state_dict)
    g_bf16, _ = make_grad_step()(bf16, batch)
    out = {}
    for what, g in (("tf32 convolutions", g_tf32), ("bf16 trunk", g_bf16)):
        r = ratios(g)
        worst = max(r, key=r.get)
        out[what] = (worst, r[worst])
    return out


def _zoo_nethack(smi) -> dict:
    """(d) NetHackNet's grad step on one learn batch of config_nethack's
    shape (f32, LSTM state at frame 0 random), card against CPU; then
    train() at config_nethack.yaml's settings for NETHACK_SECONDS."""
    from bench_e2e_torch import _worker_deaths
    from moolib_tpu_torch import NetHackNet, make_grad_step
    from moolib_tpu_torch.examples.vtrace import experiment
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.telemetry import global_telemetry

    cfg = _nethack_config()
    T, B, A = cfg.unroll_length, cfg.learn_batch_size, cfg.num_actions
    gen = torch.Generator().manual_seed(5)
    cpu = NetHackNet(A, device="cpu", generator=gen)
    net = NetHackNet(A, device="cuda")
    net.load_state_dict(cpu.state_dict())
    phase = torch.randint(0, 400, (1, B), generator=gen)
    batch = {
        "obs": {"glyphs": torch.randint(0, 5976, (T + 1, B, 21, 79),
                                        generator=gen).to(torch.int16),
                "blstats": 50.0 * torch.randn((T + 1, B, 27),
                                              generator=gen)},
        "done": (torch.arange(T + 1)[:, None] + phase) % 400 == 0,
        "rewards": torch.randn((T + 1, B), generator=gen),
        "actions": torch.randint(0, A, (T, B), generator=gen),
        "behavior_logits": torch.randn((T, B, A), generator=gen),
        "core_state": tuple(torch.randn((B, 256), generator=gen)
                            for _ in range(2)),
    }

    def to(x, device):
        if torch.is_tensor(x):
            return x.to(device)
        if isinstance(x, dict):
            return {k: to(v, device) for k, v in x.items()}
        return tuple(to(v, device) for v in x)

    def to_f64(x):
        if torch.is_tensor(x):
            return x.double() if x.is_floating_point() else x
        if isinstance(x, dict):
            return {k: to_f64(v) for k, v in x.items()}
        return tuple(to_f64(v) for v in x)

    for kern in KERNELS:
        kern.launches = 0
    g_card, m_card = make_grad_step()(net, to(batch, "cuda"))
    g_cpu, m_cpu = make_grad_step()(cpu, batch)
    # The trunk's gradients pass through thousands of relu gates whose
    # inputs sit near zero; one rounding flips some, so they are no fixed
    # point of f32 (the CPU's own f32 gradients are 7.7e-3 of glyph_embed's
    # largest entry from f64's on this batch). Each tensor is held, as
    # the f64 step's, to the larger of TRAIN_GRAD_TOL and NETHACK_COND
    # times the CPU f32 step's own distance from it.
    net64 = copy.deepcopy(cpu).double()
    net64.compute_dtype = torch.float64
    g64, _ = make_grad_step()(net64, {
        k: v if k in ("actions", "done") else to_f64(v)
        for k, v in batch.items()})

    def rel(g, n):
        return float((g.cpu().double() - g64[n]).abs().max()) \
            / float(g64[n].abs().max())

    card = {n: rel(g_card[n], n) for n in g64}
    cond = {n: rel(g_cpu[n], n) for n in g64}
    tol = {n: max(TRAIN_GRAD_TOL, NETHACK_COND * cond[n]) for n in g64}
    worst = max(card, key=lambda n: card[n] / tol[n])
    metric_err = max(abs(float(m_card[k]) - float(m_cpu[k]))
                     / max(abs(float(m_cpu[k])), 1.0) for k in METRICS)
    zlog(f"(d) nethack grad step, learn batch [T+1={T + 1}, B={B}] "
         f"glyphs 21x79 int16 + blstats 27, f32, LSTM; relative gradient "
         f"errors from the f64 step's, card (CPU f32): "
         + ", ".join(f"{n} {card[n]:.2e} ({cond[n]:.2e})" for n in g64)
         + f" | worst against its tol: {worst} {card[worst]:.3e} (tol "
         f"{tol[worst]:.3e}) | metrics vs the CPU {metric_err:.3e} (tol "
         f"{TRAIN_METRIC_TOL})", smi)
    if card[worst] > tol[worst] or metric_err > TRAIN_METRIC_TOL:
        raise RuntimeError("the nethack grad step differs from the CPU's")
    wrong = _nethack_wrong_trunks(net, to(batch, "cuda"), cpu.state_dict(),
                                  lambda g: {n: rel(g[n], n) / tol[n]
                                             for n in g64})
    zlog("(d) the same bounds on deliberately wrong card trunks (worst "
         "tensor's error over its tol; over 1 fails): " + ", ".join(
             f"{what} {n} {r:.2f}" for what, (n, r) in wrong.items()), smi)
    passed = [what for what, (_, r) in wrong.items() if not r > 1.0]
    if passed:
        raise RuntimeError(f"the nethack gradient bounds pass {passed}")

    unrolls = []

    class KeptBatchState(experiment.EnvBatchState):
        def observe(self, env_out):
            unroll = super().observe(env_out)
            if unroll is not None:
                unrolls.append(unroll["core_state"])
            return unroll

    deaths0 = _worker_deaths(global_telemetry().snapshot())
    run_cfg = experiment.VtraceConfig(**{
        **cfg.__dict__, "total_steps": 10 ** 12,
        "max_seconds": NETHACK_SECONDS,
        "num_actor_processes": NETHACK_ACTOR_PROCESSES,
        "log_interval_steps": 5_000, "stats_interval": 2.0})
    saved = experiment.EnvBatchState
    experiment.EnvBatchState = KeptBatchState
    try:
        t0 = time.perf_counter()
        rows = experiment.train(run_cfg, log_fn=lambda *a: None)
        wall = time.perf_counter() - t0
    finally:
        experiment.EnvBatchState = saved
    launches = {k.name: k.launches for k in KERNELS}
    deaths = _worker_deaths(global_telemetry().snapshot()) - deaths0
    carried = [float(h.abs().sum()) for c, h in unrolls[2:]]
    rates = _rates(rows) if len(rows) > 1 else dict(
        env_steps_per_s=float("nan"), updates_per_s=float("nan"))
    zlog(f"(d) nethack train() at config_nethack.yaml's settings (bf16, "
         f"LSTM, T={cfg.unroll_length}, learn batch {B}, virtual batch "
         f"{cfg.virtual_batch_size}, lr {cfg.learning_rate}) for "
         f"{NETHACK_SECONDS:g} s; reduced: num_actor_processes "
         f"{cfg.num_actor_processes} -> {NETHACK_ACTOR_PROCESSES} (the card "
         f"machine's 8 cores), total_steps -> a {NETHACK_SECONDS:g} s run: "
         f"{len(rows)} rows in {wall:.1f} s, {rows[-1]['updates']:g} "
         f"updates, env-steps/s {rates['env_steps_per_s']:.1f}, updates/s "
         f"{rates['updates_per_s']:.2f}; "
         f"losses {[round(r['total_loss'], 4) for r in rows]}; {len(unrolls)} "
         f"unrolls, the LSTM state at their first frame nonzero in "
         f"{sum(c > 0 for c in carried)} of {len(carried)} (past the first "
         f"two); env worker deaths {deaths:g}", smi)
    if not rows or rows[-1]["updates"] < 1 \
            or not np.isfinite(rows[-1]["total_loss"]):
        raise RuntimeError(f"the nethack loop: {rows}")
    if deaths:
        raise RuntimeError(f"the nethack loop lost {deaths:g} env workers")
    if not carried or not all(c > 0 for c in carried):
        raise RuntimeError("the nethack loop did not carry the LSTM state")
    if any(launches.values()):
        raise RuntimeError(f"the nethack path launched {launches}")
    return dict(grad_err=card[worst], grad_tol=tol[worst],
                metric_err=metric_err, wrong_trunks=wrong, wall_s=wall,
                updates=rows[-1]["updates"], rows=len(rows), **rates,
                launches=launches)


def _zoo_a2c_bar() -> dict:
    """bench_a2c_torch.py's run at seed 0 in a child process, and this
    process's CPU seconds and threads meanwhile. The loop's timing enters
    its trajectory (when the Accumulator first connects, whether a reduce
    lands an iteration late), and this process carries the threads the
    earlier phases left: run in it, seed 0 missed the bar in three smoke
    runs of three on an H100 machine, where run alone it met the bar in
    four of four."""
    here = os.path.dirname(os.path.abspath(__file__))
    cpu0, threads = sum(os.times()[:2]), threading.active_count()
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "bench_a2c_torch.py"),
         "--seeds", "0"], cwd=here, capture_output=True, text=True,
        timeout=A2C_CHILD_TIMEOUT_S)
    cpu = sum(os.times()[:2]) - cpu0
    if proc.returncode:
        raise RuntimeError(f"bench_a2c_torch.py exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    (res,) = [json.loads(line) for line in proc.stdout.splitlines()
              if line.startswith('{"seed"')]
    return dict(res, parent_cpu_s=cpu, parent_threads=threads)


def _zoo_a2c(smi) -> dict:
    """(e) A2C on CartPole at LEARNING_r04.json's settings (80,000 steps,
    log windows of 4,000), gated on its bar (bench_a2c_torch.py's run at
    seed 0, in a child process); then the pixel A2C smoke."""
    import bench_a2c_torch as bar_bench
    from moolib_tpu_torch.examples import a2c
    from moolib_tpu_torch.ops._kernels import KERNELS

    for kern in KERNELS:
        kern.launches = 0
    res = _zoo_a2c_bar()
    bar, need, _ = bar_bench.BAR
    zlog(f"(e) a2c cartpole (bench_a2c_torch.py --seeds 0, a child; this "
         f"process meanwhile {res['parent_cpu_s']:.1f} CPU s over "
         f"{res['parent_threads']} threads), {bar_bench.STEPS} steps: wall "
         f"{res['wall_s']:.1f} s, {res['updates']:g} updates, dropped "
         f"unrolls {res['dropped_unrolls']:g}; bar: return > {bar:g} in "
         f"{res['hits']} of the last {res['windows']} windows (need "
         f"{need}); entropy of the last 10 windows {res['entropy']} (inside "
         f"{bar_bench.ENTROPY}); curve (env steps, return, entropy) "
         f"{res['curve']}", smi)
    pixel = a2c.train(a2c.A2CConfig(env="synthetic", num_actions=6,
                                    total_steps=600, unroll_length=5,
                                    batch_size=2, num_processes=2,
                                    log_interval_steps=300, seed=0),
                      log_fn=lambda *a: None)
    launches = {k.name: k.launches for k in KERNELS}
    zlog(f"(e) a2c pixel smoke (synthetic, bf16 ImpalaNet on the card): "
         f"{pixel[-1]['updates']:g} updates, loss "
         f"{pixel[-1]['total_loss']:.4f}; flash launches {launches}", smi)
    if not res["met"]:
        raise RuntimeError(f"a2c missed the learning bar: {res['hits']} of "
                           f"{res['windows']} windows above {bar:g}")
    if not res["entropy_ok"]:
        raise RuntimeError(f"a2c entropy outside {bar_bench.ENTROPY}: "
                           f"{res['entropy']}")
    if pixel[-1]["updates"] < 1 or not np.isfinite(pixel[-1]["total_loss"]):
        raise RuntimeError(f"the pixel a2c smoke: {pixel}")
    if any(launches.values()):
        raise RuntimeError(f"the a2c path launched {launches}")
    return dict(wall_s=res["wall_s"], updates=res["updates"],
                hits=res["hits"], windows=res["windows"],
                entropy=res["entropy"], curve=res["curve"],
                pixel_updates=pixel[-1]["updates"], launches=launches)


def _zoo_remote(env: str, num_actions: int, actors: int, must_stack: bool,
                smi) -> dict:
    """(f) run_learner on the card with ``actors`` run_actor child
    processes of REMOTE_ACTOR_SECONDS each, the learner stopped once they
    have exited; the learner's Rpc telemetry says how many actor calls
    each infer forward stacked (at least one forward must stack two calls
    where ``must_stack``)."""
    from moolib_tpu_torch.examples import remote_actors as ra

    kept = []

    class KeptRpc(ra.Rpc):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    cfg = ra.RemoteConfig(env=env, num_actions=num_actions,
                          max_seconds=REMOTE_LEARNER_CAP_S, log_interval=2.0)
    ready, stop, box = threading.Event(), threading.Event(), {}

    def learner():
        try:
            box["rows"] = ra.run_learner(
                cfg, log_fn=lambda *a: None, stop_event=stop,
                ready_fn=lambda addr: (box.update(addr=addr), ready.set()))
        finally:
            box["end"] = time.perf_counter()
            ready.set()

    saved, ra.Rpc = ra.Rpc, KeptRpc
    children = []
    try:
        t0 = time.perf_counter()
        thread = threading.Thread(target=learner, daemon=True)
        thread.start()
        if not ready.wait(120) or "addr" not in box:
            raise RuntimeError("the remote learner never listened")
        ra.Rpc = saved
        fill = kept[0].telemetry.registry.histogram(
            "rpc_batch_fill_fraction", endpoint="infer")
        for _ in range(actors):
            children.append(subprocess.Popen(
                [sys.executable, "-m", "moolib_tpu_torch.examples."
                 "remote_actors", "--role", "actor", "--learner",
                 box["addr"], "--env", env, "--num-actions",
                 str(num_actions), "--max-seconds",
                 str(REMOTE_ACTOR_SECONDS)],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True))
        errs = [c.communicate(timeout=REMOTE_CHILD_TIMEOUT_S)[1]
                for c in children]
        stop.set()
        thread.join(60)
        if thread.is_alive():
            raise RuntimeError("the remote learner did not stop")
    finally:
        stop.set()
        ra.Rpc = saved
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    rows = box.get("rows") or []
    wall = box["end"] - t0
    updates = rows[-1]["updates"] if rows else 0
    calls_per_batch = fill.sum * cfg.infer_batch_size / max(fill.count, 1)
    zlog(f"(f) remote actors, {env}: learner on the card "
         f"({'ImpalaNet f32' if env != 'cartpole' else 'A2CNet'}), "
         f"{actors} actor processes x {cfg.actor_batch_size} envs, "
         f"{REMOTE_ACTOR_SECONDS:g} s each: {updates} updates logged, fps "
         f"{rows[-1]['fps'] if rows else float('nan'):.1f}, updates/s "
         f"{updates / wall:.2f} (over the learner's {wall:.1f} s); infer "
         f"forwards {fill.count}, actor calls a forward {calls_per_batch:.2f} "
         f"(mean, of {cfg.infer_batch_size}); actor exit codes "
         f"{[c.returncode for c in children]}", smi)
    if any(c.returncode for c in children):
        raise RuntimeError(f"remote actor children failed: "
                           f"{[e[-2000:] for e in errs]}")
    if not updates or not np.isfinite(rows[-1]["total_loss"]):
        raise RuntimeError(f"the remote learner: {rows}")
    if must_stack and not fill.sum * cfg.infer_batch_size > fill.count:
        raise RuntimeError("no infer forward stacked more than one call")
    return dict(updates=updates, fps=rows[-1]["fps"],
                updates_per_s=updates / wall, infer_forwards=fill.count,
                calls_per_forward=calls_per_batch)


def phase_zoo(smi) -> dict:
    """Phase 12: the remaining model families and example entry points
    (see the module docstring)."""
    from moolib_tpu_torch.ops._kernels import KERNELS

    t0 = time.perf_counter()
    serve = _zoo_moe_serve(_telemetry("zoo"), smi)
    train = _zoo_moe_train(smi)
    e2e = _zoo_moe_e2e(smi)
    nethack = _zoo_nethack(smi)
    a2c = _zoo_a2c(smi)
    for kern in KERNELS:
        kern.launches = 0
    remote = {f"{env} x{actors}": _zoo_remote(env, n, actors, stack, smi)
              for env, n, actors, stack in REMOTE_RUNS}
    remote_launches = {k.name: k.launches for k in KERNELS}
    if any(remote_launches.values()):
        raise RuntimeError(f"the remote actors path launched "
                           f"{remote_launches}")
    zlog(f"phase took {time.perf_counter() - t0:.1f} s", smi)
    launches = {
        "moe act": serve["act"].pop("launches"),
        "moe context": serve["context"].pop("launches"),
        "moe train": train.pop("launches"),
        "e2e moe": e2e.pop("launches"),
        "nethack": nethack.pop("launches"),
        "a2c": a2c.pop("launches"),
        "remote actors": remote_launches,
    }
    return dict(serve=serve, train=train, e2e=e2e, nethack=nethack, a2c=a2c,
                remote=remote, seconds=time.perf_counter() - t0,
                launches=launches)


# -- phase 13: durable state and the fleet ------------------------------------

SS_LEARNERS = ("ss0", "ss1", "ss2")
SS_OFF_UPDATES = 4        # updates timed with the Replicators off
SS_ON_UPDATES = 12        # then with them on, before the leader dies
SS_AFTER_REJOIN = 3       # versions the cohort commits after the rejoin
SS_FOLLOWERS = 2
SS_QUORUM = 2
SS_CHUNK = 1 << 20        # bundle chunk bytes
SS_KEEP = 64              # versions a store keeps
SS_GROUP_TIMEOUT = 8.0
SS_KEEPALIVE_S = 0.5      # a dead peer's lanes close after 4 silent intervals
SS_BUDGET_S = 120.0
SS_ROOT = os.path.join("build", "statestore")
FLEET_REQUESTS = 48       # act requests before the rollouts and after adoption
FLEET_CONCURRENCY = 4
FLEET_BUDGET_S = 8.0      # a request's budget, tests/test_fleet.py's


def sslog(msg: str, smi: str) -> None:
    """A [statestore] line, with the card's name and power limit."""
    log(f"[statestore] {msg} | card: {smi}")


def flog(msg: str, smi: str) -> None:
    """A [fleet] line, with the card's name and power limit."""
    log(f"[fleet] {msg} | card: {smi}")


def _state_sha(host: dict) -> str:
    """sha256 over a train_state_to_host payload's parameters and
    optimizer state (names, then raw bytes), in name order."""
    import hashlib

    h = hashlib.sha256()
    leaves = [(f"params/{n}", t) for n, t in sorted(host["params"].items())]
    leaves += [(f"optimizer/{n}/{k}", v)
               for n, st in sorted(host["optimizer"].items())
               for k, v in sorted(st.items())]
    for name, v in leaves:
        h.update(name.encode())
        if torch.is_tensor(v):
            h.update(str(v.dtype).encode())
            h.update(v.detach().cpu().contiguous().reshape(-1)
                     .view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def _hist(snap: dict, name: str) -> list:
    h = snap.get(name)
    return [h["count"], h["sum"]] if h else [0, 0.0]


class _DurableLearner(_Learner):
    """A learner of phase 13: phase 9's _Learner of the full-width
    TransformerNet with a StateStore under ``root`` on its Rpc and, once
    asked, a Replicator(followers=2) whose state_fn is
    train_state_to_host under the sync-mode and state locks (the copy off
    the card waits for the card). With ``restore_from`` (the survivors'
    names and addresses) it first restores the newest version they agree
    on by quorum 2 onto the card, reads the state back off the card, and
    seeds its model version from it. Each version it publishes is
    recorded with the sha256 of the host copy its state_fn produced."""

    GROUP_TIMEOUT = SS_GROUP_TIMEOUT

    def __init__(self, name, rank, broker_addr, group, seed, root,
                 restore_from=()):
        self.root = root
        self.restore_from = [tuple(p) for p in restore_from]
        self.restored = None
        self.shas = {}
        self.publish_ms = []
        self.rep = None
        super().__init__(name, rank, broker_addr, group, "transformer", seed)

    def _before_join(self):
        from moolib_tpu_torch.statestore import StateStore

        self.rpc.set_keepalive_interval(SS_KEEPALIVE_S)
        self.store = StateStore(self.root, self.rpc, chunk_bytes=SS_CHUNK,
                                keep_versions=SS_KEEP)
        publish = self.store.publish

        def timed(version, state, peers=(), **kw):
            t0 = time.perf_counter()
            acks = publish(version, state, peers, **kw)
            self.publish_ms.append(
                [int(version), 1e3 * (time.perf_counter() - t0), len(peers)])
            return acks

        self.store.publish = timed  # a measuring instrument
        if self.restore_from:
            self.restored = self._restore()

    def _restore(self) -> dict:
        from moolib_tpu_torch.learner import (load_train_state,
                                              train_state_to_host)

        for _name, addr in self.restore_from:
            self.rpc.connect(addr)
        peers = tuple(n for n, _a in self.restore_from)
        t0 = time.perf_counter()
        neg = self.store.negotiate(peers, quorum=SS_QUORUM, timeout=30.0)
        t1 = time.perf_counter()
        got = self.store.restore(peers, quorum=SS_QUORUM, timeout=30.0)
        t2 = time.perf_counter()
        if neg is None or got is None:
            raise RuntimeError(f"{self.name}: nothing restorable on {peers}")
        version, host = got
        # The restore re-persists what it pulled: its local write.
        persist_ms = 1e3 * _hist(self.rpc.telemetry.registry.snapshot(),
                                 "statestore_put_seconds")[1]
        with self.lock:
            self.state = load_train_state(self.state, host)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            card = train_state_to_host(self.state)
            self.done_step = self.state.step
        return dict(version=version, negotiated=neg.version,
                    manifest_hash=neg.manifest_hash,
                    local_hash=dict(self.store.versions()).get(version),
                    holders=list(neg.holders), sha=_state_sha(card),
                    step=self.state.step, negotiate_ms=1e3 * (t1 - t0),
                    restore_ms=1e3 * (t2 - t1), persist_ms=persist_ms,
                    upload_ms=1e3 * (t3 - t2))

    def _before_run(self):
        if self.restored is not None:
            self.acc.set_model_version(self.restored["version"])

    def _get_state(self):
        with _SYNC_MODE_LOCK:
            return super()._get_state()

    def _durable_state(self):
        from moolib_tpu_torch.learner import train_state_to_host

        with _SYNC_MODE_LOCK, self.lock:
            version = self.acc.result_model_version()
            stable = not self.acc.has_gradients()
            host = train_state_to_host(self.state)
        if stable:
            self.shas[version] = _state_sha(host)
        return host

    def replicate(self):
        from moolib_tpu_torch.statestore import Replicator

        if self.rep is None:
            self.rep = Replicator(self.store, self.acc, self._durable_state,
                                  followers=SS_FOLLOWERS)

    def durable_report(self) -> dict:
        from moolib_tpu_torch.statestore import LOCAL
        from moolib_tpu_torch.statestore.bundle import read_manifest

        published = []
        if self.rep is not None:
            with self.rep._lock:
                published = sorted(self.rep.published.items())
        versions = self.store.versions()
        bundle = None
        if versions:
            m = read_manifest(self.store.root, versions[-1][0])
            bundle = [m["total_bytes"], len(m["chunks"])]
        snap = self.rpc.telemetry.registry.snapshot()
        return dict(
            version=self.acc.model_version, leader=self.acc.is_leader(),
            published=[[v, acks.get(LOCAL), sorted(p for p in acks
                                                   if p != LOCAL),
                        all(acks.values()), self.shas.get(v)]
                       for v, acks in published],
            versions=[[v, h] for v, h in versions], bundle=bundle,
            publish_ms=list(self.publish_ms),
            put=_hist(snap, "statestore_put_seconds"),
            replicate=_hist(snap, "statestore_replicate_seconds"),
            restored=self.restored,
            applies=[[a["version"], a["t"]] for a in list(self.applies)])

    def close(self):
        if self.rep is not None:
            self.rep.close()
        self.store.close()
        super().close()


class _SsCohort:
    """Phase 13's learner processes: a Broker here, and one child process
    per learner (this script with --acc-child BROKER CTL_NAME), each
    holding one _DurableLearner."""

    def __init__(self):
        from moolib_tpu_torch.rpc import Rpc
        from moolib_tpu_torch.rpc.broker import Broker

        self.broker_rpc = Rpc("broker")  # the Group default broker_name
        self.broker_rpc.set_keepalive_interval(SS_KEEPALIVE_S)
        self.broker_rpc.listen("127.0.0.1:0")
        self.addr = self.broker_rpc.debug_info()["listen"][0]
        self.broker = Broker(self.broker_rpc)
        self.stop = threading.Event()
        self.pump = threading.Thread(target=self._pump, daemon=True)  # lifelint: intentional -- close() stops and joins it; the cohort lives for one phase
        self.pump.start()
        self.client = Rpc("ss-client")
        self.client.set_timeout(SS_BUDGET_S)
        self.children = {}  # learner name -> (process, control peer)
        self.generation = 0

    def _pump(self):
        while not self.stop.is_set():
            self.broker.update()
            time.sleep(0.02)

    def spawn(self, names):
        """Start one child per learner name, all together."""
        here = os.path.dirname(os.path.abspath(__file__))
        self.generation += 1
        procs = {}
        for name in names:
            ctl = f"ss-ctl-{name}-{self.generation}"
            procs[name] = (subprocess.Popen(
                [sys.executable, os.path.join(here, "chip_smoke.py"),
                 ACC_CHILD_FLAG, self.addr, ctl], cwd=here,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True),
                ctl)
        self.children.update(procs)
        for name, (proc, _ctl) in procs.items():
            self.client.connect(_child_addresses(proc)["addr"])

    def ctl(self, name, op, *args):
        return self.client.async_(self.children[name][1], "chip_acc", op,
                                  *args).result(timeout=SS_BUDGET_S)

    def status(self) -> dict:
        st = {}
        for name in self.children:
            st.update(self.ctl(name, "status"))
        bad = {n: s["error"] for n, s in st.items() if s["error"]}
        if bad:
            raise RuntimeError(f"statestore phase: learner failed: {bad}")
        return st

    def reports(self) -> dict:
        out = {}
        for name in self.children:
            out.update(self.ctl(name, "durable_report"))
        return out

    def until(self, cond, what):
        return _until(cond, what, lambda: str(self.status()),
                      timeout=SS_BUDGET_S)

    def train_to(self, target: int):
        for name in self.children:
            self.ctl(name, "target", name, target)
        self.until(lambda: all(s["step"] >= target
                               for s in self.status().values()),
                   f"version {target} on every learner")

    def kill(self, name):
        """SIGKILL the learner's process (no cleanup of any kind)."""
        proc, _ctl = self.children.pop(name)
        proc.kill()
        proc.wait(timeout=30)

    def close(self):
        try:
            for name in list(self.children):
                try:
                    self.ctl(name, "close")
                except Exception as e:  # moolint: disable=swallow-cancelled -- the exit code below decides; no event loop in this thread
                    log(f"[statestore] closing {name}: {e}")
        finally:
            codes = {}
            for name, (proc, _ctl) in self.children.items():
                proc.stdin.close()
                try:
                    codes[name] = proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()  # lifelint: intentional -- killing an exited child is a no-op
                    proc.wait(timeout=30)
                    codes[name] = "killed"
            self.children = {}
            self.client.close()
            self.stop.set()
            self.pump.join(timeout=5)
            self.broker_rpc.close()
        if any(c != 0 for c in codes.values()):
            raise RuntimeError(f"statestore children exited with {codes}")


def _rate(applies, lo: int, hi: int) -> float:
    """Updates a second over versions (lo, hi] of one learner's applies."""
    ts = {v: t for v, t in applies}
    if lo not in ts or hi not in ts or hi <= lo:
        raise RuntimeError(f"no applies for versions {lo}..{hi}: "
                           f"{sorted(ts)}")
    return (hi - lo) / (ts[hi] - ts[lo])


def _ss_settled(cohort):
    """(leader, version, reports) once every learner is at one version,
    one of them leads, it published that version with every ack, and all
    three stores advertise it with the leader's manifest hash; else
    None."""
    reps = cohort.reports()
    leaders = [n for n, r in reps.items() if r["leader"]]
    versions = {r["version"] for r in reps.values()}
    if len(leaders) != 1 or len(versions) != 1:
        return None
    leader, v = leaders[0], versions.pop()
    pub = {p[0]: p for p in reps[leader]["published"]}
    if v not in pub or not pub[v][3]:
        return None
    h = dict(map(tuple, reps[leader]["versions"])).get(v)
    if not all(dict(map(tuple, r["versions"])).get(v) == h
               for r in reps.values()):
        return None
    return leader, v, reps


def _ss_durable(cohort, smi) -> dict:
    """Phase 13 (a): three learners train with and without Replicators;
    the leader dies with its disk; a fresh process restores by quorum 2
    onto the card, bit for bit, and rejoins."""
    names = list(SS_LEARNERS)
    shutil.rmtree(SS_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    cohort.spawn(names)
    for rank, name in enumerate(names):
        cohort.ctl(name, "durable", name, rank, "ss", rank,
                   os.path.join(SS_ROOT, name), [])
    cohort.until(lambda: all(s["connected"] and s["synced"]
                             and len(s["members"]) == 3
                             for s in cohort.status().values()),
                 "three synced learners")
    start_s = time.perf_counter() - t0
    cohort.train_to(1)
    cohort.train_to(1 + SS_OFF_UPDATES)
    off = cohort.reports()
    lead = next(n for n, r in off.items() if r["leader"])
    off_rate = _rate(off[lead]["applies"], 1, 1 + SS_OFF_UPDATES)
    for name in names:
        cohort.ctl(name, "replicator", name)
    v_on = 1 + SS_OFF_UPDATES
    target = v_on + SS_ON_UPDATES
    cohort.train_to(target)
    # Training paused at `target`: wait until the leader has published
    # the last version and both followers hold it.
    leader, v_kill, reps = cohort.until(lambda: _ss_settled(cohort),
                                        "the last version on 3 stores")
    rep = reps[leader]
    published = {p[0]: p for p in rep["published"]}
    committed = v_kill - v_on
    on_rate = _rate(rep["applies"], v_on, v_kill)
    pub_ms = sorted(ms for _v, ms, _n in rep["publish_ms"])
    put_n, put_s = rep["put"]
    repl_n, repl_s = rep["replicate"]
    mb, chunks = rep["bundle"][0] / 1e6, rep["bundle"][1]
    sslog(f"bundle {mb:.3f} MB in {chunks} chunks of {SS_CHUNK} bytes | "
          f"leader {leader}: {len(published)} versions published for "
          f"{committed} committed ({len(published) / committed:.3f} per "
          f"committed version) | publish ms median "
          f"{pub_ms[len(pub_ms) // 2]:.2f} (min {pub_ms[0]:.2f}, max "
          f"{pub_ms[-1]:.2f}): local write {1e3 * put_s / max(put_n, 1):.2f} "
          f"ms mean over {put_n}, push to one follower "
          f"{1e3 * repl_s / max(repl_n, 1):.2f} ms mean over {repl_n}", smi)
    sslog(f"updates/s of the leader: Replicators off {off_rate:.2f} "
          f"(versions 1..{v_on}), on {on_rate:.2f} (versions "
          f"{v_on}..{v_kill}) | three learners started in {start_s:.1f} s",
          smi)
    # Latest-wins: versions may be skipped, never published unacked.
    bad = {v: p for v, p in published.items()
           if not p[1] or not p[3] or len(p[2]) != SS_FOLLOWERS or not p[4]}
    if bad:
        raise RuntimeError(f"publishes not acked by the store and "
                           f"{SS_FOLLOWERS} followers: {bad}")
    launches = cohort.ctl(leader, "kernels")  # its process dies next
    addrs = {}
    for n in names:
        addrs.update(cohort.ctl(n, "addr"))

    # Host loss: SIGKILL the leader and wipe its store.
    t_kill = time.perf_counter()
    cohort.kill(leader)
    shutil.rmtree(os.path.join(SS_ROOT, leader))
    survivors = [n for n in names if n != leader]
    cohort.spawn([leader])
    restored = cohort.ctl(leader, "durable", leader, names.index(leader),
                          "ss", 10 + names.index(leader),
                          os.path.join(SS_ROOT, leader),
                          [[n, addrs[n]] for n in survivors])
    v = restored["version"]
    want = published.get(v)
    if want is None:
        raise RuntimeError(f"restored v{v}, which the leader did not "
                           f"publish ({sorted(published)})")
    leader_hash = dict(map(tuple, rep["versions"]))[v]
    checks = dict(version=v == v_kill, negotiated=restored["negotiated"] == v,
                  manifest_hash=restored["manifest_hash"] == leader_hash,
                  local_hash=restored["local_hash"] == leader_hash,
                  sha=restored["sha"] == want[4],
                  holders=sorted(restored["holders"]) == sorted(survivors))
    sslog(f"killed leader {leader} and wiped its store; the fresh process "
          f"restored v{v} from {restored['holders']} (quorum {SS_QUORUM}): "
          f"negotiate {restored['negotiate_ms']:.2f} ms; restore "
          f"{restored['restore_ms']:.2f} ms = its negotiation, the pull and "
          f"decode, and the local write of what it pulled "
          f"({restored['persist_ms']:.2f} ms); upload onto the card "
          f"{restored['upload_ms']:.2f} ms | manifest hash "
          f"{restored['manifest_hash'][:16]}.. == leader's "
          f"{leader_hash[:16]}.. | card readback sha "
          f"{restored['sha'][:16]}.. vs the leader's state_fn copy "
          f"{want[4][:16]}.. | checks {checks}", smi)
    if not all(checks.values()):
        raise RuntimeError(f"restore checks failed: {checks}")
    cohort.until(lambda: all(s["connected"] and s["synced"]
                             and len(s["members"]) == 3
                             for s in cohort.status().values()),
                 "the rejoined cohort")
    rejoin_s = time.perf_counter() - t_kill
    cohort.ctl(leader, "replicator", leader)
    cohort.train_to(v_kill + SS_AFTER_REJOIN)
    leader2, v_end, after = cohort.until(lambda: _ss_settled(cohort),
                                         "the last version after the rejoin")
    sslog(f"cohort rejoined {rejoin_s:.1f} s after the kill and committed "
          f"versions {v_kill + 1}..{v_end} with the restored learner; "
          f"leader now {leader2}", smi)
    if v_end < v_kill + SS_AFTER_REJOIN:
        raise RuntimeError(f"only versions up to {v_end} after the rejoin")
    for n in cohort.children:  # cumulative in each live process
        for k, c in cohort.ctl(n, "kernels").items():
            launches[k] = launches.get(k, 0) + c
    return dict(leader=leader, survivors=survivors, version=v,
                version_end=v_end, bundle_mb=mb, chunks=chunks,
                published=len(published), committed=committed,
                publish_ms=pub_ms, put=rep["put"],
                replicate=rep["replicate"], updates_s_off=off_rate,
                updates_s_on=on_rate, restore=restored, rejoin_s=rejoin_s,
                addrs={n: addrs[n] for n in survivors}, launches=launches)


class _CardActFn:
    """A serving model function over train-state payloads: each thread
    that calls it (one a replica) keeps a full-width TransformerNet on
    the card and loads a payload's parameters into it the first time it
    sees that payload; then it runs phase 5's act step on BATCH requests
    (a smaller batch padded as Replica(pad=True) pads it). A payload with
    ``poison`` set raises (the poisoned build of the fleet's rollback)."""

    def __init__(self):
        self.local = threading.local()
        self.batch_ms = {"act": [], "context": []}

    def __call__(self, params, batch):
        if params.get("poison"):
            raise RuntimeError("poisoned canary build")
        loc = self.local
        if getattr(loc, "net", None) is None:
            loc.net = _serve_net(0)
            loc.params = None
            loc.act = _service_fns(self.batch_ms)["act"]
        if loc.params is not params:
            _load_params(loc.net, params["params"])
            loc.params = params
        n = batch["done"].shape[0]
        if n == BATCH:
            return loc.act(loc.net, batch)
        # Phase 5's shape: pad to BATCH requests (row 0 repeated), as a
        # Replica with pad=True does, and slice the reply back.
        padded = {k: torch.cat([v, v[:1].expand(BATCH - n, *v.shape[1:])])
                  for k, v in batch.items()}
        return {k: v[:n] for k, v in loc.act(loc.net, padded).items()}


def _load_params(net, host_params):
    named = dict(net.named_parameters())
    with torch.no_grad():
        for name, t in host_params.items():
            named[name].copy_(torch.as_tensor(np.asarray(t))
                              if not torch.is_tensor(t) else t)


def _cpu_dense(host_params):
    """Phase 5's dense CPU forward with these parameters."""
    from moolib_tpu_torch import TransformerNet

    dense = TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                           attention_backend="dense", device="cpu").eval()
    _load_params(dense, host_params)
    return dense


def _ss_serve(cohort, durable, smi) -> dict:
    """Phase 13 (b): publish_from_statestore into two card Replicas."""
    from moolib_tpu_torch import Replica, Router
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.rpc import Rpc
    from moolib_tpu_torch.serving import publish_from_statestore
    from moolib_tpu_torch.statestore import StateStore

    tel = _telemetry("statestore serve")
    fn = _CardActFn()
    rpcs = [Rpc(f"ss-rep{i}", telemetry=tel) for i in range(2)]
    front = Rpc("ss-front", telemetry=tel)
    reps, router, store = [], None, None
    try:
        for r in rpcs:
            r.listen("127.0.0.1:0")
            front.connect(r.debug_info()["listen"][0])
        for addr in durable["addrs"].values():
            front.connect(addr)
        init = {"params": {n: p.detach().cpu() for n, p in
                           _serve_net(0).named_parameters()}}
        reps = [Replica(r, fn, init, service="act", batch_size=BATCH,
                        pad=True, linger_s=0.01, device="cuda")
                for r in rpcs]
        router = Router(front, [r.get_name() for r in rpcs], service="act")
        _until(lambda: len(router.routable()) == 2, "2 routable replicas",
               timeout=60)
        store = StateStore(os.path.join(SS_ROOT, "serve"), front,
                           chunk_bytes=SS_CHUNK)
        for kern in KERNELS:
            kern.launches = 0
        t0 = time.perf_counter()
        v, acks = publish_from_statestore(
            router, store, peers=durable["survivors"], quorum=SS_QUORUM)
        publish_ms = 1e3 * (time.perf_counter() - t0)
        host = store.load(v)
        if not all(acks.values()) or any(r.version != v for r in reps):
            raise RuntimeError(f"publish of v{v}: acks {acks}, replica "
                               f"versions {[r.version for r in reps]}")
        sha = _state_sha(host)
        shas = {p[0]: p[4] for r in cohort.reports().values()
                for p in r["published"]}
        if sha != shas.get(v):
            raise RuntimeError(f"v{v} served from the statestore is not "
                               "the version its publisher recorded")
        dense = _cpu_dense(host["params"])
        reqs = _serve_requests()["act"]
        errs = []
        for i in range(2 * len(reqs)):
            req = reqs[i % len(reqs)]
            out = router.infer(req, budget_s=60.0)
            errs.append(_reply_err("act", out, _dense_ref(dense, "act",
                                                          req)))
        health = [front.sync(r.get_name(), "act.health")["model_version"]
                  for r in rpcs]
        launches = {k.name: k.launches for k in KERNELS}
        sslog(f"publish_from_statestore(peers={durable['survivors']}, "
              f"quorum {SS_QUORUM}) loaded v{v} (sha {sha[:16]}.., the "
              f"publisher's) into both card replicas in {publish_ms:.1f} ms "
              f"| {len(errs)} act replies through the Router after it, max "
              f"abs err {max(errs):.3e} vs the dense CPU forward (tol "
              f"{SERVE_TOL}) | health versions {health} | launches "
              f"{launches}", smi)
        if max(errs) > SERVE_TOL or health != [v, v]:
            raise RuntimeError("statestore serve: replies off the "
                               "published version")
        if not launches["flash_fwd"]:
            raise RuntimeError("statestore serve: no flash_fwd launch")
        return dict(version=v, publish_ms=publish_ms, max_abs_err=max(errs),
                    replies=len(errs), host=host, launches=launches)
    finally:
        if store is not None:
            store.close()
        if router is not None:
            router.close()
        for r in reps:
            r.close()
        front.close()
        for r in rpcs:
            r.close()


class _FleetLoad:
    """FLEET_CONCURRENCY closed-loop clients sending act requests
    through ``router`` until stopped; every outcome is recorded (ok with
    a well-formed reply, or the error)."""

    def __init__(self, router, reqs):
        self.outcomes = []
        self.lock = threading.Lock()
        self.halt = threading.Event()
        self.t0 = time.perf_counter()
        self.threads = [threading.Thread(target=self._worker,
                                         args=(router, reqs, k), daemon=True)
                        for k in range(FLEET_CONCURRENCY)]
        for t in self.threads:
            t.start()

    def _worker(self, router, reqs, k):
        from moolib_tpu_torch.serving import error_kind

        i = k
        while not self.halt.is_set():
            try:
                out = router.infer(reqs[i % len(reqs)],
                                   budget_s=FLEET_BUDGET_S)
                ok = (np.asarray(out["action"]).shape == (ACT_ENVS,)
                      and bool(np.isfinite(np.asarray(out["logits"])).all()))
                rec = "ok" if ok else "malformed reply"
            except Exception as e:  # moolint: disable=swallow-cancelled -- recorded; the phase fails on it; no event loop in this thread
                rec = f"{error_kind(e)}: {e}"
            with self.lock:
                self.outcomes.append(rec)
            i += FLEET_CONCURRENCY

    def count(self) -> int:
        with self.lock:
            return len(self.outcomes)

    def stop(self, what: str) -> dict:
        self.halt.set()
        for t in self.threads:
            t.join(timeout=FLEET_BUDGET_S + 30)
            if t.is_alive():
                raise RuntimeError(f"fleet: a load worker hung {what}")
        wall = time.perf_counter() - self.t0
        failed = [o for o in self.outcomes if o != "ok"]
        return dict(requests=len(self.outcomes), failed=len(failed),
                    errors=failed[:3], seconds=wall,
                    requests_s=len(self.outcomes) / wall)


def _next_params(host) -> dict:
    """One more IMPALA train step on the card from ``host``: the
    payload of the version the fleet promotes."""
    from moolib_tpu_torch import (ClippedRMSprop, ImpalaConfig,
                                  make_apply_step, make_grad_step,
                                  make_train_state)
    from moolib_tpu_torch.learner import (load_train_state,
                                          train_state_to_host)

    net = _serve_net(0).train()
    state = make_train_state(net, ClippedRMSprop(
        net.parameters(), 6e-4, decay=0.99, eps=0.01, max_norm=40.0))
    state = load_train_state(state, host)
    cfg = ImpalaConfig(discounting=0.99, baseline_cost=0.5,
                       entropy_cost=0.0006, reward_clip=1.0)
    batch = _learn_batches(torch.Generator(device="cuda").manual_seed(7),
                           1)[0]
    grads, _ = make_grad_step(config=cfg, grad_scale=float(LEARN_B))(
        state.model, batch)
    state = make_apply_step()(state, grads)
    return train_state_to_host(state)


def _ss_fleet(served, smi) -> dict:
    """Phase 13 (c): a fleet Controller of card replicas serving the
    restored version, a promote, a poisoned rollback, a controller kill
    with standby adoption."""
    from moolib_tpu_torch.fleet import Controller, FleetSpec
    from moolib_tpu_torch.flightrec import load_bundle
    from moolib_tpu_torch.ops._kernels import KERNELS

    v, host = served["version"], served["host"]
    spec = FleetSpec.small(replicas=2, routers=1)
    fn = _CardActFn()
    reqs = _serve_requests()["act"]
    for kern in KERNELS:
        kern.launches = 0
    t0 = time.perf_counter()
    ctl = Controller(spec, name="ctl0", model=fn, params=host, version=v,
                     device="cuda", incident_dir=BUNDLE_DIR)
    standby = None
    try:
        ctl.materialize()
        standby = Controller(spec, cohort=ctl.cohort, name="ctl1",
                             standby=True, model=fn, params=host, version=v,
                             device="cuda", incident_dir=BUNDLE_DIR)
        _until(lambda: ctl.router() is not None
               and len(ctl.router().routable()) == 2,
               "2 routable fleet replicas", timeout=60)
        materialize_s = time.perf_counter() - t0
        router = ctl.router()
        warm = _FleetLoad(router, reqs)
        _until(lambda: warm.count() >= FLEET_REQUESTS, "warm-up requests",
               timeout=120)
        warm = warm.stop("before the rollouts")
        nxt = _next_params(host)
        rollouts = {}
        for tag, params, version, want in (
                ("promote", nxt, v + 1, "promoted"),
                ("rollback", dict(nxt, poison=True), v + 2, "rolled_back")):
            load = _FleetLoad(router, reqs)
            t1 = time.perf_counter()
            state = ctl.start_rollout(params=params, version=version,
                                      wait=True)
            took = time.perf_counter() - t1
            rollouts[tag] = dict(state=state, rollout_s=took,
                                 **load.stop(f"across the {tag}"))
            if state != want or rollouts[tag]["failed"]:
                raise RuntimeError(f"fleet {tag}: {state} (want {want}), "
                                   f"{rollouts[tag]}")
        bundle = load_bundle(ctl._rollout.incident_path)  # validates
        if bundle["trigger"]["kind"] != "fleet_rollback":
            raise RuntimeError(f"incident bundle trigger {bundle['trigger']}")
        versions = [ctl.cohort.roles[f"{spec.name}-rep{i}"].obj.version
                    for i in range(2)]
        if versions != [v + 1, v + 1]:
            raise RuntimeError(f"replicas on {versions} after the "
                               f"rollback, want v{v + 1}")
        dense = _cpu_dense(nxt["params"])
        err = _reply_err("act", router.infer(reqs[0], budget_s=60.0),
                         _dense_ref(dense, "act", reqs[0]))
        if err > SERVE_TOL:
            raise RuntimeError(f"fleet: promoted replies off by {err}")
        # Kill the primary under load: the standby adopts.
        load = _FleetLoad(router, reqs)
        t2 = time.perf_counter()
        ctl.kill()
        _until(lambda: ctl.cohort.controller == "ctl1"
               and ctl.cohort.epoch == 2, "standby adoption", timeout=30)
        adopt_s = time.perf_counter() - t2
        after = load.count()
        _until(lambda: load.count() >= after + FLEET_REQUESTS,
               "requests after the adoption", timeout=120)
        kill = load.stop("across the controller kill")
        if kill["failed"] or standby.adopt() != {"already": True,
                                                 "epoch": 2}:
            raise RuntimeError(f"fleet adoption: {kill}")
        launches = {k.name: k.launches for k in KERNELS}
        flog(f"materialize {materialize_s:.2f} s (2 card replicas "
             f"routable) | warm-up {warm['requests_s']:.1f} requests/s | "
             f"promote v{v + 1} {rollouts['promote']['rollout_s']:.2f} s, "
             f"rollback of the poisoned v{v + 2} "
             f"{rollouts['rollback']['rollout_s']:.2f} s (incident bundle "
             f"{ctl._rollout.incident_path} validates) | adoption "
             f"{adopt_s:.2f} s, {kill['requests']} requests across the "
             f"kill, {kill['failed']} failed | promoted replies max abs err "
             f"{err:.3e} | launches {launches}", smi)
        for tag, r in rollouts.items():
            flog(f"{tag}: {r['requests']} requests during the rollout, "
                 f"{r['failed']} failed, {r['requests_s']:.1f} requests/s "
                 f"({FLEET_CONCURRENCY} closed-loop clients, act requests "
                 f"of {ACT_ENVS} envs, budget {FLEET_BUDGET_S} s)", smi)
        if not launches["flash_fwd"] or not launches["flash_bwd_tile"]:
            raise RuntimeError(f"fleet path launches {launches}")
        return dict(materialize_s=materialize_s, adopt_s=adopt_s,
                    warm=warm, rollouts=rollouts, kill=kill,
                    promoted_err=err, launches=launches)
    finally:
        if standby is not None:
            standby.close()
        ctl.close(close_roles=True)


def phase_statestore(smi) -> dict:
    """Phase 13: durable state and the fleet (see the module docstring)."""
    t0 = time.perf_counter()
    cohort = _SsCohort()
    try:
        durable = _ss_durable(cohort, smi)
        served = _ss_serve(cohort, durable, smi)
    finally:
        cohort.close()
    fleet = _ss_fleet(served, smi)
    served.pop("host")
    launches = {"statestore learners": durable.pop("launches"),
                "statestore serve": served.pop("launches"),
                "fleet": fleet.pop("launches")}
    if not (launches["statestore learners"].get("flash_fwd")
            and launches["statestore learners"].get("flash_bwd_tile")):
        raise RuntimeError(f"statestore learners launched "
                           f"{launches['statestore learners']}")
    sslog(f"phase took {time.perf_counter() - t0:.1f} s", smi)
    return dict(durable=durable, serve=served, fleet=fleet,
                seconds=time.perf_counter() - t0, launches=launches)


# -- phase 14: chaos and parity ----------------------------------------------

SOAK_TIMEOUT_S = 400.0
SOAK_LOG = os.path.join("build", "chaos_soak.log")  # the child's stderr
SOAK_SCENARIOS = 18
KILL_REPLICAS = 3
KILL_CLIENTS = 8
KILL_BUDGET_S = 8.0       # a request's budget, scenario_replica_kill's
KILL_SLACK_S = 5.0        # and its slack
KILL_AFTER = 60           # completed requests before the kill
KILL_REQUESTS = 240
KILL_SEED = 101           # the replica_kill seed of tests/test_chaos.py
KILL_DISTINCT = 8         # act requests the clients cycle through
PARITY_RUNS = 3
PARITY_STEPS = 20         # timed train steps a turn


def clog(msg: str, smi: str) -> None:
    """A [chaos] line, with the card's name and power limit."""
    log(f"[chaos] {msg} | card: {smi}")


def plog(msg: str, smi: str) -> None:
    """A [parity] line, with the card's name and power limit."""
    log(f"[parity] {msg} | card: {smi}")


def _chaos_soak(smi) -> dict:
    """Phase 14 (a): every scenario of the port's chaos soak under the
    resource tracker and the lock tracer (phase 17 (e) reads the
    latter), in a child process whose serving and fleet replicas sit on
    the card. The child's exit code decides; its stderr goes to
    SOAK_LOG."""
    os.makedirs("build", exist_ok=True)
    cmd = [sys.executable, "-m", "moolib_tpu_torch.tools.chaos_soak",
           "--smoke", "--restrack", "--locktrace", "--device", "cuda",
           "--incident-dir", os.path.join("build", "incidents")]
    t0 = time.perf_counter()
    with open(SOAK_LOG, "w") as err:
        # A session of its own: a failed phase kills the soak and the env
        # workers it spawned together.
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err,
                                text=True, start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=SOAK_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    seconds = time.perf_counter() - t0
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        clog(f"soak: {line}", smi)
    try:
        report = json.loads(lines[-1])
    except (IndexError, ValueError):
        report = {}
    passed = [ln for ln in lines if ln.startswith("ok ")]
    locktrace = report.get("locktrace", {})
    if (proc.returncode != 0 or not report.get("ok")
            or report.get("runs") != SOAK_SCENARIOS
            or len(passed) != SOAK_SCENARIOS
            or report.get("restrack", {}).get("leaked") != {}
            or not locktrace.get("edges") or "violation" in locktrace):
        with open(SOAK_LOG) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"the chaos soak failed (exit {proc.returncode}"
                           f"): {report or lines[-5:]}; its stderr ends: "
                           f"{tail}")
    clog(f"soak: {len(passed)} scenarios passed, restrack "
         f"{report['restrack']['tracked']} acquisitions, none leaked; "
         f"locktrace {locktrace['edges']} observed lock-order edges, "
         f"acyclic, within static_package_edges(); {seconds:.1f} s with "
         f"the child's start", smi)
    return dict(seconds=seconds, total_seconds=report["total_seconds"],
                scenario_seconds=report["scenario_seconds"],
                tracked=report["restrack"]["tracked"],
                locktrace=dict(edges=locktrace["edges"], runs=len(passed),
                               seconds=seconds))


def _kill_requests():
    """KILL_DISTINCT act requests of ACT_ENVS envs, resets at their
    phases as in phase 5."""
    rng = np.random.default_rng(KILL_SEED)
    phase = rng.integers(0, EPISODE_LENGTH, ACT_ENVS)
    return [{"obs": rng.integers(0, 256, (ACT_ENVS, 84, 84, 4), np.uint8),
             "done": (r + phase) % EPISODE_LENGTH == 0}
            for r in range(KILL_DISTINCT)]


def _quantile(vals, q):
    vals = sorted(vals)
    return vals[min(int(q * len(vals)), len(vals) - 1)]


def _chaos_replica_kill(smi) -> dict:
    """Phase 14 (b): three Replicas of phase 5's act step on the card
    behind a Router, KILL_CLIENTS closed-loop clients, one replica's
    connections killed and its peer closed after KILL_AFTER completed
    requests (a FaultPlan seeded KILL_SEED), held to the invariants of
    scenario_replica_kill; every reply, the warm-up's too, against the
    dense CPU forward."""
    from moolib_tpu_torch import Replica, Router, Rpc
    from moolib_tpu_torch.ops._kernels import FLASH_FWD, KERNELS
    from moolib_tpu_torch.serving import error_kind
    from moolib_tpu_torch.testing import ChaosNet, FaultPlan
    from moolib_tpu_torch.testing.scenarios import _await

    reqs = _kill_requests()
    batch_ms = {"act": [], "context": []}
    rpcs, reps = [], []
    router_rpc = router = net = None
    try:
        for i in range(KILL_REPLICAS):
            rpc = Rpc(f"chaos-rep{i}")
            rpc.listen("127.0.0.1:0")
            rpcs.append(rpc)
            model = _serve_net(0)
            reps.append(Replica(rpc, _service_fns(batch_ms)["act"], model,
                                service="act", batch_size=BATCH, pad=True,
                                device="cuda"))
        dense = _dense_copy(model.state_dict())
        refs = [_dense_ref(dense, "act", req) for req in reqs]
        for rep in reps:  # a replica's first batch is cold
            rep.submit(reqs[0]).result(timeout=120)
        names = [rpc.get_name() for rpc in rpcs]
        router_rpc = Rpc("chaos-router")
        for rpc in rpcs:
            router_rpc.connect(rpc.debug_info()["listen"][0])
        router = Router(router_rpc, names, service="act",
                        attempt_timeout_s=1.0, probe_interval_s=0.1,
                        probe_misses=3, seed=KILL_SEED)
        _await(lambda: len(router.routable()) == KILL_REPLICAS, 30.0,
               "chaos replica kill: the replicas never became routable")
        # Warm the routed path (connections, lanes) with two waves of
        # KILL_CLIENTS requests, so the p99 before the kill is the
        # steady one the bound is taken from.
        with concurrent.futures.ThreadPoolExecutor(KILL_CLIENTS) as pool:
            for _ in range(2):
                warm = list(pool.map(
                    lambda i: router.infer(reqs[i], budget_s=KILL_BUDGET_S),
                    [k % KILL_DISTINCT for k in range(KILL_CLIENTS)]))
        plan = FaultPlan(KILL_SEED)
        net = ChaosNet(plan, [router_rpc] + rpcs)

        lock = threading.Lock()
        # (ok, request index, latency s, after the kill, reply or error)
        outcomes = []
        killed = threading.Event()
        marks = {}

        def worker(k):
            for j in range(KILL_REQUESTS // KILL_CLIENTS):
                i = (k + KILL_CLIENTS * j) % KILL_DISTINCT
                t0 = time.monotonic()
                try:
                    got = router.infer(reqs[i], budget_s=KILL_BUDGET_S)
                    ok = True
                except Exception as e:  # moolint: disable=swallow-cancelled -- recorded; checked after the run; no event loop in this thread
                    got, ok = f"{error_kind(e)}: {e}", False
                lat = time.monotonic() - t0
                with lock:
                    outcomes.append((ok, i, lat, killed.is_set(), got))
                    fire = (len(outcomes) >= KILL_AFTER
                            and not killed.is_set())
                    if fire:
                        killed.set()
                        marks["kill"] = time.monotonic()
                if fire:
                    net.kill_conns(rpcs[0])
                    rpcs[0].close()

        for kern in KERNELS:
            kern.launches = 0
        marks["start"] = time.monotonic()
        threads = [threading.Thread(target=worker, args=(k,), daemon=True)
                   for k in range(KILL_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=KILL_REQUESTS * (KILL_BUDGET_S + KILL_SLACK_S))
            if t.is_alive():
                raise RuntimeError("chaos replica kill: a client hung: a "
                                   "request neither returned nor failed")
        marks["end"] = time.monotonic()
        launches = {kern.name: kern.launches for kern in KERNELS}
        _await(lambda: names[0] not in router.routable(), 15.0,
               "chaos replica kill: the killed replica stayed in rotation")
        drained_s = time.monotonic() - marks["kill"]
        reg = router_rpc.telemetry.registry
        retried = reg.value("serving_retried_total", service="act") or 0
        out_of_rotation = [n for n in names if n not in router.routable()]
        plan.verify_telemetry()
        summary = plan.summary()
    finally:
        if net is not None:
            net.detach_all()
        if router is not None:
            router.close()
        if router_rpc is not None:
            router_rpc.close()
        for rep, rpc in zip(reps, rpcs):
            rep.close()
            rpc.close()

    pre = [o for o in outcomes if not o[3]]
    post = [o for o in outcomes if o[3]]
    failed = [o for o in outcomes if not o[0]]
    slow = [o for o in outcomes if o[2] >= KILL_BUDGET_S + KILL_SLACK_S]
    errs = [_reply_err("act", o[4], refs[o[1]]) for o in outcomes if o[0]]
    errs += [_reply_err("act", out, refs[k % KILL_DISTINCT])
             for k, out in enumerate(warm)]
    pre_lat = [o[2] for o in pre]
    post_lat = [o[2] for o in post if o[0]]
    p99_pre, p99_post = _quantile(pre_lat, 0.99), _quantile(post_lat, 0.99)
    bound = 3.0 * max(p99_pre, 0.1)  # scenario_replica_kill's floor
    rate_pre = len(pre) / (marks["kill"] - marks["start"])
    rate_post = len(post) / (marks["end"] - marks["kill"])
    clog(f"replica kill: {KILL_REPLICAS} act replicas ({ACT_ENVS} envs, "
         f"BATCH {BATCH}), {KILL_CLIENTS} clients, {len(outcomes)} requests "
         f"| before the kill {len(pre)} at {rate_pre:.1f} requests/s, p50 "
         f"{1e3 * _quantile(pre_lat, 0.5):.2f} ms, p99 {1e3 * p99_pre:.2f} "
         f"ms | after {len(post)} at {rate_post:.1f} requests/s, p50 "
         f"{1e3 * _quantile(post_lat, 0.5):.2f} ms, p99 "
         f"{1e3 * p99_post:.2f} ms (bound {1e3 * bound:.2f}) | failed "
         f"{len(failed)} | router retried {retried:g}, out of rotation "
         f"{out_of_rotation} {drained_s:.2f} s after the kill | injected "
         f"{summary} | max|reply-dense on CPU| {max(errs):.3e} (tol "
         f"{SERVE_TOL}) | launches {launches}", smi)
    problems = []
    if len(outcomes) != KILL_REQUESTS:
        problems.append(f"{KILL_REQUESTS - len(outcomes)} requests vanished")
    if slow:
        problems.append(f"{len(slow)} outcomes past budget + slack")
    if not all(o[0] for o in pre):
        problems.append(f"failures before the kill: {failed[:3]}")
    if sum(o[0] for o in post) < 0.8 * len(post):
        problems.append(f"only {len(post_lat)}/{len(post)} served after "
                        f"the kill: {[o[4] for o in failed][:3]}")
    if p99_post > bound:
        problems.append(f"p99 after the kill {p99_post:.4f} s > {bound:.4f}")
    if summary != {"conn_kill": 1}:
        problems.append(f"injected {summary}")
    if max(errs) > SERVE_TOL:
        problems.append(f"replies {max(errs):.3e} from the CPU forward")
    if not launches[FLASH_FWD.name]:
        problems.append(f"{FLASH_FWD.name} never launched")
    if problems:
        raise RuntimeError(f"chaos replica kill: {problems}")
    return dict(requests=len(outcomes), failed=len(failed),
                before=dict(requests=len(pre), requests_s=rate_pre,
                            p50_ms=1e3 * _quantile(pre_lat, 0.5),
                            p99_ms=1e3 * p99_pre),
                after=dict(requests=len(post), requests_s=rate_post,
                           p50_ms=1e3 * _quantile(post_lat, 0.5),
                           p99_ms=1e3 * p99_post),
                p99_ratio=p99_post / p99_pre, retried=retried,
                out_of_rotation=out_of_rotation, drained_s=drained_s,
                injected=summary, max_err=max(errs), launches=launches)


def _parity_kernels(smi) -> dict:
    """Phase 14 (c): each kernel's wrapper PARITY_RUNS times on one
    seeded input at the shapes the main paths give it, under ParityWatch
    (bitwise)."""
    from moolib_tpu_torch.ops import _kernels
    from moolib_tpu_torch.ops.attention import _flash_delta
    from moolib_tpu_torch.testing import ParityWatch

    gen = torch.Generator(device="cuda").manual_seed(14)
    items = []
    for kern in _kernels.KERNELS:
        kern.launches = 0
    for where, shape, dtype, kernels in (
            ("act", ACT_SHAPE, torch.float32, ("flash_fwd",)),
            ("train", TRAIN_SHAPE, torch.float32,
             ("flash_fwd", "flash_bwd_tile")),
            ("context, resets", CONTEXT_SHAPE, torch.float32,
             ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")),
            ("B*H=32 T=2048 bf16, resets", (8, 4, 2048, 32), torch.bfloat16,
             ("flash_fwd",))):
        B, _, T, _ = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        seg = episode_segments(gen, B, T)
        o, lse = _kernels.flash_fwd(q, k, v, seg, seg, True)
        delta = _flash_delta(o, do)
        calls = {
            "flash_fwd": lambda: _kernels.flash_fwd(q, k, v, seg, seg, True),
            "flash_bwd_tile": lambda: _kernels.flash_bwd_tile(
                q, k, v, seg, seg, o, lse, do, True),
            "flash_bwd_dq": lambda: _kernels.flash_bwd_dq(
                q, k, v, seg, seg, lse, delta, do, True),
            "flash_bwd_dkdv": lambda: _kernels.flash_bwd_dkdv(
                q, k, v, seg, seg, lse, delta, do, True),
        }
        for kname in kernels:
            ParityWatch(runs=PARITY_RUNS, enabled=True,
                        label=f"{kname} {where}").check(calls[kname])
            items.append(f"{kname} {list(shape)} {str(dtype)[6:]} ({where})")
    launches = {kern.name: kern.launches for kern in _kernels.KERNELS}
    plog(f"kernels bitwise over {PARITY_RUNS} runs: {'; '.join(items)}",
         smi)
    return dict(items=items, launches=launches)


@contextlib.contextmanager
def _tf32_off_only():
    """The convolution switch as it stood before the repair: TF32 held
    off, cuDNN free to pick any algorithm."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def _unrepaired():
    """The train steps without the determinism repair: the convolution
    switch of the learner and of the models swapped for _tf32_off_only."""
    from moolib_tpu_torch import learner
    from moolib_tpu_torch.models import impala, transformer

    mods = (learner, impala, transformer)
    saved = [m.f32_convolutions for m in mods]
    for m in mods:
        m.f32_convolutions = _tf32_off_only
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.f32_convolutions = fn


def _step_ms(step, state, batch, steps: int) -> float:
    """Mean ms of ``steps`` chained train steps (CUDA events) after 3
    warm-up steps."""
    for _ in range(3):
        state, _ = step(state, batch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state, _ = step(state, batch)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def _repair_turns(make_state, step, batch, steps: int) -> dict:
    """The step's ms with and without the determinism repair, in turns
    (with, without, without, with), each turn from a fresh state."""
    times = {"repaired": [], "unrepaired": []}
    for turn in ("repaired", "unrepaired", "unrepaired", "repaired"):
        with (_unrepaired() if turn == "unrepaired"
              else contextlib.nullcontext()):
            times[turn].append(_step_ms(step, make_state(), batch, steps))
    return times


def _parity_train(smi) -> dict:
    """Phase 14 (c): phase 6's full-width TransformerNet IMPALA/V-trace
    train step (learn batch [21, 32], bf16 compute, ClippedRMSprop) from
    one seeded state and batch, PARITY_RUNS times under ParityWatch: the
    parameters, RMSprop's state and the metrics bit for bit. Then the
    step's time with and without the determinism repair of cuDNN's
    convolutions, in turns, and whether the unrepaired step diverges."""
    from moolib_tpu_torch import (ClippedRMSprop, ImpalaConfig,
                                  TransformerNet, make_impala_train_step,
                                  make_train_state)
    from moolib_tpu_torch.learner import train_state_to_host
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.testing import ParityViolation, ParityWatch
    from moolib_tpu_torch.testing.paritywatch import flatten_with_paths

    import bench_torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    net0 = TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                          attention_backend="auto", device="cuda",
                          generator=gen)
    batch = _learn_batches(gen, 1)[0]
    step = make_impala_train_step(config=ImpalaConfig(
        discounting=0.99, baseline_cost=0.5, entropy_cost=0.0006,
        reward_clip=1.0))

    def fresh():
        net = copy.deepcopy(net0)
        return make_train_state(net, ClippedRMSprop(
            net.parameters(), 6e-4, decay=0.99, eps=0.01, max_norm=40.0))

    def update():
        state, m = step(fresh(), batch)
        return {"state": train_state_to_host(state),
                "metrics": {k: m[k] for k in METRICS}}

    for kern in KERNELS:
        kern.launches = 0
    out = ParityWatch(runs=PARITY_RUNS, enabled=True,
                      label="transformer train step").check(update)
    launches = {kern.name: kern.launches for kern in KERNELS}
    leaves = len(flatten_with_paths(out))
    times = _repair_turns(fresh, step, batch, PARITY_STEPS)
    # The repair's cost where the convolutions weigh most: bench_torch's
    # bf16 ImpalaNet step at B=BENCH_B.
    istep, istate, ibatch = bench_torch.build("cuda", BENCH_B)
    impala_times = _repair_turns(lambda: istate, istep, ibatch,
                                 PARITY_STEPS // 2)
    del istate, ibatch
    with _unrepaired():
        try:
            ParityWatch(runs=PARITY_RUNS, enabled=True,
                        label="unrepaired train step").check(update)
            control = "bitwise in this run"
        except ParityViolation as e:
            pairs = zip(flatten_with_paths(update()),
                        flatten_with_paths(update()))
            differ = [p for (p, a), (_, b) in pairs
                      if torch.is_tensor(a) and not torch.equal(a, b)]
            control = f"{e}; the leaves two more runs differ in: {differ}"
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    impala_ms = {k: float(np.mean(v)) for k, v in impala_times.items()}
    plog(f"train step {list(batch['obs'].shape)} u8, bf16 compute, "
         f"ClippedRMSprop: bitwise over {PARITY_RUNS} runs ({leaves} "
         f"leaves: parameters, RMSprop's state, metrics) | step "
         f"ms (CUDA events, {PARITY_STEPS} steps a turn) with cuDNN's "
         f"deterministic algorithms {times['repaired']}, without "
         f"{times['unrepaired']}: {ms['repaired'] / ms['unrepaired']:.3f}x "
         f"| without, the step: {control} | launches {launches}", smi)
    plog(f"bench_torch.py's bf16 ImpalaNet step at B={BENCH_B} (ms, CUDA "
         f"events, {PARITY_STEPS // 2} steps a turn; state carried over): "
         f"with cuDNN's deterministic algorithms "
         f"{impala_times['repaired']}, without "
         f"{impala_times['unrepaired']}: "
         f"{impala_ms['repaired'] / impala_ms['unrepaired']:.3f}x", smi)
    return dict(runs=PARITY_RUNS, leaves=leaves, step_ms=ms,
                step_ms_turns=times, impala_step_ms=impala_ms,
                impala_step_ms_turns=impala_times, unrepaired=control,
                launches=launches)


def phase_chaos(smi) -> dict:
    """Phase 14: chaos and parity (see the module docstring)."""
    t0 = time.perf_counter()
    soak = _chaos_soak(smi)
    kill = _chaos_replica_kill(smi)
    kernels = _parity_kernels(smi)
    train = _parity_train(smi)
    launches = {"chaos replica kill": kill.pop("launches"),
                "parity kernels": kernels.pop("launches"),
                "parity train": train.pop("launches")}
    never = [k for k, n in launches["parity kernels"].items() if not n]
    if never or not (launches["parity train"]["flash_fwd"]
                     and launches["parity train"]["flash_bwd_tile"]):
        raise RuntimeError(f"parity: launches {launches}")
    seconds = time.perf_counter() - t0
    clog(f"phase took {seconds:.1f} s", smi)
    return dict(soak=soak, replica_kill=kill,
                parity=dict(kernels=kernels, train=train), seconds=seconds,
                launches=launches)


# ---------------------------------------------------------------------------
# Phase 15: multi-device
# ---------------------------------------------------------------------------

MD_CHILD_FLAG = "--md-child"
MD_DIR = os.path.join("build", "md")
MD_RANKS = 2
MD_CHILD_TIMEOUT_S = 420.0
# (a) runs in this process as a world of one over this backend.
MD_WORLD1_BACKEND = "nccl"
# The ring against the flash kernels at the context shape: o absolute,
# the gradients relative to each one's largest entry (f32 both sides:
# the folds' and the kernels' summation orders).
MD_SP_TOL = 1e-4
# The pipeline leg: the dry run's stage tanh(x @ w) at F=128.
MD_PP = dict(F=128, mb=64, n_micro=8)
# Pipelines against the sequential model (f32 matmuls, TF32 off): outputs
# and gradients relative to their largest entry; remat against stashing.
MD_PP_TOL, MD_REMAT_TOL = 1e-5, 1e-6
# The MoE width of the zoo phase's MoE TransformerNet (d_model 128,
# mlp_ratio 4, 8 experts, top-2, capacity factor 1.25) on the act's 128
# tokens and the context's 8192. The sharded FFN against moe_ffn on the
# same tokens and seats: relative to the output's largest entry (the
# expert matmuls batch [G, E_local, C, D] against [E, C, D]).
MD_MOE_TOL = 1e-5
MD_MOE_TOKENS = {"act": BATCH * ACT_ENVS, "context": BATCH * CONTEXT_T}


def mdlog(msg: str, smi: str, shared: bool = True) -> None:
    where = ("2 gloo ranks sharing one card, gloo's transport through the "
             "host: not an interconnect measurement") if shared else \
        "an NCCL world of one rank on one card: not an interconnect measurement"
    log(f"[md] {msg} ({where}; {smi})")


def _md_cfg():
    from moolib_tpu_torch import ImpalaConfig

    return ImpalaConfig(discounting=0.99, baseline_cost=0.5,
                        entropy_cost=0.0006, reward_clip=1.0)


def _md_optimizer(net):
    from moolib_tpu_torch import ClippedRMSprop

    return ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                          max_norm=40.0)


def _md_train_inputs():
    """Phase 6's full-width train step, from its seed: the model (bf16
    compute, the flash kernels) and its first learn batch [21, 32]."""
    from moolib_tpu_torch import TransformerNet

    gen = torch.Generator(device="cuda").manual_seed(2)
    net = TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                         attention_backend="auto", device="cuda",
                         generator=gen)
    return net, _learn_batches(gen, 1)[0]


def _md_serve_net(backend: str, mesh=None):
    """Phase 5's full-width model (seed 0) with ``backend``."""
    from moolib_tpu_torch import TransformerNet

    gen = torch.Generator(device="cuda").manual_seed(0)
    return TransformerNet(6, (84, 84, 4), compute_dtype=torch.bfloat16,
                          attention_backend=backend, mesh=mesh,
                          device="cuda", generator=gen).eval()


def _md_context_qkv():
    """q, k, v, dO [4, 4, 2048, 32] f32 and episode segment ids (a reset
    every 200 steps), from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    B, H, T, D = CONTEXT_SHAPE
    q, k, v, do = (torch.randn((B, H, T, D), generator=gen, device="cuda")
                   for _ in range(4))
    return q, k, v, do, episode_segments(gen, B, T)


def _md_context_obs():
    """A context batch [2048, 4, 84, 84, 4] u8 with resets, from a seed."""
    from moolib_tpu_torch.models import segment_ids_from_done

    gen = torch.Generator(device="cuda").manual_seed(16)
    B, T = BATCH, CONTEXT_T
    obs = torch.randint(0, 256, (T, B, 84, 84, 4), generator=gen,
                        device="cuda", dtype=torch.uint8)
    seg = episode_segments(gen, B, T)  # [B, T]
    done = torch.zeros((T, B), dtype=torch.bool, device="cuda")
    done[1:] = (seg[:, 1:] != seg[:, :-1]).T
    return obs, done, segment_ids_from_done(done)


def _md_act_obs():
    gen = torch.Generator(device="cuda").manual_seed(17)
    return torch.randint(0, 256, (1, BATCH * ACT_ENVS, 84, 84, 4),
                         generator=gen, device="cuda", dtype=torch.uint8)


def _md_pp_inputs():
    gen = torch.Generator(device="cuda").manual_seed(18)
    F, mb, n_micro = MD_PP["F"], MD_PP["mb"], MD_PP["n_micro"]
    stages = [{"w": torch.randn((F, F), generator=gen, device="cuda")
               * F ** -0.5} for _ in range(MD_RANKS)]
    x = torch.randn((n_micro, mb, F), generator=gen, device="cuda")
    return stages, x


def _md_stage(p, x):
    return torch.tanh(x @ p["w"])


def _md_moe_inputs():
    from moolib_tpu_torch.parallel.moe import moe_params

    gen = torch.Generator(device="cuda").manual_seed(19)
    params = moe_params(128, 512, 8, device="cuda", generator=gen)
    xs = {kind: torch.randn((n, 128), generator=gen, device="cuda")
          for kind, n in MD_MOE_TOKENS.items()}
    return params, xs


def _rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _md_world_of_one(smi) -> dict:
    """(a): the dp step on an NCCL world of one, bitwise against the
    plain step; the ring at sp=1 against the flash forward; the psum
    plane's note."""
    import torch.distributed as dist

    import bench_allreduce_torch
    from moolib_tpu_torch import make_impala_train_step, make_train_state
    from moolib_tpu_torch.ops import attention as attn_ops
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.ops.ring_attention import ring_attention
    from moolib_tpu_torch.parallel.mesh import make_mesh

    os.makedirs(MD_DIR, exist_ok=True)
    store = os.path.join(MD_DIR, "world1.store")
    if os.path.exists(store):
        os.remove(store)
    cfg = _md_cfg()
    net, batch = _md_train_inputs()
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    state = make_train_state(net, _md_optimizer(net))
    state, m_plain = make_impala_train_step(config=cfg)(state, batch)
    plain = ({n: p.detach().clone() for n, p in net.named_parameters()},
             {n: state.optimizer.state[p]["nu"].clone()
              for n, p in net.named_parameters()})
    dist.init_process_group(MD_WORLD1_BACKEND,
                            store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, 1, 1, 1, 1, device="cuda")
        net2, batch2 = _md_train_inputs()
        state2 = make_train_state(net2, _md_optimizer(net2))
        step = make_impala_train_step(config=cfg, mesh=mesh)
        torch.cuda.synchronize()
        for kern in KERNELS:
            kern.launches = 0
        state2, m_mesh = step(state2, batch2)
        torch.cuda.synchronize()
        dp_launches = {kern.name: kern.launches for kern in KERNELS}
        meshed = ({n: p.detach() for n, p in net2.named_parameters()},
                  {n: state2.optimizer.state[p]["nu"]
                   for n, p in net2.named_parameters()})
        unequal = [n for got, want in zip(meshed, plain) for n in want
                   if not torch.equal(got[n], want[n])]
        unequal += [k for k in m_plain if not torch.equal(m_mesh[k],
                                                          m_plain[k])]
        dp_ms = _md_warm_ms(lambda: step(state2, batch2))
        mdlog(f"(a) dp step on the mesh (1,1,1,1,1): {dp_ms:.3f} ms "
              f"(host clock, synchronized, a second step); against the "
              f"plain step: "
              f"{len(unequal)} of {2 * len(plain[0]) + len(m_plain)} "
              f"tensors differ (bitwise); launches {dp_launches}", smi,
              shared=False)
        if unequal:
            raise RuntimeError(f"the world-of-one dp step is not the plain "
                               f"step bit for bit: {unequal}")
        q, k, v, do, seg = _md_context_qkv()
        for kern in KERNELS:
            kern.launches = 0
        o_ring = ring_attention(q, k, v, mesh, "sp", causal=True,
                                segment_ids=seg)
        torch.cuda.synchronize()
        sp_launches = {kern.name: kern.launches for kern in KERNELS}
        sp_ms = _md_warm_ms(lambda: ring_attention(
            q, k, v, mesh, "sp", causal=True, segment_ids=seg))
        o_flash = attn_ops.flash_attention(q, k, v, causal=True,
                                           segment_ids=seg)
        sp_err = float((o_ring - o_flash).abs().max())
        mdlog(f"(a) ring_attention at sp=1, {list(q.shape)} f32 with "
              f"resets: {sp_ms:.3f} ms; max|ring - flash forward| "
              f"{sp_err:.3e} (tol {MD_SP_TOL}); launches {sp_launches}",
              smi, shared=False)
        if not sp_err <= MD_SP_TOL:
            raise RuntimeError(f"ring at sp=1 differs from the flash "
                               f"forward by {sp_err}")
        note = bench_allreduce_torch.bench_psum("nccl")
        if not (len(note) == 1 and "note" in note[0]):
            raise RuntimeError(f"the psum plane on one card: {note}")
    finally:
        dist.destroy_process_group()
    return dict(dp_ms=dp_ms, sp_ms=sp_ms, sp_err=sp_err, psum=note[0],
                before=before, plain=plain[0],
                launches={"md dp nccl": dp_launches,
                          "md sp nccl": sp_launches})


# -- (b): the children's legs ---------------------------------------------------


def _md_leg_dp(mesh) -> dict:
    from moolib_tpu_torch import make_impala_train_step, make_train_state

    net, batch = _md_train_inputs()
    state = make_train_state(net, _md_optimizer(net))
    step = make_impala_train_step(config=_md_cfg(), mesh=mesh)
    _md_reset()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    out = dict(**_md_reading(), params={n: p.detach().to("cpu", copy=True)
                                        for n, p in net.named_parameters()},
               metrics={k: float(v) for k, v in metrics.items()})
    out["ms"] = _md_warm_ms(lambda: step(state, batch))
    return out


def _md_warm_ms(fn) -> float:
    """Host milliseconds of a second call of ``fn``, synchronized (the
    first is the one compared: it pays for cuDNN's and cuBLAS's set-up)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _md_leg_sp(mesh) -> dict:
    from moolib_tpu_torch.ops.ring_attention import (ring_attention,
                                                     zigzag_sharded_attention)

    i = mesh.get_local_rank("sp")
    q, k, v, do, seg = _md_context_qkv()
    rows = slice(i * q.shape[2] // MD_RANKS, (i + 1) * q.shape[2] // MD_RANKS)
    out = {}

    def ring():
        ql, kl, vl = (x[:, :, rows].contiguous().requires_grad_()
                      for x in (q, k, v))
        o = ring_attention(ql, kl, vl, mesh, "sp", causal=True,
                           segment_ids=seg[:, rows])
        (o * do[:, :, rows]).sum().backward()
        return dict(o=o.detach().cpu(), dq=ql.grad.cpu(), dk=kl.grad.cpu(),
                    dv=vl.grad.cpu())

    def zigzag():
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        o = zigzag_sharded_attention(mesh, qg, kg, vg, segment_ids=seg)
        (o * do).sum().backward()
        return dict(o=o.detach().cpu(), dq=qg.grad.cpu(), dk=kg.grad.cpu(),
                    dv=vg.grad.cpu())

    for name, fn in (("ring", ring), ("zigzag", zigzag)):
        _md_reset()
        res = fn()
        out[name] = dict(**res, **_md_reading(), ms=_md_warm_ms(fn))
    obs, done, segs = _md_context_obs()
    T = obs.shape[0]
    pos = torch.arange(T, device="cuda")
    for backend in ("ring", "zigzag"):
        from moolib_tpu_torch.ops.ring_attention import zigzag_order

        order = (torch.as_tensor(zigzag_order(MD_RANKS, T), device="cuda")
                 if backend == "zigzag" else pos)
        mine = order[rows]  # this rank's global steps
        net = _md_serve_net(backend, mesh)

        @torch.no_grad()
        def forward():
            return net(obs[mine], done[mine], (), segment_ids=segs[:, mine],
                       positions=mine)[0]

        _md_reset()
        logits, baseline = forward()
        out[f"model {backend}"] = dict(
            steps=mine.cpu(), logits=logits.cpu(), baseline=baseline.cpu(),
            **_md_reading(), ms=_md_warm_ms(forward))
    return out


def _md_leg_tp(mesh) -> dict:
    from moolib_tpu_torch import make_impala_train_step, make_train_state
    from moolib_tpu_torch.parallel import tp as tp_ops
    from moolib_tpu_torch.parallel.mesh import local_value

    out = {}
    net = _md_serve_net("auto")
    specs = tp_ops.transformer_tp_specs(net)
    tp_ops.shard_params(mesh, net, specs)
    obs = _md_act_obs()
    done = torch.zeros(obs.shape[:2], dtype=torch.bool, device="cuda")

    @torch.no_grad()
    def forward():
        return net(obs, done, ())[0]

    _md_reset()
    logits, baseline = forward()
    out["forward"] = dict(logits=logits.cpu(), baseline=baseline.cpu(),
                          **_md_reading(), ms=_md_warm_ms(forward))
    net, batch = _md_train_inputs()
    tp_ops.shard_params(mesh, net, specs)
    opt = _md_optimizer(net)
    tp_ops.sharded_init_opt_state(opt, net)
    state = make_train_state(net, opt)
    step = make_impala_train_step(config=_md_cfg(), mesh=mesh)
    _md_reset()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    out["train"] = dict(params={n: local_value(p).detach().to(
                                    "cpu", copy=True)
                                for n, p in net.named_parameters()},
                        dims={n: s.dim for n, s in specs.items()
                              if s.is_shard()},
                        tp=mesh.get_local_rank("tp"), **_md_reading())
    out["train"]["ms"] = _md_warm_ms(lambda: step(state, batch))
    return out


def _md_leg_pp(mesh) -> dict:
    from moolib_tpu_torch.parallel import pipeline
    from moolib_tpu_torch.parallel.mesh import shard_batch

    stages, x = _md_pp_inputs()
    d = mesh.get_local_rank("pp")
    out = {"pp": d}
    stacked = pipeline.stack_stage_params(stages)
    local = shard_batch(mesh, pipeline.shard_microbatches(x, MD_RANKS),
                        axis_name="pp").contiguous()
    def gpipe(remat):
        mine = {k: v.clone().requires_grad_() for k, v in
                pipeline.stage_slice(stacked, mesh).items()}
        y = pipeline.pipeline_apply(_md_stage, mine, local, mesh,
                                    remat=remat)
        torch.sum(y ** 2).backward()
        return dict(y=y.detach().cpu(), grad=mine["w"].grad.cpu())

    def f1b():
        loss, grads = pipeline.pipeline_train_1f1b(
            _md_stage, lambda y: torch.sum(y ** 2),
            pipeline.stage_slice(stacked, mesh), x, mesh)
        return dict(loss=float(loss), grad=grads["w"].cpu())

    # Warm every path (cuBLAS's workspace, the process group's pairs)
    # before the peaks are read.
    gpipe(False)
    for name, fn in (("gpipe", lambda: gpipe(False)),
                     ("remat", lambda: gpipe(True)), ("1f1b", f1b)):
        _md_reset()
        res = fn()
        out[name] = dict(**res, **_md_reading(), ms=_md_warm_ms(fn))
    return out


def _md_leg_ep(mesh) -> dict:
    from moolib_tpu_torch.parallel.moe import moe_ffn_sharded

    params, xs = _md_moe_inputs()
    g = mesh.get_local_rank("ep")
    local = {"router": params["router"],
             "w_up": params["w_up"].chunk(MD_RANKS)[g],
             "w_down": params["w_down"].chunk(MD_RANKS)[g]}
    out = {"ep": g}
    for kind, x in xs.items():
        xl = x.chunk(MD_RANKS)[g]
        for cap_name, cap in (("default", None), ("no drops", xl.shape[0])):
            @torch.no_grad()
            def ffn(xl=xl, cap=cap):
                return moe_ffn_sharded(local, xl, cap, mesh=mesh, top_k=2,
                                       capacity_factor=1.25)

            _md_reset()
            y, aux = ffn()
            out[f"{kind} {cap_name}"] = dict(
                y=y.cpu(), drop=float(aux["drop_fraction"]),
                **_md_reading(), ms=_md_warm_ms(ffn))
    return out


def _md_reset() -> None:
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.parallel import collectives

    torch.cuda.synchronize()
    for kern in KERNELS:
        kern.launches = 0
    collectives.TRAFFIC.sent = 0
    torch.cuda.reset_peak_memory_stats()


def _md_reading() -> dict:
    """Launches, bytes handed to the collectives and peak card memory
    since :func:`_md_reset`."""
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.parallel import collectives

    return dict(launches={kern.name: kern.launches for kern in KERNELS},
                bytes=collectives.TRAFFIC.sent,
                peak=torch.cuda.max_memory_allocated())


MD_LEGS = (("dp", dict(dp=2), _md_leg_dp), ("sp", dict(dp=1, sp=2),
                                              _md_leg_sp),
           ("tp", dict(dp=1, tp=2), _md_leg_tp),
           ("pp", dict(dp=1, pp=2), _md_leg_pp),
           ("ep", dict(dp=1, ep=2), _md_leg_ep))


def md_child(rank: str, store: str) -> int:
    """One rank of phase 15 (b) (``chip_smoke.py --md-child RANK STORE``):
    a gloo world of MD_RANKS processes sharing the card; runs every leg
    and saves its results to MD_DIR/rank{RANK}.pt for the parent."""
    import torch.distributed as dist

    from moolib_tpu_torch.parallel.mesh import make_mesh

    rank = int(rank)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, MD_RANKS),
                            rank=rank, world_size=MD_RANKS)
    try:
        out = {}
        for name, shape, leg in MD_LEGS:
            out[name] = leg(make_mesh(**shape, device="cuda"))
            log(f"md child {rank}: leg {name} done")
        torch.save(out, os.path.join(MD_DIR, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _md_children(smi) -> list:
    """Start the MD_RANKS children together; every one must exit 0."""
    store = os.path.join(MD_DIR, "world2.store")
    for path in [store] + [os.path.join(MD_DIR, f"rank{r}.pt")
                           for r in range(MD_RANKS)]:
        if os.path.exists(path):
            os.remove(path)
    logs = [open(os.path.join(MD_DIR, f"child{r}.log"), "w")
            for r in range(MD_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               MD_CHILD_FLAG, str(r), store],
                              stdout=f, stderr=subprocess.STDOUT)
             for r, f in enumerate(logs)]
    deadline = time.monotonic() + MD_CHILD_TIMEOUT_S
    try:
        for r, p in enumerate(procs):
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if rc != 0:
                raise RuntimeError(f"md child {r} exited {rc}")
    except (RuntimeError, subprocess.TimeoutExpired):
        for f in logs:
            f.flush()
        for r in range(MD_RANKS):
            with open(os.path.join(MD_DIR, f"child{r}.log")) as f:
                log(f"[md] child {r} log tail:\n{f.read()[-4000:]}")
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return [torch.load(os.path.join(MD_DIR, f"rank{r}.pt"),
                       weights_only=False) for r in range(MD_RANKS)]


def _delta_errs(got, before, want) -> dict:
    """Per parameter: the step's change against the reference's, relative
    to the reference change's largest entry."""
    return {n: _rel(got[n] - before[n].cpu(), want[n].cpu() - before[n].cpu())
            for n in want}


def _check_deltas(errs: dict, what: str) -> float:
    bad = {n: e for n, e in errs.items()
           if not e <= BF16_GRAD_TOL.get(n, TRAIN_GRAD_TOL)}
    if bad:
        raise RuntimeError(f"{what}: parameter changes differ: {bad}")
    return max(e for n, e in errs.items() if n not in BF16_GRAD_TOL)


def _md_check(outs, one, smi) -> dict:
    """Hold the children's results against the card's references."""
    from moolib_tpu_torch.ops import attention as attn_ops
    from moolib_tpu_torch.parallel.moe import moe_ffn

    report = {}
    # dp=2: against (a)'s plain step; the ranks bit for bit.
    errs = _delta_errs(outs[0]["dp"]["params"], one["before"], one["plain"])
    worst = _check_deltas(errs, "dp=2 step")
    same = all(torch.equal(outs[0]["dp"]["params"][n],
                           outs[1]["dp"]["params"][n])
               for n in outs[0]["dp"]["params"])
    if not same:
        raise RuntimeError("dp=2: the two ranks' parameters differ")
    report["dp"] = dict(delta_err=worst, pos_emb_err=errs["pos_emb.weight"],
                        ranks_bitwise=same)
    mdlog(f"dp=2 train step on halves of [21, 32]: parameter changes vs "
          f"the plain step max rel {worst:.3e} (tol {TRAIN_GRAD_TOL}), "
          f"pos_emb {errs['pos_emb.weight']:.3e} (tol "
          f"{BF16_GRAD_TOL['pos_emb.weight']:.3e}); ranks bitwise equal "
          f"{same}", smi)

    # sp=2: the ring and zigzag against the flash forward and backward.
    q, k, v, do, seg = _md_context_qkv()
    qf, kf, vf = (x.clone().requires_grad_() for x in (q, k, v))
    o = attn_ops.flash_attention(qf, kf, vf, causal=True, segment_ids=seg)
    (o * do).sum().backward()
    ref = dict(o=o.detach().cpu(), dq=qf.grad.cpu(), dk=kf.grad.cpu(),
               dv=vf.grad.cpu())
    ring = {key: torch.cat([outs[r]["sp"]["ring"][key]
                            for r in range(MD_RANKS)], dim=2)
            for key in ref}
    sp = {}
    for name, got in (("ring", ring), ("zigzag", outs[0]["sp"]["zigzag"])):
        e = dict(o=float((got["o"] - ref["o"]).abs().max()),
                 **{g: _rel(got[g], ref[g]) for g in ("dq", "dk", "dv")})
        sp[name] = e
        mdlog(f"sp=2 {name} at {list(CONTEXT_SHAPE)} f32 with resets vs "
              f"flash: o {e['o']:.3e}, dq {e['dq']:.3e}, dk {e['dk']:.3e}, "
              f"dv {e['dv']:.3e} of max (tol {MD_SP_TOL})", smi)
        if not max(e.values()) <= MD_SP_TOL:
            raise RuntimeError(f"sp=2 {name}: {e}")
    obs, done, segs = _md_context_obs()
    flash = _md_serve_net("auto")
    with torch.no_grad():
        (l_ref, b_ref), _ = flash(obs, done, (), segment_ids=segs)
    for backend in ("ring", "zigzag"):
        logits = torch.zeros_like(l_ref, device="cpu")
        baseline = torch.zeros_like(b_ref, device="cpu")
        for r in range(MD_RANKS):
            got = outs[r]["sp"][f"model {backend}"]
            logits[got["steps"]] = got["logits"]
            baseline[got["steps"]] = got["baseline"]
        err = max(float((logits - l_ref.cpu()).abs().max()),
                  float((baseline - b_ref.cpu()).abs().max()))
        sp[f"model {backend}"] = err
        mdlog(f"sp=2 TransformerNet({backend!r}) forward at the context "
              f"shape [{CONTEXT_T}, {BATCH}] vs the flash model: max err "
              f"{err:.3e} (tol {SERVE_TOL})", smi)
        if not err <= SERVE_TOL:
            raise RuntimeError(f"the {backend} model differs: {err}")
    report["sp"] = sp

    # tp=2: the act forward against tp=1, the train step against (a)'s.
    with torch.no_grad():
        obs = _md_act_obs()
        (l_ref, b_ref), _ = _md_serve_net("auto")(
            obs, torch.zeros(obs.shape[:2], dtype=torch.bool,
                             device="cuda"), ())
    fwd = max(max(float((outs[r]["tp"]["forward"]["logits"]
                         - l_ref.cpu()).abs().max()),
                  float((outs[r]["tp"]["forward"]["baseline"]
                         - b_ref.cpu()).abs().max()))
              for r in range(MD_RANKS))
    by_tp = {outs[r]["tp"]["train"]["tp"]: outs[r]["tp"]["train"]
             for r in range(MD_RANKS)}
    dims = by_tp[0]["dims"]
    params = {n: (torch.cat([by_tp[t]["params"][n] for t in range(MD_RANKS)],
                            dim=dims[n]) if n in dims
                  else by_tp[0]["params"][n]) for n in by_tp[0]["params"]}
    errs = _delta_errs(params, one["before"], one["plain"])
    worst = _check_deltas(errs, "tp=2 step")
    report["tp"] = dict(forward_err=fwd, delta_err=worst)
    mdlog(f"tp=2 forward at the act shape {list(obs.shape[:2])} vs tp=1: "
          f"max err {fwd:.3e} (tol {SERVE_TOL}); train step parameter "
          f"changes vs tp=1 max rel {worst:.3e} (tol {TRAIN_GRAD_TOL})", smi)
    if not fwd <= SERVE_TOL:
        raise RuntimeError(f"tp=2 forward differs: {fwd}")

    # pp=2: against the sequential model.
    stages, x = _md_pp_inputs()
    ws = [s["w"].clone().requires_grad_() for s in stages]
    y = x
    for w in ws:
        y = _md_stage({"w": w}, y)
    loss = torch.sum(y ** 2)
    loss.backward()
    n_micro, F = MD_PP["n_micro"], MD_PP["F"]
    by_pp = {outs[r]["pp"]["pp"]: outs[r]["pp"] for r in range(MD_RANKS)}
    pp = {}
    for kind in ("gpipe", "remat"):
        sharded = torch.cat([by_pp[d][kind]["y"] for d in range(MD_RANKS)],
                            dim=1)
        e_y = _rel(sharded.reshape(n_micro, -1, F), y.detach())
        e_g = max(_rel(by_pp[d][kind]["grad"][0], ws[d].grad)
                  for d in range(MD_RANKS))
        pp[kind] = dict(y=e_y, grad=e_g)
    remat_err = max(_rel(by_pp[d]["remat"]["grad"], by_pp[d]["gpipe"]["grad"])
                    for d in range(MD_RANKS))
    loss = float(loss.detach())
    e_loss = abs(by_pp[0]["1f1b"]["loss"] - loss) / loss
    e_g = max(_rel(by_pp[d]["1f1b"]["grad"][0], ws[d].grad)
              for d in range(MD_RANKS))
    pp["1f1b"] = dict(loss=e_loss, grad=e_g)
    pp["remat_vs_gpipe"] = remat_err
    peaks = {kind: [by_pp[d][kind]["peak"] for d in range(MD_RANKS)]
             for kind in ("gpipe", "remat", "1f1b")}
    pp["peak_bytes"] = peaks
    mdlog(f"pp=2 at F={F}, {n_micro} microbatches of {MD_PP['mb']}: gpipe "
          f"y {pp['gpipe']['y']:.3e} grad {pp['gpipe']['grad']:.3e}, remat "
          f"y {pp['remat']['y']:.3e} grad {pp['remat']['grad']:.3e}, 1f1b "
          f"loss {e_loss:.3e} grad {e_g:.3e} of max (tol {MD_PP_TOL}); remat "
          f"vs stashing {remat_err:.3e} (tol {MD_REMAT_TOL}); peak card "
          f"bytes per rank {peaks}", smi)
    if max(pp["gpipe"]["y"], pp["gpipe"]["grad"], pp["remat"]["y"],
           pp["remat"]["grad"], e_loss, e_g) > MD_PP_TOL \
            or remat_err > MD_REMAT_TOL:
        raise RuntimeError(f"pp=2: {pp}")
    report["pp"] = pp

    # ep=2: against moe_ffn on each rank's tokens at its seats, and on
    # all the tokens where nothing drops.
    params, xs = _md_moe_inputs()
    by_ep = {outs[r]["ep"]["ep"]: outs[r]["ep"] for r in range(MD_RANKS)}
    ep = {}
    with torch.no_grad():
        for kind, x in xs.items():
            n_local = x.shape[0] // MD_RANKS
            cap = math.ceil(1.25 * n_local * 2 / 8)
            groups = [moe_ffn(params, xl, min(cap, n_local), top_k=2)[0]
                      for xl in x.chunk(MD_RANKS)]
            got = torch.cat([by_ep[g][f"{kind} default"]["y"]
                             for g in range(MD_RANKS)])
            e_default = _rel(got, torch.cat(groups))
            full, _ = moe_ffn(params, x, x.shape[0], top_k=2)
            got = torch.cat([by_ep[g][f"{kind} no drops"]["y"]
                             for g in range(MD_RANKS)])
            e_full = _rel(got, full)
            drop = by_ep[0][f"{kind} default"]["drop"]
            ep[kind] = dict(default=e_default, no_drops=e_full, drop=drop)
            mdlog(f"ep=2 moe_ffn_sharded at 128->512->128, 8 experts, "
                  f"top-2 on the {kind}'s {x.shape[0]} tokens: group seats "
                  f"(cf 1.25, drop fraction {drop:.4f}) vs moe_ffn per "
                  f"group {e_default:.3e}, no drops vs moe_ffn on all "
                  f"{e_full:.3e} of max (tol {MD_MOE_TOL})", smi)
            if max(e_default, e_full) > MD_MOE_TOL:
                raise RuntimeError(f"ep=2 {kind}: {ep[kind]}")
    report["ep"] = ep
    return report


def phase_md(smi) -> dict:
    """Phase 15: multi-device (see the module docstring)."""
    t0 = time.perf_counter()
    one = _md_world_of_one(smi)
    t1 = time.perf_counter()
    outs = _md_children(smi)
    t2 = time.perf_counter()
    report = _md_check(outs, one, smi)
    launches = dict(one["launches"])
    timing = {}
    for name, _, _ in MD_LEGS:
        parts = {}
        for r, out in enumerate(outs):
            leg = out[name]
            items = [("", leg)] if "ms" in leg else [
                (k, v) for k, v in leg.items() if isinstance(v, dict)]
            for sub, rd in items:
                key = f"{name} {sub}".strip()
                parts.setdefault(key, []).append(
                    dict(rank=r, ms=rd["ms"], bytes=rd["bytes"],
                         peak=rd["peak"]))
                counts = launches.setdefault(f"md {name}", {})
                for kname, n in rd["launches"].items():
                    counts[kname] = counts.get(kname, 0) + n
        timing.update(parts)
    for key, rows in timing.items():
        mdlog(f"{key}: " + "; ".join(
            f"rank {p['rank']} {p['ms']:.3f} ms, {p['bytes']} bytes to the "
            f"collectives, peak {p['peak'] / 2**20:.1f} MiB" for p in rows),
            smi)
    dp = launches["md dp"]
    if not (dp["flash_fwd"] and dp["flash_bwd_tile"]):
        raise RuntimeError(f"md dp: the flash kernels did not launch: {dp}")
    mdlog(f"launches {launches}; (a) {t1 - t0:.1f} s, children "
          f"{t2 - t1:.1f} s, checks {time.perf_counter() - t2:.1f} s", smi)
    return dict(world_of_one={k: one[k] for k in ("dp_ms", "sp_ms",
                                                   "sp_err", "psum")},
                checks=report, legs=timing,
                seconds=time.perf_counter() - t0, launches=launches)


# ---------------------------------------------------------------------------
# Phase 15b: the experiment's data-parallel learner (train(devices=...))
# ---------------------------------------------------------------------------

DP_DEVICES = ["cuda:0", "cuda:0"]  # dp = 2 over gloo, the ranks share the card
DP_SECONDS = 10.0                  # train()'s run


def dplog(msg: str, smi: str) -> None:
    log(f"[dp] {msg} | the ranks share one card, gloo through the host: no "
        f"figure here is an interconnect figure | card: {smi}")


def _dp_cfg(**kw):
    from moolib_tpu_torch.examples.vtrace import experiment

    return experiment.VtraceConfig(env="synthetic", model="transformer",
                                   seed=0, **kw)


def _dp_grad_check(plain, plain_step, grads, model, batch) -> dict:
    """(a) rank 0's dp-mean gradients of one GRAD against the dp=1 grad
    step (``plain``'s learner) on the same learn batch and parameters."""
    from moolib_tpu_torch.ops import stage_batch

    plain.model.load_state_dict(model.state_dict())
    want, _ = plain_step(plain.model, stage_batch(batch, "cuda:0"))
    errs = {n: _rel(grads[n], want[n]) for n in want}
    return dict(
        bad={n: e for n, e in errs.items()
             if not e <= BF16_GRAD_TOL.get(n, TRAIN_GRAD_TOL)},
        grad_err=max(e for n, e in errs.items() if n not in BF16_GRAD_TOL),
        pos_emb_err=errs["pos_emb.weight"],
        shape=list(batch["obs"].shape[:2]))


def _dp_recording_class(plain, plain_step):
    """A LocalDP that keeps every world it makes and holds the first GRAD
    sent on it against the dp=1 grad step (:func:`_dp_grad_check`); rank
    0's launches in that check (the dp=1 step's) are taken back out of
    its counts. The follower runs nothing but the world's commands."""
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.parallel.local_dp import LocalDP

    class Recording(LocalDP):
        made: list = []
        check: dict = {}

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            Recording.made.append(self)

        def grad(self, grad_step, model, batch, reuse=False):
            grads, metrics = super().grad(grad_step, model, batch, reuse)
            if not Recording.check:
                counts = {kern: kern.launches for kern in KERNELS}
                try:
                    Recording.check.update(_dp_grad_check(
                        plain, plain_step, grads, model, batch))
                finally:
                    for kern, n in counts.items():
                        kern.launches = n
            return grads, metrics

    return Recording


def phase_dp_train(smi, dp1: dict) -> dict:
    """Phase 15b: the experiment's data-parallel learner (see the module
    docstring); ``dp1`` is phase 11's no-savedir loop (its rates)."""
    from moolib_tpu_torch.examples.vtrace import experiment
    from moolib_tpu_torch.ops._kernels import KERNELS
    from moolib_tpu_torch.parallel import local_dp

    t0 = time.perf_counter()
    cfg = _dp_cfg(max_seconds=DP_SECONDS, log_interval_steps=1280,
                  stats_interval=2.0)
    _, plain, plain_step, _ = experiment._learner(cfg, "cuda:0")
    recording = _dp_recording_class(plain, plain_step)
    saved = local_dp.LocalDP
    local_dp.LocalDP = recording
    for kern in KERNELS:
        kern.launches = 0
    lines = []
    try:
        t1 = time.perf_counter()
        rows = experiment.train(cfg, log_fn=lines.append,
                                devices=DP_DEVICES)
        wall = time.perf_counter() - t1
    finally:
        local_dp.LocalDP = saved
    rank0 = {kern.name: kern.launches for kern in KERNELS}
    for line in lines:
        log(f"[dp] train: {line}")
    (world,) = recording.made
    (report,) = world.reports
    check = recording.check
    if not check:
        raise RuntimeError("the dp loop sent no GRAD")
    dplog(f"(a) train()'s first GRAD at dp=2 against the dp=1 grad step "
          f"on the same learn batch {check['shape']} and parameters: "
          f"largest gradient error {check['grad_err']:.3e} of its tensor's "
          f"max (tolerance {TRAIN_GRAD_TOL:g}; pos_emb "
          f"{check['pos_emb_err']:.3e}, tolerance "
          f"{BF16_GRAD_TOL['pos_emb.weight']:g})", smi)
    if check["bad"]:
        raise RuntimeError(f"dp GRAD: gradients off {check['bad']}")
    check = {k: check[k] for k in ("grad_err", "pos_emb_err")}
    rank1 = report["launches"]
    if len(rows) < 2:
        raise RuntimeError(f"the dp loop logged {len(rows)} rows")
    rates = _rates(rows)
    # A window without a local gradient step logs a NaN loss (an empty
    # mean); every other must be finite.
    losses = [r["total_loss"] for r in rows if r["grad_steps"]]
    updates = len(world.send_ms["APPLY"])  # the last row may lag the end
    sends = {cmd: dict(n=len(v), median_ms=float(np.median(v)),
                       max_ms=max(v))
             for cmd, v in world.send_ms.items() if v}
    dplog(f"(b) train(model=transformer, bf16, 32 envs, T={UNROLL}, learn "
          f"batch {LEARN_B}, devices={DP_DEVICES}) for {DP_SECONDS:g} s: "
          f"dp {world.dp} over {world.backend}, {len(rows)} rows in "
          f"{wall:.1f} s (the world up in {world.start_s:.1f} s: spawn, "
          f"rendezvous, the follower's learner built); "
          f"{rates['env_steps_per_s']:.1f} env-steps/s, "
          f"{rates['updates_per_s']:.2f} updates/s (first to last row) "
          f"beside phase 11's dp=1 loop without a savedir in this run: "
          f"{dp1['env_steps_per_s']:.1f} env-steps/s, "
          f"{dp1['updates_per_s']:.2f} updates/s; {updates} updates, the "
          f"follower's {report['updates']}", smi)
    dplog("(b) command sends, host ms (header and payload; n, median, max): "
          + "; ".join(f"{cmd} {d['n']}, {d['median_ms']:.3f}, "
                      f"{d['max_ms']:.3f}" for cmd, d in sends.items()), smi)
    dplog(f"(b) launches: rank 0 {rank0}, rank 1 {rank1}; the ranks' "
          f"parameter checksums differ by {world.checksum_diff}; phase "
          f"{time.perf_counter() - t0:.1f} s", smi)
    if updates < 3 or not losses or not all(np.isfinite(losses)):
        raise RuntimeError(f"the dp loop made {updates} updates, losses "
                           f"{losses}")
    if report["updates"] != updates or world.checksum_diff != 0:
        raise RuntimeError(f"the dp ranks diverged: follower updates "
                           f"{report['updates']} of {updates}, checksums "
                           f"differ by {world.checksum_diff}")
    for name, counts in (("rank 0", rank0), ("rank 1", rank1)):
        if not (counts.get("flash_fwd") and counts.get("flash_bwd_tile")):
            raise RuntimeError(f"dp train: {name} did not launch the flash "
                               f"kernels: {counts}")
    return dict(check, updates=updates, **rates, dp1=dp1, sends=sends,
                wall_s=wall, start_s=world.start_s,
                checksum_diff=world.checksum_diff,
                ranks={"0": rank0, "1": rank1},
                seconds=time.perf_counter() - t0,
                launches={"dp train": {k: rank0.get(k, 0) + rank1.get(k, 0)
                                       for k in rank0}})


# ---------------------------------------------------------------------------
# Phase 16: perfwatch
# ---------------------------------------------------------------------------

PERF_ATTN_BUDGET_S = 60.0  # attn_bench --budget: its rows stop past it
PERF_D128_REPS = 20        # kernel launches a timing (CUDA events, profiler)
PERF_LIB_TAKES = 3         # profiler traces of SDPA a reading, the highest kept
BSF_RANGE = (32, 4096)     # find_batch_size's envs over the act step
PERF_SWEEP = (256, "bf16")  # perf_sweep's one config
TELEMETRY_BUDGET = 0.05


def pflog(msg: str, smi: str) -> None:
    """A [perf] line, with the card's name and power limit."""
    log(f"[perf] {msg} | card: {smi}")


def _kernel_counts() -> dict:
    from moolib_tpu_torch.ops._kernels import KERNELS

    return {kern.name: kern.launches for kern in KERNELS}


def _reset_counts() -> None:
    from moolib_tpu_torch.ops._kernels import KERNELS

    for kern in KERNELS:
        kern.launches = 0


def _perf_attn(store: str, smi: str) -> dict:
    """(a) attn_bench's validation and full rows on the card; its trend
    rows go to ``store``."""
    from moolib_tpu_torch.tools import attn_bench

    PERF_TS = attn_bench.SEQ_LENS
    prev = os.environ.get("MOOLIB_TRENDS")
    os.environ["MOOLIB_TRENDS"] = store
    _reset_counts()
    try:
        art = attn_bench.run(budget=PERF_ATTN_BUDGET_S, device="cuda",
                             log=lambda s: pflog(f"attn_bench {s}", smi))
    finally:
        if prev is None:
            os.environ.pop("MOOLIB_TRENDS", None)
        else:
            os.environ["MOOLIB_TRENDS"] = prev
    launches = _kernel_counts()
    v = art["flash_validation"]
    timed = {(r["backend"], r["T"]) for r in art["rows"] if "ms_per_step" in r}
    want = {(b, T) for b in ("dense", "blockwise", "flash") for T in PERF_TS
            if b != "dense" or T <= 4096}  # dense: T <= 4096, as the tool
    if not v["ok"] or v["shape"][3] != 128 or art["dtype"] != "bfloat16":
        raise RuntimeError(f"attn_bench validation failed: {v}")
    if want - timed:
        raise RuntimeError(f"attn_bench gave no rows for {sorted(want - timed)}"
                           f": {art['rows']}")
    if not all(launches[k] for k in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkdv")):
        raise RuntimeError(f"attn_bench: a flash kernel did not launch: "
                           f"{launches}")
    pflog(f"attn_bench validation at {v['shape']} bf16: fwd {v['max_err_fwd']:.3e} "
          f"(tol {v['tol_fwd']}), bwd {v['max_err_bwd']:.3e} (tol "
          f"{v['tol_bwd']}); {art.get('flash_vs_blockwise')}; launches "
          f"{launches}; {art['seconds']} s", smi)
    return dict(artifact=art, launches=launches)


def _perf_d128(smi: str) -> dict:
    """attn_bench's kernels at its shapes, [1, 8, T, 128] bf16 causal with
    no segments, against their plain versions (phases 3-4's tolerances)
    with the kernel's, plain's and SDPA's times (is_causal: the same
    function) and the card's bound. Launches here are not counted."""
    from moolib_tpu_torch.ops import _kernels
    from moolib_tpu_torch.tools.attn_bench import SEQ_LENS, SHAPE
    from moolib_tpu_torch.ops.attention import (
        _flash_backward_plain,
        _flash_delta,
        _flash_forward_plain,
    )

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(16)
    bf16_tol = lambda ref: 2.0 ** -7 * ref + 1e-5  # noqa: E731
    out = {}
    for T in SEQ_LENS:
        shape = (SHAPE[0], SHAPE[1], T, SHAPE[2])
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        seg = torch.zeros((1, T), dtype=torch.int32, device="cuda")
        o, lse = _kernels.flash_fwd(q, k, v, seg, seg, True)
        o_ref, lse_ref = _flash_forward_plain(q, k, v, seg, seg, True)
        o_err, lse_err, ok = _compare(o, lse, o_ref, lse_ref, bf16_tol)
        del o_ref, lse_ref
        delta = _flash_delta(o, do)
        got = (_kernels.flash_bwd_dq(q, k, v, seg, seg, lse, delta, do, True),
               *_kernels.flash_bwd_dkdv(q, k, v, seg, seg, lse, delta, do,
                                        True))
        want = _flash_backward_plain(q, k, v, seg, seg, o, lse, do, True)
        errs = {}
        for gname, g, ref in zip(("dq", "dk", "dv"), got, want):
            ref = ref.float()
            tol = 1e-4 * float(ref.abs().max()) + 2.0 ** -7 * ref.abs()
            err = (g.float() - ref).abs()
            ok &= bool((err <= tol).all())
            errs[gname] = float(err.max())
        del got, want
        ok &= lse_err <= 1e-4
        pflog(f"D=128 {shape} bf16 causal vs plain: max|o| err {o_err:.3e} "
              f"(2^-7*|o|+1e-5), lse {lse_err:.3e} (1e-4), " + ", ".join(
                  f"{g} {e:.3e}" for g, e in errs.items())
              + f" (1e-4 of max + 2^-7*|ref|) | {'ok' if ok else 'FAIL'}", smi)
        if not ok:
            raise RuntimeError(f"a flash kernel disagrees with plain at {shape}")

        def fwd():
            return _kernels.flash_fwd(q, k, v, seg, seg, True)

        def dq_fn():
            return _kernels.flash_bwd_dq(q, k, v, seg, seg, lse, delta, do,
                                         True)

        def dkdv_fn():
            return _kernels.flash_bwd_dkdv(q, k, v, seg, seg, lse, delta, do,
                                           True)

        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = sdpa(qg, kg, vg, is_causal=True)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                       retain_graph=True)

        fwd_bound = flash_bound_ms(q, k, seg, seg, True)
        bwd_bounds = flash_bwd_bounds_ms(q, k, seg, seg, True)
        plain_fwd = cuda_ms(lambda: _flash_forward_plain(
            q, k, v, seg, seg, True), 2, warmup=1)
        plain_bwd = cuda_ms(lambda: _flash_backward_plain(
            q, k, v, seg, seg, o, lse, do, True), 2, warmup=1)
        lib_fwd = lambda: sdpa(q, k, v, is_causal=True)  # noqa: E731
        rows = {}
        for kname, fn, filt, plain, lib, bound, err in (
            ("flash_fwd", fwd, "flash_fwd_", plain_fwd, lib_fwd, fwd_bound,
             max(o_err, lse_err)),
            ("flash_bwd_dq", dq_fn, "flash_bwd_dq_kernel", plain_bwd,
             lib_bwd, bwd_bounds["flash_bwd_dq"], errs["dq"]),
            ("flash_bwd_dkdv", dkdv_fn, "flash_bwd_dkdv_kernel", plain_bwd,
             lib_bwd, bwd_bounds["flash_bwd_dkdv"], max(errs["dk"],
                                                        errs["dv"])),
        ):
            dev = device_ms(fn, filt, PERF_D128_REPS, floor_ms=bound[0])
            # SDPA's backward does dQ, dK and dV: the fused kernel's bound.
            lib_floor = (fwd_bound[0] if lib is lib_fwd else
                         bwd_bounds["flash_bwd_tile"][0])
            lib_dev = device_ms(lib, None, PERF_D128_REPS, floor_ms=lib_floor,
                                takes=PERF_LIB_TAKES)
            if dev is None:
                raise RuntimeError(f"no profiler device time for {kname} at "
                                   f"{shape}")
            rows[kname] = dict(
                shape=list(shape), ms=cuda_ms(fn, PERF_D128_REPS),
                device_ms=dev, plain_ms=plain,
                library_ms=cuda_ms(lib, PERF_D128_REPS),
                library_device_ms=lib_dev, bound_ms=bound[0],
                bound_by=bound[1], max_abs_err=err,
                design=_kernels.flash_fwd_design(T, T) if kname == "flash_fwd"
                else _kernels.flash_bwd_design(T, T))
            pflog(f"{kname} {shape} bf16 causal: device {dev:.4f} ms (events "
                  f"{rows[kname]['ms']:.4f}), bound {bound[0]:.4f} ms "
                  f"({bound[1]}), device/bound {dev / bound[0]:.2f}x, plain "
                  f"{plain:.3f} ms, sdpa{' bwd' if lib is lib_bwd else ''} "
                  + (f"{lib_dev:.4f} ms device" if lib_dev is not None else
                     f"device not measured (every trace read below its bound "
                     f"{lib_floor:.4f} ms)")
                  + f" ({rows[kname]['library_ms']:.4f} events)", smi)
        out[T] = rows
        del qg, kg, vg, lib_out
        torch.cuda.empty_cache()
    return out


def _perf_suite(store: str, smi: str) -> dict:
    """(b)+(c) the suite through the perf CLI in a child process (its
    EnvPool workers import the light CLI, not this script), on the card,
    its rows appended to ``store`` and gated there; then the whole-store
    gate over what (a), (b) and (g) wrote, and the same gate over a copy
    with a planted regression, which must fail."""
    from moolib_tpu_torch.bench import BenchResult, append_trend, load_trends

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "moolib_tpu_torch.tools.perf", "--suite",
         "cpu-proxy", "--smoke", "--trends", store],
        capture_output=True, text=True, timeout=600,
    )
    suite_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith(("  ", "NULL", "BUDGET", "REGRESSION")):
            pflog(f"suite {line.strip()}", smi)
    if proc.returncode != 0:
        raise RuntimeError(f"perf --suite cpu-proxy --smoke exited "
                           f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = {r.metric: r for r in load_trends(store) if r.suite == "cpu-proxy"}
    if len(rows) != 15 or any(r.value is None for r in rows.values()):
        raise RuntimeError(f"suite rows: {sorted(rows)}")
    e2e = rows["e2e_learner_step_s"].extra
    if e2e["steady_d2h"] != 0 or e2e["compile_delta"] != 0:
        raise RuntimeError(f"e2e_learner_step_s: {e2e}")
    launches = summary["kernel_launches"] or {k: 0 for k in _kernel_counts()}
    if any(launches.values()):
        raise RuntimeError(f"the suite launched a flash kernel: {launches}")

    def gate(path):
        return subprocess.run(
            [sys.executable, "-m", "moolib_tpu_torch.tools.perf",
             "--check-trends", "--trends", path],
            capture_output=True, text=True, timeout=120)

    clean = gate(store)
    n_rows = len(load_trends(store))
    if clean.returncode != 0:
        raise RuntimeError(f"--check-trends failed on the card's rows:\n"
                           f"{clean.stdout[-2000:]}")
    planted = store + ".planted"
    shutil.copy(store, planted)
    base = rows["serial_encode_gbps"].value
    for v in (base, base, base, 0.2 * base):
        append_trend(planted, BenchResult(
            metric="serial_encode_gbps", value=v, unit="GB/s", smoke=True,
            suite="cpu-proxy", cmd="planted"))
    bites = gate(planted)
    if bites.returncode != 1 or "REGRESSION serial_encode_gbps" not in \
            bites.stdout:
        raise RuntimeError(f"the gate missed a planted regression:\n"
                           f"{bites.stdout[-2000:]}")
    ep = rows["envpool_steps_per_s"].extra
    pflog(f"suite: 15 rows on the card in {suite_s:.1f} s (the child's "
          f"wall), {summary['budget_breaches']} budget breaches "
          f"(envpool supervision overhead "
          f"{ep['supervision_overhead_frac']:.4f}, budget 0.05), "
          f"e2e_learner_step_s {rows['e2e_learner_step_s'].value * 1e3:.3f} "
          f"ms (steady_d2h {e2e['steady_d2h']}, compile_delta "
          f"{e2e['compile_delta']}), serving {rows['serving_qps'].value:.1f} "
          f"req/s p99 {rows['serving_p99_latency_s'].value * 1e3:.2f} ms; "
          f"--check-trends over {n_rows} rows: {clean.stdout.strip()}; a "
          f"planted regression: exit {bites.returncode}", smi)
    return dict(rows={m: dict(value=r.value, unit=r.unit, extra={
        k: v for k, v in r.extra.items() if k != "stepscope"})
        for m, r in rows.items()}, seconds=suite_s, launches=launches,
        trend_rows=n_rows)


def _perf_bsf(smi: str) -> dict:
    """(d) find_batch_size over phase 5's full-width TransformerNet act
    step (T=1, the SIMT flash forward), 32 to 4096 envs."""
    from moolib_tpu_torch import make_act_step
    from moolib_tpu_torch.ops.batchsizefinder import find_batch_size

    act = make_act_step(_serve_net())
    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(bs):
        return (torch.randint(0, 256, (bs, 84, 84, 4), dtype=torch.uint8,
                              device="cuda", generator=gen),
                torch.zeros((bs,), dtype=torch.bool, device="cuda"))

    _reset_counts()
    best, ms = find_batch_size(lambda obs, done: act(obs, done, (), gen)[0],
                               inputs, min_batch_size=BSF_RANGE[0],
                               max_batch_size=BSF_RANGE[1])
    launches = _kernel_counts()
    if not launches["flash_fwd"]:
        raise RuntimeError(f"bsf act: flash_fwd did not launch: {launches}")
    pflog("find_batch_size over the act step: " + ", ".join(
        f"{m.batch_size} envs {m.latency * 1e3:.3f} ms "
        f"({m.throughput:.0f} envs/s)" for m in ms)
        + f"; knee {best} envs; launches {launches}", smi)
    check = _bsf_check_kernel(act, inputs, [m.batch_size for m in ms], gen)
    pflog(f"bsf act: flash_fwd at every measured batch "
          f"({check['calls']} calls, q up to {check['largest']} "
          f"{'/'.join(check['dtypes'])}) vs plain: max|o| err "
          f"{check['o_err']:.3e} (f32 1e-4, bf16 2^-7*|o|+1e-5), lse "
          f"{check['lse_err']:.3e} (1e-4) | ok", smi)
    return dict(best=best, measurements=[list(m) for m in ms],
                launches=launches, kernel_check=check)


def _bsf_check_kernel(act, inputs, batch_sizes, gen) -> dict:
    """The act step once more at each batch size the sweep measured, with
    the flash forward's inputs and outputs kept at its wrapper: each call
    against the plain version on the same inputs (phase 3's tolerance for
    the inputs' dtype). These launches come after the path's count was
    read."""
    from moolib_tpu_torch.ops import _kernels
    from moolib_tpu_torch.ops.attention import _flash_forward_plain

    tols = {torch.float32: lambda ref: 1e-4,  # summation order only
            torch.bfloat16: lambda ref: 2.0 ** -7 * ref + 1e-5}
    kernel, calls = _kernels.flash_fwd, []

    def keep(q, k, v, seg_q, seg_k, causal):
        o, lse = kernel(q, k, v, seg_q, seg_k, causal)
        calls.append((q, k, v, seg_q, seg_k, causal, o, lse))
        return o, lse

    _kernels.flash_fwd = keep
    o_err = lse_err = 0.0
    n, largest, dtypes = 0, None, set()
    try:
        for bs in batch_sizes:
            act(*inputs(bs), (), gen)
            if not calls:
                raise RuntimeError(f"bsf act: no flash_fwd call at {bs} envs")
            for q, k, v, seg_q, seg_k, causal, o, lse in calls:
                o_ref, lse_ref = _flash_forward_plain(q, k, v, seg_q, seg_k,
                                                      causal)
                oe, le, ok = _compare(o, lse, o_ref, lse_ref, tols[q.dtype])
                if not ok or le > 1e-4:
                    raise RuntimeError(
                        f"bsf act: flash_fwd disagrees with plain at "
                        f"{tuple(q.shape)} {q.dtype}: o {oe:.3e}, lse "
                        f"{le:.3e}")
                o_err, lse_err = max(o_err, oe), max(lse_err, le)
                largest = max(largest or tuple(q.shape), tuple(q.shape))
                dtypes.add(str(q.dtype)[6:])
                n += 1
            calls.clear()
    finally:
        _kernels.flash_fwd = kernel
    return dict(calls=n, largest=list(largest), dtypes=sorted(dtypes),
                o_err=o_err, lse_err=lse_err)


def _perf_sweep(store: str, smi: str) -> dict:
    """(g) perf_sweep's B=256 bf16 config, its trend row into ``store``."""
    from moolib_tpu_torch.bench.harness import append_device_trend
    from moolib_tpu_torch.tools import perf_sweep

    B, dtype = PERF_SWEEP
    row = perf_sweep.run_config(B, dtype, device="cuda")
    append_device_trend(
        f"sweep_B{B}_{dtype}_s2d1_mxu0_env_steps_per_sec",
        row["env_steps_per_sec"], "env-steps/s",
        f"python -m moolib_tpu_torch.tools.perf_sweep B={B},dtype={dtype}")
    pflog(f"perf_sweep B={B} {dtype}: {row['env_steps_per_sec']} env-steps/s, "
          f"{row['tflops']} TFLOP/s, MFU {row['mfu']}", smi)
    if not row["env_steps_per_sec"] or row["mfu"] is None:
        raise RuntimeError(f"perf_sweep gave no rate or MFU: {row}")
    return row


def phase_perfwatch(smi: str, impala_mfu: float) -> dict:
    """Phase 16: perfwatch (see the module docstring)."""
    from moolib_tpu_torch.tools import roofline, telemetry_smoke

    t0 = time.perf_counter()
    os.makedirs(os.path.join("build", "perf"), exist_ok=True)
    store = os.path.abspath(os.path.join("build", "perf",
                                         f"smoke-{os.getpid()}.jsonl"))
    if os.path.exists(store):
        os.remove(store)
    attn = _perf_attn(store, smi)
    d128 = _perf_d128(smi)
    sweep = _perf_sweep(store, smi)
    suite = _perf_suite(store, smi)
    bsf = _perf_bsf(smi)
    roof = roofline.analyze(BENCH_B, UNROLL)
    pflog(f"roofline B={BENCH_B}: attainable MFU "
          f"{roof['attainable_mfu']:.1%} (tile ceiling "
          f"{roof['tile_ceiling']:.1%} at wgmma's k16/n8 granularity); HBM "
          f"floor {roof['hbm_ms']:.2f} ms, tensor-core floor "
          f"{roof['peak_ms']:.2f} ms; measured (phase 8, bench_torch.py) "
          f"{impala_mfu:.2%}", smi)
    tele = telemetry_smoke.run_checks(200, TELEMETRY_BUDGET,
                                      log=lambda s: pflog(f"telemetry {s}",
                                                          smi))
    seconds = time.perf_counter() - t0
    pflog(f"phase took {seconds:.1f} s", smi)
    return dict(
        attn={k: v for k, v in attn["artifact"].items()}, d128=d128,
        suite={k: v for k, v in suite.items() if k != "launches"},
        bsf={k: v for k, v in bsf.items() if k != "launches"},
        roofline=dict(attainable_mfu=roof["attainable_mfu"],
                      tile_ceiling=roof["tile_ceiling"],
                      hbm_ms=roof["hbm_ms"], peak_ms=roof["peak_ms"],
                      measured_mfu=impala_mfu),
        telemetry=tele, sweep=sweep, seconds=seconds,
        launches={"attn bench": attn["launches"], "bsf act": bsf["launches"],
                  "suite": suite["launches"]})


# -- phase 17: the operator plane ---------------------------------------------

OPS_DIR = os.path.join("build", "ops")
OPS_LAUNCH_SECONDS = 20.0  # each transformer peer's train() after start-up
OPS_LAUNCH_TIMEOUT_S = 300.0
# 102 s, a kill every 15 s (a kill falls on the soak's first 2 s poll
# past the interval: ~16, 33, 49, 66, 82, 98 s). elastic_soak exempts a
# replacement born after its end less a kill interval and 30 s (~57 s),
# and seed 0's victims (1, 2, 0, 4, 5, 6) leave the one born at the
# second kill alive, so it must train within ~69 s of its spawn (32-57 s
# on an H100 machine beside this phase's load); the one born at the
# fourth kill is exempt by ~9 s (see _ops_soak).
OPS_SOAK_MINUTES, OPS_SOAK_KILL_S = 1.7, 15.0
OPS_SOAK_ARGS = ("--minutes", f"{OPS_SOAK_MINUTES:g}", "--peers", "2",
                 "--kill-interval", f"{OPS_SOAK_KILL_S:g}",
                 "--stall-window", "45")
OPS_SOAK_EXEMPT_S = 30.0   # elastic_soak's start-up grace past a kill
OPS_CONFIG_SECONDS = 10
OPS_CHILD_TIMEOUT_S = 420.0
OPS_CRAWL_DISCOVER_S = 3.0
OPS_LEDGER_TOL = 0.05      # stepscope_report's ledger-closure tolerance
OPS_TARGET_S = 150.0


def olog(msg: str, smi: str) -> None:
    """An [ops] line, with the card's name and power limit."""
    log(f"[ops] {msg} | card: {smi}")


class _OpsChild:
    """A tool run as ``python -m`` in a session of its own (a failed
    phase kills it with every process it started), its output in
    ``OPS_DIR/<name>.log``; ``seconds`` is its wall time from start to
    exit."""

    def __init__(self, name: str, args):
        self.name = name
        self.path = os.path.join(OPS_DIR, f"{name}.log")
        self._log = open(self.path, "w")  # lifelint: intentional -- the reaper closes it when the child exits
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *args], stdout=self._log,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        self.seconds = None

        def reap():
            self.proc.wait()
            self.seconds = time.perf_counter() - t0

        self._reaper = threading.Thread(target=reap, daemon=True)  # lifelint: intentional -- it ends with the child it waits for
        self._reaper.start()

    def wait(self, timeout: float) -> str:
        """Its output once it exits; raises if it outlives ``timeout``."""
        try:
            self.proc.wait(timeout=max(1.0, timeout))
        finally:
            self.kill()
        with open(self.path) as f:
            return f.read()

    def kill(self) -> None:
        """End its session: it and whatever it started (an env worker
        can outlive its peer's kill by a second). One still running gets
        SIGTERM first, so that a tool whose own children sit in sessions
        of their own (elastic_soak's peers) can end them."""
        if self.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, 15)
            with contextlib.suppress(subprocess.TimeoutExpired):
                self.proc.wait(timeout=15)
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, 9)
        self.proc.wait()
        self._reaper.join()
        self._log.close()

    def last_json(self, out: str) -> dict:
        for line in reversed(out.strip().splitlines()):
            if line.startswith("{"):
                return json.loads(line)
        raise RuntimeError(f"{self.name} printed no JSON line:\n{out[-3000:]}")


def _ops_launch_start(savedir: str):
    """(a) ``launch local`` of two full-width TransformerNet peers on the
    card (experiment.py's own width, phase 6's learn batch [21, 32] in
    bf16, the synthetic env), tracing on; returns the launcher, its
    output lines (read on a thread), and the broker's address (a dict)
    with an event set once it is out."""
    shutil.rmtree(savedir, ignore_errors=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "moolib_tpu_torch.examples.launch", "local",
         "--peers", "2", "--savedir", savedir, "--", "model=transformer",
         "env=synthetic", "seed=0", f"max_seconds={OPS_LAUNCH_SECONDS:g}",
         "log_interval_steps=2000", "stats_interval=2.0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True, env={**os.environ, "MOOLIB_TPU_TRACE": "1"})
    lines, broker, up = [], {}, threading.Event()

    def read():
        with open(os.path.join(OPS_DIR, "launch.log"), "w") as f:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                f.write(line)
                if "listening on" in line and not up.is_set():
                    broker["address"] = line.rsplit(" ", 1)[-1].strip()
                    up.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return proc, lines, (broker, up), reader


def _ops_peer_rows(savedir: str):
    from moolib_tpu_torch.examples.plot import read_tsv

    out = []
    for i in range(2):
        path = os.path.join(savedir, f"peer{i}", "logs.tsv")
        out.append(read_tsv(path) if os.path.exists(path) else [])
    return out


def _ops_crawl(addr: str, smi: str) -> dict:
    """(b) telemetry_dump --spans, incident_report and stepscope_report
    --connect against the live cohort, each dialing the broker's address
    alone; every peer found, the tools' own validation, and the
    vtrace_learner ledgers closing."""
    from moolib_tpu_torch.flightrec import load_bundle
    from moolib_tpu_torch.tools import (incident_report, stepscope_report,
                                        telemetry_dump)

    out = {}
    dump = os.path.join(OPS_DIR, "dump")
    t0 = time.perf_counter()
    rc = telemetry_dump.main([
        "--connect", addr, "--spans", "--prometheus", "--bundle", "--out",
        dump, "--discover-seconds", f"{OPS_CRAWL_DISCOVER_S:g}"])
    out["telemetry_dump_s"] = time.perf_counter() - t0
    with open(os.path.join(dump, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(dump, "trace.json")) as f:
        trace = json.load(f)
    peers = sorted(p for p in metrics if p.startswith("vtrace-"))
    spans = sum(1 for e in trace["traceEvents"] if e.get("ph") == "X")
    bundles = [load_bundle(os.path.join(dump, "bundles", n))
               for n in sorted(os.listdir(os.path.join(dump, "bundles")))]
    if rc != 0 or len(peers) != 2 or not spans \
            or len(bundles) != len(metrics):
        raise RuntimeError(f"telemetry_dump (exit {rc}) found {sorted(metrics)}"
                           f", {spans} spans, {len(bundles)} bundles")
    rep = os.path.join(OPS_DIR, "incident")
    t0 = time.perf_counter()
    rc = incident_report.main([
        "--connect", addr, "--out", rep, "--discover-seconds",
        f"{OPS_CRAWL_DISCOVER_S:g}"])
    out["incident_report_s"] = time.perf_counter() - t0
    with open(os.path.join(rep, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(rep, "timeline.jsonl")) as f:
        timeline = [json.loads(line) for line in f]
    for path in report["bundles"].values():
        load_bundle(path)
    calls = {r["trace_id"]: r["ts_us"] for r in timeline
             if r["type"] == "span" and r["name"].startswith("call ")}
    pairs = [(r["trace_id"], r["ts_us"]) for r in timeline
             if r["type"] == "span" and r["name"].startswith("handle ")
             and r["trace_id"] in calls]
    late = [t for t, ts in pairs if ts < calls[t]]
    stamps = [r["ts_us"] for r in timeline]
    if (rc != 0 or [p for p in report["peers"] if p.startswith("vtrace-")]
            != peers or not timeline or late or stamps != sorted(stamps)):
        raise RuntimeError(f"incident_report (exit {rc}): peers "
                           f"{report['peers']}, {len(timeline)} records, "
                           f"{len(late)} handle spans before their call")
    t0 = time.perf_counter()
    ss = os.path.join(OPS_DIR, "stepscope")
    rc = stepscope_report.main([
        "--connect", addr, "--out", ss, "--discover-seconds",
        f"{OPS_CRAWL_DISCOVER_S:g}"])
    out["stepscope_report_s"] = time.perf_counter() - t0
    with open(os.path.join(ss, "report.json")) as f:
        summaries = json.load(f)["peers"]
    closure = {}
    for p in peers:
        led = summaries.get(p, {}).get("vtrace_learner")
        if rc != 0 or not led or not led["steps"]:
            raise RuntimeError(f"stepscope_report (exit {rc}): no "
                               f"vtrace_learner ledger of {p}: "
                               f"{sorted(summaries)}")
        closure[p] = stepscope_report.check_ledger_closure(
            {"vtrace_learner": led}, OPS_LEDGER_TOL)
        olog(f"(b) {p}'s vtrace_learner ledger: {led['steps']} steps, "
             f"{led['wall_s']:.2f} s, phases "
             f"{ {k: round(v, 3) for k, v in led['phases'].items()} }; "
             f"closes within {closure[p]:.2e}", smi)
    olog(f"(b) crawled from the broker {addr} alone: telemetry_dump "
         f"{out['telemetry_dump_s']:.2f} s ({len(metrics)} peers, {spans} "
         f"spans, {len(bundles)} bundles), incident_report "
         f"{out['incident_report_s']:.2f} s ({len(timeline)} records, "
         f"{len(pairs)} call/handle pairs in causal order, offsets "
         f"{report['offsets_us']} us), stepscope_report "
         f"{out['stepscope_report_s']:.2f} s", smi)
    return dict(out, peers=len(metrics), spans=spans,
                timeline_records=len(timeline), causal_pairs=len(pairs),
                ledger_closure=closure)


def _ops_launch_finish(proc, lines, reader, savedir: str, smi: str) -> dict:
    """(a)'s checks once the launcher has exited."""
    reader.join(timeout=30)
    done = [json.loads(line) for line in lines
            if line.startswith('{"updates"')]
    rows = _ops_peer_rows(savedir)
    if proc.returncode != 0 or len(done) != 2:
        raise RuntimeError(f"launch local exited {proc.returncode} with "
                           f"{len(done)} peer reports:\n"
                           + "\n".join(lines[-40:]))
    groups = set()
    peers = []
    for i, peer_rows in enumerate(rows):
        with open(os.path.join(savedir, f"peer{i}", "metadata.json")) as f:
            groups.add(json.load(f)["config"]["group"])
        # A window in which this peer took no gradient step logs NaN (an
        # empty mean: before its first step, or while its group
        # re-formed); one that took a step must log a finite loss.
        losses = [r["total_loss"] for r in peer_rows]
        steps = [int(r["grad_steps"]) for r in peer_rows]
        bad = [(n, v) for n, v in zip(steps, losses)
               if (math.isfinite(v) if n == 0 else not math.isfinite(v))]
        logged = [v for n, v in zip(steps, losses) if n]
        if len(logged) < 2 or bad or not peer_rows[-1]["updates"]:
            raise RuntimeError(f"peer{i}: {len(peer_rows)} rows, (grad "
                               f"steps, loss) {list(zip(steps, losses))}")
        rates = _rates(peer_rows)
        peers.append(dict(rows=len(peer_rows),
                          updates=peer_rows[-1]["updates"],
                          global_env_steps=peer_rows[-1]["global_env_steps"],
                          empty_windows=len(losses) - len(logged),
                          grad_steps=sum(steps),
                          **rates))
    if len(groups) != 1:
        raise RuntimeError(f"the peers trained in groups {groups}")
    launches = {k: sum(d["kernel_launches"].get(k, 0) for d in done)
                for k in done[0]["kernel_launches"]}
    if not (launches.get("flash_fwd") and launches.get("flash_bwd_tile")):
        raise RuntimeError(f"the launched peers did not run the flash "
                           f"kernels: {done}")
    for i, p in enumerate(peers):
        olog(f"(a) peer{i}: {p['rows']} rows, {p['updates']:g} updates, "
             f"{p['env_steps_per_s']:.1f} env-steps/s, "
             f"{p['updates_per_s']:.2f} updates/s (first to last row), "
             f"global env steps {p['global_env_steps']:g}, "
             f"{p['grad_steps']} local gradient steps, "
             f"{p['empty_windows']} windows without one (NaN loss)", smi)
    olog(f"(a) launch local: 2 full-width TransformerNet peers, "
         f"{OPS_LAUNCH_SECONDS:g} s each, group {groups.pop()!r}; the "
         f"peers' flash launches {[d['kernel_launches'] for d in done]}",
         smi)
    return dict(peers=peers, launches=launches)


def _ops_soak(child: _OpsChild, timeout: float, smi: str) -> dict:
    """(c) elastic_soak's three criteria with card peers. The tool holds
    a replacement to its first update only where it was born before its
    end less a kill interval and OPS_SOAK_EXEMPT_S; here at least one
    replacement that was never killed must be born before that line,
    and every such one must have reached its first update while the
    soak ran (``rejoin_s``)."""
    out = child.wait(timeout)
    rep = child.last_json(out)
    with open(os.path.join(OPS_DIR, "soak.json")) as f:
        art = json.load(f)
    history = art["churn_history"]
    killed = {h["killed"] for h in history}
    line = (art["startup_s"] + OPS_SOAK_MINUTES * 60 - OPS_SOAK_KILL_S
            - OPS_SOAK_EXEMPT_S)
    held = [h["spawned"] for h in history
            if h["t"] < line and h["spawned"] not in killed]
    missing = [i for i in held if str(i) not in art["rejoin_s"]]
    if child.proc.returncode != 0 or not rep["ok"] or not art["kills"] \
            or not held or missing:
        raise RuntimeError(f"elastic_soak (exit {child.proc.returncode}): "
                           f"replacements held to their first update "
                           f"{held}, without one {missing}: {rep}\n"
                           f"{out[-3000:]}")
    olog(f"(c) elastic_soak {' '.join(OPS_SOAK_ARGS)}: ok, {art['kills']} "
         f"kills, replacements held to their first update {held}; "
         f"replacements' seconds to their first update "
         f"{art['rejoin_s']}, start-up {art['startup_s']} s, peak live "
         f"updates {art['peak_live_updates_sum']}; {child.seconds:.1f} s",
         smi)
    return dict(kills=art["kills"], rejoin_s=art["rejoin_s"], held=held,
                startup_s=art["startup_s"],
                peak_live_updates_sum=art["peak_live_updates_sum"],
                seconds=child.seconds)


def _ops_configs_start() -> dict:
    """(d) config_matrix --seconds OPS_CONFIG_SECONDS on the card, one
    child a config (``--only``), all five at once: the configs share no
    state, and their set-up (process, CUDA, env workers) is most of a
    config's wall time."""
    return {i: _OpsChild(f"config{i}", [
        "moolib_tpu_torch.tools.config_matrix", "--seconds",
        str(OPS_CONFIG_SECONDS), "--only", str(i), "--json",
        os.path.join(OPS_DIR, f"config{i}.json")]) for i in range(1, 6)}


def _ops_configs(children: dict, timeout: float, smi: str) -> dict:
    """(d)'s checks: every config with env steps, updates and a finite
    loss."""
    configs, bad, seconds = {}, [], {}
    for i, child in children.items():
        out = child.wait(timeout)
        seconds[i] = child.seconds
        with open(os.path.join(OPS_DIR, f"config{i}.json")) as f:
            res = json.load(f)["configs"][str(i)]
        configs[str(i)] = res
        runs = list(res["peers"].values()) if "peers" in res else [res]
        if child.proc.returncode != 0 or not res.get("ok") or not all(
                r.get("env_steps", 0) > 0 and r.get("updates", 0) > 0
                and r.get("total_loss") is not None
                and math.isfinite(r["total_loss"]) for r in runs):
            bad.append((i, child.proc.returncode, out[-2000:]))
        olog(f"(d) config {i} ({res['label']}): "
             + "; ".join(f"{r.get('env_steps')} env steps, "
                         f"{r.get('updates')} updates, loss "
                         f"{r.get('total_loss')}" for r in runs)
             + f"; the tool's wall {res['wall_s']} s, {child.seconds:.1f} s "
             "with its process", smi)
    if bad:
        raise RuntimeError(f"config_matrix failed configs {bad}")
    return dict(configs=configs, seconds=seconds)


def _ops_locktrace(locktrace: dict, smi: str) -> dict:
    """(e) chaos_soak --smoke --locktrace --device cuda: phase 14's soak
    runs under the lock tracer (and the resource tracker) on a quiet
    host, and that phase fails unless the observed edges are above 0,
    acyclic and inside static_package_edges(). Beside this phase's
    other parts, two of its timed gates (fleet_bad_canary's rollback
    window, envpool_worker_kill's respawn) failed once."""
    olog(f"(e) chaos_soak --smoke --restrack --locktrace --device cuda "
         f"(phase 14's soak): {locktrace['runs']} scenarios ok, "
         f"{locktrace['edges']} observed lock-order edges, acyclic, within "
         f"static_package_edges(); {locktrace['seconds']:.1f} s", smi)
    return locktrace


def _ops_host_tools(smi: str) -> dict:
    """(f) the host tools on the card machine's host (its cores, not the
    card), beside the phase's other parts."""
    from moolib_tpu_torch.tools import env_packages_report

    out = {}
    for name, args, timeout in (
            ("decomp", ["moolib_tpu_torch.tools.allreduce_decomp", "--json",
                        os.path.join(OPS_DIR, "decomp.json")], 300.0),
            ("latency_ab", ["moolib_tpu_torch.tools.allreduce_latency_ab",
                            "--mb", "8", "--json",
                            os.path.join(OPS_DIR, "latency_ab.json")],
             300.0)):
        child = _OpsChild(name, args)
        text = child.wait(timeout)
        out[name] = dict(seconds=child.seconds,
                         rc=child.proc.returncode, text=text)
    for name in out:
        if out[name]["rc"] != 0:
            raise RuntimeError(f"{name} exited {out[name]['rc']}:\n"
                               f"{out[name]['text'][-3000:]}")
    with open(os.path.join(OPS_DIR, "decomp.json")) as f:
        decomp = json.load(f)
    with open(os.path.join(OPS_DIR, "latency_ab.json")) as f:
        ab = json.load(f)
    if decomp["cpu_count"] != os.cpu_count():
        raise RuntimeError(f"allreduce_decomp's cpu_count: {decomp}")
    envs = env_packages_report.report()
    roof = decomp["single_core_tree_roofline"]
    olog(f"(f) allreduce_decomp (4 peers, 32 MiB, {decomp['cpu_count']} "
         f"cores): host {decomp['host_primitives']}, RPC small call "
         f"{decomp['rpc_small_call_us']} us, roofline "
         f"{roof['roofline_gbps']} GB/s, measured "
         f"{decomp['measured']['gbps']} GB/s "
         f"({decomp['measured_over_roofline']} of it); "
         f"{out['decomp']['seconds']:.1f} s", smi)
    olog(f"(f) allreduce_latency_ab (4 peers, 8 MiB, 100 Mbps links): "
         f"unchunked {ab['unchunked_s']} s, chunked {ab['chunked_depth4_s']} "
         f"s, speedup {ab['chunked_speedup']}x; "
         f"{out['latency_ab']['seconds']:.1f} s", smi)
    olog(f"(f) env_packages_report: installed "
         f"{sorted(k for k, v in envs['packages'].items() if v['installed'])}",
         smi)
    return dict(
        decomp={k: decomp[k] for k in decomp if k != "interpretation"},
        latency_ab={k: ab[k] for k in ab if k != "note"},
        env_packages={k: v["installed"] for k, v in envs["packages"].items()},
        seconds={k: v["seconds"] for k, v in out.items()})


def phase_ops(smi: str, locktrace: dict) -> dict:
    """Phase 17: the operator plane (see the module docstring). (a) and
    (c) first; (d) and (f) once both launched peers have updated (their
    start-up is slowed by a busy host); (e) is phase 14's soak, whose
    ``locktrace`` reading this phase reports."""
    t0 = time.perf_counter()
    shutil.rmtree(OPS_DIR, ignore_errors=True)
    os.makedirs(OPS_DIR)
    savedir = os.path.join(OPS_DIR, "launch")
    children = {}
    launcher = None
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        launcher, lines, (broker, up), reader = _ops_launch_start(savedir)
        children["soak"] = _OpsChild(
            "soak", ["moolib_tpu_torch.tools.elastic_soak", *OPS_SOAK_ARGS,
                     "--json", os.path.join(OPS_DIR, "soak.json"),
                     "--workdir", os.path.join(OPS_DIR, "soak")])
        if not up.wait(60):
            raise RuntimeError("launch local printed no broker address:\n"
                               + "\n".join(lines))
        deadline = time.monotonic() + OPS_LAUNCH_TIMEOUT_S
        # (A row being written may lack its last columns.)
        while not all(rows and rows[-1].get("updates", 0) > 0
                      for rows in _ops_peer_rows(savedir)):
            if launcher.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("the launched peers never both "
                                   "updated:\n" + "\n".join(lines[-40:]))
            time.sleep(1.0)
        others_start = time.perf_counter() - t0
        configs_children = _ops_configs_start()
        children.update(configs_children)
        host_fut = pool.submit(_ops_host_tools, smi)
        crawl = _ops_crawl(broker["address"], smi)
        launcher.wait(timeout=max(1.0, deadline - time.monotonic()))
        launch = _ops_launch_finish(launcher, lines, reader, savedir, smi)
        configs = _ops_configs(configs_children, OPS_CHILD_TIMEOUT_S, smi)
        host = host_fut.result(timeout=OPS_CHILD_TIMEOUT_S)
        soak = _ops_soak(children["soak"], OPS_CHILD_TIMEOUT_S, smi)
        locktrace = _ops_locktrace(locktrace, smi)
    finally:
        for child in children.values():
            child.kill()
        if launcher is not None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(launcher.pid, 9)
            launcher.wait()
        pool.shutdown(wait=True)
    seconds = time.perf_counter() - t0
    olog(f"phase took {seconds:.1f} s (target {OPS_TARGET_S:g} s); (a) and "
         f"(c) from its start, (d) and (f) from {others_start:.1f} s (the "
         f"launched peers' first updates)", smi)
    return dict(launch={k: v for k, v in launch.items() if k != "launches"},
                crawl=crawl, soak=soak, configs=configs,
                locktrace=locktrace, host=host, seconds=seconds,
                others_start=others_start,
                launches={"launch transformer": launch["launches"]})


BUNDLE_DIR = os.path.join("build", "flightrec")
# The environment prefixes the port's bundles record (the reference's
# MOOLIB, and the card's in place of JAX and XLA).
CARD_ENV_PREFIXES = ("MOOLIB", "TORCH", "PYTORCH", "CUDA", "NCCL")


def phase_bundles(tels) -> dict:
    """One incident bundle per phase's Telemetry, captured through the
    explicit ``api`` trigger into build/flightrec/: each must load and
    validate, and the train and impala bundles must carry a step_phases
    flight event of every scoped loop (each loop's StepScope stamps one
    every FLIGHT_EVERY steps)."""
    from moolib_tpu_torch.flightrec import capture_incident, load_bundle
    from moolib_tpu_torch.telemetry import summarize_stepscope

    out = {}
    for kind, tel in tels.items():
        path = capture_incident("api", f"chip_smoke {kind} phase",
                                telemetry=tel, out_dir=BUNDLE_DIR)
        bundle = load_bundle(path)  # validates
        loops = set(summarize_stepscope(bundle["metrics"][kind]))
        stamped = {e["fields"]["loop"] for e in bundle["events"]
                   if e["kind"] == "step_phases"}
        env = sorted(bundle["fingerprint"]["env"])
        foreign = [k for k in env if k.split("_")[0] not in CARD_ENV_PREFIXES]
        out[kind] = dict(path=path, events=len(bundle["events"]),
                         spans=len(bundle["spans"]),
                         step_phases=len([e for e in bundle["events"]
                                          if e["kind"] == "step_phases"]),
                         loops=sorted(loops), env_keys=env)
        log(f"[flightrec] {kind}: {path} | {out[kind]['events']} events "
            f"({out[kind]['step_phases']} step_phases, loops stamped "
            f"{sorted(stamped)}), {out[kind]['spans']} spans, dropped "
            f"{bundle['events_dropped']}/{bundle['spans_dropped']} | loops "
            f"in its metrics {sorted(loops)} | fingerprint env {env}")
        if foreign:
            raise RuntimeError(f"bundle {path} records env keys outside "
                               f"{CARD_ENV_PREFIXES}: {foreign}")
        if kind != "serve" and stamped != loops:
            raise RuntimeError(f"bundle {path}: scoped loops {sorted(loops)} "
                               f"but step_phases events of {sorted(stamped)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA H100", file=sys.stderr)
        return 2
    from moolib_tpu_torch.ops._kernels import KERNELS, LIBRARIES

    t_start = time.perf_counter()
    name, smi = phase_device()
    _, library_builds = phase_build()
    fwd_results, fwd_timings = phase_kernel_vs_plain()
    bwd_results, bwd_timings = phase_backward_vs_plain()
    tels = {kind: _telemetry(kind) for kind in ("serve", "train", "impala")}
    serve_launches, served = phase_serve(tels["serve"])
    rpc = phase_rpc(served)
    train = phase_train(tels["train"])
    context_backward = phase_context_backward()
    for kern in KERNELS:
        kern.launches = 0
    impala = phase_impala(tels["impala"])
    impala_launches = {kern.name: kern.launches for kern in KERNELS}
    if any(impala_launches.values()):
        raise RuntimeError(f"the impala path launched a flash kernel: "
                           f"{impala_launches}")
    acc = phase_acc()
    # Before the e2e phase: the loops it runs record into the global
    # flight recorder, which every bundle merges in.
    bundles = phase_bundles(tels)
    e2e = phase_e2e(impala["bench"]["line"]["value"])
    zoo = phase_zoo(smi)
    durable = phase_statestore(smi)
    chaos = phase_chaos(smi)
    md = phase_md(smi)
    dp = phase_dp_train(smi, e2e["transformer"]["without_savedir"])
    perf = phase_perfwatch(smi, impala["bench"]["line"]["mfu"])
    ops = phase_ops(smi, chaos["soak"]["locktrace"])

    launches_by_path = {
        path: counts for path, counts in
        [*serve_launches.items(), *rpc["launches"].items(),
         ("train", train["launches"]),
         ("context backward", context_backward),
         ("impala", impala_launches), *acc["launches"].items(),
         *e2e["launches"].items(), *zoo["launches"].items(),
         *durable["launches"].items(), *chaos["launches"].items(),
         *md["launches"].items(), *dp["launches"].items(),
         *perf["launches"].items(),
         *ops["launches"].items()]
    }
    never = [kname for kname in train["launches"]
             if not any(c[kname] for c in launches_by_path.values())]
    if never:
        raise RuntimeError(f"kernels no path launched: {never}")

    def row(kname, source, replaces, timing, err, shape, extra):
        return {
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(c[kname] for c in launches_by_path.values()),
            "launches_by_path": {p: c[kname]
                                 for p, c in launches_by_path.items()},
            "max_abs_err": err,
            "ms": timing["ms"],
            "device_ms": timing["device_ms"],
            "plain_ms": timing["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "bound_ms_no_resets": timing["bound_ms_no_resets"],
            "library_ms": timing["library_ms"],
            "library_device_ms": timing["library_device_ms"],
            "design": timing["design"],
            "shape": list(shape),
            "parity": "pass",
            **extra,
        }

    def d128(kname):
        """The kernel's rows at attn_bench's shapes (phase 16)."""
        return {"d128_bf16_causal": [rows[kname]
                                     for rows in perf["d128"].values()]}

    f = fwd_results["context (main path)"]
    ctx = fwd_timings["context (main path)"]
    kernels = [row(
        "flash_fwd", "moolib_tpu_torch/ops/csrc/flash_fwd.cu",
        "moolib_tpu/ops/attention.py:226", ctx,
        max(f["o_err"], f["lse_err"]), CONTEXT_SHAPE,
        {"no_resets": fwd_timings["context (no resets)"],
         "act_shape": dict(shape=list(ACT_SHAPE),
                           **fwd_timings["act (main path)"]),
         "train_shape": dict(shape=list(TRAIN_SHAPE),
                             **fwd_timings["train (main path)"]),
         "bf16_shape": dict(shape=[8, 4, 2048, 32],
                            **fwd_timings["B*H=32 T=2048 bf16"]),
         **d128("flash_fwd")},
    )]
    for kname, line, grads in (("flash_bwd_dq", 362, ("dq",)),
                               ("flash_bwd_dkdv", 407, ("dk", "dv"))):
        b = bwd_results["context (main path)"]
        kernels.append(row(
            kname, "moolib_tpu_torch/ops/csrc/flash_bwd.cu",
            f"moolib_tpu/ops/attention.py:{line}",
            bwd_timings["context (main path)"][kname],
            max(b["errs"][g][0] for g in grads), CONTEXT_SHAPE,
            {"no_resets": bwd_timings["context (no resets)"][kname],
             "bf16_shape": dict(shape=[8, 4, 2048, 32],
                                **bwd_timings["B*H=32 T=2048 bf16"][kname]),
             **d128(kname)},
        ))
    b = bwd_results["train (main path)"]
    kernels.append(row(
        "flash_bwd_tile", "moolib_tpu_torch/ops/csrc/flash_bwd.cu",
        "moolib_tpu/ops/attention.py:362 and :407 (both, at Tq, Tk <= 64)",
        bwd_timings["train (main path)"]["flash_bwd_tile"],
        max(b["errs"][g][0] for g in ("dq", "dk", "dv")), TRAIN_SHAPE, {},
    ))
    print(json.dumps({"kernels": kernels,
                      "train": {k: train[k] for k in
                                ("step_ms", "step_host_ms", "breakdown",
                                 "grad_err", "tf32_grad_err", "param_err",
                                 "split_err", "ledgers")},
                      "impala": impala, "bundles": bundles,
                      "rpc": {k: rpc[k] for k in rpc if k != "launches"},
                      "acc": {k: acc[k] for k in acc if k != "launches"},
                      "e2e": {k: e2e[k] for k in e2e if k != "launches"},
                      "zoo": {k: zoo[k] for k in zoo if k != "launches"},
                      "statestore": {k: durable[k] for k in durable
                                     if k != "launches"},
                      "chaos": {k: chaos[k] for k in chaos
                                if k != "launches"},
                      "md": {k: md[k] for k in md if k != "launches"},
                      "dp": {k: dp[k] for k in dp if k != "launches"},
                      "perf": {k: perf[k] for k in perf
                               if k not in ("launches", "d128")},
                      "ops": {k: ops[k] for k in ops if k != "launches"}}),
          flush=True)
    log(f"[lint] recompile_guard: build_all made {library_builds} "
        f"kernel-library builds (want {len(LIBRARIES)}, one per source); "
        f"the steady train steps made {train['steady_builds']} (budget 0) "
        f"| card: {smi}")
    log(f"[total] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s "
        f"of its 1200 s limit | card: {smi}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


RACES_FLAG = "--races"


def races(reps: int) -> int:
    """The --races mode (see the module docstring)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA H100", file=sys.stderr)
        return 2
    _, smi = phase_device()
    paths = {
        "allreduce": _bench_allreduce,
        "remote actors": lambda: [_zoo_remote(env, n, actors, stack, smi)
                                  for env, n, actors, stack in REMOTE_RUNS],
    }
    passes = {key: {"hog": 0, "quiet": 0} for key in paths}
    for rep in range(reps):
        load = "hog" if rep % 2 else "quiet"
        hog = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
               for _ in range((os.cpu_count() or 2) // 2 if rep % 2 else 0)]
        try:
            for key, fn in paths.items():
                t0 = time.perf_counter()
                try:
                    fn()
                    passes[key][load] += 1
                    verdict = "pass"
                except Exception as e:  # moolint: disable=swallow-cancelled -- counted and reported; no event loop in this process
                    verdict = f"FAIL {type(e).__name__}: {e}"[:2000]
                log(f"[races] {key} run {rep + 1}/{reps} ({load}, {len(hog)} "
                    f"busy processes): {verdict} in "
                    f"{time.perf_counter() - t0:.1f} s | card: {smi}")
        finally:
            for p in hog:
                p.kill()
                p.wait()
    runs = {"hog": reps // 2, "quiet": reps - reps // 2}
    log(json.dumps({"races": passes, "runs": runs, "card": smi}))
    return 0 if all(v == runs for v in passes.values()) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == [RACES_FLAG]:
        sys.exit(races(int(sys.argv[2])))
    if sys.argv[1:] == [RPC_CHILD_FLAG]:
        sys.exit(rpc_child())
    if sys.argv[1:2] == [ACC_CHILD_FLAG]:
        sys.exit(acc_child(*sys.argv[2:4]))
    if sys.argv[1:2] == [MD_CHILD_FLAG]:
        sys.exit(md_child(*sys.argv[2:4]))
    sys.exit(main())
