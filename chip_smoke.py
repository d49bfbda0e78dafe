"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of the repository, on a machine with a CUDA GPU, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of ``asyncrl_tpu_torch`` from its source, one
   ``nvcc`` per source, all at once;
3. holds each kernel against its plain PyTorch version at the shapes the
   training paths give it (bit for bit) and times both, with each kernel's
   device time at each shape: the fused V-trace tail (B1), the reverse scan
   (B2) and its bulk-copy twin (B3), which are also held against each other
   (these three also with a cold L2 at brax_ppo's), and the ring
   all-reduce (B4) over 2, 4 and 8 ranks at the three mesh presets'
   gradient sizes (pong_impala, atari_impala, procgen_ppo) and a ragged
   one, in the gradient path's layout and as a contiguous tensor, with a
   plain sum over the ranks as the library call
   (warm, and with a cold L2 at the flagship point);
4. trains, each at the preset's full width, and checks that every update
   launched each of its path's kernels as often as the path says and the
   other kernels never, that the metrics are finite, and that the loss on
   one fragment is bit-identical through the kernel and through plain code.
   Through ``make_agent`` on one rank: ``atari_impala`` (1024 envs of
   84x84x4 pixel Pong, IMPALA-CNN, T=32) and ``pong_impala`` (256 envs, MLP
   256x256) on B1; ``brax_ppo`` (8192 Pendulum envs, T=64, MLP 64x64, 4
   epochs x 8 minibatches) three ways: by default on B1, with
   ``fused_scan="lax", scan_impl="kernel"`` on B2 and with
   ``scan_impl="kernel_dma"`` on B3; and ``pong_impala`` on the lax path on
   B2. Through ``Trainer(cfg, mesh=make_mesh((8,), devices=[cuda] * 8))``
   with ``grad_reduce="ring"``, 8 data-parallel ranks sharing the card:
   ``pong_impala`` and ``atari_impala``, each update B1 once per rank and B4
   once, with the reduced gradient of one fragment bit-identical through B4
   and through the plain ring, and within the fold bound of a plain sum.
   Through ``make_agent`` on one rank, the A3C and trainer-surface slice:
   ``cartpole_a3c`` (64 CartPole envs, T=32, MLP 64x64) three ways, its
   n-step returns on B1 by default, on B2 with ``fused_scan="lax",
   scan_impl="kernel"`` and on B3 with ``scan_impl="kernel_dma"``;
   ``cartpole_impala`` on B1; and ``pong_t2t`` (256 envs, 32 updates a call,
   the living cost, the entropy anneal, and an in-training eval after its
   second call) on B1, two calls. The procgen slice: ``procgen_ppo`` (4096
   Chaser envs, T=16, IMPALA-CNN on 17x17x4 planes, 2 epochs x 8
   minibatches) through ``make_agent``, B1 once an update; and on 8 ranks
   sharing the card with ``grad_reduce="ring"`` (``procgen_ppo_mesh8_ring``),
   B1 once a rank and B4 once a minibatch step (16 an update), with one
   minibatch's gradients (each rank's, under the global advantage moments)
   bit-identical through B4 and through the plain ring, and within the fold
   bound of a plain sum. The Q-learning, optimizer and normalization slice,
   each through ``make_agent`` on one rank unless named: ``cartpole_qlearn``
   (128 CartPole envs, T=32) and ``pong_qlearn`` (256 envs, MLP 256x256),
   their n-step returns on B1; ``pong_qlearn`` with ``fused_scan="lax",
   scan_impl="kernel_dma"`` on B3; ``pong_qlearn`` on 8 ranks sharing the
   card with ``grad_reduce="ring"`` (B1 once a rank, B4 once an update);
   ``atari_impala_wide`` (256 pixel envs, IMPALA-CNN (64, 128, 128),
   ``grad_accum=4``, block remat), B1 once a chunk, with its loss and
   gradients on one chunk held to the same model without remat within 1e-5
   relative (cuDNN deterministic) and its peak memory printed beside
   ``atari_impala``'s; and ``brax_ppo`` with ``normalize_obs``,
   ``normalize_returns`` and ``optimizer="rmsprop"`` on B1. The LSTM and
   self-play slice, each with ``core_size=256``: ``pong_impala`` with
   ``core="lstm"`` (IMPALA-LSTM) on B1, and on 8 ranks sharing the card
   with ``grad_reduce="ring"`` (B1 once a rank, B4 once); ``pong_qlearn``
   with ``core="lstm"`` (DRQN, the target re-forwarding the fragment) on
   B1; ``procgen_ppo`` with ``core="lstm"`` (minibatches of whole envs,
   2 x 8 blocks of [16, 512]) on B1 once an update; and ``pong_selfplay``
   (256 ``JaxPongDuel-v0`` envs, the frozen rival promoted every 200
   updates), feed-forward and with an LSTM, on B1. The population, ALE,
   Breakout, Nature-CNN and locomotion slice: ``breakout_impala`` (256
   vector Breakout envs, MLP 256x256); ``atari_impala`` on
   ``JaxBreakoutPixels-v0``, with ``frame_skip=4, frame_pool=True,
   sticky_actions=0.25``, and with ``torso="nature_cnn"``;
   ``pong_t2t_ale4`` (vector Pong through a 4-frame skip, 32 updates a
   call); ``pong_pixels_t2t`` (1024 pixel envs, ``grad_accum=4``, remat, 8
   updates a call; B1 once a chunk); ``hopper_ppo`` and
   ``brax_humanoid_ppo`` (8192 planar rigid-body worlds, T=32, 48 physics
   substeps a step, 4 epochs x 8 minibatches), each on B1; then
   ``PopulationTrainer(pong_impala, pop_size=4)``, 256 envs a member, B1
   once a member an update, with member 2 held bit for bit to a standalone
   ``make_agent(pong_impala, seed=2)`` after two calls and its rate per
   member against ``pong_impala``'s alone. The MinAtar games, each
   ``atari_impala`` with its ``env_id`` swapped (``minatari_invaders``,
   ``_freeway``, ``_asterix``, ``_seaquest``: 1024 envs of 10x10 planes),
   on B1. Then the command lines from the repository's root:
   ``python -m asyncrl_tpu_torch.cli.train pong_impala`` for 4 updates
   (``cli_train``: it must exit 0, every output and JSONL line must parse,
   and its ``--profile`` trace must show B1 once an update), and two
   processes of ``cli.launch pong_impala --backend gloo`` sharing the card
   (``launch_pong_impala_2proc``), whose weights must equal the
   one-process ``(dcn=2, dp=1)`` mesh's bit for bit, each process
   launching B1 once an update and B4 never (NCCL is not measured: one
   card), with the cost of drawing the whole batch's random values in each
   process; and the time-sharded V-trace, GAE and n-step returns at (256,
   1024) over 4 shards against the unsharded functions and the float64
   solution (``timeshard``). Then the host path (``backend="sebulba"``), through
   ``make_agent`` with ``host_pool="native"``: ``pendulum_native_ppo`` (128
   native Pendulum envs over 4 actor threads, T=64, 4 epochs x 8
   minibatches; GAE on B1) and ``pong_impala`` with ``backend="sebulba",
   actor_threads=4`` (256 native Pong envs, T=32; V-trace on B1), each for
   4 windows of 2 updates, an update one actor's fragment: B1 once an update
   and no other kernel, the loss on the last drained slab bit-identical
   through B1 and through the plain version, finite windows, one slab's
   bytes copied an update (``fragment_template``'s), no actor error, a
   32-episode eval on the native pool, and one update profiled. Then the
   host path's second slice, each ``pong_impala`` or ``pong_qlearn`` on
   4 threads of 64 native envs like the last: ``sebulba_pong_impala_server``
   and ``sebulba_pong_impala_lstm_server`` (``inference_server=True,
   serve=False``: the most frequent round must be all 256 envs' rows),
   ``sebulba_pong_impala_replay`` (``replay_slabs=4, replay_passes=2``: B1
   once a fresh and once a replayed update, every replayed row bit for bit
   the slab published into it, the ring full and four slabs' bytes),
   ``sebulba_pong_qlearn`` and ``sebulba_pong_qlearn_lstm`` (epsilon-greedy
   threads, DRQN: the target network bit for bit the weights right after
   each refresh and not before it, every thread's epsilons the schedule's at
   the published env steps); every line gives the model forwards an env
   step (one a thread per-thread, one a round through the server). Then the
   host learner on a mesh, through ``SebulbaTrainer(mesh=make_mesh(...,
   devices=[cuda] * n))``, ranks sharing the card: ``pong_impala`` on the
   host path over ``(8,) ("dp",)`` with ``grad_reduce="ring"``
   (``sebulba_pong_impala_mesh8_ring``: B1 once a rank, 8 an update, at
   (32, 8), and B4 once an update; rank 0's loss on the last drained slab
   bit-identical through B1, the ranks' gradients on it through B4 = the
   plain ring, within the fold bound of a plain sum); ``pong_impala`` on
   ``(2, 4) ("dp", "sp")`` (``sebulba_pong_impala_dp2_sp4``: 8 steps a
   shard, no B1 and no B4, one update on the last drained slab equal to the
   same update on ``(2,) ("dp",)`` within ``rtol=5e-5, atol=1e-6``, the JAX
   package's test's bound, at that test's precision: both learners at
   ``precision="f32"`` from the trainer's state); and
   ``pendulum_native_ppo`` on ``(2, 4)``
   (``sebulba_pendulum_native_ppo_dp2_sp4``: 4 epochs x 8 minibatches of
   each shard's own samples, no twin, so the update is deterministic bit for
   bit, finite, and moves the weights); each sp update and its dp-only
   twin's are timed. Then the serving tier: ``pong_serve`` through
   ``make_agent`` (``serve_pong_serve``: 16 Pong envs over 2 actor threads,
   T=16, ``host_pool="jax"``, the ``ServeCore`` and the external gateway
   with the preset's tenants ``gold``, ``bulk`` and ``*``), 8 windows of 2
   updates with wire load from ``GatewayClient`` in the middle four (two
   ``gold`` clients at 50 rps, ``bulk`` at 100 rps, ``/v1/evaluate`` at
   10 rps), then the serve core killed mid-run and rebuilt by the
   supervisor: B1 once an update at (16, 8) and no other kernel, the loss
   on the last drained slab bit-identical through B1, more than one
   generation over the wire, no actor restart under the load,
   ``gateway_live`` 1.0 at the last window, ``bulk`` refused 429 with a
   Retry-After and ``gold`` never, during the outage ``gold`` stale, ``*``
   its fallback and ``bulk`` 503, ``gold`` fresh after the rebuild, and,
   training stopped, every served log-prob within 1e-5 of the final
   snapshot's plain forward; and the population's four members published
   into a router-only ``ServeCore`` (``serve_pong_impala_pop4``): four
   clients, one a ``member/<i>``, a second ``publish_policies`` after one
   population update mid-traffic, no request dropped, every batched call
   on one published snapshot, each answer within 1e-5 of its generation's
   plain forward. Then the replicated fleet (``serve_fleet_pong_impala``):
   ``pong_impala`` through ``make_agent`` (256 envs, T=32) publishing
   snapshots into a ``ParamFeed``, a ``ServeFleet`` of 3 cores on the card
   behind ``ServeGateway(FleetRouter(...))``, 4 gold clients of 64 Pong
   observations from the load process; the ``fleet.replica`` site kills
   one replica, rebuilt while the others serve; the next learner version
   is canaried and promoted, and a poisoned one (its policy head negated
   and scaled) rolled back and vetoed; every request answered fresh, each
   answer within 1e-5 of the plain forward of the version stamped on it,
   device memory grown under 512 MiB over the rebuild, B1 once a learner
   update and nothing else. And the preemption drain
   (``drain_pong_serve``): ``pong_serve`` with a checkpoint directory in a
   child process under that load gets a real SIGTERM after its fourth
   window; it must exit 86 inside its 30 s grace, refuse (503 or a closed
   port) every request sent after the signal, and leave one final
   checkpoint with its manifest whose weights, restored with
   ``make_agent(restore=)``, hash to the SHA-256 the child printed. Then
   supervision (``supervision_sebulba_pong_impala``): ``sebulba_pong_impala``'s
   geometry with ``stall_timeout_s=2``, (i) the actors under an injected
   ``actor.step`` crash and 60 s stalls in ``pool.step`` and at
   ``actor.queue_put`` (3 restarts, 2 by the heartbeat watchdog, each within
   2 s past the timeout, the target reached far inside the stalls), (ii) the
   coalescing inference server crashed, then stalled 60 s (rebuilt twice,
   the second time by the watchdog, no actor retired by it), (iii) the
   checkpoint writer under two injected save crashes (every periodic step on
   disk, each restoring to the SHA-256 of the state when it was saved, the
   snapshot the state's size on the card, the train thread's ms a save
   printed beside the synchronous save's); B1 once an update throughout and
   nothing else, device memory grown under 512 MiB over the restarts. Then
   tracing and forensics (``trace_sebulba_pong_impala``):
   ``sebulba_pong_impala``'s geometry with the coalescing server,
   ``trace=True``, a run directory and one injected ``actor.step`` crash,
   for 16 updates: flight-recorder dumps for the fault and for the
   supervisor's restart, one of them holding actor, server and learner
   spans; the run's Perfetto export and every dump valid, in process and
   through ``python -m asyncrl_tpu_torch.obs validate``; the stall report
   rendered, its ``learner.queue_wait`` share printed beside the windows'
   time-weighted ``learner_stall_frac``; the last window's trace and
   recorder counters and a finite ``h2d_wait_ms_p95``; B1 once an update
   and nothing else; spans an update by thread group; the cost of a span
   enabled and disabled, on one thread and on four at once, and from it
   the share of an actor step that tracing costs; the phase's seconds and
   device-memory growth. Run health (``health_sebulba_pong_impala``): the
   same geometry with per-thread inference, traced, ``obs_http_port=-1``,
   introspection on, ``health_window_ttl=2``, two ``actor.step`` crashes a
   few rounds in and enough windows for the storm to age out, the endpoint
   scraped every window: ``/healthz`` 503 ``critical`` inside the TTL and
   200 ``ok`` after, ``/metrics`` with ``asyncrl_fps`` and a device-memory
   sample, ``/timeseries?key=fps`` one point a window closed; every window's
   health, staleness, first-call and memory keys, ``staleness_mean`` equal
   to ``param_lag``, one learner geometry, the allocator's watermarks under
   the card's total memory, the storm's counter and its validated
   ``health.restart_storm`` dump, ``timeseries.jsonl`` one sample a window
   with platform ``gpu`` and the config's thresholds, the doctor's exit 0
   and 1 against a temporary history (``BENCH_HISTORY.json`` unchanged),
   no ``obs-http`` thread after ``close()``, B1 once an update and nothing
   else, memory growth under 512 MiB, the phase under 30 s; printed: ms a
   window drain with the health layer mounted and not, the scrapes' p50 ms,
   ``infer_recompile`` and ``compile_ms_p50``, events by detector. The
   elastic runtime (``elastic_sebulba_pong_impala``): the same geometry
   through the serve core, ``elastic=True`` up to 6 actors with the organic
   signals off, a checkpoint directory, traced, the transport checker on,
   40 updates in windows of 2: a scripted +2 and -3 around a ``pool.step``
   crash move the fleet 4 5 6 5 4 3, a slot a window (``actors_live`` the
   fleet a window ran with, one fewer only beside the crash), with
   ``elastic_scale_up`` 2, ``elastic_scale_down`` 3, one actor restart;
   ``staging_slabs_live`` ``auto_num_slabs`` of the fleet, at most 4 retired
   rings, every ring's slabs free after ``stop()``, every batch from the
   ring of the fragment drained; the serve core's registered clients the
   fleet's slots; each action behind one barrier save on disk before it;
   then a +1 whose ring build damages the weights and raises: one
   ``elastic_reconfigure_failed``, fleet and ring unchanged, the weights'
   SHA-256 that of the barrier's save; one ``elastic_scale`` annotation an
   action with JAX's keys and the ``elastic.*`` dumps; a one-actor agent
   with the stall bar at 0.01 grown to 2 in 12 updates without a restart;
   B1 once an update and nothing else, memory growth under 512 MiB, the
   phase under 45 s; printed: each action's ms split into the barrier's save
   and wait, the ring's pinned allocation, the slot and the swap, env
   steps/s at each fleet size, the serve core's full and deadline
   dispatches a window. The crash-consistent resume
   (``resume_sebulba_pong_impala``, ``RESUME_*``): the same geometry with
   per-thread inference, elastic up to 6 actors, a checkpoint every 2
   updates, traced, the health layer mounted; act 1 trains on a thread of
   its own (no signal is raised) and drains on a scripted preempt at the
   25th fragment hand-off after a scripted +1 scale; act 2 resumes it with
   ``resume=True`` to the same target. Gated, each a count, an equality or
   a bit-identity: one ``PreemptedExit``; the final checkpoint's
   ``run_state`` with JAX's eight keys; act 2 built at its update count
   (> 0) with act 1's drain-time weights (SHA-256); its first window at act
   1's drain-time fleet (5, not the configured 4) and ring, after one
   ``durability.fleet_restored`` dump; act 2 past act 1's updates and at
   the target; ``timeseries.jsonl`` with 2 ``meta`` lines, 1 ``resume``
   event with JAX's keys and 1 ``drain_preempt`` sample, env steps
   monotone, the window index going on from the checkpoint's cursor;
   finite losses; B1 once an update in each act and no other kernel;
   printed: the phase's seconds against its 30 s budget, each act's env
   steps/s, the resume's construction and fleet-rebuild ms, device memory
   before and after, the health verdict. The MuJoCo presets' line says why
   they were skipped (gymnasium). Every phase prints its seconds and the
   running total; one that raises prints ``chip_smoke: phase <name> failed
   after <s> s: <type>: <message>`` to stderr and stdout;
5. saves ``pong_t2t`` after one call into a git-ignored directory, restores
   it into a fresh trainer with ``restore=``, and checks that the next call
   of both gives the same state bit for bit, the CUDA generator's included,
   and that a save the next call overwrites in place at once (the writer
   still running) restores the saved state bit for bit;
   the same for ``pong_selfplay`` with an LSTM (the rival's weights and
   both carries in the state); and runs ``pong_selfplay`` with an LSTM at
   ``selfplay_refresh=2``: after update 1 the rival's weights differ from
   the learner's and its carry is nonzero, after update 2 they are the
   learner's bit for bit and the carry is zero;
6. learning lines: trains ``cartpole_a3c`` for its full 400,000 env steps,
   ``brax_ppo`` for its full 10,000,000 and ``cartpole_qlearn`` for 600,000
   (the JAX package's own learning test's budget), each at seeds 0, 1 and
   2, takes a 32-episode greedy eval (``max_steps=500``) after each, and
   fails if their mean is under the bar: half the JAX package's mean at the
   same budget for ``cartpole_a3c`` (``JAX_CARTPOLE_A3C_EVALS``), and for
   the other two a random policy's return plus half the gap from it to the
   JAX package's mean (Pendulum's returns are negative); then the JAX
   package's recurrent learning test's CartPole IMPALA-LSTM (500,000 env
   steps, seeds 0-2), held to that test's own criterion on the training
   return: the mean of the last three windows above max(2 x the first, 60);
   then the JAX package's HalfCheetah PPO learning test (512 envs, 150
   updates, seed 0: the last window's training return above the first's
   by 100 and above 100) and its Breakout learning test (``breakout_impala``
   at 128 envs, lr 1e-3, 800,000 steps, seeds 0-2), gated on the training
   return's rise (at least half the JAX package's), the greedy eval's rise
   printed beside it. The IMPALA-LSTM, HalfCheetah and Breakout lines run
   in two spawned processes beside the other three (``WORKER_LINES``), on
   the same card, since each process leaves it idle most of the time; in
   three more, ``pendulum_native_ppo`` (the host path) for its 2,000,000
   steps, a seed (0-2) a process, by the gap rule against the JAX
   package's mean; and in one more ``cartpole_a3c_cpu``
   (``backend="cpu_async"``, everything on the CPU) for its 200,000 steps,
   which must launch no CUDA kernel and take no device memory, and whose
   16-episode greedy eval must be above 60, the JAX package's test's bar.
   These processes start once the last profiled phase (the host path's) is
   done, beside the command lines, the time-sharded check and the round
   trips, since every one of them is bound by its own host threads;
7. prints one JSON line about the kernels, then the result line
   ``{"ok": true, "device": {...}}`` last.

It exits non-zero without a result when CUDA is missing or any phase fails,
a preset that does not fit on the card included. Weights are random, from
a seed. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import hashlib
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

# Path shapes (T, B) of the fused V-trace kernel (brax_ppo's and
# procgen_ppo's GAE ride it by default; on the mesh phases each rank's
# shard), a ragged one, and one longer than a time chunk whose rows are off
# the 16-byte grid.
VTRACE_SHAPES = {
    "atari_impala": (32, 1024), "pong_impala": (32, 256), "brax_ppo": (64, 8192),
    "ragged": (37, 1000), "atari_impala_mesh8_rank": (32, 128),
    "pong_impala_mesh8_rank": (32, 32), "long_ragged": (257, 1001), "cartpole": (32, 64),
    "procgen_ppo": (16, 4096), "procgen_ppo_mesh8_rank": (16, 512),
    "cartpole_qlearn": (32, 128), "atari_impala_wide_chunk": (32, 64),
    "hopper_ppo": (32, 8192),
    # The host path's learner takes one actor's fragment an update; on 8
    # data-parallel ranks each rank's 8 columns of it.
    "sebulba_pendulum_native_ppo": (64, 32), "sebulba_pong_impala": (32, 64),
    "sebulba_pong_impala_mesh8_rank": (32, 8),
    # pong_serve: one of its 2 actors' fragments, 16 steps of 8 envs.
    "serve_pong_serve": (16, 8),
}
# Path shapes of the scan kernels, each with the floats its inputs start
# into a larger buffer: brax_ppo's GAE, pong_impala's lax V-trace, a ragged
# [T, ...] whose 7 x 143 = 1001 columns leave every row but one in four off
# the 16-byte grid that bulk copies need, one longer than several time
# chunks, brax_ppo's shape with both base pointers off that grid, and one
# on the grid whose last time chunk and last block of columns are partial
# (B3's tiles reach past T and N).
SCAN_SHAPES = {
    "brax_ppo": ((64, 8192), 0), "pong_impala": ((32, 256), 0), "ragged": ((37, 7, 143), 0),
    "long_ragged": ((257, 1001), 0), "offset": ((64, 8192), 1), "tile_edges": ((37, 1004), 0),
}
# Ring sizes of B4 (ranks sharing the card) and its ragged payload size.
RING_RANKS = (2, 4, 8)
RING_RAGGED = 1031
# Floats of the scratch tensor written between calls to time a kernel (and
# B4's library call) with a cold L2 (50 MB on an H100): 128 MB.
L2_FLUSH_FLOATS = 32 << 20
MESH_RANKS = 8  # ranks of the mesh phases
UPDATES = 4  # update calls per training phase; the fps window is the last half
# Calls of the phases whose calls fuse several updates (pong_t2t: 32 each).
FUSED_CALLS = 2
# NVIDIA H100 SXM published peaks (data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Entropy of one Gaussian dim at log_std 0, brax_ppo's init: 0.5 log(2 pi e).
GAUSSIAN_ENTROPY = 0.5 * math.log(2 * math.pi * math.e)
# The kernels, by wrapper counter, as the kernels line names them.
KERNELS = ("fused_vtrace", "linear_scan", "linear_scan_dma", "ring_all_reduce")
# Training phases: (phase name, preset, config overrides, data-parallel
# ranks, launches of each kernel per update; every other kernel must not
# launch). On a mesh B1 runs once a rank, and B4 once an IMPALA update or
# once a minibatch step of PPO (procgen_ppo: 2 epochs x 8 minibatches).
MESH = {"fused_vtrace": MESH_RANKS, "ring_all_reduce": 1}
PPO_MESH = {"fused_vtrace": MESH_RANKS, "ring_all_reduce": 2 * 8}
# Chunks of atari_impala_wide's grad_accum: B1 runs once a chunk.
WIDE_CHUNKS = 4
PHASES = (
    ("atari_impala", "atari_impala", {}, 1, {"fused_vtrace": 1}),
    ("pong_impala", "pong_impala", {}, 1, {"fused_vtrace": 1}),
    ("brax_ppo", "brax_ppo", {}, 1, {"fused_vtrace": 1}),
    ("brax_ppo_lax_kernel", "brax_ppo", {"fused_scan": "lax", "scan_impl": "kernel"}, 1,
     {"linear_scan": 1}),
    ("brax_ppo_lax_kernel_dma", "brax_ppo", {"fused_scan": "lax", "scan_impl": "kernel_dma"}, 1,
     {"linear_scan_dma": 1}),
    ("pong_impala_lax_kernel", "pong_impala", {"fused_scan": "lax", "scan_impl": "kernel"}, 1,
     {"linear_scan": 1}),
    ("pong_impala_mesh8_ring", "pong_impala", {"grad_reduce": "ring"}, MESH_RANKS, MESH),
    ("atari_impala_mesh8_ring", "atari_impala", {"grad_reduce": "ring"}, MESH_RANKS, MESH),
    ("cartpole_a3c", "cartpole_a3c", {}, 1, {"fused_vtrace": 1}),
    ("cartpole_a3c_lax_kernel", "cartpole_a3c", {"fused_scan": "lax", "scan_impl": "kernel"}, 1,
     {"linear_scan": 1}),
    ("cartpole_a3c_lax_kernel_dma", "cartpole_a3c",
     {"fused_scan": "lax", "scan_impl": "kernel_dma"}, 1, {"linear_scan_dma": 1}),
    ("cartpole_impala", "cartpole_impala", {}, 1, {"fused_vtrace": 1}),
    # One in-training eval, after the second call.
    ("pong_t2t", "pong_t2t", {"eval_every": FUSED_CALLS}, 1, {"fused_vtrace": 1}),
    ("procgen_ppo", "procgen_ppo", {}, 1, {"fused_vtrace": 1}),
    ("procgen_ppo_mesh8_ring", "procgen_ppo", {"grad_reduce": "ring"}, MESH_RANKS, PPO_MESH),
    ("cartpole_qlearn", "cartpole_qlearn", {}, 1, {"fused_vtrace": 1}),
    ("pong_qlearn", "pong_qlearn", {}, 1, {"fused_vtrace": 1}),
    ("pong_qlearn_lax_kernel_dma", "pong_qlearn", {"fused_scan": "lax", "scan_impl": "kernel_dma"},
     1, {"linear_scan_dma": 1}),
    ("pong_qlearn_mesh8_ring", "pong_qlearn", {"grad_reduce": "ring"}, MESH_RANKS, MESH),
    ("atari_impala_wide", "atari_impala_wide", {}, 1, {"fused_vtrace": WIDE_CHUNKS}),
    ("brax_ppo_norm_rmsprop", "brax_ppo",
     {"normalize_obs": True, "normalize_returns": True, "optimizer": "rmsprop"}, 1,
     {"fused_vtrace": 1}),
    # LSTM cores (core_size 256, the JAX default) and self-play: the same
    # kernel launches an update as each one's base.
    ("pong_impala_lstm", "pong_impala", {"core": "lstm"}, 1, {"fused_vtrace": 1}),
    ("pong_impala_lstm_mesh8_ring", "pong_impala", {"core": "lstm", "grad_reduce": "ring"},
     MESH_RANKS, MESH),
    ("pong_qlearn_lstm", "pong_qlearn", {"core": "lstm"}, 1, {"fused_vtrace": 1}),
    ("procgen_ppo_lstm", "procgen_ppo", {"core": "lstm"}, 1, {"fused_vtrace": 1}),
    ("pong_selfplay", "pong_selfplay", {}, 1, {"fused_vtrace": 1}),
    ("pong_selfplay_lstm", "pong_selfplay", {"core": "lstm"}, 1, {"fused_vtrace": 1}),
    # Breakout, the ALE knobs, the Nature-CNN, the pixel t2t recipe (B1 once
    # a grad_accum chunk) and the planar locomotion family: each update's
    # V-trace or GAE rides B1.
    ("breakout_impala", "breakout_impala", {}, 1, {"fused_vtrace": 1}),
    ("breakout_pixels_impala", "atari_impala", {"env_id": "JaxBreakoutPixels-v0"}, 1,
     {"fused_vtrace": 1}),
    ("atari_impala_ale", "atari_impala", {"frame_skip": 4, "frame_pool": True,
                                          "sticky_actions": 0.25}, 1, {"fused_vtrace": 1}),
    ("atari_nature_cnn", "atari_impala", {"torso": "nature_cnn"}, 1, {"fused_vtrace": 1}),
    ("pong_t2t_ale4", "pong_t2t_ale4", {"eval_every": 0}, 1, {"fused_vtrace": 1}),
    ("pong_pixels_t2t", "pong_pixels_t2t", {"eval_every": 0}, 1, {"fused_vtrace": WIDE_CHUNKS}),
    ("hopper_ppo", "hopper_ppo", {}, 1, {"fused_vtrace": 1}),
    ("brax_humanoid_ppo", "brax_humanoid_ppo", {}, 1, {"fused_vtrace": 1}),
    # The MinAtar games: atari_impala with its env_id swapped, the JAX
    # package's own way of switching games (1024 envs of 10x10 planes).
    ("minatari_invaders", "atari_impala", {"env_id": "JaxSpaceInvaders-v0"}, 1,
     {"fused_vtrace": 1}),
    ("minatari_freeway", "atari_impala", {"env_id": "JaxFreeway-v0"}, 1, {"fused_vtrace": 1}),
    ("minatari_asterix", "atari_impala", {"env_id": "JaxAsterix-v0"}, 1, {"fused_vtrace": 1}),
    ("minatari_seaquest", "atari_impala", {"env_id": "JaxSeaquest-v0"}, 1, {"fused_vtrace": 1}),
)
# The command lines, run as a user runs them, from the repository's root:
# cli.train on pong_impala for CLI_UPDATES updates (its B1 launches read
# from its --profile trace), and cli.launch as two gloo processes sharing
# the card for LAUNCH_UPDATES updates (each prints its kernel counters on
# stderr through LAUNCH_WRAPPER), held to the one-process (dcn=2, dp=1)
# mesh. Each subprocess gets SUBPROCESS_TIMEOUT_S.
ROOT = Path(__file__).resolve().parent
CLI_UPDATES = UPDATES
LAUNCH_UPDATES = UPDATES
SUBPROCESS_TIMEOUT_S = 300
LAUNCH_WRAPPER = """\
import json, runpy, sys
from asyncrl_tpu_torch.ops import fused_vtrace as fv, linear_scan as ls, ring_reduce as rr
sys.argv = ["asyncrl_tpu_torch.cli.launch", *sys.argv[1:]]
code = 0
try:
    runpy.run_module("asyncrl_tpu_torch.cli.launch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code
print("launches " + json.dumps({"fused_vtrace": fv.launches, **ls.launches,
                                "ring_all_reduce": rr.launches}), file=sys.stderr)
sys.exit(code)
"""
# The time-sharded recurrences: (T, B) and the sp shards, held to the
# unsharded port functions at the JAX package's own bound.
TIMESHARD_SHAPE = (256, 1024)
TIMESHARD_SHARDS = 4
TIMESHARD_TOL = dict(rtol=1e-5, atol=1e-6)
# The population phase: PopulationTrainer(pong_impala, pop_size=POP_SIZE),
# B1 once a member an update; member POP_CHECKED is held to a standalone run
# at seed + POP_CHECKED after POP_CALLS calls.
POP_SIZE = 4
POP_CHECKED = 2
POP_CALLS = 2
# The JAX package's locomotion learning test (tests/test_locomotion.py::
# test_halfcheetah_ppo_learns): PPO on HalfCheetah, 512 envs, 150 updates,
# seed 0, windows of 25 updates; its criterion is on the training return:
# the last window above the first by 100 and above 100.
LOCOMOTION_LINE = dict(env_id="JaxHalfCheetah-v0", algo="ppo", num_envs=512, unroll_len=32,
                       total_env_steps=512 * 32 * 150, learning_rate=3e-4, gamma=0.99,
                       entropy_coef=0.001, reward_scale=0.1, ppo_epochs=4, ppo_minibatches=8,
                       precision="f32", log_every=25)
# The JAX package's Breakout learning test (tests/test_breakout.py::
# test_breakout_vector_learns): breakout_impala at 128 envs, lr 1e-3, f32,
# 800,000 env steps, at LEARNING_SEEDS. That test asks the 32-episode greedy
# eval at max_steps=3000 to rise by more than 3.0; the line prints that
# rise, but it does not discriminate at this budget (the JAX package's own
# rise on the CPU is 2.0, 0.6 and 10.4 at seeds 0-2: a greedy policy's
# return depends on its random init), so the line is gated as the
# recurrent one is, on the training return: the mean over the seeds of the
# last three windows must exceed the mean of the first windows by half the
# JAX package's own rise (the gap rule of the other lines).
BREAKOUT_LINE = dict(num_envs=128, learning_rate=1e-3, precision="f32", log_every=20)
BREAKOUT_LINE_STEPS = 800_000
BREAKOUT_EVAL_MAX_STEPS = 3000
BREAKOUT_EVAL_RISE = 3.0
# The learning lines that run in spawned processes beside the main one's
# (LEARNING_LINES), one process a group, and the longest the main process
# waits for them after its own. One after the other on an H100 machine's
# host, the lines took: HalfCheetah 320 s, the IMPALA-LSTM 177 s, Breakout
# 90 s, and the main process's three 236 s.
WORKER_LINES = (("halfcheetah_ppo",), ("cartpole_impala_lstm", "breakout_impala"),
                ("pendulum_native_ppo_seed0",), ("pendulum_native_ppo_seed1",),
                ("pendulum_native_ppo_seed2",), ("cpu_async_cartpole_a3c",))
LEARNING_WORKER_TIMEOUT_S = 900
# The host path (backend="sebulba"): (phase, preset, overrides[, mesh]).
# Each runs SEBULBA_WINDOWS windows of SEBULBA_LOG_EVERY updates, an update
# one actor's fragment, B1 once an update on one rank; host_pool="native"
# is explicit, so a failed build of the C++ pool fails the phase. A mesh
# (shape, axes) is that many ranks sharing the card, passed to
# SebulbaTrainer(mesh=...): B1 once a data-parallel rank an update on an
# unsharded time axis and never on a time-sharded one (the two-level solves
# of parallel/timeshard.py), B4 once an update with grad_reduce="ring".
HOST_PONG = {"backend": "sebulba", "actor_threads": 4}
SERVER = {"inference_server": True, "serve": False}
# Tolerance of a time-sharded update against its dp-only twin: the JAX
# package's own test's (tests/test_timeshard.py).
SP_TWIN_TOL = dict(rtol=5e-5, atol=1e-6)
SP_TIMED = 3  # timed runs of a time-sharded update and of its dp-only twin
SEBULBA_PHASES = (
    ("sebulba_pendulum_native_ppo", "pendulum_native_ppo", {}),
    ("sebulba_pong_impala", "pong_impala", HOST_PONG),
    # The host path's second slice: the shared inference server ("ff" and
    # "rec"), the device replay ring (IMPACT), per-thread epsilon-greedy
    # Q-learning ("eps") and DRQN ("rec_eps").
    ("sebulba_pong_impala_server", "pong_impala", {**HOST_PONG, **SERVER}),
    ("sebulba_pong_impala_replay", "pong_impala", {**HOST_PONG, "replay_slabs": 4,
                                                   "replay_passes": 2}),
    ("sebulba_pong_qlearn", "pong_qlearn", HOST_PONG),
    ("sebulba_pong_impala_lstm_server", "pong_impala", {**HOST_PONG, **SERVER, "core": "lstm"}),
    ("sebulba_pong_qlearn_lstm", "pong_qlearn", {**HOST_PONG, "core": "lstm"}),
    # The host learner's mesh: 8 data-parallel ranks with the ring (B1 8 and
    # B4 1 an update), and the time-sharded (dp=2, sp=4) learner on Pong
    # (held to its (2,) dp twin) and on Pendulum's multipass PPO (held to
    # itself: deterministic, finite, moving).
    ("sebulba_pong_impala_mesh8_ring", "pong_impala", {**HOST_PONG, "grad_reduce": "ring"},
     ((8,), ("dp",))),
    ("sebulba_pong_impala_dp2_sp4", "pong_impala", HOST_PONG, ((2, 4), ("dp", "sp"))),
    ("sebulba_pendulum_native_ppo_dp2_sp4", "pendulum_native_ppo", {}, ((2, 4), ("dp", "sp"))),
)
SEBULBA_WINDOWS = 4
SEBULBA_LOG_EVERY = 2
SEBULBA_EVAL_EPISODES = 32
# The serving tier (serve_pong_serve): windows of SEBULBA_LOG_EVERY updates
# before the wire load, under it, and after the serve core's kill; the load
# runs at least SERVE_MIN_LOAD_S (the bulk bucket, 25 tokens refilled at 50
# a second, empties in half a second at twice its rate). Each load is
# (name, tenant, requests a second, endpoint), SERVE_ROWS observations a
# request under a SERVE_CLIENT_DEADLINE_MS budget.
SERVE_QUIET_WINDOWS = 2
SERVE_LOAD_WINDOWS = 4
SERVE_AFTER_WINDOWS = 2
SERVE_MIN_LOAD_S = 3.0
SERVE_LOADS = (("gold0", "gold", 50.0, "act"), ("gold1", "gold", 50.0, "act"),
               ("bulk", "bulk", 100.0, "act"), ("evaluate", "", 10.0, "evaluate"))
SERVE_ROWS = 8
SERVE_CLIENT_DEADLINE_MS = 2000.0
# Time for the stopped bulk client's bucket to hold a token again before
# the outage probe (one token takes 20 ms at 50 a second).
SERVE_OUTAGE_REFILL_S = 0.1
# A served log-prob against log_softmax of the snapshot's plain forward on
# the same rows: the dispatch and the plain forward run the same kernels on
# the same batch shape, so only the last bits of the log_softmax may differ.
SERVE_LOGP_TOL = 1e-5
SERVE_FINAL_REQUESTS = 8  # 8-row requests served from the final snapshot
# Device memory the outage may add: a few cuBLAS workspaces (32 MiB each,
# one a handler thread on the backend's side stream), not one a stale answer.
SERVE_OUTAGE_BYTES = 512 << 20
SERVE_POP_REQUESTS = 20  # answers a member before, and again after, the republish
# The replicated fleet (serve_fleet_pong_impala) and the drain
# (drain_pong_serve): FLEET_CLIENTS gold clients in the load process, each
# FLEET_RPS requests a second of its own FLEET_ROWS Pong observations (256
# rows in all, pong_impala's env count), keeping every answer's actions and
# log-probs. A fleet core dispatches one request (max_batch_rows=FLEET_ROWS),
# so a served log-prob and the plain forward run on the same rows and batch
# shape (SERVE_LOGP_TOL, the bound of the other serving phases).
FLEET_CLIENTS = 4
FLEET_ROWS = 64
FLEET_RPS = 25.0
FLEET_TENANTS = "gold:stale:p95_ms=250,inflight=32;*:fallback"
FLEET_REPLICAS = 3
FLEET_UPDATES = 4  # learner updates (B1 each) before the next version's publish
# The fleet.replica kill of r0 fires on this maintenance tick (50 ms each,
# from the fleet's start), once the load has run for a while.
FLEET_KILL_TICK = 60
FLEET_EVENT_TIMEOUT_S = 20.0
FLEET_AFTER_S = 1.0  # serving after each event
# The poisoned version: the policy head's logits negated and scaled. A
# freshly initialised head (orthogonal, gain 0.01) gives logits about 0.002
# apart: negated alone, the policy moves by a total variation of 0.001,
# which no window of sampled actions resolves. Scaled, each row plays the
# fresh policy's least likely action, and a client's 64 rows put about
# half their mass on one action (a total variation of about 0.5 from the
# fresh policy, measured on the CPU).
FLEET_POISON_SCALE = 1e4
# The canary's windows: 256 sampled actions a version (4 answers). Between
# two such windows of one near-uniform policy the total variation stayed
# under 0.22 in 20,000 draws, and between the fresh and the poisoned
# policies over 0.37 (a simulation of both action distributions).
FLEET_CANARY_WINDOW = 256
FLEET_CANARY_DIVERGENCE = 0.3
# Device memory the kill and rebuild may add: a new core is a new thread and
# CUDA stream, a cuBLAS workspace each (32 MiB), not one an answer.
FLEET_REBUILD_BYTES = 512 << 20
DRAIN_WINDOWS = 4  # the child's windows before the SIGTERM
DRAIN_LOAD_S = 2.0  # and at least this much wire load before it
DRAIN_GRACE_S = 30.0  # pong_serve's default drain_grace_s
DRAIN_AFTER_S = 2.0  # wire load after the signal
DRAIN_DIR = str(Path(__file__).resolve().parent / "chip_smoke_drain")
# Supervision (supervision_sebulba_pong_impala): sebulba_pong_impala's
# geometry under the heartbeat watchdog, each injected stall far longer than
# the run, each fault staged past the first fragments. A watchdog restart
# must come between the timeout and SUPERVISION_DETECT_SLACK_S after it.
SUPERVISION_TIMEOUT_S = 2.0
SUPERVISION_STALL_S = 60.0
SUPERVISION_DETECT_SLACK_S = 2.0
SUPERVISION_WALL_S = 30.0  # each part's training, against the 60 s stalls
# (i) actors: the hand-off stall after 2 rounds of the 4 threads' fragments,
# the crash after 2 rounds of their steps, the pool stall after 4 (the
# thread stalled at its hand-off steps no more, so each fault takes a live
# thread); the healthy threads carry the run meanwhile, for
# SUPERVISION_ACTOR_UPDATES fragments.
SUPERVISION_ACTOR_FAULTS = (
    f"actor.queue_put:stall:1.0:0:max=1,stall_s={SUPERVISION_STALL_S:g},after=8;"
    "actor.step:crash:1.0:0:max=1,after=256;"
    f"pool.step:stall:1.0:0:max=1,stall_s={SUPERVISION_STALL_S:g},after=512")
SUPERVISION_ACTOR_UPDATES = 96
# (ii) the coalescing server: a crash after 64 served rounds (2 fragments of
# 32 steps), then, re-armed for a second train call, a 60 s stall after 64.
SUPERVISION_SERVER_CRASH = "server.serve:crash:1.0:0:max=1,after=64"
SUPERVISION_SERVER_STALL = (
    f"server.serve:stall:1.0:0:max=1,stall_s={SUPERVISION_STALL_S:g},after=64")
SUPERVISION_SERVER_UPDATES = (24, 56)  # the two calls' cumulative targets
# (iii) checkpoints every 2 updates, the save site crashing twice; 6 updates
# leave the 3 periodic steps the checkpointer keeps.
SUPERVISION_CKPT_FAULTS = "checkpoint.save:crash:1.0:0:max=2"
SUPERVISION_CKPT_UPDATES = 6
SUPERVISION_CKPT_DIR = str(Path(__file__).resolve().parent / "chip_smoke_supervision")
SUPERVISION_BYTES = 512 << 20
# Tracing and forensics (trace_sebulba_pong_impala): sebulba_pong_impala's
# geometry with the coalescing server, traced, one actor crash; the span
# cost on TRACE_SPAN_THREADS threads of TRACE_SPANS spans each. The crash
# comes after 2 rounds of the 4 threads' 32 steps: a crash at the first step
# is reaped by the drain's first supervision, before the learner has closed
# a span, and then no dump can hold the learner's.
TRACE_UPDATES = 16
TRACE_FAULTS = "actor.step:crash:1:0:max=1,after=256"
TRACE_GROUPS = ("actor", "server", "learner")
TRACE_SPANS = 200_000
TRACE_SPAN_THREADS = 4
TRACE_PHASE_S = 30.0
TRACE_STALL_GAP = 0.10  # |report's queue-wait share - learner_stall_frac|, printed
TRACE_DIR = str(Path(__file__).resolve().parent / "chip_smoke_trace")
# Run health (health_sebulba_pong_impala): sebulba_pong_impala's geometry with
# per-thread inference, traced, the endpoint on an ephemeral port, and a
# crash storm of two actor.step crashes after 2 rounds of the 4 threads' 32
# steps; windows of HEALTH_LOG_EVERY updates, so that both restarts fall in
# one window, and enough of them after the storm for it to age out of the
# TTL. observe_window is timed HEALTH_DRAINS times, mounted and not.
HEALTH_UPDATES = 32
HEALTH_LOG_EVERY = 4
HEALTH_TTL = 2
HEALTH_FAULTS = "actor.step:crash:1:0:max=2,after=256"
HEALTH_BYTES = 512 << 20
HEALTH_PHASE_S = 30.0
HEALTH_DRAINS = 200
HEALTH_DIR = str(Path(__file__).resolve().parent / "chip_smoke_health")
# The elastic runtime (elastic_sebulba_pong_impala): sebulba_pong_impala's
# geometry through the serve core, elastic up to 6 actors with the organic
# signals off (JAX's _elastic_config), a checkpoint directory under
# ELASTIC_DIR so that every action runs behind a real barrier save, traced
# (the flight recorder's elastic.* dumps) with the endpoint on an ephemeral
# port, the transport checker on. Act 1: a +2 scale at actor.step after 2
# rounds of the 4 threads' 32 steps, a pool.step crash after ~19 fragments'
# steps, a -3 scale at the 21st actor.queue_put; the fleet goes 4 5 6 5 4 3,
# a slot a window. Act 2: with the script spent, a +1 whose ring build
# damages the weights and raises once. Act 3: a second agent of one actor,
# a max of 2, cooldown 0, the stall bar 0.01 and no fault.
ELASTIC_UPDATES = 40
ELASTIC_LOG_EVERY = 2
ELASTIC_MAX_ACTORS = 6
ELASTIC_FAULTS = ("actor.step:scale:1:0:delta=2,max=1,after=256;"
                  "pool.step:crash:1:3:max=1,after=600;"
                  "actor.queue_put:scale:1:5:delta=-3,max=1,after=20")
ELASTIC_FLEET = [4, 5, 6, 5, 4, 3]
ELASTIC_ORGANIC_UPDATES = 12
ELASTIC_BYTES = 512 << 20
ELASTIC_PHASE_S = 45.0
# The slab-free check's copy waits behind this many cycles of
# torch.cuda._sleep (~0.2 s on an H100's ~1.98 GHz clock).
ELASTIC_SLEEP_CYCLES = 400_000_000
ELASTIC_DIR = str(Path(__file__).resolve().parent / "chip_smoke_elastic")
# The keys of an elastic_scale annotation (JAX's ScaleDecision.event).
ELASTIC_EVENT_KEYS = ["action", "actors_after", "actors_before", "detail", "event_type",
                      "reason", "scripted", "signals", "t"]
# The resume (resume_sebulba_pong_impala): sebulba_pong_impala's geometry (4
# threads of 64 native Pong envs, per-thread inference), elastic up to 6
# actors with the organic signals off, a checkpoint every 2 updates, traced,
# the health layer mounted with its stall and fps detectors off (JAX's resume
# test), all under RESUME_DIR. Act 1: a +1 scale at the first actor.step and a
# preempt at the 25th fragment hand-off (actor.queue_put), training toward
# RESUME_UPDATES on a thread of its own, so that the preempt reaches the drain
# as a direct request and no signal is raised in this process. The queue holds
# 8 fragments and 5 actors hold one each, so the learner is 12-25 updates in
# when it drains, and the scale landed at the first or second window close
# (2-4 updates). Act 2: the same config with resume=True and no fault, to the
# same target.
RESUME_UPDATES = 48
RESUME_LOG_EVERY = 2
RESUME_MAX_ACTORS = 6
RESUME_PREEMPT_AFTER = 24
RESUME_FAULTS = ("actor.step:scale:1.0:0:delta=1,max=1;"
                 f"actor.queue_put:preempt:1.0:0:max=1,after={RESUME_PREEMPT_AFTER}")
RESUME_PHASE_S = 30.0  # the phase's budget, printed beside its time, not gated
RESUME_DIR = Path(__file__).resolve().parent / "chip_smoke_resume"
# JAX's run_state and resume annotation keys (asyncrl_tpu/api/sebulba_trainer.py).
RESUME_RUN_STATE_KEYS = ["actor_restarts", "actors_live", "gateway_restarts", "next_actor_seed",
                         "rollback_attempts", "server_restarts", "updates", "window_idx"]
RESUME_EVENT_KEYS = ["actors", "env_steps", "event_type", "restored_update", "t"]
# The divergence rollback (rollback_sebulba_pong_impala): pong_impala on the
# host path at full width as the resume phase runs it (4 actor threads with
# their own inference, log_every=2), with the NaN guard and the policy armed
# (2 bad windows in a row restore, at most 3 restores), a checkpoint every 2
# update calls, and the JAX package's end-to-end corrupt burst: from the 17th
# fragment hand-off, 12 fragments' rewards turn NaN through the staging row.
# It runs inside the learning workers' block, where the main process would
# otherwise wait for them. Every gate is a count, an equality or a
# bit-identity, plus the phase's budget; the guard's cost is printed.
ROLLBACK_UPDATES = 48
ROLLBACK_LOG_EVERY = 2
ROLLBACK_FAULTS = "actor.queue_put:corrupt:1.0:0:max=12,after=16"
ROLLBACK_BYTES = 512 << 20
ROLLBACK_PHASE_S = 30.0
ROLLBACK_TIMED = 10  # timed updates, guard armed and off, on one fragment
ROLLBACK_DIR = Path(__file__).resolve().parent / "chip_smoke_ckpt" / "rollback"
# JAX's rollback annotation keys (asyncrl_tpu/runtime/durability.py), with
# the store's stamp.
ROLLBACK_EVENT_KEYS = ["action", "attempts", "detail", "detectors", "event_type", "t"]
# cartpole_a3c_cpu (backend="cpu_async": 4 actor threads of one CartPole env,
# A3C, everything on the CPU) for its 200,000 steps in a spawned process on
# one torch thread; its greedy eval (16 episodes, max_steps=500) must be
# above the JAX package's test's bar (tests/test_cpu_async.py).
CPU_ASYNC_EVAL_EPISODES = 16
CPU_ASYNC_BAR = 60.0
# pendulum_native_ppo at its 2,000,000 steps, seeds 0-2, a seed a spawned
# process (one seed took 270-290 s on an H100 machine's host, its learner's
# kernel issue the bound): the JAX package's evals and the random floor on
# the CPU (`JAX_PLATFORMS=cpu python tests/cartpole_a3c_parity.py
# jax|random pendulum_native_ppo`). The random floor is brax_ppo's: the
# same env under uniform torques.
JAX_PENDULUM_NATIVE_EVALS = (-164.00726452479154, -201.84705642333574, -158.87030664601025)
PENDULUM_NATIVE_STEPS = 2_000_000
# The JAX package's cartpole_a3c at its full budget, seeds 0, 1 and 2, each
# a 32-episode greedy eval at max_steps=500, measured on the CPU by
# `JAX_PLATFORMS=cpu python tests/cartpole_a3c_parity.py jax`; the port's
# three-seed mean must reach half their mean.
JAX_CARTPOLE_A3C_EVALS = (179.3125, 83.4375, 76.1875)
# The same for brax_ppo at its full 10,000,000 env steps and cartpole_qlearn
# at 600,000 (`... parity.py jax brax_ppo`, `... jax cartpole_qlearn`), and
# the mean over seeds 0-2 of 32 episodes of uniform actions on each env
# (`... parity.py random brax_ppo`, `... random cartpole_qlearn`). Their
# bar is random + (JAX mean - random) / 2: half the gap from random play.
JAX_BRAX_PPO_EVALS = (-849.2451171875, -778.9615478515625, -770.7603759765625)
JAX_CARTPOLE_QLEARN_EVALS = (83.65625, 61.9375, 82.3125)
RANDOM_PENDULUM_RETURN = -1147.4588216145833
RANDOM_CARTPOLE_RETURN = 25.354166666666668
LEARNING_SEEDS = (0, 1, 2)
# (preset, env steps, the JAX package's evals, a random policy's return;
# None: the bar is half the JAX mean).
LEARNING_LINES = (
    ("cartpole_a3c", 400_000, JAX_CARTPOLE_A3C_EVALS, None),
    ("brax_ppo", 10_000_000, JAX_BRAX_PPO_EVALS, RANDOM_PENDULUM_RETURN),
    ("cartpole_qlearn", 600_000, JAX_CARTPOLE_QLEARN_EVALS, RANDOM_CARTPOLE_RETURN),
)
# The JAX package's recurrent learning test (tests/test_recurrent.py::
# test_recurrent_cartpole_learns): IMPALA-LSTM on CartPole, the fields set
# on the Config defaults, 500,000 env steps. Its criterion is on the
# training return (greedy eval does not discriminate for an LSTM there):
# the mean of the last three windows above max(2 x the first window's, 60).
RECURRENT_LINE = dict(env_id="CartPole-v1", algo="impala", core="lstm", core_size=64,
                      num_envs=64, unroll_len=16, learning_rate=1e-3, precision="f32",
                      log_every=40)
RECURRENT_LINE_STEPS = 500_000
# The JAX package's (first window, mean of the last three) at seeds 0, 1 and
# 2, on the CPU: `JAX_PLATFORMS=cpu python tests/cartpole_a3c_parity.py jax
# cartpole_impala_lstm`.
JAX_RECURRENT_WINDOWS = ((27.77349281311035, 90.40292104085286),
                         (28.949554443359375, 108.79885609944661),
                         (28.750545501708984, 91.98917134602864))
# The JAX package's numbers for the two learning lines above, on the CPU
# (`JAX_PLATFORMS=cpu python tests/cartpole_a3c_parity.py jax
# halfcheetah_ppo_learning 0` and `... jax breakout_impala_learning`):
# HalfCheetah's training return by window, and Breakout's greedy evals
# (before, after) at seeds 0-2.
JAX_HALFCHEETAH_WINDOWS = (-3.788254499435425, 3.5679640769958496, 14.780814170837402,
                           48.51607894897461, 169.58786010742188, 304.0821228027344)
JAX_BREAKOUT_EVALS = ((6.78125, 7.28125, 7.84375), (8.78125, 7.84375, 18.28125))
# Breakout's training return at seeds 0-2, (first window, mean of the last
# three), from the same run.
JAX_BREAKOUT_WINDOWS = ((8.412036895751953, 11.25097688039144),
                        (9.669683456420898, 11.203525225321451),
                        (7.482300758361816, 12.531726837158203))
# Where the checkpoint round trip writes (git-ignored; removed after).
CKPT_DIR = str(Path(__file__).resolve().parent / "chip_smoke_ckpt")
# Device-kernel names in the profiler, by wrapper counter.
PROFILE_KEYS = {
    "fused_vtrace": "fused_vtrace_kernel(",
    "linear_scan": "linear_scan_kernel(",
    "linear_scan_dma": "linear_scan_dma_kernel",
    "ring_all_reduce": "ring_all_reduce_kernel<",
}
# The library call of B4, torch.sum over the ranks, in the profiler.
SUM_PROFILE_KEY = "reduce_kernel"


def log(msg: str) -> None:
    print(msg, flush=True)


def set_precision() -> None:
    """The presets run the torso in bf16 and the heads in f32; f32 matmuls
    stay full f32, f32 convolutions may use TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True


def time_ms(fn, reps: int = 20, trials: int = 7) -> float:
    """Median over ``trials`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over its memory rate or
    f32 operations over its peak rate, whichever is longer."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def counters() -> dict[str, int]:
    from asyncrl_tpu_torch.ops import fused_vtrace as fv
    from asyncrl_tpu_torch.ops import linear_scan as ls
    from asyncrl_tpu_torch.ops import ring_reduce as rr

    return {"fused_vtrace": fv.launches, **ls.launches, "ring_all_reduce": rr.launches}


def reset_counters() -> None:
    from asyncrl_tpu_torch.ops import fused_vtrace as fv
    from asyncrl_tpu_torch.ops import linear_scan as ls
    from asyncrl_tpu_torch.ops import ring_reduce as rr

    fv.launches = 0
    rr.launches = 0
    for name in ls.launches:
        ls.launches[name] = 0


def device_ms(fn, key: str, calls: int = 10, required: bool = False) -> float | None:
    """Device time per call of the kernel whose profiler name holds
    ``key``, over ``calls`` calls of ``fn`` under ``torch.profiler``; None
    if the profiler recorded no such kernel. With ``required``, a profile
    that misses it is taken once more, and a second miss fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2 if required else 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and key in e.key]
        if hits:
            return hits[0].self_device_time_total / hits[0].count / 1e3
    if required:
        raise AssertionError(f"the profiler recorded no kernel named {key!r}, twice")
    return None


def vtrace_inputs(T: int, B: int, seed: int) -> tuple[torch.Tensor, ...]:
    g = torch.Generator(device="cuda").manual_seed(seed)
    rho = torch.exp(0.5 * torch.randn(T, B, generator=g, device="cuda"))
    disc = 0.99 * (torch.rand(T, B, generator=g, device="cuda") > 0.05).float()
    return (
        rho.clamp(max=1.0),
        disc * rho.clamp(max=1.0),
        torch.randn(T, B, generator=g, device="cuda"),
        disc,
        torch.randn(T, B, generator=g, device="cuda"),
        torch.randn(B, generator=g, device="cuda"),
    )


def check_fused_vtrace() -> dict:
    """Kernel vs plain version, bit for bit, and their times: call and
    device time at every shape, and at brax_ppo's the device time with a
    cold L2 too."""
    from asyncrl_tpu_torch.ops import fused_vtrace as fv

    flush = torch.empty(L2_FLUSH_FLOATS, device="cuda")
    rows = {}
    for name, (T, B) in VTRACE_SHAPES.items():
        args = vtrace_inputs(T, B, seed=T * 7919 + B)
        out = fv.fused_vtrace(*args)
        ref = fv.fused_vtrace_plain(*args)
        torch.cuda.synchronize()
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        mismatched = sum(int((o != r).sum()) for o, r in zip(out, ref))
        if mismatched:
            raise AssertionError(
                f"fused_vtrace {name} {(T, B)}: {mismatched} elements differ from "
                f"the plain version (max abs err {err})"
            )
        # Bytes: five [T, B] inputs and the [B] bootstrap read once, three
        # [T, B] outputs written once. Operations: 11 f32 flops an element
        # (TD term 4, recurrence fma 2, vs 1, pg 4).
        rows[name] = {
            "T": T, "B": B, "max_abs_err": err,
            "ms": time_ms(lambda: fv.fused_vtrace(*args), reps=200),
            "device_ms": device_ms(lambda: fv.fused_vtrace(*args), PROFILE_KEYS["fused_vtrace"]),
            "plain_ms": time_ms(lambda: fv.fused_vtrace_plain(*args), reps=3, trials=5),
            **bound(4 * (5 * T * B + B + 3 * T * B), 11 * T * B),
        }
        if name == "brax_ppo":
            # Each timed call after 128 MB of writes, so it reads its
            # inputs from device memory and not from the L2.
            rows[name]["cold_l2_device_ms"] = device_ms(
                lambda: (flush.zero_(), fv.fused_vtrace(*args)), PROFILE_KEYS["fused_vtrace"],
                required=True)
        log(f"fused_vtrace {name} T={T} B={B}: bit-identical to plain; "
            + json.dumps(rows[name]))
    return rows


def check_linear_scan() -> dict:
    """Both scan kernels vs the plain version and vs each other, bit for
    bit, and their times: call and device time at every shape, and at
    brax_ppo's the device time with a cold L2 too."""
    from asyncrl_tpu_torch.ops import linear_scan as ls

    flush = torch.empty(L2_FLUSH_FLOATS, device="cuda")
    rows = {}
    for name, (shape, offset) in SCAN_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(math.prod(shape) + offset)
        n = math.prod(shape)
        # Discount-like coefficients (GAE's gamma * lambda * (1 - done)),
        # each input a contiguous view `offset` floats into its buffer.
        a = (0.94 * torch.rand(n + offset, generator=g, device="cuda"))[offset:].view(shape)
        b = torch.randn(n + offset, generator=g, device="cuda")[offset:].view(shape)
        ref = ls.linear_scan_plain(a, b)
        outs = {"linear_scan": ls.linear_scan(a, b), "linear_scan_dma": ls.linear_scan_dma(a, b)}
        torch.cuda.synchronize()
        for kernel, out in outs.items():
            differ = int((out != ref).sum())
            if differ or out.shape != ref.shape:
                raise AssertionError(
                    f"{kernel} {name} {shape}: {differ} elements differ from the plain version"
                )
        if not torch.equal(outs["linear_scan"], outs["linear_scan_dma"]):
            raise AssertionError(f"linear_scan and linear_scan_dma differ at {name} {shape}")
        T, N = shape[0], math.prod(shape[1:])
        plain_ms = time_ms(lambda: ls.linear_scan_plain(a, b), reps=3, trials=5)
        for kernel, out in outs.items():
            fn = getattr(ls, kernel)
            # Bytes: a and b read once, x written once. Operations: one fma
            # (2 f32 flops) an element.
            row = {
                "shape": list(shape), "offset_floats": offset, "T": T, "N": N,
                "max_abs_err": float((out - ref).abs().max()),
                "ms": time_ms(lambda: fn(a, b), reps=200),
                # Required at brax_ppo's shape: the kernels line reports it.
                "device_ms": device_ms(lambda: fn(a, b), PROFILE_KEYS[kernel], calls=20,
                                       required=name == "brax_ppo"),
                "plain_ms": plain_ms,
                **bound(4 * 3 * T * N, 2 * T * N),
            }
            if name == "brax_ppo":
                # Each timed call after 128 MB of writes, so it reads its
                # inputs from device memory and not from the L2.
                row["cold_l2_device_ms"] = device_ms(
                    lambda: (flush.zero_(), fn(a, b)), PROFILE_KEYS[kernel], calls=20,
                    required=True)
            rows[(kernel, name)] = row
            log(f"{kernel} {name} {shape} offset {offset}: bit-identical to plain and to its twin; "
                + json.dumps(rows[(kernel, name)]))
    return rows


def gradient_sizes() -> dict[str, int]:
    """Parameter counts of the mesh phases' models (their gradients' sizes),
    counted from the models themselves."""
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.envs import registry
    from asyncrl_tpu_torch.models.networks import build_model

    sizes = {}
    for name in ("pong_impala", "atari_impala", "procgen_ppo", "pong_impala_lstm"):
        preset, lstm, _ = name.partition("_lstm")
        cfg = getattr(presets, preset).replace(device="cpu", core="lstm" if lstm else "ff")
        model = build_model(cfg, registry.make(cfg.env_id, cfg).spec, torch.Generator())
        sizes[name] = sum(p.numel() for p in model.parameters())
    return sizes


def check_ring_bound(out: torch.Tensor, stacked: torch.Tensor, where: str) -> float:
    """Every rank's row is the same bits, and within the float fold bound
    (n-1) * eps * sum_r |x_r| of a plain sum, elementwise. Returns the
    largest error against the sum."""
    n = stacked.shape[0]
    if not bool((out == out[0]).all()):
        raise AssertionError(f"{where}: the ranks' rows differ")
    err = (out[0].double() - stacked.double().sum(0)).abs()
    limit = (n - 1) * torch.finfo(torch.float32).eps * stacked.double().abs().sum(0)
    if not bool((err <= limit).all()):
        raise AssertionError(f"{where}: {int((err > limit).sum())} elements outside the fold bound")
    return float(err.max())


def check_ring_reduce(sizes: dict[str, int]) -> dict:
    """B4 vs its plain version, bit for bit, at every ring size and payload,
    in the gradient path's layout (16-byte loads) and as a contiguous
    ``[n, D]`` (scalar loads where D is odd), and the times of both and of
    the library call (one ``torch.sum`` over the ranks: the same function,
    summed in another order), warm and, at the flagship point, with a cold
    L2."""
    from asyncrl_tpu_torch.ops import ring_reduce as rr

    flush = torch.empty(L2_FLUSH_FLOATS, device="cuda")
    rows = {}
    for n in RING_RANKS:
        for name, D in {**sizes, "ragged": RING_RAGGED}.items():
            g = torch.Generator(device="cuda").manual_seed(1_000_003 * n + D)
            contiguous = torch.randn(n, D, generator=g, device="cuda")
            # The gradient path's layout (ring_all_reduce_grads).
            x = rr.rows_buffer(n, D, "cuda").copy_(contiguous)
            ref = rr.ring_all_reduce_plain(x)
            outs = {"grads_layout": rr.ring_all_reduce(x),
                    "contiguous": rr.ring_all_reduce(contiguous)}
            torch.cuda.synchronize()
            for layout, out in outs.items():
                differ = int((out != ref).sum())
                if differ or out.shape != x.shape:
                    raise AssertionError(
                        f"ring_all_reduce n={n} {name} D={D} ({layout}): {differ} elements "
                        "differ from the plain version"
                    )
            out = outs["grads_layout"]
            err_vs_sum = check_ring_bound(out, x, f"ring_all_reduce n={n} {name}")
            if n == 2 and not torch.equal(out, (x[0] + x[1]).expand(2, D)):
                raise AssertionError(f"ring_all_reduce n=2 {name}: not the two-operand sum")
            # Bytes: the n payloads read once and the one reduced vector
            # written once (every rank's row is a view of it, as psum hands
            # every rank one tensor). Operations: n-1 adds an element.
            row = {
                "n": n, "D": D, "D_padded": rr._to_chunks(x[:1], n).numel(),
                "max_abs_err": float((out - ref).abs().max()),
                "max_abs_err_vs_sum": err_vs_sum,
                "ms": time_ms(lambda: rr.ring_all_reduce(x), reps=50),
                "device_ms": device_ms(lambda: rr.ring_all_reduce(x), PROFILE_KEYS["ring_all_reduce"]),
                "contiguous_ms": time_ms(lambda: rr.ring_all_reduce(contiguous), reps=50),
                "contiguous_device_ms": device_ms(lambda: rr.ring_all_reduce(contiguous),
                                                  PROFILE_KEYS["ring_all_reduce"]),
                "plain_ms": time_ms(lambda: rr.ring_all_reduce_plain(x), reps=3, trials=5),
                "library_ms": time_ms(lambda: torch.sum(x, 0), reps=50),
                "library_device_ms": device_ms(lambda: torch.sum(x, 0), SUM_PROFILE_KEY),
                **bound(4 * (n + 1) * D, (n - 1) * D),
            }
            if n == MESH_RANKS and name == "atari_impala":
                # Each timed call after 128 MB of writes, so it reads its
                # inputs from device memory and not from the L2.
                row["cold_l2_device_ms"] = device_ms(
                    lambda: (flush.zero_(), rr.ring_all_reduce(x)), PROFILE_KEYS["ring_all_reduce"])
                row["cold_l2_library_device_ms"] = device_ms(
                    lambda: (flush.zero_(), torch.sum(x, 0)), SUM_PROFILE_KEY)
            rows[(n, name)] = row
            log(f"ring_all_reduce n={n} {name} D={D}: bit-identical to plain in both layouts, "
                "ranks agree, within the fold bound of a sum"
                + (", = x0 + x1" if n == 2 else "") + "; " + json.dumps(row))
    return rows


def train_phase(phase: str, preset_name: str, overrides: dict, ranks: int,
                per_update: dict[str, int]) -> dict:
    """A preset at full width: a few updates through ``train()``, with the
    kernels counted; through ``make_agent`` on one rank, through
    ``Trainer(cfg, mesh=...)`` on ``ranks`` ranks sharing the card. A preset
    that does not fit on the card fails the phase."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.api.trainer import Trainer
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.learn.learner import (
        _ppo_multipass, accumulate_grads, algo_loss, draw_permutations, mesh_loss_and_grads,
        ppo_minibatch_grads, ppo_multipass, ppo_rank_samples, ppo_shuffle_size, shard_rollout,
        take_minibatch,
    )
    from asyncrl_tpu_torch.ops import ring_reduce as rr
    from asyncrl_tpu_torch.ops.normalize import normalizing_apply
    from asyncrl_tpu_torch.parallel.mesh import make_mesh, reduce_grads

    phase_t0 = time.perf_counter()
    preset = getattr(presets, preset_name)
    calls = UPDATES if preset.updates_per_call == 1 else FUSED_CALLS
    cfg = preset.replace(device="cuda", log_every=calls // 2, **overrides)
    steps_per_call = cfg.batch_steps_per_update * cfg.updates_per_call
    updates = calls * cfg.updates_per_call
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if ranks == 1:
        agent = asyncrl_tpu_torch.make_agent(cfg)
    else:
        agent = Trainer(cfg, mesh=make_mesh((ranks,), devices=[torch.device("cuda")] * ranks))
    reset_counters()
    history = agent.train(total_env_steps=calls * steps_per_call)
    torch.cuda.synchronize()
    launches = counters()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    last = history[-1]
    expected = {k: updates * per_update.get(k, 0) for k in KERNELS}
    if launches != expected or agent.state.update_step != updates:
        raise AssertionError(f"{phase}: {calls} calls of {cfg.updates_per_call} updates "
                             f"launched {launches}, expected {expected}")
    for window in history:
        bad = [k for k, v in window.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{phase}: non-finite metrics {bad}")
    evals = [w["eval_return"] for w in history if "eval_return" in w]
    if len(evals) != (1 if cfg.eval_every else 0):
        raise AssertionError(f"{phase}: {len(evals)} in-training evals in {len(history)} windows")
    if cfg.algo == "qlearn":
        # No policy entropy: the Q-values must be finite and the TD error
        # non-zero.
        if not (math.isfinite(last["mean_max_q"]) and last["td_abs"] > 0.0):
            raise AssertionError(f"{phase}: Q-learning metrics {last}")
    elif cfg.algo == "ppo" and agent.env.spec.continuous:
        dims = agent.env.spec.action_dim
        if abs(last["entropy"] - dims * GAUSSIAN_ENTROPY) > 0.15 * dims:
            raise AssertionError(f"{phase}: entropy {last['entropy']} far from "
                                 f"{dims * GAUSSIAN_ENTROPY} ({dims} Gaussian dims at log_std 0)")
    elif not 0.0 < last["entropy"] <= math.log(agent.env.spec.num_actions) + 1e-4:
        raise AssertionError(f"{phase}: entropy {last['entropy']} outside (0, log actions]")

    # Where an update's time goes: the rollout alone (the learner's
    # collect: the actor weights behind the stats, epsilon, the return
    # scale), and the learner alone (loss + backward over the chunks for
    # IMPALA and Q-learning, the whole multipass update for PPO), each timed
    # after a synchronize.
    state, learner = agent.state, agent.learner
    lcfg = learner.config
    model = normalizing_apply(state.params, state.obs_stats)
    target = normalizing_apply(state.actor_params, state.obs_stats) if lcfg.algo == "qlearn" else None
    torch.cuda.synchronize()
    t = time.perf_counter()
    state.actor, rollout, _ = learner.collect(state)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t

    # The loss through the kernel equals the loss through plain code on
    # this fragment (rank 0's shard of it on a mesh, its first chunk under
    # grad_accum): the kernel is the only difference between the two. Plain
    # code is the fused tail's plain version for B1, and the sequential scan
    # (the scan kernels' arithmetic) for B2 and B3, for V-trace, GAE and
    # n-step returns alike.
    parts = ranks * max(lcfg.grad_accum, 1)
    frag = shard_rollout(rollout, 0, parts) if parts > 1 else rollout
    plain = {"fused_scan": "plain"} if "fused_vtrace" in per_update else {"scan_impl": "sequential"}
    with torch.no_grad():
        plain_loss, _ = algo_loss(lcfg.replace(**plain), model, frag, learner.dist, target=target)
        kernel_loss, _ = algo_loss(lcfg, model, frag, learner.dist, target=target)
    if not torch.equal(plain_loss, kernel_loss) or not torch.isfinite(kernel_loss):
        raise AssertionError(f"{phase}: kernel loss {kernel_loss} vs plain {plain_loss}")
    remat = check_remat(lcfg, model, frag, learner.dist, target) if lcfg.remat else {}

    ring = {}
    if ranks > 1:
        # The ranks' gradients on this fragment (PPO: on the first minibatch
        # of each rank's samples, under the global advantage moments),
        # reduced through B4 (by the learner's entry point) and through the
        # plain ring: the same bits, every rank's row alike, and within the
        # fold bound of a plain sum (psum).
        if ppo_multipass(lcfg):
            samples = ppo_rank_samples(lcfg, model, rollout, ranks)
            first = torch.arange(ppo_shuffle_size(rollout, ranks) // lcfg.ppo_minibatches,
                                 device=rollout.rewards.device)
            grads, _, _ = ppo_minibatch_grads(
                lcfg, model, learner.dist, [take_minibatch(s, first) for s in samples],
                lcfg.entropy_coef)
        else:
            grads, _, _ = mesh_loss_and_grads(lcfg, model, rollout, learner.dist, ranks,
                                              target=target)
        stacked = torch.stack([torch.cat([g.reshape(-1) for g in gs]) for gs in grads])
        kernel_sum = torch.stack(
            [torch.cat([g.reshape(-1) for g in gs]) for gs in rr.ring_all_reduce_grads(grads)])
        plain_sum = rr.ring_all_reduce_plain(stacked)
        if not torch.equal(kernel_sum, plain_sum):
            raise AssertionError(f"{phase}: reduced gradient through B4 differs from the plain ring")
        ring = {
            "grad_size": stacked.shape[1],
            "grad_bit_identical_to_plain_ring": True,
            "grad_max_abs_err_vs_psum": check_ring_bound(kernel_sum, stacked, phase),
        }

    t = time.perf_counter()
    if ppo_multipass(lcfg):
        perms = draw_permutations(ppo_shuffle_size(rollout, ranks), lcfg.ppo_epochs,
                                  state.generator, ranks)
        _ppo_multipass(lcfg, model, learner.optimizer, state.opt_state, learner.dist,
                       rollout, perms, ranks=ranks, axes=learner.axes)
    elif ranks > 1:
        grads, _, _ = mesh_loss_and_grads(lcfg, model, rollout, learner.dist, ranks,
                                          target=target)
        reduce_grads(grads, learner.axes, lcfg.grad_reduce)
    else:
        accumulate_grads(lcfg, model, rollout, learner.dist, 1, target=target)
    torch.cuda.synchronize()
    learner_s = time.perf_counter() - t

    eval_return = agent.evaluate(num_episodes=32, max_steps=100)
    if not math.isfinite(eval_return):
        raise AssertionError(f"{phase}: eval return {eval_return}")
    profile = profile_update(agent, unprofiled_s=cfg.batch_steps_per_update / last["fps"])
    log(f"profile {phase}: " + json.dumps(profile))

    row = {
        "phase": phase,
        "preset": preset_name,
        "overrides": overrides,
        "ranks": ranks,
        "num_envs": cfg.num_envs,
        "unroll_len": cfg.unroll_len,
        "calls": calls,
        "updates_per_call": cfg.updates_per_call,
        "updates": updates,
        "launches_per_update": per_update,
        "launches": launches,
        "env_steps_per_s": last["fps"],
        "max_memory_allocated_bytes": peak,
        "rollout_s": rollout_s,
        ("ppo_multipass_s" if ppo_multipass(lcfg) else "learner_loss_backward_s"): learner_s,
        **ring,
        **remat,
        "wall_s_incl_setup": wall,
        "loss": last["loss"],
        **({"mean_max_q": last["mean_max_q"], "td_abs": last["td_abs"]} if cfg.algo == "qlearn"
           else {"entropy": last["entropy"]}),
        "loss_bit_identical_to_plain": True,
        **({"in_training_eval_return": evals[0]} if evals else {}),
        "eval_return_100_steps": eval_return,
        "device_idle_share": profile["device_idle_share"],
        "kernel_device_ms": {k: profile["kernel_device_ms"][k] for k in per_update},
        "phase_s": time.perf_counter() - phase_t0,
    }
    log(f"train {phase}: " + json.dumps(row))
    return row


def check_remat(cfg, model, frag, dist, target) -> dict:
    """The loss and gradients on ``frag`` with block remat and without it
    (the same weights), under cuDNN's deterministic algorithms so that only
    the recompute differs: within 1e-5 relative, the loss to itself and
    each gradient to its tensor's largest entry."""
    from asyncrl_tpu_torch.learn.learner import algo_loss

    torsos = [m for m in model.modules() if hasattr(m, "remat")]
    params = list(model.parameters())
    out = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=torch.backends.cudnn.allow_tf32):
        for remat in (True, False):
            for torso in torsos:
                torso.remat = remat
            loss, _ = algo_loss(cfg, model, frag, dist, target=target)
            out[remat] = (loss.detach(), torch.autograd.grad(loss, params))
    for torso in torsos:
        torso.remat = cfg.remat
    (loss_r, grads_r), (loss_p, grads_p) = out[True], out[False]
    loss_err = float((loss_r - loss_p).abs() / loss_p.abs().clamp(min=1e-30))
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(grads_r, grads_p))
    bitwise = bool(torch.equal(loss_r, loss_p)) and all(
        torch.equal(a, b) for a, b in zip(grads_r, grads_p))
    if not (loss_err <= 1e-5 and grad_err <= 1e-5):
        raise AssertionError(f"remat: loss rel err {loss_err}, grad rel err {grad_err}")
    return {"remat_loss_rel_err": loss_err, "remat_grad_rel_err": grad_err,
            "remat_bit_identical": bitwise}


def profile_update(agent, unprofiled_s: float) -> dict:
    """One more update under ``torch.profiler``: the device's busy time by
    kernel, and its idle share against the unprofiled update time (the
    training window's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # Device activity only, read from the raw trace: a mesh update's tens of
    # thousands of kernels would cost key_averages() more than the update.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        agent.state, _ = agent.learner.update_once(agent.state)
        torch.cuda.synchronize()
    kernels: dict[str, list] = {}  # name -> [count, total ms]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            entry = kernels.setdefault(e.name(), [0, 0.0])
            entry[0] += 1
            entry[1] += e.duration_ns() / 1e6
    busy_ms = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:8]

    def device_ms(key: str):
        hits = [(count, ms) for name, (count, ms) in kernels.items() if key in name]
        return hits[0][1] / hits[0][0] if hits else None

    return {
        "device_busy_ms": busy_ms,
        "update_ms_unprofiled": unprofiled_s * 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (unprofiled_s * 1e3)),
        "kernel_launches": sum(count for count, _ in kernels.values()),
        "kernel_device_ms": {k: device_ms(key) for k, key in PROFILE_KEYS.items()},
        "top_kernels": [
            {"name": name[:90], "ms": ms, "count": count} for name, (count, ms) in top
        ],
    }


def checkpoint_round_trip(preset_name: str = "pong_t2t", overrides: dict | None = None) -> dict:
    """The preset saves after one call; a fresh trainer restored from that
    save (``restore=``, read-only) and the run that did not stop each take
    the next call, and must end in the same state bit for bit: weights (the
    rival's too with self-play), Adam state, envs and carries, update count
    and the CUDA generator's state. Saves go through the checkpoint writer's
    thread: a save followed at once by a call that updates the state in
    place restores, bit for bit, the state it was taken of."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.utils.checkpoint import state_dict

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    overrides = overrides or {}
    cfg = getattr(presets, preset_name).replace(device="cuda", eval_every=0, log_every=1,
                                                **overrides)
    steps_per_call = cfg.batch_steps_per_update * cfg.updates_per_call
    try:
        t = time.perf_counter()
        run = asyncrl_tpu_torch.make_agent(cfg, checkpoint_dir=CKPT_DIR)
        run.train(total_env_steps=steps_per_call)  # saves on exit
        saved = run.checkpointer.all_steps()
        if saved != [cfg.updates_per_call]:
            raise AssertionError(f"checkpoint: saved steps {saved}, expected [{cfg.updates_per_call}]")
        restored = asyncrl_tpu_torch.make_agent(cfg, restore=CKPT_DIR)
        before = state_dict(restored.state)
        if not _flat_equal(before, state_dict(run.state)):
            raise AssertionError("checkpoint: the restored state differs from the saved one")
        run.state, run_metrics = run.learner.update(run.state)
        restored.state, restored_metrics = restored.learner.update(restored.state)
        torch.cuda.synchronize()
        after_run, after_restored = state_dict(run.state), state_dict(restored.state)
        if not _flat_equal(after_run, after_restored):
            differ = [k for k in after_run if not _leaf_equal(after_run[k], after_restored[k])]
            raise AssertionError(f"checkpoint: the next call differs after a restore: {differ[:8]}")
        if any(not torch.equal(run_metrics[k], restored_metrics[k]) for k in run_metrics):
            raise AssertionError("checkpoint: the next call's metrics differ after a restore")
        # The writer runs off this thread: a save that the next call
        # overwrites in place at once restores the state of the save.
        at_save = state_dict(run.state)
        step = next_step = run.state.update_step
        run.checkpointer.save(step, run.state, run.env_steps)
        run.state, _ = run.learner.update(run.state)
        run.checkpointer.wait()
        again = asyncrl_tpu_torch.make_agent(cfg, restore=CKPT_DIR)
        if again.state.update_step != step or not _flat_equal(state_dict(again.state), at_save):
            raise AssertionError("checkpoint: a save overwritten by the next call at once "
                                 "restores other bytes")
        row = {
            "preset": preset_name,
            "overrides": overrides,
            "saved_update_step": saved[0],
            "next_update_step": next_step,
            "leaves": len(after_run),
            "state_bytes": sum(v.numel() * v.element_size() for v in after_run.values()
                               if isinstance(v, torch.Tensor)),
            "next_call_bit_identical_after_restore": True,
            "saved_during_next_call_restores_bit_identical": True,
            "snapshot_device_bytes": run.checkpointer.snapshot_bytes,
            "cuda_generator_state_equal": torch.equal(after_run["generator"],
                                                      after_restored["generator"]),
            "wall_s": time.perf_counter() - t,
        }
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log("checkpoint round trip: " + json.dumps(row))
    return row


def selfplay_promotion() -> dict:
    """``pong_selfplay`` with an LSTM at ``selfplay_refresh=2``, two updates
    through ``make_agent``: after the first the rival's weights are the
    initial copy, not the learner's, and its carry has moved; after the
    second they are the learner's bit for bit and the carry is zero."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets

    agent = asyncrl_tpu_torch.make_agent(presets.pong_selfplay, device="cuda", core="lstm",
                                         selfplay_refresh=2)
    state = agent.state
    rows = []
    for step in (1, 2):
        state, _ = agent.learner.update(state)
        torch.cuda.synchronize()
        rival = list(state.opponent_params.parameters())
        learner = list(state.params.parameters())
        rows.append({
            "update_step": state.update_step,
            "rival_equals_learner": all(torch.equal(o, p) for o, p in zip(rival, learner)),
            "rival_carry_abs_sum": float(sum(c.abs().sum() for c in state.actor.opp_core)),
            "agent_carry_abs_sum": float(sum(c.abs().sum() for c in state.actor.core)),
        })
    first, second = rows
    if first["rival_equals_learner"] or not first["rival_carry_abs_sum"] > 0.0:
        raise AssertionError(f"selfplay promotion: after update 1 {first}")
    if not second["rival_equals_learner"] or second["rival_carry_abs_sum"] != 0.0:
        raise AssertionError(f"selfplay promotion: after update 2 {second}")
    row = {"preset": "pong_selfplay", "core": "lstm", "selfplay_refresh": 2, "updates": rows,
           "promoted_bit_identical_and_carry_zeroed": True}
    log("selfplay promotion: " + json.dumps(row))
    return row


def population_phase(reference_fps: float) -> dict:
    """``PopulationTrainer(pong_impala, pop_size=POP_SIZE)`` at full width
    (256 envs a member): ``POP_CALLS`` calls through ``train()``, B1 once a
    member an update and no other kernel, finite ``[pop]`` windows; member
    ``POP_CHECKED``'s whole state then equals a standalone
    ``make_agent(pong_impala, seed=seed + POP_CHECKED)`` after as many calls,
    bit for bit; ``evaluate()`` is a finite ``[pop]`` vector; one more call
    under the profiler. ``reference_fps``: ``pong_impala``'s rate alone in
    this run, for the rate per member."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.utils.checkpoint import state_dict

    phase = f"pong_impala_pop{POP_SIZE}"
    phase_t0 = time.perf_counter()
    preset = presets.pong_impala
    steps_per_call = preset.batch_steps_per_update
    cfg = preset.replace(device="cuda", log_every=1, total_env_steps=POP_CALLS * steps_per_call)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pop = asyncrl_tpu_torch.PopulationTrainer(cfg, pop_size=POP_SIZE)
    stamps = []
    reset_counters()
    t0 = time.perf_counter()
    history = pop.train(callback=lambda window: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    expected = {k: POP_CALLS * POP_SIZE * (k == "fused_vtrace") for k in KERNELS}
    if launches != expected or pop.state.update_step != POP_CALLS:
        raise AssertionError(f"{phase}: launched {launches}, expected {expected}")
    for window in history:
        bad = [k for k, v in window.items()
               if np.shape(v) not in ((), (POP_SIZE,)) or not np.all(np.isfinite(v))]
        if bad:
            raise AssertionError(f"{phase}: bad metrics {bad}")
    # The last call alone: every member's envs stepped once.
    call_s = stamps[-1] - stamps[-2]
    fps = POP_SIZE * steps_per_call / call_s

    solo = asyncrl_tpu_torch.make_agent(preset, device="cuda", seed=cfg.seed + POP_CHECKED)
    for _ in range(POP_CALLS):
        solo.state, _ = solo.learner.update(solo.state)
    torch.cuda.synchronize()
    member, alone = state_dict(pop.state.members[POP_CHECKED]), state_dict(solo.state)
    if not _flat_equal(member, alone):
        differ = [k for k in member if not _leaf_equal(member[k], alone.get(k))]
        raise AssertionError(f"{phase}: member {POP_CHECKED} differs from its standalone run: "
                             f"{differ[:8]}")
    evals = pop.evaluate()
    if evals.shape != (POP_SIZE,) or not np.all(np.isfinite(evals)):
        raise AssertionError(f"{phase}: evaluate() gave {evals}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pop.update()
        torch.cuda.synchronize()
    busy_ms, kernel_launches, vtrace = 0.0, 0, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy_ms += e.duration_ns() / 1e6
            kernel_launches += 1
            if PROFILE_KEYS["fused_vtrace"] in e.name():
                vtrace.append(e.duration_ns() / 1e6)
    profile_row = {
        "device_busy_ms": busy_ms, "call_ms_unprofiled": call_s * 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (call_s * 1e3)),
        "kernel_launches": kernel_launches, "fused_vtrace_in_profile": len(vtrace),
    }
    log(f"profile {phase}: " + json.dumps(profile_row))
    row = {
        "phase": phase, "preset": "pong_impala", "pop_size": POP_SIZE, "ranks": 1,
        "num_envs_per_member": cfg.num_envs, "unroll_len": cfg.unroll_len, "calls": POP_CALLS,
        "updates": POP_CALLS, "launches_per_update": {"fused_vtrace": POP_SIZE},
        "launches": launches,
        "env_steps_per_s": fps, "env_steps_per_s_per_member": fps / POP_SIZE,
        "pong_impala_env_steps_per_s_alone": reference_fps,
        "per_member_rate_vs_alone": fps / POP_SIZE / reference_fps,
        "max_memory_allocated_bytes": peak,
        "loss": history[-1]["loss"].tolist(), "entropy": history[-1]["entropy"].tolist(),
        f"member_{POP_CHECKED}_bit_identical_to_standalone": True,
        "member_leaves": len(member), "eval_returns": evals.tolist(),
        "device_idle_share": profile_row["device_idle_share"],
        "kernel_device_ms": {"fused_vtrace": statistics.mean(vtrace) if vtrace else None},
        "wall_s_incl_setup": time.perf_counter() - t0,
        "phase_s": time.perf_counter() - phase_t0,
    }
    log(f"train {phase}: " + json.dumps(row))
    return row, pop


class _ForwardCounter:
    """Wraps an inference callable: the batch rows of every call (a model
    forward), from any thread."""

    def __init__(self, fn):
        self._fn = fn
        self.rows: list[int] = []

    def __call__(self, params, obs, *rest):
        self.rows.append(int(obs.shape[0]))  # list.append: atomic under the GIL
        return self._fn(params, obs, *rest)


class _EpsilonRecorder:
    """Wraps the trainer's ``_epsilon_fn``: each thread's calls as
    ``(published env steps, thread frames, epsilons)``, a call dropped when
    a publish landed during it (its published count is then unknown)."""

    def __init__(self, agent):
        self._make = agent._epsilon_fn
        self._store = agent._store
        self.calls: dict[int, list] = {}
        self.dropped = 0

    def __call__(self, index: int):
        fn, calls = self._make(index), self.calls.setdefault(index, [])

        def record(thread_frames: int):
            before = self._store.env_steps()
            eps = fn(thread_frames)
            if self._store.env_steps() == before:
                calls.append((before, thread_frames, np.array(eps)))
            else:
                self.dropped += 1
            return eps

        return record


def check_epsilons(cfg, recorder: _EpsilonRecorder, envs_per_actor: int) -> dict:
    """Each thread's epsilons against ``qlearn_epsilon_at_frames`` at the
    global frames the trainer's rule gives: the published env steps plus
    the thread's frames since that publish times the threads, never going
    back. Exact; returns the counts."""
    from asyncrl_tpu_torch.learn.learner import qlearn_epsilon_at_frames

    checked = at_publish = 0
    for index, calls in recorder.calls.items():
        gidx = index * envs_per_actor + np.arange(envs_per_actor, dtype=np.float32)
        steps, base, floor = None, 0, 0.0
        for published, thread_frames, eps in calls:
            if published != steps:
                steps, base = published, thread_frames
            frames = max(float(published + (thread_frames - base) * cfg.actor_threads), floor)
            floor = frames
            want = qlearn_epsilon_at_frames(cfg, gidx, frames)
            if eps.dtype != np.float32 or not np.array_equal(eps, want):
                raise AssertionError(f"thread {index}: epsilon {eps[:4]} at {thread_frames} "
                                     f"thread frames (published {published}), want {want[:4]}")
            checked += 1
            at_publish += frames == published
    if not checked or not at_publish:
        raise AssertionError(f"epsilons checked {checked}, at a publish {at_publish}")
    return {"epsilon_calls_checked": checked, "epsilon_calls_at_publish": at_publish,
            "epsilon_calls_dropped_for_a_publish_race": recorder.dropped,
            "epsilon_equals_schedule": True}


def clone_learner_state(state):
    """A deep copy of a host learner's state, its generator's state too."""
    generator = torch.Generator(device=state.generator.device)
    generator.set_state(state.generator.get_state())
    return copy.deepcopy(state, memo={id(state.generator): generator})


def timeshard_checks(phase: str, agent, update, frag) -> dict:
    """The time-sharded learner's update on ``frag``, each from a copy of
    the trainer's state: it launches no kernel; with PPO's minibatches (no
    unsharded twin, the JAX test's criteria) the same state and slab give
    the same weights bit for bit, finite, and the weights move; otherwise,
    at the JAX test's precision (``precision="f32"``, an f32 copy of the
    model with the trainer's weights), it equals the same update of a
    dp-only twin learner (the mesh's data-parallel ranks, no time axis)
    within ``SP_TWIN_TOL``, on the weights and the loss. The trainer's own
    update and its dp-only twin at the preset's precision are timed (host
    ms to a synchronize, the median of ``SP_TIMED`` runs, the actors
    stopped)."""
    from asyncrl_tpu_torch.learn.learner import ppo_multipass
    from asyncrl_tpu_torch.learn.rollout_learner import RolloutLearner
    from asyncrl_tpu_torch.models.networks import build_model
    from asyncrl_tpu_torch.parallel.mesh import make_mesh

    def weights(state):
        return [p.detach().clone() for p in state.params.parameters()]

    def timed(fn):
        times = []
        for _ in range(SP_TIMED):
            state = clone_learner_state(agent.state)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = fn(state, frag)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return state, metrics, statistics.median(times)

    start = weights(agent.state)
    ranks = agent.learner.ranks
    twin = RolloutLearner(agent.config, agent.spec, agent.model,
                          make_mesh((ranks,), ("dp",), devices=[agent.learner.device] * ranks))
    torch.cuda.synchronize()
    reset_counters()
    sp_state, sp_metrics = update(clone_learner_state(agent.state), frag)
    torch.cuda.synchronize()
    launches = counters()
    sp_w, sp_loss = weights(sp_state), float(sp_metrics["loss"])
    moved = max(float((a - b).abs().max()) for a, b in zip(sp_w, start))
    again_state, again_metrics, sp_ms = timed(update)
    dp_state, dp_metrics, dp_ms = timed(twin.update)
    row = {"sp_update_launches": launches, "sp_update_ms": sp_ms, "dp_twin_update_ms": dp_ms,
           "sp_update_loss": sp_loss, "sp_update_moves_weights_max_abs": moved}
    finite = math.isfinite(sp_loss) and all(bool(w.isfinite().all()) for w in sp_w)
    if any(launches.values()) or not finite or moved == 0.0:
        raise AssertionError(f"{phase}: time-sharded update launched {launches}, loss "
                             f"{sp_loss}, moved the weights {moved}")
    if ppo_multipass(agent.learner.config) and agent.learner.config.ppo_minibatches > 1:
        same = (float(again_metrics["loss"]) == sp_loss
                and all(torch.equal(a, b) for a, b in zip(weights(again_state), sp_w)))
        if not same:
            raise AssertionError(f"{phase}: the time-sharded update is not deterministic")
        return {**row, "sp_update_bit_identical_twice": True}
    # The twins at f32: the presets' bf16 torso rounds the two reductions'
    # gradients apart by bf16's rounding, which Adam's step carries into the
    # weights at SP_TWIN_TOL itself, a tolerance set for f32.
    cfg32 = agent.config.replace(precision="f32")

    def f32_update(mesh):
        state = clone_learner_state(agent.state)
        model = build_model(cfg32, agent.spec, torch.Generator()).to(agent.learner.device)
        model.load_state_dict(state.params.state_dict())
        state.params = model
        state, metrics = RolloutLearner(cfg32, agent.spec, model, mesh).update(state, frag)
        return weights(state), float(metrics["loss"])

    sp32_w, sp32_loss = f32_update(agent.learner.mesh)
    dp32_w, dp32_loss = f32_update(twin.mesh)
    close = all(torch.allclose(a, b, **SP_TWIN_TOL) for a, b in zip(sp32_w, dp32_w))
    if not close or abs(sp32_loss - dp32_loss) > SP_TWIN_TOL["rtol"] * abs(dp32_loss):
        raise AssertionError(f"{phase}: f32 weights within {SP_TWIN_TOL} of the dp-only "
                             f"twin's {close}; loss {sp32_loss} against {dp32_loss}")
    dp_w, dp_loss = weights(dp_state), float(dp_metrics["loss"])
    return {**row, "sp_equals_dp_twin_f32": True, "dp_twin_loss": dp_loss,
            "sp_twin_f32_loss": [sp32_loss, dp32_loss],
            "sp_twin_f32_weights_max_abs_diff": max(float((a - b).abs().max())
                                                    for a, b in zip(sp32_w, dp32_w)),
            "sp_twin_weights_max_abs_diff": max(float((a - b).abs().max())
                                                for a, b in zip(sp_w, dp_w))}


def sebulba_phase(phase: str, preset_name: str, overrides: dict, mesh=None) -> dict:
    """The host path at the preset's full width through ``make_agent``, or
    on ``mesh`` (shape, axes; ranks sharing the card) through
    ``SebulbaTrainer(mesh=...)``: actor threads stepping the C++ pool, the
    pinned staging ring, the device rollout queue and the
    ``RolloutLearner``, for ``SEBULBA_WINDOWS`` windows of
    ``SEBULBA_LOG_EVERY`` fresh updates. Every update (replay passes
    included) launches B1 once a data-parallel rank on an unsharded time
    axis, B4 once with the ring, and no other kernel; the loss on the last
    drained slab (rank 0's columns on a mesh) is the same through B1 and
    through the plain version; with the ring, the ranks' gradients on it
    reduce through B4 to the plain ring's bits, within the fold bound of a
    plain sum; on a time-sharded mesh, ``timeshard_checks``. Every window
    is finite, copies one slab's bytes a fresh update, and no actor failed
    and no server died; one more update on that slab is profiled, and the
    model forwards an env step are counted. With the shared server, the
    most frequent round is all the envs; with the replay ring, every
    replayed row equals its published slab, the ring fills and holds
    ``replay_slabs`` slabs; with Q-learning, the target equals the weights
    right after each refresh and differs before it, and every thread's
    epsilons are the schedule's."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.api.sebulba_trainer import SebulbaTrainer
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.learn import replay as replay_lib
    from asyncrl_tpu_torch.learn.learner import (
        algo_loss, mesh_loss_and_grads, ppo_multipass, shard_rollout,
    )
    from asyncrl_tpu_torch.ops import ring_reduce as rr
    from asyncrl_tpu_torch.ops.normalize import normalizing_apply
    from asyncrl_tpu_torch.parallel.mesh import dp_size, make_mesh, time_shards
    from asyncrl_tpu_torch.rollout.buffer import rollout_leaves, rollout_map
    from asyncrl_tpu_torch.rollout.staging import fragment_template

    phase_t0 = time.perf_counter()
    passes = overrides.get("replay_passes", 2) if overrides.get("replay_slabs", 0) else 1
    cfg = getattr(presets, preset_name).replace(
        device="cuda", host_pool="native", log_every=SEBULBA_LOG_EVERY * passes, eval_every=0,
        **overrides)
    fresh = SEBULBA_WINDOWS * SEBULBA_LOG_EVERY
    updates = fresh * passes
    envs_per_actor = cfg.num_envs // cfg.actor_threads
    steps_per_update = envs_per_actor * cfg.unroll_len
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if mesh is None:
        agent = asyncrl_tpu_torch.make_agent(cfg)
    else:
        shape, axes = mesh
        agent = SebulbaTrainer(cfg, mesh=make_mesh(
            shape, axes, devices=[torch.device("cuda")] * math.prod(shape)))
    dp, sp = dp_size(agent.mesh), time_shards(agent.mesh)
    ring = agent.learner.config.grad_reduce == "ring"
    reductions = cfg.ppo_epochs * cfg.ppo_minibatches if ppo_multipass(cfg) else 1
    per_update = {"fused_vtrace": 0 if sp > 1 else dp,
                  "ring_all_reduce": reductions if ring else 0}
    forwards = _ForwardCounter(agent._inference_fn)
    agent._inference_fn = forwards
    epsilons = _EpsilonRecorder(agent) if cfg.algo == "qlearn" else None
    if epsilons is not None:
        agent._epsilon_fn = epsilons
    # The last slab the drain handed the learner, as the learner saw it,
    # and with a target network whether it equalled the weights after each
    # update.
    drained, target_equal = {}, []
    learner_update = agent.learner.update

    def update(state, rollout, perms=None):
        drained["rollout"] = rollout_map(torch.clone, rollout)
        state, metrics = learner_update(state, rollout, perms)
        if state.target_params is not None and cfg.algo == "qlearn":
            target_equal.append((state.update_step, all(
                torch.equal(t, p) for t, p in zip(state.target_params.parameters(),
                                                  state.params.parameters()))))
        return state, metrics

    agent.learner.update = update
    replayed = []
    consume = replay_lib.ReplayLease.consume
    if agent._replay is not None:
        ring = agent._replay
        published, ring_publish = {}, ring.publish

        def publish(slab, behaviour_update=0):
            published[ring._cursor] = rollout_map(torch.clone, slab)
            ring_publish(slab, behaviour_update)

        def checked_consume(lease):
            out = consume(lease)
            want = published[lease.row]
            replayed.append(all(torch.equal(a, b) for a, b in zip(
                rollout_leaves(out[0]), rollout_leaves(want))))
            return out

        ring.publish = publish
        replay_lib.ReplayLease.consume = checked_consume
    try:
        reset_counters()
        history = agent.train(total_env_steps=fresh * steps_per_update)
        torch.cuda.synchronize()
        launches = counters()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        expected = {k: updates * per_update.get(k, 0) for k in KERNELS}
        if launches != expected or agent.state.update_step != updates:
            raise AssertionError(f"{phase}: {updates} updates launched {launches}, "
                                 f"expected {expected}")
        if (len(history) != SEBULBA_WINDOWS or agent._actor_restarts or agent._server_restarts
                or not agent._errors.empty()):
            raise AssertionError(f"{phase}: {len(history)} windows, {agent._actor_restarts} "
                                 f"actor restarts, {agent._server_restarts} server restarts")
        template = fragment_template(cfg, agent.spec, agent.model, envs_per_actor)
        slab_bytes = sum(math.prod(s.shape) * s.dtype.itemsize for s in rollout_leaves(template))
        for window in history:
            bad = [k for k, v in window.items() if not math.isfinite(v)]
            if bad:
                raise AssertionError(f"{phase}: non-finite metrics {bad}")
            if window["h2d_bytes"] != SEBULBA_LOG_EVERY * slab_bytes:
                raise AssertionError(f"{phase}: {window['h2d_bytes']} bytes copied in a window "
                                     f"of {SEBULBA_LOG_EVERY} updates of {slab_bytes}")
        last = history[-1]
        mechanism = {}
        if cfg.inference_server:
            sizes = collections.Counter(forwards.rows)
            modal = sizes.most_common(1)[0][0]
            if modal != cfg.num_envs or max(sizes) != cfg.num_envs:
                raise AssertionError(f"{phase}: server rounds by rows {dict(sizes)}")
            mechanism.update({
                "infer_coalesce_batch_by_window": [w["infer_coalesce_batch"] for w in history],
                "round_rows_most_frequent": modal,
                "full_round_share": sizes[cfg.num_envs] / len(forwards.rows),
                "server_rounds": len(forwards.rows), "server_restarts": 0,
            })
        if agent._replay is not None:
            ring_bytes = agent._replay.nbytes
            if (len(replayed) != fresh * (passes - 1) or not all(replayed)
                    or last["replay_fill_frac"] != 1.0
                    or ring_bytes != cfg.replay_slabs * slab_bytes):
                raise AssertionError(
                    f"{phase}: {sum(replayed)} of {len(replayed)} replayed rows equal their "
                    f"slabs, fill {last['replay_fill_frac']}, ring {ring_bytes} bytes")
            mechanism.update({
                "replayed_rows_bit_identical_to_published": len(replayed),
                "replay_fill_frac": last["replay_fill_frac"], "ring_device_bytes": ring_bytes,
                "ring_bytes_over_slab_bytes": ring_bytes / slab_bytes,
                "target_kl": last["target_kl"], "reuse_max": last["reuse_max"],
                "learner_stall_trend": last["learner_stall_trend"],
            })
        if cfg.algo == "qlearn":
            period = cfg.actor_staleness
            wrong = [(step, eq) for step, eq in target_equal if eq != (step % period == 0)]
            if len(target_equal) != updates or wrong:
                raise AssertionError(f"{phase}: target equal to the weights after updates "
                                     f"{target_equal}")
            mechanism.update({"target_bit_identical_after_each_refresh": True,
                              "target_differs_before_refresh": True,
                              **check_epsilons(cfg, epsilons, envs_per_actor)})

        frag, lcfg = drained["rollout"], agent.learner.config
        model = normalizing_apply(agent.state.params, agent.state.obs_stats)
        target = (normalizing_apply(agent.state.target_params, agent.state.obs_stats)
                  if cfg.algo == "qlearn" else None)
        if sp == 1:
            shard = shard_rollout(frag, 0, dp) if dp > 1 else frag
            with torch.no_grad():
                plain_loss, _ = algo_loss(lcfg.replace(fused_scan="plain"), model, shard,
                                          agent.learner.dist, target=target)
                kernel_loss, _ = algo_loss(lcfg, model, shard, agent.learner.dist,
                                           target=target)
            if not torch.equal(plain_loss, kernel_loss) or not torch.isfinite(kernel_loss):
                raise AssertionError(f"{phase}: kernel loss {kernel_loss} vs plain {plain_loss}")
            mechanism["loss_bit_identical_to_plain"] = True
        if ring:
            # The ranks' gradients on the slab, reduced through B4 (by the
            # learner's entry point) and through the plain ring.
            grads, _, _ = mesh_loss_and_grads(lcfg, model, frag, agent.learner.dist, dp,
                                              target=target)
            stacked = torch.stack([torch.cat([g.reshape(-1) for g in gs]) for gs in grads])
            kernel_sum = torch.stack([torch.cat([g.reshape(-1) for g in gs])
                                      for gs in rr.ring_all_reduce_grads(grads)])
            if not torch.equal(kernel_sum, rr.ring_all_reduce_plain(stacked)):
                raise AssertionError(f"{phase}: reduced gradient through B4 differs from the "
                                     "plain ring")
            mechanism.update({
                "grad_size": stacked.shape[1], "grad_bit_identical_to_plain_ring": True,
                "grad_max_abs_err_vs_psum": check_ring_bound(kernel_sum, stacked, phase),
            })
        if sp > 1:
            mechanism.update(timeshard_checks(phase, agent, learner_update, frag))

        eval_return = agent.evaluate(num_episodes=SEBULBA_EVAL_EPISODES)
        if not math.isfinite(eval_return):
            raise AssertionError(f"{phase}: eval return {eval_return}")

        update_s = steps_per_update / last["fps"] / passes
        profile_row, kernel_ms = host_update_profile(phase, agent, learner_update, frag,
                                                     update_s)
    finally:
        replay_lib.ReplayLease.consume = consume
        agent.close()
    # Model forwards an env step of all the envs: one a thread per-thread,
    # one a round through the server.
    env_step_rounds = sum(forwards.rows) / cfg.num_envs
    row = {
        "phase": phase, "preset": preset_name, "overrides": overrides, "ranks": dp * sp,
        "mesh": mesh,
        "backend": cfg.backend, "host_pool": cfg.host_pool, "num_envs": cfg.num_envs,
        "actor_threads": cfg.actor_threads, "unroll_len": cfg.unroll_len,
        "device_queue": agent.config.device_queue, "staging_slabs": agent._staging.num_slabs,
        "updates": updates, "fresh_updates": fresh,
        "launches_per_update": per_update, "launches": launches,
        "env_steps_per_s": last["fps"], "learner_stall_frac": last["learner_stall_frac"],
        "h2d_wait_s": last["h2d_wait_s"], "h2d_bytes_per_update": slab_bytes,
        "param_lag": last["param_lag"], "queue_backpressure": last["queue_backpressure"],
        "slab_reuse_waits": last["slab_reuse_waits"], "devq_reuse_waits": last["devq_reuse_waits"],
        "model_forwards_per_env_step": len(forwards.rows) / max(env_step_rounds, 1e-9),
        "max_memory_allocated_bytes": peak, "loss": last["loss"],
        "entropy": last.get("entropy"), "td_abs": last.get("td_abs"),
        "no_actor_error": True, **mechanism,
        f"eval_return_{SEBULBA_EVAL_EPISODES}_episodes": eval_return,
        "device_idle_share": profile_row["device_idle_share"],
        "update_ms_without_actors": profile_row["update_ms_without_actors"],
        "kernel_device_ms": {name: statistics.mean(times) if times else None
                             for name, times in kernel_ms.items()},
        "wall_s_incl_setup": wall, "phase_s": time.perf_counter() - phase_t0,
    }
    log(f"train {phase}: " + json.dumps(row))
    return row


class _WireLoad(threading.Thread):
    """Open-loop wire load: ``rps`` requests a second of ``rows``
    observations to ``endpoint`` as ``tenant``, each issued on a worker of
    its own whatever the latency of the others (``GatewayClient``, no
    retries). Records, stamped with the monotonic time of the answer:
    ``(t, "ok", generation, stale, wire ms)``, ``(t, "shed", status,
    Retry-After s)`` or ``(t, "error", repr)``."""

    WORKERS = 16

    def __init__(self, name: str, port: int, tenant: str, rps: float, endpoint: str,
                 rows: int, obs_dim: int, seed: int, obs: np.ndarray | None = None,
                 keep: bool = False):
        super().__init__(name=f"load-{name}", daemon=True)
        from concurrent.futures import ThreadPoolExecutor

        from asyncrl_tpu_torch.serve import GatewayClient

        self._client = GatewayClient(f"http://127.0.0.1:{port}", tenant=tenant,
                                     deadline_ms=SERVE_CLIENT_DEADLINE_MS, retries=0,
                                     breaker_failures=10**6, seed=seed)
        self._call = getattr(self._client, endpoint)
        self._period = 1.0 / rps
        self._obs = (np.random.default_rng(seed).normal(size=(rows, obs_dim)).astype(np.float32)
                     if obs is None else obs)
        # keep: each record also carries its send time, and an answer its
        # replica, actions and log-probs.
        self._keep = keep
        self._pool = ThreadPoolExecutor(self.WORKERS, thread_name_prefix=f"load-{name}")
        self.stop_event = threading.Event()
        self.issued = 0
        self.records: list[tuple] = []

    def _one(self) -> None:
        from asyncrl_tpu_torch.serve import GatewayShed

        t0 = time.monotonic()
        try:
            r = self._call(self._obs)
            record = (time.monotonic(), "ok", r.generation, r.stale,
                      1e3 * (time.monotonic() - t0))
            extra = (t0, r.replica, r.actions, r.logp)
        except GatewayShed as e:
            record = (time.monotonic(), "shed", e.status, e.retry_after_s)
            extra = (t0, str(e)[:160])
        # lint: broad-except-ok(load generator: every other failure is recorded and gated on)
        except Exception as e:
            record, extra = (time.monotonic(), "error", repr(e)), (t0,)
        self.records.append(record + extra if self._keep else record)

    def run(self) -> None:
        next_t = time.monotonic()
        while not self.stop_event.is_set():
            self._pool.submit(self._one)
            self.issued += 1
            next_t += self._period
            self.stop_event.wait(max(0.0, next_t - time.monotonic()))

    def finish(self) -> None:
        self.stop_event.set()
        self.join(timeout=10)
        self._pool.shutdown(wait=True, cancel_futures=True)


def wire_load_main() -> None:
    """The wire load's process (``_LoadProcess``): external clients, so
    they do not share the trainer's interpreter lock. Reads commands from
    stdin (``start PORT OBS_DIM``: the ``SERVE_LOADS``; ``fleet PORT OBS``:
    ``FLEET_CLIENTS`` gold clients, client ``i`` sending rows ``i *
    FLEET_ROWS`` on of the JSON array ``OBS``; ``stop NAME``, answered
    ``stopped`` once that load's requests have all returned; and
    ``finish``), then prints every load's records as one JSON line."""
    loads: dict[str, _WireLoad] = {}
    print("ready", flush=True)
    for line in sys.stdin:
        cmd, *args = line.split(maxsplit=2)
        if cmd == "fleet":
            obs = np.asarray(json.loads(args[1]), np.float32)
            for i in range(FLEET_CLIENTS):
                rows = obs[i * FLEET_ROWS:(i + 1) * FLEET_ROWS]
                loads[f"fleet{i}"] = _WireLoad(f"fleet{i}", int(args[0]), "gold", FLEET_RPS,
                                               "act", FLEET_ROWS, obs.shape[1], seed=i,
                                               obs=rows, keep=True)
                loads[f"fleet{i}"].start()
        elif cmd == "start":
            for i, (name, tenant, rps, endpoint) in enumerate(SERVE_LOADS):
                loads[name] = _WireLoad(name, int(args[0]), tenant, rps, endpoint, SERVE_ROWS,
                                        int(args[1]), seed=i)
                loads[name].start()
        elif cmd == "stop":
            loads[args[0]].finish()
            print("stopped", flush=True)
        elif cmd == "finish":
            break
    for load in loads.values():
        load.finish()
    print(json.dumps({name: {"issued": load.issued, "records": load.records}
                      for name, load in loads.items()}), flush=True)


class _LoadProcess:
    """``wire_load_main`` in a child process, driven over its stdin."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.wire_load_main()"],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def expect(self, word: str) -> None:
        if self.proc.stdout.readline().strip() != word:
            raise AssertionError(f"the wire load process did not answer {word!r}")

    def send(self, command: str) -> None:
        self.proc.stdin.write(command + "\n")
        self.proc.stdin.flush()

    def finish(self) -> dict:
        """Every load's ``issued`` count and records."""
        out, _ = self.proc.communicate("finish\n", timeout=60)
        if self.proc.returncode != 0:
            raise AssertionError(f"the wire load process exited {self.proc.returncode}")
        return json.loads(out.strip().splitlines()[-1])

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


def _wire_probe(port: int, tenant: str, obs: np.ndarray):
    """One request, no retries: ("ok", result) or ("shed", status, retry)."""
    from asyncrl_tpu_torch.serve import GatewayClient, GatewayShed

    client = GatewayClient(f"http://127.0.0.1:{port}", tenant=tenant,
                           deadline_ms=SERVE_CLIENT_DEADLINE_MS, retries=0)
    try:
        return ("ok", client.act(obs))
    except GatewayShed as e:
        return ("shed", e.status, e.retry_after_s)


def _plain_logp(snapshot, obs: np.ndarray, actions) -> torch.Tensor:
    """log_softmax of the snapshot's plain forward at ``actions``."""
    with torch.no_grad():
        logits, _ = snapshot.apply(torch.as_tensor(obs, device="cuda"))
        logp = torch.log_softmax(logits.float(), dim=-1)
        index = torch.as_tensor(np.asarray(actions), device="cuda").long()[:, None]
        return logp.gather(1, index)[:, 0].cpu()


def _percentiles(values: list[float]) -> dict:
    if not values:
        return {"p50": None, "p95": None, "p99": None, "n": 0}
    return {f"p{q}": float(np.percentile(values, q)) for q in (50, 95, 99)} | {"n": len(values)}


def serve_pong_serve_phase() -> dict:
    """``pong_serve`` through ``make_agent`` at its full width (16 Pong envs
    over 2 actor threads, T=16, MLP 256x256, ``host_pool="jax"``, the
    serve core and the gateway on an ephemeral port, the preset's three
    tenants), ``SERVE_QUIET_WINDOWS + SERVE_LOAD_WINDOWS +
    SERVE_AFTER_WINDOWS`` windows of ``SEBULBA_LOG_EVERY`` updates. Wire
    load from a process of its own (``GatewayClient``, open loop) starts
    after the quiet windows: two ``gold`` clients of 8-row ``/v1/act`` at
    50 rps each, one ``bulk`` at 100 rps (twice its class's rate) and one
    ``/v1/evaluate`` at 10 rps; it runs ``SERVE_LOAD_WINDOWS`` windows and at
    least ``SERVE_MIN_LOAD_S``. Then, inside that window's callback (the
    learner paused), the serve core is killed and three probes answer from
    the outage: ``gold`` stale, ``*`` its fallback, ``bulk`` 503; training
    resumes, the supervisor rebuilds the core (the dead core's clients
    raise into their actors, which it restarts, as in the JAX package), and
    ``gold`` is served fresh again. Gated: B1 once an update at (16, 8) and
    no other kernel, the loss on the last drained slab bit-identical
    through B1 and the plain version, more than one generation over the
    wire, no actor restart under the load, ``gateway_live == 1.0`` at the
    last window, ``bulk`` refused 429 with a Retry-After and ``gold`` never,
    device memory not growing with the stale answers, and, once training
    has stopped (serving restarted alone, no actors), each served log-prob
    within ``SERVE_LOGP_TOL`` of the final snapshot's plain forward. The
    wire latencies, the serve core's, rows a dispatch, the dispatch
    reasons, env steps/s with and without load and one profiled update are
    printed, not gated."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.learn.learner import algo_loss
    from asyncrl_tpu_torch.ops.normalize import normalizing_apply
    from asyncrl_tpu_torch.rollout.buffer import rollout_map

    phase = "serve_pong_serve"
    phase_t0 = time.perf_counter()
    cfg = presets.pong_serve.replace(device="cuda", log_every=SEBULBA_LOG_EVERY, eval_every=0)
    windows = SERVE_QUIET_WINDOWS + SERVE_LOAD_WINDOWS + SERVE_AFTER_WINDOWS
    updates = windows * SEBULBA_LOG_EVERY
    envs_per_actor = cfg.num_envs // cfg.actor_threads
    steps_per_update = envs_per_actor * cfg.unroll_len
    load = _LoadProcess()  # its imports overlap the trainer's construction
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    agent = asyncrl_tpu_torch.make_agent(cfg)
    drained = {}
    learner_update = agent.learner.update

    def update(state, rollout, perms=None):
        drained["rollout"] = rollout_map(torch.clone, rollout)
        return learner_update(state, rollout, perms)

    agent.learner.update = update
    obs_dim = agent.spec.obs_shape[0]
    zeros = np.zeros((SERVE_ROWS, obs_dim), np.float32)
    load.expect("ready")
    marks: dict = {}

    def callback(window: dict) -> None:
        n = marks["n"] = marks.get("n", 0) + 1
        if n == SERVE_QUIET_WINDOWS:
            load.send(f"start {agent._gateway.port} {obs_dim}")
            marks["load_start"] = time.monotonic()
        elif n == SERVE_QUIET_WINDOWS + SERVE_LOAD_WINDOWS:
            # The load's whole span; then the outage, the learner paused here.
            time.sleep(max(0.0, marks["load_start"] + SERVE_MIN_LOAD_S - time.monotonic()))
            marks["load_end"] = time.monotonic()
            marks["load_window"] = dict(window)
            load.send("stop bulk")  # its bucket refills for the outage probe
            load.expect("stopped")
            marks["bytes_before_kill"] = torch.cuda.memory_allocated()
            core = agent._server
            core.kill()
            core.join(timeout=5.0)
            marks["killed"] = core
            time.sleep(SERVE_OUTAGE_REFILL_S)
            port = agent._gateway.port
            marks["outage"] = {tenant or "*": _wire_probe(port, tenant, zeros)
                               for tenant in ("gold", "", "bulk")}
        elif "killed" in marks and "fresh" not in marks:
            # The supervisor rebuilt the core before this window closed (the
            # dead core's clients raised into their actors, which it
            # restarted); gold must be served fresh by it.
            if agent._server is marks["killed"] or not agent._server.is_alive():
                raise AssertionError(f"{phase}: the serve core was not rebuilt")
            marks["fresh"] = _wire_probe(agent._gateway.port, "gold", zeros)
            marks["bytes_after_rebuild"] = torch.cuda.memory_allocated()

    try:
        reset_counters()
        history = agent.train(total_env_steps=updates * steps_per_update, callback=callback)
        torch.cuda.synchronize()
        launches = counters()
        wall = time.perf_counter() - t0
        loads = load.finish()
        peak = torch.cuda.max_memory_allocated()
        expected = {k: updates * (k == "fused_vtrace") for k in KERNELS}
        frag = drained["rollout"]
        if (launches != expected or agent.state.update_step != updates
                or tuple(frag.rewards.shape) != (cfg.unroll_len, envs_per_actor)):
            raise AssertionError(f"{phase}: {updates} updates launched {launches}, expected "
                                 f"{expected}; B1 at {tuple(frag.rewards.shape)}")
        if len(history) != windows or not all(
                math.isfinite(v) for w in history for v in w.values()):
            raise AssertionError(f"{phase}: {len(history)} windows or non-finite metrics")
        load_window, last = marks["load_window"], history[-1]
        if load_window["actor_restarts"] or load_window["gateway_live"] != 1.0:
            raise AssertionError(f"{phase}: {load_window['actor_restarts']} actor restarts, "
                                 f"gateway_live {load_window['gateway_live']} under load")
        if last["gateway_live"] != 1.0 or last["server_restarts"] != 1 or not agent._errors.empty():
            raise AssertionError(f"{phase}: last window gateway_live {last['gateway_live']}, "
                                 f"server_restarts {last['server_restarts']}")

        # The load span: gold's answers and generations, the 429s.
        span = (marks["load_start"], marks["load_end"])
        in_span = {name: [r for r in got["records"] if span[0] <= r[0] <= span[1]]
                   for name, got in loads.items()}
        counts = {name: {"issued": got["issued"], **collections.Counter(
            r[1] if r[1] != "shed" else f"shed_{r[2]}" for r in got["records"])}
            for name, got in loads.items()}
        gold = [r for name in ("gold0", "gold1") for r in loads[name]["records"]]
        gold_ok = [r for name in ("gold0", "gold1") for r in in_span[name] if r[1] == "ok"]
        generations = {r[2] for r in gold_ok}
        gold_refused = [r for r in gold if r[1] == "shed" and r[2] == 429]
        bulk_429 = [r for r in loads["bulk"]["records"] if r[1] == "shed" and r[2] == 429]
        errors = [r for rows in in_span.values() for r in rows if r[1] == "error"]
        if len(generations) < 2 or gold_refused or not bulk_429 or any(
                r[3] <= 0 for r in bulk_429) or errors:
            raise AssertionError(
                f"{phase}: gold saw generations {sorted(generations)}, gold 429s "
                f"{len(gold_refused)}, bulk 429s {len(bulk_429)}, errors {errors[:3]}; "
                f"gold wire ms {_percentiles([r[4] for r in gold_ok])}; " + json.dumps(counts))
        # The outage and the rebuild.
        outage, fresh = marks["outage"], marks["fresh"]
        gold_stale, catchall, bulk_out = outage["gold"], outage["*"], outage["bulk"]
        if not (gold_stale[0] == "ok" and gold_stale[1].stale
                and gold_stale[1].raw.get("stale_generation") is not None
                and catchall[0] == "ok" and catchall[1].fallback
                and bulk_out[0] == "shed" and bulk_out[1] == 503):
            raise AssertionError(f"{phase}: outage answers {outage}")
        if fresh[0] != "ok" or fresh[1].stale or fresh[1].fallback:
            raise AssertionError(f"{phase}: gold after the rebuild: {fresh}")
        # The stale answers run on handler threads: device memory must not
        # grow with their count (a cuBLAS workspace a thread and stream).
        stale_answers = sum(r[1] == "ok" and r[3] for r in gold)
        growth = marks["bytes_after_rebuild"] - marks["bytes_before_kill"]
        if growth > SERVE_OUTAGE_BYTES:
            raise AssertionError(f"{phase}: device memory grew {growth} bytes over "
                                 f"{stale_answers} stale answers")

        # The loss on the last drained slab through B1 and the plain version.
        lcfg = agent.learner.config
        model = normalizing_apply(agent.state.params, agent.state.obs_stats)
        with torch.no_grad():
            plain_loss, _ = algo_loss(lcfg.replace(fused_scan="plain"), model, frag,
                                      agent.learner.dist)
            kernel_loss, _ = algo_loss(lcfg, model, frag, agent.learner.dist)
        if not torch.equal(plain_loss, kernel_loss) or not torch.isfinite(kernel_loss):
            raise AssertionError(f"{phase}: kernel loss {kernel_loss} vs plain {plain_loss}")

        # Training stopped: serving alone on the final snapshot, each served
        # log-prob against its plain forward on the same rows.
        agent._spawn_server()
        agent._spawn_gateway()
        final, version = agent._store.get()
        rng = np.random.default_rng(11)
        logp_err, served_gens = 0.0, set()
        for _ in range(SERVE_FINAL_REQUESTS):
            obs = rng.normal(size=(SERVE_ROWS, obs_dim)).astype(np.float32)
            answer = _wire_probe(agent._gateway.port, "gold", obs)
            if answer[0] != "ok" or answer[1].stale:
                raise AssertionError(f"{phase}: the final serve answered {answer}")
            served_gens.add(answer[1].generation)
            want = _plain_logp(final, obs, answer[1].actions)
            logp_err = max(logp_err, float((torch.tensor(answer[1].logp) - want).abs().max()))
        if logp_err > SERVE_LOGP_TOL:
            raise AssertionError(f"{phase}: served log-probs off the plain forward by {logp_err}")

        update_s = steps_per_update / last["fps"]
        profile_row, kernel_ms = host_update_profile(phase, agent, learner_update, frag,
                                                     update_s)
    finally:
        load.kill()
        agent.close()
    quiet = [w["fps"] for w in history[1:SERVE_QUIET_WINDOWS]]
    loaded = [w["fps"] for w in history[SERVE_QUIET_WINDOWS:SERVE_QUIET_WINDOWS
                                         + SERVE_LOAD_WINDOWS]]
    row = {
        "phase": phase, "preset": "pong_serve", "ranks": 1, "backend": cfg.backend,
        "host_pool": cfg.host_pool, "num_envs": cfg.num_envs, "actor_threads": cfg.actor_threads,
        "unroll_len": cfg.unroll_len, "updates": updates,
        "b1_shape": [cfg.unroll_len, envs_per_actor],
        "launches_per_update": {"fused_vtrace": 1}, "launches": launches,
        "loss_bit_identical_to_plain": True,
        "generations_over_the_wire": len(generations),
        "gold_wire_ms": _percentiles([r[4] for r in gold_ok]),
        "load_counts": counts, "bulk_429": len(bulk_429),
        "bulk_retry_after_s": sorted({r[3] for r in bulk_429})[:3],
        "serve_latency_ms_p50": load_window["serve_latency_ms_p50"],
        "serve_latency_ms_p95": load_window["serve_latency_ms_p95"],
        "gateway_gold_latency_ms_p95": load_window["gateway_gold_latency_ms_p95"],
        "rows_per_dispatch_p50": load_window["serve_batch_rows_p50"],
        "rows_per_dispatch_max": load_window["serve_batch_rows_max"],
        "infer_coalesce_batch_by_window": [w["infer_coalesce_batch"] for w in history],
        "serve_dispatch_full": load_window["serve_dispatch_full"],
        "serve_dispatch_deadline": load_window["serve_dispatch_deadline"],
        "env_steps_per_s_without_load": quiet, "env_steps_per_s_with_load": loaded,
        "load_s": marks["load_end"] - marks["load_start"],
        "outage": {"gold_stale_generation": gold_stale[1].raw["stale_generation"],
                   "catchall_fallback": catchall[1].fallback, "bulk_status": bulk_out[1]},
        "actor_restarts_during_load": 0, "actor_restarts_after_the_kill": last["actor_restarts"],
        "server_restarts": last["server_restarts"], "gateway_live_last": last["gateway_live"],
        "stale_answers": stale_answers, "device_bytes_growth_over_the_outage": growth,
        "final_logp_max_abs_err": logp_err, "final_generations": sorted(served_gens),
        "final_store_version": version,
        "max_memory_allocated_bytes": peak, "loss": last["loss"],
        "device_idle_share": profile_row["device_idle_share"],
        "update_ms_without_actors": profile_row["update_ms_without_actors"],
        "kernel_device_ms": {name: statistics.mean(times) if times else None
                             for name, times in kernel_ms.items()},
        "wall_s_incl_setup": wall, "phase_s": time.perf_counter() - phase_t0,
    }
    log(f"train {phase}: " + json.dumps(row))
    return row


def serve_population_phase(pop) -> dict:
    """The population phase's ``pong_impala_pop4`` members, published with
    ``publish_policies`` into a router-only ``ServeCore`` (``store=None``)
    on the card. Four client threads ask ``member/<i>`` for 8-row actions
    through ``submit_external``; mid-traffic the population takes one
    update (B1 once a member) and publishes again. Gated: every request
    answered, the generation advanced for every member, every batched call
    read one published snapshot, and each answer's log-probs within
    ``SERVE_LOGP_TOL`` of the plain forward of the snapshot its generation
    names (one client a policy, so a dispatch holds one request: the same
    rows, the same batch shape)."""
    from asyncrl_tpu_torch.rollout.sebulba import make_inference_fn
    from asyncrl_tpu_torch.serve import PolicyRouter, ServeCore

    phase = f"serve_pong_impala_pop{POP_SIZE}"
    phase_t0 = time.perf_counter()
    router = PolicyRouter()
    snapshots: dict[tuple[str, int], object] = {}

    def publish() -> list[str]:
        ids = pop.publish_policies(router)
        for policy in ids:
            slots = router.slots(policy)
            params, gen = slots.lease()
            slots.release(gen)
            snapshots[(policy, gen)] = params
        return ids

    ids = publish()
    spec = pop.env.spec
    fn = make_inference_fn(pop.member_params(0), spec, pop.config)
    read = []

    def recorded(params, obs, generator):
        read.append(id(params))
        return fn(params, obs, generator)

    stop = threading.Event()
    core = ServeCore(recorded, store=None, router=router, num_clients=1, stop_event=stop,
                     seed=pop.config.seed, device="cuda", deadline_ms=2.0)
    core.start()
    obs_dim = spec.obs_shape[0]
    answers: dict[str, list] = {policy: [] for policy in ids}
    failures: list = []
    halt = threading.Event()

    def client(policy: str, seed: int) -> None:
        rng = np.random.default_rng(seed)
        while not halt.is_set():
            obs = rng.normal(size=(SERVE_ROWS, obs_dim)).astype(np.float32)
            try:
                (actions, logp), gen = core.submit_external(policy, (obs,), 1000.0)
            # lint: broad-except-ok(load generator: a dropped request is recorded and gated on)
            except Exception as e:
                failures.append((policy, repr(e)))
                return
            answers[policy].append((obs, actions, logp, gen))

    threads = [threading.Thread(target=client, args=(p, i), name=f"pop-client-{i}", daemon=True)
               for i, p in enumerate(ids)]
    reset_counters()
    try:
        for t in threads:
            t.start()

        def wait_for(count: int) -> None:
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline and not failures and min(
                    len(a) for a in answers.values()) < count:
                time.sleep(0.005)

        wait_for(SERVE_POP_REQUESTS)
        pop.update()
        publish()
        first = {p: len(a) for p, a in answers.items()}
        wait_for(max(first.values()) + SERVE_POP_REQUESTS)
        halt.set()
        for t in threads:
            t.join(timeout=10)
        torch.cuda.synchronize()
        launches = counters()
    finally:
        halt.set()
        stop.set()
        core.join(timeout=5)
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"{phase}: dropped requests {failures[:3]}")
    known = {id(s) for s in snapshots.values()}
    if not read or any(r not in known for r in read):
        raise AssertionError(f"{phase}: a batched call read weights that were never published")
    err, gens = 0.0, {}
    for policy, rows in answers.items():
        gens[policy] = sorted({g for *_, g in rows})
        if gens[policy] != [0, 1]:
            raise AssertionError(f"{phase}: {policy} served generations {gens[policy]}")
        for obs, actions, logp, gen in rows:
            want = _plain_logp(snapshots[(policy, gen)], obs, actions)
            err = max(err, float((torch.from_numpy(logp) - want).abs().max()))
    if err > SERVE_LOGP_TOL:
        raise AssertionError(f"{phase}: served log-probs off the plain forward by {err}")
    expected = {k: POP_SIZE * (k == "fused_vtrace") for k in KERNELS}
    if launches != expected:
        raise AssertionError(f"{phase}: the update between publishes launched {launches}")
    row = {
        "phase": phase, "preset": "pong_impala", "pop_size": POP_SIZE, "ranks": 1,
        "updates": 1, "launches_per_update": {"fused_vtrace": POP_SIZE}, "launches": launches,
        "answers": {p: len(a) for p, a in answers.items()}, "generations": gens,
        "dispatches": len(read), "logp_max_abs_err": err, "no_request_dropped": True,
        "kernel_device_ms": {"fused_vtrace": None, "ring_all_reduce": None},
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "phase_s": time.perf_counter() - phase_t0,
    }
    log(f"train {phase}: " + json.dumps(row))
    return row


def params_sha256(state) -> str:
    """SHA-256 over the weights of a learner state (``params.*`` of its
    ``state_dict``, by key), as a process prints it and a restore reads it."""
    from asyncrl_tpu_torch.utils.checkpoint import state_dict

    return _flat_params_sha256(state_dict(state))


def pong_observations(rows: int, seed: int) -> np.ndarray:
    """``rows`` vector Pong observations: fresh envs from ``seed`` after 64
    uniformly random steps, on the CPU."""
    from asyncrl_tpu_torch.envs import registry

    env = registry.make("JaxPong-v0")
    gen = torch.Generator().manual_seed(seed)
    state = env.init(rows, gen, "cpu")
    for _ in range(64):
        actions = torch.randint(env.spec.num_actions, (rows,), generator=gen)
        state, _ = env.step(state, actions, env.draw(rows, gen, "cpu"))
    return env.observe(state).numpy().astype(np.float32)


def _wait(what: str, done, timeout_s: float = FLEET_EVENT_TIMEOUT_S, poll=None) -> float:
    """Poll ``done`` every 5 ms (calling ``poll`` each time) until it is
    true; the monotonic time it turned true. Fails after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not done():
        if poll is not None:
            poll()
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout_s} s waiting for {what}")
        time.sleep(0.005)
    return time.monotonic()


def _sent_at(record: tuple) -> float:
    """The send time of a kept load record (``_WireLoad(keep=True)``)."""
    return record[{"ok": 5, "shed": 4, "error": 3}[record[1]]]


def _answer_checks(loads: dict, logp_of: dict) -> dict:
    """The fleet load's answers held to the plain forwards: each answer's
    log-probs against ``logp_of[(version, client)]`` ([FLEET_ROWS, A]
    log_softmax of that version's snapshot on the client's rows) at its
    actions. Returns the worst error, the answers a version, the wire
    latencies and the records that were not answers."""
    err, by_version, wire_ms, other, stale = 0.0, collections.Counter(), [], [], 0
    for name, got in loads.items():
        client = int(name.removeprefix("fleet"))
        for r in got["records"]:
            if r[1] != "ok":
                other.append(r)
                continue
            version, actions, logp = r[2], np.asarray(r[7]), np.asarray(r[8], np.float32)
            stale += bool(r[3])
            want = logp_of[(version, client)][np.arange(len(actions)), actions]
            err = max(err, float(np.abs(logp - want).max()))
            by_version[version] += 1
            wire_ms.append(r[4])
    return {"logp_max_abs_err": err, "answers_by_version": dict(sorted(by_version.items())),
            "wire_ms": wire_ms, "not_answered": other, "stale": stale}


def serve_fleet_phase() -> dict:
    """The replicated fleet at full width. The learner is ``pong_impala``
    through ``make_agent`` on the card (256 Pong envs, T=32, MLP 256x256);
    its snapshots go into a ``ParamFeed`` that a ``ServeFleet`` of
    ``FLEET_REPLICAS`` cores on the card serves behind
    ``ServeGateway(FleetRouter(...))``, with a ``CanaryController``. The
    load process sends ``FLEET_CLIENTS`` gold clients of ``FLEET_ROWS`` Pong
    observations, once each core has dispatched a warm-up request. Three
    events, each gated: the ``fleet.replica`` site kills r0 on tick
    ``FLEET_KILL_TICK`` and the tick rebuilds it while the others serve (it
    comes back through its probe); ``FLEET_UPDATES``
    learner updates later, version 1 is published, canaried on one replica
    and promoted, and every replica follows; version 2, version 1 with its
    policy head negated and scaled (``FLEET_POISON_SCALE``), is canaried,
    rolled back on divergence and vetoed, and every replica stays on 1.
    Gated too: every request answered, none stale; each answer's log-probs
    within ``SERVE_LOGP_TOL`` of the plain forward of the snapshot whose
    version it is stamped with (a batch that mixed versions would miss it);
    device memory grown under ``FLEET_REBUILD_BYTES`` over the rebuild; B1
    once a learner update and no other kernel."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.obs import registry as obs_registry
    from asyncrl_tpu_torch.rollout.sebulba import make_inference_fn, snapshot_policy
    from asyncrl_tpu_torch.serve import (
        CanaryController, FleetRouter, ParamFeed, ServeFleet, ServeGateway, parse_tenant_spec,
    )
    from asyncrl_tpu_torch.utils import faults

    phase = "serve_fleet_pong_impala"
    phase_t0 = time.perf_counter()
    cfg = presets.pong_impala.replace(device="cuda", log_every=FLEET_UPDATES, eval_every=0)
    steps_per_update = cfg.batch_steps_per_update * cfg.updates_per_call
    load = _LoadProcess()  # its imports overlap the fleet's construction
    obs_registry.registry().reset()
    faults.arm(f"fleet.replica:replica:1.0:0:rmode=kill,max=1,replica=r0,"
               f"after={FLEET_KILL_TICK - 1}")
    agent = asyncrl_tpu_torch.make_agent(cfg)
    spec = agent.env.spec
    snapshots = {0: snapshot_policy(agent.state.params)}
    feed = ParamFeed(snapshots[0])
    canary = CanaryController(window=FLEET_CANARY_WINDOW, min_serves=FLEET_CANARY_WINDOW,
                              divergence=FLEET_CANARY_DIVERGENCE, share=4)
    fleet = ServeFleet(make_inference_fn(agent.state.params, spec, cfg), feed, FLEET_REPLICAS,
                       device="cuda", canary=canary, max_batch_rows=FLEET_ROWS, seed=cfg.seed)
    router = FleetRouter(fleet, spec.obs_shape, seed=cfg.seed)
    gateway = ServeGateway(router, port=-1, tenants=parse_tenant_spec(FLEET_TENANTS))
    obs = pong_observations(FLEET_CLIENTS * FLEET_ROWS, cfg.seed)
    victim = fleet.replicas[0]
    staleness = [0.0]

    def sample() -> None:
        staleness[0] = max(staleness[0], obs_registry.gauge("fleet_staleness_max").value())

    def on_version(v: int) -> bool:
        return all(r.version == v and r.state == "serving" for r in fleet.replicas)

    try:
        reset_counters()
        load.expect("ready")
        fleet.start()
        # Each core's first dispatch sets up its stream and cuBLAS handle on
        # the card: done before traffic, as a server warms up.
        for replica in fleet.replicas:
            replica.core.submit_external("default", (obs[:FLEET_ROWS],), 10_000.0)
        torch.cuda.synchronize()
        bytes_before = torch.cuda.memory_allocated()
        if faults.counters().get("fault_fleet.replica"):
            raise AssertionError(f"{phase}: the kill fired before the memory baseline")
        gateway.start()
        load.send(f"fleet {gateway.port} {json.dumps(obs.tolist())}")
        t_start = time.monotonic()
        # 1. The kill, the rebuild and the readmission through the probe.
        t_kill = _wait("the fleet.replica kill",
                       lambda: faults.counters().get("fault_fleet.replica") == 1, poll=sample)
        t_rebuilt = _wait("r0's rebuild", lambda: victim.restarts == 1 and victim.core.is_alive(),
                          poll=sample)
        t_back = _wait("r0's readmission", lambda: victim.state == "serving", poll=sample)
        time.sleep(FLEET_AFTER_S)
        torch.cuda.synchronize()
        bytes_after = torch.cuda.memory_allocated()
        # 2. The next version, canaried and promoted.
        t0 = time.perf_counter()
        t_train = time.monotonic()
        history = agent.train(total_env_steps=agent.env_steps + FLEET_UPDATES * steps_per_update)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches, updates = counters(), agent.state.update_step
        snapshots[1] = snapshot_policy(agent.state.params)
        t_publish1 = time.monotonic()
        feed.publish(snapshots[1])
        t_promoted = _wait("the promotion of version 1",
                           lambda: ("promote", 1) in list(canary.history) and on_version(1),
                           poll=sample)
        time.sleep(FLEET_AFTER_S)
        # 3. The poisoned version, canaried, rolled back and vetoed.
        poisoned = copy.deepcopy(snapshots[1].model)
        with torch.no_grad():
            poisoned.policy.weight.mul_(-FLEET_POISON_SCALE)
            poisoned.policy.bias.mul_(-FLEET_POISON_SCALE)
        snapshots[2] = snapshot_policy(poisoned)
        t_publish2 = time.monotonic()
        feed.publish(snapshots[2])
        t_rolled = _wait("the rollback of version 2",
                         lambda: ("rollback", 2) in list(canary.history) and on_version(1),
                         poll=sample)
        time.sleep(FLEET_AFTER_S)
        t_end = time.monotonic()
        loads = load.finish()
        window = obs_registry.window()
        verdicts = fleet.replica_verdicts()
        vetoed = sorted(canary.vetoed())
        events = list(canary.history)
        # One profiled learner update, the load stopped (launches read above).
        update_s = steps_per_update / history[-1]["fps"]
        profile_row = profile_update(agent, update_s)
    finally:
        load.kill()
        gateway.stop()
        router.close()
        fleet.close()
        agent.close()
        faults.disarm()

    # Every answer against the plain forward of its stamped version.
    logp_of = {}
    with torch.no_grad():
        for version, snap in snapshots.items():
            for client in range(FLEET_CLIENTS):
                rows = torch.as_tensor(obs[client * FLEET_ROWS:(client + 1) * FLEET_ROWS],
                                       device="cuda")
                logits, _ = snap.apply(rows)
                logp_of[(version, client)] = torch.log_softmax(logits.float(), -1).cpu().numpy()
    answers = _answer_checks(loads, logp_of)
    issued = sum(got["issued"] for got in loads.values())
    # The events and the requests not answered, in seconds from the load's start.
    timeline = {name: round(t - t_start, 3) for name, t in (
        ("kill", t_kill), ("rebuilt", t_rebuilt), ("readmitted", t_back),
        ("train", t_train), ("publish_1", t_publish1), ("promoted", t_promoted),
        ("publish_2", t_publish2), ("rolled_back", t_rolled), ("end", t_end))}
    not_answered = [(round(r[0] - t_start, 3), *r[1:3], r[-1])
                    for r in answers["not_answered"]]
    expected = {k: FLEET_UPDATES * (k == "fused_vtrace") for k in KERNELS}
    growth = bytes_after - bytes_before
    failures = []
    if launches != expected or updates != FLEET_UPDATES:
        failures.append(f"{FLEET_UPDATES} updates launched {launches}, expected {expected}")
    if not_answered or answers["stale"]:
        failures.append(f"requests not answered fresh: {not_answered[:6]}, "
                        f"{answers['stale']} stale; timeline {timeline}")
    if answers["logp_max_abs_err"] > SERVE_LOGP_TOL:
        failures.append(f"served log-probs off their version's plain forward by "
                        f"{answers['logp_max_abs_err']}")
    if set(answers["answers_by_version"]) != {0, 1, 2}:
        failures.append(f"versions served {answers['answers_by_version']}")
    if victim.restarts != 1 or window.get("fleet_replica_restarts") != 1.0:
        failures.append(f"r0 restarts {victim.restarts}, fleet restarts "
                        f"{window.get('fleet_replica_restarts')}")
    if vetoed != [2] or ("promote", 1) not in events:
        failures.append(f"canary history {events}, vetoed {vetoed}")
    if growth > FLEET_REBUILD_BYTES:
        failures.append(f"device memory grew {growth} bytes over the rebuild")
    if not math.isfinite(history[-1]["loss"]):
        failures.append(f"learner loss {history[-1]['loss']}")
    if failures:
        raise AssertionError(f"{phase}: " + "; ".join(failures))
    row = {
        "phase": phase, "preset": "pong_impala", "ranks": 1, "num_envs": cfg.num_envs,
        "unroll_len": cfg.unroll_len, "updates": FLEET_UPDATES, "replicas": FLEET_REPLICAS,
        "launches_per_update": {"fused_vtrace": 1}, "launches": launches,
        "b1_shape": [cfg.unroll_len, cfg.num_envs],
        "requests_issued": issued, "answers_by_version": answers["answers_by_version"],
        "logp_max_abs_err": answers["logp_max_abs_err"],
        "gold_wire_ms": _percentiles(answers["wire_ms"]),
        "failovers": window.get("fleet_failovers"), "ejections": window.get("fleet_ejections"),
        "readmissions": window.get("fleet_readmissions"),
        "promotions": window.get("fleet_promotions"), "rollbacks": window.get("fleet_rollbacks"),
        "rebuild_ms": 1e3 * (t_rebuilt - t_kill), "kill_to_readmission_ms": 1e3 * (t_back - t_kill),
        "publish_to_promotion_ms": 1e3 * (t_promoted - t_publish1),
        "publish_to_rollback_ms": 1e3 * (t_rolled - t_publish2),
        "canary_history": events, "vetoed": vetoed,
        "fleet_staleness_max": staleness[0], "replica_verdicts": verdicts,
        "device_bytes_growth_over_the_rebuild": growth,
        "learner_env_steps_per_s": FLEET_UPDATES * steps_per_update / train_s,
        "timeline_s": timeline, "load_s": t_end - t_start, "loss": history[-1]["loss"],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "device_idle_share": profile_row["device_idle_share"],
        "device_busy_ms": profile_row["device_busy_ms"],
        "kernel_device_ms": profile_row["kernel_device_ms"],
        "phase_s": time.perf_counter() - phase_t0,
    }
    log(f"train {phase}: " + json.dumps(row))
    return row


def drain_child_main(ckpt_dir: str) -> None:
    """The drain phase's child (``drain_pong_serve_phase``): ``pong_serve``
    through ``make_agent`` on the card with ``checkpoint_dir=ckpt_dir``,
    training until a signal drains it. Prints a JSON line a window (its env
    steps and the gateway's port) and, at the drain, the step, the weights'
    SHA-256 and its kernel launches; ``PreemptedExit`` then exits 86."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets

    set_precision()
    cfg = presets.pong_serve.replace(device="cuda", checkpoint_dir=ckpt_dir,
                                     log_every=SEBULBA_LOG_EVERY, eval_every=0)
    agent = asyncrl_tpu_torch.make_agent(cfg)

    def callback(window: dict) -> None:
        if window.get("drain_preempt"):
            torch.cuda.synchronize()
            print(json.dumps({"drained": agent.state.update_step, "env_steps": agent.env_steps,
                              "sha256": params_sha256(agent.state), "launches": counters(),
                              "t": time.monotonic(),
                              "peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)
        else:
            print(json.dumps({"window": window["env_steps"], "port": agent._gateway.port,
                              "fps": window["fps"]}), flush=True)

    reset_counters()
    agent.train(total_env_steps=10**12, callback=callback)


def drain_pong_serve_phase() -> dict:
    """The preemption drain on the card: ``pong_serve`` (sebulba, the serve
    core and the gateway) in a child process (``drain_child_main``) with
    ``checkpoint_dir`` set, under the fleet's wire load from its first
    window on, gets a real SIGTERM after its ``DRAIN_WINDOWS``-th window and
    ``DRAIN_LOAD_S`` of load.
    Gated: exit code 86 inside the ``DRAIN_GRACE_S`` grace; every request
    sent after the signal answered 503 or refused; one final checkpoint with
    its manifest at the step the child printed at the drain; the weights
    ``make_agent(restore=)`` reads from it hashing to the SHA-256 the child
    printed; B1 once an update in the child and no other kernel."""
    import signal as signal_mod

    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.utils.checkpoint import Checkpointer

    phase = "drain_pong_serve"
    phase_t0 = time.perf_counter()
    shutil.rmtree(DRAIN_DIR, ignore_errors=True)
    load = _LoadProcess()
    child = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.drain_child_main({DRAIN_DIR!r})"],
        cwd=ROOT, stdout=subprocess.PIPE, text=True)
    obs = pong_observations(FLEET_CLIENTS * FLEET_ROWS, 1)
    windows, drained = [], None
    try:
        load.expect("ready")
        for line in child.stdout:
            if not line.startswith("{"):
                continue  # the trainer's own notices
            doc = json.loads(line)
            if "window" not in doc:
                raise AssertionError(f"{phase}: the child printed {doc} before the signal")
            windows.append(doc)
            if len(windows) == 1:
                load.send(f"fleet {doc['port']} {json.dumps(obs.tolist())}")
                t_load = time.monotonic()
            if len(windows) == DRAIN_WINDOWS:
                break
        # The child trains on meanwhile; the load gets a fair run first.
        time.sleep(max(0.0, t_load + DRAIN_LOAD_S - time.monotonic()))
        t_signal = time.monotonic()
        child.send_signal(signal_mod.SIGTERM)
        rest = child.stdout.read()
        child.wait(timeout=DRAIN_GRACE_S + 30)
        t_exit = time.monotonic()
        time.sleep(max(0.0, t_signal + DRAIN_AFTER_S - time.monotonic()))
        loads = load.finish()
        docs = [json.loads(x) for x in rest.splitlines() if x.startswith("{")]
        windows += [d for d in docs if "window" in d]
        drained = [d for d in docs if "drained" in d]
    finally:
        load.kill()
        if child.poll() is None:
            child.kill()
            child.wait(timeout=10)
    try:
        if child.returncode != 86 or len(drained) != 1:
            raise AssertionError(f"{phase}: the child exited {child.returncode}, printed "
                                 f"{drained} after the signal")
        done = drained[0]
        step = done["drained"]
        after = [r for got in loads.values() for r in got["records"] if _sent_at(r) > t_signal]
        served_after = [r[:3] for r in after if not (
            r[1] == "error" or (r[1] == "shed" and r[2] == 503))]
        before = [r for got in loads.values() for r in got["records"]
                  if _sent_at(r) <= t_signal and r[1] == "ok"]
        ckpt = Checkpointer(DRAIN_DIR, create=False)
        manifest = ckpt.read_manifest(step)
        restored = asyncrl_tpu_torch.make_agent(
            presets.pong_serve.replace(device="cuda", gateway_port=0), restore=DRAIN_DIR)
        try:
            restored_sha = params_sha256(restored.state)
            restored_step = restored.state.update_step
        finally:
            restored.close()
        expected = {k: step * (k == "fused_vtrace") for k in KERNELS}
        failures = []
        if not before or not after or served_after:
            failures.append(f"{len(before)} answers before the signal, {len(after)} requests "
                            f"sent after it, of which not refused: {served_after[:3]}")
        if ckpt.latest_step() != step or manifest is None or restored_step != step:
            failures.append(f"latest checkpoint {ckpt.latest_step()}, manifest {manifest}, "
                            f"restored step {restored_step}; the drain printed {step}")
        if restored_sha != done["sha256"]:
            failures.append("the restored weights' SHA-256 differs from the drained ones'")
        if done["launches"] != expected:
            failures.append(f"{step} updates launched {done['launches']}")
        if t_exit - t_signal > DRAIN_GRACE_S:
            failures.append(f"the drain took {t_exit - t_signal} s")
        if failures:
            raise AssertionError(f"{phase}: " + "; ".join(failures))
    finally:
        shutil.rmtree(DRAIN_DIR, ignore_errors=True)
    refused = collections.Counter(
        "503" if r[1] == "shed" else r[2].split("(")[0] for r in after)
    row = {
        "phase": phase, "preset": "pong_serve", "ranks": 1, "updates": step,
        "launches_per_update": {"fused_vtrace": 1}, "launches": done["launches"],
        "exit_code": child.returncode, "signal_to_exit_ms": 1e3 * (t_exit - t_signal),
        "signal_to_drain_window_ms": 1e3 * (done["t"] - t_signal), "grace_s": DRAIN_GRACE_S,
        "windows": len(windows), "drained_step": step,
        "drained_env_steps": done["env_steps"], "answers_before_the_signal": len(before),
        "requests_after_the_signal": len(after), "refused_after_the_signal": dict(refused),
        "gold_wire_ms_before": _percentiles([r[4] for r in before]),
        "restored_sha256_equal": True, "manifest_sha256": manifest["sha256"],
        "max_memory_allocated_bytes": done["peak_bytes"],
        "kernel_device_ms": {"fused_vtrace": None, "ring_all_reduce": None},
        "phase_s": time.perf_counter() - phase_t0,
    }
    log(f"train {phase}: " + json.dumps(row))
    return row


class _FaultClock:
    """Wraps the armed stall sites of the active fault registry: for each
    fire, the stalled thread, its last progress stamp (``heartbeat``) before
    the fire and the monotonic time of the fire. The stall began between
    the two."""

    def __init__(self):
        from asyncrl_tpu_torch.utils import faults

        self.stalls: list[tuple[str, threading.Thread, float, float]] = []
        for name, site in faults.active()._sites.items():
            if site.kind == "stall":
                site.fire = self._timed(name, site, site.fire)

    def _timed(self, name, site, fire):
        def timed(stop=None, payload=None):
            thread = threading.current_thread()
            before, stamp, t0 = site.fires, getattr(thread, "heartbeat", None), time.monotonic()
            out = fire(stop=stop, payload=payload)
            if site.fires != before:
                self.stalls.append((name, thread, stamp, t0))
            return out

        return timed


class _Supervised:
    """Records an agent's actor restarts (reason, retired thread, time), the
    spawn time of each actor thread, each thread's first inference call, and
    the server rebuilds (the cause the old server died of, time)."""

    def __init__(self, agent):
        self.restarts: list[tuple[str, threading.Thread, float]] = []
        self.replacements: list[threading.Thread] = []
        self.spawned: dict[threading.Thread, float] = {}
        self.first_call: dict[threading.Thread, float] = {}
        self.servers: list[tuple[str, float]] = []
        restart, spawn, spawn_server = (agent._restart_actor, agent._spawn_actor,
                                        agent._spawn_server)
        infer = agent._inference_fn

        def recorded_restart(index, err, reason="crash"):
            self.restarts.append((reason, agent._actors[index], time.monotonic()))
            restart(index, err, reason=reason)
            self.replacements.append(agent._actors[index])

        def recorded_spawn(index):
            t0 = time.monotonic()
            actor = spawn(index)
            self.spawned[actor] = t0
            return actor

        def recorded_spawn_server():
            old = agent._server
            if old is not None:
                cause = "crash" if old._fatal is not None else "watchdog"
                self.servers.append((cause, time.monotonic()))
            return spawn_server()

        def first_call(params, obs, *rest):
            self.first_call.setdefault(threading.current_thread(), time.monotonic())
            return infer(params, obs, *rest)

        agent._restart_actor = recorded_restart
        agent._spawn_actor = recorded_spawn
        agent._spawn_server = recorded_spawn_server
        agent._inference_fn = first_call

    def reasons(self) -> dict[str, int]:
        return dict(collections.Counter(reason for reason, _, _ in self.restarts))

    def first_step_ms(self) -> list[float]:
        """Spawn to first inference call of each replacement thread."""
        return [1e3 * (self.first_call[t] - self.spawned[t]) for t in self.replacements
                if t in self.first_call]


def _synchronous_save(directory: str, step: int, state, env_steps: int) -> None:
    """The checkpoint save as PR 16's port made it, on the caller's thread:
    the state to the host, ``torch.save``, the metadata, the rename and the
    manifest's digest (the baseline of the writer's train-thread cost)."""
    import os

    from asyncrl_tpu_torch.utils.checkpoint import META_FILE, STATE_FILE, content_digest, state_dict

    flat = state_dict(state)
    final, tmp = Path(directory) / str(step), Path(directory) / f".tmp-{step}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(flat, tmp / STATE_FILE)
    (tmp / META_FILE).write_text(json.dumps({"env_steps": env_steps}))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    (Path(directory) / f"manifest-{step}.json").write_text(json.dumps(
        {"step": step, "sha256": content_digest(flat), "env_steps": env_steps}))


def _supervision_cfg(**overrides):
    from asyncrl_tpu_torch.configs import presets

    return presets.pong_impala.replace(
        device="cuda", host_pool="native", eval_every=0, log_every=SEBULBA_LOG_EVERY,
        stall_timeout_s=SUPERVISION_TIMEOUT_S, **HOST_PONG, **overrides)


def _supervision_train(agent, updates: int, what: str):
    """Train ``agent`` to ``updates`` fresh updates with the launch counters
    reset; returns the windows, the wall seconds and the device bytes at
    the first window and at the end. B1 once an update, no other kernel."""
    steps_per_update = agent._envs_per_actor * agent.config.unroll_len
    done = agent.state.update_step
    memory = []

    def first_window(window):
        if not memory:
            torch.cuda.synchronize()
            memory.append(torch.cuda.memory_allocated())

    reset_counters()
    t0 = time.perf_counter()
    history = agent.train(total_env_steps=updates * steps_per_update, callback=first_window)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    expected = {k: (updates - done) * (k == "fused_vtrace") for k in KERNELS}
    if launches != expected or agent.state.update_step != updates:
        raise AssertionError(f"{what}: {updates - done} updates launched {launches}, "
                             f"expected {expected}")
    bad = [k for w in history for k, v in w.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{what}: non-finite metrics {sorted(set(bad))}")
    return history, wall, memory[0], torch.cuda.memory_allocated()


def _detection_ms(clock: _FaultClock, retired: dict) -> dict[str, list[float]]:
    """Each stalled site's ms to its thread's retirement (``retired``:
    thread -> time), from its last progress stamp and from the fire."""
    return {name: [1e3 * (retired[t] - stamp), 1e3 * (retired[t] - t0)]
            for name, t, stamp, t0 in clock.stalls if t in retired}


def _check_detection(what: str, detect_ms: dict, sites: tuple) -> None:
    """The stall began between the thread's last stamp and the fire: the
    retirement comes at least the timeout after the one and at most the
    timeout and the slack after the other."""
    low, high = 1e3 * SUPERVISION_TIMEOUT_S, 1e3 * (SUPERVISION_TIMEOUT_S
                                                   + SUPERVISION_DETECT_SLACK_S)
    if sorted(detect_ms) != sorted(sites) or not all(
            from_stamp >= low and from_fire <= high for from_stamp, from_fire in detect_ms.values()):
        raise AssertionError(f"{what}: watchdog detection ms (from the stamp, from the fire) "
                             f"{detect_ms}, expected {sites} in [{low}, {high}]")


def supervision_actors() -> dict:
    """(i) The actors under the watchdog: one ``actor.step`` crash, one
    ``pool.step`` and one ``actor.queue_put`` stall of 60 s. Gated: 3 actor
    restarts, 2 by the watchdog, each between the timeout and 2 s past it
    after its stall began; one fire a site; the target reached in under 30 s;
    the loss on the last drained slab bit-identical through B1."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.learn.learner import algo_loss
    from asyncrl_tpu_torch.ops.normalize import normalizing_apply
    from asyncrl_tpu_torch.rollout.buffer import rollout_map

    what = "supervision actors"
    agent = asyncrl_tpu_torch.make_agent(_supervision_cfg(fault_spec=SUPERVISION_ACTOR_FAULTS))
    clock, supervised = _FaultClock(), _Supervised(agent)
    drained, learner_update = {}, agent.learner.update

    def update(state, rollout, perms=None):
        drained["rollout"] = rollout_map(torch.clone, rollout)
        return learner_update(state, rollout, perms)

    agent.learner.update = update
    try:
        history, wall, before, after = _supervision_train(agent, SUPERVISION_ACTOR_UPDATES, what)
        last = history[-1]
        fires = {k: last.get(f"fault_{k}") for k in ("actor.step", "pool.step",
                                                      "actor.queue_put")}
        reasons = supervised.reasons()
        detect = _detection_ms(clock, {t: when for reason, t, when in supervised.restarts
                                       if reason == "watchdog"})
        if (agent._actor_restarts != 3 or reasons != {"crash": 1, "watchdog": 2}
                or set(fires.values()) != {1} or wall > SUPERVISION_WALL_S):
            raise AssertionError(f"{what}: restarts {agent._actor_restarts} {reasons}, fires "
                                 f"{fires}, {wall:.1f} s")
        _check_detection(what, detect, ("pool.step", "actor.queue_put"))
        lcfg = agent.learner.config
        model = normalizing_apply(agent.state.params, agent.state.obs_stats)
        with torch.no_grad():
            plain, _ = algo_loss(lcfg.replace(fused_scan="plain"), model, drained["rollout"],
                                 agent.learner.dist)
            kernel, _ = algo_loss(lcfg, model, drained["rollout"], agent.learner.dist)
        if not torch.equal(plain, kernel) or not torch.isfinite(kernel):
            raise AssertionError(f"{what}: kernel loss {kernel} vs plain {plain}")
        first_steps = supervised.first_step_ms()
    finally:
        agent.close()
    return {
        "updates": SUPERVISION_ACTOR_UPDATES, "actor_restarts_by_reason": reasons,
        "fires": fires, "watchdog_detection_ms": detect,
        "restarted_actor_first_step_ms": first_steps, "wall_s": wall,
        "env_steps_per_s": last["fps"], "loss_bit_identical_to_plain": True,
        "device_bytes_growth_over_the_restarts": after - before,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }


def supervision_server() -> dict:
    """(ii) The coalescing inference server under the watchdog: a
    ``server.serve`` crash, then, re-armed for a second call, a 60 s stall.
    Gated: 2 server rebuilds, the first for the crash, the second by the
    watchdog between the timeout and 2 s past it; one fire each; no actor
    retired by the watchdog (the actors' restarts are their clients'
    errors); each call under 30 s."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.utils import faults

    what = "supervision server"
    agent = asyncrl_tpu_torch.make_agent(_supervision_cfg(**SERVER,
                                                          fault_spec=SUPERVISION_SERVER_CRASH))
    supervised = _Supervised(agent)
    try:
        first, second = SUPERVISION_SERVER_UPDATES
        history, wall1, before, _ = _supervision_train(agent, first, what)
        crash_fires = history[-1].get("fault_server.serve")
        faults.arm(SUPERVISION_SERVER_STALL)
        clock = _FaultClock()
        history, wall2, _, after = _supervision_train(agent, second, what)
        stall_fires = history[-1].get("fault_server.serve")
        causes = [cause for cause, _ in supervised.servers]
        ((_, hung, _, _),) = clock.stalls
        detect = _detection_ms(clock, {hung: supervised.servers[-1][1]})
        reasons = supervised.reasons()
        if (causes != ["crash", "watchdog"] or agent._server_restarts != 2
                or (crash_fires, stall_fires) != (1, 1) or "watchdog" in reasons
                or max(wall1, wall2) > SUPERVISION_WALL_S):
            raise AssertionError(f"{what}: rebuilds {causes}, fires {crash_fires} "
                                 f"{stall_fires}, actor restarts {reasons}, "
                                 f"{wall1:.1f} s + {wall2:.1f} s")
        _check_detection(what, detect, ("server.serve",))
    finally:
        agent.close()
    return {
        "updates": second, "server_rebuilds_by_cause": causes,
        "server_watchdog_detection_ms": detect["server.serve"],
        "actor_restarts_by_reason": reasons, "wall_s": [wall1, wall2],
        "device_bytes_growth_over_the_restarts": after - before,
    }


def supervision_checkpoints() -> dict:
    """(iii) The checkpoint writer under the ``checkpoint.save`` site's two
    crashes, every 2 updates. Gated: both crashes absorbed by the retry,
    every periodic step on disk, each restoring to the SHA-256 of the state
    taken when it was saved (before the next update ran); a save followed at
    once by an update restores the state of the save; the snapshot's device
    bytes the state's. Printed: the train thread's ms per save against the
    synchronous save of PR 16's port at the same state."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.utils.checkpoint import content_digest, state_dict

    what = "supervision checkpoints"
    shutil.rmtree(SUPERVISION_CKPT_DIR, ignore_errors=True)
    agent = asyncrl_tpu_torch.make_agent(_supervision_cfg(
        checkpoint_dir=SUPERVISION_CKPT_DIR, checkpoint_every=2,
        fault_spec=SUPERVISION_CKPT_FAULTS))
    ck = agent.checkpointer
    saved, save_ms, save = {}, [], ck.save
    drained, learner_update = {}, agent.learner.update

    def update(state, rollout, perms=None):
        drained["rollout"] = rollout
        return learner_update(state, rollout, perms)

    def recorded_save(step, state, env_steps=0):
        saved[int(step)] = content_digest(state_dict(state))
        t0 = time.perf_counter()
        save(step, state, env_steps)
        save_ms.append(1e3 * (time.perf_counter() - t0))

    agent.learner.update = update
    ck.save = recorded_save
    try:
        history, wall, _, _ = _supervision_train(agent, SUPERVISION_CKPT_UPDATES, what)
        fires = history[-1].get("fault_checkpoint.save")
        steps = ck.all_steps()
        periodic = list(range(2, SUPERVISION_CKPT_UPDATES + 1, 2))
        # A state to restore into: the learner's init_state hands back its
        # own model, the live weights, so the weights are a copy.
        fresh = agent.learner.init_state(agent.config.seed + 1)
        fresh.params = copy.deepcopy(fresh.params)
        restored = {}
        for step in steps:
            ck.restore(fresh, step=step)
            restored[step] = content_digest(state_dict(fresh))
        if fires != 2 or steps != periodic or any(restored[s] != saved[s] for s in steps):
            raise AssertionError(f"{what}: {fires} fires, steps {steps}, restored digests "
                                 f"equal {[restored[s] == saved[s] for s in steps]}")
        # A save the next update overwrites in place at once, the writer
        # still running.
        frag = drained["rollout"]
        reset_counters()
        agent.state, _ = learner_update(agent.state, frag)
        step = agent.state.update_step
        ck.save(step, agent.state, agent.env_steps)
        agent.state, _ = learner_update(agent.state, frag)
        torch.cuda.synchronize()
        if counters() != {k: 2 * (k == "fused_vtrace") for k in KERNELS}:
            raise AssertionError(f"{what}: 2 updates launched {counters()}")
        t0 = time.perf_counter()
        ck.wait()
        writer_wait_ms = 1e3 * (time.perf_counter() - t0)
        ck.restore(fresh, step=step)
        if content_digest(state_dict(fresh)) != saved[step]:
            raise AssertionError(f"{what}: step {step} saved during the next update restores "
                                 "other bytes")
        state_bytes = sum(v.numel() * v.element_size()
                          for k, v in state_dict(agent.state).items()
                          if isinstance(v, torch.Tensor) and k != "generator")
        if ck.snapshot_bytes != state_bytes:
            raise AssertionError(f"{what}: snapshot {ck.snapshot_bytes} device bytes, the state "
                                 f"{state_bytes}")
        async_ms = []
        for i in range(3):
            t0 = time.perf_counter()
            save(step + 1 + i, agent.state, agent.env_steps)
            async_ms.append(1e3 * (time.perf_counter() - t0))
            ck.wait()
        sync_ms = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _synchronous_save(SUPERVISION_CKPT_DIR + "-sync", step + 1 + i, agent.state,
                              agent.env_steps)
            sync_ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        agent.close()
        shutil.rmtree(SUPERVISION_CKPT_DIR, ignore_errors=True)
        shutil.rmtree(SUPERVISION_CKPT_DIR + "-sync", ignore_errors=True)
    return {
        "updates": SUPERVISION_CKPT_UPDATES + 2, "save_fires_absorbed": fires,
        "periodic_steps_on_disk": steps, "restored_sha256_equal_at_save": True,
        "saved_during_next_update_restores_bit_identical": True,
        "snapshot_device_bytes": state_bytes, "train_thread_ms_per_save": async_ms,
        "train_thread_ms_per_periodic_save": save_ms,
        "synchronous_save_ms_pr16": sync_ms, "writer_wait_ms": writer_wait_ms,
        "wall_s": wall,
    }


def supervision_phase() -> dict:
    """The supervision slice on the card at ``sebulba_pong_impala``'s
    geometry (4 threads of 64 ``JaxPong-v0`` envs, T=32, MLP 256x256), with
    ``stall_timeout_s`` 2: the actors (``supervision_actors``), the shared
    server (``supervision_server``) and the checkpoint writer
    (``supervision_checkpoints``) in turn; B1 once an update throughout and
    no other kernel, device memory grown under 512 MiB over each part's
    restarts."""
    phase = "supervision_sebulba_pong_impala"
    phase_t0 = time.perf_counter()
    from asyncrl_tpu_torch.utils import faults

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        actors = supervision_actors()
        server = supervision_server()
        ckpt = supervision_checkpoints()
    finally:
        faults.disarm()  # the server's stall was armed by hand
    growth = [part["device_bytes_growth_over_the_restarts"] for part in (actors, server)]
    if max(growth) >= SUPERVISION_BYTES:
        raise AssertionError(f"{phase}: device memory grew {growth} bytes over the restarts")
    updates = actors["updates"] + server["updates"] + ckpt["updates"]
    row = {
        "phase": phase, "preset": "pong_impala", "overrides": {**HOST_PONG, "stall_timeout_s":
                                                                SUPERVISION_TIMEOUT_S},
        "ranks": 1, "updates": updates, "launches_per_update": {"fused_vtrace": 1},
        "launches": {k: updates * (k == "fused_vtrace") for k in KERNELS},
        "actors": actors, "server": server, "checkpoints": ckpt,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "kernel_device_ms": {"fused_vtrace": None, "ring_all_reduce": None},
        "phase_s": time.perf_counter() - phase_t0,
    }
    log(f"train {phase}: " + json.dumps(row))
    return row


def span_cost_ns(threads: int) -> dict:
    """ns of one ``trace.span`` around an empty body, enabled and disabled,
    with ``threads`` threads (named as actors) each opening ``TRACE_SPANS``
    spans at once: ``per_span`` is the wall time over all the spans,
    ``per_thread_span`` over one thread's (what a thread sees while the
    others contend for the GIL); ``added`` is enabled less disabled."""
    from asyncrl_tpu_torch.obs import spans as span_names
    from asyncrl_tpu_torch.obs import trace

    out = {}
    for state in ("enabled", "disabled"):
        tracer = trace.configure(state == "enabled")
        barrier = threading.Barrier(threads + 1)

        def work():
            barrier.wait()
            for _ in range(TRACE_SPANS):
                with trace.span(span_names.ACTOR_ENV_STEP):
                    pass

        workers = [threading.Thread(target=work, name=f"actor-{i}") for i in range(threads)]
        for w in workers:
            w.start()
        barrier.wait()
        t0 = time.perf_counter()
        for w in workers:
            w.join()
        wall = time.perf_counter() - t0
        if tracer is not None and tracer.stats()["trace_spans"] != threads * TRACE_SPANS:
            raise AssertionError(f"span cost: {tracer.stats()} after {threads} x {TRACE_SPANS}")
        out[state] = {"per_span": 1e9 * wall / (threads * TRACE_SPANS),
                      "per_thread_span": 1e9 * wall / TRACE_SPANS}
    trace.configure(False)
    out["added"] = {k: out["enabled"][k] - out["disabled"][k] for k in out["enabled"]}
    return out


def trace_phase() -> dict:
    """Tracing and forensics on the card at ``sebulba_pong_impala``'s
    geometry with the coalescing server (4 threads of 64 ``JaxPong-v0``
    envs, T=32, MLP 256x256): ``trace=True``, a run directory, one injected
    ``actor.step`` crash, ``TRACE_UPDATES`` updates. Gated: (a) dumps for
    ``fault.actor.step`` and ``supervisor.actor_restart``, one holding
    actor, server and learner spans; (b) the run's export and every dump
    valid, in process and through ``python -m asyncrl_tpu_torch.obs
    validate`` (exit 0); (c) the report with its ``dominant stall:`` line;
    (d) the last window's ``trace_spans`` > 0, ``trace_dropped_spans``,
    ``flightrec_dumps`` >= 2 and a finite ``h2d_wait_ms_p95``; (e) B1 once
    an update and nothing else; (g) the phase under ``TRACE_PHASE_S``.
    Printed: the report's ``learner.queue_wait`` share beside the windows'
    time-weighted ``learner_stall_frac``, spans an update by group, (f) the
    cost of a span and the share of an actor step it makes, device memory
    over the run."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.obs import export, flightrec, report, trace
    from asyncrl_tpu_torch.utils import faults

    phase = "trace_sebulba_pong_impala"
    phase_t0 = time.perf_counter()
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    cfg = presets.pong_impala.replace(
        device="cuda", host_pool="native", log_every=SEBULBA_LOG_EVERY, eval_every=0,
        trace=True, run_dir=TRACE_DIR, fault_spec=TRACE_FAULTS, **HOST_PONG, **SERVER)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    agent = asyncrl_tpu_torch.make_agent(cfg)
    steps_per_update = agent._envs_per_actor * cfg.unroll_len
    memory = []

    def first_window(window):
        if not memory:
            torch.cuda.synchronize()
            memory.append(torch.cuda.memory_allocated())

    try:
        reset_counters()
        t0 = time.perf_counter()
        history = agent.train(total_env_steps=TRACE_UPDATES * steps_per_update,
                              callback=first_window)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = counters()
        after = torch.cuda.memory_allocated()
    finally:
        agent.close()
        faults.disarm()
        trace.configure(False)
        flightrec.disarm()
    try:
        expected = {k: TRACE_UPDATES * (k == "fused_vtrace") for k in KERNELS}
        if launches != expected or agent.state.update_step != TRACE_UPDATES:
            raise AssertionError(f"{phase}: {agent.state.update_step} updates launched "
                                 f"{launches}, expected {expected}")
        last = history[-1]
        # A traced run mounts the health layer: its verdict is the one
        # string of a window.
        bad = [k for w in history for k, v in w.items()
               if k != "health_status" and not math.isfinite(v)]
        if (bad or last["trace_spans"] <= 0 or "trace_dropped_spans" not in last
                or last["flightrec_dumps"] < 2 or not math.isfinite(last["h2d_wait_ms_p95"])
                or last["actor_restarts"] < 1):
            raise AssertionError(f"{phase}: last window {json.dumps(last)}, non-finite {bad}")
        (trace_path,) = Path(TRACE_DIR).glob("trace-*.json")
        dump_paths = sorted(Path(TRACE_DIR).glob("flightrec-*.json"))
        dumps = [json.loads(p.read_text()) for p in dump_paths]
        doc = json.loads(trace_path.read_text())
        reasons = [d["reason"] for d in dumps]
        groups = [sorted(d["thread_groups"]) for d in dumps]
        if ("fault.actor.step" not in reasons or "supervisor.actor_restart" not in reasons
                or not any(set(TRACE_GROUPS) <= set(g) for g in groups)):
            raise AssertionError(f"{phase}: dumps {reasons} with groups {groups}")
        errors = {str(trace_path): export.validate_trace(doc)}
        errors.update({str(p): export.validate_trace(d["trace"], require_spans=False)
                       for p, d in zip(dump_paths, dumps)})
        procs = {p: subprocess.Popen(
            [sys.executable, "-m", "asyncrl_tpu_torch.obs", "validate", p], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for p in errors}
        cli = {}
        for p, proc in procs.items():
            out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
            cli[Path(p).name] = proc.returncode
            if proc.returncode != 0:
                errors[p] = errors[p] + [err.strip()]
        if any(errors.values()):
            raise AssertionError(f"{phase}: invalid documents {errors}")
        analysis = report.analyze(doc)
        text = report.render(analysis)
        dominant = [line for line in text.splitlines() if line.startswith("dominant stall:")]
        if not dominant:
            raise AssertionError(f"{phase}: the report has no dominant stall:\n{text}")
        queue_share = next(share for share, group, name, _ in analysis["waits"]
                           if (group, name) == ("learner", "learner.queue_wait"))
        seconds, stalled, before_steps = 0.0, 0.0, 0
        for w in history:
            elapsed = (w["env_steps"] - before_steps) / w["fps"]
            before_steps = w["env_steps"]
            seconds += elapsed
            stalled += w["learner_stall_frac"] * elapsed
        stall_frac = stalled / seconds
        spans = collections.Counter()
        for stage in analysis["stages"]:
            spans[stage.group] += stage.count
        actor_steps = sum(s.count for s in analysis["stages"] if s.name == "actor.env_step")
        actor_spans_per_step = spans["actor"] / actor_steps
        span_cost = {"1_thread": span_cost_ns(1),
                     f"{TRACE_SPAN_THREADS}_threads": span_cost_ns(TRACE_SPAN_THREADS)}
        # An actor step of one thread's 64 envs: the run's env steps/s over
        # all 256 envs, so each thread steps fps / num_envs times a second.
        step_ns = 1e9 * cfg.num_envs / last["fps"]
        added = span_cost[f"{TRACE_SPAN_THREADS}_threads"]["added"]["per_thread_span"]
        phase_s = time.perf_counter() - phase_t0
        if phase_s > TRACE_PHASE_S:
            raise AssertionError(f"{phase}: {phase_s:.1f} s, over {TRACE_PHASE_S} s")
    finally:
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
    row = {
        "phase": phase, "preset": "pong_impala",
        "overrides": {**HOST_PONG, **SERVER, "trace": True, "fault_spec": TRACE_FAULTS},
        "ranks": 1, "updates": TRACE_UPDATES, "launches_per_update": {"fused_vtrace": 1},
        "launches": launches,
        "dumps": [{"reason": d["reason"], "thread_groups": d["thread_groups"],
                   "spans": sum(e["ph"] == "X" for e in d["trace"]["traceEvents"])}
                  for d in dumps],
        "valid_in_process": True, "cli_validate_exit_codes": cli,
        "report_dominant_stall": dominant[0],
        "report_learner_queue_wait_share": queue_share,
        "learner_stall_frac_time_weighted": stall_frac,
        "queue_wait_gap": abs(queue_share - stall_frac),
        "queue_wait_gap_over_bar": abs(queue_share - stall_frac) > TRACE_STALL_GAP,
        "report_waits": {f"{group}:{name}": share
                         for share, group, name, _ in analysis["waits"]},
        "window": {k: last[k] for k in ("trace_spans", "trace_dropped_spans", "trace_threads",
                                        "flightrec_dumps", "h2d_wait_ms_count",
                                        "h2d_wait_ms_p50", "h2d_wait_ms_p95",
                                        "h2d_wait_ms_max", "actor_restarts",
                                        "learner_stall_frac", "fps")},
        "spans_per_update_by_group": {g: n / TRACE_UPDATES for g, n in sorted(spans.items())},
        "actor_spans_per_actor_step": actor_spans_per_step,
        "span_cost_ns": span_cost, "actor_step_ns": step_ns,
        "tracing_share_of_an_actor_step": actor_spans_per_step * added / step_ns,
        "train_s": train_s, "phase_s": phase_s,
        "device_bytes_growth_over_the_run": after - memory[0],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "kernel_device_ms": {"fused_vtrace": None, "ring_all_reduce": None},
    }
    log(f"report {phase}:\n{text}")
    log(f"train {phase}: " + json.dumps(row))
    return row


def _scrape(url: str) -> tuple[int, bytes, float]:
    """(status, body, ms) of one GET, 4xx and 5xx included."""
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=5.0) as resp:
            code, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, 1e3 * (time.perf_counter() - t0)


def _drain_ms(cfg, window: dict) -> float:
    """Mean ms of one ``observe_window`` of a fresh ``obs.setup(cfg)``
    handle over ``HEALTH_DRAINS`` copies of ``window``."""
    from asyncrl_tpu_torch import obs

    handle = obs.setup(cfg)
    try:
        t0 = time.perf_counter()
        for _ in range(HEALTH_DRAINS):
            handle.observe_window(dict(window))
        return 1e3 * (time.perf_counter() - t0) / HEALTH_DRAINS
    finally:
        handle.shutdown()


def health_phase() -> dict:
    """Run health on the card at ``sebulba_pong_impala``'s geometry (4
    threads of 64 ``JaxPong-v0`` envs, T=32, MLP 256x256) with per-thread
    inference: ``trace=True``, the endpoint on an ephemeral port,
    introspection on, ``health_window_ttl=2``, a storm of two ``actor.step``
    crashes, ``HEALTH_UPDATES`` updates, ``/healthz``, ``/metrics`` and
    ``/timeseries?key=fps`` scraped every window. Gated as the module
    docstring says; a failed bind or a missing device watermark fails it."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.obs import doctor, export, flightrec, health, timeseries, trace
    from asyncrl_tpu_torch.utils import bench_history, faults

    phase = "health_sebulba_pong_impala"
    phase_t0 = time.perf_counter()
    shutil.rmtree(HEALTH_DIR, ignore_errors=True)
    cfg = presets.pong_impala.replace(
        device="cuda", host_pool="native", log_every=HEALTH_LOG_EVERY, eval_every=0,
        trace=True, run_dir=HEALTH_DIR, fault_spec=HEALTH_FAULTS, obs_http_port=-1,
        introspect=True, health_window_ttl=HEALTH_TTL, inference_server=False, **HOST_PONG)
    histories = [ROOT / name for name in ("BENCH_HISTORY.json", "BENCH_HISTORY_TORCH.json")]

    def digests():
        return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() if p.exists() else None
                for p in histories}

    digests_before = digests()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    agent = asyncrl_tpu_torch.make_agent(cfg)
    setup_s = time.perf_counter() - t_setup
    if agent._obs.http is None:
        raise AssertionError(f"{phase}: the endpoint did not bind")
    base = f"http://127.0.0.1:{agent._obs.http.port}"
    steps_per_update = agent._envs_per_actor * cfg.unroll_len
    memory, scrapes, drains = [], [], []
    live = agent._obs.observe_window

    def timed_drain(agg):
        t0 = time.perf_counter()
        out = live(agg)
        drains.append(1e3 * (time.perf_counter() - t0))
        return out

    agent._obs.observe_window = timed_drain

    def scrape(window):
        if not memory:
            torch.cuda.synchronize()
            memory.append(torch.cuda.memory_allocated())
        healthz, metrics, fps = (_scrape(f"{base}{route}") for route in (
            "/healthz", "/metrics", "/timeseries?key=fps"))
        scrapes.append({"healthz": (healthz[0], json.loads(healthz[1])["status"]),
                        "metrics": (metrics[0], metrics[1].decode()),
                        "fps_points": len(json.loads(fps[1])["points"]),
                        "ms": {"healthz": healthz[2], "metrics": metrics[2],
                               "timeseries": fps[2]}})

    try:
        reset_counters()
        t0 = time.perf_counter()
        history = agent.train(total_env_steps=HEALTH_UPDATES * steps_per_update, callback=scrape)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = counters()
        after = torch.cuda.memory_allocated()
        port = agent._obs.http.port
    finally:
        t_close = time.perf_counter()
        agent.close()
        close_s = time.perf_counter() - t_close
        faults.disarm()
        trace.configure(False)
        flightrec.disarm()
    history_dir = tempfile.mkdtemp(prefix="health_history_")
    try:
        expected = {k: HEALTH_UPDATES * (k == "fused_vtrace") for k in KERNELS}
        if launches != expected or agent.state.update_step != HEALTH_UPDATES:
            raise AssertionError(f"{phase}: {agent.state.update_step} updates launched "
                                 f"{launches}, expected {expected}")
        if "obs-http" in [t.name for t in threading.enumerate()]:
            raise AssertionError(f"{phase}: an obs-http thread outlived close()")
        try:
            _scrape(f"http://127.0.0.1:{port}/healthz")
        except OSError:
            pass
        else:
            raise AssertionError(f"{phase}: port {port} still answers after close()")
        # The verdict over the run: critical inside the storm's TTL, ok after.
        codes = [s["healthz"] for s in scrapes]
        if (503, "critical") not in codes or (200, "ok") not in codes[
                codes.index((503, "critical")):]:
            raise AssertionError(f"{phase}: /healthz answered {codes}")
        bad_metrics = [i for i, s in enumerate(scrapes) if s["metrics"][0] != 200
                       or "# TYPE asyncrl_fps gauge" not in s["metrics"][1]
                       or not re.search(r"^asyncrl_mem_device_bytes_in_use \S+$",
                                        s["metrics"][1], re.M)]
        points = [s["fps_points"] for s in scrapes]
        if bad_metrics or points != list(range(1, len(history) + 1)):
            raise AssertionError(f"{phase}: /metrics bad in windows {bad_metrics}, "
                                 f"/timeseries points {points}")
        keys = {"health_events", "health_status", "staleness_p50", "staleness_p95",
                "staleness_max", "staleness_mean", "compiles", "learner_recompile",
                "infer_recompile", "compile_ms_p50", "compile_ms_p95", "compile_ms_max",
                "compile_ms_count", "mem_device_bytes_in_use", "mem_device_peak_bytes",
                "mem_device_bytes_limit", "mem_host_rss_bytes", "mem_host_rss_peak_bytes"}
        limit = torch.cuda.get_device_properties(torch.device("cuda")).total_memory
        for i, w in enumerate(history):
            missing = keys - set(w)
            if missing:
                raise AssertionError(f"{phase}: window {i} lacks {sorted(missing)}")
            if abs(w["staleness_mean"] - w["param_lag"]) > 1e-9 * max(abs(w["param_lag"]), 1.0):
                raise AssertionError(f"{phase}: window {i} staleness_mean "
                                     f"{w['staleness_mean']} != param_lag {w['param_lag']}")
            if w["learner_recompile"] != 1:
                raise AssertionError(f"{phase}: window {i} learner_recompile "
                                     f"{w['learner_recompile']}")
            mem = (w["mem_device_bytes_in_use"], w["mem_device_peak_bytes"],
                   w["mem_device_bytes_limit"])
            if not (0 < mem[0] <= mem[1] <= mem[2] and mem[2] == limit):
                raise AssertionError(f"{phase}: window {i} memory {mem}, limit {limit}")
            bad = [k for k, v in w.items() if k != "health_status" and not math.isfinite(v)]
            if bad:
                raise AssertionError(f"{phase}: window {i} non-finite {bad}")
        last = history[-1]
        if last.get("health_restart_storm", 0) < 1:
            raise AssertionError(f"{phase}: no restart storm counted: {json.dumps(last)}")
        dump_paths = sorted(Path(HEALTH_DIR).glob("flightrec-*.json"))
        dumps = {p: json.loads(p.read_text()) for p in dump_paths}
        storm = [p for p, d in dumps.items() if d["reason"] == "health.restart_storm"]
        if not storm:
            raise AssertionError(f"{phase}: no health.restart_storm dump among "
                                 f"{[d['reason'] for d in dumps.values()]}")
        errors = export.validate_trace(dumps[storm[0]]["trace"], require_spans=False)
        # The command line's validation runs beside the doctor's below.
        t_commands = time.perf_counter()
        validate = subprocess.Popen(
            [sys.executable, "-m", "asyncrl_tpu_torch.obs", "validate", str(storm[0])],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        run = timeseries.read_jsonl(str(Path(HEALTH_DIR) / timeseries.FILENAME))
        thresholds = dataclasses.asdict(health.Thresholds.from_config(agent.config))
        if (len(run["samples"]) != len(history) or run["meta"]["platform"] != "gpu"
                or run["meta"]["thresholds"] != thresholds):
            raise AssertionError(f"{phase}: timeseries.jsonl holds {len(run['samples'])} "
                                 f"samples for {len(history)} windows, meta {run['meta']}")
        by_detector = collections.Counter(e["detector"] for e in run["events"]
                                          if "detector" in e)
        # The doctor against a temporary history: a row at half the run's
        # best fps passes; the same history with a row at four times it
        # recorded after is a regression. The two histories are two files,
        # so that both commands run at once, beside the validation.
        best = doctor.best_fps(run["samples"])
        previous = os.environ.get("ASYNCRL_BENCH_HISTORY")
        cases, procs = {}, {}
        try:
            for factor, want_code, want in ((0.5, 0, "ok"), (4.0, 1, "regressed")):
                path = Path(history_dir) / f"history-{want}.json"
                if want == "regressed":
                    shutil.copy(Path(history_dir) / "history-ok.json", path)
                os.environ["ASYNCRL_BENCH_HISTORY"] = str(path)
                row = bench_history.record_throughput("sebulba_pong_impala", agent.config,
                                                      factor * best)
                verdict = doctor.regression_verdict(run["meta"], run["samples"],
                                                    preset="sebulba_pong_impala")
                cases[want] = (factor, want_code, verdict, row, len(bench_history.load()))
                procs[want] = subprocess.Popen(
                    [sys.executable, "-m", "asyncrl_tpu_torch.obs", "doctor", HEALTH_DIR,
                     "--preset", "sebulba_pong_impala"], cwd=ROOT,
                    env={**os.environ, "ASYNCRL_BENCH_HISTORY": str(path)},
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        finally:
            if previous is None:
                os.environ.pop("ASYNCRL_BENCH_HISTORY", None)
            else:
                os.environ["ASYNCRL_BENCH_HISTORY"] = previous
        verdicts = {}
        for want, (factor, want_code, verdict, row, rows) in cases.items():
            out, err = procs[want].communicate(timeout=SUBPROCESS_TIMEOUT_S)
            verdicts[want] = {"exit_code": procs[want].returncode, "verdict": verdict["verdict"],
                              "baseline_fps": verdict["baseline_fps"],
                              "run_fps": verdict["run_fps"], "history_rows": rows,
                              "row_platform": row["platform"],
                              "verdict_line": out.strip().splitlines()[-1] if out.strip() else ""}
            if procs[want].returncode != want_code or verdict["verdict"] != want:
                raise AssertionError(f"{phase}: doctor at {factor}x the best fps: "
                                     f"{verdicts[want]}\n{out}{err}")
        _, validate_err = validate.communicate(timeout=SUBPROCESS_TIMEOUT_S)
        commands_s = time.perf_counter() - t_commands
        if errors or validate.returncode != 0:
            raise AssertionError(f"{phase}: the storm dump is invalid: {errors} "
                                 f"{validate_err.strip()}")
        if digests() != digests_before:
            raise AssertionError(f"{phase}: the committed histories changed: "
                                 f"{digests_before} -> {digests()}")
        growth = after - memory[0]
        if growth >= HEALTH_BYTES:
            raise AssertionError(f"{phase}: device memory grew {growth} bytes over the restarts")
        # Printed, not gated: the window drain mounted and not, on the last
        # window's keys.
        drain_cfg = agent.config.replace(trace=False, obs_http_port=0,
                                         run_dir=str(Path(history_dir) / "drain"))
        drain_ms = {"mounted_live_mean": statistics.mean(drains),
                    "mounted": _drain_ms(drain_cfg.replace(trace=True), last),
                    "unmounted": _drain_ms(drain_cfg, last)}
        trace.configure(False)
        flightrec.disarm()
        phase_s = time.perf_counter() - phase_t0
        if phase_s > HEALTH_PHASE_S:
            raise AssertionError(f"{phase}: {phase_s:.1f} s, over {HEALTH_PHASE_S} s")
    finally:
        shutil.rmtree(HEALTH_DIR, ignore_errors=True)
        shutil.rmtree(history_dir, ignore_errors=True)
    storm_windows = [i for i, w in enumerate(history) if w["health_events"] >= 1]
    row = {
        "phase": phase, "preset": "pong_impala",
        "overrides": {**HOST_PONG, "inference_server": False, "trace": True,
                      "obs_http_port": -1, "health_window_ttl": HEALTH_TTL,
                      "log_every": HEALTH_LOG_EVERY, "fault_spec": HEALTH_FAULTS},
        "ranks": 1, "updates": HEALTH_UPDATES, "windows": len(history),
        "launches_per_update": {"fused_vtrace": 1}, "launches": launches,
        "healthz_by_window": [list(c) for c in codes],
        "windows_with_events": storm_windows,
        "events_by_detector": dict(by_detector),
        "window_staleness_equals_param_lag": True,
        "infer_recompile": last["infer_recompile"], "learner_recompile":
            last["learner_recompile"], "compiles": last["compiles"],
        "compile_ms_p50": last["compile_ms_p50"], "compile_ms_max": last["compile_ms_max"],
        "health_restart_storm": last["health_restart_storm"],
        "actor_restarts": last["actor_restarts"],
        "mem_device": {k: last[k] for k in ("mem_device_bytes_in_use", "mem_device_peak_bytes",
                                            "mem_device_bytes_limit")},
        "mem_host_rss_bytes": last["mem_host_rss_bytes"],
        "storm_dump": storm[0].name, "doctor": verdicts,
        "committed_histories_unchanged": True,
        "scrape_p50_ms": {route: statistics.median(s["ms"][route] for s in scrapes)
                          for route in ("healthz", "metrics", "timeseries")},
        "observe_window_ms": drain_ms,
        "fps_last_window": last["fps"], "learner_stall_frac_last": last["learner_stall_frac"],
        "setup_s": setup_s, "train_s": train_s, "close_s": close_s,
        "three_commands_s": commands_s, "phase_s": phase_s,
        "device_bytes_growth_over_the_restarts": growth,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "kernel_device_ms": {"fused_vtrace": None, "ring_all_reduce": None},
    }
    log(f"train {phase}: " + json.dumps(row))
    return row


def _flat_params_sha256(flat: dict) -> str:
    """SHA-256 over the ``params.*`` tensors of a flat state dict, by key."""
    digest = hashlib.sha256()
    for key in sorted(k for k in flat if k.startswith("params.")):
        digest.update(key.encode())
        digest.update(flat[key].numpy().tobytes())
    return digest.hexdigest()


def _elastic_acts(agent, phase: str) -> dict:
    """Acts 1 and 2 of the elastic phase on ``agent`` (see ``ELASTIC_*``):
    trains ``ELASTIC_UPDATES`` updates, watching every window, every barrier
    and every batch; returns what the gates and the line read."""
    from asyncrl_tpu_torch.rollout import staging
    from asyncrl_tpu_torch.utils import faults

    holder, barrier, ckpt = agent._staging, agent._elastic_barrier, agent._ckpt
    steps_per_update = agent._envs_per_actor * agent.config.unroll_len
    # The fleet the first window ran with: the actors start inside train().
    fleets, windows, retired_max, rings, memory = [agent.config.actor_threads], [], [0], {}, []
    registries, slabs_after, actions, saves, batches = [], [], [], [], []
    act2 = {}
    last_fragment = {}

    # Every batch is taken from the ring that minted the fragment just drained.
    real_check, real_batch = agent._seq_checker.check, staging.StagingRing.batch

    def check(fragment):
        last_fragment["ring"] = fragment.lease.ring if fragment.lease is not None else None
        return real_check(fragment)

    def batch(ring, slab_id):
        batches.append(ring is last_fragment.get("ring"))
        return real_batch(ring, slab_id)

    real_save = ckpt.save_now

    def save_now(state, env_steps):
        saves.append(state.update_step)
        return real_save(state, env_steps)

    # Each action's split: the barrier's save and wait, the ring's pinned
    # allocation, the slot operation and the swap.
    timers = {}

    def timed(name, fn):
        def wrapper(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                timers[name] = 1e3 * (time.perf_counter() - t0)
        return wrapper

    real_build = agent._build_staging_ring
    agent._build_staging_ring = timed("build_ring_ms", real_build)
    agent._scale_up_actor = timed("slot_ms", agent._scale_up_actor)
    agent._scale_down_actor = timed("slot_ms", agent._scale_down_actor)
    real_swap, forced = holder.swap, []

    def swap(new_ring):
        # Printed: retired rings dropped while still busy (beyond
        # MAX_RETIRED_RINGS), whose queued fragments the drain skips.
        busy = [r for r in [*holder._retired, holder.current()] if r.busy()]
        t0 = time.perf_counter()
        real_swap(new_ring)
        timers["swap_ms"] = 1e3 * (time.perf_counter() - t0)
        forced.extend(r for r in busy if not any(r is k for k in holder._retired))

    holder.swap = swap
    real_run = barrier.run

    def run(state, env_steps, action):
        timers.clear()
        t0 = time.perf_counter()
        saves_before = len(saves)
        entry = {"fleet_before": len(agent._actors), "update": state.update_step}

        def watched():
            entry["save_wait_ms"] = 1e3 * (time.perf_counter() - t0)
            entry["saves"] = len(saves) - saves_before
            entry["on_disk"] = agent.checkpointer.latest_step()
            entry["sha_at_save"] = params_sha256(state)
            action()

        out = real_run(state, env_steps, watched)
        entry.update(timers, ok=out[2], span_ms=1e3 * (time.perf_counter() - t0),
                     fleet_after=len(agent._actors))
        actions.append(entry)
        return out

    barrier.run = run

    def broken_build(actor_count):
        # Act 2: the weights are damaged first, so only the barrier's
        # restore can bring them back.
        agent._build_staging_ring = timed("build_ring_ms", real_build)
        with torch.no_grad():
            for p in agent.state.params.parameters():
                p.add_(1.0)
        raise MemoryError("injected staging-ring allocation failure")

    def on_window(window):
        if not memory:
            torch.cuda.synchronize()
            memory.append(torch.cuda.memory_allocated())
        fleets.append(len(agent._actors))
        windows.append(window)
        retired_max[0] = max(retired_max[0], len(holder._retired))
        for ring in [holder.current(), *holder._retired]:
            rings[id(ring)] = ring
        slabs_after.append(holder.num_slabs)
        registries.append((sorted(agent._server._client_policy), agent._server._n))
        if "armed_at" in act2 and "window" not in act2:
            act2.update(window=len(windows) - 1, sha_after=params_sha256(agent.state))
        changes = sum(a != b for a, b in zip(fleets, fleets[1:]))
        if changes == len(ELASTIC_FLEET) - 1 and fleets[-1] == fleets[-2] == fleets[-3] \
                and "armed_at" not in act2:
            agent._build_staging_ring = broken_build
            faults.request_scale(1)
            act2["armed_at"] = len(windows) - 1

    agent._seq_checker.check = check
    staging.StagingRing.batch = batch
    ckpt.save_now = save_now
    try:
        reset_counters()
        t0 = time.perf_counter()
        history = agent.train(total_env_steps=ELASTIC_UPDATES * steps_per_update,
                              callback=on_window)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = counters()
        after = torch.cuda.memory_allocated()
    finally:
        staging.StagingRing.batch = real_batch
    expected = {k: ELASTIC_UPDATES * (k == "fused_vtrace") for k in KERNELS}
    if launches != expected or agent.state.update_step != ELASTIC_UPDATES:
        raise AssertionError(f"{phase}: {agent.state.update_step} updates launched "
                             f"{launches}, expected {expected}")
    return {"history": history, "fleets": fleets, "retired_max": retired_max[0],
            "rings": list(rings.values()), "registries": registries,
            "slabs_after": slabs_after, "actions": actions, "saves": saves,
            "batches": batches, "act2": act2, "train_s": train_s, "launches": launches,
            "forced": len(forced),
            "growth": after - memory[0]}


def _slab_free_check(template) -> dict:
    """The slab-free hazard on the card: the port frees a staging slab on
    its copy's CUDA event. A pinned ring whose one slab is being copied
    behind ``ELASTIC_SLEEP_CYCLES`` of ``torch.cuda._sleep`` on a side
    stream is retired, then swapped past ``MAX_RETIRED_RINGS`` times: the
    holder keeps it (its slab untouched) at every swap made while the copy
    is pending and drops it at the first swap after; the copy lands the
    bytes written before it. Then the same ring, oldest among
    ``MAX_RETIRED_RINGS`` busy ones, is force-dropped by a swap that
    returns only once its copy has run."""
    from asyncrl_tpu_torch.rollout import staging
    from asyncrl_tpu_torch.rollout.buffer import rollout_leaves

    rng = np.random.default_rng(0)
    cap = staging.RingSwapHolder.MAX_RETIRED_RINGS

    def ring():
        return staging.StagingRing(template, rows_per_slab=1, num_slabs=2, pin_memory=True)

    def pending_copy(holder):
        """A committed, batched and retired slab of the current ring whose
        copy to the card waits behind a sleep; (ring, event, sent, landed)."""
        owner = holder.current()
        lease = holder.acquire()
        for a in rollout_leaves(owner._slabs[lease.slab].arrays):
            np.copyto(a, rng.standard_normal(a.shape).astype(a.dtype))
        lease.commit()
        leaves = rollout_leaves(owner.batch(lease.slab))
        sent = [t.clone() for t in leaves]
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            torch.cuda._sleep(ELASTIC_SLEEP_CYCLES)
            landed = [t.to("cuda", non_blocking=True) for t in leaves]
            event = torch.cuda.Event()
            event.record(stream)
        owner.retire(lease.slab, event)
        return owner, event, sent, landed

    holder = staging.RingSwapHolder(ring())
    ring0, event, sent, landed = pending_copy(holder)
    kept_while_pending = []
    for _ in range(cap + 2):
        pending = not event.query()
        holder.swap(ring())
        if pending:
            kept_while_pending.append(any(r is ring0 for r in holder._retired)
                                      and ring0.copies_pending())
    event.synchronize()
    torch.cuda.synchronize()
    holder.swap(ring())
    dropped_after = not any(r is ring0 for r in holder._retired)
    intact = all(torch.equal(d.cpu(), h) for d, h in zip(landed, sent))

    holder = staging.RingSwapHolder(ring())
    ring1, event1, _, _ = pending_copy(holder)
    holder.acquire()  # an open lease: ring1 is busy too
    for _ in range(cap):
        holder.swap(ring())
        holder.acquire()  # each retired ring keeps an open lease
    waited = not event1.query()
    t0 = time.perf_counter()
    holder.swap(ring())
    force_ms = 1e3 * (time.perf_counter() - t0)
    forced = (event1.query() and not any(r is ring1 for r in holder._retired)
              and all(s.phase == "free" for s in ring1._slabs))
    holder.reset()
    torch.cuda.synchronize()
    row = {"swaps_while_copy_pending": len(kept_while_pending),
           "kept_at_each": all(kept_while_pending), "dropped_after_copy": dropped_after,
           "copy_bytes_intact": intact, "force_drop_waited_for_copy": waited and forced,
           "force_drop_swap_ms": force_ms}
    if not (kept_while_pending and row["kept_at_each"] and dropped_after and intact
            and forced and waited):
        raise AssertionError(f"slab-free hazard: {json.dumps(row)}")
    return row


def _elastic_organic(cfg, phase: str) -> dict:
    """Act 3: one actor under a stall bar any starvation clears grows to
    its max of 2 through the hysteresis, with no fault and no restart."""
    import asyncrl_tpu_torch

    agent = asyncrl_tpu_torch.make_agent(cfg.replace(
        actor_threads=1, num_envs=cfg.num_envs // cfg.actor_threads, elastic_max_actors=2,
        elastic_cooldown_windows=0, elastic_up_stall_frac=0.01, fault_spec="",
        checkpoint_dir="", trace=False, obs_http_port=0))
    try:
        steps = agent._envs_per_actor * agent.config.unroll_len
        reset_counters()
        history = agent.train(total_env_steps=ELASTIC_ORGANIC_UPDATES * steps)
        torch.cuda.synchronize()
        launches = counters()
    finally:
        agent.close()
    last = history[-1]
    row = {"windows": len(history), "elastic_scale_up": last.get("elastic_scale_up", 0),
           "actors_live": last["actors_live"], "actor_restarts": last["actor_restarts"],
           "learner_stall_frac_by_window": [w["learner_stall_frac"] for w in history],
           "launches": launches}
    expected = {k: ELASTIC_ORGANIC_UPDATES * (k == "fused_vtrace") for k in KERNELS}
    if (row["elastic_scale_up"] < 1 or row["actors_live"] != 2.0 or row["actor_restarts"] != 0
            or launches != expected):
        raise AssertionError(f"{phase}: organic act: {json.dumps(row)}")
    return row


def elastic_phase() -> dict:
    """The elastic runtime on the card at ``sebulba_pong_impala``'s geometry
    through the serve core (see ``ELASTIC_*``): act 1's scripted scales and
    crash, act 2's failed reconfigure, act 3's organic scale-up. Gated as
    the module docstring says."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.obs import flightrec, trace
    from asyncrl_tpu_torch.rollout import staging
    from asyncrl_tpu_torch.utils import faults
    from asyncrl_tpu_torch.utils.checkpoint import STATE_FILE

    phase = "elastic_sebulba_pong_impala"
    phase_t0 = time.perf_counter()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    ckpt_dir = str(Path(ELASTIC_DIR) / "ckpt")
    cfg = presets.pong_impala.replace(
        device="cuda", host_pool="native", log_every=ELASTIC_LOG_EVERY, eval_every=0,
        inference_server=True, serve=True, elastic=True, elastic_max_actors=ELASTIC_MAX_ACTORS,
        elastic_up_stall_frac=1.0, elastic_down_backpressure=0.0, elastic_down_admission=0.0,
        checkpoint_dir=ckpt_dir, trace=True, run_dir=ELASTIC_DIR, obs_http_port=-1,
        fault_spec=ELASTIC_FAULTS, **HOST_PONG)
    previous = os.environ.get("ASYNCRL_DEBUG_SYNC")
    os.environ["ASYNCRL_DEBUG_SYNC"] = "1"
    try:
        torch.cuda.empty_cache()
        agent = asyncrl_tpu_torch.make_agent(cfg)
        cap = agent._queue.maxsize
        try:
            slab_free = _slab_free_check(agent._staging_template)
            acts = _elastic_acts(agent, phase)
            events = [e for e in agent._obs.store.events(last_n=1024)
                      if e.get("event_type") == "elastic_scale"]
        finally:
            agent.close()
            faults.disarm()
            trace.configure(False)
            flightrec.disarm()
        organic = _elastic_organic(cfg, phase)
        reasons = sorted({json.loads(p.read_text())["reason"]
                          for p in Path(ELASTIC_DIR).glob("flightrec-*.json")})
        history, fleets, actions = acts["history"], acts["fleets"], acts["actions"]
        act2 = acts["act2"]
        # Fleet: one slot a window, in the script's order.
        collapsed = [f for i, f in enumerate(fleets) if i == 0 or f != fleets[i - 1]]
        steps_ok = all(abs(b - a) <= 1 for a, b in zip(fleets, fleets[1:]))
        changed = [i for i in range(1, len(fleets)) if fleets[i] != fleets[i - 1]]
        restarts = [w["actor_restarts"] for w in history]
        live_bad = [i for i, w in enumerate(history) if w["actors_live"] != fleets[i] and not (
            w["actors_live"] == fleets[i] - 1
            and restarts[min(i + 1, len(restarts) - 1)] > (restarts[i - 1] if i else 0))]
        last = history[-1]
        if (collapsed != ELASTIC_FLEET or not steps_ok or changed[1] != changed[0] + 1
                or changed[3:5] != [changed[2] + 1, changed[2] + 2] or live_bad
                or last.get("elastic_scale_up") != 2 or last.get("elastic_scale_down") != 3
                or last["actor_restarts"] != 1 or last.get("fault_pool.step") != 1
                or not math.isfinite(last["loss"])):
            raise AssertionError(f"{phase}: fleet by window {fleets}, actors_live "
                                 f"{[w['actors_live'] for w in history]} (bad {live_bad}), "
                                 f"last window {json.dumps(last)}")
        # Ring: sized for the fleet a window ran with, the queue's capacity
        # fixed at construction; at most 4 retired rings; all free after
        # stop(); every batch from its fragment's ring.
        want_slabs = [staging.auto_num_slabs(cap, f, 1) for f in fleets]
        slabs = [w["staging_slabs_live"] for w in history]
        free = all(s.phase == "free" for ring in acts["rings"] for s in ring._slabs)
        if (slabs != want_slabs[:-1] or acts["slabs_after"] != want_slabs[1:]
                or acts["retired_max"] > staging.RingSwapHolder.MAX_RETIRED_RINGS or not free
                or not all(acts["batches"]) or len(acts["batches"]) != ELASTIC_UPDATES):
            raise AssertionError(
                f"{phase}: staging_slabs_live {slabs}, expected {want_slabs[:-1]}; after "
                f"each window {acts['slabs_after']}; retired at most {acts['retired_max']}; "
                f"all free {free}; batches from their ring "
                f"{sum(acts['batches'])}/{len(acts['batches'])}")
        # Serve registry: the registered clients are the live fleet's slots.
        bad_registry = [i for i, (clients, n) in enumerate(acts["registries"])
                        if clients != list(range(fleets[i + 1])) or n < fleets[i + 1]]
        if bad_registry:
            raise AssertionError(f"{phase}: serve registry {acts['registries']} for fleets "
                                 f"{fleets[1:]} (bad windows {bad_registry})")
        # Barrier: every action behind one save, on disk before it ran; act 2
        # the only failure, restoring the saved weights with the fleet and
        # ring as they were.
        failed = [a for a in actions if not a["ok"]]
        saved = torch.load(Path(ckpt_dir) / str(failed[0]["on_disk"]) / STATE_FILE,
                           weights_only=True) if failed else {}
        w2 = act2.get("window")
        if (len(actions) != 6 or any(a["saves"] != 1 or a["on_disk"] != a["update"]
                                     for a in actions)
                or len(failed) != 1 or failed[0] is not actions[-1] or w2 is None
                or failed[0]["fleet_after"] != failed[0]["fleet_before"]
                or fleets[w2 + 1] != fleets[w2]
                or acts["slabs_after"][w2] != acts["slabs_after"][w2 - 1]
                or act2["sha_after"] != failed[0]["sha_at_save"]
                or _flat_params_sha256(saved) != failed[0]["sha_at_save"]
                or last.get("elastic_reconfigure_failed") != 1):
            raise AssertionError(f"{phase}: barrier actions {json.dumps(actions)}, act 2 "
                                 f"{json.dumps(act2)}, last window {json.dumps(last)}")
        # Forensics: one annotation an applied action, with JAX's keys; the
        # recorder's dumps.
        want_events = [("scale_up" if b > a else "scale_down", a, b)
                       for a, b in zip(collapsed, collapsed[1:])]
        got_events = [(e["action"], e["actors_before"], e["actors_after"]) for e in events]
        if (got_events != want_events or any(sorted(e) != ELASTIC_EVENT_KEYS for e in events)
                or not {"elastic.scale_up", "elastic.scale_down",
                        "elastic.reconfigure_failed"} <= set(reasons)):
            raise AssertionError(f"{phase}: events {got_events}, expected {want_events}, keys "
                                 f"{[sorted(e) for e in events]}; dumps {reasons}")
        if acts["growth"] >= ELASTIC_BYTES:
            raise AssertionError(f"{phase}: device memory grew {acts['growth']} bytes")
        phase_s = time.perf_counter() - phase_t0
        if phase_s > ELASTIC_PHASE_S:
            raise AssertionError(f"{phase}: {phase_s:.1f} s, over {ELASTIC_PHASE_S} s")
    finally:
        if previous is None:
            os.environ.pop("ASYNCRL_DEBUG_SYNC", None)
        else:
            os.environ["ASYNCRL_DEBUG_SYNC"] = previous
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    # Printed, not gated: each action's split, env steps/s at each fleet
    # size, the serve core's dispatches a window around the last scale-down.
    split = {}
    for a in actions:
        key = "failed" if not a["ok"] else ("up" if a["fleet_after"] > a["fleet_before"]
                                             else "down")
        split.setdefault(key, []).append({k: a.get(k) for k in (
            "span_ms", "save_wait_ms", "build_ring_ms", "slot_ms", "swap_ms")})
    fps_by_fleet = {}
    for i, w in enumerate(history):
        fps_by_fleet.setdefault(fleets[i], []).append(w["fps"])
    dispatch = []
    prev = (0.0, 0.0)
    for w in history:
        now = (w.get("serve_dispatch_full", 0.0), w.get("serve_dispatch_deadline", 0.0))
        dispatch.append([now[0] - prev[0], now[1] - prev[1]])
        prev = now
    last_down = changed[4]
    row = {
        "phase": phase, "preset": "pong_impala",
        "overrides": {**HOST_PONG, "inference_server": True, "serve": True, "elastic": True,
                      "elastic_max_actors": ELASTIC_MAX_ACTORS, "elastic_up_stall_frac": 1.0,
                      "elastic_down_backpressure": 0.0, "elastic_down_admission": 0.0,
                      "trace": True, "obs_http_port": -1, "log_every": ELASTIC_LOG_EVERY,
                      "fault_spec": ELASTIC_FAULTS},
        "ranks": 1, "updates": ELASTIC_UPDATES, "windows": len(history),
        "launches_per_update": {"fused_vtrace": 1}, "launches": acts["launches"],
        "fleet_by_window": fleets, "staging_slabs_by_window": [w["staging_slabs_live"]
                                                               for w in history],
        "retired_rings_max": acts["retired_max"], "rings_seen": len(acts["rings"]),
        "busy_rings_force_dropped": acts["forced"], "slab_free_check": slab_free,
        "act2_window": act2.get("window"), "flightrec_reasons": reasons,
        "elastic_scale_up": last.get("elastic_scale_up"),
        "elastic_scale_down": last.get("elastic_scale_down"),
        "elastic_reconfigure_failed": last.get("elastic_reconfigure_failed"),
        "actor_restarts": last["actor_restarts"], "loss_last": last["loss"],
        "reconfigure_ms": split,
        "env_steps_per_s_by_fleet": {f: statistics.mean(v) for f, v in
                                     sorted(fps_by_fleet.items())},
        "serve_dispatch_full_deadline_by_window": dispatch,
        "serve_dispatch_before_last_scale_down": [sum(d[0] for d in dispatch[:last_down]),
                                                  sum(d[1] for d in dispatch[:last_down])],
        "serve_dispatch_after_last_scale_down": [sum(d[0] for d in dispatch[last_down:]),
                                                 sum(d[1] for d in dispatch[last_down:])],
        "organic": organic, "train_s": acts["train_s"], "phase_s": phase_s,
        "device_bytes_growth": acts["growth"],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "kernel_device_ms": {"fused_vtrace": None, "ring_all_reduce": None},
    }
    log(f"train {phase}: " + json.dumps(row))
    return row


def _resume_act(agent, target: int, own_thread: bool) -> dict:
    """Train ``agent`` toward ``target`` env steps, on a daemon thread of its
    own with ``own_thread`` (the drain's coordinator is then not installed,
    so the scripted preempt requests the drain directly) and else here;
    returns the windows with the fleet and the health monitor's window index
    each ran with, what ``train`` raised (None if it returned), the launches
    and the env steps a second."""
    windows = []

    def on_window(window):
        windows.append((window, len(agent._actors), agent._staging.num_slabs,
                        agent._obs.monitor.window_idx))

    out = {"error": None}

    def run():
        try:
            agent.train(total_env_steps=target, callback=on_window)
        # lint: broad-except-ok(handed to the caller, which gates on it)
        except BaseException as e:
            out["error"] = e

    steps_before = agent.env_steps
    reset_counters()
    t0 = time.perf_counter()
    if own_thread:
        thread = threading.Thread(target=run, name="resume-act1", daemon=True)
        thread.start()
        # A guard against a hung drain, not a gate: act 1 takes seconds.
        thread.join(timeout=SUBPROCESS_TIMEOUT_S)
        if thread.is_alive():
            raise AssertionError(f"resume act 1 still training after {SUBPROCESS_TIMEOUT_S} s")
    else:
        run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    return {"windows": windows, "error": out["error"], "launches": counters(),
            "train_s": train_s,
            "env_steps_per_s": (agent.env_steps - steps_before) / max(train_s, 1e-9)}


def resume_phase() -> dict:
    """The crash-consistent resume on the card (see ``RESUME_*``): act 1
    drains on a scripted preempt at a scaled fleet, act 2 resumes it to the
    target. Every gate is a count, an equality or a bit-identity: one
    ``PreemptedExit``; the final checkpoint's ``run_state`` with JAX's keys;
    act 2 built with its update count and act 1's weights (SHA-256); its
    first window at act 1's drain-time fleet (not the configured 4) and
    ring, after one ``durability.fleet_restored`` dump; act 2 past act 1 and
    at the target; one timeseries of two segments, one resume event with
    JAX's keys and one drain flush, env steps monotone, the window index
    going on from the checkpoint's cursor; finite losses; B1 once an update
    in each act and no other kernel."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.obs import flightrec, trace
    from asyncrl_tpu_torch.rollout import staging
    from asyncrl_tpu_torch.runtime.durability import PreemptedExit
    from asyncrl_tpu_torch.utils import faults
    from asyncrl_tpu_torch.utils.checkpoint import Checkpointer

    phase = "resume_sebulba_pong_impala"
    phase_t0 = time.perf_counter()
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    ckpt_dir, run_dir = str(RESUME_DIR / "ckpt"), str(RESUME_DIR / "run")
    overrides = {**HOST_PONG, "host_pool": "native", "log_every": RESUME_LOG_EVERY,
                 "eval_every": 0, "elastic": True, "elastic_max_actors": RESUME_MAX_ACTORS,
                 "elastic_up_stall_frac": 1.0, "elastic_down_backpressure": 0.0,
                 "elastic_down_admission": 0.0, "checkpoint_dir": ckpt_dir,
                 "checkpoint_every": 2, "run_dir": run_dir, "obs_http_port": -1,
                 "health_stall_frac": 1.0, "health_fps_collapse": 0.0, "trace": True}
    cfg = presets.pong_impala.replace(device="cuda", **overrides)
    try:
        torch.cuda.synchronize()
        memory_before = torch.cuda.memory_allocated()
        agent = asyncrl_tpu_torch.make_agent(cfg.replace(fault_spec=RESUME_FAULTS))
        target = RESUME_UPDATES * agent._envs_per_actor * cfg.unroll_len
        try:
            act1 = _resume_act(agent, target, own_thread=True)
            drained = {"fleet": agent._last_live_fleet, "updates": agent._updates,
                       "update_step": agent.state.update_step, "env_steps": agent.env_steps,
                       "params_sha256": params_sha256(agent.state),
                       "launches": act1["launches"]}
            log(f"resume act 1 drained: {json.dumps(drained)}")
        finally:
            agent.close()
            faults.disarm()
        if not isinstance(act1["error"], PreemptedExit):
            raise AssertionError(f"{phase}: act 1 ended with {act1['error']!r}, not one "
                                 "PreemptedExit") from act1["error"]
        with Checkpointer(ckpt_dir, create=False) as ck:
            latest = ck.latest_step()
            run_state = ck.read_meta().get("run_state")
        if (latest != drained["update_step"] or run_state is None
                or sorted(run_state) != RESUME_RUN_STATE_KEYS):
            raise AssertionError(f"{phase}: final checkpoint step {latest} (drained at "
                                 f"{drained['update_step']}), run_state {run_state}")

        t0 = time.perf_counter()
        agent2 = asyncrl_tpu_torch.make_agent(cfg.replace(resume=True))
        construct_ms = 1e3 * (time.perf_counter() - t0)
        try:
            restored = {"updates": agent2._updates, "env_steps": agent2.env_steps,
                        "params_sha256": params_sha256(agent2.state),
                        "resume_fleet": agent2._resume_fleet}
            real_restore_fleet, fleet_ms = agent2._restore_fleet, []

            def timed_restore_fleet():
                t = time.perf_counter()
                real_restore_fleet()
                fleet_ms.append(1e3 * (time.perf_counter() - t))

            agent2._restore_fleet = timed_restore_fleet
            cap = agent2._queue.maxsize
            act2 = _resume_act(agent2, target, own_thread=False)
            verdict = agent2._obs.monitor.verdict()
            final = {"updates": agent2._updates, "env_steps": agent2.env_steps}
        finally:
            agent2.close()
            trace.configure(False)
            flightrec.disarm()
        torch.cuda.synchronize()
        memory_after = torch.cuda.memory_allocated()
        if act2["error"] is not None:
            raise AssertionError(f"{phase}: act 2 raised {act2['error']!r}") from act2["error"]
        if not (restored["updates"] == run_state["updates"] > 0
                and restored["params_sha256"] == drained["params_sha256"]):
            raise AssertionError(f"{phase}: restored {json.dumps(restored)}, run_state "
                                 f"{run_state}, drained {json.dumps(drained)}")
        fleet = run_state["actors_live"]
        _, first_fleet, first_slabs, _ = act2["windows"][0]
        dumps = [json.loads(p.read_text())["reason"]
                 for p in Path(run_dir).glob("flightrec-*.json")]
        if (fleet != drained["fleet"] or fleet == cfg.actor_threads
                or first_fleet != fleet or first_slabs != staging.auto_num_slabs(cap, fleet, 1)
                or dumps.count("durability.fleet_restored") != 1):
            raise AssertionError(
                f"{phase}: run_state fleet {fleet}, drained at {drained['fleet']}, act 2's "
                f"first window at {first_fleet} actors and {first_slabs} slabs; dumps {dumps}")
        if not (final["updates"] > drained["updates"] and final["env_steps"] >= target):
            raise AssertionError(f"{phase}: act 2 ended at {json.dumps(final)}, act 1 drained "
                                 f"at {drained['updates']} updates, target {target}")
        metas, events, samples = 0, [], []
        with open(Path(run_dir) / "timeseries.jsonl") as f:
            for line in f:
                doc = json.loads(line)
                if doc.get("kind") == "meta":
                    metas += 1
                elif doc.get("kind") == "sample":
                    samples.append(doc["window"])
                elif doc.get("kind") == "event" and doc["event"].get("event_type") == "resume":
                    events.append(doc["event"])
        env_series = [w.get("env_steps", 0.0) for w in samples]
        flushes = sum(1 for w in samples if w.get("drain_preempt"))
        index1 = [w[3] for w in act1["windows"]]
        index2 = [w[3] for w in act2["windows"]]
        cursor = run_state["window_idx"]
        if (metas != 2 or len(events) != 1 or sorted(events[0]) != RESUME_EVENT_KEYS
                or flushes != 1 or env_series != sorted(env_series)
                or index1 != list(range(1, len(index1) + 1))
                or not 1 <= cursor <= index1[-1] <= cursor + 2
                or index2 != list(range(cursor + 1, cursor + 1 + len(index2)))):
            raise AssertionError(
                f"{phase}: timeseries metas {metas}, resume events {events}, drain flushes "
                f"{flushes}, env steps {env_series}; window index act 1 {index1}, checkpoint "
                f"{cursor}, act 2 {index2}")
        losses = [w["loss"] for w, *_ in act1["windows"] + act2["windows"] if "loss" in w]
        if not losses or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{phase}: losses {losses}")
        for name, act, updates in (("act 1", act1, drained["updates"]),
                                   ("act 2", act2, final["updates"] - restored["updates"])):
            expected = {k: updates * (k == "fused_vtrace") for k in KERNELS}
            if act["launches"] != expected:
                raise AssertionError(f"{phase}: {name} launched {act['launches']} in "
                                     f"{updates} updates, expected {expected}")
    finally:
        shutil.rmtree(RESUME_DIR, ignore_errors=True)
    # Printed, not gated: the budget is RESUME_PHASE_S.
    phase_s = time.perf_counter() - phase_t0
    launches = {k: act1["launches"][k] + act2["launches"][k] for k in KERNELS}
    row = {
        "phase": phase, "preset": "pong_impala",
        "overrides": {**overrides, "checkpoint_dir": "<RESUME_DIR>/ckpt",
                      "run_dir": "<RESUME_DIR>/run", "fault_spec (act 1)": RESUME_FAULTS,
                      "resume (act 2)": True},
        "ranks": 1, "target_updates": RESUME_UPDATES,
        "launches_per_update": {"fused_vtrace": 1}, "launches": launches,
        "launches_by_act": [act1["launches"], act2["launches"]],
        "drained": drained, "run_state": run_state,
        "final_save_fresh": cursor == index1[-1],
        "act1_fleet_by_window": [w[1] for w in act1["windows"]],
        "act2_fleet_by_window": [w[1] for w in act2["windows"]],
        "window_index_act1": index1, "window_index_act2": index2,
        "updates_final": final["updates"], "env_steps_final": final["env_steps"],
        "loss_last": losses[-1],
        "env_steps_per_s_act1": act1["env_steps_per_s"],
        "env_steps_per_s_act2": act2["env_steps_per_s"],
        "train_s": [act1["train_s"], act2["train_s"]],
        "resume_construct_ms": construct_ms, "restore_fleet_ms": fleet_ms[0],
        "device_bytes_before": memory_before, "device_bytes_after": memory_after,
        "health_verdict": verdict, "phase_s": phase_s, "phase_budget_s": RESUME_PHASE_S,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "kernel_device_ms": {"fused_vtrace": None, "ring_all_reduce": None},
    }
    log(f"train {phase}: " + json.dumps(row, default=str))
    return row


def _guard_check(agent, frag) -> dict:
    """The NaN guard on the card, from the phase's final state, on one clean
    drained fragment ``frag`` and a copy with ``rewards[0, 0] = NaN``:
    armed on the copy, the state's digest and both counters are unchanged,
    ``nonfinite_skip`` is 1 and B1 launches once; armed on ``frag``, the
    weights are the unarmed update's from the same state, bit for bit. The
    ms per update of each, on ``frag``, printed."""
    from asyncrl_tpu_torch.learn.rollout_learner import RolloutLearner
    from asyncrl_tpu_torch.rollout.buffer import rollout_map
    from asyncrl_tpu_torch.utils.checkpoint import content_digest, state_dict

    armed = agent.learner
    off = RolloutLearner(armed.config.replace(rollback_bad_windows=0), agent.spec, agent.model)
    if not armed.nan_guard or off.nan_guard:
        raise AssertionError("rollback: the guard is not armed in the trainer's learner")
    poisoned = rollout_map(torch.clone, frag)
    poisoned.rewards[0, 0] = float("nan")
    if not bool(torch.isfinite(frag.rewards).all()):
        raise AssertionError("rollback: the captured fragment is not finite")
    state = clone_learner_state(agent.state)
    before = (content_digest(state_dict(state)), state.update_step, state.opt_state.count)
    reset_counters()
    state, metrics = armed.update(state, poisoned)
    torch.cuda.synchronize()
    after = (content_digest(state_dict(state)), state.update_step, state.opt_state.count)
    skip = float(metrics["nonfinite_skip"])
    nan_launches = counters()
    if (after != before or skip != 1.0
            or nan_launches != {k: int(k == "fused_vtrace") for k in KERNELS}):
        raise AssertionError(f"rollback guard on the poisoned copy: state {before} -> {after}, "
                             f"nonfinite_skip {skip}, launches {nan_launches}")
    armed_state, m_armed = armed.update(clone_learner_state(agent.state), frag)
    off_state, m_off = off.update(clone_learner_state(agent.state), frag)
    torch.cuda.synchronize()
    armed_sha, off_sha = params_sha256(armed_state), params_sha256(off_state)
    if (armed_sha != off_sha or float(m_armed["nonfinite_skip"]) != 0.0
            or "nonfinite_skip" in m_off or armed_sha == params_sha256(agent.state)):
        raise AssertionError(f"rollback guard on the clean fragment: armed {armed_sha}, off "
                             f"{off_sha}, metrics {sorted(m_armed)} / {sorted(m_off)}")
    ms = {}
    for name, learner, st in (("armed", armed, armed_state), ("off", off, off_state)):
        ms[name] = time_ms(lambda learner=learner, st=st: learner.update(st, frag),
                           reps=ROLLBACK_TIMED, trials=3)
    return {"poisoned_state_sha256_unchanged": True, "nonfinite_skip": skip,
            "poisoned_launches": nan_launches, "clean_weights_sha256_equal_unarmed": True,
            "ms_per_update_armed": ms["armed"], "ms_per_update_off": ms["off"],
            "guard_ms_per_update": ms["armed"] - ms["off"]}


def rollback_phase() -> dict:
    """The divergence rollback on the card (see ``ROLLBACK_*``). Gates: at
    least one quarantine and one restore and no abort; the last window's
    ``nonfinite_skips`` above 0 and its loss finite; the weights right after
    each restore those of the retained step it targeted (SHA-256), no step
    newer than it left on disk; the final checkpoint's ``rollback_attempts``
    the policy's; one ``rollback`` event with JAX's keys an action and a
    ``rollback.rollback`` dump (the recorder debounces a reason); the health
    verdict ok; B1 once an
    update, skipped ones included, and no other kernel; device memory grown
    by less than ``ROLLBACK_BYTES``; the phase within ``ROLLBACK_PHASE_S``;
    and ``_guard_check``."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.obs import flightrec, trace
    from asyncrl_tpu_torch.obs import registry as obs_registry
    from asyncrl_tpu_torch.rollout.buffer import rollout_map
    from asyncrl_tpu_torch.utils import faults
    from asyncrl_tpu_torch.utils.checkpoint import STATE_FILE, Checkpointer, _step_dir

    phase = "rollback_sebulba_pong_impala"
    phase_t0 = time.perf_counter()
    shutil.rmtree(ROLLBACK_DIR, ignore_errors=True)
    ckpt_dir, run_dir = str(ROLLBACK_DIR / "ckpt"), str(ROLLBACK_DIR / "run")
    overrides = {**HOST_PONG, "host_pool": "native", "log_every": ROLLBACK_LOG_EVERY,
                 "eval_every": 0, "checkpoint_dir": ckpt_dir, "checkpoint_every": 2,
                 "rollback_bad_windows": 2, "rollback_max_attempts": 3, "run_dir": run_dir,
                 "obs_http_port": -1, "health_stall_frac": 1.0, "health_fps_collapse": 0.0,
                 "trace": True, "fault_spec": ROLLBACK_FAULTS}
    cfg = presets.pong_impala.replace(device="cuda", **overrides)
    try:
        torch.cuda.synchronize()
        memory_before = torch.cuda.memory_allocated()
        agent = asyncrl_tpu_torch.make_agent(cfg)
        try:
            target = ROLLBACK_UPDATES * agent._envs_per_actor * cfg.unroll_len
            windows, restores, first = [], [], {}
            learner_update = agent.learner.update

            def update(state, rollout, perms=None):
                # The first drained fragment, put by an actor before the
                # burst (the queue is first in, first out).
                if not first:
                    first["rollout"] = rollout_map(torch.clone, rollout)
                return learner_update(state, rollout, perms)

            execute = agent._execute_rollback
            ckpt = agent._ckpt.checkpointer

            def timed_rollback(action):
                ckpt.wait()
                steps = sorted(ckpt.all_steps())
                # The step the trainer targets: the newest at or before the
                # last good one, else the oldest retained.
                good = agent._rollback.last_good_step
                kept = [s for s in steps if good is not None and s <= good]
                aim = kept[-1] if kept else (steps[0] if steps else None)
                t = time.perf_counter()
                execute(action)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t)
                left = sorted(ckpt.all_steps())
                row = {"window": len(windows), "steps_before": steps, "last_good": good,
                       "target": aim, "steps_after": left, "restore_ms": ms,
                       "update_step": agent.state.update_step, "updates": agent._updates}
                if aim is not None:
                    flat = torch.load(os.path.join(_step_dir(ckpt_dir, aim), STATE_FILE),
                                      weights_only=True)
                    row["sha256_equal"] = (_flat_params_sha256(flat)
                                           == params_sha256(agent.state))
                restores.append(row)

            agent.learner.update = update
            agent._execute_rollback = timed_rollback
            reset_counters()
            t0 = time.perf_counter()
            agent.train(total_env_steps=target, callback=windows.append)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches = counters()
            updates = agent._updates
            counts = {k: obs_registry.counter(k).value() for k in (
                "rollback_quarantine", "rollback_restores", "rollback_abort",
                "rollback_quarantined")}
            attempts = agent._rollback.attempts
            verdict = agent._obs.monitor.verdict()
            agent.learner.update = learner_update
            guard = _guard_check(agent, first["rollout"])
        finally:
            agent.close()
            faults.disarm()
            trace.configure(False)
            flightrec.disarm()
        torch.cuda.synchronize()
        memory_after = torch.cuda.memory_allocated()
        with Checkpointer(ckpt_dir, create=False) as ck:
            run_state = ck.read_meta().get("run_state") or {}
        last = windows[-1]
        if not (counts["rollback_quarantine"] >= 1 and counts["rollback_restores"] >= 1
                and counts["rollback_abort"] == 0 and len(restores) == counts["rollback_restores"]
                and last.get("nonfinite_skips", 0) > 0 and math.isfinite(last["loss"])):
            raise AssertionError(f"{phase}: counters {counts}, restores {restores}, last window "
                                 f"nonfinite_skips {last.get('nonfinite_skips')} loss "
                                 f"{last['loss']}")
        for row in restores:
            if (row["target"] is None or not row.get("sha256_equal")
                    or row["update_step"] != row["target"]
                    or any(s > row["target"] for s in row["steps_after"])):
                raise AssertionError(f"{phase}: restore {row}")
        if run_state.get("rollback_attempts") != attempts or attempts != len(restores):
            raise AssertionError(f"{phase}: final run_state {run_state}, policy attempts "
                                 f"{attempts}, restores {len(restores)}")
        events = []
        with open(Path(run_dir) / "timeseries.jsonl") as f:
            for line in f:
                doc = json.loads(line)
                if doc.get("kind") == "event" and doc["event"].get("event_type") == "rollback":
                    events.append(doc["event"])
        dumps = [json.loads(p.read_text())["reason"]
                 for p in Path(run_dir).glob("flightrec-*.json")]
        actions = [e["action"] for e in events]
        if (any(sorted(e) != ROLLBACK_EVENT_KEYS for e in events)
                or actions.count("rollback") != len(restores)
                or actions.count("quarantine") != counts["rollback_quarantine"]
                or not 1 <= dumps.count("rollback.rollback") <= len(restores)):
            raise AssertionError(f"{phase}: events {events}, dumps {dumps}")
        if verdict.get("status") != "ok":
            raise AssertionError(f"{phase}: health verdict {verdict}")
        expected = {k: updates * (k == "fused_vtrace") for k in KERNELS}
        if launches != expected:
            raise AssertionError(f"{phase}: launched {launches} in {updates} updates, "
                                 f"expected {expected}")
        if memory_after - memory_before >= ROLLBACK_BYTES:
            raise AssertionError(f"{phase}: device memory grew {memory_after - memory_before} "
                                 f"bytes, bound {ROLLBACK_BYTES}")
    finally:
        shutil.rmtree(ROLLBACK_DIR, ignore_errors=True)
        try:
            ROLLBACK_DIR.parent.rmdir()  # CKPT_DIR, unless another phase's files are in it
        except OSError:
            pass
    phase_s = time.perf_counter() - phase_t0
    if phase_s >= ROLLBACK_PHASE_S:
        raise AssertionError(f"{phase}: {phase_s:.1f} s, budget {ROLLBACK_PHASE_S} s")
    restore_at = restores[0]["window"]
    fps = [w["fps"] for w in windows]
    row = {
        "phase": phase, "preset": "pong_impala",
        "overrides": {**overrides, "checkpoint_dir": "<ROLLBACK_DIR>/ckpt",
                      "run_dir": "<ROLLBACK_DIR>/run"},
        "ranks": 1, "target_updates": ROLLBACK_UPDATES,
        "launches_per_update": {"fused_vtrace": 1}, "launches": launches, "updates": updates,
        "counters": counts, "attempts": attempts, "restores": restores,
        "run_state": run_state, "events": actions, "flightrec_reasons": sorted(set(dumps)),
        "nonfinite_skips_by_window": [w.get("nonfinite_skips") for w in windows],
        "loss_by_window": [w["loss"] for w in windows],
        "loss_last": last["loss"], "guard": guard,
        "env_steps_per_s_before_restore": statistics.mean(fps[:restore_at]) if restore_at
        else None,
        "env_steps_per_s_after_restore": statistics.mean(fps[restore_at:]),
        "train_s": train_s, "device_bytes_before": memory_before,
        "device_bytes_after": memory_after, "health_verdict": verdict, "phase_s": phase_s,
        "phase_budget_s": ROLLBACK_PHASE_S,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "kernel_device_ms": {"fused_vtrace": None, "ring_all_reduce": None},
    }
    log(f"train {phase}: " + json.dumps(row, default=str))
    return row


def mujoco_presets_line() -> None:
    """The MuJoCo presets run through gymnasium, which this script does not
    drive: the line says why they were skipped, and no number."""
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.envs import gym_adapter

    line = {}
    for name in ("mujoco_ant_ppo", "mujoco_humanoid_ppo"):
        env_id = getattr(presets, name).env_id
        line[name] = ("skipped: " + (
            "gymnasium is not installed on this machine" if gym_adapter._gymnasium() is None
            else f"gymnasium has no {env_id} here (MuJoCo missing)"
            if not gym_adapter.available(env_id)
            else "gymnasium pools are held on the CPU (tests/test_torch_faults.py), "
                 "not timed by this script"))
    log("mujoco presets: " + json.dumps(line))


def host_update_profile(phase: str, agent, learner_update, frag, update_s: float):
    """One more host-path update on ``frag`` with the actors stopped, timed
    (its own host time, to set against the window's ``update_s``: the actor
    threads share the GIL), then one under the profiler: the device's busy
    time, its idle share of ``update_s`` and each kernel's times. Returns
    the profile line and the kernel times by wrapper counter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    agent.state, _ = learner_update(agent.state, frag)
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        agent.state, _ = learner_update(agent.state, frag)
        torch.cuda.synchronize()
    busy_ms, kernel_launches = 0.0, 0
    kernel_ms = {"fused_vtrace": [], "ring_all_reduce": []}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy_ms += e.duration_ns() / 1e6
            kernel_launches += 1
            for name, times in kernel_ms.items():
                if PROFILE_KEYS[name] in e.name():
                    times.append(e.duration_ns() / 1e6)
    profile_row = {
        "device_busy_ms": busy_ms, "update_ms_unprofiled": update_s * 1e3,
        "update_ms_without_actors": alone_s * 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (update_s * 1e3)),
        "kernel_launches": kernel_launches,
        **{f"{name}_in_profile": len(times) for name, times in kernel_ms.items()},
    }
    log(f"profile {phase}: " + json.dumps(profile_row))
    return profile_row, kernel_ms


def cpu_async_phase() -> dict:
    """``cartpole_a3c_cpu`` as the preset has it, on one torch thread (its
    4 actor threads and the learner share the GIL; more intra-op threads
    only add contention), for its 200,000 steps: no CUDA kernel is launched
    (the launch counters stay 0) and no device memory is taken; then the
    16-episode greedy eval at ``max_steps=500`` must be above
    ``CPU_ASYNC_BAR``. The rate is a CPU rate."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets

    torch.set_num_threads(1)
    phase_t0 = time.perf_counter()
    cfg = presets.cartpole_a3c_cpu
    memory_before = torch.cuda.max_memory_allocated()
    reset_counters()
    agent = asyncrl_tpu_torch.make_agent(cfg)
    try:
        history = agent.train()
        launches = counters()
        memory_after = torch.cuda.max_memory_allocated()
        if any(launches.values()) or memory_after != memory_before:
            raise AssertionError(f"cpu_async: launched {launches}, device memory "
                                 f"{memory_before} -> {memory_after}")
        eval_return = agent.evaluate(num_episodes=CPU_ASYNC_EVAL_EPISODES, max_steps=500)
    finally:
        agent.close()
    seconds = time.perf_counter() - phase_t0
    row = {
        "phase": "cpu_async_cartpole_a3c", "preset": "cartpole_a3c_cpu",
        "backend": cfg.backend, "device": agent.device.type, "num_envs": cfg.num_envs,
        "actor_threads": cfg.actor_threads, "unroll_len": cfg.unroll_len,
        "env_steps": agent.env_steps, "updates": agent.state.update_step,
        "cpu_env_steps_per_s_last_window": history[-1]["fps"],
        "cpu_env_steps_per_s_whole_run": agent.env_steps / seconds,
        "learner_stall_frac": history[-1]["learner_stall_frac"],
        "param_lag": history[-1]["param_lag"], "launches": launches,
        "cuda_max_memory_allocated_before_after": [memory_before, memory_after],
        "eval_return": eval_return, "eval_episodes": CPU_ASYNC_EVAL_EPISODES,
        "bar": CPU_ASYNC_BAR, "bar_rule": "above 60, the JAX package's test's",
        "seconds": seconds,
    }
    log("train cpu_async_cartpole_a3c: " + json.dumps(row))
    if not eval_return > CPU_ASYNC_BAR:
        raise AssertionError(f"cpu_async: eval return {eval_return}, not above {CPU_ASYNC_BAR}")
    return row


def _run_subprocesses(cmds: list[list[str]], what: str) -> list[tuple[str, str]]:
    """Run ``cmds`` at once from the repository's root; returns each one's
    (stdout, stderr). Every process is killed if any has not exited within
    ``SUBPROCESS_TIMEOUT_S``; a non-zero exit fails the phase."""
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in cmds]
    try:
        outs = [p.communicate(timeout=SUBPROCESS_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{what}: process {i} exited {p.returncode}:\n{err[-3000:]}")
    return outs


def _trace_launches(trace_dir: Path) -> dict[str, int]:
    """Each kernel's launches in the ``torch.profiler`` trace under
    ``trace_dir``, by its device kernel's name."""
    traces = sorted(trace_dir.glob("*.json"))
    if len(traces) != 1:
        raise AssertionError(f"expected one profiler trace under {trace_dir}, got {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError(f"the trace {traces[0]} holds no device kernel")
    return {k: sum(key in name for name in kernels) for k, key in PROFILE_KEYS.items()}


def cli_train_phase(workdir: Path) -> dict:
    """``python -m asyncrl_tpu_torch.cli.train pong_impala`` for
    ``CLI_UPDATES`` updates on the card, as a user runs it, with
    ``--eval-episodes 4 --json --jsonl`` and ``--profile``: it must exit 0,
    every line of its output and of its JSONL file must parse, and its trace
    must show B1 once an update and no other kernel."""
    from asyncrl_tpu_torch.configs import presets

    t = time.perf_counter()
    steps = CLI_UPDATES * presets.pong_impala.batch_steps_per_update
    jsonl, trace = workdir / "cli_train.jsonl", workdir / "cli_train_trace"
    cmd = [sys.executable, "-m", "asyncrl_tpu_torch.cli.train", "pong_impala", "device=cuda",
           "log_every=1", "--steps", str(steps), "--eval-episodes", "4", "--json",
           "--jsonl", str(jsonl), "--profile", str(trace)]
    ((out, _),) = _run_subprocesses([cmd], "cli_train")
    lines = [json.loads(line) for line in out.splitlines()]
    windows, last = lines[:-1], lines[-1]
    if [json.loads(line) for line in jsonl.read_text().splitlines()] != windows:
        raise AssertionError("cli_train: the JSONL file differs from the printed windows")
    if len(windows) != CLI_UPDATES or windows[-1]["env_steps"] != steps:
        raise AssertionError(f"cli_train: windows {[w['env_steps'] for w in windows]}")
    bad = [k for w in windows for k, v in w.items() if not math.isfinite(v)]
    if bad or last.get("eval_episodes") != 4 or not math.isfinite(last["mean_return"]):
        raise AssertionError(f"cli_train: non-finite {bad}, eval line {last}")
    launches = _trace_launches(trace)
    expected = {k: CLI_UPDATES * (k == "fused_vtrace") for k in KERNELS}
    if launches != expected:
        raise AssertionError(f"cli_train: the trace shows {launches}, expected {expected}")
    row = {
        "phase": "cli_train", "preset": "pong_impala", "command": cmd[1:11],
        "updates": CLI_UPDATES, "launches_per_update": {"fused_vtrace": 1},
        "launches": launches, "launches_from": "the run's torch.profiler trace",
        "windows": len(windows), "env_steps_per_s": windows[-1]["fps"],
        "loss": windows[-1]["loss"], "eval_mean_return": last["mean_return"],
        "device": "cuda", "lines_parse": True, "wall_s": time.perf_counter() - t,
    }
    log("train cli_train: " + json.dumps(row))
    return row


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_phase() -> dict:
    """Two processes of ``cli.launch pong_impala --backend gloo`` on the
    one card for ``LAUNCH_UPDATES`` updates, each stepping its 128 envs,
    against the one-process ``(dcn=2, dp=1)`` mesh (2 ranks sharing the
    card) from the same seed: the same weights bit for bit (the SHA-256 the
    lead prints) and the same windows; each process launches B1 once an
    update and B4 never. NCCL goes unmeasured: the machine has one card."""
    from asyncrl_tpu_torch.api.trainer import Trainer
    from asyncrl_tpu_torch.cli.launch import params_digest
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.parallel.mesh import make_mesh

    phase = "launch_pong_impala_2proc"
    t = time.perf_counter()
    cfg = presets.pong_impala.replace(device="cuda", log_every=1)
    steps = LAUNCH_UPDATES * cfg.batch_steps_per_update
    port = _free_port()
    cmds = [[sys.executable, "-c", LAUNCH_WRAPPER, "pong_impala", "device=cuda", "log_every=1",
             "--backend", "gloo", "--num-processes", "2", "--process-id", str(pid),
             "--coordinator", f"127.0.0.1:{port}", "--steps", str(steps)] for pid in (0, 1)]
    outs = _run_subprocesses(cmds, phase)
    lines = [json.loads(line) for line in outs[0][0].splitlines()]
    header, windows, final = lines[0], lines[1:-1], lines[-1]
    if outs[1][0].strip():
        raise AssertionError(f"{phase}: process 1 reported: {outs[1][0][:500]}")
    if header["mesh"] != {"dcn": 2, "dp": 1} or len(windows) != LAUNCH_UPDATES:
        raise AssertionError(f"{phase}: header {header}, {len(windows)} windows")
    per_process = [json.loads(next(line for line in err.splitlines()[::-1]
                                    if line.startswith("launches "))[len("launches "):])
                   for _, err in outs]
    expected = {k: LAUNCH_UPDATES * (k == "fused_vtrace") for k in KERNELS}
    if any(launches != expected for launches in per_process):
        raise AssertionError(f"{phase}: processes launched {per_process}, each expected {expected}")
    launch_s = time.perf_counter() - t

    one = Trainer(cfg, mesh=make_mesh((2, 1), ("dcn", "dp"), devices=[torch.device("cuda")] * 2))
    reset_counters()
    history = one.train(total_env_steps=steps)
    torch.cuda.synchronize()
    one_launches = counters()
    digest = params_digest(one.state.params)
    if final["params_sha256"] != digest:
        raise AssertionError(f"{phase}: the weights differ from the one-process mesh's")
    keys = ("loss", "grad_norm", "entropy", "episode_count", "episode_return", "env_steps")
    differ = [(i, k) for i, (w, r) in enumerate(zip(windows, history)) for k in keys
              if w[k] != float(r[k])]
    if differ:
        raise AssertionError(f"{phase}: windows differ from the one-process mesh's at {differ}")
    draws = full_batch_draws_cost(one, processes=2)
    row = {
        "phase": phase, "preset": "pong_impala", "processes": 2, "backend": "gloo",
        "mesh": header["mesh"], "updates": LAUNCH_UPDATES,
        "launches_per_update": {"fused_vtrace": 1}, "launches_by_process": per_process,
        "launches": {k: sum(p[k] for p in per_process) for k in KERNELS},
        "one_process_mesh_launches": one_launches,
        "params_bit_identical_to_one_process_mesh": True, "windows_equal": True,
        "params_sha256": digest, "env_steps_per_s": windows[-1]["fps"],
        "one_process_env_steps_per_s": history[-1]["fps"], "loss": windows[-1]["loss"],
        "full_batch_draws": draws, "nccl": "not measured: one card", "launch_wall_s": launch_s,
        "wall_s": time.perf_counter() - t,
    }
    log(f"train {phase}: " + json.dumps(row))
    return row


def _exact_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x_t = b_t + a_t x_{t+1}, x_T = 0, walked in float64."""
    x, out = torch.zeros_like(b[0]), torch.empty_like(b)
    for t in range(b.shape[0] - 1, -1, -1):
        x = b[t] + a[t] * x
        out[t] = x
    return out


def full_batch_draws_cost(agent, processes: int) -> dict:
    """What a process of a run across ``processes`` pays for drawing the
    whole batch's random values and keeping its rows: one rollout step's
    env draws and action noise through ``ProcessRows`` and
    ``ProcessRowsDist`` against drawing its own rows only, times the
    update's T steps."""
    from asyncrl_tpu_torch.parallel.distributed import ProcessRows, ProcessRowsDist

    cfg, env, dist = agent.config, agent.env, agent.learner.dist
    B, local = cfg.num_envs, cfg.num_envs // processes
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = torch.zeros(local, env.spec.num_actions, device="cuda")
    rows_env = ProcessRows(env, B, 0, local)
    rows_dist = ProcessRowsDist(dist, B, 0, local)
    sliced_ms = time_ms(lambda: (rows_env.draw(local, gen, "cuda"), rows_dist.noise(params, gen)))
    own_ms = time_ms(lambda: (env.draw(local, gen, "cuda"), dist.noise(params, gen)))
    return {"step_ms_whole_batch_sliced": sliced_ms, "step_ms_own_rows": own_ms,
            "extra_ms_per_update": (sliced_ms - own_ms) * cfg.unroll_len}


def timeshard_check() -> dict:
    """``vtrace_timesharded``, ``gae_timesharded`` and
    ``n_step_returns_timesharded`` over ``TIMESHARD_SHARDS`` sp shards at
    ``TIMESHARD_SHAPE`` on the card, on the JAX test's inputs
    (tests/test_timeshard.py), against the unsharded port functions (V-trace
    through B1, as a user calls it) and the float64 solution of the same
    inputs, both timed. The count of elements outside ``TIMESHARD_TOL`` of
    the unsharded function is printed; the gate: the sharded result is
    within ``TIMESHARD_TOL`` of the unsharded one everywhere, or no farther
    from the float64 solution than twice the unsharded function is (at
    262,144 elements neither float32 solve keeps to ``TIMESHARD_TOL`` of
    the float64 one where a return crosses zero: both round partial sums a
    few times larger than the result)."""
    from asyncrl_tpu_torch.ops.gae import gae, n_step_returns
    from asyncrl_tpu_torch.ops.vtrace import vtrace
    from asyncrl_tpu_torch.parallel import timeshard as tts

    T, B = TIMESHARD_SHAPE
    n = TIMESHARD_SHARDS
    g = torch.Generator(device="cuda").manual_seed(11)

    def normal():
        return torch.randn(T, B, generator=g, device="cuda")

    # The JAX test's recipe: V-trace's discounts 0.99 with 10% episode
    # ends and a bootstrap of 0.3; GAE's 0.97 with 5% ends, -0.2, lambda 0.9.
    bl, tl = normal() * 0.1 - 1.0, normal() * 0.1 - 1.0
    r, v = normal(), normal()
    d = 0.99 * (torch.rand(T, B, generator=g, device="cuda") > 0.1).float()
    d_gae = 0.97 * (torch.rand(T, B, generator=g, device="cuda") > 0.05).float()
    boot = torch.full((B,), 0.3, device="cuda")
    lam = 0.9
    S = functools.partial(tts.split_time, n=n)

    # The float64 solutions of the same float32 inputs.
    f64 = [x.double() for x in (bl, tl, r, v, d, d_gae, boot)]
    bl64, tl64, r64, v64, d64, dg64, boot64 = f64
    rho = torch.exp(tl64 - bl64).clamp(max=1.0)
    v_tp1 = torch.cat([v64[1:], boot64[None]])
    vs64 = _exact_scan(d64 * rho, rho * (r64 + d64 * v_tp1 - v64)) + v64
    pg64 = rho * (r64 + d64 * torch.cat([vs64[1:], boot64[None]]) - v64)
    adv64 = _exact_scan(dg64 * lam, r64 + dg64 * torch.cat([v64[1:], -boot64[None]]) - v64)
    r_ext = r64.clone()
    r_ext[-1] += d64[-1] * boot64
    ret64 = _exact_scan(d64, r_ext)

    pairs = {
        "vtrace_vs": (lambda: torch.cat([o.vs for o in tts.vtrace_timesharded(
                          S(bl), S(tl), S(r), S(d), S(v), boot)]),
                      lambda: vtrace(bl, tl, r, d, v, boot).vs, vs64),
        "vtrace_pg": (lambda: torch.cat([o.pg_advantages for o in tts.vtrace_timesharded(
                          S(bl), S(tl), S(r), S(d), S(v), boot)]),
                      lambda: vtrace(bl, tl, r, d, v, boot).pg_advantages, pg64),
        "gae": (lambda: torch.cat([o.advantages for o in tts.gae_timesharded(
                    S(r), S(d_gae), S(v), -boot, gae_lambda=lam)]),
                lambda: gae(r, d_gae, v, -boot, gae_lambda=lam).advantages, adv64),
        "n_step_returns": (lambda: torch.cat(tts.n_step_returns_timesharded(S(r), S(d), boot)),
                           lambda: n_step_returns(r, d, boot), ret64),
    }
    rows = {}
    for name, (sharded, whole, exact) in pairs.items():
        got, want = sharded(), whole()
        torch.cuda.synchronize()
        within = (got - want).abs() <= TIMESHARD_TOL["atol"] + TIMESHARD_TOL["rtol"] * want.abs()
        err_exact = float((got.double() - exact).abs().max())
        want_err_exact = float((want.double() - exact).abs().max())
        if not (bool(within.all()) or err_exact <= 2 * want_err_exact):
            raise AssertionError(
                f"timeshard {name}: {int((~within).sum())} elements outside {TIMESHARD_TOL} of "
                f"the unsharded function, and {err_exact} from the float64 solution against its "
                f"{want_err_exact}")
        rows[name] = {"max_abs_err": float((got - want).abs().max()),
                      "outside_jax_bound": int((~within).sum()),
                      "max_abs_err_vs_float64": err_exact,
                      "unsharded_max_abs_err_vs_float64": want_err_exact,
                      "sharded_ms": time_ms(sharded, reps=5, trials=3),
                      "unsharded_ms": time_ms(whole, reps=5, trials=3)}
    row = {"T": T, "B": B, "sp_shards": n, "tolerance": TIMESHARD_TOL,
           "elements": T * B, **rows}
    log("timeshard: " + json.dumps(row))
    return row


def locomotion_learning_line() -> dict:
    """The JAX package's HalfCheetah learning test on the card
    (``LOCOMOTION_LINE``): the last window's training return must exceed
    the first's by 100 and exceed 100."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.config import Config

    t = time.perf_counter()
    agent = asyncrl_tpu_torch.make_agent(Config(**LOCOMOTION_LINE), device="cuda")
    history = agent.train()
    rets = [h["episode_return"] for h in history]
    row = {
        "config": LOCOMOTION_LINE, "seed": 0, "window_returns": rets,
        "first": rets[0], "last": rets[-1],
        "bar": "last > first + 100 and last > 100, the JAX test's",
        "jax_window_returns": list(JAX_HALFCHEETAH_WINDOWS),
        "seconds": time.perf_counter() - t,
    }
    log("learning halfcheetah_ppo: " + json.dumps(row))
    if not (rets[-1] > rets[0] + 100 and rets[-1] > 100):
        raise AssertionError(f"halfcheetah_ppo learned {rets[0]} -> {rets[-1]}, under its bar")
    return row


def breakout_learning_line() -> dict:
    """The JAX package's Breakout learning test on the card at each of
    ``LEARNING_SEEDS``: the mean over the seeds of the last three windows'
    training return must exceed the first windows' by half the JAX
    package's rise; the greedy eval's rise (the JAX test's own criterion,
    ``BREAKOUT_EVAL_RISE``) is printed beside it."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets

    before, after, firsts, lasts, seconds = [], [], [], [], []
    for seed in LEARNING_SEEDS:
        t = time.perf_counter()
        agent = asyncrl_tpu_torch.make_agent(presets.breakout_impala, device="cuda", seed=seed,
                                             **BREAKOUT_LINE)
        before.append(agent.evaluate(num_episodes=32, max_steps=BREAKOUT_EVAL_MAX_STEPS))
        history = agent.train(total_env_steps=BREAKOUT_LINE_STEPS)
        after.append(agent.evaluate(num_episodes=32, max_steps=BREAKOUT_EVAL_MAX_STEPS))
        firsts.append(history[0]["episode_return"])
        lasts.append(statistics.mean(h["episode_return"] for h in history[-3:]))
        seconds.append(time.perf_counter() - t)
    rise = statistics.mean(lasts) - statistics.mean(firsts)
    jax_rise = (statistics.mean(w[1] for w in JAX_BREAKOUT_WINDOWS)
                - statistics.mean(w[0] for w in JAX_BREAKOUT_WINDOWS))
    bar = jax_rise / 2
    eval_rise = statistics.mean(after) - statistics.mean(before)
    row = {
        "preset": "breakout_impala", "overrides": BREAKOUT_LINE, "env_steps": BREAKOUT_LINE_STEPS,
        "seeds": list(LEARNING_SEEDS), "first_window_returns": firsts,
        "last3_window_returns": lasts, "training_return_rise": rise, "bar": bar,
        "bar_rule": "mean last-3 minus mean first window > half the JAX package's",
        "jax_first_and_last3": [list(w) for w in JAX_BREAKOUT_WINDOWS], "jax_rise": jax_rise,
        "eval_before": before, "eval_after": after, "eval_mean_rise": eval_rise,
        f"eval_mean_rise_above_{BREAKOUT_EVAL_RISE}": eval_rise > BREAKOUT_EVAL_RISE,
        "jax_eval_before": list(JAX_BREAKOUT_EVALS[0]), "jax_eval_after": list(JAX_BREAKOUT_EVALS[1]),
        "seconds": seconds,
    }
    log("learning breakout_impala: " + json.dumps(row))
    if not rise > bar:
        raise AssertionError(f"breakout_impala's training return rose by {rise}, not above {bar}")
    return row


def learning_worker(queue, names: tuple[str, ...]) -> None:
    """Run in a spawned process beside the main one: the learning lines
    ``names`` (keys of ``WORKER_LINES``' functions), on the same card (each
    process leaves it idle most of the time, bound by its own host thread's
    issue rate). Their rows, or the failure, go to ``queue``."""
    set_precision()
    lines = {"cartpole_impala_lstm": recurrent_learning_line,
             "halfcheetah_ppo": locomotion_learning_line,
             "breakout_impala": breakout_learning_line,
             "cpu_async_cartpole_a3c": cpu_async_phase,
             **{f"pendulum_native_ppo_seed{seed}": functools.partial(
                 learning_evals, "pendulum_native_ppo", PENDULUM_NATIVE_STEPS, (seed,))
                for seed in LEARNING_SEEDS}}
    try:
        queue.put(("ok", {name: lines[name]() for name in names}))
    # lint: broad-except-ok(the worker's boundary: any failure is handed to the parent, which fails the run)
    except Exception as e:
        import traceback

        queue.put(("error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


class Workers:
    """Spawned :func:`learning_worker` processes, one a group of names, from
    ``with`` on; ``join()`` returns their rows by name and fails the run if
    any failed. Leaving the block stops every one still alive."""

    def __init__(self, groups):
        ctx = multiprocessing.get_context("spawn")
        self._queue = ctx.Queue()
        self._procs = [ctx.Process(target=learning_worker, args=(self._queue, names),
                                   name="learning-lines") for names in groups]

    def __enter__(self) -> "Workers":
        for proc in self._procs:
            proc.start()
        return self

    def join(self) -> dict:
        results = [self._queue.get(timeout=LEARNING_WORKER_TIMEOUT_S) for _ in self._procs]
        for proc in self._procs:
            proc.join(timeout=60)
        failed = [payload for status, payload in results if status != "ok"]
        if failed:
            raise AssertionError("learning worker failed: " + "\n".join(failed))
        return {name: row for _, payload in results for name, row in payload.items()}

    def __exit__(self, *exc) -> None:
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
                proc.join()


def learning_lines(workers: Workers) -> None:
    """Every learning line: ``LEARNING_LINES`` in this process, beside
    ``workers`` (each group of ``WORKER_LINES`` in a spawned process),
    joined before the verdict on ``pendulum_native_ppo``'s seeds. A failure
    anywhere fails the run."""
    for line in LEARNING_LINES:
        learning_line(*line)
    rows = workers.join()
    # The host path's line, its seeds gathered from their processes.
    seeds = [rows[f"pendulum_native_ppo_seed{seed}"] for seed in LEARNING_SEEDS]
    learning_verdict("pendulum_native_ppo", PENDULUM_NATIVE_STEPS, LEARNING_SEEDS,
                     [e for row in seeds for e in row["evals"]],
                     [t for row in seeds for t in row["seconds"]],
                     JAX_PENDULUM_NATIVE_EVALS, RANDOM_PENDULUM_RETURN)


def recurrent_learning_line() -> dict:
    """The JAX package's recurrent learning test on the card at each of
    ``LEARNING_SEEDS``: ``RECURRENT_LINE`` for ``RECURRENT_LINE_STEPS`` env
    steps; the mean over the seeds of the last three windows' training
    return must exceed max(2 x the mean of the first windows', 60)."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.config import Config

    firsts, lasts, seconds = [], [], []
    for seed in LEARNING_SEEDS:
        t = time.perf_counter()
        agent = asyncrl_tpu_torch.make_agent(Config(**RECURRENT_LINE), device="cuda", seed=seed)
        history = agent.train(total_env_steps=RECURRENT_LINE_STEPS)
        firsts.append(history[0]["episode_return"])
        lasts.append(statistics.mean(h["episode_return"] for h in history[-3:]))
        seconds.append(time.perf_counter() - t)
    first, last = statistics.mean(firsts), statistics.mean(lasts)
    bar = max(2 * first, 60.0)
    row = {
        "config": RECURRENT_LINE, "env_steps": RECURRENT_LINE_STEPS,
        "seeds": list(LEARNING_SEEDS), "first_window_returns": firsts,
        "last3_window_returns": lasts, "first_mean": first, "last3_mean": last, "bar": bar,
        "bar_rule": "max(2 * first window, 60), the JAX test's",
        "per_seed_above_own_bar": [lt > max(2 * ft, 60.0) for ft, lt in zip(firsts, lasts)],
        "jax_first_and_last3": [list(w) for w in JAX_RECURRENT_WINDOWS],
        "seconds": seconds,
    }
    log("learning cartpole_impala_lstm: " + json.dumps(row))
    if not last > bar:
        raise AssertionError(f"the IMPALA-LSTM learned to {last}, not above its bar {bar}")
    return row


def _leaf_equal(a, b) -> bool:
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def _flat_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(_leaf_equal(a[k], b[k]) for k in a)


def learning_evals(preset_name: str, env_steps: int, seeds) -> dict:
    """``preset_name`` for ``env_steps`` on the card at each of ``seeds``,
    each followed by a 32-episode greedy eval at ``max_steps=500``."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets

    evals, seconds = [], []
    for seed in seeds:
        t = time.perf_counter()
        agent = asyncrl_tpu_torch.make_agent(getattr(presets, preset_name), device="cuda",
                                             seed=seed)
        agent.train(total_env_steps=env_steps)
        evals.append(agent.evaluate(num_episodes=32, max_steps=500))
        agent.close()
        seconds.append(time.perf_counter() - t)
    return {"evals": evals, "seconds": seconds}


def learning_line(preset_name: str, env_steps: int, jax_evals: tuple, random_return) -> dict:
    """:func:`learning_evals` at ``LEARNING_SEEDS``, held to the bar of
    :func:`learning_verdict`."""
    row = learning_evals(preset_name, env_steps, LEARNING_SEEDS)
    return learning_verdict(preset_name, env_steps, LEARNING_SEEDS, row["evals"],
                            row["seconds"], jax_evals, random_return)


def learning_verdict(preset_name: str, env_steps: int, seeds, evals: list, seconds: list,
                     jax_evals: tuple, random_return) -> dict:
    """The mean of ``evals`` must reach the bar: half the JAX package's
    mean, or with ``random_return`` given, that return plus half the gap
    from it to the JAX mean."""
    mean = statistics.mean(evals)
    jax_mean = statistics.mean(jax_evals)
    if random_return is None:
        bar, random_policy, rule = jax_mean / 2, 22, "jax_mean / 2"
    else:
        bar = random_return + (jax_mean - random_return) / 2
        random_policy, rule = random_return, "random + (jax_mean - random) / 2"
    row = {
        "preset": preset_name, "env_steps": env_steps,
        "seeds": list(seeds), "eval_returns": evals, "mean": mean,
        "jax_eval_returns": list(jax_evals), "jax_mean": jax_mean,
        "bar": bar, "random_policy": random_policy, "bar_rule": rule, "seconds": seconds,
    }
    log(f"learning {preset_name}: " + json.dumps(row))
    if not mean >= bar:
        raise AssertionError(f"{preset_name} learned to {mean}, under the bar {bar} ({rule}; "
                             f"JAX mean {jax_mean})")
    return row


def kernel_entry(name: str, source: str, replaces: str, main: dict, max_err: float,
                 trains: list[dict], device_phase: str, rows: dict) -> dict:
    """One kernel's row of the kernels line: its numbers at the main path's
    shape, its device time in the profiled update of ``device_phase``, its
    launches on every training path, and its times against its bound at
    every checked shape (``rows``, the kernel check's)."""
    by_path = {r["phase"]: r["launches"][name] for r in trains}
    device = [r["kernel_device_ms"][name] for r in trains if r["phase"] == device_phase]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max_err,
        "ms": main["ms"],
        "device_ms": device[0] if device else None,
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        # No single PyTorch call computes the fused tail or an affine
        # reverse scan (cumsum/cumprod cover only its special cases); a sum
        # over the ranks computes the all-reduce.
        "library_ms": main.get("library_ms"),
        # The device times at this shape from the kernel check (the one
        # above is the profiled update's), warm and with a cold L2, and for
        # B4 the library call's.
        "shape_device_ms": main.get("device_ms"),
        **{k: main[k] for k in ("library_device_ms", "cold_l2_device_ms",
                                "cold_l2_library_device_ms") if k in main},
        "shape": _shape(main),
        "by_shape": {
            "/".join(map(str, key)) if isinstance(key, tuple) else key: {
                "shape": _shape(row),
                **{k: row.get(k) for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                           "library_device_ms", "bound_ms")},
            }
            for key, row in rows.items()
        },
    }


def _shape(row: dict) -> list:
    if "shape" in row:
        return row["shape"]
    return [row["n"], row["D"]] if "n" in row else [row["T"], row["B"]]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU, no result",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    set_precision()
    log("allow_tf32: matmul False, cudnn True")

    from asyncrl_tpu_torch.utils import cuda_build

    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    t = time.perf_counter()
    logs = cuda_build.build(sources)
    log(f"built {sources} in {time.perf_counter() - t:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    kernels = checks_and_phases()
    log(json.dumps(kernels))
    result = {"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}
    print(json.dumps(result), flush=True)
    return 0


def checks_and_phases() -> dict:
    """Every kernel check, training phase, round trip and learning line in
    turn, each through ``phase`` (its seconds and the running total
    printed, its name and error printed if it raises); returns the kernels
    line."""
    started = time.perf_counter()

    def phase(name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        # lint: broad-except-ok(names the failed phase, then re-raises unchanged)
        except BaseException as e:
            msg = (f"chip_smoke: phase {name} failed after {time.perf_counter() - t0:.1f} s: "
                   f"{type(e).__name__}: {e}")
            print(msg, file=sys.stderr, flush=True)
            log(msg)
            raise
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s "
            f"(total {time.perf_counter() - started:.1f} s)")
        return out

    vtrace_rows = phase("check_fused_vtrace", check_fused_vtrace)
    scan_rows = phase("check_linear_scan", check_linear_scan)
    sizes = phase("gradient_sizes", gradient_sizes)
    log(f"gradient sizes (parameter counts): {json.dumps(sizes)}")
    ring_rows = phase("check_ring_reduce", check_ring_reduce, sizes)
    trains = [phase(p[0], train_phase, *p) for p in PHASES]
    reference = next(r for r in trains if r["phase"] == "pong_impala")
    pop_row, pop = phase("population", population_phase, reference["env_steps_per_s"])
    trains.append(pop_row)
    trains.extend(phase(p[0], sebulba_phase, *p) for p in SEBULBA_PHASES)
    trains.append(phase("serve_pong_serve", serve_pong_serve_phase))
    trains.append(phase("serve_population", serve_population_phase, pop))
    trains.append(phase("serve_fleet_pong_impala", serve_fleet_phase))
    trains.append(phase("drain_pong_serve", drain_pong_serve_phase))
    trains.append(phase("supervision_sebulba_pong_impala", supervision_phase))
    trains.append(phase("trace_sebulba_pong_impala", trace_phase))
    trains.append(phase("health_sebulba_pong_impala", health_phase))
    trains.append(phase("elastic_sebulba_pong_impala", elastic_phase))
    trains.append(phase("resume_sebulba_pong_impala", resume_phase))
    phase("mujoco_presets", mujoco_presets_line)
    pop.close()
    del pop
    peaks = {r["phase"]: r["max_memory_allocated_bytes"] for r in trains}
    log("peak memory: " + json.dumps({k: peaks[k] for k in (
        "atari_impala", "atari_impala_wide", "breakout_pixels_impala", "pong_pixels_t2t",
        "atari_nature_cnn", "brax_humanoid_ppo", f"pong_impala_pop{POP_SIZE}",
        "minatari_seaquest", "sebulba_pendulum_native_ppo", "sebulba_pong_impala")}))
    # The learning workers start here: no phase after this point is
    # profiled for its busy time.
    with Workers(WORKER_LINES) as workers:
        cli_dir = ROOT / "chip_smoke_cli"  # git-ignored; removed after
        shutil.rmtree(cli_dir, ignore_errors=True)
        cli_dir.mkdir()
        try:
            trains.append(phase("cli_train", cli_train_phase, cli_dir))
        finally:
            shutil.rmtree(cli_dir, ignore_errors=True)
        trains.append(phase("launch_pong_impala_2proc", launch_phase))
        phase("timeshard", timeshard_check)
        phase("checkpoint_round_trip pong_t2t", checkpoint_round_trip)
        phase("checkpoint_round_trip pong_selfplay_lstm", checkpoint_round_trip,
              "pong_selfplay", {"core": "lstm"})
        phase("selfplay_promotion", selfplay_promotion)
        # In the learning workers' shadow: the main process would wait for
        # them here anyway.
        trains.append(phase("rollback_sebulba_pong_impala", rollback_phase))
        phase("learning_lines", learning_lines, workers)

    scan_err = {
        k: max(r["max_abs_err"] for (kk, _), r in scan_rows.items() if kk == k)
        for k in ("linear_scan", "linear_scan_dma")
    }
    kernels = {"kernels": [
        kernel_entry("fused_vtrace", "asyncrl_tpu_torch/csrc/fused_vtrace.cu",
                     "asyncrl_tpu/ops/pallas_scan.py:367", vtrace_rows["atari_impala"],
                     max(r["max_abs_err"] for r in vtrace_rows.values()), trains,
                     "atari_impala", vtrace_rows),
        kernel_entry("linear_scan", "asyncrl_tpu_torch/csrc/linear_scan.cu",
                     "asyncrl_tpu/ops/pallas_scan.py:164", scan_rows[("linear_scan", "brax_ppo")],
                     scan_err["linear_scan"], trains, "brax_ppo_lax_kernel",
                     {n: r for (k, n), r in scan_rows.items() if k == "linear_scan"}),
        kernel_entry("linear_scan_dma", "asyncrl_tpu_torch/csrc/linear_scan.cu",
                     "asyncrl_tpu/ops/pallas_scan.py:230",
                     scan_rows[("linear_scan_dma", "brax_ppo")], scan_err["linear_scan_dma"],
                     trains, "brax_ppo_lax_kernel_dma",
                     {n: r for (k, n), r in scan_rows.items() if k == "linear_scan_dma"}),
        kernel_entry("ring_all_reduce", "asyncrl_tpu_torch/csrc/ring_reduce.cu",
                     "asyncrl_tpu/ops/ring_reduce.py:257", ring_rows[(MESH_RANKS, "atari_impala")],
                     max(r["max_abs_err"] for r in ring_rows.values()), trains,
                     "atari_impala_mesh8_ring", ring_rows),
    ]}
    return kernels


if __name__ == "__main__":
    sys.exit(main())
