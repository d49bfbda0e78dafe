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
   all-reduce (B4) over 2, 4 and 8 ranks at both mesh phases' gradient
   sizes and a ragged one, in the gradient path's layout and as a
   contiguous tensor, with a plain sum over the ranks as the library call
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
   second call) on B1, two calls;
5. saves ``pong_t2t`` after one call into a git-ignored directory, restores
   it into a fresh trainer with ``restore=``, and checks that the next call
   of both gives the same state bit for bit, the CUDA generator's included;
6. trains ``cartpole_a3c`` for its full 400,000 env steps at seeds 0, 1 and
   2, takes a 32-episode greedy eval (``max_steps=500``) after each, and
   fails if their mean is under half the JAX package's at the same budget
   (``JAX_CARTPOLE_A3C_EVALS``);
7. prints one JSON line about the kernels, then the result line
   ``{"ok": true, "device": {...}}`` last.

It exits non-zero without a result when CUDA is missing or any phase fails,
a preset that does not fit on the card included. Weights are random, from
a seed. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# Path shapes (T, B) of the fused V-trace kernel (brax_ppo's GAE rides it
# by default; on the mesh phases each rank's shard), a ragged one, and one
# longer than a time chunk whose rows are off the 16-byte grid.
VTRACE_SHAPES = {
    "atari_impala": (32, 1024), "pong_impala": (32, 256), "brax_ppo": (64, 8192),
    "ragged": (37, 1000), "atari_impala_mesh8_rank": (32, 128),
    "pong_impala_mesh8_rank": (32, 32), "long_ragged": (257, 1001), "cartpole": (32, 64),
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
# launch).
MESH = {"fused_vtrace": MESH_RANKS, "ring_all_reduce": 1}
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
)
# The JAX package's cartpole_a3c at its full budget, seeds 0, 1 and 2, each
# a 32-episode greedy eval at max_steps=500, measured on the CPU by
# `JAX_PLATFORMS=cpu python tests/cartpole_a3c_parity.py jax`; the port's
# three-seed mean must reach half their mean.
JAX_CARTPOLE_A3C_EVALS = (179.3125, 83.4375, 76.1875)
LEARNING_SEEDS = (0, 1, 2)
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
    for name in ("pong_impala", "atari_impala"):
        cfg = getattr(presets, name).replace(device="cpu")
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
        _ppo_multipass, algo_loss, draw_permutations, mesh_loss_and_grads, ppo_multipass,
        shard_rollout,
    )
    from asyncrl_tpu_torch.ops import ring_reduce as rr
    from asyncrl_tpu_torch.parallel.mesh import make_mesh, reduce_grads
    from asyncrl_tpu_torch.rollout.anakin import unroll

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
    if cfg.algo == "ppo" and agent.env.spec.continuous:
        if abs(last["entropy"] - GAUSSIAN_ENTROPY) > 0.15:
            raise AssertionError(f"{phase}: entropy {last['entropy']} far from {GAUSSIAN_ENTROPY}")
    elif not 0.0 < last["entropy"] <= math.log(agent.env.spec.num_actions) + 1e-4:
        raise AssertionError(f"{phase}: entropy {last['entropy']} outside (0, log actions]")

    # Where an update's time goes: the rollout alone, and the learner alone
    # (loss + backward for IMPALA, the whole multipass update for PPO),
    # each timed after a synchronize.
    state, learner = agent.state, agent.learner
    lcfg = learner.config
    torch.cuda.synchronize()
    t = time.perf_counter()
    state.actor, rollout, _ = unroll(
        state.actor_params, agent.env, state.actor, cfg.unroll_len,
        state.generator, learner.dist, cfg.reward_scale, cfg.step_cost,
    )
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t

    # The loss through the kernel equals the loss through plain code on
    # this fragment (rank 0's shard of it on a mesh): the kernel is the only
    # difference between the two. Plain code is the fused tail's plain
    # version for B1, and the sequential scan (the scan kernels' arithmetic)
    # for B2 and B3, for V-trace, GAE and n-step returns alike.
    frag = shard_rollout(rollout, 0, ranks) if ranks > 1 else rollout
    plain = {"fused_scan": "plain"} if "fused_vtrace" in per_update else {"scan_impl": "sequential"}
    with torch.no_grad():
        plain_loss, _ = algo_loss(lcfg.replace(**plain), state.params, frag, learner.dist)
        kernel_loss, _ = algo_loss(lcfg, state.params, frag, learner.dist)
    if not torch.equal(plain_loss, kernel_loss) or not torch.isfinite(kernel_loss):
        raise AssertionError(f"{phase}: kernel loss {kernel_loss} vs plain {plain_loss}")

    ring = {}
    if ranks > 1:
        # The ranks' gradients on this fragment, reduced through B4 (by the
        # learner's entry point) and through the plain ring: the same bits,
        # every rank's row alike, and within the fold bound of a plain sum
        # (psum).
        grads, _, _ = mesh_loss_and_grads(lcfg, state.params, rollout, learner.dist, ranks)
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
        perms = draw_permutations(rollout.behaviour_logp.numel(), lcfg.ppo_epochs, state.generator)
        _ppo_multipass(lcfg, state.params, learner.optimizer, state.opt_state, learner.dist,
                       rollout, perms)
    elif ranks > 1:
        grads, _, _ = mesh_loss_and_grads(lcfg, state.params, rollout, learner.dist, ranks)
        reduce_grads(grads, learner.axes, lcfg.grad_reduce)
    else:
        loss, _ = algo_loss(lcfg, state.params, rollout, learner.dist)
        torch.autograd.grad(loss, list(state.params.parameters()))
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
        "wall_s_incl_setup": wall,
        "loss": last["loss"],
        "entropy": last["entropy"],
        "loss_bit_identical_to_plain": True,
        **({"in_training_eval_return": evals[0]} if evals else {}),
        "eval_return_100_steps": eval_return,
        "device_idle_share": profile["device_idle_share"],
        "kernel_device_ms": {k: profile["kernel_device_ms"][k] for k in per_update},
    }
    log(f"train {phase}: " + json.dumps(row))
    return row


def profile_update(agent, unprofiled_s: float) -> dict:
    """One more update under ``torch.profiler``: the device's busy time by
    kernel, and its idle share against the unprofiled update time (the
    training window's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        agent.state, _ = agent.learner.update_once(agent.state)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]

    def device_ms(key: str):
        hits = [e for e in kernels if key in e.key]
        return hits[0].self_device_time_total / hits[0].count / 1e3 if hits else None

    return {
        "device_busy_ms": busy_ms,
        "update_ms_unprofiled": unprofiled_s * 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (unprofiled_s * 1e3)),
        "kernel_launches": sum(e.count for e in kernels),
        "kernel_device_ms": {k: device_ms(key) for k, key in PROFILE_KEYS.items()},
        "top_kernels": [
            {"name": e.key[:90], "ms": e.self_device_time_total / 1e3, "count": e.count}
            for e in top
        ],
    }


def checkpoint_round_trip() -> dict:
    """``pong_t2t`` saves after one call; a fresh trainer restored from that
    save (``restore=``, read-only) and the run that did not stop each take
    the next call, and must end in the same state bit for bit: weights,
    Adam state, envs, update count and the CUDA generator's state."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets
    from asyncrl_tpu_torch.utils.checkpoint import state_dict

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    cfg = presets.pong_t2t.replace(device="cuda", eval_every=0, log_every=1)
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
        row = {
            "preset": "pong_t2t",
            "saved_update_step": saved[0],
            "next_update_step": run.state.update_step,
            "leaves": len(after_run),
            "state_bytes": sum(v.numel() * v.element_size() for v in after_run.values()
                               if isinstance(v, torch.Tensor)),
            "next_call_bit_identical_after_restore": True,
            "cuda_generator_state_equal": torch.equal(after_run["generator"],
                                                      after_restored["generator"]),
            "wall_s": time.perf_counter() - t,
        }
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    log("checkpoint round trip: " + json.dumps(row))
    return row


def _leaf_equal(a, b) -> bool:
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def _flat_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(_leaf_equal(a[k], b[k]) for k in a)


def learning_line() -> dict:
    """``cartpole_a3c`` at its full budget on the card, at each of
    ``LEARNING_SEEDS``, each followed by a 32-episode greedy eval at
    ``max_steps=500``; the mean must reach half the JAX package's."""
    import asyncrl_tpu_torch
    from asyncrl_tpu_torch.configs import presets

    evals, seconds = [], []
    for seed in LEARNING_SEEDS:
        t = time.perf_counter()
        agent = asyncrl_tpu_torch.make_agent(presets.cartpole_a3c, device="cuda", seed=seed)
        agent.train()
        evals.append(agent.evaluate(num_episodes=32, max_steps=500))
        seconds.append(time.perf_counter() - t)
    mean = statistics.mean(evals)
    jax_mean = statistics.mean(JAX_CARTPOLE_A3C_EVALS)
    row = {
        "preset": "cartpole_a3c", "env_steps": presets.cartpole_a3c.total_env_steps,
        "seeds": list(LEARNING_SEEDS), "eval_returns": evals, "mean": mean,
        "jax_eval_returns": list(JAX_CARTPOLE_A3C_EVALS), "jax_mean": jax_mean,
        "bar": jax_mean / 2, "random_policy": 22, "seconds": seconds,
    }
    log("learning cartpole_a3c: " + json.dumps(row))
    if not mean >= jax_mean / 2:
        raise AssertionError(f"cartpole_a3c learned to {mean}, under half the JAX mean {jax_mean}")
    return row


def kernel_entry(name: str, source: str, replaces: str, main: dict, max_err: float,
                 trains: list[dict], device_phase: str) -> dict:
    """One kernel's row of the kernels line: its numbers at the main path's
    shape, its device time in the profiled update of ``device_phase``, and
    its launches on every training path."""
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
        "shape": main.get("shape", [main.get("n"), main.get("D")] if "n" in main
                          else [main.get("T"), main.get("B")]),
    }


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
    # State the precision settings: the presets run the torso in bf16 and
    # the heads in f32; f32 matmuls stay full f32, f32 convs may use TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
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

    vtrace_rows = check_fused_vtrace()
    scan_rows = check_linear_scan()
    sizes = gradient_sizes()
    log(f"gradient sizes (parameter counts): {json.dumps(sizes)}")
    ring_rows = check_ring_reduce(sizes)
    trains = [train_phase(*phase) for phase in PHASES]
    checkpoint_round_trip()
    learning_line()

    scan_err = {
        k: max(r["max_abs_err"] for (kk, _), r in scan_rows.items() if kk == k)
        for k in ("linear_scan", "linear_scan_dma")
    }
    kernels = {"kernels": [
        kernel_entry("fused_vtrace", "asyncrl_tpu_torch/csrc/fused_vtrace.cu",
                     "asyncrl_tpu/ops/pallas_scan.py:367", vtrace_rows["atari_impala"],
                     max(r["max_abs_err"] for r in vtrace_rows.values()), trains,
                     "atari_impala"),
        kernel_entry("linear_scan", "asyncrl_tpu_torch/csrc/linear_scan.cu",
                     "asyncrl_tpu/ops/pallas_scan.py:164", scan_rows[("linear_scan", "brax_ppo")],
                     scan_err["linear_scan"], trains, "brax_ppo_lax_kernel"),
        kernel_entry("linear_scan_dma", "asyncrl_tpu_torch/csrc/linear_scan.cu",
                     "asyncrl_tpu/ops/pallas_scan.py:230",
                     scan_rows[("linear_scan_dma", "brax_ppo")], scan_err["linear_scan_dma"],
                     trains, "brax_ppo_lax_kernel_dma"),
        kernel_entry("ring_all_reduce", "asyncrl_tpu_torch/csrc/ring_reduce.cu",
                     "asyncrl_tpu/ops/ring_reduce.py:257", ring_rows[(MESH_RANKS, "atari_impala")],
                     max(r["max_abs_err"] for r in ring_rows.values()), trains,
                     "atari_impala_mesh8_ring"),
    ]}
    log(json.dumps(kernels))
    result = {"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
