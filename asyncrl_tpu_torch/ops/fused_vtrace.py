"""The fused V-trace tail: TD errors, the reverse recurrence and the vs/pg
reconstruction in one pass over ``[T, B]`` tensors.

Port of ``asyncrl_tpu/ops/pallas_scan.py::fused_vtrace_pallas`` (a Pallas
TPU kernel). Three pieces live here:

- :func:`fused_vtrace_plain`, the plain PyTorch version: the same per-step
  arithmetic as a Python loop over ``t``. The CPU path and the yardstick the
  CUDA kernel is held to, bit for bit.
- the CUDA kernel, ``csrc/fused_vtrace.cu`` (a block stages 32 columns by
  up to 32 time steps in shared memory, double-buffered, and walks only the
  recurrence serially; its header gives the design and the bound).
- :func:`fused_vtrace`, the wrapper: checks its inputs, runs the plain
  version for CPU tensors and launches the kernel for CUDA tensors. It never
  falls back from one to the other. :data:`launches` counts kernel launches.

Rounding contract (the JAX kernel's, measured against
``fused_vtrace_pallas(interpret=True)``): the recurrence ``delta + a * x`` is
ONE rounded fused multiply-add, and every other product is rounded on its
own before the add that consumes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from asyncrl_tpu_torch.utils import cuda_build
from asyncrl_tpu_torch.utils.numerics import fma_f32

# Kernel launches since import (or since a caller reset it). Only the CUDA
# path counts; the plain version never does.
launches = 0


def fused_vtrace_plain(
    clipped_rhos: torch.Tensor,
    scan_coeffs: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch V-trace tail; see :func:`fused_vtrace` for the contract."""
    vs = torch.empty_like(rewards)
    adv = torch.empty_like(rewards)
    pg = torch.empty_like(rewards)
    x = bootstrap_value * 0.0
    v_next = vs_next = bootstrap_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        c, r, d, v = clipped_rhos[t], rewards[t], discounts[t], values[t]
        delta = c * ((r + d * v_next) - v)
        x = fma_f32(scan_coeffs[t], x, delta)
        s = x + v
        adv[t] = x
        vs[t] = s
        pg[t] = c * ((r + d * vs_next) - v)
        v_next, vs_next = v, s
    return vs, adv, pg


def _check(inputs: tuple[torch.Tensor, ...]) -> None:
    *per_step, boot = inputs
    shape = per_step[0].shape
    device = per_step[0].device
    if len(shape) != 2 or 0 in shape:
        raise ValueError(f"fused_vtrace takes non-empty [T, B] inputs, got {tuple(shape)}")
    for x in inputs:
        if x.dtype != torch.float32:
            raise TypeError(f"fused_vtrace takes float32 tensors, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"fused_vtrace inputs on {x.device} and {device}")
        if not x.is_contiguous():
            raise ValueError("fused_vtrace takes contiguous tensors")
    for x in per_step:
        if x.shape != shape:
            raise ValueError(f"fused_vtrace shape mismatch: {tuple(x.shape)} vs {tuple(shape)}")
    if boot.shape != shape[1:]:
        raise ValueError(
            f"bootstrap_value must be [B]={tuple(shape[1:])}, got {tuple(boot.shape)}"
        )


@functools.cache
def _kernel():
    fn = cuda_build.load("fused_vtrace").fused_vtrace_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(inputs: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    global launches
    rewards = inputs[2]
    T, B = rewards.shape
    outs = tuple(torch.empty_like(rewards) for _ in range(3))
    with torch.cuda.device(rewards.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(*(x.data_ptr() for x in inputs + outs), T, B, stream)
    if rc != 0:
        raise RuntimeError(f"fused_vtrace kernel launch failed: cudaError {rc}")
    launches += 1
    return outs


def fused_vtrace(
    clipped_rhos: torch.Tensor,
    scan_coeffs: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """V-trace tail over time-major ``[T, B]`` float32 tensors.

    ``clipped_rhos`` is min(rho_bar, rho) and ``scan_coeffs`` is
    d_t * min(c_bar, rho): the caller computes that exp/clip prologue
    (``ops/vtrace.py``). ``bootstrap_value`` is ``[B]``. Returns
    ``(vs, vs - V, pg_advantages)``, each ``[T, B]`` float32. Forward only:
    the outputs are training targets, so the inputs carry no gradient.

    CPU tensors run :func:`fused_vtrace_plain`; CUDA tensors launch the
    kernel (built on first use) or raise.
    """
    inputs = (clipped_rhos, scan_coeffs, rewards, discounts, values, bootstrap_value)
    _check(inputs)
    if any(x.requires_grad for x in inputs):
        raise ValueError("fused_vtrace is forward-only: detach its inputs")
    device = rewards.device.type
    if device == "cpu":
        return fused_vtrace_plain(*inputs)
    if device != "cuda":
        raise ValueError(f"fused_vtrace runs on cpu or cuda, not {device}")
    return _launch(inputs)
