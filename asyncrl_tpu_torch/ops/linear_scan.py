"""The reverse affine time scan x_t = b_t + a_t * x_{t+1}, x_T = 0, as two
CUDA kernels.

Port of two Pallas TPU kernels of ``asyncrl_tpu/ops/pallas_scan.py``:
``reverse_linear_scan_pallas`` (Pallas feeds the tiles) and
``reverse_linear_scan_pallas_dma`` (the kernel issues its own HBM-to-VMEM
copies on DMA semaphores). Four pieces live here:

- :func:`linear_scan_plain`, the plain PyTorch version shared by both
  kernels: a Python loop over ``t`` with one fused multiply-add a step. The
  CPU path and the yardstick both kernels are held to, bit for bit.
- the CUDA kernels, ``csrc/linear_scan.cu`` (its header gives the designs
  and the bound, 12 bytes an element): ``linear_scan`` gives each thread a
  column, which it loads 32 rows at a time into registers, the next batch in
  flight while the current one is walked; ``linear_scan_dma`` brings ``a``
  and ``b`` into a ring of four 16-row stages in shared memory with Hopper
  bulk asynchronous copies that complete on mbarriers, issued by a producer
  warp that runs up to three chunks ahead of the walk: two 2-D tensor-map
  tiles a stage where every row is on the 16-byte grid, one copy a row
  segment elsewhere. Both take 32 columns a block.
- :func:`linear_scan` and :func:`linear_scan_dma`, the wrappers: they check
  their inputs, flatten the trailing dims into columns (as the JAX
  ``_prep`` does), run the plain version for CPU tensors and launch their
  kernel for CUDA tensors. Neither falls back from one to the other.
- :data:`launches`, the count of each kernel's launches.

Rounding contract, measured against both JAX kernels in interpret mode and
JAX's jitted sequential scan: all three round ``b + a * x`` once, as a
fused multiply-add, and agree bit for bit. The recurrence starts from
``a[0] * 0`` of each column, as the JAX kernels build their zero carry.

Forward only: the JAX kernels define no VJP and every caller stops the
gradient of their inputs, so an input that requires grad raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from asyncrl_tpu_torch.utils import cuda_build
from asyncrl_tpu_torch.utils.numerics import fma_f32

# Kernel launches since import (or since a caller reset them), by kernel.
# Only the CUDA path counts; the plain version never does.
launches = {"linear_scan": 0, "linear_scan_dma": 0}


def reverse_fma_walk(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x_t = fma(a_t, x_{t+1}, b_t) for t = T-1 .. 0, from the carry ``x``
    (shaped like ``a[0]``)."""
    out = torch.empty_like(b)
    for t in range(b.shape[0] - 1, -1, -1):
        x = fma_f32(a[t], x, b[t])
        out[t] = x
    return out


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch reverse scan; see :func:`linear_scan` for the contract."""
    return reverse_fma_walk(a, b, a[0] * 0.0)


def _check(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape:
        raise ValueError(f"{name} shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.dim() == 0 or a.numel() == 0:
        raise ValueError(f"{name} takes non-empty [T, ...] inputs, got {tuple(a.shape)}")
    for x in (a, b):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 tensors, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if x.requires_grad:
            raise ValueError(f"{name} is forward-only: detach its inputs")
    if a.device != b.device:
        raise ValueError(f"{name} inputs on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {a.device.type}")


@functools.cache
def _kernel(name: str):
    fn = getattr(cuda_build.load("linear_scan"), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    T = a.shape[0]
    a2, b2 = a.reshape(T, -1), b.reshape(T, -1)
    N = a2.shape[1]
    out = torch.empty_like(b2)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel(name)(a2.data_ptr(), b2.data_ptr(), out.data_ptr(), T, N, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    launches[name] += 1
    return out.reshape(a.shape)


def _scan(name: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(name, a, b)
    if a.device.type == "cpu":
        return linear_scan_plain(a, b)
    return _launch(name, a, b)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve x_t = b_t + a_t * x_{t+1}, x_T = 0, over time-major ``[T, ...]``
    float32 contiguous tensors; trailing dims are independent columns.

    CPU tensors run :func:`linear_scan_plain`; CUDA tensors launch the
    ``linear_scan`` kernel (built on first use) or raise.
    """
    return _scan("linear_scan", a, b)


def linear_scan_dma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`linear_scan` through the kernel that owns its copies into
    shared memory (``linear_scan_dma``); bit-identical to it."""
    return _scan("linear_scan_dma", a, b)
