"""Bidirectional ring all-reduce over the ranks of a mesh, as a CUDA kernel.

Port of ``asyncrl_tpu/ops/ring_reduce.py::ring_all_reduce_pallas`` (a Pallas
TPU kernel with remote copies between chips) and of its lax twin
``ring_all_reduce_lax``, whose schedule fixes the fold order. The port's
ranks share one card, so one tensor holds every rank's payload:
``stacked[r]`` is rank r's flat float32 vector. Four pieces live here:

- :func:`ring_all_reduce_plain`, the plain PyTorch version: the lax twin's
  ``ppermute`` steps written over the rank axis (a step's sends are one
  gather of each rank's chunk, ``torch.roll`` along the ranks delivers them).
  The CPU path and the yardstick the kernel is held to, bit for bit.
- the CUDA kernel, ``csrc/ring_reduce.cu``: the ring's fold as one
  elementwise pass over the ranks' rows (its header gives the design and
  the bound).
- :func:`ring_all_reduce`, the wrapper: checks its input, is the identity
  for one rank, runs the plain version for CPU tensors and launches the
  kernel for CUDA tensors. It never falls back from one to the other.
  :data:`launches` counts kernel launches.
- :func:`ring_all_reduce_grads`, the gradient entry point: one ring over
  each rank's flattened gradient list.

Schedule and numerics (the JAX module's contract): the payload is zero-padded
into ``[2 directions, n chunks, S, 128]`` tiles; each direction runs n-1
reduce-scatter steps, then n-1 all-gather steps, clockwise on direction 0
and counter-clockwise on direction 1. Chunk c of a direction (sign +1 for
direction 0, -1 for 1) starts on rank c and is folded ``local + incoming``
on ranks c+sign, c+2*sign, ...; the all-gather only copies. So every rank
ends with the same bits, run to run, and the result equals a plain sum
within (n-1) rounding steps (bit-equal at n=2, where the fold is one
commutative add).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from asyncrl_tpu_torch.utils import cuda_build

LANE = 128
SUBLANE = 8

# Kernel launches since import (or since a caller reset it). Only the CUDA
# path counts; the plain version and the one-rank identity never do.
launches = 0


def _chunk(size: int, n: int) -> int:
    """Floats in one ring chunk of the JAX geometry, ``S * 128`` with S a
    multiple of 8 and at least 8: a multiple of 1024."""
    rows_per_chunk = -(-size // (2 * n * LANE))
    return max(SUBLANE, -(-rows_per_chunk // SUBLANE) * SUBLANE) * LANE


def _to_chunks(flat: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last dim ``D`` into ``[2, n, S, 128]`` ring tiles (the
    JAX geometry)."""
    size = flat.shape[-1]
    chunk = _chunk(size, n)
    padded = F.pad(flat, (0, 2 * n * chunk - size))
    return padded.reshape(*flat.shape[:-1], 2, n, chunk // LANE, LANE)


def _ring_passes_plain(buf: torch.Tensor, sign: int) -> torch.Tensor:
    """One direction's reduce-scatter + all-gather over ``buf[rank, chunk]``
    (``[n, n, S, 128]``): the lax twin's ``_ring_passes_lax`` with rank r
    sending to rank r + sign at every step."""
    n = buf.shape[0]
    buf = buf.clone()
    ranks = torch.arange(n, device=buf.device)
    for s in range(n - 1):
        incoming = torch.roll(buf[ranks, (ranks - sign * s) % n], sign, dims=0)
        recv = (ranks - sign * (s + 1)) % n
        buf[ranks, recv] = buf[ranks, recv] + incoming
    for s in range(n - 1):
        incoming = torch.roll(buf[ranks, (ranks + sign * (1 - s)) % n], sign, dims=0)
        buf[ranks, (ranks - sign * s) % n] = incoming
    return buf


def ring_all_reduce_plain(stacked: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ring; see :func:`ring_all_reduce` for the contract."""
    n, size = stacked.shape
    buf = _to_chunks(stacked, n)
    out = torch.stack([_ring_passes_plain(buf[:, 0], +1), _ring_passes_plain(buf[:, 1], -1)], 1)
    return out.reshape(n, -1)[:, :size]


@functools.cache
def _kernel():
    fn = cuda_build.load("ring_reduce").ring_all_reduce_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_bool, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rows_buffer(n: int, size: int, device) -> torch.Tensor:
    """An uninitialised float32 ``[n, size]`` view whose rows lie ``size``
    rounded up to 4 floats apart: the layout the kernel reads with 16-byte
    loads."""
    return torch.empty(n, -(-size // 4) * 4, dtype=torch.float32, device=device)[:, :size]


def _vector_rows(stacked: torch.Tensor) -> bool:
    """Whether the kernel may read ``stacked[n, D]`` with 16-byte loads:
    they read each row up to a multiple of 4 floats, so every row must start
    on the 16-byte grid and that much of the storage must be there."""
    n, size = stacked.shape
    stride = stacked.stride(0)
    size4 = -(-size // 4) * 4
    return (
        stride % 4 == 0 and stride >= size4 and stacked.data_ptr() % 16 == 0
        and stacked.storage_offset() + (n - 1) * stride + size4
        <= stacked.untyped_storage().nbytes() // 4
    )


def _launch(stacked: torch.Tensor) -> torch.Tensor:
    global launches
    n, size = stacked.shape
    if stacked.stride(1) != 1:
        raise ValueError("ring_all_reduce takes rows with unit stride")
    out = torch.empty(-(-size // 4) * 4, dtype=torch.float32, device=stacked.device)
    with torch.cuda.device(stacked.device):
        rc = _kernel()(stacked.data_ptr(), out.data_ptr(), stacked.stride(0), size, n,
                       _chunk(size, n), _vector_rows(stacked),
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ring_all_reduce kernel launch failed: cudaError {rc}")
    launches += 1
    return out[:size].unsqueeze(0).expand(n, size)


def ring_all_reduce(stacked: torch.Tensor) -> torch.Tensor:
    """All-reduce the ranks' float32 payloads ``stacked[n, D]`` (rank r's in
    row r, rows with unit stride) with the bidirectional ring. Row r of the
    result is what rank r ends with; every row is the same bits. One rank
    is the identity.

    CPU tensors run :func:`ring_all_reduce_plain`, which returns n rows of
    their own. CUDA tensors launch the kernel (built on first use) or raise;
    it writes the reduced vector once, and the result is
    ``out.unsqueeze(0).expand(n, D)``: every row is a view of the same
    storage, so the ranks' rows are the same bits by construction (the psum
    path hands every rank one tensor too). Do not write into it.
    """
    if stacked.dim() != 2 or 0 in stacked.shape:
        raise ValueError(f"ring_all_reduce takes a non-empty [n, D] tensor, got {tuple(stacked.shape)}")
    if stacked.dtype != torch.float32:
        raise TypeError(f"ring_all_reduce takes float32, got {stacked.dtype}")
    if stacked.requires_grad:
        raise ValueError("ring_all_reduce is forward-only: detach its input")
    device = stacked.device.type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"ring_all_reduce runs on cpu or cuda, not {device}")
    if stacked.shape[0] == 1:
        return stacked
    if device == "cpu":
        return ring_all_reduce_plain(stacked)
    return _launch(stacked)


def ring_all_reduce_grads(per_rank_grads: list[list[torch.Tensor]]) -> list[list[torch.Tensor]]:
    """Ring-sum gradient lists across ranks: ``per_rank_grads[r]`` is rank
    r's list, and the result holds each rank's reduced list. Each rank's list
    is flattened into one float32 row first, as the JAX ``ravel_pytree``
    does: one ring over the concatenation, not one per tensor. The rows are
    written straight into one :func:`rows_buffer`, so the kernel reads every
    row with 16-byte loads."""
    first = per_rank_grads[0]
    sizes = [g.numel() for g in first]
    stacked = rows_buffer(len(per_rank_grads), sum(sizes), first[0].device)
    for row, grads in zip(stacked, per_rank_grads):
        torch.cat([g.reshape(-1).float() for g in grads], out=row)
    return [
        [t.reshape(g.shape).to(g.dtype) for t, g in zip(row.split(sizes), first)]
        for row in ring_all_reduce(stacked)
    ]
