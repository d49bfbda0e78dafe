"""The port's reverse linear scans against the JAX package's.

The plain version of the two CUDA scan kernels (``ops/linear_scan.py``)
must equal ``reverse_linear_scan_pallas`` and ``reverse_linear_scan_pallas_dma``
run in the Pallas interpreter bit for bit: all of them round ``b + a * x``
once per step, as a fused multiply-add. ``impl="sequential"`` must equal
JAX's jitted sequential scan bit for bit. The associative scans of the two
packages combine in different orders, so, as ``tests/test_pallas_scan.py``
holds JAX's own, they agree within rtol 1e-5 / atol 1e-5.

The CUDA kernels run only on a GPU, so numpy copies of their index
arithmetic (constants read from ``csrc/linear_scan.cu``) are held here to
what the kernels rely on. These tests pin the plan, not the kernel: the
loops are retyped from the CUDA source, so a change there that is not made
here too passes them, and only ``chip_smoke.py`` runs the kernels. The
plan: ``linear_scan_dma``'s copy plan (stages, phases, bulk copies on the
16-byte grid, edge loads) moves every element once into the place its walk
reads it from, and ``linear_scan``'s register batches are loaded before
they are walked; walking what they hold, one ``fma_f32`` a step, gives the
plain version's bits.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from asyncrl_tpu.ops.pallas_scan import (
    reverse_linear_scan_pallas,
    reverse_linear_scan_pallas_dma,
)
from asyncrl_tpu.ops.scan import reverse_linear_scan as jreverse_linear_scan
from asyncrl_tpu_torch import make_agent
from asyncrl_tpu_torch.configs import presets as tpresets
from asyncrl_tpu_torch.ops import linear_scan as ls
from asyncrl_tpu_torch.ops.scan import combine, reverse_linear_scan
from asyncrl_tpu_torch.utils.numerics import fma_f32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one CPU thread, as in the port's other comparisons."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = [(64, 512), (37, 130), (16, 300), (9, 3, 5), (1, 7), (1000, 16)]


def scan_inputs(shape, seed):
    """a in [0, 0.94] (discount-like), b ~ N(0, 1), numpy f32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 0.94, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kernel", ["linear_scan", "linear_scan_dma"])
def test_plain_is_bit_identical_to_pallas_interpret(shape, kernel):
    a, b = scan_inputs(shape, seed=sum(shape))
    jax_kernel = {
        "linear_scan": reverse_linear_scan_pallas,
        "linear_scan_dma": reverse_linear_scan_pallas_dma,
    }[kernel]
    ref = np.asarray(jax_kernel(a, b, interpret=True))
    out = getattr(ls, kernel)(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_sequential_and_associative_match_jax(shape):
    a, b = scan_inputs(shape, seed=7 * sum(shape))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    jscan = jax.jit(jreverse_linear_scan, static_argnames="impl")
    np.testing.assert_array_equal(
        reverse_linear_scan(ta, tb, "sequential").numpy(),
        np.asarray(jscan(a, b, impl="sequential")),
    )
    np.testing.assert_allclose(
        reverse_linear_scan(ta, tb, "associative").numpy(),
        np.asarray(jscan(a, b, impl="associative")),
        rtol=1e-5, atol=1e-5,
    )
    # "kernel" on CPU tensors is the plain version: the sequential bits.
    np.testing.assert_array_equal(
        reverse_linear_scan(ta, tb, "kernel").numpy(),
        reverse_linear_scan(ta, tb, "sequential").numpy(),
    )


def test_combine_composes_affine_maps():
    rng = np.random.default_rng(3)
    a1, b1, a2, b2, x = (torch.from_numpy(rng.standard_normal(5)) for _ in range(5))
    a, b = combine((a1, b1), (a2, b2))
    torch.testing.assert_close(b + a * x, b2 + a2 * (b1 + a1 * x))


def test_wrappers_refuse_bad_inputs():
    a = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="forward-only"):
        ls.linear_scan(a.clone().requires_grad_(), a)
    with pytest.raises(TypeError):
        ls.linear_scan_dma(a.double(), a.double())
    with pytest.raises(ValueError):
        ls.linear_scan(a, torch.zeros(4, 2))
    with pytest.raises(ValueError):
        ls.linear_scan(a.T, a.T)  # not contiguous
    with pytest.raises(ValueError):
        reverse_linear_scan(a, a, impl="pallas")
    assert ls.launches == {"linear_scan": 0, "linear_scan_dma": 0}  # CPU: plain only


@pytest.mark.parametrize("knobs", [
    {"scan_impl": "kernel"}, {"scan_impl": "kernel_dma"},
    {"fused_scan": "lax", "scan_impl": "kernel"}, {"fused_scan": "kernel"},
])
def test_config_refuses_the_kernels_on_cpu(knobs):
    with pytest.raises(ValueError, match="device='cuda'"):
        tpresets.brax_ppo.replace(device="cpu", **knobs)
    with pytest.raises(ValueError, match="device='cuda'"):
        make_agent(tpresets.brax_ppo, device="cpu", num_envs=8, unroll_len=4, **knobs)


CU = (Path(ls.__file__).resolve().parents[1] / "csrc" / "linear_scan.cu").read_text()


def _cu_int(pattern: str) -> int:
    return int(re.search(pattern, CU).group(1))


SCAN_ROWS = _cu_int(r"constexpr int kRows = (\d+);")
DMA_COLS = _cu_int(r"constexpr int kDmaCols = (\d+);")
DMA_ROWS = _cu_int(r"constexpr int kDmaRows = (\d+);")
STAGES = _cu_int(r"constexpr int kStages = (\d+);")
PITCH = DMA_COLS + _cu_int(r"constexpr int kPitch = kDmaCols \+ (\d+);")


def _aligned_span(lead, width):
    """Floats [j0, j1) of a segment of ``width`` floats that starts ``lead``
    floats past the 16-byte grid lie on whole 16-byte granules."""
    j0 = np.minimum((4 - lead) & 3, width)
    return j0, j0 + ((width - j0) & ~3)


def _dma_chunks(T):
    """(k, stage, phase, lo, rows) of each chunk, in the order walked."""
    chunks = -(-T // DMA_ROWS)
    for k in range(chunks):
        lo = (chunks - 1 - k) * DMA_ROWS
        yield k, k % STAGES, (k // STAGES) & 1, lo, min(DMA_ROWS, T - lo)


def _fma_walk(ra, rb, x, rows):
    """The chain over a chunk's rows held as [..., R] registers, from the top."""
    xs = {}
    for r in range(rows - 1, -1, -1):
        x = fma_f32(torch.from_numpy(ra[..., r]), x, torch.from_numpy(rb[..., r]))
        xs[r] = x.numpy()
    return x, xs


def _dma_run(a, b, off_a, off_b):
    """``linear_scan_dma`` on [T, N] float32 ``a`` and ``b`` whose base
    pointers lie ``off_a`` and ``off_b`` floats past the 16-byte grid: the
    producer's copies into a shared memory that is poisoned with NaN before
    every chunk, the consumers' edge loads and reads, and the walk. Asserts
    the plan's facts on the way; returns x and how often each element of a
    and of b was moved."""
    T, N = a.shape
    tiles = N % 4 == 0 and off_a % 4 == 0 and off_b % 4 == 0
    nb = -(-N // DMA_COLS)
    c0 = np.arange(nb) * DMA_COLS
    width = np.minimum(DMA_COLS, N - c0)
    jj = np.arange(DMA_COLS)
    live = jj[None, :] < width[:, None]
    live_bi, live_ji = np.nonzero(live)
    cols = np.minimum(c0[:, None] + jj[None, :], N - 1)
    step = N & 3
    moved = {"a": np.zeros((T, N), np.int64), "b": np.zeros((T, N), np.int64)}
    smem = {name: np.empty((nb, STAGES, DMA_ROWS * PITCH), np.float32) for name in "ab"}
    x = torch.from_numpy(np.where(live, a[0][cols] * np.float32(0), np.float32(0)))
    out = np.full((T, N), np.nan, np.float32)
    walked, phases = [], {}
    for k, s, phase, lo, rows in _dma_chunks(T):
        # The stage's phase bit flips on each reuse; before refilling it the
        # producer waits for the parity of the previous use's release.
        if s in phases:
            assert phase == 1 - phases[s] == ((k // STAGES - 1) & 1) ^ 1
        phases[s] = phase
        regs = {}
        expected = np.zeros(nb, np.int64)  # the full barrier's bytes, per block
        landed = np.zeros(nb, np.int64)    # bytes the copies write
        for name, arr, off in (("a", a, off_a), ("b", b, off_b)):
            stage = smem[name][:, s]
            stage[:] = np.nan
            reg = np.full((nb, DMA_COLS, DMA_ROWS), np.nan, np.float32)
            if tiles:
                # One [DMA_ROWS, DMA_COLS] tensor-map box at (lo, c0): global
                # base and row stride on the 16-byte grid, the shared tile on
                # the 128-byte grid, rows DMA_COLS floats apart; zeros past T
                # and N, which count in the bytes.
                assert (4 * off) % 16 == 0 and (4 * N) % 16 == 0
                assert (4 * s * DMA_ROWS * PITCH) % 128 == 0 and DMA_COLS <= PITCH
                for r in range(DMA_ROWS):
                    inside = live & (lo + r < T)
                    row = arr[min(lo + r, T - 1)][cols]
                    stage[:, r * DMA_COLS + jj] = np.where(inside, row, np.float32(0))
                    if lo + r < T:
                        bi, ji = np.nonzero(inside)
                        moved[name][lo + r, c0[bi] + ji] += 1
                    reg[:, :, r] = stage[:, r * DMA_COLS + jj]
                expected += 4 * DMA_ROWS * DMA_COLS
                landed += 4 * DMA_ROWS * DMA_COLS
            else:
                for r in range(DMA_ROWS):
                    t = lo + r
                    # Row r of every stage: lead from the kernel's formula, the
                    # same as the row's address mod 16 bytes (chunks start on
                    # a multiple of 4 rows).
                    lead = (off % 4 + r * step) & 3
                    assert lead == (off + t * N) % 4
                    j0, j1 = _aligned_span(lead, width)
                    copy = (jj[None, :] >= j0[:, None]) & (jj[None, :] < j1[:, None])
                    edge = live & ~copy
                    if r < rows:
                        row = arr[t][cols]
                        size = 4 * (j1 - j0)
                        some = size > 0
                        assert (4 * (off + t * N + c0[some] + j0[some]) % 16 == 0).all()
                        dst = 4 * (s * DMA_ROWS * PITCH + r * PITCH + lead + j0[some])
                        assert (dst % 16 == 0).all() and (size % 16 == 0).all()
                        assert (lead + j1 <= PITCH).all() and lead + DMA_COLS <= PITCH
                        expected += size
                        bi, ji = np.nonzero(copy)
                        stage[bi, r * PITCH + lead + ji] = row[bi, ji]
                        moved[name][t, c0[bi] + ji] += 1
                        landed += np.bincount(bi, minlength=nb) * 4
                        # The edge floats: each loaded by the thread that owns it.
                        bi, ji = np.nonzero(edge)
                        reg[bi, ji, r] = row[bi, ji]
                        moved[name][t, c0[bi] + ji] += 1
                    read = ~edge
                    reg[:, :, r] = np.where(read, stage[:, r * PITCH + lead + jj], reg[:, :, r])
            regs[name] = reg
        assert (expected == landed).all()
        x, xs = _fma_walk(regs["a"], regs["b"], x, rows)
        for r in range(rows - 1, -1, -1):
            out[lo + r, c0[live_bi] + live_ji] = xs[r][live_bi, live_ji]
            walked.append(lo + r)
    assert walked == list(range(T - 1, -1, -1))
    return out, moved


# Every T against every N but the two largest products (257 rows of 8192
# and 8193 columns), which would double the file's time; in their place
# 257 rows of 1004 and 2052 columns: several stages of tiles over many
# blocks, the last block partial.
PLAN_SHAPES = [
    (T, N) for T in (1, 15, 16, 17, 64, 257) for N in (1, 3, 4, 7, 1001, 8192, 8193)
    if T * N <= 64 * 8193
] + [(257, 1004), (257, 2052)]


@pytest.mark.parametrize("T, N", PLAN_SHAPES)
def test_dma_copy_plan_moves_each_element_once_and_walks_to_plain(T, N):
    """B3's plan at base pointers 0-3 floats off the 16-byte grid (tensor-map
    tiles where every row is on the grid, row copies and edge loads
    elsewhere): every element of a and b moved exactly once, each stage's
    expected bytes equal to what its copies write, every copy on the 16-byte
    grid within its pitch, rows walked T-1 .. 0, phases flipping on reuse,
    and x bit-identical to the plain version."""
    a, b = scan_inputs((T, N), seed=T * 8209 + N)
    ref = ls.linear_scan_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for off_a, off_b in ((0, 0), (1, 2), (2, 3), (3, 1)):
        out, moved = _dma_run(a, b, off_a, off_b)
        assert (moved["a"] == 1).all() and (moved["b"] == 1).all()
        np.testing.assert_array_equal(out, ref)


def _scan_schedule(T):
    """``linear_scan``'s register batches in issue order, as its loop runs:
    ("load" or "walk", buffer, chunk); chunk c holds rows
    [c*SCAN_ROWS, min(c*SCAN_ROWS + SCAN_ROWS, T))."""
    c = -(-T // SCAN_ROWS) - 1
    events = [("load", 0, c)]
    while True:
        if c >= 1:
            events.append(("load", 1, c - 1))
        events.append(("walk", 0, c))
        if c == 0:
            break
        if c >= 2:
            events.append(("load", 0, c - 2))
        events.append(("walk", 1, c - 1))
        if c == 1:
            break
        c -= 2
    return events


@pytest.mark.parametrize("T", [1, 15, 16, 17, 31, 32, 33, 64, 65, 96, 257])
def test_scan_register_batches_prefetch_and_walk_to_plain(T):
    """B2's schedule: every chunk loaded once, into a buffer that nothing
    overwrites before it is walked from it; the next chunk's loads issued
    before this chunk's walk; rows walked T-1 .. 0, only the first chunk
    partial; x bit-identical to the plain version."""
    a, b = scan_inputs((T, 5), seed=T)
    held, loaded, walked_rows = {}, set(), []
    x = torch.from_numpy(a[0] * np.float32(0))
    out = np.empty_like(a)
    events = _scan_schedule(T)
    for i, (kind, buf, c) in enumerate(events):
        lo, hi = c * SCAN_ROWS, min(c * SCAN_ROWS + SCAN_ROWS, T)
        if kind == "load":
            assert c not in loaded and buf not in held
            loaded.add(c)
            held[buf] = (c, a[lo:hi].T.copy(), b[lo:hi].T.copy())
            continue
        held_c, ra, rb = held.pop(buf)
        assert held_c == c
        if c >= 1:
            assert ("load", 1 - buf, c - 1) in events[:i]
        assert (hi - lo == SCAN_ROWS) or not walked_rows
        x, xs = _fma_walk(ra, rb, x, hi - lo)
        for r in range(hi - lo - 1, -1, -1):
            out[lo + r] = xs[r]
            walked_rows.append(lo + r)
    assert not held and walked_rows == list(range(T - 1, -1, -1))
    ref = ls.linear_scan_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(out, ref)
