"""The port's fused V-trace tail and ``vtrace`` against the JAX package.

The plain version must equal ``fused_vtrace_pallas`` run in the Pallas
interpreter bit for bit: both round the recurrence once as a fused
multiply-add and every other product on its own. ``vtrace`` adds the
exp/clip prologue, where PyTorch's ``exp`` and XLA's may differ in the last
ulp; 2 f32 ulps on each rho (rtol 3e-7) compound through at most T steps of
the recurrence, so the outputs are held to rtol 1e-5 of their scale. The
CUDA kernel's chunked, three-phase order of the same operations is written
out in numpy and held to the plain version bit for bit.
"""

import numpy as np
import pytest
import torch

from asyncrl_tpu.ops.pallas_scan import fused_vtrace_pallas
from asyncrl_tpu.ops.vtrace import vtrace as jvtrace
from asyncrl_tpu_torch.ops import fused_vtrace as fv
from asyncrl_tpu_torch.ops.vtrace import vtrace
from asyncrl_tpu_torch.utils.numerics import fma_f32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one CPU thread for these comparisons. Its multithreaded CPU
    ``exp`` has been seen to return one worker's chunk about 1.5e-4 off on
    the first parallel call of a process that had run XLA jobs before; one
    thread computes every element the same way."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tail_inputs(T, B, seed):
    """(clipped rhos, scan coeffs, rewards, discounts, values, bootstrap),
    numpy f32, with episode ends (zero discounts) scattered in."""
    rng = np.random.default_rng(seed)
    rhos = np.exp(0.6 * rng.standard_normal((T, B))).astype(np.float32)
    disc = (0.99 * (rng.random((T, B)) > 0.1)).astype(np.float32)
    return (
        np.minimum(np.float32(1.0), rhos),
        disc * np.minimum(np.float32(1.0), rhos),
        rng.standard_normal((T, B)).astype(np.float32),
        disc,
        rng.standard_normal((T, B)).astype(np.float32),
        rng.standard_normal(B).astype(np.float32),
    )


@pytest.mark.parametrize("T,B", [(32, 256), (37, 130), (1, 1), (8, 3)])
def test_plain_is_bit_identical_to_pallas_interpret(T, B):
    args = tail_inputs(T, B, seed=T * 1000 + B)
    ref = fused_vtrace_pallas(*args, interpret=True)
    out = fv.fused_vtrace(*map(torch.from_numpy, args))
    for name, r, o in zip(("vs", "vs_minus_v", "pg"), ref, out):
        r = np.asarray(r)
        assert o.dtype == torch.float32 and o.shape == r.shape
        assert np.array_equal(o.numpy(), r), f"{name}: {int((o.numpy() != r).sum())} differ"


def _staged_tail(crho, coeff, rew, disc, val, boot, rows=32):
    """The CUDA kernel's schedule in numpy float32: time chunks of ``rows``
    steps from the end; per chunk delta for every step, then the recurrence
    alone, then vs, vs - V and pg, with vs_{t+1} recomputed as
    x_{t+1} + V_{t+1}; V, vs and x carried from chunk to chunk."""
    f32 = np.float32
    T = rew.shape[0]
    vs, adv, pg = (np.empty_like(rew) for _ in range(3))
    x = boot * f32(0)
    v_next = vs_next = boot
    for hi in range(T, 0, -rows):
        lo = max(hi - rows, 0)
        v_below = np.concatenate([val[lo + 1:hi], v_next[None]])
        delta = crho[lo:hi] * ((rew[lo:hi] + disc[lo:hi] * v_below) - val[lo:hi])
        xs = np.empty_like(delta)
        for t in range(hi - lo - 1, -1, -1):
            x = fma_f32(*map(torch.from_numpy, (coeff[lo + t], x, delta[t]))).numpy()
            xs[t] = x
        s = xs + val[lo:hi]
        vs_below = np.concatenate([xs[1:] + val[lo + 1:hi], vs_next[None]])
        vs[lo:hi], adv[lo:hi] = s, xs
        pg[lo:hi] = crho[lo:hi] * ((rew[lo:hi] + disc[lo:hi] * vs_below) - val[lo:hi])
        v_next, vs_next = val[lo], s[0]
    return vs, adv, pg


@pytest.mark.parametrize("T,B", [(257, 1001), (37, 1000), (64, 130), (32, 32), (1, 3)])
def test_staged_schedule_is_bit_identical_to_plain(T, B):
    """The kernel's chunked, three-phase order of the same operations gives
    the plain version's bits, at a T longer than one chunk too."""
    args = tail_inputs(T, B, seed=T * 31 + B)
    ref = fv.fused_vtrace_plain(*map(torch.from_numpy, args))
    for name, r, o in zip(("vs", "vs_minus_v", "pg"), ref, _staged_tail(*args)):
        assert o.dtype == np.float32
        assert np.array_equal(o, r.numpy()), f"{name}: {int((o != r.numpy()).sum())} differ"


def test_fma_rounds_once():
    """fma_f32 is the correctly rounded a * b + c, where a product rounded
    first, then added, differs."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(20000).astype(np.float32) for _ in range(3))
    exact = a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
    got = fma_f32(*map(torch.from_numpy, (a, b, c))).numpy()
    # float64 holds a*b exactly; its sum is off by at most 2^-53 relative,
    # far inside the f32 half-ulp, so rounding it is correct but for ties.
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    unfused = a * b + c
    assert (unfused != got).any()


@pytest.mark.parametrize("T,B", [(32, 256), (37, 130)])
def test_vtrace_matches_jax_fused(T, B):
    rng = np.random.default_rng(T + B)
    blogp = (-np.abs(rng.standard_normal((T, B))) - 1.0).astype(np.float32)
    tlogp = (blogp + 0.5 * rng.standard_normal((T, B))).astype(np.float32)
    _, _, rew, disc, val, boot = tail_inputs(T, B, seed=3)
    ref = jvtrace(blogp, tlogp, rew, disc, val, boot, rho_clip=1.0, c_clip=0.9,
                  fused="interpret")
    out = vtrace(*map(torch.from_numpy, (blogp, tlogp, rew, disc, val, boot)),
                 rho_clip=1.0, c_clip=0.9, fused="auto")
    for name in ("vs", "pg_advantages"):
        r, o = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5 * np.abs(r).max(), err_msg=name)
    # The clip fractions count rhos against the caps; a 1-ulp exp
    # difference can move at most a rho sitting on a cap.
    for name in ("rho_clip_frac", "c_clip_frac"):
        assert abs(float(getattr(out, name)) - float(getattr(ref, name))) <= 1.0 / (T * B)


def test_cpu_dispatch_uses_plain_and_counts_no_launch():
    args = tuple(map(torch.from_numpy, tail_inputs(5, 7, seed=1)))
    before = fv.launches
    out = fv.fused_vtrace(*args)
    ref = fv.fused_vtrace_plain(*args)
    assert fv.launches == before
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    with pytest.raises(ValueError):
        vtrace(*(torch.zeros(3, 2),) * 5, torch.zeros(2), fused="kernel")


def test_wrapper_checks_inputs():
    good = tuple(map(torch.from_numpy, tail_inputs(4, 3, seed=2)))
    with pytest.raises(TypeError):
        fv.fused_vtrace(*(x.double() for x in good))
    with pytest.raises(ValueError):
        fv.fused_vtrace(*good[:5], torch.zeros(4))
    with pytest.raises(ValueError):
        fv.fused_vtrace(good[0].t().contiguous().t(), *good[1:])
    with pytest.raises(ValueError):
        fv.fused_vtrace(*(x.requires_grad_() for x in (g.clone() for g in good)))


def test_make_agent_on_cuda_raises_without_a_gpu():
    """The entry point runs on CUDA unless told otherwise, and never falls
    back to the CPU. (This test's CPU-only environment has no GPU.)"""
    from asyncrl_tpu_torch import make_agent
    from asyncrl_tpu_torch.configs import presets

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA path is chip_smoke.py's to drive")
    with pytest.raises(RuntimeError, match="cuda"):
        make_agent(presets.pong_impala, num_envs=2, unroll_len=2)
    with pytest.raises(RuntimeError, match="cuda"):
        make_agent(presets.pong_impala.replace(num_envs=2, unroll_len=2, device="cuda"))
