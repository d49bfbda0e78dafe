"""The port's GAE, n-step returns, lax-path V-trace and A3C and PPO losses
against the JAX package's.

GAE is exact arithmetic on both sides but for one fused multiply-add a step,
so both of its paths are held to JAX bit for bit on f32 inputs: the fused
one (the V-trace tail with unit weights) to ``gae(fused="interpret")``, the
lax one to ``gae(fused="lax", scan_impl="sequential")``. The lax V-trace
adds the exp/clip prologue, where PyTorch's ``exp`` and XLA's may differ in
the last ulp, so it is held to rtol 1e-5 of its scale as the fused path is
(``test_torch_fused_vtrace.py``). The PPO loss takes logs and exps and
means over the batch: 1e-5 relative, 1e-6 absolute, for the loss, its
metrics and its gradients. n-step returns are held to JAX bit for bit as
GAE is (the fused tail with unit weights and zero values to
``n_step_returns(fused="interpret")``, the sequential scan to JAX's), but
for the associative scan, whose two packages combine in different orders
(rtol 1e-5 / atol 1e-5, as ``tests/test_torch_scan.py``). The A3C loss
takes logs and exps and means over the batch, and its returns ride the
associative scan: 1e-5 relative, 1e-6 absolute, for the loss, its metrics
and its gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asyncrl_tpu.ops.distributions import Categorical as JCategorical
from asyncrl_tpu.ops.distributions import DiagGaussian as JDiagGaussian
from asyncrl_tpu.ops.gae import gae as jgae
from asyncrl_tpu.ops.gae import n_step_returns as jn_step_returns
from asyncrl_tpu.ops.losses import a3c_loss as ja3c_loss
from asyncrl_tpu.ops.losses import ppo_loss as jppo_loss
from asyncrl_tpu.ops.vtrace import vtrace as jvtrace
from asyncrl_tpu_torch.ops.distributions import Categorical, DiagGaussian
from asyncrl_tpu_torch.ops.gae import gae, n_step_returns
from asyncrl_tpu_torch.ops.losses import a3c_loss, ppo_loss
from asyncrl_tpu_torch.ops.vtrace import vtrace


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one CPU thread, as in the port's other comparisons."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fragment(T, B, seed):
    """(rewards, discounts, values, bootstrap), numpy f32, with episode
    ends (zero discounts) scattered in."""
    rng = np.random.default_rng(seed)
    disc = (0.95 * (rng.random((T, B)) > 0.1)).astype(np.float32)
    return (
        rng.standard_normal((T, B)).astype(np.float32),
        disc,
        rng.standard_normal((T, B)).astype(np.float32),
        rng.standard_normal(B).astype(np.float32),
    )


SHAPES = [(64, 512), (37, 130), (1, 5)]


@pytest.mark.parametrize("T,B", SHAPES)
@pytest.mark.parametrize("path", ["fused", "lax"])
def test_gae_is_bit_identical_to_jax(T, B, path):
    args = fragment(T, B, seed=T * 31 + B)
    if path == "fused":
        ref = jax.jit(lambda *a: jgae(*a, 0.95, fused="interpret"))(*args)
        out = gae(*map(torch.from_numpy, args), 0.95, fused="plain")
    else:
        ref = jax.jit(lambda *a: jgae(*a, 0.95, scan_impl="sequential", fused="lax"))(*args)
        out = gae(*map(torch.from_numpy, args), 0.95, scan_impl="sequential", fused="lax")
    for name in ("advantages", "returns"):
        np.testing.assert_array_equal(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )


@pytest.mark.parametrize("T,B", [(37, 130), (64, 512)])
def test_gae_paths_agree(T, B):
    """Every path of the port gives the sequential bits, but the
    associative scan, which is within rounding of them."""
    args = [torch.from_numpy(x) for x in fragment(T, B, seed=5)]
    ref = gae(*args, 0.9, scan_impl="sequential", fused="lax")
    for kw in ({"fused": "plain"}, {"fused": "auto"}, {"fused": "lax", "scan_impl": "kernel"},
               {"fused": "lax", "scan_impl": "kernel_dma"}):
        out = gae(*args, 0.9, **kw)
        assert torch.equal(out.advantages, ref.advantages), kw
        assert torch.equal(out.returns, ref.returns), kw
    assoc = gae(*args, 0.9, scan_impl="associative", fused="lax")
    torch.testing.assert_close(assoc.advantages, ref.advantages, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,B", [(32, 256), (37, 130)])
def test_lax_vtrace_matches_jax(T, B):
    rng = np.random.default_rng(T + B)
    blogp = (-1.5 + 0.5 * rng.standard_normal((T, B))).astype(np.float32)
    tlogp = (blogp + 0.4 * rng.standard_normal((T, B))).astype(np.float32)
    rewards, disc, values, boot = fragment(T, B, seed=B)
    args = (blogp, tlogp, rewards, disc, values, boot)
    ref = jax.jit(lambda *a: jvtrace(*a, scan_impl="sequential", fused="lax"))(*args)
    out = vtrace(*map(torch.from_numpy, args), fused="lax", scan_impl="sequential")
    for name in ("vs", "pg_advantages"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(
            getattr(out, name).numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max(), err_msg=name
        )
    for name in ("rho_clip_frac", "c_clip_frac"):
        assert abs(float(getattr(out, name)) - float(getattr(ref, name))) <= 1.0 / (T * B)
    # The lax path with the kernel scans (their plain version on the CPU)
    # gives the same bits as the sequential lax path.
    targs = [torch.from_numpy(x) for x in args]
    for kw in ({"fused": "lax", "scan_impl": "kernel"}, {"fused": "lax", "scan_impl": "kernel_dma"}):
        other = vtrace(*targs, **kw)
        assert torch.equal(other.vs, out.vs) and torch.equal(other.pg_advantages, out.pg_advantages)


def ppo_batch(dist_name, n, seed):
    rng = np.random.default_rng(seed)
    if dist_name == "categorical":
        params = rng.standard_normal((n, 4)).astype(np.float32)
        actions = rng.integers(0, 4, n).astype(np.int64)
    else:
        mean = rng.standard_normal((n, 2))
        log_std = np.broadcast_to(0.3 * rng.standard_normal(2), (n, 2))
        params = np.concatenate([mean, log_std], -1).astype(np.float32)
        actions = rng.standard_normal((n, 2)).astype(np.float32)
    return {
        "params": params,
        "values": rng.standard_normal(n).astype(np.float32),
        "actions": actions,
        "behaviour_logp": (-1.4 + 0.3 * rng.standard_normal(n)).astype(np.float32),
        "advantages": (0.5 + 2.0 * rng.standard_normal(n)).astype(np.float32),
        "returns": rng.standard_normal(n).astype(np.float32),
    }


@pytest.mark.parametrize("dist_name", ["categorical", "gaussian"])
def test_ppo_loss_matches_jax(dist_name):
    batch = ppo_batch(dist_name, 512, seed=11)
    jdist = JCategorical(4) if dist_name == "categorical" else JDiagGaussian(2)
    tdist = Categorical(4) if dist_name == "categorical" else DiagGaussian(2)
    kw = dict(clip_eps=0.2, value_coef=0.5, entropy_coef=0.01)

    def jloss(params, values):
        loss, metrics = jppo_loss(
            params, values, batch["actions"], batch["behaviour_logp"], batch["advantages"],
            batch["returns"], dist=jdist, diagnostics=True, **kw,
        )
        return loss, metrics

    (jl, jm), (jg_params, jg_values) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(batch["params"]), jnp.asarray(batch["values"]))
    params = torch.from_numpy(batch["params"]).requires_grad_()
    values = torch.from_numpy(batch["values"]).requires_grad_()
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = ppo_loss(
        params, values, t["actions"], t["behaviour_logp"], t["advantages"], t["returns"],
        tdist, diagnostics=True, **kw,
    )
    g_params, g_values = torch.autograd.grad(loss, [params, values])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, atol=1e-6)
    assert set(metrics) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    for g, jg in ((g_params, jg_params), (g_values, jg_values)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    assert 0.0 < float(metrics["clip_frac"]) < 1.0


def returns_fragment(T, B, seed, terminal_share=0.1):
    """(rewards, discounts, bootstrap), numpy f32; ``terminal_share`` of the
    discounts are episode ends (0)."""
    rewards, _, _, boot = fragment(T, B, seed)
    rng = np.random.default_rng(seed + 1)
    disc = (0.99 * (rng.random((T, B)) >= terminal_share)).astype(np.float32)
    return rewards, disc, boot


RETURN_CASES = [(64, 512, 0.1), (37, 130, 0.1), (1, 5, 0.1), (32, 64, 0.6)]


@pytest.mark.parametrize("T,B,terminal_share", RETURN_CASES)
@pytest.mark.parametrize("path", ["plain", "sequential", "associative"])
def test_n_step_returns_match_jax(T, B, terminal_share, path):
    args = returns_fragment(T, B, seed=T * 17 + B, terminal_share=terminal_share)
    targs = [torch.from_numpy(x) for x in args]
    if path == "plain":
        ref = jax.jit(lambda *a: jn_step_returns(*a, fused="interpret"))(*args)
        out = n_step_returns(*targs, fused="plain")
    else:
        ref = jax.jit(lambda *a: jn_step_returns(*a, scan_impl=path, fused="lax"))(*args)
        out = n_step_returns(*targs, scan_impl=path, fused="lax")
    assert out.dtype == torch.float32 and out.shape == (T, B) and not out.requires_grad
    if path == "associative":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("T,B,terminal_share", RETURN_CASES)
def test_n_step_returns_paths_agree(T, B, terminal_share):
    """The fused tail (its plain version, and "auto" on CPU tensors) and the
    kernel scans' plain version give the sequential scan's bits."""
    args = [torch.from_numpy(x) for x in returns_fragment(T, B, seed=B, terminal_share=terminal_share)]
    ref = n_step_returns(*args, scan_impl="sequential", fused="lax")
    for kw in ({"fused": "plain"}, {"fused": "auto"}, {"fused": "lax", "scan_impl": "kernel"},
               {"fused": "lax", "scan_impl": "kernel_dma"}):
        assert torch.equal(n_step_returns(*args, **kw), ref), kw
    with pytest.raises(ValueError):
        n_step_returns(*args, fused="kernel")  # the kernel needs CUDA tensors
    with pytest.raises(ValueError):
        n_step_returns(*args, fused="interpret")


def loss_fixture(T=6, B=4, A=3, seed=0, terminal_share=0.0):
    """The fixture of tests/test_losses.py (``rand``), optionally with
    episode ends among the discounts."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T, B, A)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    actions = rng.integers(0, A, (T, B)).astype(np.int32)
    rng.normal(-1.0, 0.3, (T, B))  # the behaviour log-probs A3C does not use
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    discounts = np.full((T, B), 0.99, np.float32)
    discounts[rng.random((T, B)) < terminal_share] = 0.0
    bootstrap = rng.normal(size=(B,)).astype(np.float32)
    return logits, values, actions, rewards, discounts, bootstrap


@pytest.mark.parametrize("case", [
    {}, {"T": 37, "B": 130, "A": 6, "seed": 3, "terminal_share": 0.2},
], ids=["test_losses_rand", "long_terminal"])
def test_a3c_loss_matches_jax(case):
    logits, values, actions, rewards, discounts, boot = loss_fixture(**case)
    kw = dict(value_coef=0.5, entropy_coef=0.01)
    A = logits.shape[-1]

    def jloss(lg, v):
        return ja3c_loss(lg, v, actions, rewards, discounts, boot, dist=JCategorical(A),
                         diagnostics=True, **kw)

    (jl, jm), (jg_lg, jg_v) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(logits), jnp.asarray(values))
    lg = torch.from_numpy(logits).requires_grad_()
    v = torch.from_numpy(values).requires_grad_()
    loss, metrics = a3c_loss(
        lg, v, torch.from_numpy(actions).long(), torch.from_numpy(rewards),
        torch.from_numpy(discounts), torch.from_numpy(boot), dist=Categorical(A),
        diagnostics=True, **kw,
    )
    g_lg, g_v = torch.autograd.grad(loss, [lg, v])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5, atol=1e-6)
    assert set(metrics) == set(jm)
    for k, val in jm.items():
        np.testing.assert_allclose(float(metrics[k]), float(val), rtol=1e-5, atol=1e-6, err_msg=k)
    for g, jg in ((g_lg, jg_lg), (g_v, jg_v)):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
