"""The port's ring all-reduce (``asyncrl_tpu_torch/ops/ring_reduce.py``)
against JAX's, on the CPU.

JAX's ``ring_all_reduce_lax`` runs under a jitted ``shard_map`` on the forced
host devices (tests/conftest.py), as tests/test_ring_reduce.py runs it: one
call per ring size n reduces every payload size D at once. The Pallas kernel
``ring_all_reduce_pallas`` does not run here (its remote copies have no
interpret path on the CPU, and the JAX package's own tests do not run it
either); the JAX module documents the lax twin as bit-identical to it.

Bars: the port's plain version equals the lax twin bit for bit (same
schedule, same fold order); its rows are the same bits for every rank; at
n=2 it is the two-operand sum; against a plain sum it is within the float
fold bound (n-1) * eps * sum|x| elementwise (tests/test_ring_reduce.py's).
The CUDA kernel's arithmetic, one pass that folds each element's ranks in
the ring's order, is written out in numpy and held to the lax twin and the
plain version bit for bit; the kernel itself is held to the plain version
on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from asyncrl_tpu.ops import ring_reduce as jring
from asyncrl_tpu.parallel.mesh import make_mesh, shard_map
from asyncrl_tpu_torch.ops import ring_reduce as rr

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 forced host devices")

NS = (2, 4, 8)
DS = (7, 1031, 8192)  # below one tile, ragged, a whole number of tiles
# The gradient sizes of the two mesh phases of chip_smoke.py: pong_impala's
# ActorCritic (MLP 6-256-256, 6 actions) and atari_impala's (IMPALA-CNN
# (16, 32, 32) + Dense 3872-256).
GRAD_DS = (69_383, 1_091_031)
EPS = np.finfo(np.float32).eps
GRAD_SHAPES = [(5, 3), (3,), (7,), (2, 2, 2)]


def _vals(n: int, d: int) -> np.ndarray:
    return np.random.default_rng(1000 * n + d).standard_normal((n, d)).astype(np.float32)


def _grads(n: int) -> list[list[np.ndarray]]:
    rng = np.random.default_rng(n)
    return [[rng.standard_normal(s).astype(np.float32) for s in GRAD_SHAPES] for _ in range(n)]


@pytest.fixture(scope="module")
def jax_rings():
    """JAX's lax ring of ``_vals(n, d)`` for every (n, d), and JAX's
    ``ring_all_reduce_grads`` of ``_grads(n)``: one jitted shard_map per n."""
    out = {}
    for n in NS:
        mesh = make_mesh((n,), ("dp",), devices=jax.devices()[:n])

        def body(grads, *xs):
            rings = tuple(jring.ring_all_reduce_lax(x[0], "dp")[None] for x in xs)
            reduced = jring.ring_all_reduce_grads([g[0] for g in grads], "dp")
            return [g[None] for g in reduced], *rings

        specs = (P("dp"),) * len(DS)
        per_leaf = [np.stack(leaves) for leaves in zip(*_grads(n))]
        grads, *rings = jax.jit(shard_map(
            body, mesh=mesh, in_specs=([P("dp")] * len(GRAD_SHAPES), *specs),
            out_specs=([P("dp")] * len(GRAD_SHAPES), *specs),
        ))(per_leaf, *(_vals(n, d) for d in DS))
        out.update({(n, d): np.asarray(r) for d, r in zip(DS, rings)})
        out[(n, "grads")] = [np.asarray(g) for g in grads]
    return out


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_plain_is_bit_identical_to_jax_lax_ring(jax_rings, n, d):
    got = rr.ring_all_reduce_plain(torch.from_numpy(_vals(n, d)))
    np.testing.assert_array_equal(got.numpy(), jax_rings[(n, d)])


def _one_pass_fold(x: np.ndarray) -> np.ndarray:
    """The CUDA kernel's arithmetic in numpy: element i of direction
    i // (n*chunk) and chunk (i // chunk) % n starts from rank c's value and
    adds ranks c+sign, c+2*sign, ... in that order, one float32 add each
    (sign +1 for direction 0, -1 for 1; chunk = S*128 of the JAX geometry)."""
    n, d = x.shape
    sublanes = max(8, -(-(-(-d // (2 * n * 128))) // 8) * 8)
    chunk = sublanes * 128
    i = np.arange(d)
    c = (i // chunk) % n
    sign = np.where(i // (n * chunk) == 0, 1, -1)
    acc = x[c, i]
    for k in range(1, n):
        acc = x[(c + k * sign) % n, i] + acc
        assert acc.dtype == np.float32
    return acc


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_one_pass_fold_is_bit_identical_to_jax_lax_ring(jax_rings, n, d):
    """The kernel's one-pass fold gives every rank the lax ring's bits."""
    fold = _one_pass_fold(_vals(n, d))
    for rank in range(n):
        np.testing.assert_array_equal(fold, jax_rings[(n, d)][rank])


@pytest.mark.parametrize("d", GRAD_DS)
@pytest.mark.parametrize("n", NS)
def test_one_pass_fold_is_bit_identical_to_plain_ring(n, d):
    """At the mesh phases' gradient sizes, against the plain ring."""
    x = _vals(n, d)
    ref = rr.ring_all_reduce_plain(torch.from_numpy(x)).numpy()
    fold = _one_pass_fold(x)
    for rank in range(n):
        np.testing.assert_array_equal(fold, ref[rank])


def _short_storage() -> torch.Tensor:
    """Rows 1032 floats apart whose storage ends right after the last
    row's 1031st float."""
    return torch.zeros(3 * 1032 + 1031).as_strided((4, 1031), (1032, 1))


@pytest.mark.parametrize("make,vector", [
    (lambda: torch.zeros(8, 1092)[:, :1091], True),
    (lambda: torch.zeros(4, 1032), True),
    (lambda: torch.zeros(8, 1091), False),
    (lambda: torch.zeros(4, 1036)[:, 1:1033], False),
    (_short_storage, False),
    (lambda: torch.zeros(1031).expand(4, 1031), False),
], ids=["stride-rounded", "contiguous-4", "odd-stride", "off-grid-start", "short-storage",
        "broadcast-rows"])
def test_16_byte_loads_only_where_every_row_can_take_them(make, vector):
    assert rr._vector_rows(make()) is vector


def test_grads_are_laid_out_for_16_byte_loads(monkeypatch):
    """``ring_all_reduce_grads`` writes the ranks' flattened lists into
    one buffer whose rows the kernel reads with 16-byte loads, even at an
    odd D (33 floats here)."""
    seen = []
    real = rr.ring_all_reduce
    monkeypatch.setattr(rr, "ring_all_reduce", lambda x: seen.append(x) or real(x))
    rr.ring_all_reduce_grads([[torch.from_numpy(g) for g in grads] for grads in _grads(4)])
    (stacked,) = seen
    assert stacked.shape == (4, 33) and stacked.stride() == (36, 1)
    assert rr._vector_rows(stacked)


@pytest.mark.parametrize("n", NS)
def test_grads_match_jax_ring_all_reduce_grads(jax_rings, n):
    per_rank = [[torch.from_numpy(g) for g in grads] for grads in _grads(n)]
    reduced = rr.ring_all_reduce_grads(per_rank)
    assert len(reduced) == n
    for leaf, ref in enumerate(jax_rings[(n, "grads")]):
        for rank in range(n):
            assert reduced[rank][leaf].shape == GRAD_SHAPES[leaf]
            np.testing.assert_array_equal(reduced[rank][leaf].numpy(), ref[rank])


@pytest.mark.parametrize("d", DS + GRAD_DS)
@pytest.mark.parametrize("n", NS)
def test_chunks_have_the_jax_geometry(n, d):
    flat = _vals(1, d)[0]
    ref = np.asarray(jring._to_chunks(jnp.asarray(flat), n))
    got = rr._to_chunks(torch.from_numpy(flat), n)
    assert tuple(got.shape) == ref.shape
    assert got.shape[2] % 8 == 0 and got.shape[2] >= 8
    np.testing.assert_array_equal(got.numpy(), ref)
    # The kernel's 512-float tiles never straddle a chunk.
    assert rr._chunk(d, n) == got.shape[-2:].numel() and rr._chunk(d, n) % 1024 == 0


def test_flagship_chunks_exceed_the_pallas_vmem_budget():
    """atari_impala's gradient needs 536 sublanes a chunk at n=8 and 2136 at
    n=2, above the Pallas kernel's 512; the port keeps chunks in device
    memory and takes any size."""
    flat = torch.zeros(GRAD_DS[1])
    assert rr._to_chunks(flat, 8).shape == (2, 8, 536, 128)
    assert rr._to_chunks(flat, 2).shape == (2, 2, 2136, 128)
    assert jring._MAX_SUBLANES == 512


@pytest.mark.parametrize("d", DS)
def test_two_ranks_are_the_two_operand_sum(d):
    x = torch.from_numpy(_vals(2, d))
    out = rr.ring_all_reduce(x)
    for row in out:
        assert torch.equal(row, x[0] + x[1])


@pytest.mark.parametrize("n", NS)
def test_ranks_agree_bitwise_within_the_sum_bound(n):
    x = torch.from_numpy(_vals(n, 4097))
    before = rr.launches
    out = rr.ring_all_reduce(x)
    assert rr.launches == before  # CPU tensors take the plain version
    assert out.shape == x.shape
    for row in out[1:]:
        assert torch.equal(row, out[0])
    err = (out[0].double() - x.double().sum(0)).abs()
    assert bool((err <= (n - 1) * EPS * x.double().abs().sum(0)).all())
    assert torch.equal(rr.ring_all_reduce(x), out)  # run to run: the same bits


def test_one_rank_is_the_identity_and_launches_nothing():
    x = torch.from_numpy(_vals(1, 33))
    before = rr.launches
    assert rr.ring_all_reduce(x) is x
    assert rr.launches == before


@pytest.mark.parametrize("bad", [
    torch.zeros(8), torch.zeros(2, 0), torch.zeros(2, 5, dtype=torch.float64),
    torch.zeros(2, 5, requires_grad=True),
], ids=["1-d", "empty", "float64", "requires_grad"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises((ValueError, TypeError)):
        rr.ring_all_reduce(bad)
