"""The backward of the port's neighbour gather (``gkgnet_tpu_torch/ops/
aggregate.py`` ``gather_nodes``, ``gather_backward``) against the JAX
package's gather VJP (``jax.vjp`` of ``gkgnet_tpu/ops/aggregate.py``
``gather_nodes``) and an fp64 oracle, on the CPU, with inputs made by numpy
from a seed. The kernel's own test, bitwise against the ordered plain
version, is ``tests/test_torch_cuda.py``'s (on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkgnet_tpu.ops.aggregate import gather_nodes as jax_gather_nodes
from gkgnet_tpu.ops.aggregate import max_relative as jax_max_relative
from gkgnet_tpu_torch.ops import aggregate, knn_mr

# (B, N, k, M, C): a hub target (a quarter of the edges), targets with no
# edge, rows not whole 16-byte chunks, one edge per row
SHAPES = [(2, 40, 9, 16, 24), (3, 50, 5, 7, 33), (1, 200, 18, 600, 8),
          (2, 1, 1, 3, 1)]
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _case(b, n, k, m, c, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, m, c)).astype(np.float32)
    idx = rng.integers(0, m, (b, n, k)).astype(np.int32)
    idx[:, : n // 4 + 1, 0] = 0
    g = rng.standard_normal((b, n, k, c)).astype(np.float32)
    return y, idx, g


def _port_grad(y, idx, g, dtype):
    """y's gradient through ``gather_nodes``' autograd backward (the plain
    version on the CPU)."""
    yt = torch.from_numpy(y).to(dtype).requires_grad_()
    aggregate.gather_nodes(yt, torch.from_numpy(idx)).backward(
        torch.from_numpy(g).to(dtype))
    return yt.grad


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,n,k,m,c", SHAPES)
def test_gather_backward_matches_jax_vjp(b, n, k, m, c, dt):
    """The port's gy against the JAX gather's VJP on the same inputs. fp32:
    both are fp32 sums of a target's edge rows in some order, each within
    gamma(deg - 1) * sum|g_j| of the exact sum (``backward_gy_bound``), so
    within twice that of each other. bf16: the port sums in fp32 and rounds
    once, XLA's scatter-add rounds each add to bf16 (half a bf16 spacing of
    the running sum, at most 2**-9 * sum|g_j| apiece): within deg * 2**-9 *
    sum|g_j| plus the port's bound."""
    torch_dt, jax_dt = DTYPES[dt]
    y, idx, g = _case(b, n, k, m, c, seed=b * n + c)
    got = _port_grad(y, idx, g, torch_dt).float().double().numpy()
    _, vjp = jax.vjp(lambda t: jax_gather_nodes(t, jnp.asarray(idx)),
                     jnp.asarray(y).astype(jax_dt))
    (want,) = vjp(jnp.asarray(g).astype(jax_dt))
    want = np.asarray(want.astype(jnp.float32), np.float64)
    gt = torch.from_numpy(g).to(torch_dt)
    ti = torch.from_numpy(idx)
    _, bound = knn_mr.backward_gy_bound(gt, ti, m)
    bound = 2 * bound.reshape(b, m, c).numpy()
    if dt == "bf16":
        flat = aggregate._flat_targets(ti, m)
        deg = torch.bincount(flat, minlength=b * m).double()
        mag = torch.zeros((b * m, c), dtype=torch.float64)
        mag.index_add_(0, flat, gt.reshape(-1, c).double().abs())
        bound = bound + (deg[:, None] * 2.0 ** -9 * mag).reshape(
            b, m, c).numpy()
    assert (np.abs(got - want) <= bound + 1e-30).all()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,n,k,m,c", SHAPES)
def test_gather_backward_is_the_ordered_fp64_sum(b, n, k, m, c, dt):
    """The CPU path (``gather_backward_reference``, through autograd) is
    bitwise the ordered plain version, each target's fp32 sum in ascending
    edge id (the kernel's contract), and within ``backward_gy_bound`` of the
    fp64 sum; targets without an edge get 0."""
    torch_dt, _ = DTYPES[dt]
    y, idx, g = _case(b, n, k, m, c, seed=7 * b + n)
    got = _port_grad(y, idx, g, torch_dt)
    gt, ti = torch.from_numpy(g).to(torch_dt), torch.from_numpy(idx)
    assert got.dtype == torch_dt
    assert torch.equal(got, aggregate.gather_backward_ordered_reference(
        gt, ti, m))
    assert torch.equal(got, aggregate.gather_backward_reference(gt, ti, m))
    exact, bound = knn_mr.backward_gy_bound(gt, ti, m)
    assert ((got.double() - exact).abs() <= bound).all()
    empty = torch.bincount(aggregate._flat_targets(ti, m),
                           minlength=b * m) == 0
    assert (got.reshape(b * m, c)[empty] == 0).all()


def test_gather_nodes_without_a_gradient_is_the_plain_gather():
    """Without a gradient to take, ``gather_nodes`` is ``torch.gather``
    alone (no autograd node), and its values equal the JAX gather's."""
    y, idx, _ = _case(2, 30, 4, 11, 6, seed=1)
    yt, ti = torch.from_numpy(y), torch.from_numpy(idx)
    out = aggregate.gather_nodes(yt, ti)
    assert out.grad_fn is None
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_gather_nodes(jnp.asarray(y),
                                                 jnp.asarray(idx))))
    with torch.no_grad():
        assert aggregate.gather_nodes(yt.requires_grad_(), ti).grad_fn is None


@pytest.mark.parametrize("dt", list(DTYPES))
def test_max_relative_gradients_match_jax(dt):
    """``max_relative`` computes each rel_j in the input type as the JAX
    package's does: the values bitwise, x's gradient bitwise and y's (the
    gather's backward over the same tie splits) within the bounds of
    ``test_gather_backward_matches_jax_vjp`` -- here, with ties made by
    rounding in bf16, where an fp32 rel would split otherwise."""
    torch_dt, jax_dt = DTYPES[dt]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 30, 12)).astype(np.float32)
    y = rng.standard_normal((2, 20, 12)).astype(np.float32)
    idx = rng.integers(0, 20, (2, 30, 6)).astype(np.int32)
    gm = rng.standard_normal((2, 30, 12)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch_dt).requires_grad_()
    yt = torch.from_numpy(y).to(torch_dt).requires_grad_()
    mr = aggregate.max_relative(xt, torch.from_numpy(idx), yt)
    mr.backward(torch.from_numpy(gm).to(torch_dt))
    j_mr, vjp = jax.vjp(lambda a, b_: jax_max_relative(a, jnp.asarray(idx),
                                                       b_),
                        jnp.asarray(x).astype(jax_dt),
                        jnp.asarray(y).astype(jax_dt))
    j_gx, j_gy = vjp(jnp.asarray(gm).astype(jax_dt))
    f32 = jnp.float32
    np.testing.assert_array_equal(mr.detach().float().numpy(),
                                  np.asarray(j_mr.astype(f32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(j_gx.astype(f32)))
    tol = 2.0 ** -6 if dt == "bf16" else 1e-6
    ref = np.asarray(j_gy.astype(f32))
    np.testing.assert_allclose(yt.grad.float().numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())
