"""Parity of the PyTorch port's graph-core ops with the JAX package, on the
CPU. Inputs are made with numpy from a seed and handed to both frameworks.

``knn_mr_reference`` (the plain version of the port's CUDA kernel) is held
against the JAX package's Pallas kernel, run in interpret mode, and against
its XLA path: idx bitwise, mr within 1e-5 in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkgnet_tpu.ops import aggregate as jagg
from gkgnet_tpu.ops import knn as jknn
from gkgnet_tpu.ops.interpolate import bicubic_resize_matrix as j_bicubic
from gkgnet_tpu.ops.pallas.knn_mr import knn_mr_fused as j_knn_mr_fused
from gkgnet_tpu.ops.pos_embed import get_relative_pos_table as j_rel_pos
from gkgnet_tpu_torch.ops import aggregate as tagg
from gkgnet_tpu_torch.ops import knn as tknn
from gkgnet_tpu_torch.ops import knn_mr as tknn_mr
from gkgnet_tpu_torch.ops.interpolate import bicubic_resize_matrix
from gkgnet_tpu_torch.ops.pos_embed import get_relative_pos_table


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU work on one thread: the suite runs several test files at
    once on the host's cores, and beside them a run on every core's thread
    spends most of its time waiting for the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("c,n,r", [(48, 1024, 4), (96, 256, 2), (240, 64, 1)])
def test_relative_pos_table_matches_jax(c, n, r):
    np.testing.assert_array_equal(get_relative_pos_table(c, n, r),
                                  j_rel_pos(c, n, r))


@pytest.mark.parametrize("n_in,n_out", [(1024, 64), (20, 20), (7, 13)])
def test_bicubic_resize_matrix_matches_jax(n_in, n_out):
    np.testing.assert_array_equal(bicubic_resize_matrix(n_in, n_out),
                                  j_bicubic(n_in, n_out))


def test_l2_normalize_and_sqdist_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 30, 12)).astype(np.float32)
    y = rng.standard_normal((2, 20, 12)).astype(np.float32)
    np.testing.assert_allclose(tknn.l2_normalize(_t(x)).numpy(),
                               np.asarray(jknn.l2_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tknn.pairwise_sqdist(_t(x), _t(y)).numpy(),
        np.asarray(jknn.pairwise_sqdist(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5, atol=1e-5)
    # bf16: normalized in fp32, rounded back to bf16
    xb = tknn.l2_normalize(_t(x).to(torch.bfloat16))
    assert xb.dtype == torch.bfloat16
    jb = jknn.l2_normalize(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_allclose(xb.float().numpy(),
                               np.asarray(jb.astype(jnp.float32)),
                               rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("bias_kind,self_knn", [
    (None, False), ("shared", False), ("batched", False), ("shared", True),
    (None, True)])
def test_knn_graph_matches_jax(bias_kind, self_knn):
    bg, n, m, d, k = 2, 24, 40, 10, 6
    rng = np.random.default_rng(1)
    x = rng.standard_normal((bg, n, d)).astype(np.float32)
    y = None if self_knn else rng.standard_normal((bg, m, d)).astype(
        np.float32)
    m = n if self_knn else m
    bias = {None: None,
            "shared": rng.standard_normal((n, m)).astype(np.float32) * 0.1,
            "batched": rng.standard_normal((bg, n, m)).astype(np.float32)
            * 0.1}[bias_kind]
    ref = jknn.knn_graph(jnp.asarray(x), None if y is None else jnp.asarray(y),
                         k=k, bias=None if bias is None else jnp.asarray(bias))
    got = tknn.knn_graph(_t(x), None if y is None else _t(y), k=k,
                         bias=None if bias is None else _t(bias))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_dilate_edges_matches_jax():
    idx = np.arange(2 * 5 * 12, dtype=np.int32).reshape(2, 5, 12)
    for dil in (1, 2, 3):
        np.testing.assert_array_equal(
            tknn.dilate_edges(_t(idx), dilation=dil).numpy(),
            np.asarray(jknn.dilate_edges(jnp.asarray(idx), dilation=dil)))


def test_aggregate_ops_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    y = rng.standard_normal((2, 14, 6)).astype(np.float32)
    idx = rng.integers(0, 14, (2, 9, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tagg.gather_nodes(_t(y), _t(idx)).numpy(),
        np.asarray(jagg.gather_nodes(jnp.asarray(y), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tagg.max_relative(_t(x), _t(idx), _t(y)).numpy(),
        np.asarray(jagg.max_relative(jnp.asarray(x), jnp.asarray(idx),
                                     jnp.asarray(y))))
    self_idx = rng.integers(0, 9, (2, 9, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tagg.max_relative(_t(x), _t(self_idx)).numpy(),
        np.asarray(jagg.max_relative(jnp.asarray(x), jnp.asarray(self_idx))))
    np.testing.assert_array_equal(
        tagg.interleave_channels(_t(x), _t(2 * x)).numpy(),
        np.asarray(jagg.interleave_channels(jnp.asarray(x),
                                            jnp.asarray(2 * x))))


# ------------------------------------------- knn_mr: the kernel's contract


def _jax_xla_path(x, y, bias, k, dilation):
    idx = jknn.knn_graph(x, y, k=k * dilation, bias=bias)
    idx = jknn.dilate_edges(idx, dilation=dilation)
    return idx, jagg.max_relative(x, idx, y)


def _check_knn_mr(x, y, bias, k, dilation, tile_n):
    """knn_mr_reference vs the Pallas kernel (interpret mode) and the XLA
    path: idx bitwise, mr within 1e-5 (fp32)."""
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    jb = None if bias is None else jnp.asarray(bias)
    tx = _t(x)
    ty = tx if y is x else _t(y)
    idx, mr = tknn_mr.knn_mr_reference(
        tx, ty, None if bias is None else _t(bias), k, dilation)
    assert idx.dtype == torch.int32 and idx.shape == (*x.shape[:2], k)
    assert mr.dtype == torch.float32 and mr.shape == x.shape
    p_idx, p_mr = j_knn_mr_fused(jx, jy, jb, k, dilation, tile_n, True)
    x_idx, x_mr = _jax_xla_path(jx, jy, jb, k, dilation)
    for ref_idx, ref_mr in ((p_idx, p_mr), (x_idx, x_mr)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_allclose(mr.numpy(), np.asarray(ref_mr),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bg,n,d,m,k,dilation,has_bias", [
    (2, 64, 12, 48, 4, 1, True),      # M < 1024: argmin selector
    (2, 64, 12, 48, 4, 2, True),
    (2, 40, 12, 48, 3, 3, False),
    (1, 16, 8, 1100, 3, 2, True),     # M >= 1024: foldv selector
    (1, 16, 8, 1024, 3, 3, False),
])
def test_knn_mr_reference_matches_jax(bg, n, d, m, k, dilation, has_bias):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((bg, n, d)).astype(np.float32)
    y = rng.standard_normal((bg, m, d)).astype(np.float32)
    bias = (rng.standard_normal((n, m)).astype(np.float32) * 0.1
            if has_bias else None)
    _check_knn_mr(x, y, bias, k, dilation, 16)


def test_knn_mr_reference_self_knn_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, 8)).astype(np.float32)
    _check_knn_mr(x, x, None, 5, 2, 40)


def _duplicated_rows():
    # y rows 0-2 are equal (and equal to every query): three-way ties
    x = np.ones((1, 8, 4), np.float32)
    y = np.concatenate([np.ones((1, 3, 4)), np.zeros((1, 5, 4))], 1)
    return x, y.astype(np.float32), 3, 1


def _quantized():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 2, (2, 48, 6)).astype(np.float32)
    y = rng.integers(0, 2, (2, 160, 6)).astype(np.float32)
    return x, y, 5, 1


def _constant(dilation):
    def make():
        x = np.full((2, 40, 8), 0.7, np.float32)
        y = np.full((2, 192, 8), 0.7, np.float32)
        return x, y, 3, dilation
    return make


def _hidden_tied_candidate():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 8, 8)).astype(np.float32)
    y = rng.standard_normal((1, 896, 8)) * 10.0
    for c in (3, 131, 259, 387, 4):
        y[:, c] = x[:, 0]
    return x, y.astype(np.float32), 4, 1


def _lane_collision():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 16, 8)).astype(np.float32)
    y = rng.standard_normal((1, 768, 8)) * 10.0
    for j, c in enumerate([7, 135, 263, 391, 7 + 4 * 128]):
        y[:, c] = x[:, j % 16] * (1.0 + 0.01 * j)
    return x, y.astype(np.float32), 4, 2


@pytest.mark.parametrize("make", [
    _duplicated_rows, _quantized, _constant(1), _constant(2),
    _hidden_tied_candidate, _lane_collision,
], ids=["duplicated_rows", "quantized", "constant_d1", "constant_d2",
        "hidden_tied_candidate", "lane_collision"])
def test_knn_mr_reference_tie_fixtures(make):
    """The tie fixtures of tests/test_pallas.py: the lowest column wins
    every exact tie, as lax.top_k orders them."""
    x, y, k, dilation = make()
    _check_knn_mr(x, y, None, k, dilation, 8)


def test_knn_mr_fused_on_cpu_runs_plain_version():
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((2, 20, 6)).astype(np.float32))
    y = _t(rng.standard_normal((2, 30, 6)).astype(np.float32))
    bias = _t(rng.standard_normal((20, 30)).astype(np.float32))
    before = tknn_mr.launches
    idx, mr = tknn_mr.knn_mr_fused(x, y, bias, 4, 2)
    ref_idx, ref_mr = tknn_mr.knn_mr_reference(x, y, bias, 4, 2)
    assert tknn_mr.launches == before
    assert torch.equal(idx, ref_idx) and torch.equal(mr, ref_mr)
    # bf16 in, bf16 out; mr is the fp32 max-relative rounded once
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    idx_b, mr_b = tknn_mr.knn_mr_fused(xb, yb, bias, 4, 2)
    assert mr_b.dtype == torch.bfloat16
    gathered = tagg.gather_nodes(yb.float(), idx_b)
    expect = (gathered - xb.float()[:, :, None]).amax(2).to(torch.bfloat16)
    assert torch.equal(mr_b, expect)


@pytest.mark.parametrize("case", ["dtype_mix", "bias_shape", "bias_dtype",
                                  "kd_over_m", "channels"])
def test_knn_mr_rejects_bad_inputs(case):
    x = torch.zeros(2, 10, 4)
    y = torch.zeros(2, 12, 4)
    bias = torch.zeros(10, 12)
    k, dilation = 3, 2
    if case == "dtype_mix":
        y = y.to(torch.bfloat16)
    elif case == "bias_shape":
        bias = torch.zeros(12, 10)
    elif case == "bias_dtype":
        bias = bias.double()
    elif case == "kd_over_m":
        k, dilation = 5, 3
    else:
        y = torch.zeros(2, 12, 5)
    with pytest.raises((ValueError, TypeError)):
        tknn_mr.knn_mr_fused(x, y, bias, k, dilation)


def test_ordering_gaps_flags_a_wrong_order():
    """The fp64 oracle that holds the CUDA kernel to its ordering contract:
    near zero for the plain version's order, large for a wrong one."""
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal((2, 30, 8)).astype(np.float32))
    y = _t(rng.standard_normal((2, 50, 8)).astype(np.float32))
    bias = _t(rng.standard_normal((30, 50)).astype(np.float32) * 0.1)
    idx, _ = tknn_mr.knn_mr_reference(x, y, bias, 4, 2)
    xn, yn = tknn.l2_normalize(x), tknn.l2_normalize(y)
    assert tknn_mr.ordering_gaps(xn, yn, bias, idx, 2).max() < 1e-6
    rows = torch.tensor([3, 31, 59])
    gaps = tknn_mr.ordering_gaps(xn, yn, bias, idx.flip(-1), 2, rows)
    assert gaps.shape == (3, 4) and gaps.max() > 1e-2
    repeated = idx.clone()
    repeated[0, 0, 1] = repeated[0, 0, 0]
    with pytest.raises(ValueError):
        tknn_mr.ordering_gaps(xn, yn, bias, repeated, 2)


# ------------------------------------ NaN rows: the plain version pinned


def test_knn_mr_reference_nan_rows_match_jax():
    """A query row of NaN and a target row of NaN: the plain version (and
    the CUDA kernel held to it) gives what the JAX XLA path gives: in-range,
    distinct idx, the NaN target column last, and mr NaN on the NaN query
    row."""
    rng = np.random.default_rng(12)
    bg, n, m, d, k, dilation = 2, 12, 20, 6, 3, 2
    x = rng.standard_normal((bg, n, d)).astype(np.float32)
    y = rng.standard_normal((bg, m, d)).astype(np.float32)
    x[0, 3] = np.nan
    y[1, 0] = np.nan
    idx, mr = tknn_mr.knn_mr_reference(_t(x), _t(y), None, k, dilation)
    j_idx, j_mr = _jax_xla_path(jnp.asarray(x), jnp.asarray(y), None, k,
                                dilation)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(mr.numpy(), np.asarray(j_mr), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(idx[0, 3].numpy(), [0, 2, 4])
    assert torch.isnan(mr[0, 3]).all()
    assert not (idx[1] == 0).any()           # the NaN target is never chosen
    assert torch.isfinite(mr[1]).all() and torch.isfinite(mr[0, :3]).all()


# --------------------------------- knn_mr backward: the _bwd_pallas contract

from gkgnet_tpu.ops.pallas.knn_mr import _bwd_pallas as j_bwd_pallas  # noqa: E402

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _bwd_inputs(bg, n, m, d, k, dtype, seed, ties=True):
    """Seeded x, y, g in ``dtype`` and the plain kNN's idx of them; with
    ``ties``, target rows 30 and 31 (and 5 and 6) are equal, so their
    relative features tie exactly in the max."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bg, n, d)).astype(np.float32)
    y = rng.standard_normal((bg, m, d))
    if ties:
        y[:, 31] = y[:, 30]
        y[:, 6] = y[:, 5]
    y = y.astype(np.float32)
    g = rng.standard_normal((bg, n, d)).astype(np.float32)
    tx, ty, tg = (_t(a).to(dtype) for a in (x, y, g))
    idx, _ = tknn_mr.knn_mr_reference(tx, ty, None, k)
    return tx, ty, idx, tg


def _bf16_ulp(a):
    """The bf16 spacing at |a| (float32 numpy in, float32 out)."""
    a = np.abs(a.astype(np.float32))
    exp = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.float32(2.0) ** (exp - 7)


def _jax_tie_set(x, y, idx):
    """rel == max(rel) with rel computed by the JAX package in the input
    dtype: the indicator lax.reduce_max's VJP splits the gradient over."""
    rel = jagg.gather_nodes(y, idx) - x[:, :, None, :]
    return np.asarray(rel == jnp.max(rel, axis=2, keepdims=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
def test_knn_mr_backward_reference_matches_bwd_pallas(dtype, self_knn):
    """``knn_mr_backward_reference`` against the JAX package's Pallas
    backward (interpret mode, one tile): gx bitwise, the tie sets equal,
    gy within 1e-6 (fp32: the same sums in another order) or 1 bf16 ulp
    (bf16: one rounding of an fp32 sum)."""
    bg, n, m, d, k = 2, 48, 40, 8, 4
    x, y, idx, g = _bwd_inputs(bg, n, m, d, k, dtype, seed=21)
    if self_knn:
        y = x.clone()
        y[:, 31] = y[:, 30]
        x = y
        idx, _ = tknn_mr.knn_mr_reference(x, y, None, k)
    gx, gy = tknn_mr.knn_mr_backward_reference(x, y, idx, g)
    assert gx.dtype == dtype and gy.dtype == dtype and gy.shape == y.shape
    jx, jy, jg = (jnp.asarray(a.float().numpy(), _JDT[dtype])
                  for a in (x, y, g))
    j_idx = jnp.asarray(idx.numpy())
    j_gx, j_gy = j_bwd_pallas(jx, jy, j_idx, jg, k, n, True)
    np.testing.assert_array_equal(gx.float().numpy(),
                                  np.asarray(j_gx.astype(jnp.float32)))
    ge = tknn_mr.edge_gradients_reference(x, y, idx, g)
    ties = _jax_tie_set(jx, jy, j_idx)
    assert ties.sum(axis=2).max() > 1, "the fixture has no tie"
    np.testing.assert_array_equal((ge != 0).numpy(), ties & (g != 0).numpy()[
        :, :, None, :])
    got = gy.float().numpy()
    ref = np.asarray(j_gy.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:
        assert (np.abs(got - ref) <= _bf16_ulp(np.maximum(np.abs(got),
                                                          np.abs(ref)))).all()


def test_knn_mr_backward_reference_splits_ties_in_the_input_dtype():
    """Two targets equal in bf16 but not in fp32 tie in the bf16 max: the
    gradient is split between them, as the JAX kernel's bf16 comparison
    does (autograd through the fp32 max would give all of it to one)."""
    x = torch.zeros((1, 1, 1), dtype=torch.bfloat16)
    y = torch.tensor([[[1.0], [1.0]]]).to(torch.bfloat16)
    y[0, 1, 0] = torch.tensor(1.0 + 2 ** -9).to(torch.bfloat16)  # rounds to 1
    idx = torch.tensor([[[0, 1]]], dtype=torch.int32)
    g = torch.ones((1, 1, 1), dtype=torch.bfloat16)
    _, gy = tknn_mr.knn_mr_backward_reference(x, y, idx, g)
    assert gy.flatten().tolist() == [0.5, 0.5]
    j_gx, j_gy = j_bwd_pallas(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              jnp.asarray(y.float().numpy(), jnp.bfloat16),
                              jnp.asarray(idx.numpy()),
                              jnp.ones((1, 1, 1), jnp.bfloat16), 2, 1, True)
    np.testing.assert_array_equal(np.asarray(j_gy.astype(jnp.float32)),
                                  gy.float().numpy())


def test_knn_mr_backward_reference_nan_rows():
    """A NaN among a row's rels makes the max NaN and matches no rel, so
    that row sends no gradient to y (as jnp.maximum and == do) and gx is
    -g. A NaN query row is held against the Pallas backward; a NaN target
    row only within the port, because the Pallas kernel gathers through a
    one-hot matmul, where 0 * NaN spreads the NaN target over every row."""
    x, y, idx, g = _bwd_inputs(1, 10, 16, 4, 3, torch.float32, seed=22,
                               ties=False)
    x[0, 2] = float("nan")
    gx, gy = tknn_mr.knn_mr_backward_reference(x, y, idx, g)
    assert (tknn_mr.edge_gradients_reference(x, y, idx, g)[0, 2] == 0).all()
    assert torch.equal(gx, -g) and torch.isfinite(gy).all()
    j_gx, j_gy = j_bwd_pallas(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                              jnp.asarray(idx.numpy()), jnp.asarray(g.numpy()),
                              3, 10, True)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(j_gx))
    np.testing.assert_allclose(gy.numpy(), np.asarray(j_gy), rtol=1e-6,
                               atol=1e-6)
    x[0, 2] = 0.0
    before = tknn_mr.edge_gradients_reference(x, y, idx, g)
    target = idx[0, 4, 0]
    y[0, target] = float("nan")
    _, gy = tknn_mr.knn_mr_backward_reference(x, y, idx, g)
    ge = tknn_mr.edge_gradients_reference(x, y, idx, g)
    hit = (idx[0] == target).any(-1)
    assert (ge[0, hit] == 0).all() and torch.isfinite(gy).all()
    assert torch.equal(ge[0, ~hit], before[0, ~hit]) and (~hit).any()


@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
def test_knn_mr_fused_autograd_matches_jax_grad(self_knn):
    """torch.autograd through the port's ``knn_mr_fused`` against jax.grad
    through the JAX package's (interpret mode): the same gradients within
    1e-5. With y = x the two parts sum into the one input."""
    bg, n, m, d, k, dilation = 1, 24, 16, 6, 3, 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal((bg, n, d)).astype(np.float32)
    y = x if self_knn else rng.standard_normal((bg, m, d)).astype(np.float32)
    bias = (rng.standard_normal((n, x.shape[1] if self_knn else m)) * 0.1
            ).astype(np.float32)
    w = rng.standard_normal((bg, n, d)).astype(np.float32)

    def j_loss(x_, y_):
        _, mr = j_knn_mr_fused(x_, x_ if self_knn else y_,
                               jnp.asarray(bias), k, dilation, 8, True)
        return jnp.sum(mr * mr * jnp.asarray(w))

    j_gx, j_gy = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(y))
    tx = _t(x).requires_grad_()
    ty = tx if self_knn else _t(y).requires_grad_()
    _, mr = tknn_mr.knn_mr_fused(tx, ty, _t(bias), k, dilation)
    (mr * mr * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_gx),
                               rtol=1e-5, atol=1e-5)
    if not self_knn:
        np.testing.assert_allclose(ty.grad.numpy(), np.asarray(j_gy),
                                   rtol=1e-5, atol=1e-5)


def test_knn_mr_fused_graph_build_gets_no_gradient():
    """Only the gather + max-relative is differentiated: the bias gets no
    gradient and idx is not differentiable; on the CPU no kernel runs."""
    x, y, _, _ = _bwd_inputs(1, 10, 16, 4, 3, torch.float32, seed=23,
                             ties=False)
    x.requires_grad_()
    y.requires_grad_()
    bias = torch.zeros((10, 16), requires_grad=True)
    before = (tknn_mr.launches, tknn_mr.backward_launches)
    idx, mr = tknn_mr.knn_mr_fused(x, y, bias, 3)
    assert not idx.requires_grad
    mr.sum().backward()
    assert bias.grad is None
    assert torch.equal(x.grad, -torch.ones_like(x))
    assert (tknn_mr.launches, tknn_mr.backward_launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_backward_gy_bound_holds_plain_and_flags_a_wrong_sum(dtype):
    """The fp64 oracle that holds the backward kernel's gy: the plain
    version's gy is within it, a gy with one edge's gradient dropped is
    not."""
    x, y, idx, g = _bwd_inputs(2, 48, 40, 8, 4, dtype, seed=24)
    _, gy = tknn_mr.knn_mr_backward_reference(x, y, idx, g)
    ge = tknn_mr.edge_gradients_reference(x, y, idx, g)
    exact, bound = tknn_mr.backward_gy_bound(ge, idx, 40)
    assert exact.dtype == torch.float64 and exact.shape == (2, 40, 8)
    assert ((gy.double() - exact).abs() <= bound).all()
    wrong = gy.double()
    wrong[0, idx[0, 0, 0]] -= ge[0, 0, 0].double()
    assert ((wrong - exact).abs() > bound).any()


# ------------- knn_mr backward: the kernel's summation order, in plain torch


def _python_ordered_gy(x, y, idx, g):
    """gy by a pure-Python loop: each target's fp32 sum from 0.0 over its
    edges in ascending edge id (bg*N + n)*k + j, one numpy float32 add per
    edge, rounded once to y's type."""
    bg, n, d = x.shape
    m, k = y.shape[1], idx.shape[2]
    ge = tknn_mr.edge_gradients_reference(x, y, idx, g).float().numpy()
    acc = np.zeros((bg, m, d), np.float32)
    ids = idx.numpy()
    for b in range(bg):
        for r in range(n):
            for j in range(k):
                acc[b, ids[b, r, j]] = acc[b, ids[b, r, j]] + ge[b, r, j]
    return _t(acc).to(y.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["ties", "hub", "k1"])
def test_knn_mr_backward_ordered_reference_matches_python_loop(dtype, case):
    """``knn_mr_backward_ordered_reference`` bitwise against a pure-Python
    loop over the edges in ascending edge id: with exact ties, with a hub
    target that every row chose (its sum the longest), and at k = 1; gx is
    -g; targets no edge chose get exactly 0."""
    if case == "k1":
        x, y, idx, g = _bwd_inputs(2, 30, 40, 6, 1, dtype, seed=25)
    else:
        x, y, idx, g = _bwd_inputs(2, 40, 36, 6, 4, dtype, seed=26)
    if case == "hub":  # target 7 in every row, once
        idx = idx.clone()
        idx[:, :, 0] = torch.where((idx == 7).any(-1), idx[:, :, 0], 7)
        assert ((idx == 7).sum((1, 2)) == idx.shape[1]).all()
    gx, gy = tknn_mr.knn_mr_backward_ordered_reference(x, y, idx, g)
    assert torch.equal(gx, -g)
    want = _python_ordered_gy(x, y, idx, g)
    assert torch.equal(gy.float().view(torch.int32),
                       want.float().view(torch.int32))
    count = torch.bincount(tknn_mr._flat_targets(idx, y.shape[1]),
                           minlength=y.shape[0] * y.shape[1])
    assert (count == 0).any()
    assert (gy.reshape(-1, y.shape[2])[count == 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_knn_mr_backward_ordered_reference_within_the_bound(dtype):
    """The ordered plain version and ``knn_mr_backward_reference`` both
    within ``backward_gy_bound`` of the fp64 sum (two fp32 sums of the
    same terms in their orders), and within twice the bound of each
    other."""
    x, y, idx, g = _bwd_inputs(2, 48, 40, 8, 4, dtype, seed=27)
    _, gy = tknn_mr.knn_mr_backward_ordered_reference(x, y, idx, g)
    _, gy_plain = tknn_mr.knn_mr_backward_reference(x, y, idx, g)
    ge = tknn_mr.edge_gradients_reference(x, y, idx, g)
    exact, bound = tknn_mr.backward_gy_bound(ge, idx, 40)
    assert ((gy.double() - exact).abs() <= bound).all()
    assert ((gy_plain.double() - exact).abs() <= bound).all()
    assert ((gy.double() - gy_plain.double()).abs() <= 2 * bound).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
def test_knn_mr_backward_ordered_reference_matches_bwd_pallas(dtype,
                                                              self_knn):
    """The ordered plain version against the JAX package's Pallas backward
    (interpret mode, one tile), at the tolerance of
    ``test_knn_mr_backward_reference_matches_bwd_pallas``: gx bitwise, gy
    within 1e-6 (fp32) or 1 bf16 ulp (bf16)."""
    bg, n, m, d, k = 2, 48, 40, 8, 4
    x, y, idx, g = _bwd_inputs(bg, n, m, d, k, dtype, seed=28)
    if self_knn:
        y = x.clone()
        y[:, 31] = y[:, 30]
        x = y
        idx, _ = tknn_mr.knn_mr_reference(x, y, None, k)
    gx, gy = tknn_mr.knn_mr_backward_ordered_reference(x, y, idx, g)
    assert gx.dtype == dtype and gy.dtype == dtype and gy.shape == y.shape
    jx, jy, jg = (jnp.asarray(a.float().numpy(), _JDT[dtype])
                  for a in (x, y, g))
    j_gx, j_gy = j_bwd_pallas(jx, jy, jnp.asarray(idx.numpy()), jg, k, n,
                              True)
    np.testing.assert_array_equal(gx.float().numpy(),
                                  np.asarray(j_gx.astype(jnp.float32)))
    got = gy.float().numpy()
    ref = np.asarray(j_gy.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:
        assert (np.abs(got - ref) <= _bf16_ulp(np.maximum(np.abs(got),
                                                          np.abs(ref)))).all()


def test_backward_wrappers_launch_only_on_cuda():
    """The backward kernel's wrappers raise on CPU tensors (the autograd
    Functions run the plain versions there) and count no launch; the
    grouped wrapper checks its shapes first."""
    x, y, idx, g = _bwd_inputs(1, 10, 16, 4, 3, torch.float32, seed=29,
                               ties=False)
    before = tknn_mr.backward_launches
    with pytest.raises(ValueError, match="CUDA"):
        tknn_mr.launch_backward(x, y, idx, g)
    xu, yu, gu = (t.reshape(1, -1, 8) for t in (x, y, g))
    idxu = idx.reshape(1, 5, 2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tknn_mr.launch_backward_grouped(xu, yu, idxu, gu, 2)
    with pytest.raises(ValueError, match="idx"):
        tknn_mr.launch_backward_grouped(xu, yu, idx, gu, 2)
    assert tknn_mr.backward_launches == before
