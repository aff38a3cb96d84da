"""Parity of the fp32 plain versions with the JAX package at the shapes the
fp32 kernels (``csrc/knn_scan_f32.cuh``) are checked at on the card, on the
CPU: rows of D = 1024 with k*d = 45 (arch b's ungrouped stage 4), and rows
whose width is not a multiple of 4 (the scan's padded float4 tail), with
NaN query, target and bias rows.

``knn_mr_reference``, ``knn_topk_reference`` and
``knn_mr_grouped_reference`` are what the card tests hold the kernels to.
Here they are held to the JAX package: its Pallas kernels in interpret mode
where the rows are finite (idx bitwise, values within the stated bounds),
and its XLA path where a row is NaN (the Pallas kernels' masked argmin
loses such a row; the port orders NaN distances last in column order, as
the XLA path's top-k does). Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkgnet_tpu.ops import aggregate as jagg
from gkgnet_tpu.ops import knn as jknn
from gkgnet_tpu.ops.pallas import knn_mr as jknn_mr
from gkgnet_tpu.ops.pallas.knn_topk import knn_topk as j_knn_topk
from gkgnet_tpu_torch.ops import knn as tknn
from gkgnet_tpu_torch.ops import knn_mr as tknn_mr
from gkgnet_tpu_torch.ops.aggregate import fold_groups, unfold_groups


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
    return torch.from_numpy(np.array(a))


def _xla_knn_mr(x, y, bias, k, dilation):
    idx = jknn.knn_graph(x, y, k=k * dilation, bias=bias)
    idx = jknn.dilate_edges(idx, dilation=dilation)
    return idx, jagg.max_relative(x, idx, y)


def _rows(seed, bg, n, m, d, bias_kind):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bg, n, d)).astype(np.float32)
    y = rng.standard_normal((bg, m, d)).astype(np.float32)
    bias = {None: None,
            "shared": rng.standard_normal((n, m)).astype(np.float32) * 0.1,
            "batched": rng.standard_normal((bg, n, m)).astype(np.float32)
            * 0.1}[bias_kind]
    return x, y, bias


# ------------------------------------------- D = 1024, k*d = 45: finite rows


@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
def test_knn_mr_reference_d1024_matches_jax(self_knn):
    """knn_mr_reference at D = 1024, k 9, dilation 5 (k*d 45), BG 2, with a
    shared bias, against the JAX Pallas kernel (interpret mode) and its XLA
    path: idx bitwise, mr within 1e-5 (the same maxima; the distances'
    fp32 sums taken in other orders decide no tie at this seed)."""
    x, y, bias = _rows(20, 2, 64 if self_knn else 24, 64, 1024, "shared")
    if self_knn:
        y = x
    k, dilation = 9, 5
    tx = _t(x)
    ty = tx if self_knn else _t(y)
    idx, mr = tknn_mr.knn_mr_reference(tx, ty, _t(bias), k, dilation)
    jx, jb = jnp.asarray(x), jnp.asarray(bias)
    jy = jx if self_knn else jnp.asarray(y)
    for ref_idx, ref_mr in (
            jknn_mr.knn_mr_fused(jx, jy, jb, k, dilation, 8, True),
            _xla_knn_mr(jx, jy, jb, k, dilation)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_allclose(mr.numpy(), np.asarray(ref_mr),
                                   rtol=1e-5, atol=1e-5)


def test_knn_topk_reference_d1024_matches_jax_kernel():
    """knn_topk_reference at D = 1024, k 45, BG 2, with a shared bias, on
    rows the JAX package normalized, against the JAX kernel (interpret
    mode): idx bitwise; the distances within 1e-5 (fp32 sums of 1024
    products of unit rows in another order: a few ulps of values below
    4, plus the bias)."""
    x, y, bias = _rows(21, 2, 24, 64, 1024, "shared")
    jx = jknn.l2_normalize(jnp.asarray(x))
    jy = jknn.l2_normalize(jnp.asarray(y))
    ref_idx, ref_vals = j_knn_topk(jx, jy, k=45, bias=jnp.asarray(bias),
                                   tile_n=8, interpret=True,
                                   return_values=True)
    idx, vals = tknn.knn_topk_reference(
        _t(np.asarray(jx)), _t(np.asarray(jy)), k=45, bias=_t(bias),
        return_values=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals), rtol=0,
                               atol=1e-5)


def test_grouped_reference_d1024_matches_jax():
    """knn_mr_grouped_reference with 2 groups of D = 1024 channels, k*d 45
    and a shared bias, against the JAX knn_mr_fused_grouped (interpret
    mode): idx bitwise, mr within 1e-5."""
    rng = np.random.default_rng(22)
    b, g, n, m, d, k, dilation = 1, 2, 16, 48, 1024, 9, 5
    x = rng.standard_normal((b, n, g * d)).astype(np.float32)
    y = rng.standard_normal((b, m, g * d)).astype(np.float32)
    bias = rng.standard_normal((n, m)).astype(np.float32) * 0.1
    idx, mr = tknn_mr.knn_mr_grouped_reference(_t(x), _t(y), _t(bias), k,
                                               dilation, g)
    j_idx, j_mr = jknn_mr.knn_mr_fused_grouped(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(bias), k, dilation, g,
        16, True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(mr.numpy(), np.asarray(j_mr), rtol=1e-5,
                               atol=1e-5)


# ------------------- widths not a multiple of 4, with NaN rows: the XLA path


def _nan_rows(x, y, bias):
    """Query row 1 of group 0 NaN, target row 2 of group 1 NaN, and the
    bias of query row 3 (of group 0 when batched) NaN."""
    x[0, 1] = np.nan
    y[1, 2] = np.nan
    if bias is not None:
        (bias if bias.ndim == 2 else bias[0])[3] = np.nan


@pytest.mark.parametrize("bias_kind", [None, "shared", "batched"])
@pytest.mark.parametrize("d,k,dilation", [(1, 9, 1), (3, 9, 5), (5, 9, 5),
                                          (7, 16, 4), (1023, 9, 5)])
def test_knn_mr_reference_nan_rows_odd_widths_match_jax(d, k, dilation,
                                                        bias_kind):
    """knn_mr_reference on rows of 1, 3, 5, 7 and 1023 channels, k*d 9 to
    64, with NaN rows, against the JAX XLA path: idx bitwise (a NaN query
    or bias row takes columns 0, d, 2d, ...; the NaN target never enters a
    row that has numbers enough), mr within 1e-5, NaN on the NaN rows."""
    x, y, bias = _rows(23 + d, 2, 20, 64, d, bias_kind)
    _nan_rows(x, y, bias)
    tb = None if bias is None else _t(bias)
    jb = None if bias is None else jnp.asarray(bias)
    idx, mr = tknn_mr.knn_mr_reference(_t(x), _t(y), tb, k, dilation)
    j_idx, j_mr = _xla_knn_mr(jnp.asarray(x), jnp.asarray(y), jb, k,
                              dilation)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(mr.numpy(), np.asarray(j_mr), rtol=1e-5,
                               atol=1e-5)
    stride = list(range(0, k * dilation, dilation))
    assert idx[0, 1].tolist() == stride and torch.isnan(mr[0, 1]).all()
    if bias is not None:
        assert idx[0, 3].tolist() == stride
    rows = [r for r in range(20) if bias_kind != "shared" or r != 3]
    assert not (idx[1, rows] == 2).any()


@pytest.mark.parametrize("d,k", [(3, 9), (1023, 45)])
def test_knn_topk_reference_nan_rows_odd_widths_match_jax(d, k):
    """knn_topk_reference on rows the JAX package normalized (3 and 1023
    channels), a shared bias and NaN rows, against the JAX XLA path's
    top-k: idx bitwise; the NaN query and bias rows take columns 0..k-1
    with NaN values; the NaN target comes after every number."""
    x, y, bias = _rows(30 + d, 2, 20, 64, d, "shared")
    _nan_rows(x, y, bias)
    jx = jknn.l2_normalize(jnp.asarray(x))
    jy = jknn.l2_normalize(jnp.asarray(y))
    ref = jknn.knn_graph(jx, jy, k=k, bias=jnp.asarray(bias))
    idx, vals = tknn.knn_topk_reference(
        _t(np.asarray(jx)), _t(np.asarray(jy)), k=k, bias=_t(bias),
        return_values=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    for b, r in ((0, 1), (0, 3), (1, 3)):
        assert idx[b, r].tolist() == list(range(k))
        assert torch.isnan(vals[b, r]).all()
    rows = [r for r in range(20) if r != 3]
    assert not (idx[1, rows] == 2).any()
    assert torch.isfinite(vals[1, rows]).all()


def test_grouped_reference_nan_rows_odd_width_matches_jax():
    """knn_mr_grouped_reference with 2 groups of 7 channels, NaN rows in
    one group and a shared bias, against fold -> the JAX XLA path ->
    unfold: idx bitwise, mr within 1e-5."""
    rng = np.random.default_rng(40)
    b, g, n, m, d, k, dilation = 2, 2, 20, 64, 7, 9, 5
    x = rng.standard_normal((b, n, g * d)).astype(np.float32)
    y = rng.standard_normal((b, m, g * d)).astype(np.float32)
    bias = rng.standard_normal((n, m)).astype(np.float32) * 0.1
    x[0, 1, :d] = np.nan
    y[1, 2, d:] = np.nan
    idx, mr = tknn_mr.knn_mr_grouped_reference(_t(x), _t(y), _t(bias), k,
                                               dilation, g)
    jx = np.asarray(fold_groups(_t(x), g))
    jy = np.asarray(fold_groups(_t(y), g))
    j_idx, j_mr = _xla_knn_mr(jnp.asarray(jx), jnp.asarray(jy),
                              jnp.asarray(bias), k, dilation)
    ref_idx = np.asarray(j_idx).reshape(b, g, n, k).transpose(0, 2, 1, 3)
    ref_mr = unfold_groups(_t(np.asarray(j_mr)), g).numpy()
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_allclose(mr.numpy(), ref_mr, rtol=1e-5, atol=1e-5)
    assert idx[0, 1, 0].tolist() == list(range(0, k * dilation, dilation))
    assert not (idx[1, :, 1] == 2).any()
