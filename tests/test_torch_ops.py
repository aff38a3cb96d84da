"""Parity of the PyTorch port's graph-core ops with the JAX package, on the
CPU. Inputs are made with numpy from a seed and handed to both frameworks.

``knn_mr_reference`` (the plain version of the port's CUDA kernel) is held
against the JAX package's Pallas kernel, run in interpret mode, and against
its XLA path: idx bitwise, mr within 1e-5 in fp32.
"""

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
