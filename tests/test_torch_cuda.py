"""Tests of the port's CUDA kernels on the card. Without a card they skip.

On the machine with the card (which has no JAX) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

``--noconftest`` because ``tests/conftest.py`` imports JAX. This file
imports no JAX, and each test decides inside a fixture whether a card is
present.
"""

import contextlib
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (GATHER_KERNELS, check_topk, folded_route,  # noqa: E402
                        forced_chunked, fp32_block, kernels_of, tie_fixture,
                        topk_fixture)
from gkgnet_tpu_torch.core.optim import build_optimizer  # noqa: E402
from gkgnet_tpu_torch.core.trainer import (create_train_state,  # noqa: E402
                                           make_device_normalize,
                                           make_eval_step, make_train_step)
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier, init_parameters  # noqa: E402
from gkgnet_tpu_torch.nn import grapher  # noqa: E402
from gkgnet_tpu_torch.ops import aggregate, knn_mr, knn_topk  # noqa: E402
from gkgnet_tpu_torch.ops.aggregate import (fold_groups,  # noqa: E402
                                            gather_nodes, max_relative,
                                            unfold_groups)
from gkgnet_tpu_torch.ops.knn import (knn_graph,  # noqa: E402
                                      knn_topk_reference, l2_normalize)
from gkgnet_tpu_torch.ops.pos_embed import get_relative_pos_table  # noqa: E402
from gkgnet_tpu_torch.tools import exp_kernel_phases as phases  # noqa: E402
from gkgnet_tpu_torch.utils.weights import init_block_parameters  # noqa: E402

pytestmark = pytest.mark.cuda

ORACLE_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(bg, n, m, d, bias_kind, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((bg, n, d), generator=g).to(dtype)
    y = x if m is None else torch.randn((bg, m, d), generator=g).to(dtype)
    m = n if m is None else m
    bias = {None: None,
            "shared": torch.randn((n, m), generator=g) * 0.1,
            "batched": torch.randn((bg, n, m), generator=g) * 0.1}[bias_kind]
    return x, y, bias


@pytest.mark.parametrize("d,dtype", [(12, torch.float32),
                                     (40, torch.bfloat16),
                                     (320, torch.bfloat16),
                                     (7, torch.float32)])
def test_launch_normalize_is_the_forwards_normalization(cuda, d, dtype):
    """``launch_normalize`` (the forward's row normalization alone, which
    the ring and label-sharded builds rank with) is bitwise the xn the
    fused forward computes its distances from, zero rows included, with
    one counted launch."""
    x, y, _ = _inputs(2, 50, 30, d, None, dtype)
    x[0, 0] = 0
    x, y = x.to(cuda), y.to(cuda)
    _, _, xn, yn = knn_mr.launch(x, y, None, 3, 1)
    before = knn_mr.normalize_launches
    got_x, got_y = knn_mr.launch_normalize(x), knn_mr.launch_normalize(y)
    torch.cuda.synchronize()
    assert knn_mr.normalize_launches == before + 2
    assert torch.equal(got_x, xn) and torch.equal(got_y, yn)
    assert (got_x[0, 0] == 0).all()


@pytest.mark.parametrize("bg,n,m,d,k,dilation,bias_kind,dtype", [
    (2, 100, 70, 12, 4, 1, "shared", torch.float32),   # ragged N and M
    (3, 64, None, 40, 9, 2, "shared", torch.bfloat16),  # self-kNN
    (2, 37, 300, 200, 9, 3, "batched", torch.bfloat16),
    (2, 80, 1500, 320, 9, 1, None, torch.bfloat16),
    (1, 33, 130, 7, 5, 7, None, torch.float32),         # k*d=35: 64-lists
    (2, 20, 5, 3, 5, 1, None, torch.float32),           # k*d == M
])
def test_kernel_matches_plain(cuda, bg, n, m, d, k, dilation, bias_kind,
                              dtype):
    x, y, bias = _inputs(bg, n, m, d, bias_kind, dtype)
    self_knn = y is x
    x = x.to(cuda)
    y = x if self_knn else y.to(cuda)
    bias = None if bias is None else bias.to(cuda)
    before = knn_mr.launches
    idx, mr, xn, yn = knn_mr.launch(x, y, bias, k, dilation)
    torch.cuda.synchronize()
    assert knn_mr.launches == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (bg, n, k)
    assert mr.dtype == dtype and mr.shape == x.shape
    assert torch.equal(mr, max_relative(x, idx, y))
    gaps = knn_mr.ordering_gaps(xn, yn, bias, idx, dilation)
    assert gaps.max().item() <= ORACLE_TOL
    # the kernel's normalized rows are the plain l2_normalize's, to 1 ulp
    torch.testing.assert_close(xn.float(), l2_normalize(x).float(),
                               rtol=2 ** -7, atol=1e-6)


def _duplicated_rows():
    x = torch.ones((1, 8, 4))
    y = torch.cat([torch.ones((1, 3, 4)), torch.zeros((1, 5, 4))], 1)
    return x, y, 3, 1


def _quantized():
    g = torch.Generator().manual_seed(8)
    x = torch.randint(0, 2, (2, 48, 6), generator=g).float()
    y = torch.randint(0, 2, (2, 160, 6), generator=g).float()
    return x, y, 5, 1


def _constant(dilation):
    def make():
        return (torch.full((2, 40, 8), 0.7), torch.full((2, 192, 8), 0.7),
                3, dilation)
    return make


def _lane_collision():
    g = torch.Generator().manual_seed(9)
    x = torch.randn((1, 16, 8), generator=g)
    y = torch.randn((1, 768, 8), generator=g) * 10.0
    for j, c in enumerate([7, 135, 263, 391, 7 + 4 * 128]):
        y[:, c] = x[:, j % 16] * (1.0 + 0.01 * j)
    return x, y, 4, 2


@pytest.mark.parametrize("make", [
    _duplicated_rows, _quantized, _constant(1), _constant(2),
    _lane_collision,
], ids=["duplicated_rows", "quantized", "constant_d1", "constant_d2",
        "lane_collision"])
def test_kernel_tie_fixtures_match_plain_bitwise(cuda, make):
    """Exact ties: the lowest column wins, as in the plain version."""
    x, y, k, dilation = make()
    x, y = x.to(cuda), y.to(cuda)
    idx, mr = knn_mr.knn_mr_fused(x, y, None, k, dilation)
    ref_idx, ref_mr = knn_mr.knn_mr_reference(x, y, None, k, dilation)
    assert torch.equal(idx, ref_idx)
    assert torch.equal(mr, ref_mr)


@pytest.mark.parametrize("case", ["not_contiguous", "bias_on_cpu",
                                  "kd_over_64"])
def test_kernel_wrapper_rejects_bad_inputs(cuda, case):
    x = torch.randn((2, 16, 8), device=cuda)
    y = torch.randn((2, 100, 8), device=cuda)
    bias = torch.zeros((16, 100), device=cuda)
    k, dilation = 3, 1
    if case == "not_contiguous":
        x = torch.randn((2, 8, 16), device=cuda).transpose(1, 2)
    elif case == "bias_on_cpu":
        bias = bias.cpu()
    else:
        k, dilation = 13, 5
    before = knn_mr.launches
    with pytest.raises(ValueError):
        knn_mr.knn_mr_fused(x, y, bias, k, dilation)
    assert knn_mr.launches == before


@pytest.mark.parametrize("batch", [1, 2])
def test_model_forward_on_card_matches_cpu(cuda, batch):
    """Small model (arch t, size 128, k=2) in fp32: the kernel path on the
    card against the plain path on the CPU; 16 launches per forward."""
    model = GKGNetClassifier(arch="t", k=2, k_label_gcn=2, n_classes=6,
                             size=128)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    x = torch.randn((batch, 128, 128, 3),
                    generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            plain, _ = model(x)
            model.to(cuda)
            before = knn_mr.launches
            got, _ = model(x.to(cuda))
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert knn_mr.launches - before == 16
    scale = plain.abs().max().item()
    assert (got.cpu() - plain).abs().max().item() <= 1e-3 * scale


def _nan_rows(dtype):
    """Seeded rows with a NaN query row and a NaN target row."""
    g = torch.Generator().manual_seed(12)
    x = torch.randn((2, 40, 6), generator=g)
    y = torch.randn((2, 96, 6), generator=g)
    x[0, 3] = float("nan")
    y[1, 5] = float("nan")
    return x.to(dtype), y.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_nan_rows_match_plain(cuda, dtype):
    """NaN distances order after every number: an all-NaN query row selects
    columns 0, d, 2d, ... (in range, distinct) with a NaN mr, and a NaN
    target row is never selected where enough finite candidates exist;
    idx and mr equal the plain version's."""
    x, y = _nan_rows(dtype)
    k, dilation = 4, 2
    ref_idx, ref_mr = knn_mr.knn_mr_reference(x, y, None, k, dilation)
    idx, mr = knn_mr.knn_mr_fused(x.to(cuda), y.to(cuda), None, k, dilation)
    torch.cuda.synchronize()
    assert torch.equal(idx.cpu(), ref_idx)
    torch.testing.assert_close(mr.cpu(), ref_mr, rtol=0, atol=0,
                               equal_nan=True)
    assert idx[0, 3].tolist() == [0, 2, 4, 6]
    assert torch.isnan(mr[0, 3]).all()
    assert not (idx[1] == 5).any()


def _bwd_case(bg, n, m, d, k, dilation, dtype, self_knn, seed=0):
    """Inputs on the card with exact ties (``tie_fixture``), the forward
    kernel's idx, and an output gradient g."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((bg, n, d), generator=gen)
    y = x if self_knn else torch.randn((bg, m, d), generator=gen)
    tie_fixture(x, y)
    x = x.to(dtype).cuda()
    y = x if self_knn else y.to(dtype).cuda()
    idx, _ = knn_mr.knn_mr_fused(x, y, None, k, dilation)
    g = torch.randn((bg, n, d), generator=gen).to(dtype).cuda()
    return x, y, idx, g


def _bits(t):
    """The bit patterns of a float tensor, for bitwise comparisons that tell
    -0.0 from 0.0."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _check_bwd_kernel(x, y, idx, g):
    """One backward launch against the plain versions: gx bitwise -g, gy
    bitwise ``knn_mr_backward_ordered_reference`` (the same fp32 sums in
    the same order, which also holds the tie sets), within
    ``backward_gy_bound`` of the fp64 sum, and a second launch bitwise
    equal (no atomics). Returns gy."""
    before = knn_mr.backward_launches
    gx, gy = knn_mr.launch_backward(x, y, idx, g)
    torch.cuda.synchronize()
    assert knn_mr.backward_launches == before + 1
    assert gx.dtype == x.dtype and gy.dtype == y.dtype and gy.shape == y.shape
    assert torch.equal(gx, -g)
    _, want = knn_mr.knn_mr_backward_ordered_reference(x, y, idx, g)
    assert torch.equal(_bits(gy), _bits(want))
    ge = knn_mr.edge_gradients_reference(x, y, idx, g)
    exact, bound = knn_mr.backward_gy_bound(ge, idx, y.shape[1])
    finite = torch.isfinite(exact)
    assert ((gy.double() - exact).abs() <= bound)[finite].all()
    gx2, gy2 = knn_mr.launch_backward(x, y, idx, g)
    assert torch.equal(_bits(gy2), _bits(gy)) and torch.equal(gx2, gx)
    return gy


@pytest.mark.parametrize("bg,n,m,d,k,dilation,dtype,self_knn", [
    (2, 100, 70, 12, 4, 1, torch.float32, False),
    (2, 64, None, 40, 9, 2, torch.bfloat16, True),
    (3, 37, 300, 200, 9, 3, torch.bfloat16, False),
    (2, 80, 1500, 40, 9, 1, torch.bfloat16, False),    # label-like: M >> N
    (1, 300, None, 33, 5, 1, torch.float32, True),
])
def test_backward_kernel_matches_plain(cuda, bg, n, m, d, k, dilation, dtype,
                                       self_knn):
    """The backward kernel against the plain versions on the forward
    kernel's idx of rows with exact ties (``_check_bwd_kernel``)."""
    x, y, idx, g = _bwd_case(bg, n, m or n, d, k, dilation, dtype, self_knn)
    ge = knn_mr.edge_gradients_reference(x, y, idx, g)
    assert ((ge[:, 0] != 0).sum(dim=1) >= 2).all(), "row 0 must tie"
    _check_bwd_kernel(x, y, idx, g)


def _distinct_idx(bg, n, m, k, gen):
    """Seeded idx (bg, n, k), int32, k distinct targets per row."""
    return torch.rand((bg, n, m), generator=gen).argsort(-1)[..., :k].to(
        torch.int32)


def _bwd_hub(dtype):
    """One target with 4500 incoming edges in each group (every row holds
    target 3, at slot n % k), whose edges come from every ranking unit of
    the group (18000 edges); target 5 equals target 3, so the rows holding
    both tie."""
    gen = torch.Generator().manual_seed(31)
    bg, n, m, d, k = 2, 4500, 64, 40, 4
    idx = _distinct_idx(bg, n, m - 1, k, gen)
    idx = idx + (idx >= 3).to(torch.int32)  # targets other than 3
    rows = torch.arange(n)
    idx[:, rows, rows % k] = 3
    x = torch.randn((bg, n, d), generator=gen)
    y = torch.randn((bg, m, d), generator=gen)
    y[:, 5] = y[:, 3]
    return x.to(dtype), y.to(dtype), idx, 3


def _bwd_no_edges(dtype):
    """Label-like (M >> N): most targets get no edge, and their gy is 0."""
    gen = torch.Generator().manual_seed(32)
    x = torch.randn((2, 30, 40), generator=gen).to(dtype)
    y = torch.randn((2, 5000, 40), generator=gen).to(dtype)
    idx, _ = knn_mr.knn_mr_reference(x, y, None, 9)
    return x, y, idx, None


def _bwd_nan_rows(dtype):
    """A NaN query row (its channels get no gradient) and a NaN target row
    that 10 rows chose: those rows' channels get none either."""
    gen = torch.Generator().manual_seed(33)
    x = torch.randn((2, 40, 16), generator=gen)
    y = torch.randn((2, 96, 16), generator=gen)
    x[0, 3] = float("nan")
    y[1, 5] = float("nan")
    idx = _distinct_idx(2, 40, 95, 6, gen)
    idx = idx + (idx >= 5).to(torch.int32)  # targets other than 5
    idx[1, :10, 0] = 5
    return x.to(dtype), y.to(dtype), idx, None


def _bwd_k1(dtype):
    """k = 1: every edge carries its row's whole gradient."""
    gen = torch.Generator().manual_seed(34)
    x = torch.randn((3, 200, 24), generator=gen).to(dtype)
    y = torch.randn((3, 50, 24), generator=gen).to(dtype)
    return x, y, _distinct_idx(3, 200, 50, 1, gen), None


def _bwd_d33(dtype):
    """D = 33, not a multiple of 8: the kernels' scalar loads, a last chunk
    of one channel; exact ties from ``tie_fixture``."""
    gen = torch.Generator().manual_seed(35)
    x = torch.randn((2, 120, 33), generator=gen)
    y = torch.randn((2, 90, 33), generator=gen)
    tie_fixture(x, y)
    x, y = x.to(dtype).cuda(), y.to(dtype).cuda()
    idx, _ = knn_mr.knn_mr_fused(x, y, None, 7, 1)
    return x, y, idx.cpu(), None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("make", [_bwd_hub, _bwd_no_edges, _bwd_nan_rows,
                                  _bwd_k1, _bwd_d33],
                         ids=["hub", "no_edges", "nan_rows", "k1", "d33"])
def test_backward_kernel_edge_cases(cuda, make, dtype):
    """The backward kernel at the inverse list's edges (``_check_bwd_kernel``
    each): a hub target over many ranking units, targets with no edge
    (gy exactly 0), NaN query and target rows, k = 1, D = 33."""
    x, y, idx, hub = make(dtype)
    gen = torch.Generator().manual_seed(36)
    g = torch.randn(x.shape, generator=gen).to(dtype)
    x, y, idx, g = x.to(cuda), y.to(cuda), idx.to(cuda), g.to(cuda)
    gy = _check_bwd_kernel(x, y, idx, g)
    count = torch.bincount(knn_mr._flat_targets(idx, y.shape[1]),
                           minlength=y.shape[0] * y.shape[1])
    no_edge = (count == 0).reshape(y.shape[:2])
    assert (gy[no_edge] == 0).all()
    if make is _bwd_hub:
        assert (count.reshape(y.shape[:2])[:, hub] >= 4000).all()
    if make is _bwd_no_edges:
        assert no_edge.float().mean() > 0.9
    if make is _bwd_nan_rows:
        assert torch.isfinite(gy).all()


@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
def test_autograd_on_card_matches_cpu(cuda, self_knn):
    """torch.autograd through ``knn_mr_fused`` on the card (both kernels)
    against the CPU's plain path, fp32, on seeded rows whose graph both
    build alike (asserted): the gradients within 1e-6 (the same sums,
    taken in the same order on both)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 50, 8), generator=gen)
    y = x if self_knn else torch.randn((2, 70, 8), generator=gen)
    w = torch.randn((2, 50, 8), generator=gen)
    grads, graphs = [], []
    for device in ("cpu", cuda):
        xd = x.to(device, copy=True).requires_grad_()
        yd = xd if self_knn else y.to(device, copy=True).requires_grad_()
        idx, mr = knn_mr.knn_mr_fused(xd, yd, None, 5, 2)
        (mr * w.to(device)).sum().backward()
        graphs.append(idx.cpu())
        grads.append((xd.grad.cpu(), None if self_knn else yd.grad.cpu()))
    assert torch.equal(graphs[0], graphs[1])
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=1e-6,
                               atol=1e-6)
    if not self_knn:
        torch.testing.assert_close(grads[1][1], grads[0][1], rtol=1e-6,
                                   atol=1e-6)


def test_train_step_on_card_matches_cpu(cuda):
    """One training step of the small model (arch t, size 128, k=3, fp32,
    TF32 off, batch 2, drop_path 0): the kernel path on the card against
    the plain path on the CPU. 16 forward and 16 backward launches; the
    losses within 1e-4 relative; every gradient leaf within 1e-2 of its
    largest |g| (floored at 1e-4 of the model's largest, as in
    tests/test_torch_train.py: fp32 sums in other orders and max-relative
    near-ties); the running statistics within 1e-4 of each leaf's largest
    value (floor 1e-6)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    img = torch.randn((2, 128, 128, 3), generator=gen)
    gt = (torch.rand((2, 10), generator=gen) < 0.3).float()
    results = []
    try:
        for device in ("cpu", cuda):
            model = GKGNetClassifier(arch="t", k=3, k_label_gcn=3,
                                     n_classes=10, size=128)
            init_parameters(model, torch.Generator().manual_seed(0))
            model = model.to(device)
            state = create_train_state(model, build_optimizer(model, 1e-4))
            before = (knn_mr.launches, knn_mr.backward_launches)
            state, logs = make_train_step()(
                state, {"img": img.to(device), "gt_label": gt.to(device)})
            if device != "cpu":
                torch.cuda.synchronize()
                assert knn_mr.launches - before[0] == 16
                assert knn_mr.backward_launches - before[1] == 16
            grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
            stats = {k: v.cpu() for k, v in model.state_dict().items()
                     if "running" in k}
            results.append((logs, grads, stats))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (cpu_logs, cpu_grads, cpu_stats), (logs, grads, stats) = results
    for key in ("bce_loss", "asy_loss", "loss", "grad_norm"):
        torch.testing.assert_close(logs[key].cpu(), cpu_logs[key],
                                   rtol=1e-4, atol=0)
    floor = 1e-4 * max(g.abs().max().item() for g in cpu_grads.values())
    for key, g in cpu_grads.items():
        scale = max(g.abs().max().item(), floor)
        assert (grads[key] - g).abs().max().item() <= 1e-2 * scale, key
    for key, v in cpu_stats.items():
        bound = max(1e-4 * v.abs().max().item(), 1e-6)
        assert (stats[key] - v).abs().max().item() <= bound, key


# ------------------------------------------------ knn_topk (knn_graph's kernel)


@pytest.mark.parametrize("bg,n,m,d,k,bias_kind,dtype", [
    (2, 100, 70, 12, 4, "shared", torch.float32),     # ragged N and M
    (3, 64, None, 40, 9, "shared", torch.bfloat16),   # self-kNN
    (2, 37, 300, 200, 18, "batched", torch.bfloat16),
    (2, 80, 1500, 80, 9, None, torch.bfloat16),       # label-like: M >> N
    (1, 33, 130, 7, 35, None, torch.float32),         # 64-lists
    (2, 20, 64, 3, 64, None, torch.float32),          # k == M == 64
    (2, 40, 90, 640, 27, "shared", torch.bfloat16),   # D = 640: 187 KB smem
    (1, 50, 60, 16, 5, None, torch.float16),          # cast to fp32
])
def test_topk_kernel_matches_plain(cuda, bg, n, m, d, k, bias_kind, dtype):
    """The kernel against ``knn_topk_reference`` on normalized rows: the
    fp64 ordering oracle, idx equal to the plain version's except at
    oracle near-ties, each returned distance within its fp32 bound of the
    fp64 one (``chip_smoke.check_topk``); idx alone equals idx with values;
    one launch counted per call."""
    x, y, bias = _inputs(bg, n, m, d, bias_kind, torch.float32)
    self_knn = y is x
    xn = l2_normalize(x.to(cuda)).to(dtype)
    yn = xn if self_knn else l2_normalize(y.to(cuda)).to(dtype)
    bias = None if bias is None else bias.to(cuda)
    before = knn_topk.launches
    idx, vals = knn_topk.launch(xn, yn, k=k, bias=bias, return_values=True)
    torch.cuda.synchronize()
    assert knn_topk.launches == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (bg, n, k)
    assert vals.dtype == torch.float32 and vals.shape == (bg, n, k)
    stats = check_topk("card", xn, yn, bias, idx, vals)
    assert stats["oracle_worst_gap"] <= ORACLE_TOL
    assert torch.equal(knn_topk.launch(xn, yn, k=k, bias=bias), idx)


def _normalized_pair(x, y):
    xn = l2_normalize(x)
    return xn, (xn if y is x else l2_normalize(y))


@pytest.mark.parametrize("make,bitwise", [
    (_duplicated_rows, True), (_quantized, False), (_constant(1), True),
    (_lane_collision, True),
], ids=["duplicated_rows", "quantized", "constant", "lane_collision"])
def test_topk_kernel_tie_fixtures_match_plain(cuda, make, bitwise):
    """Ties and near-collisions: the fp64 oracle, the plain idx up to
    near-ties and each distance within its fp32 bound (``check_topk``);
    where the tied distances are bitwise equal in both versions (equal
    rows) or the fixture stresses the lanes' lists (lane_collision), idx
    bitwise the plain version's: the lowest column wins every tie. The
    quantized rows tie in exact arithmetic only: each version's fp32 sums
    (the kernel's lane-strided y_sq, the plain version's blocked products)
    round some tied pairs apart, each in its own way."""
    x, y, k, dilation = make()
    xn, yn = _normalized_pair(x, y)
    kd = k * dilation
    idx, vals = knn_topk.launch(xn.to(cuda), yn.to(cuda), k=kd,
                                return_values=True)
    check_topk("fixture", xn.to(cuda), yn.to(cuda), None, idx, vals)
    if bitwise:
        assert torch.equal(idx.cpu(), knn_topk_reference(xn, yn, k=kd))


@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_topk_kernel_nan_rows_match_plain(cuda, dtype, self_knn):
    """NaN distances order after every number in column order: a NaN query
    row selects columns 0..k-1 with NaN values, a NaN target row is never
    selected; the fixture's tied and NaN rows equal the plain version's
    bitwise (``chip_smoke.topk_fixture``)."""
    g = torch.Generator().manual_seed(13)
    x = torch.randn((2, 40, 6), generator=g)
    y = x if self_knn else torch.randn((2, 96, 6), generator=g)
    rows = topk_fixture(x, y, self_knn)
    xn = l2_normalize(x.to(dtype))
    yn = xn if self_knn else l2_normalize(y.to(dtype))
    k = 7
    ref_idx, ref_vals = knn_topk_reference(xn, yn, k=k, return_values=True)
    idx, vals = knn_topk.launch(xn.to(cuda), yn.to(cuda), k=k,
                                return_values=True)
    idx, vals = idx.cpu(), vals.cpu()
    for b, r in rows:
        assert torch.equal(idx[b, r], ref_idx[b, r]), (b, r)
    assert idx[0, 10].tolist() == list(range(k))
    assert torch.isnan(vals[0, 10]).all()
    finite = torch.isfinite(xn[1]).all(-1)
    assert not (idx[1][finite] == 5).any()
    assert idx[0, 0, :4].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("case", ["not_contiguous", "bias_on_cpu",
                                  "k_over_64", "k_over_m", "too_many_rows",
                                  "too_wide_bf16"])
def test_topk_kernel_rejects_bad_inputs(cuda, case):
    x = torch.randn((2, 16, 8), device=cuda)
    y = torch.randn((2, 100, 8), device=cuda)
    bias = torch.zeros((16, 100), device=cuda)
    k = 3
    if case == "not_contiguous":
        x = torch.randn((2, 8, 16), device=cuda).transpose(1, 2)
    elif case == "bias_on_cpu":
        bias = bias.cpu()
    elif case == "k_over_64":
        k = 65
    elif case == "k_over_m":
        k = 101
    elif case == "too_many_rows":  # the grid's y extent at 8 rows a block
        x = torch.randn((1, 8 * 65535 + 1, 1), device=cuda)
        y = torch.randn((1, 100, 1), device=cuda)
        bias = None
    else:  # even the chunked scan's merge rows do not fit, at 1 warp
        x = torch.randn((2, 16, 30000), device=cuda).to(torch.bfloat16)
        y = torch.randn((2, 100, 30000), device=cuda).to(torch.bfloat16)
    before = knn_topk.launches
    with pytest.raises(ValueError):
        knn_topk.launch(x, y, k=k, bias=bias)
    assert knn_topk.launches == before


def _block_edges(block, args):
    """The graph of a block's graph conv in eval mode."""
    with torch.no_grad():
        h = block.fc1(args[0])
        if isinstance(block, grapher.Grapher):
            return block.graph_conv(h, args[1])[1]
        b, hh, w, c = args[1].shape
        return block.graph_conv(h, args[1].reshape(b, hh * w, c))[1]


@pytest.mark.parametrize("conv", ["edge", "sage", "gin", "gat"])
def test_aggregator_blocks_on_card_match_cpu(cuda, conv):
    """A Grapher (r=2, with its relative-position table) and a GrapherLabel
    with each aggregator, in fp32 (TF32 off): the card (knn_topk, one launch
    per graph conv, no knn_mr) against the CPU (the plain version). The
    eval graphs equal (asserted, so what is compared is the aggregators);
    the eval output, the train-mode output and every gradient of a scalar
    loss within 1e-4 of their largest value (the same sums in other
    orders)."""
    c, side = 16, 8
    gen = torch.Generator().manual_seed(21)
    x = torch.randn((2, side, side, c), generator=gen)
    labels = torch.randn((2, 6, c), generator=gen)
    bias = torch.from_numpy(get_relative_pos_table(c, side * side, 2))
    makers = (
        (lambda: grapher.Grapher(c, 4, 1, conv, "gelu", r=2,
                                 use_multi_group=False), (x, bias)),
        (lambda: grapher.GrapherLabel(c, 4, conv=conv, act="gelu",
                                      use_multi_group=False), (labels, x)))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for make, inputs in makers:
            results = []
            for device in ("cpu", cuda):
                block = make()
                init_block_parameters(block, torch.Generator().manual_seed(3))
                block.to(device).eval()
                args = [a.to(device) for a in inputs]
                before = (knn_topk.launches, knn_mr.launches)
                edges = _block_edges(block, args)
                with torch.no_grad():
                    out_eval = block(*args)
                out = block.train()(*args)
                out_eval, out = (o[0] if isinstance(o, tuple) else o
                                 for o in (out_eval, out))
                out.square().sum().backward()
                if device != "cpu":
                    torch.cuda.synchronize()
                    assert knn_topk.launches - before[0] == 3
                    assert knn_mr.launches == before[1]
                results.append((edges.cpu(), out_eval.cpu(),
                                out.detach().cpu(),
                                {k: p.grad.cpu()
                                 for k, p in block.named_parameters()}))
            (i0, e0, t0, g0), (i1, e1, t1, g1) = results
            assert torch.equal(i0, i1)
            for got, ref in ((e1, e0), (t1, t0)):
                assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
            # a leaf that is zero in exact arithmetic (a bias before a
            # train-mode BN) holds rounding noise on both sides
            noise = 1e-5 * max(g.abs().max().item() for g in g0.values())
            for key, ref in g0.items():
                scale = ref.abs().max().item()
                if scale <= noise:
                    assert g1[key].abs().max().item() <= noise, key
                    continue
                assert (g1[key] - ref).abs().max() <= 1e-4 * scale, key
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def test_knn_graph_on_card_launches_the_kernel(cuda):
    """knn_graph on CUDA tensors normalizes and launches the kernel once;
    the result equals the plain version's on the same normalized rows
    (seeded rows without near-ties at this size, asserted by the oracle in
    the kernel tests)."""
    g = torch.Generator().manual_seed(22)
    x = torch.randn((2, 30, 8), generator=g)
    y = torch.randn((2, 50, 8), generator=g)
    before = knn_topk.launches
    idx = knn_graph(x.to(cuda), y.to(cuda), k=6)
    torch.cuda.synchronize()
    assert knn_topk.launches == before + 1
    ref = knn_topk_reference(l2_normalize(x), l2_normalize(y), k=6)
    assert torch.equal(idx.cpu(), ref)


# ------------------------------------- knn_mr_fused_grouped: the contract


@pytest.mark.parametrize("b,g,n,m,d,k,dilation,bias_kind,dtype", [
    (2, 2, 100, 70, 12, 4, 1, "shared", torch.float32),   # ragged N and M
    (3, 2, 64, None, 40, 9, 2, "shared", torch.bfloat16),  # self-kNN
    (2, 4, 37, 300, 20, 9, 3, None, torch.bfloat16),      # 4 groups
    (1, 2, 33, 130, 7, 5, 7, None, torch.float32),        # k*d=35
    (8, 2, 20736, 1296, 40, 9, 1, "table", torch.bfloat16),  # s@576 stage 1
    (8, 2, 1296, None, 200, 9, 3, "table", torch.bfloat16),  # stage 3, d 3
    (8, 2, 80, 20736, 40, 9, 1, None, torch.bfloat16),    # label 1
    (2, 2, 324, None, 320, 9, 3, "table", torch.float32),  # stage 4, fp32
])
def test_grouped_kernel_matches_folded(cuda, b, g, n, m, d, k, dilation,
                                       bias_kind, dtype):
    """The group-strided kernel on unfolded rows against fold -> the folded
    kernel -> unfold: idx and mr bitwise, at small shapes and at s@576's; one
    grouped launch and no folded one; mr bitwise the plain max-relative of
    its own idx, per group."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((b, n, g * d), generator=gen).to(dtype).to(cuda)
    y = x if m is None else torch.randn((b, m, g * d), generator=gen).to(
        dtype).to(cuda)
    m = n if m is None else m
    bias = None
    if bias_kind == "shared":
        bias = (torch.randn((n, m), generator=gen) * 0.1).to(cuda)
    elif bias_kind == "table":
        bias = torch.from_numpy(get_relative_pos_table(
            g * d, n, int(round((n / m) ** 0.5)))).to(cuda)
    before = (knn_mr.launches, knn_mr.grouped_launches)
    idx, mr, xn, yn = knn_mr.launch_grouped(x, y, bias, k, dilation, g)
    torch.cuda.synchronize()
    assert (knn_mr.launches, knn_mr.grouped_launches) == (before[0],
                                                          before[1] + 1)
    assert idx.shape == (b, n, g, k) and mr.shape == x.shape
    assert xn.shape == (b * g, n, d) and (yn is xn) == (y is x)
    ref_idx, ref_mr = folded_route(x, y, bias, k, dilation, g)
    assert torch.equal(idx, ref_idx)
    assert torch.equal(mr, ref_mr)
    idx_f = idx.permute(0, 2, 1, 3).reshape(b * g, n, k)
    assert torch.equal(fold_groups(mr, g), max_relative(
        fold_groups(x, g), idx_f, fold_groups(y, g)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_grouped_kernel_nan_and_tie_rows_match_folded(cuda, dtype):
    """Exact ties (``tie_fixture`` on the unfolded rows: every group ties),
    a NaN query row in group 0 of batch 0 and a NaN target row in group 1
    of batch 1: the grouped kernel equals fold -> kernel -> unfold bitwise
    (the NaN rows' columns in column order, as select_nan_columns walks the
    folded scratch), and the plain version."""
    gen = torch.Generator().manual_seed(12)
    g, d, k, dilation = 2, 6, 4, 2
    x = torch.randn((2, 40, g * d), generator=gen)
    y = torch.randn((2, 96, g * d), generator=gen)
    tie_fixture(x, y)
    x[0, 3, :d] = float("nan")
    y[1, 5, d:] = float("nan")
    x, y = x.to(dtype).to(cuda), y.to(dtype).to(cuda)
    idx, mr, _, _ = knn_mr.launch_grouped(x, y, None, k, dilation, g)
    ref_idx, ref_mr = folded_route(x, y, None, k, dilation, g)
    plain_idx, plain_mr = knn_mr.knn_mr_grouped_reference(x, y, None, k,
                                                          dilation, g)
    for want_idx, want_mr in ((ref_idx, ref_mr), (plain_idx, plain_mr)):
        assert torch.equal(idx, want_idx)
        torch.testing.assert_close(mr, want_mr, rtol=0, atol=0,
                                   equal_nan=True)
    assert idx[0, 3, 0].tolist() == [0, 2, 4, 6]
    assert torch.isnan(mr[0, 3, :d]).all() and not torch.isnan(
        mr[0, 3, d:]).any()
    assert not (idx[1, :, 1] == 5).any()
    assert idx[:, 0, :, :2].tolist() == [[[0, 2], [0, 2]]] * 2


@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
def test_grouped_backward_matches_folded(cuda, self_knn):
    """Autograd through ``knn_mr_fused_grouped`` on the card against autograd
    through fold -> ``knn_mr_fused`` -> unfold on the same rows (bf16, with
    exact ties): the gradients bitwise (the same folded backward kernel on
    the same folded inputs; with y = x the two parts sum into the one
    input in the same order); one grouped forward launch and one backward
    launch, no folded forward launch."""
    gen = torch.Generator().manual_seed(5)
    g, d, k, dilation = 2, 40, 9, 2
    x = torch.randn((4, 300, g * d), generator=gen)
    y = x if self_knn else torch.randn((4, 200, g * d), generator=gen)
    tie_fixture(x, y)
    w = torch.randn((4, 300, g * d), generator=gen).to(torch.bfloat16).cuda()
    grads, counts = [], []
    for grouped in (True, False):
        xd = x.to(torch.bfloat16).cuda().requires_grad_()
        yd = xd if self_knn else y.to(torch.bfloat16).cuda().requires_grad_()
        before = (knn_mr.launches, knn_mr.grouped_launches,
                  knn_mr.backward_launches)
        if grouped:
            _, mr = knn_mr.knn_mr_fused_grouped(xd, yd, None, k, dilation, g)
        else:
            xf = fold_groups(xd, g)
            _, mrf = knn_mr.knn_mr_fused(
                xf, xf if self_knn else fold_groups(yd, g), None, k,
                dilation)
            mr = unfold_groups(mrf, g)
        (mr * w).float().sum().backward()
        torch.cuda.synchronize()
        counts.append(tuple(a - c for a, c in zip(
            (knn_mr.launches, knn_mr.grouped_launches,
             knn_mr.backward_launches), before)))
        grads.append((xd.grad, None if self_knn else yd.grad))
    assert counts == [(0, 1, 1), (1, 0, 1)]
    assert torch.equal(grads[0][0], grads[1][0])
    if not self_knn:
        assert torch.equal(grads[0][1], grads[1][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
def test_grouped_backward_kernel_matches_folded(cuda, self_knn, dtype):
    """The group-strided backward on the unfolded rows as they are against
    fold -> the folded backward -> unfold: gx and gy bitwise (with exact
    ties, 3 groups, D = 40); one backward launch each."""
    gen = torch.Generator().manual_seed(7)
    b, g, n, d, k, dilation = 3, 3, 250, 40, 9, 2
    x = torch.randn((b, n, g * d), generator=gen)
    y = x if self_knn else torch.randn((b, 180, g * d), generator=gen)
    tie_fixture(x, y)
    x = x.to(dtype).to(cuda)
    y = x if self_knn else y.to(dtype).to(cuda)
    grad = torch.randn((b, n, g * d), generator=gen).to(dtype).to(cuda)
    idx, _, _, _ = knn_mr.launch_grouped(x, y, None, k, dilation, g)
    before = knn_mr.backward_launches
    gx, gy = knn_mr.launch_backward_grouped(x, y, idx, grad, g)
    torch.cuda.synchronize()
    assert knn_mr.backward_launches == before + 1
    xf = fold_groups(x, g)
    yf = xf if self_knn else fold_groups(y, g)
    idxf = idx.permute(0, 2, 1, 3).reshape(b * g, n, k).contiguous()
    fgx, fgy = knn_mr.launch_backward(xf, yf, idxf, fold_groups(grad, g))
    assert torch.equal(_bits(gx), _bits(unfold_groups(fgx, g)))
    assert torch.equal(_bits(gy), _bits(unfold_groups(fgy, g)))
    assert torch.equal(gx, -grad)


def test_grouped_route_in_the_model_matches_default(cuda, monkeypatch):
    """The small model (arch t, size 128, k=2, fp32) with GKGNET_GROUPED=1:
    16 grouped launches and no folded one per forward, the logits bitwise
    the default route's (16 folded launches)."""
    model = GKGNetClassifier(arch="t", k=2, k_label_gcn=2, n_classes=6,
                             size=128)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    x = torch.randn((2, 128, 128, 3),
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    logits, counts = [], []
    for flag in ("0", "1"):
        monkeypatch.setenv("GKGNET_GROUPED", flag)
        before = (knn_mr.launches, knn_mr.grouped_launches)
        with torch.no_grad():
            logits.append(model(x)[0])
        torch.cuda.synchronize()
        counts.append((knn_mr.launches - before[0],
                       knn_mr.grouped_launches - before[1]))
    assert counts == [(16, 0), (0, 16)]
    assert torch.equal(logits[0], logits[1])


# --------------------------------------- exp_kernel_phases: the phase kernels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("phase", phases.PHASES)
def test_phase_kernel_matches_plain(cuda, phase, dtype):
    """Each phase kernel against its plain version at a small geometry
    (ragged N, M over two tiles): dist within twice ``dist_bound``, sel
    -inf, gfix within twice ``gather_bound``; selg within ``gather_bound``
    of the fp64 checksum of ``knn_mr.launch``'s own idx on the same rows
    (the same selection); one launch each."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((3, 45, 40), generator=gen).to(dtype).to(cuda)
    y = torch.randn((3, 100, 40), generator=gen).to(dtype).to(cuda)
    k = 9
    before = phases.launches
    got = phases.launch(phase, x, y, k)
    torch.cuda.synchronize()
    assert phases.launches == before + 1
    assert got.shape == (3, 45, 1) and got.dtype == torch.float32
    plain = phases.phase_reference(phase, x, y, k)
    if phase == "sel":
        assert (got == float("-inf")).all() and (plain == got).all()
        return
    if phase == "dist":
        exact, bound = phases.dist_bound(x, y)
    else:
        idx = (phases.fixed_columns(x, k) if phase == "gfix"
               else knn_mr.launch(x, y, None, k)[0])
        exact, bound = phases.gather_bound(x, y, idx)
    assert ((got.double() - exact).abs() <= bound).all()
    assert ((got.double() - plain.double()).abs() <= 2 * bound).all()


# ---------------- the bf16 tensor-core scan (csrc/knn_scan.cuh): its edges
#
# 16 query rows per warp, target tiles of 64 rows, channels padded to a
# multiple of 16, lists of 8, 12, 16, 24, 32 or 64 (k*d 5, 9, 16, 18, 27,
# 40 below) behind a threshold for the whole row. Each case runs knn_mr
# (folded and grouped) and knn_topk on the same rows and holds them to
# their plain versions: the fp64 ordering oracle, idx equal to the plain
# version's but at near-ties (``check_topk``), mr the plain max-relative of
# the kernel's idx, knn_topk(xn, yn, k*d)[..., ::d] bitwise knn_mr's idx,
# the grouped kernel bitwise fold -> folded kernel -> unfold, and the
# returned distances in lexicographic (distance, column) order.

TC_SHAPES = [  # (n, m, d, k, dilation): N, M ragged against 16 and 64
    (80, 1296, 40, 5, 1),
    (324, 324, 200, 9, 1),
    (80, 1296, 200, 8, 2),
    (324, 324, 40, 9, 2),
    (1296, 324, 40, 9, 3),
    (80, 324, 200, 20, 2),
]


def _tc_case(n, m, d, seed, fixture=None):
    """Seeded bf16 rows on the card: x (2, n, 2d) and y (2, m, 2d), two
    groups of d channels; ``fixture`` edits the fp32 rows first."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, n, 2 * d), generator=g)
    y = torch.randn((2, m, 2 * d), generator=g)
    if fixture is not None:
        fixture(x, y, g)
    return x.to(torch.bfloat16).cuda(), y.to(torch.bfloat16).cuda()


def _toward(q, angles, g):
    """Rows at the given angles from the unit rows q (B, d), in a random
    plane through each: (B, len(angles), d)."""
    v = torch.randn(q.shape[-1:], generator=g)
    v = v - (q * v).sum(-1, keepdim=True) * q
    v = v / v.norm(dim=-1, keepdim=True)
    a = torch.as_tensor(angles, dtype=torch.float32)
    return (torch.cos(a)[None, :, None] * q[:, None, :]
            + torch.sin(a)[None, :, None] * v[:, None, :])


def _exact_ties(x, y, g):
    """Groups of equal target rows, at the start (columns 0-3), across the
    first tile boundary (61-66) and in the fourth tile (200-202), each
    nearer to query row 7 than the group before it, and columns 300, 301
    nearer still: at that row each group is in the lists when nearer
    targets arrive and push it down."""
    d = y.shape[2] // 2
    for cs in (slice(0, d), slice(d, 2 * d)):
        q = x[:, 7, cs] / x[:, 7, cs].norm(dim=-1, keepdim=True)
        for (lo, hi), angle in (((0, 4), 0.9), ((61, 67), 0.7),
                                ((200, 203), 0.5)):
            y[:, lo:hi, cs] = _toward(q, [angle], g)
        y[:, 300:302, cs] = _toward(q, [0.2, 0.25], g)


def _falling(x, y, g):
    """Query row 5 of every batch and group meets targets in falling
    distance order: in each group, y_j at angle 0.5 + (1 - j / M) from it,
    so each target is nearer than every earlier one and passes any
    threshold."""
    m, d = y.shape[1], y.shape[2] // 2
    angles = 0.5 + (1.0 - torch.arange(m, dtype=torch.float32) / m)
    for cs in (slice(0, d), slice(d, 2 * d)):
        q = x[:, 5, cs] / x[:, 5, cs].norm(dim=-1, keepdim=True)
        y[:, :, cs] = _toward(q, angles, g)


def _check_lex_order(vals, idx):
    """Ascending distances, the lower column first among equal ones."""
    v, i = vals[..., :-1], vals[..., 1:]
    assert bool((v <= i).all())
    tied = vals[..., :-1] == vals[..., 1:]
    assert bool((idx[..., :-1][tied] < idx[..., 1:][tied]).all())


def _check_tc(x, y, k, dilation):
    """knn_mr, its grouped route and knn_topk on bf16 (B, N, 2D) rows (two
    groups), against their plain versions and each other."""
    kd = k * dilation
    xf, yf = fold_groups(x, 2), fold_groups(y, 2)
    idx, mr, xn, yn = knn_mr.launch(xf, yf, None, k, dilation)
    torch.cuda.synchronize()
    assert torch.equal(mr, max_relative(xf, idx, yf))
    assert knn_mr.ordering_gaps(xn, yn, None, idx, dilation).max().item() \
        <= ORACLE_TOL
    t_idx, t_vals = knn_topk.launch(xn, yn, k=kd, return_values=True)
    assert torch.equal(t_idx[..., ::dilation], idx)
    check_topk("tc", xn, yn, None, t_idx, t_vals, max_flip_share=1e-2)
    _check_lex_order(t_vals, t_idx)
    g_idx, g_mr, _, _ = knn_mr.launch_grouped(x, y, None, k, dilation, 2)
    ref_idx, ref_mr = folded_route(x, y, None, k, dilation, 2)
    assert torch.equal(g_idx, ref_idx) and torch.equal(g_mr, ref_mr)
    return t_idx, t_vals


@pytest.mark.parametrize("n,m,d,k,dilation", TC_SHAPES)
def test_tc_kernels_match_plain(cuda, n, m, d, k, dilation):
    """Random rows at the design's edges: D 40 and 200 (not multiples of
    16), N 80, 324, 1296 and M 324, 1296 (not multiples of 16 or 64 rows),
    every list length."""
    x, y = _tc_case(n, m, d, seed=20)
    _check_tc(x, y, k, dilation)


@pytest.mark.parametrize("n,m,d,k,dilation", TC_SHAPES)
def test_tc_kernels_exact_ties(cuda, n, m, d, k, dilation):
    """Exact ties at the start, across a tile boundary and deep in the
    scan, pushed down the lists by nearer targets: where a group is
    selected, its lowest columns, in column order (the plain version's
    order, which ``check_topk`` also holds)."""
    x, y = _tc_case(n, m, d, seed=21, fixture=_exact_ties)
    t_idx, _ = _check_tc(x, y, k, dilation)
    for lo, hi in ((0, 4), (61, 67), (200, 203)):
        inside = (t_idx >= lo) & (t_idx < hi)
        place = inside.int().cumsum(-1) - 1  # among the group's selected
        assert bool((t_idx[inside] == lo + place[inside]).all())
    assert bool(((t_idx[:, 7] >= 200) & (t_idx[:, 7] < 203)).any(-1).all())


@pytest.mark.parametrize("n,m,d,k,dilation", TC_SHAPES[:3])
def test_tc_kernels_falling_distances(cuda, n, m, d, k, dilation):
    """A row whose targets come nearer with every column: every candidate
    passes the row's threshold, the lists take one insertion per column
    (their worst case); the row keeps the last columns, nearest first."""
    x, y = _tc_case(n, m, d, seed=22, fixture=_falling)
    t_idx, _ = _check_tc(x, y, k, dilation)
    # the falling row of each (batch, group) keeps the last columns, up to
    # the bf16 rounding of neighbours' distances
    assert int(t_idx[:, 5].min()) >= m - 4 * k * dilation


@pytest.mark.parametrize("self_knn", [False, True], ids=["cross", "self"])
def test_tc_kernels_nan_rows_match_plain(cuda, self_knn):
    """bf16 NaN rows at the main path's widths: a NaN query row (its
    columns 0, d, 2d, ... in column order, NaN mr), a NaN target row at the
    first tile boundary (column 64: never chosen); knn_mr, grouped and
    knn_topk bitwise the plain versions on those rows."""
    g = torch.Generator().manual_seed(23)
    n, m, d, k, dilation = 80, (80 if self_knn else 324), 40, 9, 2
    x = torch.randn((2, n, 2 * d), generator=g)
    y = x if self_knn else torch.randn((2, m, 2 * d), generator=g)
    x[0, 3, :d] = float("nan")
    (x if self_knn else y)[1, 64, d:] = float("nan")
    x = x.to(torch.bfloat16).cuda()
    y = x if self_knn else y.to(torch.bfloat16).cuda()
    idx, mr = knn_mr.knn_mr_fused_grouped(x, y, None, k, dilation, 2)
    ref_idx, ref_mr = knn_mr.knn_mr_grouped_reference(x, y, None, k,
                                                      dilation, 2)
    assert idx[0, 3, 0].tolist() == list(range(0, 2 * k, 2))
    assert torch.equal(idx[0, 3], ref_idx[0, 3])
    assert torch.isnan(mr[0, 3, :d]).all()
    assert not (idx[1, :, 1] == 64).any()
    f_idx, _ = folded_route(x, y, None, k, dilation, 2)
    assert torch.equal(idx, f_idx)
    xn = l2_normalize(fold_groups(x, 2))
    yn = xn if self_knn else l2_normalize(fold_groups(y, 2))
    t_idx, t_vals = knn_topk.launch(xn, yn, k=k * dilation,
                                    return_values=True)
    p_idx, _ = knn_topk_reference(xn, yn, k=k * dilation,
                                  return_values=True)
    assert torch.equal(t_idx[0, 3], p_idx[0, 3])
    assert torch.isnan(t_vals[0, 3]).all()
    assert not (t_idx[3][torch.isfinite(xn[3]).all(-1)] == 64).any()


# --------------- the D-chunked scan: rows too wide for a whole-row layout

# Every fp32 block shape the kernels take at once (query rows, column
# groups): the results must be bitwise the host's choice.
FP32_BLOCKS = [(8, 1), (8, 2), (8, 4), (16, 1), (16, 4), (32, 2), (64, 1)]

# (n, m or None for y = x, d, k, dilation, bias): arch b@576 without
# channel groups (its stage-4 spatial calls and its stage-4 label call at
# D = 1024, with a batch of 1 here), and 1000 channels, whose last chunk of
# 104 is not a multiple of 16.
WIDE_SHAPES = [
    (324, None, 1024, 9, 5, True),
    (80, 324, 1024, 9, 1, False),
    (100, 200, 1000, 9, 2, False),
]


def _wide_case(cuda, n, m, d, dtype, bias, seed):
    x, y, b = _inputs(1, n, m, d, "shared" if bias else None, dtype, seed)
    x = x.to(cuda)
    y = x if m is None else y.to(cuda)
    return x, y, None if b is None else b.to(cuda)


def _other_layout(dtype, block=(8, 4)):
    """The second layout of a kernel whose results must be bitwise the
    default's: bf16's D-chunked scan forced, or a fp32 block of ``block``
    (query rows, column groups)."""
    if dtype == torch.bfloat16:
        return forced_chunked()
    return fp32_block(block)


def _check_wide(name, x, y, bias, k, dilation, chunked=False):
    """knn_mr and knn_topk on one input against their plain versions: mr
    bitwise the plain max-relative of the kernel's idx, the fp64 oracle,
    idx the plain version's but at near-ties (at most 1 % of the rows),
    knn_topk(xn, yn, k*d)[..., ::d] bitwise knn_mr's idx and its values
    within their fp32 bound. chunked: on ``_other_layout``. Returns the
    outputs."""
    with _other_layout(x.dtype) if chunked else contextlib.nullcontext():
        idx, mr, xn, yn = knn_mr.launch(x, y, bias, k, dilation)
    torch.cuda.synchronize()
    assert torch.equal(mr, max_relative(x, idx, y)), name
    assert knn_mr.ordering_gaps(xn, yn, bias, idx, dilation).max().item() \
        <= ORACLE_TOL, name
    with _other_layout(x.dtype) if chunked else contextlib.nullcontext():
        t_idx, t_vals = knn_topk.launch(xn, yn, k=k * dilation, bias=bias,
                                        return_values=True)
    assert torch.equal(t_idx[..., ::dilation], idx), name
    check_topk(name, xn, yn, bias, t_idx, t_vals, max_flip_share=1e-2)
    return idx, mr, xn, t_idx, t_vals


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,m,d,k,dilation,bias", WIDE_SHAPES)
def test_wide_rows_take_the_chunked_scan(cuda, n, m, d, k, dilation, bias,
                                         dtype):
    """D = 1024 and 1000: the bf16 whole-row layouts do not fit, the bf16
    kernels take the chunked scan (the fp32 ones their one layout) and meet
    the contract of every other width."""
    for mod, kk in ((knn_mr, k * dilation), (knn_topk, k * dilation)):
        smem, chunked = mod.block_layout(d, kk, dtype, 1, n,
                                         n if m is None else m)
        assert chunked == (dtype == torch.bfloat16)
        assert 0 < smem <= knn_topk.MAX_SMEM_BYTES
    x, y, b = _wide_case(cuda, n, m, d, dtype, bias, seed=30)
    _check_wide(f"D={d}", x, y, b, k, dilation)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_wide_backward_matches_plain(cuda, dtype):
    """The backward at D = 1024 (arch b's ungrouped stage 4) on the chunked
    forward's idx: gx bitwise -g, gy bitwise the ordered plain version."""
    x, y, idx, g = _bwd_case(1, 324, 324, 1024, 9, 5, dtype, self_knn=True)
    _check_bwd_kernel(x, y, idx, g)


def _boundary(mod, dtype, kd):
    """The widest multiple of 8 channels that the whole-row layout of
    ``mod``'s bf16 kernel takes; for fp32, which has one layout for every
    D, the width where the earlier fp32 kernel's whole-row layout ended
    (its transposed tile, 260 bytes a channel, filled the block at 795)."""
    if dtype == torch.float32:
        assert not mod.block_layout(4096, kd, dtype, 1, 324, 324)[1]
        return 792
    d = 8
    while not mod.block_layout(d + 8, kd, dtype)[1]:
        d += 8
    return d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mod", [knn_mr, knn_topk],
                         ids=["knn_mr", "knn_topk"])
def test_chunking_boundary(cuda, mod, dtype):
    """The widths on either side of a kernel's chunking boundary (k*d =
    45): the last one its whole-row layout takes and the first one it does
    not, each against the plain versions, and bitwise what the chunked
    scan forced (fp32: another block) on the same input gives."""
    k, dilation = 9, 5
    d = _boundary(mod, dtype, k * dilation)
    for width in (d, d + 8):
        x, y, b = _wide_case(cuda, 324, None, width, dtype, True, seed=31)
        got = _check_wide(f"D={width}", x, y, b, k, dilation)
        forced = _check_wide(f"D={width} chunked", x, y, b, k, dilation,
                             chunked=True)
        for a, c in zip(got, forced):
            assert torch.equal(_bits(a) if a.is_floating_point() else a,
                               _bits(c) if c.is_floating_point() else c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("bg,n,m,d,k,dilation,bias_kind", [
    (2, 100, 70, 40, 9, 1, "shared"),
    (2, 37, 300, 200, 9, 3, "batched"),    # 2 chunks, the last of 72
    (2, 324, None, 320, 9, 3, "shared"),    # arch s stage 4, self-kNN
    (1, 64, 130, 129, 4, 2, None),          # a last chunk of 1 channel
])
def test_chunked_scan_is_bitwise_the_unchunked(cuda, bg, n, m, d, k,
                                               dilation, bias_kind, dtype):
    """The chunked scan forced at widths the whole-row layout takes (fp32:
    every block shape the kernels take): the same mma / fmaf steps in the
    same order, so idx, mr, the normalized rows and knn_topk's idx and
    values are bitwise the default layout's."""
    x, y, bias = _inputs(bg, n, m, d, bias_kind, dtype, seed=32)
    x = x.to(cuda)
    y = x if m is None else y.to(cuda)
    bias = None if bias is None else bias.to(cuda)
    plain = knn_mr.launch(x, y, bias, k, dilation)
    xn, yn = plain[2], plain[3]
    t = knn_topk.launch(xn, yn, k=k * dilation, bias=bias,
                        return_values=True)
    for block in (FP32_BLOCKS if dtype == torch.float32 else [None]):
        with _other_layout(dtype, block):
            forced = knn_mr.launch(x, y, bias, k, dilation)
            tc = knn_topk.launch(xn, yn, k=k * dilation, bias=bias,
                                 return_values=True)
        for a, c in zip(plain, forced):
            assert torch.equal(_bits(a) if a.is_floating_point() else a,
                               _bits(c) if c.is_floating_point() else c)
        assert torch.equal(t[0], tc[0]) and torch.equal(_bits(t[1]),
                                                        _bits(tc[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_chunked_scan_nan_rows_match_plain(cuda, dtype):
    """NaN rows at D = 1024 through the bf16 chunked scan and the fp32
    scan (whose NaN tails read the query row from device memory, not from
    a staged row): a NaN query row takes columns 0, d, 2d, ... with a NaN
    mr, a NaN target row is never chosen; idx and mr bitwise the plain
    versions' on those rows."""
    g = torch.Generator().manual_seed(33)
    k, dilation = 9, 2
    x = torch.randn((2, 80, 1024), generator=g)
    y = torch.randn((2, 324, 1024), generator=g)
    x[0, 3] = float("nan")
    y[1, 64] = float("nan")
    x, y = x.to(dtype).to(cuda), y.to(dtype).to(cuda)
    idx, mr, xn, yn = knn_mr.launch(x, y, None, k, dilation)
    ref_idx, ref_mr = knn_mr.knn_mr_reference(x, y, None, k, dilation)
    assert idx[0, 3].tolist() == list(range(0, 2 * k, 2))
    assert torch.equal(idx[0, 3], ref_idx[0, 3])
    assert torch.isnan(mr[0, 3]).all()
    assert not (idx[1] == 64).any()
    torch.testing.assert_close(mr, max_relative(x, idx, y), rtol=0, atol=0,
                               equal_nan=True)
    t_idx, t_vals = knn_topk.launch(xn, yn, k=k * dilation,
                                    return_values=True)
    assert torch.equal(t_idx[..., ::dilation], idx)
    assert torch.isnan(t_vals[0, 3]).all()


# ------------------------- the fp32 scan (csrc/knn_scan_f32.cuh): its edges
#
# Query rows 8-64 and column groups 1-4 a block (picked by shape), target
# tiles of 64 columns a group, 32-channel chunks (a last chunk not a multiple
# of 4 padded with zeros), lists of 8, 16, 32 or 64.


def _same_on_every_block(x, y, bias, k, dilation, got, t_got):
    """knn_mr's and knn_topk's outputs on every fp32 block shape bitwise
    ``got`` / ``t_got`` (the host's block)."""
    xn, yn = got[2], got[3]
    for block in FP32_BLOCKS:
        with fp32_block(block):
            other = knn_mr.launch(x, y, bias, k, dilation)
            t_other = knn_topk.launch(xn, yn, k=k * dilation, bias=bias,
                                      return_values=True)
        for a, c in zip(got, other):
            assert torch.equal(_bits(a) if a.is_floating_point() else a,
                               _bits(c) if c.is_floating_point() else c), \
                block
        assert torch.equal(t_got[0], t_other[0]), block
        assert torch.equal(_bits(t_got[1]), _bits(t_other[1])), block


@pytest.mark.parametrize("k,dilation", [(1, 1), (9, 1), (9, 5), (16, 4)],
                         ids=["kd1", "kd9", "kd45", "kd64"])
@pytest.mark.parametrize("d", [1, 3, 5, 24, 40, 1023, 1024])
def test_fp32_scan_edges_match_plain(cuda, d, k, dilation):
    """The fp32 kernels at the scan's edges: 1 channel, widths not a
    multiple of 4 (the padded float4 tail), 1023 and 1024 (32 chunks);
    k*d 1, 9, 45 and 64 (lists of 8, 16, 64, 64); a ragged last tile
    (M = 70) and N = 45 off every block's multiple, with a shared bias:
    knn_mr and knn_topk against their plain versions (``_check_wide``),
    then both bitwise alike on every block shape."""
    x, y, bias = _inputs(2, 45, 70, d, "shared", torch.float32, seed=d)
    x, y, bias = x.to(cuda), y.to(cuda), bias.to(cuda)
    got = knn_mr.launch(x, y, bias, k, dilation)
    _check_wide(f"D={d} k*d={k * dilation}", x, y, bias, k, dilation)
    t_got = knn_topk.launch(got[2], got[3], k=k * dilation, bias=bias,
                            return_values=True)
    _same_on_every_block(x, y, bias, k, dilation, got, t_got)


@pytest.mark.parametrize("bias_kind", [None, "shared", "batched"])
def test_fp32_scan_nan_rows_and_short_targets(cuda, bias_kind):
    """M = k*d = 45, below one tile: every target is ranked. A NaN query
    row (and, with a bias, a query row whose bias is NaN) takes columns 0,
    d, 2d, ... with NaN values (and the NaN query row a NaN mr); a NaN
    target row comes last (rank 44, not
    kept at dilation 5) in every other row of its batch-group; idx and mr
    bitwise the plain versions' on those rows, on every block shape."""
    k, dilation = 9, 5
    x, y, bias = _inputs(2, 30, 45, 5, bias_kind, torch.float32, seed=41)
    x[0, 1] = float("nan")
    y[1, 7] = float("nan")
    if bias is not None:
        (bias if bias.dim() == 2 else bias[0])[2] = float("nan")
    x, y = x.to(cuda), y.to(cuda)
    bias = None if bias is None else bias.to(cuda)
    got = knn_mr.launch(x, y, bias, k, dilation)
    idx, mr, xn, yn = got
    ref_idx, _ = knn_mr.knn_mr_reference(x, y, bias, k, dilation)
    nan_rows = [(0, 1)] + ([(0, 2)] if bias is not None else [])
    for b, r in nan_rows:
        assert idx[b, r].tolist() == list(range(0, k * dilation, dilation))
        assert torch.equal(idx[b, r], ref_idx[b, r])
    assert torch.isnan(mr[0, 1]).all()  # the NaN query row's rels
    assert not (idx[1] == 7).any()
    torch.testing.assert_close(mr, max_relative(x, idx, y), rtol=0, atol=0,
                               equal_nan=True)
    t_idx, t_vals = knn_topk.launch(xn, yn, k=k * dilation, bias=bias,
                                    return_values=True)
    assert torch.equal(t_idx[..., ::dilation], idx)
    for b, r in nan_rows:
        assert torch.isnan(t_vals[b, r]).all()
    finite = [r for r in range(30) if not (bias is not None
                                           and bias.dim() == 2 and r == 2)]
    assert (t_idx[1, finite, -1] == 7).all()
    assert torch.isnan(t_vals[1, finite, -1]).all()
    _same_on_every_block(x, y, bias, k, dilation, got, (t_idx, t_vals))


def test_fp32_grouped_kernel_is_the_same_on_every_block(cuda):
    """The grouped fp32 kernel (unfolded rows, 2 groups, a shared bias,
    NaN rows) bitwise alike on every block shape."""
    gen = torch.Generator().manual_seed(42)
    x = torch.randn((2, 75, 2 * 36), generator=gen)
    y = torch.randn((2, 130, 2 * 36), generator=gen)
    x[0, 3, :36] = float("nan")
    y[1, 9, 36:] = float("nan")
    bias = (torch.randn((75, 130), generator=gen) * 0.1).to(cuda)
    x, y = x.to(cuda), y.to(cuda)
    got = knn_mr.launch_grouped(x, y, bias, 9, 2, 2)
    assert torch.equal(got[0], folded_route(x, y, bias, 9, 2, 2)[0])
    for block in FP32_BLOCKS:
        with fp32_block(block):
            other = knn_mr.launch_grouped(x, y, bias, 9, 2, 2)
        assert torch.equal(got[0], other[0]), block
        assert torch.equal(_bits(got[1]), _bits(other[1])), block


# ------------------------------------------- the kernels as registered ops


def _op_inputs(cuda, dtype, grouped=False):
    g = torch.Generator().manual_seed(31)
    d = 80 if grouped else 40
    x = torch.randn((2, 96, d), generator=g).to(dtype).to(cuda)
    y = torch.randn((2, 70, d), generator=g).to(dtype).to(cuda)
    bias = (torch.randn((96, 70), generator=g) * 0.1).to(cuda)
    return x, y, bias


@pytest.mark.parametrize("op", ["knn_mr_fused", "knn_mr_fused_grouped",
                                "knn_topk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_registered_ops_pass_opcheck_on_the_card(cuda, op, dtype):
    """Schema, autograd registration and the fake function against the
    kernels' real outputs on CUDA tensors."""
    x, y, bias = _op_inputs(cuda, dtype, op.endswith("grouped"))
    if op != "knn_topk":
        x.requires_grad_()
        y.requires_grad_()
    args = {"knn_mr_fused": (x, y, bias, 5, 2),
            "knn_mr_fused_grouped": (x, y, bias, 5, 2, 2),
            "knn_topk": (l2_normalize(x), l2_normalize(y), 9, bias)}[op]
    torch.library.opcheck(
        getattr(torch.ops.gkgnet_tpu_torch, op).default, args,
        test_utils=("test_schema", "test_autograd_registration",
                    "test_faketensor"))


@pytest.mark.parametrize("op", ["knn_mr_fused", "knn_mr_fused_grouped",
                                "knn_topk"])
def test_exported_op_launches_its_kernel(cuda, op, tmp_path):
    """An op exported on the card stays one node; the saved and loaded
    program launches the kernel once per call (the counter counts it) and
    gives the eager call's bits."""
    x, y, bias = _op_inputs(cuda, torch.bfloat16, op.endswith("grouped"))

    class Call(torch.nn.Module):
        def forward(self, x, y):
            if op == "knn_mr_fused":
                return knn_mr.knn_mr_fused(x, y, bias, 5, 2)
            if op == "knn_mr_fused_grouped":
                return knn_mr.knn_mr_fused_grouped(x, y, bias, 5, 2, 2)
            return knn_graph(x, y, k=9, bias=bias)

    program = torch.export.export(Call(), (x, y), strict=False)
    nodes = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"
             and "gkgnet_tpu_torch" in str(n.target)]
    assert nodes == [f"gkgnet_tpu_torch.{op}.default"]
    torch.export.save(program, str(tmp_path / "op.pt2"))
    loaded = torch.export.load(str(tmp_path / "op.pt2")).module()
    counter = {"knn_mr_fused": "launches",
               "knn_mr_fused_grouped": "grouped_launches"}.get(op)
    module = knn_mr if counter else knn_topk
    counter = counter or "launches"
    before = getattr(module, counter)
    got = loaded(x, y)
    assert getattr(module, counter) == before + 1
    want = Call()(x, y)
    for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        assert torch.equal(a, b)


def test_registered_op_raises_where_its_kernel_cannot_run(cuda):
    """No fallback through the dispatcher: k * dilation over the kernel's
    lists raises on the card, where the CPU runs the plain version."""
    x, y, _ = _op_inputs(cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="exceeds"):
        knn_mr.knn_mr_fused(x, y, None, 33, 2)
    knn_mr.knn_mr_fused(x.cpu(), y.cpu(), None, 33, 2)


# The gather's backward (csrc/knn_mr_bwd.cu gather_backward): (b, n, k, m,
# c) at the label-sharded build's s@576 shapes (BG 16, 80 label rows, k 9,
# half the stage's targets), a spatial gather with hub targets (many
# queries, few targets), rows not whole 16-byte chunks, fp32 at the
# widest row, one edge per row.
GATHER_SHAPES = [(16, 80, 9, 10368, 40), (16, 80, 9, 162, 320),
                 (4, 4096, 9, 64, 80), (3, 50, 5, 7, 33),
                 (2, 300, 18, 40, 1024), (2, 1, 1, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,k,m,c", GATHER_SHAPES)
def test_gather_backward_kernel_is_the_ordered_sum(cuda, b, n, k, m, c,
                                                   dtype):
    """The kernel's gy is bitwise each target's fp32 sum in ascending edge
    id (``gather_backward_ordered_reference``, computed on the CPU), a
    second launch is bitwise the first (no float atomics), and each launch
    is counted; targets without an edge get 0."""
    gen = torch.Generator().manual_seed(b * n + c)
    g = torch.randn((b, n, k, c), generator=gen).to(dtype)
    # a hub: a quarter of the edges on target 0
    idx = torch.randint(0, m, (b, n, k), generator=gen, dtype=torch.int32)
    idx[:, : n // 4 + 1, 0] = 0
    want = aggregate.gather_backward_ordered_reference(g, idx, m)
    before = knn_mr.gather_backward_launches
    got = knn_mr.launch_gather_backward(g.to(cuda), idx.to(cuda), m)
    again = knn_mr.launch_gather_backward(g.to(cuda), idx.to(cuda), m)
    torch.cuda.synchronize()
    assert knn_mr.gather_backward_launches == before + 2
    assert torch.equal(got.cpu(), want)
    assert torch.equal(again, got)


# The small path (one launch of gather_small, no workspace) at its edges:
# (b, n, k, m, c, idx type, how idx is made). n*k at the cap (4096) and
# one past it (the large path); one hub target that takes every edge of a
# row; targets that mostly have no edge; rows of 33 channels (not whole
# 16-byte chunks in either type); B > 1 with M = 1 and k = 1; idx int64 at
# the label shape and at the cap.
GATHER_SMALL_CASES = {
    "at_cap": (3, 512, 8, 300, 40, torch.int32, "random"),
    "past_cap": (3, 4097, 1, 300, 40, torch.int32, "random"),
    "hub_takes_a_row": (2, 80, 9, 50, 80, torch.int32, "hub"),
    "targets_without_edges": (2, 20, 9, 5000, 24, torch.int32, "random"),
    "unaligned": (3, 50, 5, 7, 33, torch.int32, "hub"),
    "one_target": (4, 6, 1, 1, 8, torch.int32, "random"),
    "int64": (16, 80, 9, 162, 320, torch.int64, "random"),
    "int64_at_cap": (2, 4096, 1, 64, 16, torch.int64, "hub"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(GATHER_SMALL_CASES))
def test_gather_backward_small_path_is_the_ordered_sum(cuda, case, dtype):
    """At and around the small path's limits, gy is bitwise the ordered
    plain version and the same over two launches; a call at most the cap's
    edges a row launches gather_small alone, one past it the large path's
    four kernels, and idx int64 is read as it comes (no cast kernel)."""
    b, n, k, m, c, itype, kind = GATHER_SMALL_CASES[case]
    gen = torch.Generator().manual_seed(b * n * k + c)
    g = torch.randn((b, n, k, c), generator=gen).to(dtype)
    idx = torch.randint(0, m, (b, n, k), generator=gen).to(itype)
    if kind == "hub":  # every edge of the last row on one target
        idx[-1] = m // 2
    path = knn_mr.gather_backward_path(n, k)
    assert path == ("large" if n * k > 4096 else "small")
    want = aggregate.gather_backward_ordered_reference(g, idx, m)
    gd, idxd = g.to(cuda), idx.to(cuda)
    launched, _ = kernels_of(lambda: knn_mr.launch_gather_backward(gd, idxd,
                                                                   m))
    assert sorted(launched) == GATHER_KERNELS[path]
    before = knn_mr.gather_backward_launches
    got = knn_mr.launch_gather_backward(gd, idxd, m)
    again = knn_mr.launch_gather_backward(gd, idxd, m)
    torch.cuda.synchronize()
    assert knn_mr.gather_backward_launches == before + 2
    assert torch.equal(got.cpu(), want)
    assert torch.equal(again, got)


def test_gather_backward_beyond_its_limits_raises(cuda):
    """A CUDA call beyond the kernel's limits raises and launches nothing:
    rows of more than 256 16-byte chunks, more than 65535 batch rows, and
    an int64 idx on the large path is cast, not refused."""
    before = knn_mr.gather_backward_launches
    g = torch.zeros((1, 2, 1, 1025), device=cuda)
    with pytest.raises(ValueError, match="16-byte chunks"):
        knn_mr.launch_gather_backward(
            g, torch.zeros((1, 2, 1), dtype=torch.int32, device=cuda), 3)
    g = torch.zeros((65536, 1, 1, 1), device=cuda)
    with pytest.raises(ValueError, match="batch rows"):
        knn_mr.launch_gather_backward(
            g, torch.zeros((65536, 1, 1), dtype=torch.int32, device=cuda), 1)
    assert knn_mr.gather_backward_launches == before
    g = torch.ones((1, 5000, 1, 4), device=cuda)
    idx = torch.zeros((1, 5000, 1), dtype=torch.int64, device=cuda)
    gy = knn_mr.launch_gather_backward(g, idx, 2)
    assert gy[0, 0].tolist() == [5000.0] * 4 and gy[0, 1].eq(0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_gather_nodes_backward_on_the_card_runs_the_kernel(cuda, dtype):
    """``gather_nodes``'s gradient on a CUDA tensor is the kernel's,
    bitwise the CPU's plain version on the same inputs, and the same over
    two runs; max_relative (the ring's and the non-fused aggregators'
    route) reaches it through its gather in the input type, bf16 rows
    included."""
    gen = torch.Generator().manual_seed(5)
    y = torch.randn((4, 97, 48), generator=gen).to(dtype)
    x = torch.randn((4, 200, 48), generator=gen).to(dtype)
    idx = torch.randint(0, 97, (4, 200, 9), generator=gen)
    g = torch.randn((4, 200, 9, 48), generator=gen).to(dtype)
    grads = []
    for dev in ("cpu", cuda, cuda):
        yd = y.to(dev, copy=True).requires_grad_()
        before = knn_mr.gather_backward_launches
        gather_nodes(yd, idx.to(dev)).backward(g.to(dev))
        assert knn_mr.gather_backward_launches == before + \
            (dev != "cpu")
        grads.append(yd.grad.cpu())
    assert torch.equal(grads[1], grads[0]) and torch.equal(grads[2],
                                                           grads[0])
    # 200 x 9 edges a row: the small path, one kernel for the call
    assert knn_mr.gather_backward_path(200, 9) == "small"
    gd, idxd = g.to(cuda), idx.to(cuda)
    launched, _ = kernels_of(
        lambda: aggregate.gather_backward(gd, idxd, 97))
    assert launched == ["gather_small"]
    gm = torch.randn((4, 200, 48), generator=gen).to(dtype)
    got = []
    for dev in ("cpu", cuda):
        yd = y.to(dev, copy=True).requires_grad_()
        max_relative(x.to(dev), idx.to(dev), yd).backward(gm.to(dev))
        got.append(yd.grad.cpu())
    assert torch.equal(got[1], got[0])


# ------------------------------------------- the compiled steps (graphs)


def _state_bits(state):
    """Every tensor a train step keeps: parameters, buffers, EMA and
    optimizer state."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in (state.ema_params or {}).items()})
    names = {p: n for n, p in state.model.named_parameters()}
    for p, st in state.optimizer.optimizer.state.items():
        out.update({f"opt.{names[p]}.{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_compiled_steps_match_eager_bitwise(cuda, dtype):
    """t@128 (k=3, drop_path 0.1): three graphed train steps and three
    eager ones from one seeded state give the same bits (every log value,
    parameter, BatchNorm statistic, EMA tensor and optimizer state
    tensor), each call 16 + 16 knn_mr launches, one capture; then graphed
    eval scores bitwise the eager ones at batch 2 and at a second input
    shape (batch 1, its own capture). cuDNN's deterministic algorithms on
    for both paths: its default fp32 convolution backward sums in an
    order that changes from run to run on an H100, eager against eager."""
    gen = torch.Generator().manual_seed(3)
    img = torch.randn((2, 128, 128, 3), generator=gen).to(cuda, dtype)
    gt = (torch.rand((2, 10), generator=gen) < 0.3).float().to(cuda)
    states = []
    for _ in range(2):
        model = GKGNetClassifier(arch="t", k=3, k_label_gcn=3, n_classes=10,
                                 size=128, drop_path=0.1, dtype=dtype)
        init_parameters(model, torch.Generator().manual_seed(0))
        model = model.to(cuda)
        states.append(create_train_state(
            model, build_optimizer(model, 1e-3), ema=True))
    graphed = make_train_step(ema_momentum=2e-4)
    eager = make_train_step(ema_momentum=2e-4, compiled=False)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for i in range(3):
            before = (knn_mr.launches, knn_mr.backward_launches)
            _, g_log = graphed(states[0], {"img": img, "gt_label": gt}, i)
            torch.cuda.synchronize()
            assert (knn_mr.launches - before[0],
                    knn_mr.backward_launches - before[1]) == (16, 16)
            _, e_log = eager(states[1], {"img": img, "gt_label": gt}, i)
            for key in e_log:
                if key != "lr":
                    assert torch.equal(g_log[key], e_log[key]), (i, key)
        assert graphed.graphs.captures == 1
        got, want = _state_bits(states[0]), _state_bits(states[1])
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), key
        g_eval, e_eval = make_eval_step(), make_eval_step(compiled=False)
        for x in (img, img[:1].contiguous()):
            ref = e_eval(states[0], x)
            for _ in range(3):  # warm-up, capture, replay
                before = knn_mr.launches
                assert torch.equal(g_eval(states[0], x), ref)
                torch.cuda.synchronize()
                assert knn_mr.launches - before == 16
        assert g_eval.graphs.captures == 2
    finally:
        torch.backends.cudnn.deterministic = deterministic


def test_compiled_true_on_a_collective_step_raises(cuda):
    """A step under graph_sharding over a world of two ranks runs
    collectives: ``compiled=True`` raises before it runs, ``None`` would
    run it eagerly."""
    from gkgnet_tpu_torch.core import graphs
    from gkgnet_tpu_torch.parallel.mesh import Mesh
    from gkgnet_tpu_torch.parallel.sharding import graph_sharding

    model = GKGNetClassifier(arch="t", k=3, k_label_gcn=3, n_classes=10,
                             size=128)
    init_parameters(model, torch.Generator().manual_seed(0))
    state = create_train_state(model.to(cuda), build_optimizer(model, 1e-3))
    mesh = Mesh(world=2, rank=0, data=2, graph=1, data_rank=0, graph_rank=0,
                data_group=None, graph_group=None, graph_ranks=(0,),
                device=cuda, backend="gloo")
    batch = {"img": torch.zeros((1, 128, 128, 3), device=cuda),
             "gt_label": torch.zeros((1, 10), device=cuda)}
    with graph_sharding(mesh):
        assert not graphs.capturable(None, cuda)
        with pytest.raises(RuntimeError, match="world of more than one"):
            make_train_step(compiled=True)(state, batch)
    assert state.step == 0
    assert graphs.capturable(None, cuda)


@contextlib.contextmanager
def _sync_errors():
    """A CUDA call that makes the host wait for the card raises inside."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_graphed_replays_make_the_host_wait_for_nothing(cuda):
    """Once warmed up and captured, train steps fed by the device
    normalize from uint8 batches and eval steps on a device batch replay
    with no call that makes the host wait for the card (the normalize
    builds its constants once, the eval step walks its modules once and
    replays with a hit each). Their losses and scores are bitwise those
    of eager steps on a twin state fed by a normalize that makes its
    constants anew at every batch, as it did before it kept them."""
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    gen = torch.Generator().manual_seed(4)
    u8 = [torch.randint(0, 256, (2, 128, 128, 3), generator=gen,
                        dtype=torch.uint8).to(cuda) for _ in range(4)]
    gt = (torch.rand((2, 10), generator=gen) < 0.3).float().to(cuda)

    def anew(img):
        return (img.float() - torch.tensor(mean, device=cuda)) \
            * (1.0 / torch.tensor(std, device=cuda))

    states = [_small_state(cuda, lr=1e-3) for _ in range(2)]
    norm = make_device_normalize((mean, std))
    graphed, eager = make_train_step(), make_train_step(compiled=False)
    g_eval, e_eval = make_eval_step(), make_eval_step(compiled=False)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got, want = [], []
        for i, img in enumerate(u8):
            x = anew(img)
            e_logs = eager(states[1], {"img": x, "gt_label": gt})[1]
            want += [e_logs["loss"], e_eval(states[1], x)]
            torch.cuda.synchronize()
            with _sync_errors() if i >= 2 else contextlib.nullcontext():
                g_logs = graphed(states[0], {"img": norm(img),
                                             "gt_label": gt})[1]
                got += [g_logs["loss"], g_eval(states[0], x)]
            torch.cuda.synchronize()
        assert graphed.graphs.captures == 1 and g_eval.graphs.captures == 1
        assert norm.builds == 1
        assert (g_eval.prepared.rebuilds, g_eval.prepared.hits) == (1, 2)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), i
    finally:
        torch.backends.cudnn.deterministic = deterministic


# ------------------------------------------------- span markers in graphs


def _small_state(cuda, lr=1e-4):
    model = GKGNetClassifier(arch="t", k=3, k_label_gcn=3, n_classes=10,
                             size=128)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(cuda)
    return create_train_state(model, build_optimizer(model, lr))


MODEL_SPANS = ("stem", "stage1", "label1", "stage2", "label2", "stage3",
               "label3", "stage4", "label4", "head")


def test_graph_replay_runs_each_marker_pair_in_order(cuda):
    """A captured eval graph holds its 22 span markers (at most
    MAX_MARKERS) and each replay runs every begin and end marker once, in
    stream order: ``forward`` around the model's ten spans, each span's
    kernels between its markers. The train graph holds 28."""
    from torch.profiler import ProfilerActivity, profile

    from gkgnet_tpu_torch.utils import profiling

    state = _small_state(cuda)
    img = torch.randn((2, 128, 128, 3), device=cuda)
    step = make_eval_step()
    for _ in range(3):   # eager, capture, replay
        step(state, img)
    (cap,) = step.graphs.graphs.values()
    assert cap.markers == 22 <= profiling.MAX_MARKERS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(state, img)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [e.name for e in events if e.name.startswith("gkgnet_span_")]
    one = ["gkgnet_span_begin_forward"] + [
        f"gkgnet_span_{side}_{n}" for n in MODEL_SPANS
        for side in ("begin", "end")] + ["gkgnet_span_end_forward"]
    assert marks == one * 2
    # every span holds device work between its markers
    inside = {}
    current = None
    for e in events:
        if e.name.startswith("gkgnet_span_begin_") and \
                e.name != "gkgnet_span_begin_forward":
            current = e.name[len("gkgnet_span_begin_"):]
        elif e.name.startswith("gkgnet_span_end_"):
            current = None
        elif current is not None:
            inside[current] = inside.get(current, 0) + 1
    assert set(inside) == set(MODEL_SPANS)
    gt = (torch.rand((2, 10), device=cuda) < 0.3).float()
    train = make_train_step()
    for _ in range(2):
        train(state, {"img": img, "gt_label": gt})
    (cap,) = train.graphs.graphs.values()
    assert cap.markers == 28 <= profiling.MAX_MARKERS


def test_markers_leave_the_graphed_outputs_bitwise(cuda, monkeypatch):
    """The graphed eval logits and the graphed train steps' losses are
    bitwise those of graphs captured without markers (learning rate 0,
    so every step's loss depends on the forward alone)."""
    from gkgnet_tpu_torch.utils import profiling

    img = torch.randn((2, 128, 128, 3), device=cuda)
    gt = (torch.rand((2, 10), device=cuda) < 0.3).float()
    runs = []
    for markers in (True, False):
        if not markers:   # a capture that launches no marker
            monkeypatch.setattr(profiling, "_capturing", lambda: False)
        state = _small_state(cuda, lr=0.0)
        train = make_train_step()
        losses = [train(state, {"img": img, "gt_label": gt})[1]["loss"]
                  for _ in range(3)]
        step = make_eval_step()
        scores = [step(state, img) for _ in range(3)]
        (cap,) = step.graphs.graphs.values()
        assert cap.markers == (22 if markers else 0)
        torch.cuda.synchronize()
        runs.append((losses, scores))
    for got, want in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(got, want)
