"""Tests of the port's CUDA kernels on the card. Without a card they skip.

On the machine with the card (which has no JAX) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

``--noconftest`` because ``tests/conftest.py`` imports JAX. This file
imports no JAX, and each test decides inside a fixture whether a card is
present.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import tie_fixture  # noqa: E402
from gkgnet_tpu_torch.core.optim import build_optimizer  # noqa: E402
from gkgnet_tpu_torch.core.trainer import (create_train_state,  # noqa: E402
                                           make_train_step)
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier, init_parameters  # noqa: E402
from gkgnet_tpu_torch.ops import knn_mr  # noqa: E402
from gkgnet_tpu_torch.ops.aggregate import max_relative  # noqa: E402
from gkgnet_tpu_torch.ops.knn import l2_normalize  # noqa: E402

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


@pytest.mark.parametrize("bg,n,m,d,k,dilation,dtype,self_knn", [
    (2, 100, 70, 12, 4, 1, torch.float32, False),
    (2, 64, None, 40, 9, 2, torch.bfloat16, True),
    (3, 37, 300, 200, 9, 3, torch.bfloat16, False),
    (2, 80, 1500, 40, 9, 1, torch.bfloat16, False),    # label-like: M >> N
    (1, 300, None, 33, 5, 1, torch.float32, True),
])
def test_backward_kernel_matches_plain(cuda, bg, n, m, d, k, dilation, dtype,
                                       self_knn):
    """The backward kernel against the plain version on the same idx: gx
    bitwise -g, the per-edge gradients (hence the tie sets) bitwise, gy
    within ``backward_gy_bound`` of the fp64 sum (the fp32 summation bound,
    plus one rounding in bf16), and a second launch bitwise equal (no
    atomics)."""
    x, y, idx, g = _bwd_case(bg, n, m or n, d, k, dilation, dtype, self_knn)
    before = knn_mr.backward_launches
    gx, gy, ge = knn_mr.launch_backward(x, y, idx, g)
    torch.cuda.synchronize()
    assert knn_mr.backward_launches == before + 1
    assert gx.dtype == dtype and gy.dtype == dtype and gy.shape == y.shape
    assert torch.equal(gx, -g)
    ge_ref = knn_mr.edge_gradients_reference(x, y, idx, g)
    assert torch.equal(ge, ge_ref)
    assert ((ge_ref[:, 0] != 0).sum(dim=1) >= 2).all(), "row 0 must tie"
    exact, bound = knn_mr.backward_gy_bound(ge_ref, idx, y.shape[1])
    assert ((gy.double() - exact).abs() <= bound).all()
    gx2, gy2, _ = knn_mr.launch_backward(x, y, idx, g)
    assert torch.equal(gy, gy2) and torch.equal(gx, gx2)


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
