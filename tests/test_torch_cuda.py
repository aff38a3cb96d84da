"""Tests of the port's CUDA kernel on the card. Without a card they skip.

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
