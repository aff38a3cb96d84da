"""The frozen yardstick: the FLOP formula is the port's, and the operator
bounds are those the kernel table of PERF.md section 6 records."""

import pytest
import torch

from benchmark import flops

S576 = dict(arch="s", size=576, k=9, k_label_gcn=9, num_group=2,
            n_classes=80, num_gcn=1)


@pytest.mark.parametrize("arch", ["t", "s", "b"])
def test_model_flops_are_the_ports(arch):
    from gkgnet_tpu_torch.utils.profiling import model_flops
    assert flops.model_flops(arch, 576, batch=3) == \
        model_flops(arch, 576, batch=3)


def test_per_image_gflops():
    got = {a: flops.model_flops(a, 576)["per_image_total"] / 1e9
           for a in "tsb"}
    assert got == pytest.approx({"t": 34.01, "s": 79.87, "b": 269.93},
                                abs=0.01)


def test_bounds_are_the_kernel_tables():
    """PERF.md's kernel table: 0.226 ms per s@576 forward at batch 8 and
    0.187 ms per train step for the backward, both bytes-bound."""
    calls = flops.knn_mr_calls(S576, batch=8)
    assert len(calls) == 16
    fwd = sum(flops.knn_mr_forward_bound_s(c) for c in calls) * 1e3
    bwd = sum(flops.knn_mr_backward_bound_s(c) for c in calls) * 1e3
    assert round(fwd, 3) == 0.226 and round(bwd, 3) == 0.187


def test_calls_are_the_models(monkeypatch):
    """The calls ``knn_mr_calls`` lists are those a forward of the port
    makes (T at 224, k 9: every stage, pooled, self and label calls)."""
    from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier
    from gkgnet_tpu_torch.ops import knn_mr
    seen = []
    real = knn_mr.knn_mr_reference

    def spy(x, y, bias, k, dilation=1):
        seen.append(dict(bg=x.shape[0], n=x.shape[1], m=y.shape[1],
                         d=x.shape[2], k=k, dilation=dilation,
                         bias=bias is not None))
        return real(x, y, bias, k, dilation)

    monkeypatch.setattr(knn_mr, "knn_mr_reference", spy)
    model = dict(S576, arch="t", size=224)
    net = GKGNetClassifier(arch="t", size=224).eval()
    with torch.no_grad():
        net(torch.randn(2, 224, 224, 3))
    want = [{k: v for k, v in c.items() if k != "self"}
            for c in flops.knn_mr_calls(model, batch=2)]
    assert seen == want
