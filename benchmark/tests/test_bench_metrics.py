"""Each metric's arithmetic on a small recorded event list: the owners
map, the traced stretch's busy and idle time and breakdown, and every
reader."""

from collections import namedtuple

import pytest
from torch.autograd import DeviceType

from benchmark import flops, harness, trace

Range = namedtuple("Range", "start end")
Kernel = namedtuple("Kernel", "name device duration")


class Ev:
    def __init__(self, name, start, end, device=DeviceType.CPU, parent=None,
                 kernels=()):
        self.name, self.device_type, self.cpu_parent = name, device, parent
        self.time_range = Range(start, end)
        self.kernels = [Kernel(k, 0, 1) for k in kernels]


def eager_events():
    step = Ev("aten::conv2d", 0, 10, kernels=["gemm"])
    fwd = Ev("gkgnet_tpu_torch::knn_mr_fused", 10, 20,
             kernels=["knn_mr_tc_kernel", "fill"])
    fill = Ev("aten::fill_", 20, 21, kernels=["fill"])
    fn = Ev("autograd::engine::evaluate_function: GeneratedBackwardFor_"
            "gkgnet_tpu_torch_knn_mr_fused_defaultBackward", 30, 40)
    inner = Ev("GeneratedBackwardFor_gkgnet_tpu_torch_knn_mr_fused_default"
               "Backward", 31, 39, parent=fn)
    empty = Ev("aten::empty", 32, 33, parent=inner, kernels=["row_split"])
    fwd_fn = Ev("GeneratedBackwardFor_gkgnet_tpu_torch_knn_mr_fused_default",
                50, 60)
    norm = Ev("aten::mul", 51, 52, parent=fwd_fn, kernels=["l2norm_rows"])
    return [step, fwd, fill, fn, inner, empty, fwd_fn, norm,
            Ev("gemm", 1, 2, DeviceType.CUDA)]


def test_owners_keep_only_exclusive_names():
    assert trace.owners(eager_events()) == {
        "knn_mr_tc_kernel": ("knn_mr_fused", "fwd"),
        "l2norm_rows": ("knn_mr_fused", "fwd"),
        "row_split": ("knn_mr_fused", "bwd")}


def stretch_events():
    cuda = DeviceType.CUDA
    return [
        Ev(trace.STRETCH, 0, 100),
        Ev("bench.step", 0, 50), Ev("cudaGraphLaunch", 42, 58),
        Ev("bench.sync", 60, 100),
        Ev(trace.STRETCH, 0, 100, cuda),   # device-side annotations
        Ev("bench.step", 5, 95, cuda),
        Ev("knn_mr_tc_kernel", 10, 30, cuda),
        Ev("gemm", 20, 40, cuda),
        Ev("row_split", 60, 70, cuda),
        Ev("gemm", 120, 130, cuda),        # outside the stretch
    ]


def test_stretch_busy_idle_and_breakdown():
    st = trace.Stretch(stretch_events(), items=2, images=4)
    assert st.window_s == pytest.approx(100e-6)
    assert st.busy_s == pytest.approx(40e-6)
    assert st.device_seconds() == pytest.approx(50e-6)
    assert st.device_seconds({"gemm"}) == pytest.approx(20e-6)
    bd = st.breakdown()
    assert bd["device_ops"] == [["knn_mr_tc_kernel", pytest.approx(20e-6)],
                                ["gemm", pytest.approx(20e-6)],
                                ["row_split", pytest.approx(10e-6)]]
    # gaps: 0-10 (bench.step), 40-60 (cudaGraphLaunch), 70-100 (bench.sync)
    assert dict((k, v) for k, v in bd["idle_gaps"]) == {
        "bench.step": pytest.approx(10e-6),
        "cudaGraphLaunch": pytest.approx(20e-6),
        "bench.sync": pytest.approx(30e-6)}


MODEL = dict(arch="s", size=576, k=9, k_label_gcn=9, num_group=2,
             n_classes=80, num_gcn=1)


def run(kind, traced=True, **kw):
    st = trace.Stretch(stretch_events(), items=2, images=4) if traced \
        else None
    r = {"kind": kind, "batch": 2, "setup_s": 12.5, "steps": 10,
         "seconds": 2.0, "images": 20, "latencies_s": [],
         "flops_per_image": 80e9, "dtype": "bf16",
         "knn_calls": flops.knn_mr_calls(MODEL, 2), "stretch": st,
         "owners": trace.owners(eager_events()) if traced else None}
    r.update(kw)
    return r


def read(name, r):
    return harness.reader(name).read(r, name)


def test_end_to_end_readers():
    assert read("setup_s", run("eval")) == 12.5
    assert read("train_img_per_s", run("train")) == 10.0
    assert read("train_img_per_s", run("eval")) is None
    assert read("eval_img_per_s", run("eval")) == 10.0
    lat = [i / 1000 for i in range(1, 101)]
    assert read("serve_p95_ms", run("serve", latencies_s=lat)) == \
        pytest.approx(95.05)
    assert read("serve_p95_ms", run("eval")) is None


def test_per_layer_readers():
    r = run("train")
    assert read("idle_pct.train", r) == pytest.approx(60.0)
    assert read("idle_pct.eval", r) is None
    assert read("idle_pct.train", run("train", traced=False)) is None
    assert read("step_mfu.train", r) == pytest.approx(
        100 * 3 * 80e9 * 20 / 2.0 / 989e12)
    assert read("step_mfu.eval", run("eval")) == pytest.approx(
        100 * 80e9 * 20 / 2.0 / 989e12)
    # dense: all device time less the operator's kernels, per image
    assert read("dense_ms_per_img.train", r) == pytest.approx(
        1e3 * 20e-6 / 4)
    calls = flops.knn_mr_calls(MODEL, 2)
    fwd = sum(flops.knn_mr_forward_bound_s(c) for c in calls)
    bwd = sum(flops.knn_mr_backward_bound_s(c) for c in calls)
    assert read("knn_mr_fwd_roofline.train", r) == pytest.approx(
        100 * fwd * 2 / 20e-6)
    assert read("knn_mr_bwd_roofline.train", r) == pytest.approx(
        100 * bwd * 2 / 10e-6)


def test_roofline_is_silent_without_its_kernels():
    r = run("eval", owners={})
    assert read("knn_mr_fwd_roofline.eval", r) is None
    assert read("knn_mr_bwd_roofline.train", run("train", owners={})) is None
