"""The readers of the program's own spans (``benchmark/spans.py``) on a
small recorded stretch: device spans between marker kernels (nested
markers, a kernel between spans, an unclosed span), idle gaps under and
outside the program's host ranges, and each reader's None where the
program has no such spans."""

import pytest
from torch.autograd import DeviceType

from benchmark import harness, spans, trace
from test_bench_metrics import Ev

CUDA = DeviceType.CUDA


def begin(name, t):
    return Ev(f"gkgnet_span_begin_{name}", t, t + 1, CUDA)


def end(name, t):
    return Ev(f"gkgnet_span_end_{name}", t, t + 1, CUDA)


def marked_events():
    return [
        Ev(trace.STRETCH, 0, 200),
        Ev("bench.step", 0, 190),
        Ev("gkgnet.train_step", 10, 100),
        Ev("gkgnet.graph.replay", 15, 25),
        Ev("gkgnet.input", 140, 155),
        Ev("gkgnet.train_step", 12, 98, CUDA),   # device-side annotation
        Ev("Memcpy_DtoD", 5, 8, CUDA),           # before the graph
        begin("forward", 20), begin("stem", 21),
        Ev("conv", 22, 30, CUDA),
        end("stem", 30), begin("forward", 31),   # nested: counted once
        Ev("add", 32, 35, CUDA),
        end("forward", 35),
        Ev("knn", 36, 40, CUDA),
        end("forward", 40),
        begin("backward", 41), Ev("bwd", 42, 60, CUDA), end("backward", 60),
        Ev("stray", 61, 64, CUDA),               # between spans
        begin("optimizer", 64), Ev("adam", 65, 70, CUDA),
        end("optimizer", 70),
        begin("loss", 71),                       # never closed
        Ev("late", 150, 160, CUDA),
    ]


def plain_events():
    """The same stretch from a program without spans."""
    return [e for e in marked_events()
            if not e.name.startswith(("gkgnet.", "gkgnet_span_"))]


def run(kind, events=marked_events, items=2, images=4):
    st = trace.Stretch(events(), items=items, images=images) \
        if events else None
    return {"kind": kind, "stretch": st, "owners": {}}


def read(name, r):
    return harness.reader(name).read(r, name)


def test_device_spans_between_markers():
    st = trace.Stretch(marked_events(), items=2, images=4)
    assert spans.device_seconds(st, "forward") == pytest.approx(15e-6)
    assert spans.device_seconds(st, "stem") == pytest.approx(8e-6)
    assert spans.device_seconds(st, "backward") == pytest.approx(18e-6)
    assert spans.device_seconds(st, "optimizer") == pytest.approx(5e-6)
    assert spans.device_seconds(st, "loss") is None
    assert spans.device_seconds(st, "head") is None


def test_idle_under_the_programs_host_ranges():
    """Gaps 0-5, 8-20, 72-150 and 160-200; the program's ranges cover
    10-100 and 140-155: 10 + 28 + 10 us of idle under them."""
    st = trace.Stretch(marked_events(), items=2, images=4)
    assert st.gaps == [(0, 5), (8, 20), (72, 150), (160, 200)]
    assert spans.host_idle_seconds(st) == pytest.approx(48e-6)


@pytest.mark.parametrize("name,kind,want", [
    ("fwd_ms_per_img.train", "train", 1e3 * 15e-6 / 4),
    ("fwd_ms_per_img.eval", "eval", 1e3 * 15e-6 / 4),
    ("fwd_ms_per_img.serve", "serve", 1e3 * 15e-6 / 4),
    ("bwd_ms_per_img.train", "train", 1e3 * 18e-6 / 4),
    ("optimizer_ms_per_step.train", "train", 1e3 * 5e-6 / 2),
    ("host_idle_ms.train", "train", 1e3 * 48e-6 / 2),
    ("host_idle_ms.eval", "eval", 1e3 * 48e-6 / 2),
    ("host_idle_ms.serve", "serve", 1e3 * 48e-6 / 2),
])
def test_span_readers(name, kind, want):
    assert read(name, run(kind)) == pytest.approx(want)
    other = "eval" if kind != "eval" else "train"
    assert read(name, run(other)) is None            # another kind's cell
    assert read(name, run(kind, events=None)) is None  # untraced
    assert read(name, run(kind, events=plain_events)) is None  # no spans


def test_every_span_reader_is_in_the_benchmark():
    names = {m["name"] for m in harness.load_spec()["per_layer"]}
    assert {"fwd_ms_per_img.train", "fwd_ms_per_img.eval",
            "fwd_ms_per_img.serve", "bwd_ms_per_img.train",
            "optimizer_ms_per_step.train", "host_idle_ms.train",
            "host_idle_ms.eval", "host_idle_ms.serve"} <= names
