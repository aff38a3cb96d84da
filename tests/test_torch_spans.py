"""The port's spans and set-up table (``utils/profiling.py``) on the CPU:
the host ranges an eager step opens under ``torch.profiler`` and how they
nest; the device spans' markers as a capture would launch them, in order
and within ``MAX_MARKERS``, and that nothing else launches one; that with
no profiler and no capture a span does nothing; the set-up table's rows
from a build, a kernel load and ``StepGraphs``' warm-up and capture; and
``csrc/spans.cu``'s list against the spans the port marks. The markers on
the card: tests/test_torch_cuda.py.
"""

import ctypes
import os
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gkgnet_tpu_torch import entry
from gkgnet_tpu_torch.core import graphs as tgraphs
from gkgnet_tpu_torch.core.optim import build_optimizer
from gkgnet_tpu_torch.core.trainer import (create_train_state,
                                           make_device_normalize,
                                           make_eval_step, make_train_step)
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier, init_parameters
from gkgnet_tpu_torch.ops import _build
from gkgnet_tpu_torch.utils import profiling
from test_torch_compiled import _FakeGraph, fake_cuda  # noqa: F401

SMALL = dict(arch="t", k=3, k_label_gcn=3, n_classes=10, size=128)
MODEL_SPANS = ["stem", "stage1", "label1", "stage2", "label2", "stage3",
               "label3", "stage4", "label4", "head"]
TRAIN_SPANS = ["forward", "loss", "backward", "optimizer"]


@pytest.fixture(scope="module")
def small():
    """The small model and its train state, built once; one torch thread
    beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    model = GKGNetClassifier(**SMALL)
    init_parameters(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, build_optimizer(model, 1e-4))
    gen = torch.Generator().manual_seed(1)
    img = torch.randn((2, 128, 128, 3), generator=gen)
    gt = (torch.rand((2, 10), generator=gen) < 0.3).float()
    yield model, state, img, gt
    torch.set_num_threads(threads)


def _ranges(fn) -> list:
    """The ``gkgnet.*`` host ranges ``fn()`` opens under the profiler, by
    start: (name without the prefix, its ``gkgnet.*`` ancestors)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith(profiling.PREFIX):
            continue
        chain, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith(profiling.PREFIX):
                chain.append(p.name[len(profiling.PREFIX):])
            p = p.cpu_parent
        out.append((e.name[len(profiling.PREFIX):], chain))
    return out


@pytest.fixture(scope="module")
def eval_ranges(small):
    model, state, img, _ = small
    return _ranges(lambda: make_eval_step()(state, img))


@pytest.fixture(scope="module")
def train_ranges(small):
    model, state, img, gt = small
    return _ranges(lambda: make_train_step()(
        state, {"img": img, "gt_label": gt}))


@pytest.mark.parametrize("name", MODEL_SPANS)
def test_eager_forward_nests_each_model_span_in_forward(eval_ranges, name):
    """An eager eval step under the profiler: each of the model's spans
    once, inside ``forward`` inside ``eval_step``, in the model's order."""
    got = [(n, chain) for n, chain in eval_ranges if n == name]
    assert got == [(name, ["forward", "eval_step"])]
    order = [n for n, _ in eval_ranges if n in MODEL_SPANS]
    assert order == MODEL_SPANS


def test_eager_eval_step_host_ranges(eval_ranges):
    top = [(n, chain) for n, chain in eval_ranges
           if n not in MODEL_SPANS]
    assert top == [("eval_step", []), ("eval_step.prepare", ["eval_step"]),
                   ("forward", ["eval_step"])]


@pytest.mark.parametrize("name", TRAIN_SPANS)
def test_eager_train_step_adds_loss_backward_optimizer(train_ranges, name):
    """An eager train step: forward, loss, backward and optimizer once
    each, in that order, inside ``train_step`` after its ``prepare``; the
    model's spans inside ``forward``."""
    assert [c for n, c in train_ranges if n == name] == [["train_step"]]
    order = [n for n, c in train_ranges if c == ["train_step"]]
    assert order == ["train_step.prepare"] + TRAIN_SPANS
    assert [n for n, c in train_ranges if c[:1] == ["forward"]] \
        == MODEL_SPANS


def test_knn_mr_backward_has_its_host_range(train_ranges):
    """The kNN operators' backward formula runs in ``knn_mr.bwd``, once
    per Grapher and label tap (16 at t), inside ``backward``."""
    bwd = [c for n, c in train_ranges if n == "knn_mr.bwd"]
    assert len(bwd) == 16 and all(c[0] == "backward" for c in bwd)


def test_predict_and_normalize_open_their_input_ranges(small):
    model, _, img, _ = small
    got = _ranges(lambda: entry.predict(model, img[:1]))
    assert got[:2] == [("predict", []), ("input", ["predict"])]
    assert ("eval_step", ["predict"]) in got
    norm = make_device_normalize(((1.0, 2.0, 3.0), (4.0, 5.0, 6.0)))
    u8 = torch.zeros((1, 4, 4, 3), dtype=torch.uint8)
    assert _ranges(lambda: norm(u8)) == [("input", [])]
    assert _ranges(lambda: norm(u8.float())) == []   # passes through


@pytest.fixture
def marks(monkeypatch):
    """Every step runs as if its stream captured: the markers each device
    span would launch, recorded as (span, 0 begin | 1 end)."""
    got = []
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    monkeypatch.setattr(profiling, "_mark",
                        lambda name, end: got.append((name, end)))
    return got


def _pairs(names):
    return [(n, 0) for n in names[:1]] + [
        m for n in names[1:] for m in ((n, 0), (n, 1))] + [(names[0], 1)]


def test_capture_marks_the_eval_forward_in_order(small, marks):
    """An eval step's markers: ``forward`` around the model's ten spans,
    22 in all."""
    _, state, img, _ = small
    make_eval_step()(state, img)
    assert marks == _pairs(["forward"] + MODEL_SPANS)
    assert len(marks) == 22 <= profiling.MAX_MARKERS


@pytest.mark.parametrize("ema,scaler,count", [(False, False, 28),
                                              (True, False, 30),
                                              (True, True, 32)])
def test_capture_marks_the_train_step_in_order(small, marks, ema, scaler,
                                               count):
    """A train step's markers: forward (holding the model's spans), loss,
    backward, optimizer, then ``ema``; the loss scaler's span holds the
    optimizer's. With every option on, ``MAX_MARKERS``; none from inside
    the kNN operators' backward formula."""
    model, state, img, gt = small
    state = create_train_state(model, state.optimizer, ema=ema,
                               dynamic_loss_scale=scaler)
    step = make_train_step(ema_momentum=2e-4 if ema else None,
                           dynamic_loss_scale=scaler)
    step(state, {"img": img, "gt_label": gt})
    want = _pairs(["forward"] + MODEL_SPANS) + _pairs(["loss"]) \
        + _pairs(["backward"])
    want += ([("loss_scale", 0)] + _pairs(["optimizer"])
             + [("loss_scale", 1)]) if scaler else _pairs(["optimizer"])
    want += _pairs(["ema"]) if ema else []
    assert marks == want and len(marks) == count <= profiling.MAX_MARKERS


def test_spans_cu_lists_every_marked_span():
    """``csrc/spans.cu``'s one list holds exactly the port's device
    spans."""
    with open(os.path.join(_build.CSRC_DIR, "spans.cu")) as f:
        src = f.read()
    body = re.search(r"#define GKGNET_SPANS\(X\)(.*?)\n\n", src, re.S)
    listed = re.findall(r"X\((\w+)\)", body.group(1))
    assert sorted(listed) == sorted(TRAIN_SPANS + MODEL_SPANS
                                    + ["ema", "loss_scale"])


def test_without_profiler_or_capture_a_span_does_nothing(small,
                                                         monkeypatch):
    """No profiler, no capture: a step opens no host range and launches
    no marker."""
    _, state, img, gt = small

    def refuse(*args):
        raise AssertionError("a span acted without a profiler or capture")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(profiling, "_mark", refuse)
    launched = profiling.marker_launches
    make_eval_step()(state, img)
    with profiling.span("forward"), profiling.host_span("graph.replay"):
        pass
    assert profiling.marker_launches == launched


def test_timed_rows_tallies_reset(monkeypatch):
    monkeypatch.setattr(profiling, "_table", {})
    with profiling.timed("a"):
        pass
    with profiling.timed("a"):
        sum(range(10000))
    profiling.tally("a", "builds")
    profiling.tally("a", "builds", 2)

    @profiling.timed("b")
    def work(x):
        return x + 1

    assert work(1) == 2 and work(2) == 3
    with pytest.raises(ValueError):
        with profiling.timed("c"):
            raise ValueError("a failed build")
    table = profiling.table()
    assert set(table) == {"a", "b"}
    assert table["a"]["count"] == 2 and table["a"]["builds"] == 3
    assert 0 < table["a"]["max_s"] <= table["a"]["total_s"]
    assert table["b"]["count"] == 2
    table["a"]["count"] = 99   # a copy
    assert profiling.table()["a"]["count"] == 2
    profiling.reset()
    assert profiling.table() == {}


def test_table_holds_the_model_and_optimizer_builds(monkeypatch):
    monkeypatch.setattr(profiling, "_table", {})
    model = GKGNetClassifier(**SMALL)
    build_optimizer(model, 1e-4)
    table = profiling.table()
    assert table["setup.model"]["count"] == 1
    assert table["setup.optimizer"]["count"] == 1
    assert table["setup.model"]["total_s"] > 0


def test_kernel_loads_are_timed_with_builds_and_cache_hits(monkeypatch,
                                                           tmp_path):
    """``_build.load``: the first load of a name is timed in
    ``setup.kernels``, a build counted as ``builds`` (its compiler log
    kept), a built library as ``cached``; a loaded name times nothing."""
    monkeypatch.setattr(profiling, "_table", {})
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "compiler_log", {})
    monkeypatch.setattr(_build, "_lib_path",
                        lambda name: str(tmp_path / f"{name}.so"))

    def compile_(name, out):
        open(out, "w").close()
        return f"ptxas info: {name}"

    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: ("lib", path))
    first = _build.load("x")
    assert _build.load("x") is first
    (tmp_path / "y.so").touch()
    _build.load("y")
    row = profiling.table()["setup.kernels"]
    assert row["count"] == 2 and row["builds"] == 1 and row["cached"] == 1
    assert _build.compiler_log == {"x": "ptxas info: x", "y": ""}


def test_step_graphs_time_warm_up_and_capture_and_cap_markers(
        fake_cuda, monkeypatch):  # noqa: F811
    """``StepGraphs`` on the stand-in graph API: the warm-up and the
    capture in the set-up table, the markers a capture launched kept with
    its graph, and a capture of more than ``MAX_MARKERS`` refused."""
    monkeypatch.setattr(profiling, "_table", {})
    graphs = tgraphs.StepGraphs()
    per_capture = []

    def body(inputs):
        for _ in range(per_capture[-1]):
            profiling.marker_launches += 1   # what ``_mark`` counts
        out = [inputs[0] * 2.0]
        graph = _FakeGraph.current
        if graph is not None:
            graph.run, graph.outputs = (lambda: [inputs[0] * 2.0]), out
        return out

    per_capture.append(0)
    graphs("k", [torch.ones(1)], body, [])        # warm-up
    per_capture.append(22)
    graphs("k", [torch.ones(1)], body, [])        # capture
    graphs("k", [torch.ones(1)], body, [])        # replay
    (cap,) = graphs.graphs.values()
    assert cap.markers == 22
    table = profiling.table()
    assert table["graph.warm"]["count"] == 1
    assert table["graph.capture"]["count"] == 1
    per_capture.append(profiling.MAX_MARKERS + 2)
    graphs("k", [torch.ones(2)], body, [])        # warm-up
    with pytest.raises(RuntimeError, match="34 span markers"):
        graphs("k", [torch.ones(2)], body, [])
