"""The port's profiling tools on the CPU: ``gkgnet_tpu_torch/tools/
profile_breakdown.py`` (its cases against the JAX tool's, its tables'
arithmetic in both modes, the t@576 model's graph-conv calls at the cases'
shapes) and ``gkgnet_tpu_torch/tools/profile_loader.py`` (``--quick`` on its
fixture), and the helpers of ``gkgnet_tpu_torch/tools/determinism_probe.py``
(a card tool). Times on the CPU are the host's, never a device metric.
"""

import importlib.util
import math
import os
import subprocess
import sys

import pytest
import torch

from gkgnet_tpu_torch.core.builder import build_model
from gkgnet_tpu_torch.nn import grapher
from gkgnet_tpu_torch.ops import aggregate
from gkgnet_tpu_torch.parallel import edge_partition
from gkgnet_tpu_torch.tools import (determinism_probe, profile_breakdown,
                                    profile_loader)
from gkgnet_tpu_torch.tools.train import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_breakdown",
        os.path.join(REPO, "tools", "profile_breakdown.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,size,batch", [("s", 576, 8), ("t", 576, 8),
                                             ("b", 576, 8), ("t", 224, 2)])
def test_kernel_cases_are_the_jax_tools(arch, size, batch):
    """The distinct graph-conv calls, their counts and shapes: the JAX
    tool's list (``tools/profile_breakdown.py`` ``kernel_cases``)."""
    assert profile_breakdown.kernel_cases(arch, size, batch) == \
        _jax_tool().kernel_cases(arch, size, batch)


def test_t576_config_makes_the_calls_kernel_cases_lists(monkeypatch):
    """The model of ``configs/gkgnet_t_coco_576.py`` (arch t, bf16) makes
    16 graph-conv calls per forward, 12 Grapher and 4 label ones, at the
    shapes, dilations, biases and counts of ``kernel_cases('t', 576, 1)``
    (the calls recorded; their results stood in by zeros)."""
    cfg = load_config(os.path.join(REPO, "configs", "gkgnet_t_coco_576.py"),
                      [])
    model = build_model(cfg.model).eval()
    seen = []

    def record(x, y, bias, k, dilation):
        seen.append((x.shape[0], x.shape[1], x.shape[2], y.shape[1], k,
                     dilation, bias is not None))
        return (torch.zeros((x.shape[0], x.shape[1], k), dtype=torch.int32),
                torch.zeros_like(x))

    monkeypatch.setattr(grapher, "knn_mr_fused", record)
    with torch.no_grad():
        model(torch.zeros((1, 576, 576, 3), dtype=torch.bfloat16))
    want = []
    for (_, count, bg, n, d, m, k, dil, has_bias) in \
            profile_breakdown.kernel_cases("t", 576, 1):
        want += [(bg, n, d, m, k, dil, has_bias)] * count
    assert len(seen) == 16
    assert sorted(seen) == sorted(want)
    assert {s[2] for s in seen} == {24, 48, 120, 192}


def test_profile_breakdown_tables_on_the_cpu(monkeypatch, capsys):
    """Both modes at t@224, batch 1, one timed call each, on the CPU: a row
    per case (the kernel's plain version on CPU tensors), the kernel sum
    and the remainder from the rows, the train table and the step's split;
    no MFU from a CPU run."""
    for key, value in dict(BD_MODE="both", BD_ARCH="t", BD_SIZE="224",
                           BD_BATCH="1", BD_ITERS="1").items():
        monkeypatch.setenv(key, value)
    out = profile_breakdown.main(["--device", "cpu"])
    ev, tr = out["eval"], out["train"]
    cases = profile_breakdown.kernel_cases("t", 224, 1)
    assert [r["name"] for r in ev["rows"]] == [c[0] for c in cases]
    assert sum(r["count"] for r in ev["rows"]) == 16
    assert all(r["fits"] and r["kernel_ms"] > 0 and r["plain_ms"] > 0
               for r in ev["rows"])
    assert math.isclose(ev["kernel_sum_ms"], sum(
        r["count"] * r["kernel_ms"] for r in ev["rows"]))
    assert math.isclose(ev["dense_ms"], ev["model_ms"] - ev["kernel_sum_ms"])
    assert ev["mfu"] is None and ev["flops"] > 0
    assert [r["name"] for r in tr["rows"]] == [c[0] for c in cases]
    assert math.isclose(tr["kernel_sum_ms"], sum(
        r["count"] * r["fwd_bwd_ms"] for r in tr["rows"]))
    assert all(tr[key] > 0 for key in ("step_ms", "fwd_eval_ms",
                                       "fwd_train_ms", "fwd_bwd_ms",
                                       "opt_ms"))
    text = capsys.readouterr().out
    for line in ("| kernel SUM |", "| FULL MODEL |", "dense remainder",
                 "MFU: not measured (a CPU run)", "| FULL TRAIN STEP |",
                 "| optimizer+EMA standalone |"):
        assert line in text


def test_profile_breakdown_needs_a_card_by_default(monkeypatch):
    """The tool runs on the card unless asked for the CPU: without one it
    raises, and an unknown mode raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_breakdown.main([])
    monkeypatch.setenv("BD_MODE", "fast")
    with pytest.raises(ValueError, match="BD_MODE"):
        profile_breakdown.main(["--device", "cpu"])


def test_profile_loader_quick(capsys):
    """``--quick`` without the loader runs: every transform of PIPE_CFG
    timed (JPEG decode in LoadImageFromFile), their total, and the
    CropMixup split; the fixture is removed."""
    out = profile_loader.main(["--quick", "--skip-e2e"])
    names = [c["type"] for c in profile_loader.PIPE_CFG]
    per = out["per_transform"]
    assert list(per["transforms"]) == names
    assert all(mean >= 0 and p90 >= 0
               for mean, p90 in per["transforms"].values())
    assert per["total_ms"] > 0
    assert out["cropmix"]["views_ms"] > 0 and out["cropmix"]["blend_ms"] > 0
    assert "loader" not in out
    text = capsys.readouterr().out
    assert "img/s/core" in text and "CropMixup split" in text


def test_profile_loader_end_to_end(tmp_path):
    """The loader's img/s at 1, 2 and 4 workers in threads and processes
    on a 16-image fixture, one epoch after the warmup one."""
    ann_file = profile_loader.make_fixture(str(tmp_path), n_img=16)
    rates = profile_loader.end_to_end(str(tmp_path), ann_file, epochs=1)
    assert set(rates) == {(w, m) for w in (1, 2, 4)
                          for m in ("threads", "processes")}
    assert all(r > 0 for r in rates.values())


def test_determinism_probe_helpers(monkeypatch):
    """The probe's gradient digest tells one bit apart, its per-leaf gap is
    max|diff| / max|ref| (a leaf far below the model's largest against
    that), and its ``atomic`` modes put ``torch.gather`` alone in the two
    modules that gather, where the ``ordered`` mode leaves the port as it
    is; without a card the tool exits with an error."""
    ref = {"a": torch.tensor([1.0, -2.0]), "b": torch.tensor([1e-9, 0.0])}
    got = {"a": torch.tensor([1.0, -1.5]), "b": torch.tensor([1e-9, 1.0])}
    assert determinism_probe.digest(ref) == determinism_probe.digest(
        {k: v.clone() for k, v in ref.items()})
    bumped = {"a": ref["a"].clone(), "b": ref["b"]}
    bumped["a"].view(torch.int32)[0] += 1
    assert determinism_probe.digest(bumped) != determinism_probe.digest(ref)
    assert determinism_probe.leaf_gaps(got, ref) == [0.25, 0.5]
    for mode, want in (("ordered", aggregate.gather_nodes),
                       ("atomic", aggregate._take)):
        monkeypatch.setattr(aggregate, "gather_nodes", aggregate.gather_nodes)
        monkeypatch.setattr(edge_partition, "gather_nodes",
                            edge_partition.gather_nodes)
        determinism_probe.setup(mode)
        assert aggregate.gather_nodes is want
        assert edge_partition.gather_nodes is want
    proc = subprocess.run(
        [sys.executable, "-m", "gkgnet_tpu_torch.tools.determinism_probe"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
