"""The command line and the result line: arguments, the refusal to run
without a card (no fallback to the CPU, no result), and the keys of the
last line of a run."""

import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from benchmark import harness

ROOT = harness.ROOT
RUN = [sys.executable, "benchmark/run.py", "--workload", "s576-eval-b16",
       "--seed", "2147483659", "--seconds", "1", "--trace", "0"]


def test_arguments():
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    import run
    a = run.parse_args(["--workload", "w", "--seed", "4294967297",
                        "--seconds", "10", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("w", 2 ** 32 + 1,
                                                         10.0, 1)
    with pytest.raises(SystemExit):
        run.parse_args(["--workload", "w", "--seed", "1", "--seconds", "1",
                        "--trace", "2"])


def test_no_card_no_result():
    """Without a card the run fails and prints nothing on stdout."""
    out = subprocess.run(RUN, cwd=ROOT, capture_output=True, text=True,
                         timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_is_no_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_result_line(tiny):
    r = harness.run_cell(tiny, "s576-eval-b16", 2 ** 31 + 11, 0.2, False,
                         torch.device("cpu"))
    err, out = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.report(r)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"eval_img_per_s", "setup_s"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(harness.limits("s576-eval-b16"))
    assert err.getvalue().splitlines()[-1].startswith("check score_gap ")
