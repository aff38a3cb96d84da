"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["reduced"] == []
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]


def test_workloads_have_their_files():
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names))
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(names)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        tr = harness.traffic(w["traffic"])
        assert tr["kind"] in harness.drivers.WINDOWS
        assert harness.limits(w["name"])


def test_metrics_and_readers():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25 and "workloads" not in setup[0]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        moves = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moves["workloads"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert hasattr(harness.reader(m["name"]), "read")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"] if harness.applies(m, cell)]
    per_layer = [m for m in SPEC["per_layer"] if harness.applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer


@pytest.mark.parametrize("name,repo", [("gkgnet-s-576", "gkgnet_coco_576.py"),
                                       ("gkgnet-t-576",
                                        "gkgnet_t_coco_576.py")])
def test_configs_are_the_repositorys(name, repo):
    from gkgnet_tpu_torch.core.config import Config
    ours = harness.config(SPEC, name)
    theirs = Config.fromfile(os.path.join(ROOT, "configs", repo))
    for key, value in theirs["model"].items():
        assert ours["model"][key] == value, key
    assert ours["samples_per_device"] == theirs["data"]["samples_per_device"]
    for key in ("lr", "weight_decay", "eps", "grad_clip_norm", "type",
                "paramwise_no_decay"):
        assert ours["optimizer"][key] == theirs["optimizer"][key], key
    assert tuple(ours["optimizer"]["betas"]) == \
        tuple(theirs["optimizer"]["betas"])
    for key, value in theirs["lr_config"].items():
        assert ours["lr_config"][key] == (list(value) if isinstance(
            value, tuple) else value), key
    assert ours["img_norm"] == {k: list(v) for k, v in
                                theirs["img_norm"].items()}
