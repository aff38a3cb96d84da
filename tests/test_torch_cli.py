"""The port's train and test CLIs on the CPU (``--device cpu``), on the
mini workspace of ``tests/test_cli.py`` (t@128, k=3, 8 JPEGs): exit codes,
the work dir and the JSON log with the JAX CLI's record keys, the test CLI's
mAP against the log's, an exact resume, checkpoints, and what the CLIs
refuse (no card, a mesh outside a world of ranks, an orbax checkpoint).
"""

import json
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkgnet_tpu.core.metrics import coco_metrics as jax_coco_metrics
from gkgnet_tpu.nn.classifier import parse_losses as jax_parse_losses
from gkgnet_tpu.nn.heads import LabelQueryHead as JaxLabelQueryHead
from gkgnet_tpu.utils.logging import load_json_log as jax_load_json_log
from gkgnet_tpu_torch.core import checkpoint
from gkgnet_tpu_torch.tools import test as test_cli
from gkgnet_tpu_torch.tools import train as train_cli
from gkgnet_tpu_torch.tools.analysis_tools import analyze_logs
from gkgnet_tpu_torch.utils.logging import load_json_log
from test_cli import MINI_CONFIG
from test_torch_data import _mini_set, assert_same, load_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# torch's CPU threads for this module's runs: the suite runs several
# test files at once, and 8 threads per run oversubscribe the host
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    img_dir, ann = _mini_set(root)
    cfg_path = root / "mini_config.py"
    cfg_path.write_text(MINI_CONFIG.format(
        work_dir=str(root / "work"), img_dir=img_dir, ann=ann))
    return root, str(cfg_path)


def _run(*args):
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS))
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=600, cwd=REPO, env=env)


def _records(work_dir):
    logs = [f for f in os.listdir(work_dir) if f.endswith(".log.json")]
    assert len(logs) == 1, logs
    path = os.path.join(work_dir, logs[0])
    with open(path) as f:
        return path, [json.loads(line) for line in f]


def _jax_keys():
    """The record keys the JAX train CLI writes: its train step's log
    scalars (the head's losses through parse_losses, grad_norm, lr) plus
    data_time, and the metric dict of its datasets' evaluate."""
    losses = JaxLabelQueryHead(num_classes=80, in_channels=8).loss(
        jnp.zeros((2, 80)), jnp.zeros((2, 80)))
    _, loss_logs = jax_parse_losses(losses)
    metrics = jax_coco_metrics(np.eye(4, 80, dtype=np.int8),
                               np.random.default_rng(0).random((4, 80)))
    return set(loss_logs), set(metrics)


@pytest.fixture(scope="module")
def trained(workspace):
    """One epoch through ``python -m gkgnet_tpu_torch.tools.train`` with
    EMA, then the test CLI on the epoch's checkpoint: raw weights through
    ``python -m gkgnet_tpu_torch.tools.test``, EMA weights through its
    ``main``."""
    root, cfg = workspace
    work = str(root / "work")
    ckpt = os.path.join(work, "checkpoints")
    proc = _run("gkgnet_tpu_torch.tools.train", cfg, "--device", "cpu",
                "--ema")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out, metrics_out = str(root / "scores.pkl"), str(root / "metrics.json")
    proc = _run("gkgnet_tpu_torch.tools.test", cfg, ckpt, "--device", "cpu",
                "--out", out, "--metrics-out", metrics_out)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        scores = pickle.load(f)
    with open(metrics_out) as f:
        metrics = json.load(f)
    assert json.loads(proc.stdout[proc.stdout.index("{"):]) == metrics
    ema_metrics, ema_scores = test_cli.main([cfg, ckpt, "--device", "cpu",
                                             "--ema"])
    return work, {False: (scores, metrics), True: (ema_scores, ema_metrics)}


def test_train_cli_writes_the_jax_records(trained):
    work, _ = trained
    assert {"config.json", "checkpoints", "best"} <= set(os.listdir(work))
    path, records = _records(work)
    modes = [r["mode"] for r in records]
    assert modes == ["train", "train", "val_loss", "val"], modes
    loss_keys, metric_keys = _jax_keys()
    base = {"mode", "epoch", "iter", "time"}
    train_keys = base | loss_keys | {"data_time", "grad_norm", "lr"}
    assert set(records[0]) == train_keys
    assert set(records[2]) == base | loss_keys
    assert set(records[3]) == base | metric_keys | {
        f"{k}_ema" for k in metric_keys}
    for r in records:
        assert all(np.isfinite(v) for k, v in r.items() if k != "mode")
    assert jax_load_json_log(path) == load_json_log(path)
    with open(os.path.join(work, "config.json")) as f:
        assert json.load(f)["model"]["arch"] == "t"


@pytest.mark.parametrize("tool", ["port", "jax"])
def test_log_reads_with_the_analysis_tool(trained, capsys, tool):
    """The port's analyze_logs reads the log and prints each epoch's
    iteration window; the JAX tool prints the same lines."""
    path, _ = _records(trained[0])
    port_logs = analyze_logs.main(["cal_train_time", path])
    port_out = capsys.readouterr().out
    assert "epoch 1: avg iter window" in port_out
    assert port_logs == [load_json_log(path)]
    if tool == "jax":
        jax_tool = load_tool("analysis_tools/analyze_logs.py")
        jax_tool.cal_train_time(jax_tool.load_json_log(path), None)
        assert capsys.readouterr().out == port_out


@pytest.mark.parametrize("ema", [False, True])
def test_test_cli_reproduces_the_logged_map(trained, ema):
    """The test CLI on the epoch's checkpoint scores the val set (the
    same images) with the weights the train CLI evaluated: the same mAP,
    exactly, on the CPU."""
    work, tests = trained
    scores, metrics = tests[ema]
    assert scores.shape == (8, 80) and scores.dtype == np.float32
    assert np.all((scores >= 0) & (scores <= 1))
    val = [r for r in _records(work)[1] if r["mode"] == "val"][0]
    assert metrics["mAP"] == val["mAP_ema" if ema else "mAP"]


@pytest.mark.parametrize("cli", ["train", "test"])
def test_clis_need_a_card_unless_cpu_is_asked(workspace, cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = train_cli.main if cli == "train" else test_cli.main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([workspace[1]])


@pytest.mark.parametrize("option", ["mesh.graph=2", "mesh.data=4",
                                    "--multihost"])
def test_train_cli_refuses_more_than_one_card(workspace, option, tmp_path):
    """Outside a world of ranks a mesh over more than one rank, or
    --multihost without the torch.distributed.run environment, raises and
    names the launcher (tests/test_torch_multirank.py runs the CLIs in a
    world of ranks)."""
    args = [workspace[1], "--device", "cpu", "--work-dir", str(tmp_path)]
    args += [option] if option.startswith("--") else ["--cfg-options",
                                                      option]
    with pytest.raises((ValueError, RuntimeError),
                       match="torch.distributed.run"):
        train_cli.main(args)


def _state(path):
    return torch.load(os.path.join(path, checkpoint.STATE_FILE),
                      weights_only=True)


def test_resume_is_bitwise_a_straight_run(workspace, tmp_path):
    """Epoch 1, then --resume-from for epoch 2, against 2 epochs at once:
    every parameter, buffer, AdamW moment and step count, EMA tensor and
    the step are bitwise equal."""
    cfg = workspace[1]
    base = [cfg, "--device", "cpu", "--ema"]
    train_cli.main(base + ["--work-dir", str(tmp_path / "straight"),
                           "--max-epochs", "2"])
    train_cli.main(base + ["--work-dir", str(tmp_path / "first"),
                           "--max-epochs", "1"])
    summary = train_cli.main(base + [
        "--work-dir", str(tmp_path / "resumed"), "--max-epochs", "2",
        "--resume-from", str(tmp_path / "first" / "checkpoints")])
    assert summary["steps"] == summary["steps_per_epoch"] > 0
    straight = _state(tmp_path / "straight" / "checkpoints" / "2")
    resumed = _state(tmp_path / "resumed" / "checkpoints" / "2")
    assert straight["step"] == 2 * summary["steps_per_epoch"]
    assert straight["optimizer"]["state"]
    assert straight["ema_params"] and \
        set(straight["ema_params"]) <= set(straight["model"])
    assert_same(straight, resumed, "state")
    first = _state(tmp_path / "first" / "checkpoints" / "1")
    assert not torch.equal(first["model"]["head.fc1.weight"],
                           straight["model"]["head.fc1.weight"])


def test_checkpoints_keep_the_newest_and_refuse_orbax(workspace, tmp_path):
    """Three epochs (with the TensorBoard writer on): the newest
    ``max_to_keep`` saves stay, with their meta; an orbax-style directory
    is refused; ``--load-from`` of a save trains on."""
    cfg = workspace[1]
    work = tmp_path / "work"
    train_cli.main([cfg, "--device", "cpu", "--work-dir", str(work),
                    "--max-epochs", "3", "--cfg-options",
                    "log_config.tensorboard=True"])
    events = os.listdir(work / "tf_logs")
    assert len(events) == 1 and events[0].startswith("events.out.tfevents")
    # max_to_keep=2 in the mini config
    assert checkpoint.epochs(str(work / "checkpoints")) == [2, 3]
    assert checkpoint.latest_epoch(str(work / "checkpoints")) == 3
    with open(work / "checkpoints" / "3" / checkpoint.META_FILE) as f:
        meta = json.load(f)
    assert meta["epoch"] == 3 and len(meta["CLASSES"]) == 80
    orbax = tmp_path / "orbax" / "3"
    (orbax / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        train_cli.main([cfg, "--device", "cpu", "--work-dir",
                        str(tmp_path / "w2"), "--load-from",
                        str(tmp_path / "orbax")])
    loaded = train_cli.main([cfg, "--device", "cpu", "--work-dir",
                             str(tmp_path / "w3"), "--max-epochs", "1",
                             "--load-from", str(work / "checkpoints")])
    assert loaded["steps"] > 0
