"""The port's multi-rank entry points on the CPU: ``dryrun_multichip``, the
transport rule, the data-rank sharding of the loaders and the dataset-order
reassembly of scores, the train and test CLIs under
``torch.distributed.run`` on 2 ranks (the mini workspace of
``tests/test_cli.py``), and the configs' ``mesh``.

Every world has a timeout: a spawned one its process groups' and
``run_world``'s, a ``torch.distributed.run`` one the parent's, which kills
the launcher's whole process group and fails the test. The launcher takes
a free port of its own (``--standalone``), so worlds of parallel test
workers cannot collide.
"""

import json
import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from gkgnet_tpu_torch.data.samplers import DistributedSampler
from gkgnet_tpu_torch.entry import dryrun_multichip
from gkgnet_tpu_torch.parallel.mesh import choose_backend
from gkgnet_tpu_torch.tools import train as train_cli
from test_cli import MINI_CONFIG
from test_torch_data import _mini_set

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 240


def test_dryrun_multichip_cpu():
    """A world of 4 spawned CPU ranks on a (data 2, graph 2) mesh takes one
    full t@128 train step (forward through the partitioned graph convs,
    dual loss, backward, AdamW, BatchNorm statistics, EMA): a finite
    loss."""
    loss = dryrun_multichip(4, device="cpu")
    assert np.isfinite(loss)


@pytest.mark.parametrize("device,local,cards,want", [
    ("cuda", 1, 1, "nccl"), ("cuda", 8, 8, "nccl"), ("cuda", 4, 1, "gloo"),
    ("cuda", 2, 1, "gloo"), ("cpu", 4, 0, "gloo"), ("cpu", 1, 0, "gloo")])
def test_transport_rule(device, local, cards, want):
    """NCCL where every local rank has a card of its own, gloo where ranks
    share a card or run on the CPU."""
    assert choose_backend(torch.device(device), local, cards) == want


def test_loader_shards_by_data_rank():
    """The train loader's sampler takes the DATA rank: the graph ranks of a
    data group see the same rows, the data ranks disjoint rows covering
    the epoch's permutation."""
    ds = list(range(10))
    data, graph = 2, 2
    rows = {}
    for rank in range(data * graph):
        data_rank = rank // graph
        smp = DistributedSampler(ds, num_replicas=data, rank=data_rank,
                                 shuffle=True, seed=3)
        smp.set_epoch(1)
        rows[rank] = list(smp)
    assert rows[0] == rows[1] and rows[2] == rows[3]
    assert not set(rows[0]) & set(rows[2])
    assert sorted(rows[0] + rows[2]) == list(range(10))


@pytest.mark.parametrize("data", [1, 2, 3, 4])
def test_scores_reassemble_in_dataset_order(data):
    """Rank r scores dataset indices r::data; the reassembly puts every row
    back at its index, whatever the world."""
    n = 10
    scores = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    parts = [scores[r::data] for r in range(data)]
    np.testing.assert_array_equal(train_cli.reassemble(parts, n), scores)


def test_configs_with_a_mesh_load():
    """configs/gkgnet_coco_768_dist.py (graph 4) and ``mesh`` options load;
    outside a world of 4 ranks its mesh raises and names the launcher (no
    NotImplementedError any more)."""
    cfg = train_cli.load_config(
        os.path.join(REPO, "configs", "gkgnet_coco_768_dist.py"), [])
    assert cfg.mesh["graph"] == 4 and cfg.mesh.get("data") is None
    assert cfg.model["size"] == 768 and cfg.model["k"] == 16
    cfg = train_cli.load_config(
        os.path.join(REPO, "configs", "gkgnet_coco_576.py"),
        ["mesh.data=2", "mesh.graph=2", "mesh.overlap=True"])
    assert (cfg.mesh["data"], cfg.mesh["graph"], cfg.mesh["overlap"]) \
        == (2, 2, True)
    assert not hasattr(train_cli, "check_one_card")
    args = train_cli.parse_args(
        [os.path.join(REPO, "configs", "gkgnet_coco_768_dist.py"),
         "--device", "cpu"])
    with pytest.raises(ValueError, match="torch.distributed.run"):
        train_cli.join_world(args, train_cli.load_config(args.config, []))


def _torchrun(nproc: int, module: str, *args) -> subprocess.CompletedProcess:
    """``python -m torch.distributed.run --standalone`` of a port CLI on
    the CPU; the launcher and its ranks are killed at WORLD_TIMEOUT_S."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", module, *args,
           "--device", "cpu"]
    # MKL's conditional numerical reproducibility: without it MKL may round
    # otherwise from run to run with its buffers' alignment, and the random
    # model carries one ulp through a flipped kNN near-tie to a whole score
    # (seen once under a loaded host, cause not isolated: one image of the
    # 2-rank test CLI off by 1.0, the other seven bitwise equal)
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_CBWR="COMPATIBLE",
               PYTHONPATH=REPO)
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{module} on {nproc} ranks outlasted "
                    f"{WORLD_TIMEOUT_S} s")
    assert proc.returncode == 0, err[-4000:]
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The mini config trained for one epoch on 2 ranks (data 2): its
    config path and work dir."""
    root = tmp_path_factory.mktemp("multirank")
    img_dir, ann = _mini_set(root)
    cfg_path = root / "mini_config.py"
    work = root / "work"
    cfg_path.write_text(MINI_CONFIG.format(work_dir=str(work),
                                           img_dir=img_dir, ann=ann))
    run = _torchrun(2, "gkgnet_tpu_torch.tools.train", str(cfg_path),
                    "--seed", "0", "--cfg-options", "mesh.data=2")
    return str(cfg_path), str(work), run


def test_train_cli_on_two_ranks(trained):
    """One epoch on 2 ranks: one JSON log (rank 0 writes it) with the
    train, val_loss and val records, a global batch of 4, finite losses,
    and the epoch's checkpoint."""
    _, work, run = trained
    logs = [f for f in os.listdir(work) if f.endswith(".log.json")]
    assert len(logs) == 1, logs
    with open(os.path.join(work, logs[0])) as f:
        records = [json.loads(line) for line in f]
    modes = {r["mode"] for r in records}
    assert {"val_loss", "val"} <= modes
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    assert os.path.isdir(os.path.join(work, "checkpoints", "1"))
    with open(os.path.join(work, [f for f in os.listdir(work)
                                  if f.endswith(".log")][0])) as f:
        text = f.read()
    assert "global batch 4" in text and "mesh=data 2 x graph 1" in text


def _test_cli(tmp_path, nproc: int, cfg: str, ckpt: str, *options):
    """``(scores, metrics)`` of the test CLI on ``nproc`` ranks."""
    out, metrics = tmp_path / f"scores{nproc}.pkl", \
        tmp_path / f"metrics{nproc}.json"
    _torchrun(nproc, "gkgnet_tpu_torch.tools.test", cfg, ckpt, "--out",
              str(out), "--metrics-out", str(metrics), *options)
    with open(out, "rb") as f, open(metrics) as g:
        return pickle.load(f), json.load(g)


@pytest.mark.parametrize("mesh", ["mesh.data=2", "mesh.graph=2"])
def test_test_cli_two_ranks_match_one(trained, tmp_path, mesh):
    """The test CLI on 2 ranks (data 2: each scores its rows r::2; graph 2:
    the partitioned graph convs) against 1 rank on the same checkpoint,
    both launched alike (2 threads a rank): the scores in dataset order
    within 1e-5 (a data rank batches other images together, and the plain
    kNN's fp32 distances of a row block may round otherwise) and the mAP
    within 1e-4 (mAP points)."""
    cfg, work, _ = trained
    ckpt = os.path.join(work, "checkpoints")
    one, metrics_one = _test_cli(tmp_path, 1, cfg, ckpt)
    two, metrics_two = _test_cli(tmp_path, 2, cfg, ckpt, "--cfg-options",
                                 mesh)
    assert two.shape == one.shape == (8, 80)
    gap = float(np.abs(two - one).max())
    print(f"{mesh}: largest score gap {gap:.3e}")
    assert gap <= 1e-5
    assert abs(metrics_two["mAP"] - metrics_one["mAP"]) <= 1e-4


def test_test_cli_data_ranks_score_as_one_process_on_their_batches(
        trained, tmp_path):
    """The test CLI on 2 data ranks scores each image bitwise as one
    process does that is fed the same batches: the annotation reordered
    so that one rank's batches of 2 are the data ranks' own (rank r's rows
    r::2, in order), the scores put back in dataset order. Any gap to the
    1-rank run on the dataset's own batches (the test above, 1e-5) is then
    the batch composition's, not the ranks'."""
    cfg, work, _ = trained
    ckpt = os.path.join(work, "checkpoints")
    ann = train_cli.load_config(cfg, []).data["test"]["ann_file"]
    with open(ann, "rb") as f:
        records = pickle.load(f)
    order = list(range(0, len(records), 2)) + list(range(1, len(records), 2))
    ranked = tmp_path / "ranked.data"
    with open(ranked, "wb") as f:
        pickle.dump([records[i] for i in order], f)
    two, _ = _test_cli(tmp_path, 2, cfg, ckpt, "--cfg-options",
                       "mesh.data=2")
    one, _ = _test_cli(tmp_path, 1, cfg, ckpt, "--cfg-options",
                       f"data.test.ann_file={ranked}")
    back = np.empty_like(one)
    back[order] = one
    assert two.shape == (8, 80)
    np.testing.assert_array_equal(two, back)
