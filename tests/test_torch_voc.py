"""The port's PASCAL VOC and ImageList datasets against the JAX package's on
the CPU, and the VOC path through the port's CLIs: the labels of every image
of two VOCdevkit fixtures (``tests/test_voc.py``'s plans and a seeded set
written by ``chip_smoke.write_vocdevkit``, the writer the card's run uses)
and of the pickle form, in train and test mode; ``evaluate`` on seeded
scores; the builder with a pipeline; ``configs/gkgnet_voc_448.py`` through
the port's ``Config``; the image list's samples and metrics; then one epoch
of the train CLI and the test CLI with ``--out`` on a VOC mini config
(``--device cpu``, t@128, k 3, 20 classes, inheriting the VOC config), the
analysis tools on that ``--out`` against the JAX tools, and what a 20-class
model does with an 80-class checkpoint.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import write_vocdevkit
from gkgnet_tpu.core import builder as jbuilder
from gkgnet_tpu.core.config import Config as JaxConfig
from gkgnet_tpu.data.single_label import ImageListDataset as JaxImageList
from gkgnet_tpu.data.voc import VOCMultiLabel as JaxVOC
from gkgnet_tpu_torch.core import builder as tbuilder
from gkgnet_tpu_torch.core.builder import build_model
from gkgnet_tpu_torch.core.checkpoint import load_params_only, save_checkpoint
from gkgnet_tpu_torch.core.config import Config
from gkgnet_tpu_torch.core.trainer import create_train_state
from gkgnet_tpu_torch.data.single_label import ImageListDataset
from gkgnet_tpu_torch.data.voc import VOC_CLASSES, VOCMultiLabel
from gkgnet_tpu_torch.tools import test as test_cli
from gkgnet_tpu_torch.tools import train as train_cli
from gkgnet_tpu_torch.tools.analysis_tools import (analyze_results,
                                                   eval_metric)
from test_torch_data import assert_same, load_tool
from test_voc import _write_xml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_CONFIG = os.path.join(REPO, "configs", "gkgnet_voc_448.py")
PLANS = [                                 # tests/test_voc.py's fixture
    [("dog", 0), ("cat", 0)],
    [("dog", 1)],                         # only-difficult dog -> -1
    [("person", 0), ("person", 1)],       # difficult + normal -> 1
    [("car", 0), ("bottle", 0), ("unknown_cls", 0)],  # unknown skipped
]
# the VOC mini config: configs/gkgnet_voc_448.py at t@128, k 3, fp32, on
# the written fixture, loader threads
VOC_MINI_CONFIG = """
_base_ = [{base!r}]
work_dir = {work_dir!r}
model = dict(arch="t", k=3, k_label_gcn=3, size=128, dtype="float32")
img_norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375])
train_pipeline = [
    dict(type="LoadImageFromFile"),
    dict(type="CropMixup", p=0.5, size=128, scale=0.01, number=234),
    dict(type="RandomFlip", flip_prob=0.5),
    dict(type="Trivial", p=1.0),
    dict(type="Normalize", **img_norm),
    dict(type="Collect", keys=("img", "gt_label")),
]
test_pipeline = [
    dict(type="LoadImageFromFile"),
    dict(type="Resize", size=128, backend="pillow", interpolation="bicubic"),
    dict(type="Normalize", **img_norm),
    dict(type="Collect", keys=("img",)),
]
sets = {voc!r} + "/ImageSets/Main/"
data = dict(
    samples_per_device=2, workers=2, loader_mode="threads",
    train=dict(data_prefix={voc!r}, ann_file=sets + "trainval.txt",
               pipeline=train_pipeline),
    val=dict(data_prefix={voc!r}, ann_file=sets + "test.txt",
             pipeline=test_pipeline),
    test=dict(data_prefix={voc!r}, ann_file=sets + "test.txt",
              pipeline=test_pipeline),
)
runner = dict(max_epochs=1)
log_config = dict(interval=2, tensorboard=False)
"""
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


def _jpegs(root, n, seed, shape=(40, 56, 3)):
    """n seeded JPEGs and a COCO-style multi-hot (80,) for each."""
    root.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        path = root / f"src_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)
                        ).save(path)
        labels = (rng.random(80) < 0.15).astype(np.int8)
        labels[i % 80] = 1
        items.append((str(path), labels))
    return items


@pytest.fixture(scope="module")
def plans_voc(tmp_path_factory):
    """tests/test_voc.py's four images and XMLs: (root, trainval split)."""
    root = tmp_path_factory.mktemp("VOC2007")
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    ids = []
    for i, objs in enumerate(PLANS):
        img_id = f"00{i:04d}"
        ids.append(img_id)
        Image.fromarray(rng.integers(0, 255, size=(40, 56, 3),
                                     dtype=np.uint8)).save(
            root / "JPEGImages" / f"{img_id}.jpg")
        _write_xml(root / "Annotations" / f"{img_id}.xml", objs)
    split = root / "ImageSets" / "Main" / "trainval.txt"
    split.write_text("\n".join(ids) + "\n")
    return str(root), str(split)


@pytest.fixture(scope="module")
def written_voc(tmp_path_factory):
    """A seeded VOCdevkit of 8 trainval and 6 test images written by the
    card run's writer: (VOC2007 dir, kinds, trainval split, test split)."""
    root = tmp_path_factory.mktemp("written")
    voc, kinds = write_vocdevkit(str(root), {
        "trainval": _jpegs(root / "src_train", 8, 0),
        "test": _jpegs(root / "src_test", 6, 1)}, seed=0)
    main = os.path.join(voc, "ImageSets", "Main")
    return (voc, kinds, os.path.join(main, "trainval.txt"),
            os.path.join(main, "test.txt"))


def _split(request, which):
    if which == "plans":
        return request.getfixturevalue("plans_voc")
    voc, _, trainval, _ = request.getfixturevalue("written_voc")
    return voc, trainval


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("which", ["plans", "written"])
def test_voc_samples_equal_jax(request, which, test_mode):
    """Every image's annotation and sample label (abs() at train, -1 kept
    in test mode), the label matrix, the category ids and the file paths
    equal the JAX dataset's."""
    root, split = _split(request, which)
    port = VOCMultiLabel(root, split, test_mode=test_mode)
    jax_ds = JaxVOC(root, split, test_mode=test_mode)
    assert len(port) == len(jax_ds) > 0
    assert_same(port.data_infos, jax_ds.data_infos)
    assert_same(port.get_gt_labels(), jax_ds.get_gt_labels())
    for i in range(len(port)):
        assert_same(port.prepare_data(i), jax_ds.prepare_data(i))
        assert port.get_cat_ids(i) == jax_ds.get_cat_ids(i)
        assert port.filepath(i) == jax_ds.filepath(i)
    gt = port.get_gt_labels()
    labels = np.stack([port[i]["gt_label"] for i in range(len(port))])
    assert (gt == -1).any()
    assert ((labels == -1).any()) == test_mode


def test_written_voc_has_both_difficult_kinds(written_voc):
    """The writer's seeded flags give (image, class) pairs that are
    difficult only (-1 at eval) and pairs with both kinds (1)."""
    voc, kinds, _, test = written_voc
    assert kinds["difficult_only"] > 0 and kinds["mixed"] > 0
    gt = VOCMultiLabel(voc, test, test_mode=True).get_gt_labels()
    assert gt.shape == (6, 20) and (gt == -1).any() and (gt == 1).any()


@pytest.mark.parametrize("test_mode", [False, True])
def test_voc_pickle_form_equals_jax(tmp_path, test_mode):
    rng = np.random.default_rng(3)
    records = [{"objects": rng.integers(-1, 2, 20).astype(np.int8),
                "file_name": f"x{i}.jpg"} for i in range(5)]
    ann = tmp_path / "voc.data"
    with open(ann, "wb") as f:
        pickle.dump(records, f)
    port = VOCMultiLabel(str(tmp_path), str(ann), test_mode=test_mode)
    jax_ds = JaxVOC(str(tmp_path), str(ann), test_mode=test_mode)
    assert_same(port.data_infos, jax_ds.data_infos)
    for i in range(5):
        assert_same(port.prepare_data(i), jax_ds.prepare_data(i))
        assert port.get_cat_ids(i) == jax_ds.get_cat_ids(i)


@pytest.mark.parametrize("which", ["plans", "written"])
def test_voc_evaluate_equals_jax(request, which):
    """mAP with the difficult entries left out and CP..OF1 at 0.5 on seeded
    scores: the JAX dict, to 1e-9 (both numpy)."""
    root, split = _split(request, which)
    port = VOCMultiLabel(root, split, test_mode=True)
    jax_ds = JaxVOC(root, split, test_mode=True)
    scores = np.random.default_rng(5).random((len(port), 20))
    got, want = port.evaluate(scores), jax_ds.evaluate(scores)
    assert set(got) == set(want) == {"mAP", "CP", "CR", "CF1", "OP", "OR",
                                     "OF1"}
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-9), key


def test_voc_builder_with_a_pipeline_equals_jax(written_voc):
    voc, _, trainval, _ = written_voc
    cfg = dict(type="VOC", data_prefix=voc, ann_file=trainval, pipeline=[
        dict(type="LoadImageFromFile"),
        dict(type="Resize", size=32, backend="pillow",
             interpolation="bicubic"),
        dict(type="Normalize", mean=[0, 0, 0], std=[255, 255, 255]),
        dict(type="Collect", keys=("img", "gt_label"))])
    port, jax_ds = tbuilder.build_dataset(cfg), jbuilder.build_dataset(cfg)
    assert isinstance(port, VOCMultiLabel) and not port.test_mode
    for i in range(len(port)):
        out = port[i]
        assert out["img"].shape == (32, 32, 3)
        assert_same(out, jax_ds[i])


TYPE_SWITCH_BASE = """
optimizer = dict(type="AdamW", lr=1e-4, weight_decay=0.05,
                 paramwise_cfg=dict(norm_decay_mult=0.0))
model = dict(head=dict(type="MultiLabelLinearHead", n_classes=80, loss_w=1.0))
data = dict(train=dict(type="ClassBalancedDataset", oversample_thr=1e-3,
                       dataset=dict(type="COCO", data_prefix="coco")))
"""


@pytest.mark.parametrize("child,wrapper", [
    ('optimizer = dict(type="SGD", lr=0.1)', False),
    ('model = dict(head=dict(type="OtherHead", n_classes=20))', False),
    ('optimizer = dict(type="AdamW", eps=1e-6)', False),
    ('optimizer = dict(betas=(0.8, 0.9))', False),
    ('data = dict(train=dict(type="RepeatDataset", times=2))', True),
    ('data = dict(train=dict(type="VOC", data_prefix="voc"))', True)],
    ids=["optimizer", "model", "same_type", "no_type", "wrapper_to_wrapper",
         "wrapper_to_set"])
def test_a_type_switch_merges_as_jax_but_over_a_dataset_wrapper(
        tmp_path, child, wrapper):
    """A child that switches an optimizer's or a model part's ``type``
    keeps the base's other keys, as the JAX merge does, and so does one of
    the same type or with none; one that switches a dataset wrapper's
    replaces the wrapper and its keys."""
    (tmp_path / "base.py").write_text(TYPE_SWITCH_BASE)
    path = tmp_path / "child.py"
    path.write_text(f"_base_ = ['base.py']\n{child}\n")
    got, want = Config.fromfile(str(path)), JaxConfig.fromfile(str(path))
    if not wrapper:
        assert got == want
        return
    assert {k: v for k, v in got.items() if k != "data"} == \
        {k: v for k, v in want.items() if k != "data"}
    stray = {"oversample_thr", "dataset"}
    new = set(got.data["train"])
    assert set(want.data["train"]) - new == stray and not stray & new
    assert got.data["train"] == {k: v for k, v in want.data["train"].items()
                                 if k not in stray}


def test_voc_config_loads_and_its_train_set_builds(written_voc):
    """configs/gkgnet_voc_448.py through the port's Config: the JAX dict
    but for the COCO base's ClassBalancedDataset keys under data.train,
    which the JAX merge keeps and its builder then refuses."""
    cfg = Config.fromfile(VOC_CONFIG)
    want = JaxConfig.fromfile(VOC_CONFIG)
    stray = {"oversample_thr", "dataset"}
    assert set(want.data["train"]) - set(cfg.data["train"]) == stray
    assert {k: v for k, v in want.data["train"].items()
            if k not in stray} == cfg.data["train"]
    assert {k: v for k, v in want.items() if k != "data"} == \
        {k: v for k, v in cfg.items() if k != "data"}
    voc, _, trainval, _ = written_voc
    paths = dict(data_prefix=voc, ann_file=trainval)
    assert type(tbuilder.build_dataset(
        dict(cfg.data["train"], **paths))) is VOCMultiLabel
    with pytest.raises(TypeError, match="oversample_thr"):
        jbuilder.build_dataset(dict(want.data["train"], **paths))
    assert cfg.model["n_classes"] == 20 and cfg.model["size"] == 448
    assert cfg.model["dtype"] == "bfloat16" and not cfg.ema["enabled"]
    assert cfg.data["samples_per_device"] == 16
    assert cfg.data["train"]["type"] == "VOC"
    assert cfg.evaluation["save_best"] == "mAP"


# ---------------------------------------------------------------- ImageList

@pytest.fixture(scope="module")
def image_list(tmp_path_factory):
    root = tmp_path_factory.mktemp("image_list")
    rng = np.random.default_rng(0)
    lines = []
    for i in range(9):
        name = f"x_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)
                        ).save(root / name)
        lines.append(f"{name} {i % 4}")
    ann = root / "ann.txt"
    ann.write_text("\n".join(lines) + "\n\n")
    return str(root), str(ann)


@pytest.mark.parametrize("metric,options", [
    ("accuracy", None),
    (["accuracy", "precision", "recall", "f1_score", "support"],
     {"topk": (1, 3)}),
    (["precision", "recall", "f1_score"], {"average_mode": "none"}),
])
def test_image_list_equals_jax(image_list, metric, options):
    prefix, ann = image_list
    classes = ["a", "b", "c", "d"]
    port = ImageListDataset(prefix, ann, classes=classes)
    jax_ds = JaxImageList(prefix, ann, classes=classes)
    assert port.CLASSES == jax_ds.CLASSES == classes
    assert_same(port.data_infos, jax_ds.data_infos)
    assert_same(port.get_gt_labels(), jax_ds.get_gt_labels())
    for i in range(len(port)):
        assert_same(port.prepare_data(i), jax_ds.prepare_data(i))
        assert port.get_cat_ids(i) == jax_ds.get_cat_ids(i)
        assert port.filepath(i) == jax_ds.filepath(i)
    scores = np.random.default_rng(2).random((len(port), 4))
    got = port.evaluate(scores, metric=metric, metric_options=options)
    want = jax_ds.evaluate(scores, metric=metric, metric_options=options)
    assert_same(got, want)


@pytest.mark.parametrize("case", ["VOC", "ImageList"])
def test_builder_builds_the_ported_datasets(case, written_voc, image_list):
    """The two dataset types the builder refused before they were
    ported."""
    if case == "VOC":
        voc, _, _, test = written_voc
        cfg = dict(type="VOC", data_prefix=voc, ann_file=test,
                   test_mode=True)
    else:
        cfg = dict(type="ImageList", data_prefix=image_list[0],
                   ann_file=image_list[1], classes=["a", "b", "c", "d"])
    ds = tbuilder.build_dataset(cfg)
    assert type(ds) is tbuilder.DATASETS[case]
    assert_same(ds.data_infos, jbuilder.build_dataset(cfg).data_infos)


# ------------------------------------------------- the CLIs and the tools

@pytest.fixture(scope="module")
def voc_run(tmp_path_factory, written_voc):
    """One epoch of the train CLI on the VOC mini config (4 steps at batch
    2, val on the 6 test images), then the test CLI on the epoch's
    checkpoint with --out."""
    voc = written_voc[0]
    root = tmp_path_factory.mktemp("voc_cli")
    cfg = str(root / "voc_mini.py")
    with open(cfg, "w") as f:
        f.write(VOC_MINI_CONFIG.format(base=VOC_CONFIG, voc=voc,
                                       work_dir=str(root / "work")))
    summary = train_cli.main([cfg, "--device", "cpu"])
    out = str(root / "scores.pkl")
    ckpt = str(root / "work" / "checkpoints")
    metrics, scores = test_cli.main([cfg, ckpt, "--device", "cpu", "--out",
                                     out])
    with open(summary["log_json"]) as f:
        records = [json.loads(line) for line in f]
    return dict(root=root, cfg=cfg, ckpt=ckpt, out=out, metrics=metrics,
                scores=scores, records=records, summary=summary)


def test_voc_cli_test_map_equals_the_log(voc_run):
    summary, records = voc_run["summary"], voc_run["records"]
    assert summary["steps"] == 4 and summary["batch"] == 2
    assert [r["mode"] for r in records] == ["train", "train", "val"]
    assert all(np.isfinite(r["loss"]) for r in records[:2])
    scores = voc_run["scores"]
    assert scores.shape == (6, 20) and scores.dtype == np.float32
    with open(voc_run["out"], "rb") as f:
        assert_same(pickle.load(f), scores)
    assert voc_run["metrics"]["mAP"] == records[2]["mAP"]
    assert set(voc_run["metrics"]) == {"mAP", "CP", "CR", "CF1", "OP", "OR",
                                       "OF1"}


def _jax_tool_main(tool, argv, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [tool.__file__, *argv])
    capsys.readouterr()
    tool.main()
    return capsys.readouterr().out


def test_eval_metric_equals_the_jax_tool(voc_run, monkeypatch, capsys):
    want = json.loads(_jax_tool_main(
        load_tool("analysis_tools/eval_metric.py"),
        [voc_run["cfg"], voc_run["out"]], monkeypatch, capsys))
    got = eval_metric.main([voc_run["cfg"], voc_run["out"]])
    assert json.loads(capsys.readouterr().out) == got == want
    assert got == voc_run["metrics"]


def test_analyze_results_equals_the_jax_tool(voc_run, monkeypatch, capsys):
    want_path = str(voc_run["root"] / "jax_analysis.json")
    got_path = str(voc_run["root"] / "analysis.json")
    _jax_tool_main(load_tool("analysis_tools/analyze_results.py"),
                   [voc_run["cfg"], voc_run["out"], "--topk", "3", "--out",
                    want_path], monkeypatch, capsys)
    report = analyze_results.main([voc_run["cfg"], voc_run["out"], "--topk",
                                   "3", "--out", got_path])
    with open(want_path) as f, open(got_path) as g:
        want, got = json.load(f), json.load(g)
    assert got == want == json.loads(json.dumps(report))
    assert len(got["best"]) == len(got["worst"]) == 3
    assert all(set(r["gt"]) <= set(VOC_CLASSES) for r in got["best"])


@pytest.mark.parametrize("how", ["load_params_only", "--load-from"])
def test_an_80_class_checkpoint_into_20_classes_raises(voc_run, how):
    """The port's weights-only loads are strict: an 80-class checkpoint
    into the VOC config's 20-class model raises and names the head's
    keys (the VOC config's comment speaks of a shape filter that neither
    package has)."""
    root = voc_run["root"]
    cfg = train_cli.load_config(voc_run["cfg"], [])
    coco = build_model(dict(cfg.model, n_classes=80))
    ckpt = str(root / f"coco80_{how}")
    save_checkpoint(ckpt, create_train_state(coco, optimizer=None), 0)
    with pytest.raises(RuntimeError, match="size mismatch for head.fc1"):
        if how == "load_params_only":
            load_params_only(ckpt, build_model(cfg.model))
        else:
            train_cli.main([voc_run["cfg"], "--device", "cpu", "--work-dir",
                            str(root / "work_load"), "--load-from", ckpt])
