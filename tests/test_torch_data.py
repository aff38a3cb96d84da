"""The port's host data path and core services against the JAX package's,
on the CPU: the native ops (bitwise their numpy plain versions and the JAX
package's native ops), every pipeline transform and the loader's batches
(bitwise, from the same seeds, in every worker mode), the metrics, the
config files, the lr schedules, ``build_model`` with JAX weights, and the
synthetic-set generator.
"""

import glob
import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gkgnet_tpu import native as jnative
from gkgnet_tpu.core import builder as jbuilder
from gkgnet_tpu.core import config as jconfig
from gkgnet_tpu.core import metrics as jmetrics
from gkgnet_tpu.core import schedules as jschedules
from gkgnet_tpu.data import loader as jloader
from gkgnet_tpu.data import pipelines as jpipelines
from gkgnet_tpu.utils import logging as jlogging
from gkgnet_tpu.utils import tensorboard as jtensorboard
from gkgnet_tpu_torch import native as tnative
from gkgnet_tpu_torch.core import builder as tbuilder
from gkgnet_tpu_torch.core import config as tconfig
from gkgnet_tpu_torch.core import metrics as tmetrics
from gkgnet_tpu_torch.core import schedules as tschedules
from gkgnet_tpu_torch.data import loader as tloader
from gkgnet_tpu_torch.data import pipelines as tpipelines
from gkgnet_tpu_torch.utils import logging as tlogging
from gkgnet_tpu_torch.utils import tensorboard as ttensorboard
from gkgnet_tpu_torch.utils.weights import load_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


def load_tool(relpath):
    """A script of the repository's ``tools/``, loaded from its file."""
    name = "jax_tool_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_same(a, b, path="results"):
    """Bitwise equality of nested results (arrays and tensors with their
    dtypes)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor), \
            path
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _image(seed, shape=(100, 120, 3)):
    """Smooth structure plus noise, so that every op (equalize,
    autocontrast, crops) sees varied content."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 2, yy * 2, (xx + yy)], -1) % 256
    noise = rng.integers(0, 60, shape)
    return ((base + noise) % 256).astype(np.uint8)


# ---------------------------------------------------------------- native ops

def _native_cases(rng):
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    big = rng.integers(0, 256, (300, 290, 3), dtype=np.uint8)
    views = [rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
             for _ in range(4)]
    plan = [(float(rng.beta(0.1, 0.1)), side,
             *(int(p) for p in rng.permutation(3))) for side in (0, 1, 2)]
    return {
        "normalize_u8": [((img, MEAN, STD), {}), ((big, MEAN, STD), {})],
        "collate_normalize": [(([img, img[::-1].copy(), img[:, ::-1].copy()],
                                MEAN, STD), {})],
        "mix_chain": [((views, plan), {}), ((views[:2], plan[1:2]), {})],
        "color_jitter": [((img, [(0, 1.3), (1, 0.7), (2, 1.2)]), {}),
                         ((big, [(2, 0.6), (1, 1.37), (0, 0.8)]), {}),
                         ((big, [(1, 0.0)]), {})],
    }


@pytest.mark.parametrize("op", ["normalize_u8", "collate_normalize",
                                "mix_chain", "color_jitter"])
def test_native_op_bitwise_plain_and_jax(op):
    if jnative.get_fastops() is None:
        pytest.skip("the JAX package's native build is unavailable")
    for args, kw in _native_cases(np.random.default_rng(0))[op]:
        got = getattr(tnative, op)(*args, **kw)
        assert_same(got, getattr(tnative, f"{op}_reference")(*args, **kw), op)
        assert_same(got, getattr(jnative, op)(*args, **kw), op)


def test_native_build_is_cached_and_rejects_bad_input():
    lib = tnative.lib()
    assert tnative.lib() is lib and tnative.build_seconds is not None
    assert os.path.basename(tnative._lib_path()).startswith("fastops-")
    with pytest.raises(ValueError):
        tnative.normalize_u8(np.zeros((4, 4, 3), np.float32), MEAN, STD)
    with pytest.raises(ValueError):
        tnative.normalize_u8(np.zeros((4, 4, 4), np.uint8), MEAN, STD)
    with pytest.raises(ValueError):
        tnative.collate_normalize([np.zeros((4, 4, 3), np.uint8),
                                   np.zeros((3, 4, 3), np.uint8)], MEAN, STD)
    with pytest.raises(ValueError):
        tnative.mix_chain([np.zeros((4, 4, 3), np.uint8)] * 2, [])
    with pytest.raises(ValueError):
        tnative.color_jitter(np.zeros((4, 4, 3), np.uint8), [(3, 1.0)])


# ------------------------------------------------------------ the transforms

EIGVAL = [55.46, 4.794, 1.148]
EIGVEC = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
          [-0.5836, -0.6948, 0.4203]]
TRANSFORMS = {
    "LoadImageFromFile": dict(type="LoadImageFromFile"),
    "Resize": dict(type="Resize", size=64, interpolation="bicubic"),
    "Resize_adaptive": dict(type="Resize", size=(72, -1)),
    "CenterCrop": dict(type="CenterCrop", crop_size=48),
    "RandomResizedCrop": dict(type="RandomResizedCrop", size=56),
    "RandomFlip": dict(type="RandomFlip", flip_prob=0.5),
    "Normalize": dict(type="Normalize", mean=MEAN, std=STD),
    "Normalize_device": dict(type="Normalize", mean=MEAN, std=STD,
                             device=True),
    "ColorJitter": dict(type="ColorJitter", brightness=0.4, contrast=0.4,
                        saturation=0.4),
    "RandomErasing": dict(type="RandomErasing", erase_prob=0.5, mode="rand",
                          min_area_ratio=0.02, max_area_ratio=1 / 3,
                          fill_color=MEAN, fill_std=STD),
    "RandomErasing_const": dict(type="RandomErasing", erase_prob=1.0),
    "Trivial": dict(type="Trivial", p=1.0),
    "RandAug": dict(type="RandAug", n=2, m=10),
    "AutoAug": dict(type="AutoAug"),
    "UniAug": dict(type="UniAug"),
    "UniAugWeighted": dict(type="UniAugWeighted"),
    "Cutout": dict(type="Cutout", p=1.0),
    "CropMixup": dict(type="CropMixup", p=0.75, size=64, scale=0.01,
                      number=234),
    "CropMixup_cutmix": dict(type="CropMixup", p=1.0, size=48, number=3,
                             operation=1),
    "CropMixup_plain": dict(type="CropMixup", p=1.0, size=48, number=2,
                            inter_aug=0),
    "Pad": dict(type="Pad", size=(140, 130)),
    "Pad_square": dict(type="Pad", pad_to_square=True, pad_val=7),
    "Lighting": dict(type="Lighting", eigval=EIGVAL, eigvec=EIGVEC),
    "Collect": dict(type="Collect", keys=("img", "gt_label")),
    "ToTensor": dict(type="ToTensor", keys=("img",)),
}


def test_transform_table_covers_the_jax_package():
    kinds = {cfg["type"] for cfg in TRANSFORMS.values()}
    assert kinds >= set(jpipelines.TRANSFORMS)
    assert set(tpipelines.TRANSFORMS) == set(jpipelines.TRANSFORMS)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_bitwise_jax(name, tmp_path):
    cfg = TRANSFORMS[name]
    ours = tpipelines.build_pipeline([cfg])
    theirs = jpipelines.build_pipeline([cfg])
    for seed in range(6):
        img = _image(seed)
        results = {"img": img, "gt_label": np.eye(80, dtype=np.int8)[seed]}
        if cfg["type"] == "LoadImageFromFile":
            Image.fromarray(img).save(tmp_path / f"{seed}.jpg")
            results = {"img_prefix": str(tmp_path),
                       "img_info": {"filename": f"{seed}.jpg"}}
        got = ours({k: v for k, v in results.items()},
                   np.random.default_rng((seed, 1)))
        want = theirs({k: v for k, v in results.items()},
                      np.random.default_rng((seed, 1)))
        assert_same(got, want, f"{name} seed {seed}")


# ---------------------------------------------------------------- the loader

def _mini_set(root, n=8):
    """The CLI tests' mini workspace: n JPEGs of varied sizes and their
    annotation pickle."""
    img_dir = root / "imgs"
    img_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    records = []
    for i in range(n):
        name = f"im_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (100 + 8 * i, 120, 3),
                                     dtype=np.uint8)).save(img_dir / name)
        objects = (rng.random(80) < 0.08).astype(np.int8)
        objects[i % 80] = 1
        records.append({"objects": objects, "file_name": name})
    ann = root / "mini.data"
    with open(ann, "wb") as f:
        pickle.dump(records, f)
    return str(img_dir), str(ann)


@pytest.fixture(scope="module")
def mini_set(tmp_path_factory):
    return _mini_set(tmp_path_factory.mktemp("loader"))


LONG = os.path.join(REPO, "configs", "gkgnet_synthetic_576_long.py")


def _split_cfg(split, img_dir, ann):
    cfg = tconfig.Config.fromfile(LONG)
    cfg.merge_from_options({
        f"data.{split}{'.dataset' if split == 'train' else ''}.{k}": v
        for k, v in (("data_prefix", img_dir), ("ann_file", ann))})
    return cfg.data[split]


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("mode,workers", [("threads", 0), ("threads", 2),
                                          ("processes", 2)])
def test_loader_batches_bitwise_jax(mini_set, split, mode, workers):
    """The long synthetic config's train pipeline (CropMixup, RandomErasing,
    ColorJitter, Trivial, Normalize(device=True): uint8 batches) and its
    test pipeline, through its dataset wrappers, over two epochs."""
    split_cfg = _split_cfg(split, *mini_set)
    shuffle = split == "train"
    out = []
    for builder, loader_mod in ((tbuilder, tloader), (jbuilder, jloader)):
        ds = builder.build_dataset(split_cfg)
        loader = loader_mod.build_dataloader(
            ds, 2, workers, shuffle=shuffle, seed=5, drop_last=shuffle,
            mode=mode)
        batches = []
        try:
            for epoch in range(2):
                loader.set_epoch(epoch)
                batches += list(loader)
        finally:
            loader.close()
        out.append(batches)
    ours, theirs = out
    assert len(ours) == len(theirs) >= 8
    want_dtype = np.uint8 if split == "train" else np.float32
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a["img"].dtype == want_dtype and a["img"].shape[1:] == \
            (576, 576, 3)
        assert_same(a, b, f"batch {i}")


def test_device_normalize_of_uint8_batches_equals_jax(mini_set):
    """The train CLI's ``device_batches`` on a ``Normalize(device=True)``
    pipeline: uint8 batches normalized on the device (here the CPU),
    bitwise the JAX trainer's ``make_device_normalize`` of the same batch."""
    from gkgnet_tpu.core import trainer as jtrainer
    from gkgnet_tpu_torch.tools import train as train_cli

    split_cfg = _split_cfg("train", *mini_set)
    loader = tloader.build_dataloader(tbuilder.build_dataset(split_cfg), 2, 0,
                                      shuffle=True, seed=5, drop_last=True)
    raw = next(iter(loader))
    got = next(train_cli.device_batches(loader, "cpu", split_cfg))
    jax_norm = jtrainer.make_device_normalize(jtrainer.pipeline_device_norm(
        split_cfg["dataset"]["pipeline"]))
    assert raw["img"].dtype == np.uint8 and got["img"].dtype == torch.float32
    assert_same(got["img"].numpy(), np.asarray(jax_norm(raw["img"])))
    assert_same(got["gt_label"].numpy(), raw["gt_label"])


# --------------------------------------------------------------- the metrics

@pytest.mark.parametrize("fn", ["coco_metrics", "mAP_coco", "mAP_mmcls",
                                "average_performance", "mAP_area"])
def test_metrics_equal_jax(fn):
    rng = np.random.default_rng(3)
    target = (rng.random((40, 12)) < 0.3).astype(np.int8)
    target[rng.random((40, 12)) < 0.05] = -1 if fn == "mAP_mmcls" else 0
    pred = rng.random((40, 12)).astype(np.float32)
    pred[:5] = pred[5:10]                                  # ties
    args = {"coco_metrics": (target.clip(0), pred),
            "mAP_coco": (target.clip(0), pred),
            "mAP_mmcls": (pred, target),
            "average_performance": (pred, target.clip(0)),
            "mAP_area": (target.clip(0), pred,
                         rng.integers(0, 20000, (40, 12)))}[fn]
    got = getattr(tmetrics, fn)(*args)
    want = getattr(jmetrics, fn)(*args)
    assert_same(jax.tree.map(np.asarray, got) if fn == "mAP_coco" else got,
                jax.tree.map(np.asarray, want) if fn == "mAP_coco" else want)
    if fn == "average_performance":
        assert_same(getattr(tmetrics, fn)(*args, k=3),
                    getattr(jmetrics, fn)(*args, k=3))


# ----------------------------------------------------- configs and schedules

@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "configs", "*.py"))), ids=os.path.basename)
def test_config_fromfile_equals_jax(path):
    got = tconfig.Config.fromfile(path)
    want = jconfig.Config.fromfile(path)
    if os.path.basename(path) == "gkgnet_voc_448.py":
        # the port's Config replaces a base dict of another type: the VOC
        # train set does not keep the COCO base's ClassBalancedDataset keys
        # (the JAX merge keeps them; see gkgnet_tpu_torch/core/config.py)
        stray = {"oversample_thr", "dataset"}
        assert set(want["data"]["train"]) - set(got["data"]["train"]) \
            == stray
        for key in stray:
            del want["data"]["train"][key]
    assert got == want
    opts = {"data.train.dataset.data_prefix": "x", "runner.max_epochs": 3,
            "new.key": [1, 2]}
    got.merge_from_options(opts)
    want.merge_from_options(opts)
    assert got == want
    assert got.pretty_text() == want.pretty_text()
    for value in ("[('train', 1), ('val', 1)]", "1e-4", "None", "abc"):
        assert tconfig.parse_cfg_option(value) == \
            jconfig.parse_cfg_option(value)


@pytest.mark.parametrize("policy", ["step", "cosine"])
def test_lr_schedule_equals_jax(policy):
    """Every step of a 12-epoch run at 7 steps per epoch, warmup by epoch.
    The JAX schedule evaluates in float32 (an int32 step, as its trainer
    passes it), where the warmup factor 1 - (1 - t)(1 - ratio) and the
    cosine lose up to a few float32 ulps of 1.0; the port's in float64. So
    they agree within base_lr x 2**-21 (4 ulps of 1.0, scaled by the
    rate)."""
    cfg = dict(policy=policy, base_lr=4e-4, step=[5, 9], gamma=0.1,
               warmup="linear", warmup_ratio=1e-3, warmup_iters=3,
               warmup_by_epoch=True, total_steps=84, cool_down_time=10,
               cool_down_ratio=0.1, min_lr_ratio=0.01)
    ours = tschedules.build_lr_schedule(cfg, 7)
    theirs = jax.jit(jschedules.build_lr_schedule(cfg, 7))
    for step in range(84):
        want = np.float32(theirs(jnp.int32(step)))
        got = np.float32(ours(step))
        assert abs(float(got) - float(want)) <= cfg["base_lr"] * 2.0**-21, \
            (step, got, want)


# -------------------------------------------------------------- build_model

MINI_MODEL = dict(arch="t", k=3, k_label_gcn=3, num_group=2, drop_path=0.1,
                  n_classes=80, size=128, num_gcn=1, dtype="float32",
                  head=dict(gamma_pos=0.5, gamma_neg=3.0, clip=0.1,
                            asy_loss_scale=4.0, label_smooth_val=0.2))


def _random_variables(module, *args):
    """Random fp32 variables for ``module.init(key, *args)``, by shape only,
    scaled so that activations stay O(1) (at the seeded init with unit
    running statistics they reach 1e4 at this size)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))
    rng = np.random.default_rng(8)

    def leaf(path, s):
        name = path[-1].key
        if name in ("kernel", "fc1_kernel"):
            fan_in = int(np.prod(s.shape[:-1])) if name == "kernel" \
                else s.shape[-1]
            return rng.standard_normal(s.shape) * np.sqrt(1.0 / fan_in)
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        if name == "embedding":
            return rng.standard_normal(s.shape)
        return 0.1 * rng.standard_normal(s.shape)

    return {c: jax.tree_util.tree_map_with_path(
        lambda p, s: leaf(p, s).astype(np.float32), shapes[c])
        for c in ("params", "batch_stats")}


def test_build_model_with_jax_weights_gives_jax_logits():
    """build_model of one model config in both packages, the JAX init
    carried into the port by utils/weights.py: the logits agree at the
    parity tests' tolerance, and the head's loss settings (``model.head``)
    give the JAX losses."""
    jm = jbuilder.build_model(MINI_MODEL)
    tm = tbuilder.build_model(MINI_MODEL)
    x = np.random.default_rng(4).standard_normal((2, 128, 128, 3)).astype(
        np.float32)
    variables = _random_variables(jm, jnp.asarray(x), False)
    load_jax_variables(tm, variables)
    (ref, _), _ = jax.jit(
        lambda v, x: jm.apply(v, x, False, mutable=["constants"]))(
            variables, jnp.asarray(x))
    with torch.no_grad():
        got, _ = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    gt = (np.random.default_rng(5).random((2, 80)) < 0.1).astype(np.float32)
    want = jm.build_loss_head().loss(ref, jnp.asarray(gt))
    have = tm.loss(torch.from_numpy(np.array(ref)), torch.from_numpy(gt))
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(float(have[k]), float(want[k]), rtol=1e-5)


@pytest.mark.parametrize("case", ["neck", "augments", "perturbed"])
def test_builder_raises_for_what_is_not_ported(case):
    extra = {"neck": dict(neck=dict(type="GAP")),
             "augments": dict(train_cfg=dict(augments=[
                 dict(type="BatchMixup", alpha=0.2)])),
             "perturbed": dict(graph_builder="perturbed")}
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        tbuilder.build_model(dict(MINI_MODEL, **extra[case]))


# ------------------------------------------------------- logs and the tools

def test_json_log_and_tensorboard_match_jax(tmp_path):
    path = tmp_path / "run.log.json"
    writer = tlogging.JsonLogWriter(str(path))
    writer.write("train", 1, 20, {"loss": np.float32(1.5), "lr": 1e-4})
    writer.write("val", 1, 20, {"mAP": 12.5, "mAP_ema": 13.0})
    assert tlogging.load_json_log(str(path)) == \
        jlogging.load_json_log(str(path))
    meter = tlogging.ScalarMeter()
    jmeter = jlogging.ScalarMeter()
    for v in (1.0, 2.0, 4.0):
        meter.update({"a": v})
        jmeter.update({"a": v})
    assert meter.average(2) == jmeter.average(2)
    event = ttensorboard._scalar_event("train/loss", 1.25, 7, 1234.5)
    assert event == jtensorboard._scalar_event("train/loss", 1.25, 7, 1234.5)
    assert ttensorboard._masked_crc(event) == jtensorboard._masked_crc(event)


def test_make_synthetic_coco_writes_the_jax_tools_files(tmp_path):
    from gkgnet_tpu_torch.tools import make_synthetic_coco as tsyn
    jsyn = load_tool("make_synthetic_coco.py")

    for c in range(80):
        assert tsyn.class_style(c) == jsyn.class_style(c)
    for name, mod in (("port", tsyn), ("jax", jsyn)):
        assert mod.make_split(str(tmp_path / name), str(tmp_path /
                                                          f"{name}.data"),
                              5, 1) == 5
    with open(tmp_path / "port.data", "rb") as f:
        ours = pickle.load(f)
    with open(tmp_path / "jax.data", "rb") as f:
        theirs = pickle.load(f)
    assert_same(ours, theirs)
    for rec in ours:
        a = (tmp_path / "port" / rec["file_name"]).read_bytes()
        b = (tmp_path / "jax" / rec["file_name"]).read_bytes()
        assert a == b, rec["file_name"]
