"""The port's tools on the CPU against the JAX package's: get_flops'
parameters and analytic FLOPs, ``model_edge_count`` (against the JAX
function, and against the edges the port's model builds), the executed
FLOPs of ``FlopCounterMode`` with the kernel operators' formulas, a trace
and ``timeit``, vis_edges and vis_cam on weights converted from the JAX
init (``utils/weights.py``), vis_lr, vis_pipeline, print_config,
verify_dataset on COCO, VOC and ImageList, build_coco_pickle, and the
reference-checkpoint import (``tools.convert_models.from_reference``)
against the JAX converter plus ``load_jax_variables``; that every tool
runs as ``python -m`` and that the tools which run a model need a card
unless ``--device cpu`` is given. The JAX tools run in this process.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import write_vocdevkit
from gkgnet_tpu.core.builder import build_model as jax_build_model
from gkgnet_tpu.core.config import Config as JaxConfig
from gkgnet_tpu.data.pipelines import build_pipeline as jax_build_pipeline
from gkgnet_tpu.nn.classifier import GKGNetClassifier as JaxClassifier
from gkgnet_tpu.utils import profiling as jprofiling
from gkgnet_tpu.utils.torch_convert import (convert_reference_checkpoint,
                                            expected_torch_shapes)
from gkgnet_tpu_torch.core.builder import build_model
from gkgnet_tpu_torch.core.checkpoint import (load_params_only,
                                              restore_checkpoint,
                                              save_checkpoint)
from gkgnet_tpu_torch.core.optim import build_optimizer
from gkgnet_tpu_torch.core.trainer import create_train_state
from gkgnet_tpu_torch.data.voc import VOC_CLASSES
from gkgnet_tpu_torch.nn import grapher
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier, init_parameters
from gkgnet_tpu_torch.ops import knn_mr
from gkgnet_tpu_torch.tools import inference
from gkgnet_tpu_torch.tools.analysis_tools import get_flops
from gkgnet_tpu_torch.tools.convert_data import build_coco_pickle
from gkgnet_tpu_torch.tools.convert_models import from_reference
from gkgnet_tpu_torch.tools.misc import print_config, verify_dataset
from gkgnet_tpu_torch.tools.visualizations import (vis_cam, vis_edges,
                                                   vis_lr, vis_pipeline)
from gkgnet_tpu_torch.utils import profiling
from gkgnet_tpu_torch.utils.weights import load_jax_variables
from test_cli import MINI_CONFIG as CLI_MINI_CONFIG
from test_torch_data import _mini_set, assert_same, load_tool
from test_torch_hooks import jax_init_state
from test_torch_voc import VOC_MINI_CONFIG, _jpegs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_CONFIG = os.path.join(REPO, "configs", "gkgnet_voc_448.py")
SYNTHETIC = os.path.join(REPO, "configs", "gkgnet_synthetic_576.py")
# scores of the eager forward in both frameworks on the same weights and
# image, fp32 (tests/test_torch_deploy.py's bound)
SCORE_ATOL = 1e-5
# vis_cam's saliency (scaled to a maximum of 1) against the JAX tool's: the
# train step's gradient bound (tests/test_torch_train.py, 1e-2 of the
# scale). The saliency is as sensitive to rounding as the train step's
# gradients: at this fixture's image the gap to JAX is 2.1e-3, and moving
# the image by one ulp moves the port's own saliency by 3.5e-3 (both
# printed by test_vis_cam_runs_the_plain_backward).
SALIENCY_ATOL = 1e-2
TOOLS = ["analysis_tools.eval_metric", "analysis_tools.analyze_results",
         "analysis_tools.analyze_logs", "analysis_tools.get_flops",
         "visualizations.vis_edges", "visualizations.vis_cam",
         "visualizations.vis_lr", "visualizations.vis_pipeline",
         "misc.print_config", "misc.verify_dataset",
         "convert_data.build_coco_pickle", "convert_models.from_reference"]
# the reference-import checkpoint's model (tests/test_convert.py's SMALL)
SMALL = dict(arch="t", k=3, k_label_gcn=3, n_classes=10, size=128)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_tool_main(relpath, argv, monkeypatch):
    tool = load_tool(relpath)
    monkeypatch.setattr("sys.argv", [tool.__file__, *argv])
    return tool.main()


# ------------------------------------------------- counters and profiling

@pytest.mark.parametrize("arch,size", [("t", 448), ("s", 576), ("b", 448)])
def test_get_flops_equals_jax(arch, size, capsys):
    """The JAX tool's parameter count (one JAX trace of the model each, so
    one size per arch) and the analytic FLOPs at 448 and 576."""
    got = get_flops.main(["--arch", arch, "--shape", str(size), str(size)])
    jax_tool = load_tool("analysis_tools/get_flops.py")
    assert got["params"] == jax_tool.count_params(arch, size)
    out = capsys.readouterr().out
    assert f"Params: {got['params'] / 1e6:.2f} M" in out
    assert "executed" not in got
    for other in (448, 576):
        got = get_flops.main(["--arch", arch, "--shape", str(other)])
        assert got["flops"] == jprofiling.model_flops(arch, other, 1)


@pytest.mark.parametrize("arch", ["t", "s"])
def test_model_edge_count_equals_jax(arch):
    for kwargs in (dict(size=448, batch=16, n_classes=20),
                   dict(size=576, batch=8, k=9, num_gcn=2)):
        assert profiling.model_edge_count(arch, **kwargs) == \
            jprofiling.model_edge_count(arch, **kwargs)


@pytest.mark.parametrize("arch", ["t", "s", "b"])
def test_model_edge_count_equals_the_edges_built(arch, monkeypatch):
    """The edges of one forward, summed over the kernel's calls (BG * N * k
    per call): arch b's 18 stage-3 blocks count too (the JAX function
    counts 6 for every arch)."""
    calls = []
    op = grapher.knn_mr_fused

    def recording(*args):
        idx, mr = op(*args)
        calls.append(idx.numel())
        return idx, mr

    monkeypatch.setattr(grapher, "knn_mr_fused", recording)
    kw = dict(k=2, k_label_gcn=3, n_classes=5, size=128, num_gcn=2)
    model = GKGNetClassifier(arch=arch, **kw).eval()
    with torch.no_grad():
        model(torch.randn((2, 128, 128, 3),
                          generator=torch.Generator().manual_seed(0)))
    want = profiling.model_edge_count(arch, 128, 2, k=2, k_label=3,
                                      n_classes=5, num_gcn=2)
    assert sum(calls) == want
    blocks = {"t": 12, "s": 12, "b": 24}[arch]
    assert len(calls) == blocks + 3 + 2          # + label GCNs
    jax_count = jprofiling.model_edge_count(arch, 128, 2, k=2, k_label=3,
                                            n_classes=5, num_gcn=2)
    assert (jax_count == want) == (arch != "b")


def test_executed_flops_equal_the_analytic_count(tmp_path, capsys):
    """FlopCounterMode over one forward on the CPU, the kernel operator's
    formula counting its distance products: at t@128 the count equals the
    analytic one exactly."""
    cfg = tmp_path / "t128.py"
    cfg.write_text(f"_base_ = [{VOC_CONFIG!r}]\n"
                   "model = dict(arch='t', k=3, k_label_gcn=3, size=128, "
                   "dtype='float32')\n")
    got = get_flops.main([str(cfg), "--verify", "--device", "cpu"])
    assert got["executed"] == got["flops"]["per_image_total"]
    assert "ratio 1.000" in capsys.readouterr().out


def test_trace_and_timeit_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    with open(tmp_path / "trace" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()
    assert profiling.timeit(torch.matmul, x, x, iters=3) > 0


# ------------------------------------------------------- visualizations

@pytest.fixture(scope="module")
def voc_ws(tmp_path_factory):
    """A VOC mini workspace: 6 trainval and 4 test images, the VOC mini
    config, the JAX model's init state and that state saved as a port
    checkpoint."""
    root = tmp_path_factory.mktemp("tools_voc")
    voc, _ = write_vocdevkit(str(root), {
        "trainval": _jpegs(root / "src_train", 6, 2, (70, 90, 3)),
        "test": _jpegs(root / "src_test", 4, 3, (70, 90, 3))}, seed=1)
    cfg = str(root / "voc_mini.py")
    with open(cfg, "w") as f:
        f.write(VOC_MINI_CONFIG.format(base=VOC_CONFIG, voc=voc,
                                       work_dir=str(root / "work")))
    jcfg = JaxConfig.fromfile(cfg)
    jmodel = jax_build_model(jcfg.model)
    jstate = jax_init_state(jmodel, 128)
    model = build_model(jcfg.model)
    load_jax_variables(model, {"params": jstate.params,
                               "batch_stats": jstate.batch_stats})
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, create_train_state(model, optimizer=None), 1)
    img = os.path.join(voc, "JPEGImages", "test_000001.jpg")
    return dict(root=root, voc=voc, cfg=cfg, jcfg=jcfg, jmodel=jmodel,
                jstate=jstate, ckpt=ckpt, img=img)


def _jax_test_image(ws):
    pipeline = jax_build_pipeline(ws["jcfg"].data["test"]["pipeline"])
    return jnp.asarray(pipeline({"img_prefix": "", "img_info": {
        "filename": ws["img"]}}, np.random.default_rng(0))["img"][None])


def _jax_variables(ws):
    return {"params": ws["jstate"].params,
            "batch_stats": ws["jstate"].batch_stats,
            "constants": ws["jstate"].constants}


def test_vis_edges_equals_jax(voc_ws):
    """The scores, the top-3 classes and the last label GCN's edges of the
    JAX tool's forward (the same weights and image), and the VOC class
    names (the JAX tool draws COCO's)."""
    cls_score, edges = jax.jit(lambda v, x: voc_ws["jmodel"].apply(
        v, x, train=False))(_jax_variables(voc_ws), _jax_test_image(voc_ws))
    want_scores = np.asarray(jax.nn.sigmoid(cls_score))[0]
    out = str(voc_ws["root"] / "edges.png")
    got = vis_edges.main([voc_ws["img"], voc_ws["cfg"], voc_ws["ckpt"],
                          "--device", "cpu", "--out", out])
    np.testing.assert_allclose(got["scores"], want_scores, rtol=0,
                               atol=SCORE_ATOL)
    assert got["class_ids"] == [int(c) for c in
                                np.argsort(-want_scores)[:3]]
    assert got["edges"].shape == (2, 20, 3)
    np.testing.assert_array_equal(got["edges"], np.asarray(edges))
    assert got["names"] == VOC_CLASSES
    with Image.open(out) as im:
        assert im.size == (128, 128)


def test_vis_cam_runs_the_plain_backward(voc_ws, monkeypatch):
    """One eval-mode forward and backward on the CPU (the operator's plain
    backward): the activation map equals the JAX tool's capture of the
    last FFN; the saliency is the JAX tool's ``jax.grad`` saliency within
    SALIENCY_ATOL, and bitwise the gradient that autograd takes through
    the plain forward (knn_mr_reference in place of the operator)."""
    out = str(voc_ws["root"] / "cam.png")
    got = vis_cam.main([voc_ws["img"], voc_ws["cfg"], voc_ws["ckpt"],
                        "--device", "cpu", "--out", out])

    def top_logit(v, x):  # the JAX tool's forward and its class's logit
        (score, _), inter = voc_ws["jmodel"].apply(
            v, x, train=False,
            capture_intermediates=lambda mdl, _: mdl.name == "backbone_14_ffn",
            mutable=["intermediates"])
        top = score[0, jnp.argmax(score[0])]
        return top, (score, jax.tree.leaves(inter["intermediates"])[0])

    (_, (score, feat)), grad = jax.jit(jax.value_and_grad(
        top_logit, argnums=1, has_aux=True))(_jax_variables(voc_ws),
                                             _jax_test_image(voc_ws))
    assert got["class"] == int(jnp.argmax(score[0]))
    cam = np.maximum(np.asarray(feat)[0], 0).mean(-1)
    np.testing.assert_allclose(got["cam"], cam / (cam.max() + 1e-8),
                               rtol=0, atol=1e-5)
    sal = got["saliency"]
    assert sal.shape == (128, 128) and sal.max() == pytest.approx(1.0)
    assert np.isfinite(sal).all() and (sal > 0).mean() > 0.5
    want = np.asarray(jnp.abs(grad)[0].max(-1))
    gap = np.abs(sal - want / (want.max() + 1e-8))
    model, cfg = inference.init_model(voc_ws["cfg"], voc_ws["ckpt"], "cpu")
    imgs = inference.image_batch(model, cfg, voc_ws["img"])
    _, _, moved = vis_cam.cam_and_saliency(
        model, torch.nextafter(imgs, torch.full_like(imgs, np.inf)),
        got["class"])
    print(f"vis_cam saliency against JAX: max |diff| {gap.max():.3g}, "
          f"{(gap <= 1e-3).mean():.4f} of the pixels within 1e-3; the image "
          f"moved by one ulp: max |diff| {np.abs(sal - moved).max():.3g}")
    assert gap.max() <= SALIENCY_ATOL
    monkeypatch.setattr(grapher, "knn_mr_fused", knn_mr.knn_mr_reference)
    _, _, plain = vis_cam.cam_and_saliency(model, imgs, got["class"])
    np.testing.assert_array_equal(sal, plain)
    with Image.open(out) as im:
        assert im.size == (128, 128)


def test_vis_lr_equals_jax(tmp_path, monkeypatch):
    import matplotlib.pyplot as plt

    plotted = []
    monkeypatch.setattr(plt, "plot", lambda x, y: plotted.append((x, y)))
    _jax_tool_main("visualizations/vis_lr.py", [
        VOC_CONFIG, "--steps-per-epoch", "20", "--out",
        str(tmp_path / "jax.png")], monkeypatch)
    xs, ys = vis_lr.main([VOC_CONFIG, "--steps-per-epoch", "20", "--out",
                          str(tmp_path / "port.png")])
    (jx, jy), (px, py) = plotted
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(xs / 20, jx)
    # the JAX schedule is float32 (tests/test_torch_data.py's bound)
    np.testing.assert_allclose(py, jy, rtol=0, atol=5e-5 * 2.0 ** -21)
    assert ys == py and len(ys) == 800


def test_vis_pipeline_equals_jax(voc_ws, tmp_path, monkeypatch):
    """The train pipeline's samples (without Normalize): on the COCO mini
    config the grid saved by both tools pixel-equal; on the VOC mini
    config (whose train set the JAX package does not build) the port's."""
    img_dir, ann = _mini_set(tmp_path)
    cfg = tmp_path / "coco_mini.py"
    cfg.write_text(CLI_MINI_CONFIG.format(work_dir=str(tmp_path / "work"),
                                          img_dir=img_dir, ann=ann))
    _jax_tool_main("visualizations/vis_pipeline.py", [
        str(cfg), "--number", "6", "--out", str(tmp_path / "jax.png")],
        monkeypatch)
    grid = vis_pipeline.main([str(cfg), "--number", "6", "--out",
                              str(tmp_path / "port.png")])
    with Image.open(tmp_path / "jax.png") as a, \
            Image.open(tmp_path / "port.png") as b:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(b), grid)
    assert grid.shape == (2 * 128, 4 * 128, 3)
    voc = vis_pipeline.main([voc_ws["cfg"], "--number", "5", "--out",
                             str(tmp_path / "voc.png")])
    assert voc.shape == (2 * 128, 4 * 128, 3) and voc.any()


# ------------------------------------------------------------ misc tools

def test_print_config_equals_jax(monkeypatch, capsys):
    _jax_tool_main("misc/print_config.py", [SYNTHETIC], monkeypatch)
    want = capsys.readouterr().out
    text = print_config.main([SYNTHETIC])
    assert capsys.readouterr().out == want == text + "\n"
    voc = json.loads(print_config.main([VOC_CONFIG, "--cfg-options",
                                        "data.workers=2"]))
    assert voc["data"]["workers"] == 2 and voc["model"]["n_classes"] == 20


@pytest.fixture(scope="module")
def datasets(tmp_path_factory, voc_ws):
    """A config for each dataset type: VOC (the VOC mini workspace), COCO
    under a ClassBalancedDataset wrapper, and an ImageList with one
    corrupt file."""
    root = tmp_path_factory.mktemp("verify")
    img_dir, ann = _mini_set(root)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)
                        ).save(root / f"l_{i}.jpg")
        lines.append(f"l_{i}.jpg {i % 2}")
    (root / "broken.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    (root / "list_bad.txt").write_text("\n".join(lines + ["broken.jpg 1"]))
    cfgs = {}
    for name, train in (
            ("VOC", None),
            ("COCO", dict(type="ClassBalancedDataset", oversample_thr=0.01,
                          dataset=dict(type="COCO", data_prefix=img_dir,
                                       ann_file=ann))),
            ("ImageList", dict(type="ImageList", data_prefix=str(root),
                               ann_file=str(root / "list.txt"))),
            ("ImageList_bad", dict(type="ImageList", data_prefix=str(root),
                                   ann_file=str(root / "list_bad.txt")))):
        if train is None:
            cfgs[name] = voc_ws["cfg"]
            continue
        path = root / f"{name}.py"
        path.write_text(f"data = dict(train={train!r})\n")
        cfgs[name] = str(path)
    return root, cfgs


@pytest.mark.parametrize("case,n,bad", [("VOC", 6, 0), ("COCO", 8, 0),
                                        ("ImageList", 5, 0),
                                        ("ImageList_bad", 6, 1)])
def test_verify_dataset(datasets, case, n, bad, capsys):
    root, cfgs = datasets
    out = str(root / f"broken_{case}.txt")
    broken = verify_dataset.main([cfgs[case], "--workers", "4", "--out",
                                  out])
    assert len(broken) == bad
    if bad:
        assert broken[0].startswith(str(root / "broken.jpg"))
        with open(out) as f:
            assert f.read() == broken[0]
    else:
        assert f"all {n} images decodable" in capsys.readouterr().out


@pytest.mark.parametrize("with_area", [False, True])
def test_build_coco_pickle_equals_jax(tmp_path, with_area, monkeypatch):
    coco = {"categories": [{"id": i} for i in (1, 2, 5, 9)],
            "images": [{"id": 10 + i, "file_name": f"im_{i}.jpg"}
                       for i in range(4)],
            "annotations": [
                {"image_id": 10, "category_id": 5, "area": 30.0},
                {"image_id": 10, "category_id": 5, "area": 50.0},
                {"image_id": 12, "category_id": 1, "area": 7.5},
                {"image_id": 12, "category_id": 9},
                {"image_id": 13, "category_id": 2, "area": 1.0}]}
    src = tmp_path / "instances.json"
    src.write_text(json.dumps(coco))
    flag = ["--with-area"] if with_area else []
    _jax_tool_main("convert_data/build_coco_pickle.py",
                   [str(src), str(tmp_path / "jax.data"), *flag],
                   monkeypatch)
    records = build_coco_pickle.main([str(src), str(tmp_path / "port.data"),
                                      *flag])
    with open(tmp_path / "jax.data", "rb") as f, \
            open(tmp_path / "port.data", "rb") as g:
        want, got = pickle.load(f), pickle.load(g)
    assert_same(got, want)
    assert_same(records, want)
    assert records[0]["objects"].tolist() == [0, 0, 1, 0]


# ------------------------------------------------------ reference import

@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A synthetic reference checkpoint of SMALL, written as
    tests/test_convert.py writes one (every key the JAX converter reads,
    in torch layout), plus the reference's buffers the port recomputes
    and an ImageNet head; the JAX init variables; the SMALL config."""
    root = tmp_path_factory.mktemp("reference")
    jmodel = JaxClassifier(**SMALL)
    variables = jax.device_get(jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)),
        train=False))())
    g = torch.Generator().manual_seed(0)
    sd = {}
    for key, shp in expected_torch_shapes(variables).items():
        if "running_var" in key or key.endswith("norm.weight"):
            sd[key] = torch.rand(shp, generator=g) * 0.5 + 0.75
        else:
            sd[key] = torch.randn(shp, generator=g) * 0.05
    extra = {"backbone.backbone.0.0.relative_pos": torch.zeros(1, 5, 5),
             "backbone.stem.convs.1.num_batches_tracked": torch.tensor(7),
             "backbone.label_input": torch.zeros(10),
             "prediction.weight": torch.zeros(3, 4)}
    cfg = root / "small.py"
    cfg.write_text(f"model = {SMALL!r}\n")
    return dict(root=root, variables=variables, sd=sd, extra=extra,
                cfg=str(cfg))


def _container(path, state_dict):
    torch.save({"state_dict": {"module." + k: v
                               for k, v in state_dict.items()},
                "meta": {"epoch": 80, "iter": 123456,
                         "CLASSES": [f"c{i}" for i in range(10)]}},
               str(path))


def test_reference_import_equals_the_jax_converter(reference):
    """The reference container through the port's converter gives, bitwise,
    the JAX converter's variables loaded with load_jax_variables; the test
    CLI's loader reads the result."""
    root = reference["root"]
    pth = root / "full.pth.tar"
    _container(pth, {**reference["sd"], **reference["extra"]})
    out = str(root / "imported")
    res = from_reference.main([str(pth), reference["cfg"], out])
    assert res["out"] == os.path.join(out, "0")
    got = GKGNetClassifier(**SMALL)
    load_params_only(out, got)
    want = GKGNetClassifier(**SMALL)
    load_jax_variables(want, convert_reference_checkpoint(
        reference["sd"], reference["variables"]))
    assert_same(got.state_dict(), want.state_dict())
    # weights only: a resume from it is refused
    state = create_train_state(got, build_optimizer(got, 1e-3))
    with pytest.raises(ValueError, match="holds weights only"):
        restore_checkpoint(out, state)


def test_partial_import_reports_as_the_jax_converter(reference):
    """A backbone-only checkpoint with --prefix backbone. and --partial:
    the loaded, missing, mismatched and unused keys of the JAX converter's
    report, the loaded tensors bitwise its values and the rest at the
    seeded init."""
    root = reference["root"]
    sd = {k.removeprefix("backbone."): v for k, v in reference["sd"].items()
          if k.startswith("backbone.")}
    sd["pos_embed"] = torch.zeros(1, 48, 3, 3)          # mis-shaped
    sd["prediction.weight"] = reference["extra"]["prediction.weight"]
    sd["backbone.0.0.relative_pos"] = torch.zeros(1, 5, 5)
    pth = root / "pvig_s.pth"
    torch.save(sd, str(pth))
    res = from_reference.main([str(pth), reference["cfg"],
                               str(root / "partial"), "--partial",
                               "--prefix", "backbone."])
    report = res["report"]
    want_report: dict = {}
    converted = convert_reference_checkpoint(
        {"backbone." + k: v for k, v in sd.items()},
        reference["variables"], strict=False, report=want_report)
    for kind in ("loaded", "missing", "unused"):
        assert report[kind] == want_report[kind], kind
    assert [m[0] for m in report["mismatched"]] == \
        [m[0] for m in want_report["mismatched"]] == ["backbone.pos_embed"]
    assert report["unused"] == ["backbone.prediction.weight"]
    assert report["missing"] and all(k.startswith(("head.", "backbone.gcn",
                                                   "backbone.ffn_label",
                                                   "backbone.label_lt"))
                                     for k in report["missing"])
    got = GKGNetClassifier(**SMALL)
    load_params_only(str(root / "partial"), got)
    jax_loaded = GKGNetClassifier(**SMALL)
    load_jax_variables(jax_loaded, converted)
    init = GKGNetClassifier(**SMALL)
    init_parameters(init, torch.Generator().manual_seed(0))
    got_sd, want_sd, init_sd = (got.state_dict(), jax_loaded.state_dict(),
                                init.state_dict())
    for key in got_sd:
        assert_same(got_sd[key], (want_sd if key in report["loaded"]
                                  else init_sd)[key], key)


def test_strict_import_raises_on_a_missing_key(reference):
    root = reference["root"]
    sd = dict(reference["sd"])
    del sd["head.fc2.bias"]
    pth = root / "missing.pth"
    _container(pth, sd)
    with pytest.raises(from_reference.ConversionError,
                       match=r"missing keys: \['head.fc2.bias'\]"):
        from_reference.main([str(pth), reference["cfg"],
                             str(root / "never")])
    assert not os.path.exists(root / "never")


# ------------------------------------------------------------ entry points

@pytest.mark.parametrize("tool", ["vis_edges", "vis_cam", "get_flops"])
def test_model_tools_need_a_card_unless_cpu_is_asked(tool, voc_ws,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"vis_edges": [voc_ws["img"], voc_ws["cfg"]],
            "vis_cam": [voc_ws["img"], voc_ws["cfg"]],
            "get_flops": [voc_ws["cfg"], "--verify"]}[tool]
    main = {"vis_edges": vis_edges.main, "vis_cam": vis_cam.main,
            "get_flops": get_flops.main}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_every_tool_runs_as_a_module():
    """``python -m gkgnet_tpu_torch.tools.<group>.<tool> --help`` exits 0
    for every tool (run through runpy in one interpreter), which imports
    no JAX module."""
    script = (
        "import runpy, sys\n"
        "for name in sys.argv[1:]:\n"
        "    sys.argv = [name, '--help']\n"
        "    try:\n"
        "        runpy.run_module(name, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (name, e.code)\n"
        "    print('ok', name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'orbax', 'gkgnet_tpu')]\n"
        "assert not bad, bad\n")
    names = [f"gkgnet_tpu_torch.tools.{t}" for t in TOOLS]
    proc = subprocess.run([sys.executable, "-c", script, *names],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("ok ") == len(TOOLS), proc.stdout
