"""The port's serving path on the CPU against the JAX package's: the kNN
kernels as registered operators (``torch.library.opcheck``, bitwise the
plain versions forward and backward), ``torch.export`` artifacts of the JAX
deployment test's mini config (t@128, k 3, 2 groups, fp32) with one kernel
node per graph-conv call and no sort, ``tools.inference`` against the JAX
tool, the drawn predictions against the JAX drawing, the deployment test
CLI against the test CLI, the HTTP server started in a thread, and what the
serving path refuses. Weights come from the JAX init
(``utils/weights.load_jax_variables``), saved as a port checkpoint; the
images are ``tests/test_torch_data.py``'s 8 seeded JPEGs. Everything runs
in this process.
"""

import ast
import glob
import json
import os
import pickle
import threading
import urllib.request
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gkgnet_tpu.core.builder import build_model as jax_build_model
from gkgnet_tpu.core.config import Config as JaxConfig
from gkgnet_tpu.core.trainer import make_eval_step as jax_make_eval_step
from gkgnet_tpu.data.pipelines import build_pipeline as jax_build_pipeline
from gkgnet_tpu.utils.visualization import \
    imshow_predictions as jax_imshow_predictions
from gkgnet_tpu_torch.core import export as texport
from gkgnet_tpu_torch.core.builder import build_model
from gkgnet_tpu_torch.core.checkpoint import save_checkpoint
from gkgnet_tpu_torch.core.optim import build_optimizer
from gkgnet_tpu_torch.core.trainer import create_train_state
from gkgnet_tpu_torch.nn import grapher
from gkgnet_tpu_torch.ops import knn, knn_mr
from gkgnet_tpu_torch.tools import inference
from gkgnet_tpu_torch.tools import test as test_cli
from gkgnet_tpu_torch.tools.deployment import export as export_cli
from gkgnet_tpu_torch.tools.deployment import serve
from gkgnet_tpu_torch.tools.deployment import test as deploy_test
from gkgnet_tpu_torch.utils.visualization import imshow_predictions
from gkgnet_tpu_torch.utils.weights import load_jax_variables
from test_deployment import MINI_CONFIG
from test_torch_data import _mini_set, load_tool
from test_torch_hooks import jax_init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_OPS = ("gkgnet_tpu_torch.knn_mr_fused.default",
              "gkgnet_tpu_torch.knn_mr_fused_grouped.default",
              "gkgnet_tpu_torch.knn_topk.default")
# scores of the eager forward in both frameworks on the same weights and
# image, fp32: the models' logits agree to ~5e-6 of their scale (the
# parity tests' 1e-4 bound), and a sigmoid's slope is at most 1/4
SCORE_ATOL = 1e-5
# a class whose JAX score lies this far from the threshold gets the same
# label from the port's server
LABEL_MARGIN = 1e-3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def load_each_artifact_once():
    """``torch.export.load`` spends ~5 s deserializing the mini artifact's
    graph (2341 nodes, in torch's serializer): each file is read from disk
    once per module (the export CLI's --verify does it first) and the
    program shared; each ``ExportedProgramClassifier`` still builds its
    own module from it."""
    load, cache = torch.export.load, {}

    def load_once(path, *args, **kwargs):
        key = (os.path.abspath(path), os.path.getmtime(path))
        if key not in cache:
            cache[key] = load(path, *args, **kwargs)
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.export, "load", load_once)
        yield


def _program_ops(program) -> Counter:
    return Counter(str(n.target) for n in program.graph.nodes
                   if n.op == "call_function")


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The mini workspace: 8 JPEGs, the config, the JAX model and its init
    state, that state saved as a port checkpoint, and two CPU artifacts of
    it written by the export CLI (batch 2 with --verify, batch 1)."""
    root = tmp_path_factory.mktemp("torch_deploy")
    img_dir, ann = _mini_set(root)
    cfg = str(root / "cfg.py")
    with open(cfg, "w") as f:
        f.write(MINI_CONFIG.format(img_dir=img_dir, ann=ann))
    jcfg = JaxConfig.fromfile(cfg)
    jmodel = jax_build_model(jcfg.model)
    jstate = jax_init_state(jmodel, 128)
    model = build_model(jcfg.model)
    load_jax_variables(model, {"params": jstate.params,
                               "batch_stats": jstate.batch_stats})
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, create_train_state(model,
                                             build_optimizer(model, 1e-3)), 1)
    exports = {}
    for batch in (2, 1):
        out = str(root / f"mini_b{batch}.pt2")
        exports[batch] = export_cli.main(
            [cfg, ckpt, "--out", out, "--batch", str(batch), "--device",
             "cpu"] + (["--verify"] if batch == 2 else []))
    return dict(root=root, img_dir=img_dir, ann=ann, cfg=cfg, jcfg=jcfg,
                jmodel=jmodel, jstate=jstate, ckpt=ckpt, exports=exports)


# ------------------------------------------------ the registered operators


def _inputs(case):
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    if case == "grouped":
        return t(2, 12, 16), t(2, 10, 16), t(12, 10)
    return t(2, 12, 8), t(2, 10, 8), t(12, 10)


@pytest.mark.parametrize("op,args", [
    ("knn_mr_fused", lambda x, y, b: (x, y, b, 3, 2)),
    ("knn_mr_fused", lambda x, y, b: (x, x, None, 3, 1)),
    ("knn_mr_fused_grouped", lambda x, y, b: (x, y, b, 2, 2, 2)),
    ("knn_topk", lambda x, y, b: (x, y, 4, b)),
], ids=["folded", "self", "grouped", "topk"])
def test_operators_pass_opcheck(op, args):
    """Schema, autograd registration and the fake (shape) function against
    the real outputs. opcheck's aot-dispatch check is left out: its harness
    casts the int32 idx output to float and fails on its own cast; the
    export round trips below cover that path."""
    x, y, b = _inputs("grouped" if op.endswith("grouped") else op)
    grad = op != "knn_topk"
    x.requires_grad_(grad)
    y.requires_grad_(grad)
    torch.library.opcheck(
        getattr(torch.ops.gkgnet_tpu_torch, op).default, args(x, y, b),
        test_utils=("test_schema", "test_autograd_registration",
                    "test_faketensor"))


@pytest.mark.parametrize("case", ["folded", "self", "grouped"])
def test_operators_are_bitwise_the_plain_versions(case):
    """Forward and backward through the operators give the bits of the
    plain versions they dispatch to on the CPU (y is x: autograd sums the
    two gradients into the one input)."""
    x, y, bias = _inputs(case)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        x.shape).astype(np.float32))
    tx = x.clone().requires_grad_()
    ty = tx if case == "self" else y.clone().requires_grad_()
    if case == "grouped":
        idx, mr = knn_mr.knn_mr_fused_grouped(tx, ty, bias, 2, 2, 2)
        want_idx, want_mr = knn_mr.knn_mr_grouped_reference(x, y, bias, 2,
                                                            2, 2)
        gx, gy = knn_mr.knn_mr_grouped_backward_reference(x, y, idx, g, 2)
    else:
        yy = x if case == "self" else y
        b = None if case == "self" else bias
        idx, mr = knn_mr.knn_mr_fused(tx, ty, b, 3, 2)
        want_idx, want_mr = knn_mr.knn_mr_reference(x, yy, b, 3, 2)
        gx, gy = knn_mr.knn_mr_backward_reference(x, yy, idx, g)
    assert torch.equal(idx, want_idx) and torch.equal(mr, want_mr)
    assert not idx.requires_grad and mr.requires_grad
    mr.backward(g)
    if case == "self":
        assert torch.equal(tx.grad, gx + gy)
    else:
        assert torch.equal(tx.grad, gx) and torch.equal(ty.grad, gy)


def test_knn_graph_is_bitwise_the_plain_version():
    x, y, bias = _inputs("topk")
    want = knn.knn_topk_reference(knn.l2_normalize(x), knn.l2_normalize(y),
                                  k=4, bias=bias)
    assert torch.equal(knn.knn_graph(x, y, k=4, bias=bias), want)
    self_want = knn.knn_topk_reference(knn.l2_normalize(x),
                                       knn.l2_normalize(x), k=4)
    assert torch.equal(knn.knn_graph(x, k=4), self_want)


@pytest.mark.parametrize("route", ["grouped", "topk"])
def test_the_other_operators_export(route, tmp_path):
    """knn_mr_fused_grouped (GKGNET_GROUPED=1's route) and knn_topk (the
    edge/sage/gin/gat aggregators' graph) stay one node each in an
    exported graph, and the saved and loaded program gives the eager bits."""
    x, y, bias = _inputs("grouped" if route == "grouped" else "topk")

    class Call(torch.nn.Module):
        def forward(self, x, y):
            if route == "grouped":
                return knn_mr.knn_mr_fused_grouped(x, y, bias, 2, 2, 2)
            return knn.knn_graph(x, y, k=4, bias=bias)

    program = torch.export.export(Call(), (x, y), strict=False)
    ops = _program_ops(program)
    name = KERNEL_OPS[1] if route == "grouped" else KERNEL_OPS[2]
    assert ops[name] == 1
    assert not any("sort" in op or "topk" in op and "gkgnet" not in op
                   for op in ops)
    torch.export.save(program, str(tmp_path / "op.pt2"))
    got = torch.export.load(str(tmp_path / "op.pt2")).module()(x, y)
    want = Call()(x, y)
    for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        assert torch.equal(a, b)


# ------------------------------------------------------ export artifacts


def test_cpu_export_holds_one_kernel_node_per_graph_conv(ws):
    """The batch-2 artifact's graph: one knn_mr_fused node for each
    graph-conv call of an eager forward, no other kernel node and no sort
    or topk (the plain version is not traced in); --verify found the
    reloaded artifact bitwise the eager forward."""
    calls = []
    op = grapher.knn_mr_fused

    def spy(*args):
        calls.append(args[3:])
        return op(*args)

    model, cfg = inference.init_model(ws["cfg"], ws["ckpt"], "cpu")
    grapher.knn_mr_fused = spy
    try:
        with torch.no_grad():
            model(torch.zeros(1, 128, 128, 3))
    finally:
        grapher.knn_mr_fused = op
    ops = _program_ops(ws["exports"][2]["program"])
    assert len(calls) == 16
    assert ops[KERNEL_OPS[0]] == len(calls)
    assert ops[KERNEL_OPS[1]] == ops[KERNEL_OPS[2]] == 0
    assert not [o for o in ops if "sort" in o or "topk" in o]
    assert ws["exports"][2]["max_diff"] == 0.0


def test_artifact_round_trip_is_bitwise_eager(ws):
    """The saved artifact, loaded through ExportedProgramClassifier, scores
    the test pipeline's images with the eager eval step's bits."""
    clf = texport.load_exported_classifier(ws["exports"][2]["out"])
    assert clf.batch == 2 and clf.input_shape == (2, 128, 128, 3)
    assert clf.device.type == "cpu"
    model, cfg = inference.init_model(ws["cfg"], ws["ckpt"], "cpu")
    imgs = np.concatenate([
        inference.load_image(cfg, os.path.join(ws["img_dir"], f"im_{i}.jpg"))
        for i in (0, 5)])
    with torch.no_grad():
        want = torch.sigmoid(model(torch.from_numpy(imgs))[0]).numpy()
    np.testing.assert_array_equal(clf(imgs), want)
    with pytest.raises(ValueError, match="takes"):
        clf(imgs[:1])


def test_cpu_artifact_refuses_the_card(ws):
    with pytest.raises(ValueError, match="exported for cpu"):
        texport.ExportedProgramClassifier(ws["exports"][1]["out"],
                                          device="cuda")


def test_savedmodel_backend_raises(ws, tmp_path):
    with pytest.raises(NotImplementedError, match="TensorFlow"):
        texport.load_exported_classifier(str(tmp_path))
    with pytest.raises(NotImplementedError, match="TensorFlow"):
        texport.load_exported_classifier(ws["exports"][1]["out"],
                                         backend="savedmodel")
    with pytest.raises(NotImplementedError, match="TensorFlow"):
        export_cli.main([ws["cfg"], "--out", str(tmp_path / "m"),
                         "--format", "savedmodel", "--device", "cpu"])


def test_serving_clis_need_a_card_unless_cpu_is_asked(ws, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = os.path.join(ws["img_dir"], "im_0.jpg")
    art = ws["exports"][1]["out"]
    for call in (
            lambda: export_cli.main([ws["cfg"], "--out", "unused.pt2"]),
            lambda: deploy_test.main([ws["cfg"], art]),
            lambda: serve.main([ws["cfg"], "--artifact", art], block=False),
            lambda: inference.main([img, ws["cfg"]])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --------------------------------------------------- inference, drawing


def test_inference_matches_jax(ws):
    """tools.inference on one JPEG: the port's scores against the JAX
    tool's (the same weights, the same test pipeline), and the top-k
    dicts in the JAX tool's form, ordered by the port's scores."""
    jax_tool = load_tool("inference.py")
    img = os.path.join(ws["img_dir"], "im_3.jpg")
    want, want_preds = jax_tool.inference_model(
        ws["jmodel"], ws["jstate"], ws["jcfg"], img, topk=5)
    model, cfg = inference.init_model(ws["cfg"], ws["ckpt"], "cpu")
    scores, preds = inference.inference_model(model, cfg, img, topk=5)
    assert scores.shape == (80,) and scores.dtype == np.float32
    np.testing.assert_allclose(scores, np.asarray(want), rtol=0,
                               atol=SCORE_ATOL)
    assert [set(p) for p in preds] == [set(p) for p in want_preds]
    assert [p["class_id"] for p in preds] == list(np.argsort(-scores)[:5])
    assert all(p["score"] == float(scores[p["class_id"]]) for p in preds)


def test_inference_cli_draws_the_predictions(ws, tmp_path):
    img = os.path.join(ws["img_dir"], "im_2.jpg")
    out = str(tmp_path / "drawn.png")
    _, preds = inference.main([img, ws["cfg"], ws["ckpt"], "--device",
                               "cpu", "--topk", "3", "--out-image", out])
    assert len(preds) == 3
    with Image.open(out) as im:
        drawn = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(drawn, imshow_predictions(img, preds))


@pytest.mark.parametrize("source", ["path", "float_array"])
def test_imshow_predictions_pixel_equal_jax(ws, source, tmp_path):
    img = os.path.join(ws["img_dir"], "im_4.jpg")
    if source == "float_array":
        with Image.open(img) as im:
            img = np.asarray(im.convert("RGB")).astype(np.float32) * 1.3
    preds = [{"class_id": 7, "class_name": "train", "score": 0.91},
             {"class_id": 0, "class_name": "person", "score": 0.4}]
    out = str(tmp_path / "p.png")
    got = imshow_predictions(img, preds, out_file=out)
    want = jax_imshow_predictions(img, preds)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    with Image.open(out) as im:
        np.testing.assert_array_equal(np.asarray(im), got)


# ------------------------------------------------- the deployment test CLI


def test_deployment_test_equals_the_test_cli(ws, tmp_path):
    """The batch-2 artifact over the 8 test images gives the test CLI's
    scores on the same checkpoint at its batch of 2, bit for bit, and so
    its metric dict; --out and --metrics-out hold them."""
    out, mout = str(tmp_path / "s.pkl"), str(tmp_path / "m.json")
    metrics, scores = deploy_test.main(
        [ws["cfg"], ws["exports"][2]["out"], "--device", "cpu", "--out",
         out, "--metrics-out", mout])
    want_metrics, want_scores = test_cli.main([ws["cfg"], ws["ckpt"],
                                               "--device", "cpu"])
    assert scores.shape == (8, 80)
    np.testing.assert_array_equal(scores, want_scores)
    assert metrics == want_metrics and "mAP" in metrics
    with open(out, "rb") as f:
        np.testing.assert_array_equal(pickle.load(f), scores)
    with open(mout) as f:
        assert json.load(f) == metrics


def test_deployment_test_pads_the_last_batch(ws, tmp_path):
    """7 images through the batch-2 artifact: the last batch is padded with
    copies of its last image and cut back to 7 rows; every row is the
    artifact's own score of that image in the batch the CLI made of it."""
    with open(ws["ann"], "rb") as f:
        records = pickle.load(f)[:7]
    ann7 = str(tmp_path / "seven.data")
    with open(ann7, "wb") as f:
        pickle.dump(records, f)
    _, scores = deploy_test.main([ws["cfg"], ws["exports"][2]["out"],
                                  "--device", "cpu", "--cfg-options",
                                  f"data.test.ann_file={ann7}"])
    assert scores.shape == (7, 80)
    clf = texport.load_exported_classifier(ws["exports"][2]["out"])
    cfg = inference.init_model(ws["cfg"], None, "cpu")[1]
    imgs = [inference.load_image(cfg, os.path.join(ws["img_dir"],
                                                   r["file_name"]))
            for r in records]
    for i in range(0, 7, 2):
        pair = imgs[i:i + 2] if i + 1 < 7 else [imgs[i], imgs[i]]
        want = clf(np.concatenate(pair))
        np.testing.assert_array_equal(scores[i:i + 2], want[:len(
            scores[i:i + 2])])


# ----------------------------------------------------------- the server


def _request(port, path, data=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST" if data else "GET")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("source", ["checkpoint", "artifact"])
def test_server_answers_like_the_scorer(ws, source):
    """The server on port 0 in a thread: /ping, then a POST of a JPEG's
    bytes whose pred_score are the in-process scorer's on the same bytes
    (rounded to 6 digits, as the server sends them) and whose pred_label
    agrees with the JAX scores of the same decoded image wherever a score
    lies more than LABEL_MARGIN from the threshold."""
    arg = (["--checkpoint", ws["ckpt"]] if source == "checkpoint"
           else ["--artifact", ws["exports"][1]["out"]])
    server = serve.main([ws["cfg"], *arg, "--port", "0", "--device",
                         "cpu"], block=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        assert _request(port, "/ping") == (200, {"status": "Healthy"})
        with open(os.path.join(ws["img_dir"], "im_6.jpg"), "rb") as f:
            raw = f.read()
        status, body = _request(port, "/predictions/gkgnet", raw)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    assert status == 200
    scores = server.score_bytes(raw)
    keep = np.where(scores >= 0.5)[0]
    assert body["pred_label"] == [int(i) for i in keep]
    assert body["pred_score"] == [round(float(scores[i]), 6) for i in keep]
    assert len(body["pred_class"]) == len(keep)
    img = np.asarray(Image.open(
        os.path.join(ws["img_dir"], "im_6.jpg")).convert("RGB"))
    pipeline = jax_build_pipeline([
        c for c in ws["jcfg"].data["test"]["pipeline"]
        if c["type"] != "LoadImageFromFile"])
    jscores = np.asarray(jax_make_eval_step(ws["jmodel"])(
        ws["jstate"], jnp.asarray(pipeline({"img": img})["img"][None])))[0]
    far = np.abs(jscores - 0.5) > LABEL_MARGIN
    assert far.sum() > 40
    np.testing.assert_array_equal((scores >= 0.5)[far], (jscores >= 0.5)[far])


# -------------------------------------------------------- the port alone


def test_port_and_chip_smoke_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax,
    optax, orbax or the JAX package (read from their sources)."""
    banned = ("jax", "flax", "optax", "orbax", "gkgnet_tpu")
    files = glob.glob(os.path.join(REPO, "gkgnet_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 50
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            found += [(path, n) for n in names
                      if n.split(".")[0] in banned]
    assert found == []
