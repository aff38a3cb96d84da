"""Arch b (the pvig_b geometry: channels 128..1024, 18 stage-3 blocks) in
the port, on the CPU: its configuration, module names and shapes against
the JAX package's, the ungrouped backbone (stage 4 at D = 1024) against
the JAX backbone on carried weights, and the plain knn_mr at D = 1024
against the JAX package's plain path. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gkgnet_tpu.core.config import Config as JConfig
from gkgnet_tpu.nn.classifier import GKGNetClassifier as JaxClassifier
from gkgnet_tpu.nn.gkgnet import ARCH_SETTINGS as JARCH
from gkgnet_tpu.nn.gkgnet import GKGNet as JaxGKGNet
from gkgnet_tpu.ops import aggregate as jagg
from gkgnet_tpu.ops import knn as jknn
from gkgnet_tpu.utils.torch_convert import expected_torch_shapes
from gkgnet_tpu_torch.core.builder import build_model
from gkgnet_tpu_torch.core.config import Config
from gkgnet_tpu_torch.nn.gkgnet import ARCH_SETTINGS, GKGNet
from gkgnet_tpu_torch.ops.knn_mr import knn_mr_reference
from gkgnet_tpu_torch.ops.pos_embed import get_relative_pos_table
from test_torch_model import _jax_variables, _load_subtree, _t

B_CONFIG = "configs/gkgnet_b_coco_576.py"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU work on one thread: the suite runs several test files at
    once on the host's cores, and beside them a run on every core's thread
    spends most of its time waiting for the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_arch_b_registry_matches_jax():
    assert ARCH_SETTINGS["b"] == JARCH["b"]
    assert ARCH_SETTINGS["b"]["channels"] == (128, 256, 512, 1024)
    assert ARCH_SETTINGS["b"]["blocks"] == (2, 2, 18, 2)


@pytest.mark.parametrize("size", [224, 576])
def test_arch_b_names_and_shapes_match_jax(size):
    """The port's arch b classifier has exactly the state_dict keys and
    shapes that the JAX package's torch converter expects from the JAX
    tree (``tests/test_arch_b.py``'s model: 27 backbone modules, the
    (80, 1024) head, the (80, 128) label embedding), built from
    ``configs/gkgnet_b_coco_576.py`` at 576 (shapes only: on the meta
    device)."""
    if size == 576:
        cfg = Config.fromfile(B_CONFIG)
        jcfg = JConfig.fromfile(B_CONFIG)
        assert cfg.model == jcfg.model
        assert cfg.model["arch"] == "b" and cfg.model["drop_path"] == 0.2
        assert cfg.data["samples_per_device"] == 8
        jm = JaxClassifier(**{k: v for k, v in cfg.model.items()
                              if k not in ("head", "dtype")})
        with torch.device("meta"):
            tm = build_model(cfg.model)
    else:
        jm = JaxClassifier(arch="b", n_classes=80, size=size)
        with torch.device("meta"):
            tm = build_model(dict(arch="b", n_classes=80, size=size))
    variables = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    expected = expected_torch_shapes(variables)
    sd = tm.state_dict()
    assert set(sd) == set(expected)
    for key, shape in expected.items():
        assert tuple(sd[key].shape) == shape, key
    assert tuple(sd["head.fc1.weight"].shape) == (80, 1024)
    assert tuple(sd["backbone.label_lt.weight"].shape) == (80, 128)
    assert len(tm.backbone.backbone) == 27
    assert sum(isinstance(m, torch.nn.Sequential)
               for m in tm.backbone.backbone) == 24


def _graph_widths(model):
    """The D of every graph conv's build in a port backbone: its Graphers
    in order, then its label blocks."""
    out = []
    for block in model.backbone:
        if isinstance(block, torch.nn.Sequential):
            conv = block[0].graph_conv
            out.append(block[0].fc1[0].weight.shape[0] // conv.num_group)
    for stage in model.gcn_label:
        for gcn in stage:
            out.append(gcn.fc1[0].weight.shape[0] // gcn.graph_conv.num_group)
    return out


def test_ungrouped_arch_b_builds_at_d_1024():
    """Without channel groups arch b's stage 4 builds its graphs on all
    1024 channels (the D = 1024 kernel calls); with them on 512."""
    with torch.device("meta"):
        plain = GKGNet(arch="b", size=224, use_multi_group=False,
                       backbone_multi_group=False)
        grouped = GKGNet(arch="b", size=224)
    assert max(_graph_widths(plain)) == 1024
    assert max(_graph_widths(grouped)) == 512
    assert _graph_widths(plain).count(1024) == 2 + 1  # 2 Graphers, 1 label


@pytest.fixture(scope="module")
def ungrouped_b():
    """The ungrouped arch b backbone at 128 (k 2: every stage has room for
    k * dilation targets) in the JAX package, with random weights, and the
    port with the same weights."""
    kw = dict(arch="b", k=2, k_label_gcn=2, n_classes=6, size=128,
              use_multi_group=False, backbone_multi_group=False)
    x = np.random.default_rng(3).standard_normal((1, 128, 128, 3)).astype(
        np.float32)
    jm = JaxGKGNet(**kw)
    variables = _jax_variables(jm, jnp.asarray(x), False, seed=4)
    tm = GKGNet(**kw)
    _load_subtree(tm, variables, ("backbone",), "backbone.")
    return jm, variables, tm, x


def test_ungrouped_arch_b_matches_jax(ungrouped_b):
    """The ungrouped arch b backbone against the JAX backbone, eval, fp32:
    label embeddings and GAP within 1e-4 of their largest magnitude, the
    last label graph's edges equal."""
    jm, variables, tm, x = ungrouped_b
    (ref, _) = jax.jit(lambda v, x: jm.apply(v, x, False,
                                             mutable=["constants"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(_t(x))
    for a, b in ((got[0], ref[0]), (got[1], ref[1])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,m,k,dilation,bias", [
    (36, None, 9, 3, True),     # arch b stage 4 at 192 px: self, k*d 27
    (20, 36, 9, 1, False),      # its label call
])
def test_d1024_plain_knn_mr_matches_jax(n, m, k, dilation, bias, dtype):
    """The port's plain knn_mr at D = 1024 against the JAX package's plain
    path (``knn_graph`` on XLA, every d-th, ``max_relative``): idx equal,
    mr bitwise."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, n, 1024)).astype(np.float32)
    y = x if m is None else rng.standard_normal((2, m, 1024)).astype(
        np.float32)
    table = get_relative_pos_table(1024, n, 1) if bias else None
    tx = _t(x).to(dtype)
    ty = tx if m is None else _t(y).to(dtype)
    idx, mr = knn_mr_reference(tx, ty, None if table is None else _t(table),
                               k, dilation)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x).astype(jdt)
    jy = jx if m is None else jnp.asarray(y).astype(jdt)
    jidx = jknn.knn_graph(jx, None if m is None else jy, k=k * dilation,
                          bias=None if table is None else jnp.asarray(table))
    jidx = jknn.dilate_edges(jidx, dilation=dilation)
    jmr = jagg.max_relative(jx, jidx, jy)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mr.float().numpy(),
                                  np.asarray(jmr.astype(jnp.float32)))
