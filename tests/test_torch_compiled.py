"""The port's compiled steps (``core.graphs``, the counterpart of
``jax.jit``) on the CPU: the restructured step, which keeps every decision
on the device, held to the JAX package's ``make_train_step`` over three
steps with the dynamic loss scaler and a NaN batch; the step generator's
draws; when ``compiled`` captures, runs eagerly or raises; and
``StepGraphs``' bookkeeping (warm-up, capture, replay, launch counts,
recapture) on a stand-in for the CUDA graph API. The captured steps
themselves run on the card (tests/test_torch_cuda.py, chip_smoke.py phase
15).
"""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gkgnet_tpu.core import optim as joptim
from gkgnet_tpu.core import trainer as jtrainer
from gkgnet_tpu.nn import classifier as jclassifier
from gkgnet_tpu.nn import gkgnet as jgkgnet
from gkgnet_tpu_torch import entry as tentry
from gkgnet_tpu_torch.core import graphs as tgraphs
from gkgnet_tpu_torch.core import optim as toptim
from gkgnet_tpu_torch.core import trainer as ttrainer
from gkgnet_tpu_torch.nn import augment as taugment
from gkgnet_tpu_torch.nn import gkgnet as tgkgnet
from gkgnet_tpu_torch.nn import layers as tlayers
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier, init_parameters
from gkgnet_tpu_torch.ops import knn_mr
from gkgnet_tpu_torch.utils.weights import (load_jax_variables,
                                            state_dict_from_jax)

SMALL = dict(arch="t", k=3, k_label_gcn=3, n_classes=10, size=128)
TINY = dict(SMALL, arch="t_tiny")
STEPS = 3  # step 1 takes a NaN batch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module", autouse=True)
def tiny_arch():
    """``TINY``'s arch, t with one block a stage, registered in both
    packages for this module: the JAX package's jitted scaler step takes
    minutes to compile at t's depth, and the port's CPU steps take a
    third of t's time. The module's torch work runs on one thread: beside
    the other test workers, a small step on every core's thread ran ~100x
    slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for registry in (jgkgnet.ARCH_SETTINGS, tgkgnet.ARCH_SETTINGS):
                mp.setitem(registry, "t_tiny", dict(registry["t"],
                                                    blocks=(1, 1, 1, 1)))
            yield
    finally:
        torch.set_num_threads(threads)


_START = {}


def _jax_start(img: np.ndarray):
    """The JAX model and its initial train state for ``img``'s shape, made
    once for the module's runs (jitted: the eager init takes ~50 s at this
    size)."""
    if not _START:
        jm = jclassifier.GKGNetClassifier(**TINY)
        create = jax.jit(jtrainer.create_train_state,
                         static_argnums=(0, 3, 4, 5))
        _START["run"] = jm, create(jm, jax.random.PRNGKey(0),
                                   jnp.asarray(img), optax.sgd(1e-3), True,
                                   True)
    return _START["run"]


def _scaler_steps(lr: float, imgs: list, gt: np.ndarray,
                  growth_interval: int) -> dict:
    """The JAX package's jitted step and the port's eager step from the
    same weights over ``imgs``: arch ``TINY``, fp32, batch 2
    (test_torch_train.py's step_pair batch), AdamW at ``lr`` + clip 5 +
    EMA, the dynamic loss scaler."""
    jm, state = _jax_start(imgs[0])
    tx = joptim.build_optimizer(state.params, lr)
    state = state.replace(opt_state=tx.init(state.params))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    j_step = jtrainer.make_train_step(
        jm, tx, ema_momentum=2e-4, donate=False, dynamic_loss_scale=True,
        scale_growth_interval=growth_interval)

    tm = GKGNetClassifier(**TINY)
    load_jax_variables(tm, variables)
    t_state = ttrainer.create_train_state(
        tm, toptim.build_optimizer(tm, lr), ema=True,
        dynamic_loss_scale=True)
    t_step = ttrainer.make_train_step(
        ema_momentum=2e-4, dynamic_loss_scale=True,
        scale_growth_interval=growth_interval)
    j_logs, t_logs, t_stats = [], [], []
    for im in imgs:
        state, log = j_step(
            state, {"img": jnp.asarray(im), "gt_label": jnp.asarray(gt)},
            jax.random.PRNGKey(7))
        j_logs.append(jax.device_get(log))
        t_state, t_log = t_step(t_state, {"img": _t(im),
                                          "gt_label": _t(gt)}, 7)
        t_logs.append(t_log)
        t_stats.append({k: v.clone() for k, v in
                        t_state.model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))})
    return dict(j_logs=j_logs, t_logs=t_logs, j_state=state,
                t_state=t_state, t_stats=t_stats, variables=variables)


def _batch_pair():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    gt = (rng.random((2, 10)) < 0.3).astype(np.float32)
    return img, gt


@pytest.fixture(scope="module")
def scaler_run():
    """Three steps (``_scaler_steps``) with a growth interval of 1 (so the
    finite steps grow the scale and the NaN step halves it), a NaN batch
    at step 1 and the first batch again at step 2.

    The learning rate is 0, so the parameters stay where they start: the
    random t@128 model is chaotic, and one Adam step of 1e-6 flips kNN
    near-ties and moves the next loss by 1-2 % in either package
    (measured: 13.50 and 13.81 against the first step's 13.36). The
    optimizer's arithmetic is held through its moments here, and the
    parameters' update by ``scaler_lr_run``."""
    img, gt = _batch_pair()
    return _scaler_steps(0.0, [img, np.full_like(img, np.nan), img], gt, 1)


@pytest.fixture(scope="module")
def scaler_lr_run():
    """Two steps (``_scaler_steps``) at a learning rate of 1e-3 and the
    default growth interval: a finite batch, then a NaN one. Only the
    first step's loss depends on no update, so nothing after an update is
    compared by its loss."""
    img, gt = _batch_pair()
    return _scaler_steps(1e-3, [img, np.full_like(img, np.nan)], gt, 2000)


def test_scaler_steps_match_jax_losses_and_scale(scaler_run):
    """Each step's bce_loss, asy_loss, loss and pre-clip gradient norm
    within 1e-4 relative (the NaN step's loss NaN in both, its norm 0: the
    gradients were zeroed), the scale and good_steps equal: grown at the
    finite steps, halved at the NaN one."""
    for s, (j_log, t_log) in enumerate(zip(scaler_run["j_logs"],
                                           scaler_run["t_logs"])):
        for key in ("bce_loss", "asy_loss", "loss", "grad_norm"):
            np.testing.assert_allclose(float(t_log[key]), float(j_log[key]),
                                       rtol=1e-4, err_msg=f"{s} {key}")
        assert float(t_log["loss_scale"]) == float(j_log["loss_scale"])
        assert t_log["loss_scale"].shape == ()
    assert [float(t["loss_scale"]) for t in scaler_run["t_logs"]] == \
        [2.0 ** 17, 2.0 ** 16, 2.0 ** 17]
    assert np.isnan(float(scaler_run["t_logs"][1]["loss"]))
    assert float(scaler_run["t_logs"][1]["grad_norm"]) == 0.0
    t_state, j_state = scaler_run["t_state"], scaler_run["j_state"]
    assert int(t_state.good_steps) == int(j_state.good_steps) == 0
    assert t_state.good_steps.dtype == torch.int32
    assert t_state.step == int(j_state.step) == STEPS


def test_scaler_steps_match_jax_state(scaler_run):
    """After the three steps: the parameters where they started in both
    (lr 0); the running statistics within 1e-4 relative with a floor of
    1e-6 (test_torch_train.py's step_pair bound), and bitwise unchanged by
    the NaN step; Adam's moments (two applied updates: the NaN step
    counted none) within step_pair's gradient bound, 1e-2 of each leaf's
    largest value, with no leaf's scale taken below 1e-4 of the model's
    largest (``nu`` compared as its root, in the gradients' scale); the
    step counts 2 in both."""
    t_state, j_state = scaler_run["t_state"], scaler_run["j_state"]
    named = dict(t_state.model.named_parameters())
    start = state_dict_from_jax({"params": scaler_run["variables"]["params"]})
    for key, value in state_dict_from_jax(
            {"params": j_state.params}).items():
        assert torch.equal(value, start[key]), key
        assert torch.equal(named[key].detach(), start[key]), key
    sd = t_state.model.state_dict()
    for key, value in state_dict_from_jax(
            {"batch_stats": j_state.batch_stats}).items():
        bound = max(1e-4 * value.abs().max().item(), 1e-6)
        assert (sd[key] - value).abs().max().item() <= bound, key
    before, after = scaler_run["t_stats"][0], scaler_run["t_stats"][1]
    for key, value in before.items():
        assert torch.equal(after[key], value), key
    adam = j_state.opt_state[1][0]
    assert int(adam.count) == 2
    opt = t_state.optimizer.optimizer
    _moments_within_bound(opt, named, adam)
    assert {float(opt.state[p]["step"]) for p in named.values()} == {2.0}


def _moments_within_bound(t_opt, named: dict, adam) -> dict:
    """Adam's moments of the port against optax's, within step_pair's
    gradient bound: 1e-2 of each leaf's largest value, with no leaf's
    scale taken below 1e-4 of the model's largest (``nu`` compared as its
    root, in the gradients' scale). Returns each leaf's ``mu`` scale."""
    scales = {}
    for name, tree, root in (("mu", adam.mu, False), ("nu", adam.nu, True)):
        ref = state_dict_from_jax({"params": tree})
        if root:
            ref = {k: v.sqrt() for k, v in ref.items()}
        floor = 1e-4 * max(v.abs().max().item() for v in ref.values())
        for key, value in ref.items():
            got = t_opt.state[named[key]][name]
            got = got.sqrt() if root else got
            scale = max(value.abs().max().item(), floor)
            err = (got - value).abs().max().item()
            assert err <= 1e-2 * scale, (name, key, err, scale)
            if name == "mu":
                scales[key] = scale
    return scales


def test_nan_step_after_an_update_matches_jax(scaler_lr_run):
    """A finite step at lr 1e-3, then a NaN one, in both packages: the
    first step's losses and norm within 1e-4 relative; the scale and
    good_steps equal after each step (the NaN step halves the scale and
    resets the count); after the NaN step, the moments within step_pair's
    gradient bound (``_moments_within_bound``), one update counted in
    both, and the running statistics within step_pair's bound, bitwise
    what the finite step left in the port. The parameters, moved once:
    within 1e-5 of each leaf's largest value plus 2 * lr, step_pair's EMA
    bound at m = 1 (Adam's first update is +-lr on every element, and
    where a gradient is rounding noise its sign is the noise's), and
    within 1e-5 of the leaf plus 1e-2 * lr where optax's first moment is
    more than twice the moments' bound from 0, so that the gradient's sign
    is settled in both packages."""
    run = scaler_lr_run
    j_logs, t_logs = run["j_logs"], run["t_logs"]
    for key in ("bce_loss", "asy_loss", "loss", "grad_norm"):
        np.testing.assert_allclose(float(t_logs[0][key]),
                                   float(j_logs[0][key]), rtol=1e-4,
                                   err_msg=key)
    for j_log, t_log in zip(j_logs, t_logs):
        assert float(t_log["loss_scale"]) == float(j_log["loss_scale"])
    assert [float(t["loss_scale"]) for t in t_logs] == [2.0 ** 16,
                                                       2.0 ** 15]
    assert float(t_logs[1]["grad_norm"]) == 0.0
    t_state, j_state = run["t_state"], run["j_state"]
    assert int(t_state.good_steps) == int(j_state.good_steps) == 0
    assert t_state.step == int(j_state.step) == 2

    adam = j_state.opt_state[1][0]
    assert int(adam.count) == 1
    opt = t_state.optimizer.optimizer
    named = dict(t_state.model.named_parameters())
    assert {float(opt.state[p]["step"]) for p in named.values()} == {1.0}
    scales = _moments_within_bound(opt, named, adam)
    mu = state_dict_from_jax({"params": adam.mu})

    sd = t_state.model.state_dict()
    for key, value in state_dict_from_jax(
            {"batch_stats": j_state.batch_stats}).items():
        bound = max(1e-4 * value.abs().max().item(), 1e-6)
        assert (sd[key] - value).abs().max().item() <= bound, key
    for key, value in run["t_stats"][0].items():
        assert torch.equal(run["t_stats"][1][key], value), key

    lr = 1e-3
    start = state_dict_from_jax({"params": run["variables"]["params"]})
    moved = 0
    for key, value in state_dict_from_jax(
            {"params": j_state.params}).items():
        got = named[key].detach()
        settled = mu[key].abs() > 2 * 1e-2 * scales[key]
        bound = 1e-5 * value.abs().max().item() + torch.where(
            settled, 1e-2 * lr, 2 * lr)
        assert bool(((got - value).abs() <= bound).all()), key
        moved += int((value != start[key]).sum())
    assert moved > 0


def test_nan_step_keeps_parameters_and_moments_bitwise():
    """A NaN batch after a finite one, at a learning rate that moves the
    parameters: the skipped step leaves the parameters, the optimizer
    state (moments and step counts) and the BatchNorm statistics bitwise
    as they were, and halves the scale."""
    model = GKGNetClassifier(**TINY, drop_path=0.1)
    init_parameters(model, torch.Generator().manual_seed(0))
    state = ttrainer.create_train_state(
        model, toptim.build_optimizer(model, 1e-3), ema=True,
        dynamic_loss_scale=True)
    step = ttrainer.make_train_step(ema_momentum=2e-4,
                                    dynamic_loss_scale=True)
    rng = np.random.default_rng(1)
    good = {"img": _t(rng.standard_normal((2, 128, 128, 3))),
            "gt_label": _t(rng.random((2, 10)) < 0.3)}
    bad = {"img": torch.full((2, 128, 128, 3), float("nan")),
           "gt_label": good["gt_label"]}
    state, _ = step(state, good, 3)
    opt = state.optimizer.optimizer
    kept = (list(model.parameters()) + opt.state_tensors()
            + [b for n, b in model.named_buffers() if "running" in n])
    before = [t.detach().clone() for t in kept]
    state, logs = step(state, bad, 3)
    assert float(logs["loss_scale"]) == 2.0 ** 15
    for t, old in zip(kept, before):
        assert torch.equal(t, old)
    assert int(state.good_steps) == 0 and state.step == 2


# ------------------------------------------------------------ generator


def test_reseeded_generator_draws_match_a_fresh_one():
    """One generator re-seeded with ``step_seed(seed, step)`` draws bitwise
    what ``step_generator(seed, step)``'s new generator draws, for every
    kind of draw a step takes (DropPath's rand, the dilation's randperm,
    the perturbed build's randn, the augments' gamma, multinomial and
    randint), whatever it drew before."""
    def draws(gen):
        return [torch.rand((8, 1, 1), generator=gen),
                torch.randperm(27, generator=gen),
                torch.randn((3, 5), generator=gen),
                torch._standard_gamma(torch.full((2,), 0.4),
                                      generator=gen),
                torch.multinomial(torch.tensor([0.3, 0.7]), 1,
                                  generator=gen),
                torch.randint(0, 128, (), generator=gen)]

    gen = torch.Generator()
    for seed, step in ((0, 0), (7, 1), (7, 2), (0, 0), (123, 10 ** 6)):
        got = draws(gen.manual_seed(ttrainer.step_seed(seed, step)))
        want = draws(ttrainer.step_generator(seed, step, torch.device("cpu")))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_step_draws_from_the_step_seeded_generator(monkeypatch):
    """Every DropPath of a train step draws from a generator seeded
    ``step_seed(seed, step)``, step after step, and the batch augment's
    choice comes first from the same generator."""
    seen = []
    forward = tlayers.DropPath.forward

    def spy(self, x, generator):
        if self.training and self.rate > 0:
            seen.append(generator.initial_seed())
        return forward(self, x, generator)

    monkeypatch.setattr(tlayers.DropPath, "forward", spy)
    model = GKGNetClassifier(**TINY, drop_path=0.1)
    init_parameters(model, torch.Generator().manual_seed(0))
    state = ttrainer.create_train_state(model,
                                        toptim.build_optimizer(model, 1e-3))
    picks = []
    augment = taugment.build_batch_augment([dict(type="BatchMixup"),
                                            dict(type="BatchCutMix")])
    pick = augment.pick

    def spy_pick(gen):
        picks.append(gen.initial_seed())
        return pick(gen)

    augment.pick = spy_pick
    step = ttrainer.make_train_step(batch_augment=augment)
    rng = np.random.default_rng(2)
    batch = {"img": _t(rng.standard_normal((2, 128, 128, 3))),
             "gt_label": _t(rng.random((2, 10)) < 0.3)}
    for s in range(2):
        seen.clear()
        state, _ = step(state, batch, 11)
        assert seen and set(seen) == {ttrainer.step_seed(11, s)}
    assert picks == [ttrainer.step_seed(11, s) for s in range(2)]


# ------------------------------------------------------ when it captures


def _cpu_state():
    model = GKGNetClassifier(**TINY)
    init_parameters(model, torch.Generator().manual_seed(0))
    return ttrainer.create_train_state(model,
                                       toptim.build_optimizer(model, 1e-3))


def _batch():
    rng = np.random.default_rng(3)
    return {"img": _t(rng.standard_normal((2, 128, 128, 3))),
            "gt_label": _t(rng.random((2, 10)) < 0.3)}


def test_compiled_true_raises_on_a_cpu_model():
    state, batch = _cpu_state(), _batch()
    with pytest.raises(RuntimeError, match="not on a CUDA device"):
        ttrainer.make_train_step(compiled=True)(state, batch)
    with pytest.raises(RuntimeError, match="not on a CUDA device"):
        ttrainer.make_eval_step(compiled=True)(state, batch["img"])
    assert state.step == 0


def test_compiled_true_raises_in_a_world_of_two(monkeypatch):
    """A step over a world of two ranks (faked here) runs collectives: no
    capture, whatever the device; ``None`` decides for eager."""
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    for device in ("cpu", "cuda"):
        with pytest.raises(RuntimeError, match="world of more than one"):
            tgraphs.capturable(True, torch.device(device))
        assert not tgraphs.capturable(None, torch.device(device))
    with pytest.raises(RuntimeError, match="world of more than one"):
        ttrainer.make_train_step(compiled=True)(_cpu_state(), _batch())


def test_compiled_none_runs_eagerly_on_the_cpu():
    """``compiled=None`` on a CPU model captures nothing and gives the
    eager step's bits: the same code runs."""
    batch = _batch()
    runs = []
    for compiled in (None, False):
        state = _cpu_state()
        step = ttrainer.make_train_step(compiled=compiled)
        ev = ttrainer.make_eval_step(compiled=compiled)
        logs = [step(state, batch)[1]]
        runs.append((logs, ev(state, batch["img"]),
                     [p.detach().clone() for p in state.model.parameters()]))
        assert step.graphs.captures == 0 and not step.graphs.graphs
        assert ev.graphs.captures == 0
    (la, sa, pa), (lb, sb, pb) = runs
    for a, b in zip(la, lb):
        assert all(torch.equal(a[k], b[k]) for k in a if k != "lr")
    assert torch.equal(sa, sb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert not tgraphs.capturable(None, torch.device("cpu"))
    assert not tgraphs.capturable(False, torch.device("cuda"))
    assert tgraphs.capturable(None, torch.device("cuda"))


def test_entry_points_take_compiled(monkeypatch):
    """entry(), predict() and train_entry() pass ``compiled`` on: True on
    the CPU raises, None runs eagerly."""
    fn, (model, x) = tentry.entry(device="cpu", batch=1, arch="t_tiny",
                                  size=224, dtype=torch.float32)
    logits = fn(model, x)
    assert logits.shape == (1, 80) and fn.graphs.captures == 0
    with pytest.raises(RuntimeError, match="compiled=True"):
        tentry.entry(device="cpu", arch="t_tiny", size=224,
                     compiled=True)[0](model, x)
    with pytest.raises(RuntimeError, match="compiled=True"):
        tentry.predict(model, x, compiled=True)
    scores = tentry.predict(model, x)
    assert torch.equal(scores, model.predict(logits))


# ------------------------------------- StepGraphs on a stand-in graph API


class _FakeGraph:
    """A capture records the body's computation without running it (the
    body below checks ``current``); a replay runs it on the static inputs
    and writes the results into the captured outputs, as the kernels of a
    real replay write into the graph's own memory."""

    current = None

    def __init__(self):
        self.run = self.outputs = None
        self.generators = []
        self.replays = 0

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        for out, new in zip(self.outputs, self.run()):
            out.copy_(new)
        self.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    graphs = []

    def make_graph():
        graphs.append(_FakeGraph())
        return graphs[-1]

    @contextlib.contextmanager
    def capture(graph, pool=None, stream=None):
        _FakeGraph.current = graph
        try:
            yield
        finally:
            _FakeGraph.current = None

    cuda = torch.cuda
    monkeypatch.setattr(cuda, "CUDAGraph", make_graph)
    monkeypatch.setattr(cuda, "graph", capture)
    monkeypatch.setattr(cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(cuda, "Stream", _FakeStream)
    monkeypatch.setattr(cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    return graphs


def test_step_graphs_warm_capture_replay(fake_cuda):
    """The first call of a signature runs eagerly, the second captures
    and replays once, later ones copy their inputs in and replay; the
    outputs are clones; the launch counts of every call are an eager
    call's (a capture counts once, each later replay adds what it
    counted); another shape takes its own warm-up and graph; moved state
    captures anew."""
    graphs = tgraphs.StepGraphs()
    acc = torch.zeros(3)          # persistent state, updated in place
    gen = torch.Generator()

    def body(inputs):
        knn_mr.launches += 2      # the wrappers count two launches

        def run():
            acc.add_(inputs[0].sum())
            return [acc * 1.0]

        graph = _FakeGraph.current
        if graph is None:
            return run()
        graph.run, graph.outputs = run, [torch.empty(3)]
        return graph.outputs

    knn_mr.launches = 0
    outs = []
    for i in range(4):
        x = torch.full((2,), float(i + 1))
        outs.append(graphs("k", [x], body, [acc], (gen,))[0])
        assert knn_mr.launches == 2 * (i + 1)
    assert [float(o[0]) for o in outs] == [2.0, 6.0, 12.0, 20.0]
    assert graphs.captures == 1 and len(fake_cuda) == 1
    assert fake_cuda[0].replays == 3 and fake_cuda[0].generators == [gen]
    # a short last batch: its own warm-up and graph, in the same pool
    short = graphs("k", [torch.ones(1)], body, [acc])[0]
    assert float(short[0]) == 21.0 and graphs.captures == 1
    assert float(graphs("k", [torch.ones(1)], body, [acc])[0][0]) == 22.0
    assert graphs.captures == 2 and graphs.pool == "pool"
    # the state moved (a load that replaced it): captured anew, no warm-up
    graphs("k", [torch.ones(2)], body, [torch.zeros(3)])
    assert graphs.captures == 3 and knn_mr.launches == 2 * 7
    knn_mr.launches = 0


def test_step_graphs_warm_up_in_each_thread(fake_cuda):
    """A thread captures only a signature it has run eagerly itself (its
    cuDNN and cuBLAS handles are made at its first call, and making them
    cannot be captured): a server's first request after a warm-up in
    another thread runs eagerly, its second captures; the graph then
    replays in any thread."""
    graphs = tgraphs.StepGraphs()
    calls = []

    def body(inputs):
        calls.append(_FakeGraph.current is not None)
        graph = _FakeGraph.current
        out = [inputs[0] * 2.0]
        if graph is not None:
            graph.run, graph.outputs = (lambda: [inputs[0] * 2.0]), out
        return out

    def call():
        return float(graphs("k", [torch.ones(1)], body, [])[0][0])

    assert call() == 2.0                   # the warm-up, in this thread
    worker = []
    thread = threading.Thread(target=lambda: worker.extend([call(), call()]))
    thread.start()
    thread.join()
    assert worker == [2.0, 2.0] and calls == [False, False, True]
    assert graphs.captures == 1 and call() == 2.0 and len(calls) == 3


def test_step_graphs_raise_when_the_capture_fails(fake_cuda):
    """The warm-up call runs; the capture that fails raises, with no
    eager call in its place."""
    graphs = tgraphs.StepGraphs()

    def body(inputs):
        if _FakeGraph.current is not None:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return [inputs[0] * 2.0]

    assert float(graphs("k", [torch.ones(1)], body, [])[0][0]) == 2.0
    with pytest.raises(RuntimeError, match="compiled=False runs it eagerly"):
        graphs("k", [torch.ones(1)], body, [])
    assert graphs.captures == 0 and not graphs.graphs


def test_step_graphs_check_the_first_replay(fake_cuda, monkeypatch):
    """``StepGraphs.check_replay`` runs a new graph's first replay, given
    the launches its capture counted by counter; later replays go without
    it; what it raises reaches the caller."""
    seen = []

    def check(replay, counts):
        replay()
        seen.append(counts)

    monkeypatch.setattr(tgraphs.StepGraphs, "check_replay", check)
    graphs = tgraphs.StepGraphs()

    def body(inputs):
        knn_mr.launches += 2
        knn_mr.backward_launches += 1
        out = [inputs[0] * 2.0]
        graph = _FakeGraph.current
        if graph is not None:
            graph.run, graph.outputs = (lambda: [inputs[0] * 2.0]), out
        return out

    tgraphs.reset_launch_counts()
    for _ in range(3):
        assert float(graphs("k", [torch.ones(1)], body, [])[0][0]) == 2.0
    want = dict.fromkeys(tgraphs.launch_counts(), 0)
    want.update({"knn_mr.launches": 2, "knn_mr.backward_launches": 1})
    assert seen == [want] and fake_cuda[0].replays == 2
    assert knn_mr.launches == 6 and knn_mr.backward_launches == 3

    def refuse(replay, counts):
        raise RuntimeError("the replay launched other kernels")

    monkeypatch.setattr(tgraphs.StepGraphs, "check_replay", refuse)
    with pytest.raises(RuntimeError, match="other kernels"):
        graphs("k", [torch.ones(2)], body, [])   # warm-up
        graphs("k", [torch.ones(2)], body, [])   # capture
    tgraphs.reset_launch_counts()


def test_graphs_count_every_counter_of_the_ops_modules():
    """The counters a replay is credited with are the ops modules' own
    lists, and those lists name every counter the modules keep: a counter
    added to a module and not to its COUNTERS would go uncredited."""
    from gkgnet_tpu_torch.ops import knn_topk
    for mod in (knn_mr, knn_topk):
        kept = {n for n, v in vars(mod).items()
                if n.endswith("launches") and isinstance(v, int)}
        assert kept == set(mod.COUNTERS), mod.__name__
    assert [f"{m.__name__.rpartition('.')[2]}.{n}"
            for m, n in tgraphs.COUNTERS] == list(tgraphs.launch_counts())
    knn_mr.gather_backward_launches = knn_topk.launches = 5
    tgraphs.reset_launch_counts()
    assert set(tgraphs.launch_counts().values()) == {0}
    assert set(tentry.launch_counts().values()) == {0}


# ---------------------------------- the eval step's replay path (stand-in)


@pytest.fixture
def fake_eval(fake_cuda, monkeypatch):
    """The eval step of a CPU model captured and replayed as on the card:
    the capture records the step's body, a replay runs it again on the
    static inputs, as the kernels the capture recorded (in eval mode)
    would; ``Module.train`` calls made by that stand-in for the device are
    not the program's, and ``_FakeGraph.replaying`` marks them."""
    monkeypatch.setattr(ttrainer, "capturable",
                        lambda compiled, device: compiled is not False)
    capture = tgraphs.StepGraphs._capture

    def recording(self, sig, inputs, body, ptrs, generators):
        def rec(static):
            out = body(static)
            graph = _FakeGraph.current

            def run():
                _FakeGraph.replaying = True
                try:
                    return [body(static)]
                finally:
                    _FakeGraph.replaying = False

            graph.run, graph.outputs = run, [out]
            return out

        return capture(self, sig, inputs, rec, ptrs, generators)

    monkeypatch.setattr(tgraphs.StepGraphs, "_capture", recording)
    monkeypatch.setattr(_FakeGraph, "replaying", False, raising=False)
    return fake_cuda


def _images(n: int) -> list:
    rng = np.random.default_rng(5)
    return [_t(rng.standard_normal((2, 128, 128, 3))) for _ in range(n)]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_eval_replay_sets_no_mode_and_walks_no_modules(fake_eval,
                                                       monkeypatch, training):
    """Warm-up and capture run the forward in eval mode and walk the
    model's modules once (one rebuild, no hit); each replay after them
    calls no ``Module.train`` on the model and counts one hit; the model
    leaves every call in the mode it came in; the scores are bitwise the
    eager step's, on new images too."""
    state = _cpu_state()
    model = state.model.train(training)
    imgs = _images(3)
    eager = ttrainer.make_eval_step(compiled=False)
    want = [eager(state, x) for x in imgs]
    assert model.training == training
    calls = []
    train = torch.nn.Module.train

    def spy(self, mode=True):
        if self is model and not _FakeGraph.replaying:
            calls.append(mode)
        return train(self, mode)

    monkeypatch.setattr(torch.nn.Module, "train", spy)
    step = ttrainer.make_eval_step()
    for i, x in enumerate(imgs[:1] * 2 + imgs):   # warm-up, capture, replays
        before = len(calls)
        got = step(state, x)
        assert torch.equal(got, want[max(i - 2, 0)]), i
        assert model.training == training
        replayed = i >= 2
        assert (len(calls) == before) == replayed, i
        assert step.graphs.captures == (i >= 1)
        assert (step.prepared.rebuilds, step.prepared.hits) == \
            (1, max(i - 1, 0))
    assert calls == [False, training] * 2
    assert len(fake_eval) == 1 and fake_eval[0].replays == 4


def _replace_param(state):
    state.model.head.fc2.bias = torch.nn.Parameter(
        state.model.head.fc2.bias.detach() + 1.0)


def _load_assign(state):
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    sd["head.fc2.bias"] += 1.0
    state.model.load_state_dict(sd, assign=True)


def _replace_buffer(state):
    bn = state.model.backbone.gcn_label[3][0].ffn.fc2[1]
    bn.running_var = bn.running_var * 4.0


def _replace_ema(state):
    ema = {k: v.clone() for k, v in state.ema_params.items()}
    ema["head.fc2.bias"] += 1.0
    state.ema_params = ema


def _move(state):
    """What ``.to()`` does to a model whose tensors change place: the
    parameters' data swapped, the buffers replaced in their modules'
    dictionaries (no registration hook sees either); then a statistic
    changed in its new place."""
    state.model._apply(lambda t: t.clone())
    state.model.backbone.gcn_label[3][0].ffn.fc2[1].running_var.mul_(4.0)


@pytest.mark.parametrize("change", [_replace_param, _load_assign,
                                    _replace_buffer, _replace_ema, _move],
                         ids=["param", "load_assign", "buffer", "ema",
                              "moved"])
def test_eval_replay_recaptures_when_the_state_changes(fake_eval, change):
    """A parameter or buffer replaced, a load with ``assign=True``, a new
    ``ema_params`` dict under ``use_ema`` or tensors moved as ``.to()``
    moves them: the next call captures anew and answers from the new
    state, bitwise the eager step's on it, and the call after replays."""
    use_ema = change is _replace_ema
    model = GKGNetClassifier(**TINY)
    init_parameters(model, torch.Generator().manual_seed(0))
    state = ttrainer.create_train_state(
        model, toptim.build_optimizer(model, 1e-3), ema=use_ema)
    x = _images(1)[0]
    step = ttrainer.make_eval_step(use_ema=use_ema)
    eager = ttrainer.make_eval_step(use_ema=use_ema, compiled=False)
    old = eager(state, x)
    for _ in range(3):
        assert torch.equal(step(state, x), old)
    assert step.graphs.captures == 1 and step.prepared.hits == 1
    change(state)
    new = eager(state, x)
    assert not torch.equal(new, old)
    assert torch.equal(step(state, x), new)
    assert step.graphs.captures == 2 and step.prepared.hits == 1
    assert torch.equal(step(state, x), new)
    assert step.graphs.captures == 2 and step.prepared.hits == 2
    assert step.prepared.rebuilds == (
        2 if change in (_replace_param, _load_assign, _replace_buffer)
        else 1)


def test_model_tensors_follow_the_modules_and_keep_no_model_alive():
    """``ModelTensors`` gives the tensors ``parameters()`` and
    ``buffers()`` give, those that replaced others in their modules (as
    ``.to()`` replaces them) with no walk, walks again after a module is
    added, replaced or taken out, and does not keep a model alive."""
    import gc
    import weakref

    model = GKGNetClassifier(**TINY)
    tensors = tgraphs.ModelTensors()

    def ids(ts):
        return sorted(map(id, ts))

    want = ids(list(model.parameters()) + list(model.buffers()))
    assert ids(tensors(model)[0]) == want
    assert tensors(model)[1] and tensors.rebuilds == 1
    model.eval()
    model.train()
    assert tensors(model)[1]            # a mode set registers nothing
    model._apply(lambda t: t.clone())   # as .to() replaces the buffers
    got, kept = tensors(model)
    assert kept and ids(got) == ids(list(model.parameters())
                                    + list(model.buffers())) != want
    model.head.fc2 =torch.nn.Linear(model.head.fc2.in_features,
                                     model.head.fc2.out_features)
    got, kept = tensors(model)
    assert not kept and ids(got) == ids(list(model.parameters())
                                        + list(model.buffers()))
    del model.backbone.gcn_label[3]
    got, kept = tensors(model)
    assert not kept and tensors.rebuilds == 3
    assert ids(got) == ids(list(model.parameters()) + list(model.buffers()))
    ref = weakref.ref(model)
    del model, got
    gc.collect()
    assert ref() is None


def test_device_normalize_builds_its_constants_once_per_device():
    """The normalize makes ``mean`` and ``1 / std`` at a device's first
    uint8 batch and keeps them: one build per device over many batches,
    none for float batches, and each output bitwise the product that
    made both anew at every call."""
    mean, std = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    norm = ttrainer.make_device_normalize((mean, std))
    rng = np.random.default_rng(6)
    for _ in range(3):
        img = torch.from_numpy(rng.integers(0, 256, (2, 8, 8, 3),
                                            dtype=np.uint8))
        want = (img.float() - torch.tensor(mean, dtype=torch.float32)) \
            * (1.0 / torch.tensor(std, dtype=torch.float32))
        assert torch.equal(norm(img), want)
    f = img.float()
    assert norm(f) is f and norm.builds == 1
    meta = norm(torch.empty((2, 8, 8, 3), dtype=torch.uint8, device="meta"))
    assert meta.device.type == "meta" and meta.dtype == torch.float32
    assert norm.builds == 2


# ------------------------------------------- saves of earlier optimizers


def _earlier_save(kind: str, model: torch.nn.Module, ours) -> dict:
    """The optimizer state a save of this package's earlier optimizers
    holds after one step: torch's AdamW and SGD (momentum 0.9) over our
    groups, and the earlier Lamb's layout (mu, nu, a host int step)."""
    groups = [{"params": g["params"], "weight_decay": g["weight_decay"]}
              for g in ours.param_groups]
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    if kind == "adamw":
        opt = torch.optim.AdamW(groups, lr=1e-3)
    elif kind == "sgd":
        opt = torch.optim.SGD(groups, lr=1e-3, momentum=0.9)
    else:
        params = [p for g in groups for p in g["params"]]
        sd = {"state": {i: {"step": 1, "mu": torch.full_like(p, 0.05),
                            "nu": torch.full_like(p, 2.5e-4)}
                        for i, p in enumerate(params)},
              "param_groups": [
                  dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                       weight_decay=g["weight_decay"],
                       params=list(range(i, i + len(g["params"]))))
                  for i, g in zip((0, len(groups[0]["params"])), groups)]}
        return sd
    opt.step()
    return opt.state_dict()


@pytest.mark.parametrize("kind", ["adamw", "lamb", "sgd"])
def test_optimizer_restores_a_save_of_the_earlier_optimizers(kind):
    """A save of the earlier optimizers' state loads into this package's:
    the moments under their names here (exp_avg/exp_avg_sq as mu/nu,
    momentum_buffer as trace), the step count an fp32 tensor, and the
    next step runs and counts on from it."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                torch.nn.BatchNorm1d(3))
    ours = toptim.build_optimizer(model, 1e-3, optimizer=kind)
    saved = _earlier_save(kind, model, ours.optimizer)
    ours.optimizer.load_state_dict(saved)
    params = ours.params  # in the groups' order, as the save numbers them
    for i, p in enumerate(params):
        st, old = ours.optimizer.state[p], saved["state"][i]
        if kind == "sgd":
            assert set(st) == {"trace"}
            assert torch.equal(st["trace"], old["momentum_buffer"])
            continue
        assert set(st) == {"step", "mu", "nu"}
        assert st["step"].dtype == torch.float32 and float(st["step"]) == 1
        assert torch.equal(st["mu"], old.get("exp_avg", old.get("mu")))
        assert torch.equal(st["nu"], old.get("exp_avg_sq", old.get("nu")))
    before = [p.detach().clone() for p in params]
    ours.update(1)
    assert any(not torch.equal(p, b) for p, b in zip(params, before))
    if kind != "sgd":
        assert {float(ours.optimizer.state[p]["step"])
                for p in params} == {2.0}
