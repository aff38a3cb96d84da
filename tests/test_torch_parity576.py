"""GKGNet-S@576 on the CPU in fp32, JAX against the port, after PreciseBN in
both packages (ROADMAP.md queue 3 item 2: not a fault).

The JAX init is carried into the port; ``precise_bn`` recomputes the
running statistics in each package over the same 4 seeded batches of 2, and
both record the graph of every graph conv in those train-mode forwards.
The graphs agree but for flipped rows: a neighbour that one side ranks k-th
and the other (k+1)-th at an fp32 gap of a few ulp. The first graph conv
already flips 1-7 of its 82944 rows; the share grows with depth (under 3 %
in stages 1-2, every row from the second conv of stage 3 on). A flip
changes the row's max-relative aggregate by O(1), so each BatchNorm
statistic differs between the packages by at most the share of rows whose
graph flipped upstream of it, and by fp32 rounding alone before the first
flip. The eval logits then differ by as much as the port's own differ when
the image moves by one ulp: the forward is chaotic in fp32 at these widths.
The logit gaps are printed, not asserted. ~90 s and ~4 GB on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gkgnet_tpu.nn.grapher as jax_grapher
import gkgnet_tpu_torch.nn.grapher as grapher
from gkgnet_tpu.core.builder import build_model as jax_build_model
from gkgnet_tpu.core.hooks import precise_bn as jax_precise_bn
from gkgnet_tpu.core.trainer import create_train_state
from gkgnet_tpu_torch.core.builder import build_model
from gkgnet_tpu_torch.core.hooks import precise_bn
from gkgnet_tpu_torch.nn.layers import BatchNorm
from gkgnet_tpu_torch.utils.weights import (load_jax_variables,
                                            state_dict_from_jax)

CFG = dict(arch="s", k=9, k_label_gcn=9, num_group=2, drop_path=0.0,
           n_classes=80, size=576, num_gcn=1, dtype="float32")
# a statistic before the first flip: the same graphs, fp32 sums in other
# orders over 1e5-1e6 elements (measured up to 6e-7); a mean in units of
# its layer's largest standard deviation, a variance of its largest variance
PRE_FLIP_TOL = 1e-5
# after flips, each statistic's gap is at most PRE_FLIP_TOL plus FLIP_GAIN
# x the largest share of flipped rows among the graph convs before it, in
# any batch (measured up to 0.78 x: one flipped label row of 320, block 0's
# label conv)
FLIP_GAIN = 1.0


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(a).max())


def _rows(idx):
    """One sorted neighbour set per row: ``(rows, k)``."""
    idx = np.asarray(idx)
    return np.sort(idx.reshape(-1, idx.shape[-1]), axis=1)


@pytest.mark.slow
def test_s576_precise_bn_statistics_differ_only_by_graph_flips(
        monkeypatch):
    torch.set_num_threads(6)
    jmodel = jax_build_model(CFG)
    state = jax.jit(lambda x: create_train_state(
        jmodel, jax.random.PRNGKey(0), x, optax.sgd(1e-3)))(
            jnp.zeros((1, 576, 576, 3)))
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((2, 576, 576, 3)).astype(np.float32)
               for _ in range(4)]
    image = np.random.default_rng(1).standard_normal(
        (1, 576, 576, 3)).astype(np.float32)

    # JAX: every graph conv's dilated edges, tagged in trace order (one
    # trace, one execution per batch)
    jax_graphs: list[list[np.ndarray]] = []
    dilate = jax_grapher.dilate_edges

    def record(tag, idx):
        jax_graphs[tag].append(np.asarray(idx))

    def recording_dilate(idx, **kw):
        out = dilate(idx, **kw)
        jax_graphs.append([])
        jax.debug.callback(functools.partial(record, len(jax_graphs) - 1),
                           out)
        return out

    with monkeypatch.context() as m:
        m.setattr(jax_grapher, "dilate_edges", recording_dilate)
        jstate = jax_precise_bn(jmodel, state,
                                [{"img": jnp.asarray(b)} for b in batches])
        jax.effects_barrier()
    want = np.asarray(jax.jit(lambda s, x: jmodel.apply(
        {"params": s.params, "batch_stats": s.batch_stats,
         "constants": s.constants}, x, train=False)[0])(
             jstate, jnp.asarray(image)))

    # the port: the same graphs, and the order in which the BatchNorms
    # and graph convs run
    model = build_model(CFG)
    load_jax_variables(model, {"params": state.params,
                               "batch_stats": state.batch_stats})
    graphs, events = [], []
    build = grapher._build_edges

    def recording_build(*a, **kw):
        idx, maxrel = build(*a, **kw)
        events.append(("graph", len(graphs) % len(jax_graphs)))
        graphs.append(idx.numpy())
        return idx, maxrel

    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            mod.register_forward_hook(
                lambda mod, i, o, name=name: events.append(("bn", name)))
    with monkeypatch.context() as m:
        m.setattr(grapher, "_build_edges", recording_build)
        assert precise_bn(model, batches) == 4
    calls = len(jax_graphs)
    assert calls >= 16 and len(graphs) == 4 * calls
    assert all(len(g) == 4 for g in jax_graphs)

    # each graph conv's share of flipped rows (the largest over the batches)
    share = []
    for tag in range(calls):
        flipped = [(_rows(jax_graphs[tag][b])
                    != _rows(graphs[b * calls + tag])).any(axis=1)
                   for b in range(4)]
        share.append(max(float(f.mean()) for f in flipped))
    stats = {k: v.numpy() for k, v in state_dict_from_jax(
        {"batch_stats": jstate.batch_stats}).items()}
    sd = model.state_dict()

    def gap(name):
        mean, var = (f"{name}.running_{s}" for s in ("mean", "var"))
        scale = float(np.sqrt(stats[var].max()))
        return max(float(np.abs(stats[mean] - sd[mean].numpy()).max())
                   / scale, _rel(stats[var], sd[var].numpy()))

    # walk one forward in order: each BatchNorm against the flips before it
    upstream, rows, seen = 0.0, [], set()
    for kind, what in events:
        if kind == "graph":
            upstream = max(upstream, share[what])
        elif what not in seen:
            seen.add(what)
            rows.append((what, upstream, gap(what)))
    assert len(rows) == len({k.rsplit(".", 1)[0] for k in stats})

    x = torch.from_numpy(image)
    with torch.no_grad():
        got = model.eval()(x)[0].numpy()
        moved = model(torch.nextafter(x, torch.full_like(x, np.inf)))[0]
    chaos = _rel(got, moved.numpy())
    pre = [g for _, s, g in rows if s == 0.0]
    print(f"flipped share per graph conv {[f'{s:.2e}' for s in share]}; "
          f"{len(pre)} BatchNorms before the first flip, largest gap "
          f"{max(pre):.3e}; largest gap / (tol + upstream share) "
          f"{max(g / (PRE_FLIP_TOL + s) for _, s, g in rows):.3f}; "
          f"max|logit| {np.abs(want).max():.3e}, JAX vs port "
          f"{_rel(want, got):.3e}, the port vs itself one ulp away "
          f"{chaos:.3e}")
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert 0.0 < share[0] < 1e-3 and len(pre) >= 3
    for name, s, g in rows:
        assert g <= PRE_FLIP_TOL + FLIP_GAIN * s, (name, s, g)
    assert chaos > 0.05
