"""Whole-step CUDA graphs: the port's counterpart of ``jax.jit`` (the JAX
package jits its train step, ``gkgnet_tpu/core/trainer.py:196``, and its
eval step, ``:243``).

``StepGraphs`` keeps, for one step function, one ``torch.cuda.CUDAGraph``
per signature (a key the caller gives, such as the model and the eval's
``use_ema``, and the shape, dtype and device of every input), as
``jax.jit`` keeps one executable per signature:

  * the first call of a signature in each thread runs the step eagerly
    on a side stream (PyTorch's whole-network capture recipe: lazy
    set-ups, the kernels' builds and the optimizer's state happen there,
    and the thread's own cuDNN and cuBLAS handles, whose creation
    allocates device memory and cannot be captured: a server captures in
    the thread that answers its requests). It is a real step;
  * the next call copies its inputs into static buffers, captures the step
    into a graph and replays it once: capture takes no extra step, so n
    calls give the state that n eager calls give;
  * later calls copy their inputs into the static buffers and replay.
    The outputs are cloned, so the next replay cannot overwrite what the
    caller keeps.

The graphs of one ``StepGraphs`` share one memory pool, so a short last
batch's graph does not double the memory. The step must read no tensor's
value on the host (no ``bool()``, ``.item()``, ``.tolist()`` or Python
branch on a value) and must update its persistent state in place: a graph
reads and writes the addresses it was captured with. A train step's
capture also needs every autograd graph of an earlier eager step on
another stream freed: while one is alive, the parameters keep its
gradient accumulators, which run on that step's stream. Each call therefore
checks the addresses of the state it was given (``live``) and captures
anew when they moved (a load that replaced a tensor). Random draws come
from the generators the caller registers: re-seeded on the host before a
replay, a registered generator gives the draws an eager call would.

``ModelTensors`` gives a model's parameters and buffers without a walk of
its modules on every call (``list(model.parameters())`` over GKGNet-S's
421 modules takes 1-2 ms of host time): it keeps the dictionaries its
modules hold them in and reads them on each call, so a tensor replaced,
added or removed in a module shows at once; it walks the modules again
after any module, parameter or buffer is registered in the process
(PyTorch's global registration hooks count them) or a module is taken out
of its parent.

The kernels' launch counters (``knn_mr.launches`` and the rest, which
each ops module lists in its ``COUNTERS``) are Python integers that a
capture advances once; each replay adds what its capture counted, so the
counts stay those of eager calls. ``StepGraphs.check_replay``, where set,
runs each new graph's first replay and holds the kernels it launched to
those counts (``chip_smoke.py`` profiles it).

A capture launches the device spans' markers (``utils/profiling.py``
``span``) as nodes of its graph, at most ``profiling.MAX_MARKERS``; a
signature's first call and its capture are timed in the set-up table
(``graph.warm``, ``graph.capture``, each to the host's return), and each
call's host work is in the host ranges ``graph.check``, ``graph.copy_in``,
``graph.replay`` and ``graph.copy_out`` while a profiler runs.

``capturable(compiled, device)`` decides: ``compiled=False`` runs
eagerly; ``None`` captures a step of a CUDA model in a world of one rank
and runs the rest eagerly (a CPU model, the tests' path; a step over a
world of ranks, whose collectives go through host buffers); ``True``
raises where it cannot capture. A capture that fails raises.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, NamedTuple

import torch
from torch.nn.modules import module as _module

from gkgnet_tpu_torch.ops import knn_mr, knn_topk
from gkgnet_tpu_torch.parallel.sharding import active_graph_cfg
from gkgnet_tpu_torch.utils import profiling

# the kernels' launch counters, (module, attribute)
COUNTERS = tuple((mod, name) for mod in (knn_mr, knn_topk)
                 for name in mod.COUNTERS)


def launch_counts() -> dict[str, int]:
    """The counters by ``module.attribute`` (``knn_mr.launches``, ...)."""
    return {f"{mod.__name__.rpartition('.')[2]}.{name}": getattr(mod, name)
            for mod, name in COUNTERS}


def reset_launch_counts() -> None:
    for mod, name in COUNTERS:
        setattr(mod, name, 0)


def _add_counts(delta: dict[str, int]) -> None:
    for (mod, name), n in zip(COUNTERS, delta.values()):
        setattr(mod, name, getattr(mod, name) + n)


def world_size() -> int:
    """The ranks a step spans: the active graph sharding's world, else the
    initialized process group's, else 1."""
    cfg = active_graph_cfg()
    world = cfg.mesh.world if cfg is not None else 1
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        world = max(world, dist.get_world_size())
    return world


def capturable(compiled: bool | None, device: torch.device) -> bool:
    """Whether a step of a model on ``device`` runs as CUDA graphs."""
    if compiled is False:
        return False
    if world_size() > 1:
        reason = ("the step spans a world of more than one rank, and its "
                  "collectives go through host buffers")
    elif device.type != "cuda":
        reason = f"the model is on {device}, not on a CUDA device"
    else:
        return True
    if compiled:
        raise RuntimeError(f"compiled=True: a CUDA graph cannot capture this "
                           f"step: {reason}")
    return False


# registrations of a module, parameter or buffer in any module of the
# process (an assignment to an attribute of that kind included)
_registrations = 0


def _registered(module, name, value) -> None:
    global _registrations
    _registrations += 1


for _hook in (_module.register_module_module_registration_hook,
              _module.register_module_parameter_registration_hook,
              _module.register_module_buffer_registration_hook):
    _hook(_registered)


class _Layout(NamedTuple):
    registrations: int            # the count when the modules were walked
    tensors: list[dict]           # the modules' non-empty tensor dicts
    children: list[dict]          # the modules' non-empty child dicts
    n_children: int               # their entries when walked


class ModelTensors:
    """Called with a model: its parameters and buffers, read from its
    modules' dictionaries, which are kept between calls (see the module's
    docstring). ``rebuilds`` counts the walks; ``hits`` is the
    caller's count of the calls the kept state served. No model is kept
    alive: the dictionaries hold its submodules and tensors, not itself."""

    def __init__(self):
        self._layouts: weakref.WeakKeyDictionary = \
            weakref.WeakKeyDictionary()
        self.rebuilds = 0
        self.hits = 0

    def __call__(self, model: torch.nn.Module
                 ) -> tuple[list[torch.Tensor], bool]:
        """``(tensors, kept)``: ``kept`` is False when this call walked
        the modules."""
        lay = self._layouts.get(model)
        kept = lay is not None and lay.registrations == _registrations \
            and sum(map(len, lay.children)) == lay.n_children
        if not kept:
            registrations = _registrations  # before the walk: a
            mods = list(model.modules())    # registration during it counts
            children = [m._modules for m in mods if m._modules]
            lay = _Layout(registrations,
                          [d for m in mods for d in (m._parameters,
                                                     m._buffers) if d],
                          children, sum(map(len, children)))
            self._layouts[model] = lay
            self.rebuilds += 1
        return [t for d in lay.tensors for t in d.values()
                if t is not None], kept


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]    # the static input buffers
    outputs: object               # the graph's outputs (tensors in a pytree)
    live: tuple[int, ...]         # the state's addresses at capture
    counts: dict[str, int]        # the launch counts the capture added
    markers: int                  # the span markers the graph holds


class Found(NamedTuple):
    sig: tuple
    ptrs: tuple[int, ...]
    cap: _Captured | None


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_clone(v) for v in out)
    return out


class StepGraphs:
    """The CUDA graphs of one step function (see the module's docstring)."""

    # ``check_replay(replay, counts)``, where set, runs each new graph's
    # first replay (the capture's own step: ``replay()``) and holds the
    # kernels it launched to ``counts``, the launches the capture counted,
    # with which every later replay is credited
    check_replay: Callable[[Callable[[], None], dict[str, int]],
                           None] | None = None

    def __init__(self):
        self.graphs: dict[tuple, _Captured] = {}
        self.warmed: set[tuple] = set()  # (signature, thread)
        self.captures = 0
        self.pool = None
        self._stream: torch.cuda.Stream | None = None

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def __call__(self, key, inputs: list[torch.Tensor],
                 body: Callable[[list[torch.Tensor]], object],
                 live: list[torch.Tensor],
                 generators: tuple[torch.Generator, ...] = ()):
        """``body(inputs)`` as a graph: eagerly while the signature warms
        up, then captured and replayed. ``live``: the persistent tensors
        the step reads or writes (parameters, buffers, optimizer state);
        ``generators``: the generators its draws come from."""
        return self.run(self.find(key, inputs, live), inputs, body,
                        generators)

    def find(self, key, inputs: list[torch.Tensor],
             live: list[torch.Tensor]) -> Found:
        """The call's signature, the state's addresses and the graph that
        replays the call: None where the signature has none yet or the
        state's tensors moved since its capture (it is then dropped)."""
        with profiling.host_span("graph.check"):
            sig = (key,) + tuple((tuple(t.shape), t.dtype, t.device)
                                 for t in inputs)
            ptrs = tuple(t.data_ptr() for t in live)
            cap = self.graphs.get(sig)
            if cap is not None and cap.live != ptrs:
                del self.graphs[sig]  # the state's tensors moved: capture anew
                cap = None
        return Found(sig, ptrs, cap)

    def run(self, found: Found, inputs: list[torch.Tensor],
            body: Callable[[list[torch.Tensor]], object],
            generators: tuple[torch.Generator, ...] = ()):
        """``__call__`` after its ``find``."""
        sig, ptrs, cap = found
        if cap is None:
            warm = (sig, threading.get_ident())
            if warm not in self.warmed:
                self.warmed.add(warm)
                with profiling.timed("graph.warm"):
                    return self._eager(inputs, body)
            with profiling.timed("graph.capture"):
                cap = self._capture(sig, inputs, body, ptrs, generators)
        else:
            with profiling.host_span("graph.copy_in"):
                for buf, t in zip(cap.inputs, inputs):
                    buf.copy_(t)
            with profiling.host_span("graph.replay"):
                cap.graph.replay()
                _add_counts(cap.counts)
        with profiling.host_span("graph.copy_out"):
            return _clone(cap.outputs)

    def _eager(self, inputs, body):
        side, ambient = self._side_stream(), torch.cuda.current_stream()
        side.wait_stream(ambient)
        with torch.cuda.stream(side):
            out = body(inputs)
        ambient.wait_stream(side)
        return out

    def _capture(self, sig, inputs, body, ptrs, generators) -> _Captured:
        static = [torch.empty_like(t).copy_(t) for t in inputs]
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if torch.cuda.is_available():
            profiling.load_markers()
        before, marked = launch_counts(), profiling.marker_launches
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=self._side_stream()):
                outputs = body(static)
        except Exception as e:
            raise RuntimeError(
                "capturing the step as a CUDA graph failed (compiled=False "
                "runs it eagerly); the step must read no tensor's value on "
                "the host and copy nothing from unpinned host memory, and no "
                "autograd graph of an earlier step on another stream may "
                "still be alive (its parameters' gradient accumulators run "
                "on that stream)") from e
        after = launch_counts()
        counts = {k: after[k] - before[k] for k in after}
        markers = profiling.marker_launches - marked
        if markers > profiling.MAX_MARKERS:
            raise RuntimeError(f"the captured step holds {markers} span "
                               f"markers, more than "
                               f"{profiling.MAX_MARKERS}")
        cap = _Captured(graph, static, outputs, ptrs, counts, markers)
        self.graphs[sig] = cap
        self.captures += 1
        # the call's own step: the capture only recorded it
        if StepGraphs.check_replay is None:
            graph.replay()
        else:
            StepGraphs.check_replay(graph.replay, counts)
        return cap
