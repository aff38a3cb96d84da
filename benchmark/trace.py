"""The profiler reader: a bounded stretch of the cell's own calls under
``torch.profiler`` (host and device activity), reduced in memory to what
the per-layer metrics read.

  * ``owners(events)``: from the op tree of an eager call of the same step,
    which registered operator of the program launched each kernel name: a
    kernel counts as ``(operator, "fwd")`` when an enclosing host op is
    ``<namespace>::<operator>`` or the autograd function's forward
    ``GeneratedBackwardFor_<namespace>_<operator>_default``, and as
    ``(operator, "bwd")`` inside that function's ``...Backward`` node. A
    name counts only where every launch of it in the eager call lies under
    that one owner, so a generic kernel that the rest of the step also
    launches is never credited to an operator. The map is by name and
    holds for the graphed stretch, whose replays run no host code;
  * ``Stretch``: the device events of the stretch (kernels, copies, sets),
    the stretch's host span, the busy time (the union of the device
    events) and the breakdown: the device operations that took most time,
    and the idle gaps by the innermost host op running at each gap's
    middle.
"""

from __future__ import annotations

import bisect
import re

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

NAMESPACE = "gkgnet_tpu_torch"
_FWD = re.compile(rf"(?:^|\s){NAMESPACE}::(\w+)$")
_FN = re.compile(rf"GeneratedBackwardFor_{NAMESPACE}_(\w+?)_default"
                 r"(Backward)?\b")
STRETCH = "bench.stretch"
NAME_CHARS = 160


def profiled(fn):
    """Runs ``fn()`` under the profiler (host and CUDA activity); returns
    the profiler's events."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.events()


def _owner(event) -> tuple[str, str] | None:
    while event is not None:
        hit = _FWD.search(event.name)
        if hit:
            return hit.group(1), "fwd"
        hit = _FN.search(event.name)
        if hit:
            return hit.group(1), "bwd" if hit.group(2) else "fwd"
        event = event.cpu_parent
    return None


def owners(events) -> dict[str, tuple[str, str]]:
    """Kernel name -> (operator, "fwd" | "bwd") for the names that only an
    operator launched (see the module's docstring)."""
    seen: dict[str, set] = {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        for k in e.kernels:
            seen.setdefault(k.name, set()).add(_owner(e))
    return {name: next(iter(who)) for name, who in seen.items()
            if len(who) == 1 and None not in who}


class Stretch:
    """The device events of one profiled stretch of calls."""

    def __init__(self, events, items: int, images: int):
        self.items, self.images = items, images
        span = [e for e in events if e.name == STRETCH
                and e.device_type == DeviceType.CPU]
        # a host range's device-side annotation carries the range's name:
        # it is no device operation
        host_names = {e.name for e in events
                      if e.device_type == DeviceType.CPU}
        if len(span) != 1:
            raise RuntimeError(f"the profile holds {len(span)} stretch spans")
        lo, hi = span[0].time_range.start, span[0].time_range.end
        self.window_s = (hi - lo) * 1e-6
        self.device = []   # (name, start us, end us), by start
        self.host = []     # (name, start us, end us) of host ops
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if start >= lo and end <= hi and e.name not in host_names:
                    self.device.append((e.name, start, end))
            elif e.device_type == DeviceType.CPU and lo <= start \
                    and end <= hi and e.name != STRETCH:
                self.host.append((e.name, start, end))
        self.device.sort(key=lambda r: r[1])
        self.lo, self.hi = lo, hi
        self.busy_s, self.gaps = self._busy()

    def _busy(self):
        busy, gaps = 0.0, []
        cur_s = cur_e = None
        last = self.lo
        for _, s, e in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                if s > last:
                    gaps.append((last, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            last = max(last, cur_e)
        if cur_e is not None:
            busy += cur_e - cur_s
        if self.hi > last:
            gaps.append((last, self.hi))
        return busy * 1e-6, gaps

    def device_seconds(self, names=None) -> float:
        """Seconds of the device events, of those named in ``names`` if
        given."""
        return 1e-6 * sum(e - s for n, s, e in self.device
                          if names is None or n in names)

    def breakdown(self) -> dict:
        ops: dict[str, float] = {}
        for n, s, e in self.device:
            ops[n[:NAME_CHARS]] = ops.get(n[:NAME_CHARS], 0.0) + (e - s) * 1e-6
        idle: dict[str, float] = {}
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        for s, e in self.gaps:
            mid = 0.5 * (s + e)
            label = "none"
            # the innermost host op over the gap's middle: the latest
            # started one that still runs
            for i in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 400),
                           -1):
                if host[i][2] >= mid:
                    label = host[i][0]
                    break
            label = label[:NAME_CHARS]
            idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def stretch(calls, items: int, images: int) -> Stretch:
    """Profiles ``calls()`` (which makes ``items`` calls of ``images``
    images in all) inside the ``bench.stretch`` span."""
    def run():
        torch.cuda.synchronize()
        with record_function(STRETCH):
            calls()
            torch.cuda.synchronize()
    return Stretch(profiled(run), items, images)
