"""The program's own spans in a traced stretch (``trace.Stretch``), for the
per-layer metrics that read them:

  * device spans: the port launches two empty kernels,
    ``gkgnet_span_begin_<name>`` and ``gkgnet_span_end_<name>``, into each
    CUDA graph it captures around each of its device spans
    (``gkgnet_tpu_torch/utils/profiling.py``), so every replay runs them in
    stream order. A span's device time is the time of the other device
    operations that start between a begin marker and its end marker;
  * host spans: the port's host ranges are named ``gkgnet.<name>``. The
    idle time they explain is the part of the stretch's gaps (no device
    operation running) that overlaps any of them.

Each function returns None where the stretch holds none of what it reads
(a program without these spans).
"""

from __future__ import annotations

import bisect

MARKER = "gkgnet_span_"
BEGIN, END = MARKER + "begin_", MARKER + "end_"
HOST = "gkgnet."


def device_seconds(st, name: str) -> float | None:
    """Seconds of the non-marker device operations inside the device span
    ``name`` (nested spans of the same name count once); None without a
    closed pair of its markers."""
    begin, end = BEGIN + name, END + name
    depth = pairs = 0
    total = 0.0
    for n, s, e in st.device:
        if n == begin:
            depth += 1
        elif n == end:
            if depth:
                depth -= 1
                pairs += 1
        elif depth and not n.startswith(MARKER):
            total += e - s
    return total * 1e-6 if pairs else None


def _union(ranges: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def host_idle_seconds(st) -> float | None:
    """Seconds of the stretch's idle gaps that overlap a host range named
    ``gkgnet.*``; None where there is no such range."""
    spans = _union([(s, e) for n, s, e in st.host if n.startswith(HOST)])
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for lo, hi in st.gaps:
        i = max(0, bisect.bisect_right(starts, lo) - 1)
        while i < len(spans) and spans[i][0] < hi:
            total += max(0.0, min(hi, spans[i][1]) - max(lo, spans[i][0]))
            i += 1
    return total * 1e-6
