"""The measured windows, one per kind of traffic, and the benchmark's own
spans around each call into a layer.

Every window starts after a ``synchronize()``, drives the system for the
given seconds of host time and ends at the ``synchronize()`` after its
last call; nothing in it reads a value back on the host except the
serving client's scores, which are the request's answer. ``Spans`` keeps
per name the count, total and longest host seconds of the harness's calls
(``input``, ``step``, ``fetch``, ``sync``) in memory.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch
from torch.profiler import record_function


class Spans:
    def __init__(self):
        self.table: dict[str, list] = {}

    @contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        with record_function(f"bench.{name}"):
            yield
        dt = time.perf_counter() - t
        row = self.table.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += dt
        row[2] = max(row[2], dt)

    def summary(self) -> dict:
        return {k: {"count": n, "total_s": tot, "max_s": mx}
                for k, (n, tot, mx) in self.table.items()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _closed_loop(device, seconds: float | None, spans: Spans, call,
                 count: int | None = None) -> dict:
    """``call(i)`` for i = 0, 1, ... until ``seconds`` of host time have
    passed (at least once), or ``count`` times, then a synchronize. Returns
    the calls made, the window's seconds and each call's value."""
    sync(device)
    t0 = time.perf_counter()
    outs = []
    while True:
        outs.append(call(len(outs)))
        if len(outs) == count or (count is None
                                  and time.perf_counter() - t0 >= seconds):
            break
    with spans.span("sync"):
        sync(device)
    return {"calls": len(outs), "seconds": time.perf_counter() - t0,
            "outputs": outs}


def train_window(system, pool: dict, seconds: float | None, first: int,
                 spans: Spans, device, count: int | None = None) -> dict:
    """Train steps on the pool's batches (``img`` uint8, ``gt``) in turn,
    starting at batch ``first``; the outputs are the losses (unread)."""
    n = len(pool["img"])

    def call(i):
        j = (first + i) % n
        with spans.span("step"):
            return system.train_step(pool["img"][j], pool["gt"][j])

    return _closed_loop(device, seconds, spans, call, count)


def eval_window(system, pool: dict, seconds: float | None, first: int,
                spans: Spans, device, count: int | None = None) -> dict:
    """Eval steps on the pool's fp32 batches in turn; the outputs are the
    scores on the card, with the pool index of each."""
    n = len(pool["img"])

    def call(i):
        j = (first + i) % n
        with spans.span("step"):
            return j, system.eval_step(pool["img"][j])

    return _closed_loop(device, seconds, spans, call, count)


def serve_window(system, pool: dict, seconds: float | None, first: int,
                 spans: Spans, device, count: int | None = None) -> dict:
    """One client: each request hands a host image to ``predict`` and ends
    when its scores are on the host. The outputs are ``(pool index, host
    scores, latency seconds)``."""
    n = len(pool["img"])

    def call(i):
        j = (first + i) % n
        t = time.perf_counter()
        with spans.span("step"):
            scores = system.predict(pool["img"][j])
        with spans.span("fetch"):
            host = scores.cpu()
        return j, host, time.perf_counter() - t

    return _closed_loop(device, seconds, spans, call, count)


WINDOWS = {"train": train_window, "eval": eval_window,
           "serve": serve_window}
