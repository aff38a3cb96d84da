"""Shared pieces of the benchmark's tests: the repository root on the
path, one torch thread per test process, and a tiny stand-in of every cell
(GKGNet-T at 128 with k 3, batches of 2) for runs of the harness on the
CPU."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

TINY_MODEL = dict(arch="t", size=128, k=3, k_label_gcn=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny(monkeypatch):
    """Makes every cell tiny for ``harness.run_cell`` on the CPU: the
    configuration's model at TINY_MODEL, batches of 2, small pools. The
    cell's own limits stay."""
    real_config, real_traffic = harness.config, harness.traffic

    def config(spec, name):
        cfg = json.loads(json.dumps(real_config(spec, name)))
        cfg["model"].update(TINY_MODEL)
        return cfg

    def traffic(name):
        t = real_traffic(name)
        t["batch"] = 2
        for key, n in (("pool_batches", 3), ("pool_images", 4),
                       ("checked_requests", 4)):
            if key in t:
                t[key] = n
        return t

    monkeypatch.setattr(harness, "config", config)
    monkeypatch.setattr(harness, "traffic", traffic)
    return harness.load_spec()
