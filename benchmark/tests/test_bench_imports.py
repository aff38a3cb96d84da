"""No JAX on the benchmark's path: the harness, every file the cells name
and the port they drive load no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``gkgnet_tpu`` (compared whole: the port's
``gkgnet_tpu_torch`` begins with ``gkgnet_tpu``), and the reference loads
nothing of the port either."""

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "gkgnet_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_cells_and_port_load_no_jax():
    code = """
import runpy, torch
torch.set_num_threads(1)
runpy.run_path("benchmark/run.py", run_name="benchmark_run")
from benchmark import harness, control, inputs
from benchmark.system import Program
spec = harness.load_spec()
for m in spec["end_to_end"] + spec["per_layer"]:
    harness.reader(m["name"])
for w in spec["workloads"]:
    harness.config(spec, w["config"]); harness.traffic(w["traffic"])
    harness.limits(w["name"])
cfg = harness.config(spec, "gkgnet-t-576")
cfg["model"].update(size=128, k=3, k_label_gcn=3)
cpu = torch.device("cpu")
params, stats = inputs.weights(cfg["model"], 1, cpu)
p = Program(cfg, params, stats, 1, cpu)
img = inputs.images(2, 128, {"scales": [[6, 100]], "noise": 4}, 1, 3, cpu)
p.train_step(img, torch.zeros(2, 80))
p.eval_step(inputs.normalize(img, cfg["img_norm"]))
"""
    loaded = loaded_after(code)
    assert "gkgnet_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = loaded_after("import benchmark.reference.model, "
                          "benchmark.reference.train, benchmark.check, "
                          "benchmark.inputs, benchmark.flops")
    assert not loaded & (FORBIDDEN | {"gkgnet_tpu_torch"})


def test_no_file_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"),
                          recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
                if "/reference/" in path:
                    assert not name.startswith("gkgnet_tpu_torch"), path
