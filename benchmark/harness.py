"""One run of one cell: the specification read from ``BENCHMARK.json`` and
the files it names, the set-up, the window, the traced stretch, the check
and the result line. Nothing here knows a cell, configuration, traffic mix
or metric by name: a cell's files are found from its names, and a metric
from ``metrics/<name>.py`` or, for ``<family>.<suffix>``, from
``metrics/<family>.py``; a reader's ``read(run, name)`` returns a number,
or None where the run holds nothing for it to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from benchmark import check, drivers, flops, inputs, trace
from benchmark.system import Program

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "gkgnet_tpu")


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(spec: dict, name: str) -> dict:
    return _named(spec["workloads"], name, "workload")


def _json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def config(spec: dict, name: str) -> dict:
    entry = _named(spec["configs"], name, "configuration")
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def limits(workload_name: str) -> dict:
    return _json("limits", f"{workload_name}.json")


_READERS: dict[str, object] = {}


def reader(metric: str):
    """The module that reads ``metric``."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            if path not in _READERS:
                spec = importlib.util.spec_from_file_location(
                    f"benchmark_metric_{len(_READERS)}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _READERS[path] = mod
            return _READERS[path]
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"benchmark/metrics")


def applies(metric: dict, workload_name: str) -> bool:
    return workload_name in metric.get("workloads", [workload_name])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (names compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def make_pool(tr: dict, cfg: dict, seed: int, device) -> dict:
    """The inputs the run cycles through, drawn from the seed."""
    size, kind = cfg["model"]["size"], tr["kind"]
    if kind == "serve":
        n, b = tr["pool_images"], 1
    else:
        n, b = tr["pool_batches"], tr["batch"]
    img = inputs.images(n * b, size, tr["images"], seed, inputs.IMAGES,
                        device)
    if tr["input"] == "uint8":
        gt = inputs.labels(n * b, cfg["model"]["n_classes"],
                           tr["labels_per_image"], seed, inputs.LABELS,
                           device)
        return {"img": list(img.split(b)), "gt": list(gt.split(b))}
    img = inputs.normalize(img, cfg["img_norm"])
    if tr["input"] == "float32_host":
        return {"img": [t.cpu() for t in img.split(1)]}
    return {"img": list(img.split(b))}


def _release(system, device) -> None:
    system.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(spec: dict, name: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t0: float | None = None,
             make_system=Program) -> dict:
    """Runs the cell once; returns the result (see ``report``) with the
    readings and the spans under ``_readings`` and ``_spans``.
    ``seconds`` 0 leaves out the window (the checks' readings)."""
    t0 = time.perf_counter() if t0 is None else t0
    phases = {"start": time.perf_counter() - t0}
    cell = workload(spec, name)
    cfg, tr, lim = config(spec, cell["config"]), traffic(cell["traffic"]), \
        limits(name)
    kind, batch = tr["kind"], tr["batch"]
    params, stats = inputs.weights(cfg["model"], seed, device)
    if "calibration_images" in tr:
        cal = inputs.images(tr["calibration_images"], cfg["model"]["size"],
                            tr["images"], seed, inputs.CALIBRATION,
                            device)
        with check.fp32_exact():
            stats = inputs.calibrated_stats(
                cfg["model"], params, inputs.normalize(cal, cfg["img_norm"]))
        del cal
        gc.collect()
        if device.type == "cuda":  # the harness's own pass: not the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
    phases["weights"] = time.perf_counter() - t0
    pool = make_pool(tr, cfg, seed, device)
    phases["inputs"] = time.perf_counter() - t0
    system = make_system(cfg, params, stats, seed, device)
    phases["build"] = time.perf_counter() - t0
    spans = drivers.Spans()

    # set-up: every shape the window uses is warmed (the first call runs
    # eagerly, the second captures, the third replays); a training cell's
    # first steps are the ones the check compares
    prog = {"loss": []}
    warm = []
    for i in range(tr.get("checked_steps", 3)):
        if kind == "train":
            prog["loss"].append(system.train_step(pool["img"][i],
                                                  pool["gt"][i]))
            if i == 0:
                drivers.sync(device)
                prog["grad"] = system.first_grad_norms()
        elif kind == "eval":
            warm.append((i, system.eval_step(pool["img"][i])))
        else:
            warm.append((i, system.predict(pool["img"][i]).cpu(), 0.0))
    drivers.sync(device)
    if kind == "train":
        prog["change"] = system.change_norms(params)
        prog["loss"] = [float(v) for v in prog["loss"]]
    first = len(warm) or len(prog["loss"])
    setup_s = time.perf_counter() - t0
    phases["warm"] = setup_s
    print("set-up (s from start): " + ", ".join(
        f"{k} {v:.2f}" for k, v in phases.items()), file=sys.stderr)

    window = {"calls": 0, "seconds": 0.0, "outputs": []}
    if seconds > 0:
        window = drivers.WINDOWS[kind](system, pool, seconds, first, spans,
                                       device)
    peak = (torch.cuda.max_memory_reserved(device)
            if device.type == "cuda" else 0)
    outs = window["outputs"]
    failed = _failed(kind, outs)

    stretch = owners = None
    if traced:
        stretch, owners = _trace(system, kind, tr, pool, first)
        for kernel, who in sorted(owners.items(), key=lambda kv: kv[1]):
            print(f"owner {who[0]}.{who[1]}: {kernel[:100]}",
                  file=sys.stderr)
        print(f"stretch: {len(stretch.device)} device operations, busy "
              f"{stretch.busy_s:.6f} s of {stretch.window_s:.6f} s",
              file=sys.stderr)

    # the check, once the program's state is freed
    if kind == "train":
        _release(system, device)
        ref = check.reference_training(cfg, params, pool, len(prog["loss"]),
                                       seed)
        readings = check.train_readings(prog, ref)
    else:
        answers = outs if outs else warm
        picked = [answers[i] for i in check.sample(
            len(answers), tr["checked_outputs" if kind == "eval"
                             else "checked_requests"], seed)]
        picked = [(a[0], a[1].cpu()) for a in picked]
        _release(system, device)
        need = sorted({j for j, _ in picked})
        imgs = torch.cat([pool["img"][j].to(device) for j in need])
        per = batch if kind == "eval" else 1
        scores = check.reference_scores(cfg, params, stats, imgs)
        ref = {j: scores[k * per:(k + 1) * per] for k, j in enumerate(need)}
        readings = check.score_readings(picked, ref)
    correct, checks = check.judge(readings, lim)

    run = {
        "kind": kind, "batch": batch, "setup_s": setup_s,
        "steps": window["calls"], "seconds": window["seconds"],
        "images": window["calls"] * batch,
        "latencies_s": [o[2] for o in outs] if kind == "serve" else [],
        "flops_per_image": flops.model_flops(
            cfg["model"]["arch"], cfg["model"]["size"],
            n_classes=cfg["model"]["n_classes"],
            num_gcn=cfg["model"]["num_gcn"])["per_image_total"],
        "knn_calls": flops.knn_mr_calls(cfg["model"], batch),
        "dtype": "bf16" if cfg["model"]["dtype"] == "bfloat16" else "fp32",
        "stretch": stretch, "owners": owners,
    }
    group = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec[group]:
        if not applies(m, name):
            continue
        value = reader(m["name"]).read(run, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": window["calls"],
              "failed": failed, "metrics": metrics, "device": dev}
    if stretch is not None:
        dev["busy_s"], dev["window_s"] = stretch.busy_s, stretch.window_s
        result["breakdown"] = stretch.breakdown()
    result["checks"] = checks
    result["_readings"] = readings
    result["_spans"] = spans.summary()
    result["_window"] = {"calls": window["calls"],
                         "seconds": window["seconds"], "setup": phases}
    if stretch is not None:
        result["_window"]["stretch"] = {"calls": stretch.items,
                                        "seconds": stretch.window_s}
    return result


def _failed(kind: str, outs: list) -> int:
    """Calls whose output is not finite."""
    if not outs:
        return 0
    if kind == "train":
        return int((~torch.isfinite(torch.stack(outs))).sum())
    vals = torch.stack([o[1].reshape(-1, o[1].shape[-1]).float().cpu()
                        for o in outs])
    return int((~torch.isfinite(vals)).any(dim=-1).any(dim=-1).sum())


def _trace(system, kind: str, tr: dict, pool: dict, first: int):
    """The eager call's owners map and the profiled stretch."""
    n = len(pool["img"])
    args = (pool["img"][first % n],) + (
        (pool["gt"][first % n],) if kind == "train" else ())
    owners = trace.owners(trace.profiled(lambda: system.eager(kind, *args)))
    items = tr["trace_requests" if kind == "serve" else "trace_steps"]
    spans = drivers.Spans()

    def calls():
        drivers.WINDOWS[kind](system, pool, None, first, spans,
                              torch.device("cuda"), count=items)

    return trace.stretch(calls, items, items * tr["batch"]), owners


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def report(result: dict, out_dir: str | None = None, tag: str = "") -> None:
    """The checks on standard error, as its last lines, and the result as
    the last line of standard output; the spans and readings to
    ``out_dir``."""
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
            json.dump({"spans": result["_spans"],
                       "readings": result["_readings"],
                       "window": result["_window"]}, f, indent=1)
    line = {k: v for k, v in result.items() if not k.startswith("_")}
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
