"""Logging: console+file logger and the jsonl metric log the analysis tools
parse (counterpart: ``gkgnet_tpu/utils/logging.py``; reference
utils/logger.py:9-46 writes ``*.log.json``; same format).

``get_logger`` differs in one point: a call with ``log_file`` replaces the
logger's file handler, so a second in-process run (``tools.train.main``
called twice) writes its own file."""

from __future__ import annotations

import json
import logging
import os
import time


_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_logger(name: str = "gkgnet_tpu_torch", log_file: str | None = None,
               level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(level)
        logger.propagate = False
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(sh)
    if log_file:
        close_file_handlers(logger)
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger


def close_file_handlers(logger: logging.Logger) -> None:
    for h in [h for h in logger.handlers
              if isinstance(h, logging.FileHandler)]:
        logger.removeHandler(h)
        h.close()


class JsonLogWriter:
    """One JSON object per line: {"mode", "epoch", "iter", ...scalars}."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path

    def write(self, mode: str, epoch: int, it: int, scalars: dict):
        rec = {"mode": mode, "epoch": epoch, "iter": it,
               "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def load_json_log(path: str) -> dict[int, dict[str, list]]:
    """Parse a jsonl log into {epoch: {metric: [values...]}} (the reference's
    load_json_log, utils/logger.py:13-46)."""
    log_dict: dict[int, dict[str, list]] = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line.strip())
            epoch = rec.pop("epoch", 0)
            bucket = log_dict.setdefault(epoch, {})
            for k, v in rec.items():
                bucket.setdefault(k, []).append(v)
    return log_dict


class ScalarMeter:
    """Windowed averaging buffer (mmcv LogBuffer semantics)."""

    def __init__(self):
        self.history: dict[str, list] = {}

    def update(self, scalars: dict):
        for k, v in scalars.items():
            self.history.setdefault(k, []).append(float(v))

    def average(self, window: int | None = None) -> dict:
        out = {}
        for k, vals in self.history.items():
            take = vals[-window:] if window else vals
            if take:
                out[k] = sum(take) / len(take)
        return out

    def clear(self):
        self.history.clear()
