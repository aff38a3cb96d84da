"""Model-serving HTTP endpoint (counterpart: ``tools/deployment/serve.py``;
the reference's mmcls2torchserve.py + mmcls_handler.py).

Serves a checkpoint (the eager eval step) or an exported artifact (batch
1, ``tools/deployment/export.py``):

    python -m gkgnet_tpu_torch.tools.deployment.serve CONFIG --checkpoint CKPT_DIR [--port 8080]
    python -m gkgnet_tpu_torch.tools.deployment.serve CONFIG --artifact model.pt2 [--port 8080]

API (the JAX tool's, torchserve's shape):
  POST /predictions/gkgnet   body = raw image bytes (jpg/png)
    -> {"pred_label": [...], "pred_score": [...], "pred_class": [...]}
       (the classes scoring at least ``--threshold``)
  GET  /ping                 -> {"status": "Healthy"}

One forward warms the scorer up before the port is bound.
``main(argv, block=False)`` returns the bound server without serving
(``--port 0`` binds a free port, ``server.server_address`` names it): a
caller in the same process runs its ``serve_forever`` in a thread and
scores bytes itself through ``server.score_bytes``, which is
``server.score_fn(server.preprocess(raw))[0]``: the host's decode and test
pipeline, then the device's normalization and forward. Runs on the card
unless ``--device cpu`` is given; raises without a card.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from functools import partial
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import torch
from PIL import Image

from gkgnet_tpu_torch.core.config import Config
from gkgnet_tpu_torch.core.export import load_exported_classifier
from gkgnet_tpu_torch.core.trainer import (create_train_state,
                                           make_device_normalize,
                                           make_eval_step,
                                           pipeline_device_norm)
from gkgnet_tpu_torch.data.coco import COCO_CLASSES
from gkgnet_tpu_torch.data.pipelines import build_pipeline
from gkgnet_tpu_torch.entry import resolve_device
from gkgnet_tpu_torch.tools.inference import init_model


def build_scorer(args, cfg: Config, device: torch.device):
    """``score_fn(img (1, H, W, 3) fp32 or uint8 np) -> (1, C) np scores``
    and the input size."""
    size = cfg.model["size"]
    norm = make_device_normalize(
        pipeline_device_norm(cfg.data["test"]["pipeline"]))
    if args.artifact:
        clf = load_exported_classifier(args.artifact, device=device)
        if clf.batch != 1:
            raise ValueError(f"serve takes a batch-1 artifact, "
                             f"{args.artifact} takes {clf.input_shape}")
        forward = clf.forward
    else:
        model, _ = init_model(cfg, args.checkpoint, device)
        forward = partial(make_eval_step(),
                          create_train_state(model, optimizer=None))

    def score(img: np.ndarray) -> np.ndarray:
        # the uint8 image crosses to the device and is normalized there
        imgs = norm(torch.from_numpy(img).to(device))
        return forward(imgs).cpu().numpy()

    return score, size


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve a GKGNet model over HTTP")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--artifact", default=None,
                   help="a batch-1 .pt2 artifact")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def make_server(argv=None) -> HTTPServer:
    """The warmed-up server, bound and not yet serving."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    score_fn, size = build_scorer(args, cfg, device)
    pipeline = build_pipeline([
        c for c in cfg.data["test"]["pipeline"]
        if c["type"] != "LoadImageFromFile"])
    classes = cfg.data["test"].get("classes") or list(COCO_CLASSES)
    thr = args.threshold

    def preprocess(raw: bytes) -> np.ndarray:
        """One encoded image -> the test pipeline's ``(1, H, W, 3)`` batch."""
        img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        return pipeline({"img": img})["img"][None]

    def score_bytes(raw: bytes) -> np.ndarray:
        """The scores ``(C,)`` of one encoded image."""
        return score_fn(preprocess(raw))[0]

    # warm up (the kernels' builds, the first launches) before binding
    score_fn(np.zeros((1, size, size, 3), np.float32))

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/ping":
                self._send(200, {"status": "Healthy"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if not self.path.startswith("/predictions"):
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                scores = score_bytes(self.rfile.read(length))
                keep = np.where(scores >= thr)[0]
                self._send(200, {
                    "pred_label": [int(i) for i in keep],
                    "pred_score": [round(float(scores[i]), 6) for i in keep],
                    "pred_class": [classes[i] for i in keep],
                })
            except Exception as e:  # noqa: BLE001 - reported to the client
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *a):
            print(f"[serve] {fmt % a}", file=sys.stderr)

    server = HTTPServer(("0.0.0.0", args.port), Handler)
    server.preprocess, server.score_fn = preprocess, score_fn
    server.score_bytes = score_bytes
    return server


def main(argv=None, block: bool = True) -> HTTPServer:
    """Serve until interrupted; with ``block=False`` return the bound
    server (``make_server``) instead."""
    server = make_server(argv)
    if not block:
        return server
    print(f"serving on :{server.server_address[1]} "
          f"(POST /predictions/gkgnet)", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
