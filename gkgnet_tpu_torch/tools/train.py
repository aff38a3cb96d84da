"""Training CLI (counterpart: ``tools/train.py``): a config file, the same
work-dir layout and JSON log keys, on one card or a world of ranks.

    python -m gkgnet_tpu_torch.tools.train configs/gkgnet_coco_576.py --ema
    python -m gkgnet_tpu_torch.tools.train CONFIG --device cpu   # on the CPU
    python -m torch.distributed.run --nproc_per_node 4 \
        -m gkgnet_tpu_torch.tools.train CONFIG --cfg-options mesh.graph=2
    gkgnet_tpu_torch/tools/dist_train.sh CONFIG 4 [args]       # the same

Under ``torch.distributed.run`` (or with ``--multihost``, from the same
environment on several hosts) every rank joins the world
(``parallel.mesh.init_distributed``: NCCL where each local rank has a card
of its own, else gloo) and the config's ``mesh = dict(data=None, graph=1)``
lays the ranks out (``data=None`` fills the world). Rank 0 draws the seed
when none is given and sends it to the others; each rank's loader takes
the rows of its DATA rank (``DistributedSampler`` with ``num_replicas`` the
data size), so the graph ranks of a data group load the same images; the
global batch is ``samples_per_device`` times the data size; every step runs
under ``parallel.sharding.graph_sharding`` (``mesh.overlap`` selects the
ring schedule). The val-loss pass and the evaluations shard the set by data
rank and reassemble the scores in dataset order, so the metrics are the
same on every rank; logs, TensorBoard and checkpoints come from rank 0,
and a resume loads on every rank.

The work dir gets ``<timestamp>.log``, ``<timestamp>.log.json`` (records
``train``, ``val_loss`` and ``val``, as the JAX CLI writes them),
``config.json``, ``checkpoints/<epoch>/`` every ``checkpoint_config.interval``
epochs (``max_to_keep``) and ``best/<epoch>/`` at each new best of
``evaluation.save_best`` over the raw and the EMA weights.

Each step is ``core.trainer.make_train_step``'s, its random draws seeded
from ``(seed + 1, step)``; the loader's from ``(seed, epoch, position)``. A
run resumed from an epoch's checkpoint (``--resume-from``) therefore takes
the steps a run without the break takes. Runs on the card unless
``--device cpu`` is given; raises without a card. ``main(argv)`` returns a
summary of the run's timings for callers in the same process.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from gkgnet_tpu_torch import native
from gkgnet_tpu_torch.core.builder import build_dataset, build_model
from gkgnet_tpu_torch.core.checkpoint import (load_params_only,
                                              restore_checkpoint,
                                              save_checkpoint)
from gkgnet_tpu_torch.core.config import Config, parse_cfg_option
from gkgnet_tpu_torch.core.optim import build_optimizer
from gkgnet_tpu_torch.nn.augment import build_batch_augment
from gkgnet_tpu_torch.core.schedules import build_lr_schedule
from gkgnet_tpu_torch.core.trainer import (TrainState, create_train_state,
                                           make_device_normalize,
                                           make_eval_step, make_train_step,
                                           pipeline_device_norm)
from gkgnet_tpu_torch.data.loader import build_dataloader, prefetch_to_device
from gkgnet_tpu_torch.entry import resolve_device
from gkgnet_tpu_torch.nn.classifier import init_parameters, parse_losses
from gkgnet_tpu_torch.parallel.mesh import (Mesh, destroy, init_distributed,
                                            make_mesh, replicate_state)
from gkgnet_tpu_torch.parallel.sharding import graph_sharding
from gkgnet_tpu_torch.utils.env import collect_env
from gkgnet_tpu_torch.utils.logging import (JsonLogWriter, ScalarMeter,
                                            close_file_handlers, get_logger)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Train a GKGNet model on one card or a world of ranks")
    p.add_argument("config")
    p.add_argument("--work-dir")
    p.add_argument("--resume-from")
    p.add_argument("--load-from")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--deterministic", action="store_true",
                   help="pin the seed to 0 when none is given (the steps and "
                        "the loader are seeded and deterministic already)")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="join the world from the torch.distributed.run "
                        "environment (RANK, WORLD_SIZE, LOCAL_RANK, "
                        "MASTER_ADDR, MASTER_PORT) even for a world of one")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="key=value deep overrides")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def load_config(path: str, options: list[str]) -> Config:
    cfg = Config.fromfile(path)
    cfg.merge_from_options({
        k: parse_cfg_option(v) for k, v in
        (opt.split("=", 1) for opt in options)})
    return cfg


def join_world(args, cfg: Config) -> tuple[torch.device, Mesh, bool]:
    """``(device, mesh, joined)``: under ``torch.distributed.run`` (a
    ``WORLD_SIZE`` above 1) or ``--multihost`` this rank joins the world;
    then the config's mesh over it (a world of one rank otherwise, where a
    mesh over more ranks raises)."""
    joined = args.multihost or int(os.environ.get("WORLD_SIZE", "1")) > 1
    if args.multihost and "WORLD_SIZE" not in os.environ:
        raise RuntimeError("--multihost joins the world from the "
                           "torch.distributed.run environment (RANK, "
                           "WORLD_SIZE, MASTER_ADDR, MASTER_PORT); it is "
                           "not set")
    if joined:
        device = init_distributed(args.device)
    else:
        device = resolve_device(args.device)
    mesh_cfg = cfg.get("mesh") or {}
    mesh = make_mesh(mesh_cfg.get("data"), mesh_cfg.get("graph", 1),
                     device=device)
    return device, mesh, joined


def broadcast_seed(seed: int | None) -> int:
    """Rank 0's seed on every rank; rank 0 draws one when none is given
    (the reference's init_random_seed)."""
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2**31))
    if dist.is_initialized():
        box = [seed]
        dist.broadcast_object_list(box, src=0)
        seed = box[0]
    return seed


def dynamic_loss_scale(cfg: Config) -> bool:
    return (cfg.get("fp16") or {}).get("loss_scale") == "dynamic"


def build_train_state(cfg: Config, seed: int, device: torch.device,
                      steps_per_epoch: int, ema: bool) -> TrainState:
    """The config's model, initialized from ``seed`` on ``device``, with
    its optimizer and learning-rate schedule."""
    model = build_model(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    lr_cfg = dict(cfg.lr_config)
    lr_cfg["base_lr"] = cfg.optimizer["lr"]
    lr_schedule = build_lr_schedule(lr_cfg, steps_per_epoch)
    opt_cfg = dict(cfg.optimizer)
    optimizer = build_optimizer(
        model, lr_schedule, opt_cfg.get("type", "adamw"),
        opt_cfg.get("weight_decay", 0.05),
        tuple(opt_cfg.get("betas", (0.9, 0.999))), opt_cfg.get("eps", 1e-8),
        opt_cfg.get("grad_clip_norm", 5.0),
        opt_cfg.get("paramwise_no_decay", True))
    return create_train_state(model, optimizer, ema=ema,
                              dynamic_loss_scale=dynamic_loss_scale(cfg))


def find_pipeline_cfg(d):
    """The pipeline list through dataset-wrapper nesting (train=dict(
    dataset=dict(pipeline=...)) vs val=dict(pipeline=...))."""
    if not isinstance(d, dict):
        return None
    if "pipeline" in d:
        return d["pipeline"]
    if "dataset" in d:
        return find_pipeline_cfg(d["dataset"])
    return None


def device_batches(loader, device, cfg_split: dict):
    """The loader's batches on ``device``, images normalized there when the
    pipeline defers it (uint8 across the bus)."""
    dev_norm = make_device_normalize(pipeline_device_norm(
        find_pipeline_cfg(cfg_split)))
    for batch in prefetch_to_device(iter(loader), device):
        batch["img"] = dev_norm(batch["img"])
        yield batch


def _data_shard(dataset, batch: int, cfg: Config, mesh: Mesh | None):
    """An in-order loader of this rank's rows (indices ``r::data`` for data
    rank r) and those rows' dataset indices."""
    data, rank = (1, 0) if mesh is None else (mesh.data, mesh.data_rank)
    loader = build_dataloader(dataset, batch, cfg.data.get("workers", 8),
                              num_replicas=data, rank=rank, shuffle=False,
                              sampler=None, seed=0, drop_last=False)
    return loader, np.arange(len(dataset))[rank::data]


def reassemble(parts: list[np.ndarray], n_total: int) -> np.ndarray:
    """The data ranks' rows (rank r's: dataset indices ``r::len(parts)``)
    in dataset order."""
    out = np.zeros((n_total,) + parts[0].shape[1:], parts[0].dtype)
    for r, rows in enumerate(parts):
        out[r::len(parts)] = rows
    return out


def in_dataset_order(local: np.ndarray, n_total: int,
                     mesh: Mesh | None) -> np.ndarray:
    """This data rank's rows gathered over the data group and put back in
    dataset order (``reassemble``); the same on every rank."""
    if mesh is None or mesh.data == 1:
        return local
    parts: list = [None] * mesh.data
    dist.all_gather_object(parts, local, group=mesh.data_group)
    return reassemble(parts, n_total)


def run_eval(val_ds, eval_step, state: TrainState, batch: int, cfg: Config,
             device, split: str = "val", mesh: Mesh | None = None
             ) -> np.ndarray:
    """Sigmoid scores (N, n_classes) of a split's dataset, in dataset
    order; over a mesh each data rank scores its rows ``r::data`` and the
    scores are reassembled on every rank."""
    loader, rows = _data_shard(val_ds, batch, cfg, mesh)
    chunks = [eval_step(state, b["img"]).cpu().numpy()
              for b in device_batches(loader, device, cfg.data.get(split, {}))]
    scores = np.concatenate(chunks, axis=0)
    if len(scores) != len(rows):
        raise RuntimeError(f"{len(scores)} scores for {len(rows)} images")
    return in_dataset_order(scores, len(val_ds), mesh)


@torch.no_grad()
def run_val_loss(val_ds, state: TrainState, batch: int, cfg: Config,
                 device, mesh: Mesh | None = None) -> dict:
    """The val-mode loss pass (eval BatchNorm, no update) of the workflow
    [('train', 1), ('val', 1)], with the dataset's labels in loader order.
    A trailing partial batch is padded with its last image and label, and
    its mean is weighted by its valid rows, as the JAX CLI does. Over a
    mesh each data rank takes its rows ``r::data`` and the weighted sums
    are added over the data group."""
    model = state.model
    loss_head = model.build_loss_head()
    loader, rows = _data_shard(val_ds, batch, cfg, mesh)
    gts = torch.from_numpy(val_ds.get_gt_labels().astype(np.float32)[rows])
    sums: dict[str, float] = {}
    count = 0
    was_training = model.training
    model.eval()
    try:
        for b in device_batches(loader, device, cfg.data.get("val", {})):
            imgs = b["img"]
            n = imgs.shape[0]
            gt = gts[count:count + n].to(device)
            if n < batch:
                pad = batch - n
                imgs = torch.cat([imgs,
                                  imgs[-1:].expand(pad, *imgs.shape[1:])])
                gt = torch.cat([gt, gt[-1:].expand(pad, -1)])
            score, _ = model(imgs)
            _, logs = parse_losses(loss_head.loss(score, gt))
            for k, v in logs.items():
                sums[k] = sums.get(k, 0.0) + float(v) * n
            count += n
    finally:
        model.train(was_training)
    if mesh is not None and mesh.data > 1:
        keys = sorted(sums)
        total = torch.tensor([sums[k] for k in keys] + [count],
                             dtype=torch.float64)
        dist.all_reduce(total, group=mesh.data_group)
        sums = dict(zip(keys, total[:-1].tolist()))
        count = int(total[-1])
    return {k: v / max(count, 1) for k, v in sums.items()}


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = load_config(args.config, args.cfg_options)
    device, mesh, joined = join_world(args, cfg)
    try:
        if args.work_dir:
            cfg.work_dir = args.work_dir
        if args.max_epochs:
            cfg["runner"]["max_epochs"] = args.max_epochs
        seed = args.seed if args.seed is not None else cfg.get("seed", None)
        if args.deterministic and seed is None:
            seed = 0
        seed = broadcast_seed(seed)

        work_dir = cfg.get("work_dir", "./work_dirs/default")
        os.makedirs(work_dir, exist_ok=True)
        timestamp = time.strftime("%Y%m%d_%H%M%S")
        if mesh.rank == 0:
            logger = get_logger(
                log_file=os.path.join(work_dir, f"{timestamp}.log"))
        else:  # the other ranks log warnings only, and to no file
            logger = get_logger()
            logger.setLevel(logging.WARNING)
        try:
            return _train(args, cfg, seed, device, mesh, work_dir, timestamp,
                          logger)
        finally:
            close_file_handlers(logger)
    finally:
        if joined:
            destroy()


def _train(args, cfg: Config, seed: int, device: torch.device, mesh: Mesh,
           work_dir: str, timestamp: str, logger) -> dict:
    rank0 = mesh.rank == 0
    jlog = JsonLogWriter(os.path.join(work_dir, f"{timestamp}.log.json"))
    if rank0:
        cfg.dump(os.path.join(work_dir, "config.json"))
    logger.info("Environment:\n" + "\n".join(
        f"    {k}: {v}" for k, v in collect_env().items()))
    logger.info(f"device={device} seed={seed} "
                f"deterministic={args.deterministic} world={mesh.world} "
                f"mesh=data {mesh.data} x graph {mesh.graph}")

    # ------------------------------------------------------------------ data
    native.lib()  # built once here, before any spawned worker loads it
    train_ds = build_dataset(cfg.data["train"])
    val_ds = build_dataset(cfg.data["val"]) if cfg.get("evaluation") else None
    batch = cfg.data.get("samples_per_device", 16)
    # the graph ranks of a data group load the same rows: the sampler's
    # rank is the data rank
    train_loader = build_dataloader(
        train_ds, batch, cfg.data.get("workers", 8),
        num_replicas=mesh.data, rank=mesh.data_rank, shuffle=True,
        sampler=cfg.get("sampler", {}).get("type"), seed=seed,
        drop_last=True, mode=cfg.data.get("loader_mode", "threads"))
    steps_per_epoch = len(train_loader)
    logger.info(f"train dataset: {len(train_ds)} samples, "
                f"{steps_per_epoch} steps/epoch, batch {batch}, global "
                f"batch {batch * mesh.data}")
    if steps_per_epoch == 0:
        raise ValueError(
            "0 train steps/epoch — dataset smaller than one batch (note: "
            "RepeatAugSampler truncates to multiples of selected_round=256)")

    # ----------------------------------------------------------------- model
    ema_cfg = cfg.get("ema", {})
    ema_on = bool(args.ema or ema_cfg.get("enabled"))
    dyn_scale = dynamic_loss_scale(cfg)
    state = build_train_state(cfg, seed, device, steps_per_epoch, ema_on)
    model = state.model

    start_epoch = 0
    if args.resume_from or cfg.get("resume_from"):
        path = args.resume_from or cfg.resume_from
        state, start_epoch, _ = restore_checkpoint(path, state)
        logger.info(f"resumed from {path} at epoch {start_epoch}")
    elif args.load_from or cfg.get("load_from"):
        path = args.load_from or cfg.load_from
        load_params_only(path, model)
        if state.ema_params is not None:
            state.ema_params = {n: p.detach().clone()
                                for n, p in model.named_parameters()}
        logger.info(f"loaded weights from {path}")
    replicate_state(state, mesh)

    # batch-level mixup/cutmix from train_cfg.augments
    train_step = make_train_step(
        ema_momentum=ema_cfg.get("momentum", 2e-4),
        ema_warmup=ema_cfg.get("warmup", 100),
        dynamic_loss_scale=dyn_scale,
        batch_augment=build_batch_augment(
            cfg.get("model", {}).get("train_cfg", {}).get("augments")))
    eval_step = make_eval_step()
    # with EMA on, raw and EMA weights are both scored
    # (reference apis/train.py:187-207)
    eval_step_ema = make_eval_step(use_ema=True) if ema_on else None

    tb = None
    if cfg.get("log_config", {}).get("tensorboard") and rank0:
        from gkgnet_tpu_torch.utils.tensorboard import TensorboardWriter
        tb = TensorboardWriter(os.path.join(work_dir, "tf_logs"))

    # two-phase workflow: [('train', 1), ('val', 1)] adds a val-mode LOSS
    # pass after every train epoch (reference mmcv workflow)
    workflow = cfg.get("workflow") or [("train", 1)]
    do_val_loss = any(tuple(w)[0] == "val" for w in workflow)

    # ------------------------------------------------------------------ loop
    max_epochs = cfg["runner"]["max_epochs"]
    log_interval = cfg.get("log_config", {}).get("interval", 50)
    eval_interval = cfg.get("evaluation", {}).get("interval", 1)
    ckpt_interval = cfg.get("checkpoint_config", {}).get("interval", 1)
    best_metric, best_epoch = -1.0, -1
    meter = ScalarMeter()
    # seconds: train_s the epochs' loops (ending in a synchronize), data_s
    # the waits for a batch, first_data_s the first of each epoch's waits
    timing = {k: 0.0 for k in ("train_s", "data_s", "first_data_s",
                               "eval_s", "val_loss_s", "ckpt_save_s")}
    steps = eval_images = 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    overlap = (cfg.get("mesh") or {}).get("overlap", False)
    try:
        with graph_sharding(mesh, overlap=overlap):
            for epoch in range(start_epoch, max_epochs):
                train_loader.set_epoch(epoch)
                sync()
                t_epoch = t_data = time.perf_counter()
                epoch_data_s = 0.0
                for it, b in enumerate(device_batches(
                        train_loader, device, cfg.data["train"])):
                    data_time = time.perf_counter() - t_data
                    epoch_data_s += data_time
                    if it == 0:
                        timing["first_data_s"] += data_time
                    state, logs = train_step(state, b, seed + 1)
                    steps += 1
                    meter.update({"data_time": data_time})
                    if (it + 1) % log_interval == 0:
                        meter.update({k: float(v) for k, v in logs.items()})
                        avg = meter.average(log_interval)
                        msg = " ".join(f"{k}={v:.4g}"
                                       for k, v in sorted(avg.items()))
                        logger.info(f"Epoch [{epoch + 1}/{max_epochs}]"
                                    f"[{it + 1}/{steps_per_epoch}] {msg}")
                        if rank0:
                            jlog.write("train", epoch + 1, it + 1, avg)
                        if tb is not None:
                            tb.add_scalars(
                                avg, epoch * steps_per_epoch + it + 1,
                                prefix="train/")
                            tb.flush()
                    t_data = time.perf_counter()
                sync()
                epoch_s = time.perf_counter() - t_epoch
                timing["train_s"] += epoch_s
                timing["data_s"] += epoch_data_s
                logger.info(
                    f"Epoch [{epoch + 1}/{max_epochs}] {steps_per_epoch} "
                    f"steps in {epoch_s:.2f} s "
                    f"({epoch_s * 1e3 / steps_per_epoch:.1f} ms/step), "
                    f"data_time {epoch_data_s:.2f} s")

                if do_val_loss and val_ds is not None:
                    t = time.perf_counter()
                    vl = run_val_loss(val_ds, state, batch, cfg, device,
                                      mesh)
                    timing["val_loss_s"] += time.perf_counter() - t
                    if vl:
                        msg = " ".join(f"{k}={v:.4g}"
                                       for k, v in sorted(vl.items()))
                        logger.info(f"Epoch(val) [{epoch + 1}] {msg}")
                        if rank0:
                            jlog.write("val_loss", epoch + 1,
                                       steps_per_epoch, vl)

                if val_ds is not None and (epoch + 1) % eval_interval == 0:
                    t = time.perf_counter()
                    scores = run_eval(val_ds, eval_step, state, batch, cfg,
                                      device, mesh=mesh)
                    scores_ema = None
                    if eval_step_ema is not None:
                        scores_ema = run_eval(val_ds, eval_step_ema, state,
                                              batch, cfg, device, mesh=mesh)
                    timing["eval_s"] += time.perf_counter() - t
                    eval_images += len(val_ds) * (
                        1 + (scores_ema is not None))
                    metrics_dict = val_ds.evaluate(scores, logger=logger)
                    key = cfg.get("evaluation", {}).get("save_best", "mAP")
                    candidates = [(metrics_dict.get(key, -1), "raw")]
                    if scores_ema is not None:
                        ema_metrics = val_ds.evaluate(scores_ema,
                                                      logger=logger)
                        metrics_dict.update(
                            {f"{k}_ema": v for k, v in ema_metrics.items()})
                        candidates.append((ema_metrics.get(key, -1), "ema"))
                    if rank0:
                        jlog.write("val", epoch + 1, steps_per_epoch,
                                   metrics_dict)
                    if tb is not None:
                        tb.add_scalars(metrics_dict, epoch + 1,
                                       prefix="val/")
                        tb.flush()
                    score, source = max(candidates)
                    if score > best_metric:
                        best_metric, best_epoch = score, epoch + 1
                        if rank0:
                            save_checkpoint(
                                os.path.join(work_dir, "best"), state,
                                epoch + 1, {"metric": best_metric,
                                            "weights": source})
                        logger.info(f"new best {key}={best_metric:.4f} "
                                    f"({source})")

                if (epoch + 1) % ckpt_interval == 0 and rank0:
                    t = time.perf_counter()
                    save_checkpoint(
                        os.path.join(work_dir, "checkpoints"), state,
                        epoch + 1,
                        {"epoch": epoch + 1,
                         "CLASSES": list(getattr(train_ds, "CLASSES", [])
                                         or [])},
                        max_to_keep=cfg.get("checkpoint_config", {}).get(
                            "max_to_keep", 3))
                    timing["ckpt_save_s"] += time.perf_counter() - t
    finally:
        train_loader.close()
        if tb is not None:
            tb.close()

    logger.info(f"done. best={best_metric:.4f} @ epoch {best_epoch}")
    return dict(timing, steps=steps, batch=batch,
                steps_per_epoch=steps_per_epoch, eval_images=eval_images,
                log_json=jlog.path)


if __name__ == "__main__":
    main()
