#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its elapsed seconds):
  1. device: the card's name, count, and name + power limit from nvidia-smi;
  2. build: nvcc builds every kernel of the paths from csrc/, one process
     per source, all at once (seconds, and the -Xptxas -v register and
     spill summary; each row below adds the block's dynamic shared memory);
  3. kernels: each kernel against its plain PyTorch version at every shape
     the main paths give it (bf16, BG=16, i.e. batch 8), plus one fp32 row.
     The forward (knn_mr_fused):
     (a) mr bitwise equal to the plain max-relative of the kernel's own idx,
     (b) fp64 ordering oracle: each kernel column's fp64 distance within
         ORACLE_TOL of the true rank-(s*d) candidate's,
     (c) the share of rows whose idx equals the plain version's (printed,
         not asserted: near-ties may order differently in fp32),
     (d) kernel and plain times with CUDA events after warmup;
     the backward (knn_mr_backward), on inputs with exact ties in the max
     (tie_fixture) and the forward kernel's idx:
     (e) gx bitwise -g;
     (f) gy bitwise knn_mr_backward_ordered_reference (each target's fp32
         sum from 0.0 in ascending edge id, the kernel's order, which also
         holds the tie sets), and within backward_gy_bound of the fp64 sum;
         every group has a row with a tie;
     (g) a second launch bitwise equal (no atomics), the times, and each
         call's largest and 99th-percentile in-degree;
     the forward rows also hold knn_topk(xn, yn, k*d)[..., ::d] bitwise to
     knn_mr's idx on knn_mr's own normalized rows (the same selection
     helpers and arithmetic). knn_topk (knn_graph's kernel) at every shape of this slice's
     path (bf16, BG=8 for the 9 blocks without groups, BG=16 for the 3
     stochastic 'mr' blocks, plus one fp32 row): the fp64 ordering oracle,
     every returned distance within its fp32 bound of the fp64 one, idx
     equal to the plain version's except at oracle near-ties (counted), two
     launches bitwise equal, tie and NaN fixtures bitwise the plain
     version's; kernel, plain and the two-call PyTorch route's times; the
     gather's backward (knn_mr.launch_gather_backward, the ordered sum
     of csrc/knn_mr_bwd.cu) at the label-sharded build's shapes of phase
     13 (b) and the Grapher path's stage-1 gather (``gather_row`` lines):
     gy bitwise gather_backward_ordered_reference and within the fp64
     bound, two launches bitwise equal, kernel, plain and index_add_
     times;
  4. eval: entry(device="cuda", batch=8) in bf16: 16 kernel launches per
     forward, finite (8, 80) logits; 3 requests through predict(); then
     ms/forward and a profile of device time by kernel; then batch 1 in
     fp32 (TF32 off): each of the 16 calls held against the plain version on
     the forward's own activations, and the logits of the kernel path and
     the plain paths printed (see compare_fp32_paths for why they are not
     held to a tolerance);
  5. train: train_entry(device="cuda", batch=8) in bf16 for 3 steps: 16
     forward and 16 backward launches per step, finite losses and gradient
     norm, parameters and BatchNorm statistics moved, the EMA between the
     initial and the new parameters; then ms/step, img/s, peak memory and
     a profile; then one step at batch 2 in fp32: each of the 16 backward
     calls held against the plain version on the step's own activations,
     and the kernel path's loss printed beside the plain path's and beside
     the kernel path's on images moved by one ulp; neither path launches
     knn_topk;
  6. the Grapher path (this slice): per aggregator (edge, sage, gin, gat)
     the 5 Grapher and 4 GrapherLabel blocks of GKGNet-S@576 without
     channel groups, at batch 8 in bf16, in eval and in a train-mode
     forward + backward: 9 knn_topk launches and no knn_mr launch each
     (and in train a gather backward launch in each of the 5 Graphers),
     finite outputs and gradients, ms per block; the 3 'mr' Graphers with
     stochastic dilation (epsilon 0.2) in train (3 knn_topk and 3 gather
     backward launches, no knn_mr) and eval (the fused knn_mr route); then
     at batch 2 in fp32
     every knn_topk call held to the plain version on the blocks' own
     activations;
  7. the grouped path (GKGNET_GROUPED=1 for this phase only): entry() at
     batch 8 in bf16 with phase 4's seed: 16 grouped knn_mr launches and no
     folded one per forward, logits bitwise phase 4's; 3 requests (64
     grouped launches in all); ms/forward beside the default route's in
     turns (default, grouped, grouped, default) and a profile; at each of
     the forward's 16 calls, on its own activations at batch 8 in bf16 and
     at batch 2 in fp32, the grouped kernel's idx and mr bitwise fold ->
     the folded kernel -> unfold, and held to the plain version
     (knn_mr_grouped_reference): mr bitwise where idx agrees, every idx
     difference a near-tie by the fp64 oracle on both sides, at most
     FLIP_SHARE of the forward's (row, group) pairs; per bf16 call the
     grouped, folded-route and plain ms and the bound; then 3 train steps
     at batch 8 (16 grouped forward and 16 backward launches each, no
     folded one), each step's 16 grouped backward calls (the group-strided
     kernel, no fold copy) bitwise fold -> the folded backward -> unfold on
     their own inputs, the step-1 loss bitwise phase 5's and the step-1
     gradients held to phase 5's per parameter, ms/step and peak memory;
  8. the phases (gkgnet_tpu_torch/tools/exp_kernel_phases.py) at the
     tool's geometry (BG 16, N 20736, M 1296, D 40, K 9, bf16): the four
     phase kernels timed (each launched on that run), then each checksum
     held to its plain version: dist and gfix within the fp32 summation
     bound, sel -inf, selg within its bound of the fp64 checksum of
     knn_mr.launch's own idx on the same rows; ms, plain ms and bound per
     phase, and the fp64 ordering oracle of the kernel's and the plain
     version's idx;
  9. the CLI path: the port's make_synthetic_coco writes 256 train and 64
     val images (the seeds of data/synthetic) into a temporary directory;
     one pass of the train loader alone (img/s); then tools.train.main on
     configs/gkgnet_synthetic_576.py as it is (s@576 bf16, batch 8, the
     full augmentation recipe, ClassBalanced + RepeatAug, EMA, step lr with
     warmup, 2 loader processes) with the data paths pointed at that set
     and runner.max_epochs=1, evaluation.interval=1,
     checkpoint_config.interval=1 and the two-phase workflow (a val_loss
     pass): 32 steps, knn_mr launches counted exactly (16 forward and 16
     backward per step, 16 forward per batch of the val_loss pass and of
     the raw and EMA evaluations), no grouped or knn_topk launch, finite
     losses, a val record with mAP and mAP_ema, a val_loss record, the
     checkpoints; then tools.test.main on the epoch's checkpoint, raw and
     EMA: (64, 80) scores whose mAP equals the log's (CLI_MAP_TOL);
     ms/step, data_time and its share, img/s, val img/s, peak memory, the
     checkpoint's size and save and restore seconds, the native ops' build
     seconds;
 10. the serving path, in phase 9's directory on its epoch checkpoint and
     64 val JPEGs (s@576 bf16): (a) core.hooks.precise_bn over 4 seeded
     batches of 8 (16 knn_mr launches each, every running statistic
     finite and moved); (b) tools.inference on one val JPEG, its scores
     bitwise the eval step's on the dataset's own preprocessed image; (c)
     tools.deployment.export on the card at batch 1 and 8 with --verify,
     and at batch 1 on the grouped route: each graph holds 16 kernel nodes
     (knn_mr_fused, or knn_mr_fused_grouped) and no sort or topk, one
     forward of the loaded artifact launches exactly 16 kernels, the
     grouped artifact's scores bitwise the default one's; size, export
     seconds and the largest |artifact - eager| score; (d)
     tools.deployment.test of the batch-8 artifact over the 64 images, its
     mAP equal to phase 9's test CLI (CLI_MAP_TOL); (e)
     tools.deployment.serve on port 0 in a thread, on the checkpoint and
     on the batch-1 artifact: /ping, 8 POSTs of val JPEGs whose answers
     are the in-process scorer's on the same bytes, then 64 timed POSTs,
     16 knn_mr launches per request; ms per request over the 64 (p50,
     p99, max, mean) and the split of a request in process (host decode
     and pipeline, device normalization and forward); (f) at batch 1 in
     fp32 (TF32 off), with PreciseBN's statistics, the relative logit
     gaps of the kernel and the plain paths (printed, not asserted; the
     kernel run must launch 16 kernels and the plain run none);
 11. the VOC path (configs/gkgnet_voc_448.py: s@448, 20 classes, bf16,
     batch 16) and the tools, in phase 9's directory: (a) a VOCdevkit
     written from phase 9's 256 train and 64 val JPEGs (write_vocdevkit:
     each COCO label c an object of VOC class c % 20, a seeded share
     marked difficult, so that some (image, class) pairs are difficult only
     (-1 at eval) and some mixed); (b) the kernel rows of phase 3 at
     VOC@448's shapes (VOC_ROWS, BG 32, the N = 20 label rows), forward
     (a)-(d) and backward (e)-(g); (c) tools.train.main on the config as it
     is but for the data paths, runner.max_epochs=1, evaluation.interval=1,
     checkpoint_config.interval=1 and log_config.interval=8 (two train
     records): 16 steps at batch 16, 16 + 16 knn_mr launches per step and 16
     per val batch exactly, no grouped or knn_topk launch, finite losses, a
     val record with mAP, the checkpoint; ms/step, data_time, img/s, val
     img/s, peak memory; (d) tools.test.main with --out: (64, 20) scores,
     mAP equal to the log's (CLI_MAP_TOL); (e) eval_metric on the --out
     file equal to the test CLI's dict, analyze_results' 5 best and worst,
     analyze_logs on the epoch's log; (f) vis_edges on one test JPEG (its
     scores, top-3 classes and (2, 20, 9) edges equal to the eval forward's
     on the dataset's preprocessed image, VOC class names) and vis_cam (16
     forward and 16 backward launches, a finite, nonzero saliency), both
     PNGs written; (g) get_flops --verify (analytic and executed FLOPs),
     utils.profiling.trace around 2 forwards at batch 16 (a trace file,
     device time), timeit (ms/forward, img/s, edges/s); (h)
     verify_dataset over trainval (0 bad files) and print_config; (i)
     phase 9's epoch checkpoint written as a reference container
     ({'state_dict': {'module.' + key: ..}, 'meta': ..}), imported with
     tools.convert_models.from_reference, and the test CLI's scores on it
     bitwise phase 9's;
 12. arch b@576 (configs/gkgnet_b_coco_576.py: channels 128..1024, 18
     stage-3 blocks, bf16, batch 8): (a) the config's model, seeded:
     exactly 28 knn_mr launches per eval forward (24 Graphers, 4 labels),
     finite (8, 80) logits, ms/forward, peak memory and a profile; every
     distinct call shape of the forward held to its plain version on the
     model's own activations (``row`` lines: (a)-(d) of phase 3, the
     whole-row layout at every one), and at stage 3 (D 256), stage 4 and
     label 4 (D 512), in bf16 and fp32, the D-chunked scan forced on the
     same call: bitwise equal, both timed (``chunk_row`` lines); 3 train
     steps of make_train_step
     (dual loss, AdamW, EMA, drop_path 0.2): 28 + 28 launches per step,
     finite losses, every parameter moved; ms/step, peak memory, a
     profile; every distinct backward call of a step held to its plain
     version (``bwd_row`` lines: (e)-(g)); (b) GKGNet b@576 without
     channel groups in bf16 at batch 8, a train-mode forward and a backward
     of a scalar of its outputs: 28 + 28 launches; its D = 1024 calls (2
     stage-4 Graphers at N = M = 324, k 9, dilation 5; the stage-4 label
     call at N 80, M 324) held to the plain version in bf16 and in fp32
     (``row`` lines, each on the D-chunked scan), knn_topk at D = 1024
     (``topk_row`` lines: the oracle, the value bound, determinism) and
     their backward (``bwd_row`` lines: gx bitwise -g, gy bitwise the
     ordered plain version); (c) two train steps at batch 2 of a t@224
     config with a prelu arch, an FPN neck and its
     MultiLabelLinearClsHead, mixup/cutmix and LAMB: with the kNN build
     (16 knn_mr launches per step) and with graph_builder='perturbed'
     (none), finite losses and moved parameters; the knn_budget chunk of
     t@224's stage 1 tiles the plain build bitwise the untiled one (on
     the CPU; the kernel holds no distance block); (d) the ungrouped
     backbone at batch 1 in fp32 (TF32 off): each D = 1024 call's kernel
     result against the plain version computed on the CPU, as
     compare_fp32_paths holds them (near-tie flips: at most one row or
     FLIP_SHARE, each within the fp64 oracle; mr bitwise where idx
     agrees);
 13. data and graph parallelism (gkgnet_tpu_torch/parallel/): worlds of
     ranks spawned on this one card, over gloo through pinned host buffers
     (ranks sharing a card measure the partition's overhead, not its
     scaling): (a) a world of 2 (data 1 x graph 2): every bf16 call of
     ROWS at BG 16 through the gather and ring schedules and the
     label-sharded build, idx and mr bitwise the unpartitioned kernel's on
     the same inputs in the same process, each gather shard's backward gx
     bitwise -g and its gy summed over the graph group within PAR_GY_REL
     of the unpartitioned gy (``par_row`` lines: ms and launches per
     rank); (b) in the same world, entry()'s eval forward at batch 8 under
     graph_sharding: logits bitwise phase 4's, and train_entry()'s first
     step: loss bitwise phase 5's, exact launch counts (one gather
     backward per label-sharded tap), the two ranks' gradients bitwise
     alike, the step's loss and gradients bitwise alike when it is run
     again from the seeded state (against phase 5's: printed, bf16); then
     the
     t@128 fp32 step (dryrun_multichip's model): the two ranks' gradients
     bitwise alike and within PAR_GRAD_REL of the one-process step's per
     leaf; (c) dryrun_multichip_prod(4, device="cuda"): data 2 x graph 2,
     global batch 8: an eval forward and 2 train steps on the gather
     schedule and an eval forward on the ring, with the launches per rank
     worked out from the routes (par_expected) and asserted, the ring's
     logits bitwise the gather's, the parameters after the steps bitwise
     alike on the 4 ranks, both steps' losses bitwise alike when a second
     dryrun_multichip_prod call runs the two steps again in a new world
     (with the same launch counts), the first step's loss within
     PAR_LOSS_RTOL of the one-process step's (the second's printed), ms and
     peak memory per rank; then, in a world of 4 beside (e), the t@128 fp32
     step on data 2
     x graph 2: each data rank's graph ranks enter the train step's data
     mean with bitwise-equal gradients and leave it with the data ranks'
     mean, bitwise (against the one-process step: printed); (d) in phase
     9's
     directory: the train CLI through torch.distributed.run on 4 ranks
     (mesh.data=2 mesh.graph=2) for an epoch of 16 images, then the test
     CLI on 4 ranks and on 1 rank of its checkpoint: the scores' largest
     gap printed, the mAPs within PAR_CLI_MAP_TOL; (e) one train step of
     configs/gkgnet_coco_768_dist.py on a world of 4 at its own batch, peak
     memory per rank, or a line saying the ranks did not fit (not a
     gate); (f) an NCCL world of one rank: every collective wrapper on
     CUDA tensors, then the t@128 step;
 14. GKGNet-T@576 (configs/gkgnet_t_coco_576.py as it is: channels 48 to
     384, so rows of D = 24, 48, 120 and 192; bf16, batch 8, seeded
     standard-normal input): exactly 16 knn_mr launches per eval forward,
     finite (8, 80) logits, ms/forward, peak memory and the device-busy
     share; every one of the forward's 16 calls held to its plain
     version on the model's own activations ((a)-(c) of phase 3), each
     distinct shape also timed (``row`` lines: (a)-(d));
     two train steps (16 + 16 launches each, finite losses), every one of
     their 32 backward calls with gx bitwise -g and gy bitwise the
     ordered plain version (a ``bwd_row`` per distinct shape); ms/step,
     peak memory and the busy share; then tools.profile_breakdown's eval
     tables on t@576 (its 5 + 4 rows for the 12 + 4 calls, the model both
     ways, the remainder and the MFU);

then the kernels line, nvidia-smi's line, and the result line.

Any failed check raises: the script exits non-zero and prints no result
line. It needs a CUDA device and the gkgnet_tpu_torch package beside it.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

T0 = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from gkgnet_tpu_torch import native  # noqa: E402
from gkgnet_tpu_torch.core.builder import (build_dataset,  # noqa: E402
                                           build_model)
from gkgnet_tpu_torch.core.checkpoint import load_params_only  # noqa: E402
from gkgnet_tpu_torch.core.export import (  # noqa: E402
    load_exported_classifier)
from gkgnet_tpu_torch.core.hooks import precise_bn  # noqa: E402
from gkgnet_tpu_torch.core.trainer import (create_train_state,  # noqa: E402
                                           make_eval_step, make_train_step)
from gkgnet_tpu_torch.data.coco import COCO_CLASSES  # noqa: E402
from gkgnet_tpu_torch.data.loader import (build_dataloader,  # noqa: E402
                                          default_collate)
from gkgnet_tpu_torch.data.voc import VOC_CLASSES  # noqa: E402
from gkgnet_tpu_torch import entry as entry_mod  # noqa: E402
from gkgnet_tpu_torch.entry import entry, predict, train_entry  # noqa: E402
from gkgnet_tpu_torch.core.optim import build_optimizer  # noqa: E402
from gkgnet_tpu_torch.nn import gkgnet as gkgnet_mod  # noqa: E402
from gkgnet_tpu_torch.nn import grapher  # noqa: E402
from gkgnet_tpu_torch.nn.augment import build_batch_augment  # noqa: E402
from gkgnet_tpu_torch.nn.classifier import init_parameters  # noqa: E402
from gkgnet_tpu_torch.nn.gkgnet import ARCH_SETTINGS, GKGNet  # noqa: E402
from gkgnet_tpu_torch.nn.layers import BatchNorm  # noqa: E402
from gkgnet_tpu_torch.ops import (_build, aggregate, knn_mr,  # noqa: E402
                                  knn_topk)
from gkgnet_tpu_torch.ops.aggregate import (fold_groups,  # noqa: E402
                                            max_relative, unfold_groups)
from gkgnet_tpu_torch.ops.knn import (knn_graph,  # noqa: E402
                                      knn_topk_reference, l2_normalize)
from gkgnet_tpu_torch.ops.pos_embed import get_relative_pos_table  # noqa: E402
from gkgnet_tpu_torch.parallel import (collectives,  # noqa: E402
                                       edge_partition, spawn)
from gkgnet_tpu_torch.parallel.mesh import (make_mesh,  # noqa: E402
                                            shard_batch)
from gkgnet_tpu_torch.parallel.sharding import graph_sharding  # noqa: E402
from gkgnet_tpu_torch.tools import exp_kernel_phases as phases  # noqa: E402
from gkgnet_tpu_torch.tools import inference  # noqa: E402
from gkgnet_tpu_torch.tools import make_synthetic_coco  # noqa: E402
from gkgnet_tpu_torch.tools import profile_breakdown  # noqa: E402
from gkgnet_tpu_torch.tools import test as test_cli  # noqa: E402
from gkgnet_tpu_torch.tools import train as train_cli  # noqa: E402
from gkgnet_tpu_torch.tools.analysis_tools import (  # noqa: E402
    analyze_logs, analyze_results, eval_metric, get_flops)
from gkgnet_tpu_torch.tools.convert_models import (  # noqa: E402
    from_reference)
from gkgnet_tpu_torch.tools.deployment import (  # noqa: E402
    export as export_cli)
from gkgnet_tpu_torch.tools.deployment import serve  # noqa: E402
from gkgnet_tpu_torch.tools.deployment import (  # noqa: E402
    test as deploy_test)
from gkgnet_tpu_torch.tools.misc import (print_config,  # noqa: E402
                                         verify_dataset)
from gkgnet_tpu_torch.tools.visualizations import (  # noqa: E402
    vis_cam, vis_edges)
from gkgnet_tpu_torch.utils import profiling  # noqa: E402
from gkgnet_tpu_torch.utils.weights import init_block_parameters  # noqa: E402

BG = 16                   # batch 8 x 2 channel groups
ORACLE_TOL = 1e-4         # ~2x the worst fp32 accumulation error at D=320
ORACLE_ROWS = 4096
FLIP_SHARE = 1e-3         # fp32: rows of a call whose idx may differ from
                          # the plain version's (near-ties, checked in fp64)
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
CLI_CONFIG = os.path.join(REPO_DIR, "configs", "gkgnet_synthetic_576.py")
# the test CLI's mAP against the train log's, same weights and images: the
# two score the same bytes with the same batch of 8 through the same
# deterministic kernels (no atomics; cuDNN and cuBLAS at one shape on one
# card), so the scores and the mAP are equal
CLI_MAP_TOL = 0.0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense; fp32 without TF32

# (name, N, M, D, k, dilation, bias table (channels, nodes, r) or None,
#  calls per forward (and per train step), dtype, targets: "pooled" /
#  "self" / "labels")
ROWS = [
    ("stage1", 20736, 1296, 40, 9, 1, (80, 20736, 4), 2, "bf16", "pooled"),
    ("stage2", 5184, 1296, 80, 9, 1, (160, 5184, 2), 2, "bf16", "pooled"),
    ("stage3_d2", 1296, 1296, 200, 9, 2, (400, 1296, 1), 4, "bf16", "self"),
    ("stage3_d3", 1296, 1296, 200, 9, 3, (400, 1296, 1), 2, "bf16", "self"),
    ("stage4_d3", 324, 324, 320, 9, 3, (640, 324, 1), 2, "bf16", "self"),
    ("label1", 80, 20736, 40, 9, 1, None, 1, "bf16", "labels"),
    ("label2", 80, 5184, 80, 9, 1, None, 1, "bf16", "labels"),
    ("label3", 80, 1296, 200, 9, 1, None, 1, "bf16", "labels"),
    ("label4", 80, 324, 320, 9, 1, None, 1, "bf16", "labels"),
    ("stage3_d2_fp32", 1296, 1296, 200, 9, 2, (400, 1296, 1), 0, "fp32",
     "self"),
]
# the same calls of GKGNet-S@448 with 20 classes (configs/gkgnet_voc_448.py,
# batch 16): 112^2 stage-1 nodes, 20 label rows
VOC_CONFIG = os.path.join(REPO_DIR, "configs", "gkgnet_voc_448.py")
VOC_BG = 32               # batch 16 x 2 channel groups
VOC_ROWS = [
    ("voc_stage1", 12544, 784, 40, 9, 1, (80, 12544, 4), 2, "bf16",
     "pooled"),
    ("voc_stage2", 3136, 784, 80, 9, 1, (160, 3136, 2), 2, "bf16", "pooled"),
    ("voc_stage3_d2", 784, 784, 200, 9, 2, (400, 784, 1), 4, "bf16", "self"),
    ("voc_stage3_d3", 784, 784, 200, 9, 3, (400, 784, 1), 2, "bf16", "self"),
    ("voc_stage4_d3", 196, 196, 320, 9, 3, (640, 196, 1), 2, "bf16", "self"),
    ("voc_label1", 20, 12544, 40, 9, 1, None, 1, "bf16", "labels"),
    ("voc_label2", 20, 3136, 80, 9, 1, None, 1, "bf16", "labels"),
    ("voc_label3", 20, 784, 200, 9, 1, None, 1, "bf16", "labels"),
    ("voc_label4", 20, 196, 320, 9, 1, None, 1, "bf16", "labels"),
]
VOC_DIFFICULT = 0.25      # the share of a written VOC object marked difficult


# knn_topk at the shapes of this slice's path: (name, N, M, D, k, bias table
#  or None, BG, calls per aggregator pass (the 9 g=1 blocks of one
#  aggregator) or per stochastic pass (3 'mr' blocks, 2 groups), dtype,
#  targets). k is the graph conv's k * dilation.
TOPK_ROWS = [
    ("grapher1", 20736, 1296, 80, 9, (80, 20736, 4), 8, "agg", "bf16",
     "pooled"),
    ("grapher2", 5184, 1296, 160, 9, (160, 5184, 2), 8, "agg", "bf16",
     "pooled"),
    ("grapher3_d2", 1296, 1296, 400, 18, (400, 1296, 1), 8, "agg", "bf16",
     "self"),
    ("grapher3_d3", 1296, 1296, 400, 27, (400, 1296, 1), 8, "agg", "bf16",
     "self"),
    ("grapher4_d3", 324, 324, 640, 27, (640, 324, 1), 8, "agg", "bf16",
     "self"),
    ("label1", 80, 20736, 80, 9, None, 8, "agg", "bf16", "labels"),
    ("label2", 80, 5184, 160, 9, None, 8, "agg", "bf16", "labels"),
    ("label3", 80, 1296, 400, 9, None, 8, "agg", "bf16", "labels"),
    ("label4", 80, 324, 640, 9, None, 8, "agg", "bf16", "labels"),
    ("stochastic3_d2", 1296, 1296, 200, 18, (400, 1296, 1), 16, "stoch",
     "bf16", "self"),
    ("stochastic3_d3", 1296, 1296, 200, 27, (400, 1296, 1), 16, "stoch",
     "bf16", "self"),
    ("stochastic4_d3", 324, 324, 320, 27, (640, 324, 1), 16, "stoch",
     "bf16", "self"),
    ("grapher3_d2_fp32", 1296, 1296, 400, 18, (400, 1296, 1), 8, None,
     "fp32", "self"),
]
# The slice's path at GKGNet-S@576 widths, batch 8: (stage, C, grid side,
# r, dilation) of the Grapher blocks, (stage, C, grid side) of the
# GrapherLabel blocks, and the stochastic 'mr' Graphers.
GRAPHER_BLOCKS = [(1, 80, 144, 4, 1), (2, 160, 72, 2, 1), (3, 400, 36, 1, 2),
                  (3, 400, 36, 1, 3), (4, 640, 18, 1, 3)]
LABEL_BLOCKS = [(1, 80, 144), (2, 160, 72), (3, 400, 36), (4, 640, 18)]
STOCHASTIC_BLOCKS = [(3, 400, 36, 1, 2), (3, 400, 36, 1, 3),
                     (4, 640, 18, 1, 3)]
AGGREGATORS = ("edge", "sage", "gin", "gat")


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return proc.stdout.strip().splitlines()[0]


def print_ptxas_summary(compiler_log: str) -> None:
    """One line per compiled kernel from nvcc's -Xptxas -v output."""
    lines: dict[str, list[str]] = {}
    name = None
    for line in compiler_log.splitlines():
        fn = re.search(r"Compiling entry function '_Z\w*?(knn_mr_kernel|"
                       r"knn_topk_kernel|l2norm_rows|row_sq|"
                       r"knn_mr_tc_kernel|knn_topk_tc_kernel)"
                       r"I(13__nv_bfloat16|f)?(?:Li(\d+)E)?(?:Lb([01])E)?"
                       r"(?:Li(\d+)E)?(?:Lb([01])E)?", line)
        bwd = re.search(r"Compiling entry function '_Z\w*?(rank_edges|"
                        r"target_offsets|row_split|target_sum)(\w*)'", line)
        if bwd:  # the backward's: type, folded or grouped, and its flags
            args = re.match(r"I(13__nv_bfloat16|f)?((?:Lb[01]E)*)(t|m)?"
                            r"(?:Li(\d+)E)?", bwd.group(2))
            parts = []
            if args:
                if args.group(1):
                    parts.append("fp32" if args.group(1) == "f" else "bf16")
                flags = re.findall(r"Lb([01])E", args.group(2))
                names = (("grouped", "folded"),
                         ("smem counts", "global counts")
                         if bwd.group(1) == "rank_edges"
                         else ("16-byte rows", "scalar rows"))
                parts += [on if flag == "1" else off
                          for flag, (on, off) in zip(flags, names)]
                if args.group(3):  # the tie masks' words
                    parts.append("k<=16" if args.group(3) == "t" else "k<=64")
                if args.group(4):
                    parts.append(f"{args.group(4)} edges in flight")
            name = bwd.group(1) + (f"<{', '.join(parts)}>" if parts else "")
        elif fn:
            # the tensor-core kernels are bf16 only: no type argument;
            # knn_topk's one flag is its chunked scan, knn_mr's the grouped
            # route (its chunked scan is the flag after the phase)
            dtype = "fp32" if fn.group(2) == "f" else "bf16"
            phase = int(fn.group(5) or 0)  # knn_mr_kernel's: 0 the forward
            topk = fn.group(1).startswith("knn_topk")
            name = f"{fn.group(1)}<{dtype}" + "".join(
                part for part, on in (
                    (f", KDM={fn.group(3)}", fn.group(3)),
                    (", grouped", fn.group(4) == "1" and not topk),
                    (f", {phases.PHASES[phase - 1]}", phase),
                    (", D-chunked", fn.group(6) == "1"
                     or (topk and fn.group(4) == "1"))) if on) + ">"
        elif name and ("spill" in line or "registers" in line):
            lines.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    for name, parts in lines.items():
        print(f"  ptxas {name}: {'; '.join(parts)}", flush=True)


BACKWARD_KERNELS = ("rank_edges", "target_offsets", "row_split",
                    "target_sum")
OUR_KERNELS = ("knn_mr_kernel", "knn_mr_tc_kernel", "l2norm_rows",
               *BACKWARD_KERNELS, "knn_topk_kernel", "knn_topk_tc_kernel",
               "row_sq")


def profile_device(run, unit: str, iters: int = 3) -> dict:
    """Device time by kernel over a few calls of ``run`` (torch.profiler),
    the share of it in the port's kernels, and the device's busy share of
    the host wall time under the profiler (one stream: kernels do not
    overlap). Returns the ms per call: ``wall``, ``busy`` and ``ours`` (by
    kernel name)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    ours = {}
    for e in kernels:
        for name in OUR_KERNELS:
            if name in e.key:
                ours[name] = ours.get(name, 0.0) + \
                    e.self_device_time_total / 1e3 / iters
    ours_ms = sum(ours.values())
    log(f"profile: {wall_ms:.2f} ms/{unit} host wall under the profiler; "
        f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
        f"of which the port's kernels {ours_ms:.2f} ms "
        f"({100 * ours_ms / max(busy_ms, 1e-9):.1f} %: " + ", ".join(
            f"{k} {v:.2f}" for k, v in ours.items()) + ")")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / iters:8.3f} ms "
              f"{e.count // iters:4d}x  {e.key[:100]}", flush=True)
    return dict(wall=wall_ms, busy=busy_ms, ours=ours)


def compare_fp32_paths() -> None:
    """GKGNet-S@576 at batch 1 in fp32 (TF32 off): the kernel path against
    the plain path.

    The logits are not held to a tolerance. The model at its seeded init is
    chaotic: two plain paths (on the card and on the CPU, whose convolutions
    round differently) already differ by a fifth of max|logit|, from a few
    near-tie neighbour flips per forward. The check that tells a right
    kernel from a wrong one is made per call on the forward's own
    activations instead: for each of the 16 calls, the kernel's idx must
    equal the plain version's on all but FLIP_SHARE of the rows; where they
    differ the fp64 oracle must hold (the flips are near-ties), and mr must
    be bitwise equal on every row whose idx agrees."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    fn, (model, x) = entry(device="cuda", batch=1, dtype=torch.float32)
    calls = []
    kernel_op = grapher.knn_mr_fused

    def recording(*args):
        out = kernel_op(*args)
        calls.append((args, out))
        return out

    grapher.knn_mr_fused = recording
    try:
        got = fn(model, x).cpu()
        grapher.knn_mr_fused = knn_mr.knn_mr_reference
        plain_card = fn(model, x).cpu()
    finally:
        grapher.knn_mr_fused = kernel_op
    plain_cpu = fn(copy.deepcopy(model).cpu(), x.cpu())
    check(len(calls) == 16, f"{len(calls)} graph-conv calls, expected 16")
    for i, ((xx, yy, bias, k, dil), (idx, mr)) in enumerate(calls):
        idx_p, mr_p = knn_mr.knn_mr_reference(xx, yy, bias, k, dil)
        same = (idx_p == idx).all(-1)
        flips = int((~same).sum())
        _, _, xn, yn = knn_mr.launch(xx, yy, bias, k, dil)
        gap = knn_mr.ordering_gaps(xn, yn, bias, idx, dil).max().item()
        print(f"  fp32 call {i:2d}: N={xx.shape[1]:5d} M={yy.shape[1]:5d} "
              f"D={xx.shape[2]:3d} k*d={k * dil:2d}: idx differs from the "
              f"plain version's on {flips}/{same.numel()} rows; worst fp64 "
              f"gap {gap:.2e}", flush=True)
        check(flips <= FLIP_SHARE * same.numel(), f"fp32 call {i}: {flips} "
              f"rows differ from the plain idx")
        check(gap <= ORACLE_TOL, f"fp32 call {i}: fp64 gap {gap:.2e}")
        check(torch.equal(mr[same], mr_p[same]), f"fp32 call {i}: mr differs "
              f"on rows whose idx agrees")
    scale = float(plain_cpu.abs().max())

    def rel(a, b):
        return float((a - b).abs().max()) / scale

    log(f"model fp32 batch 1: max|logit| {scale:.3e}; max|diff| / max|logit|:"
        f" kernel vs plain (card) {rel(got, plain_card):.3e}, kernel vs plain"
        f" (CPU) {rel(got, plain_cpu):.3e}, plain (card) vs plain (CPU) "
        f"{rel(plain_card, plain_cpu):.3e}")


def kernel_rows(rows: list = ROWS, bg: int = BG, tag: str = "row"
                ) -> list[dict]:
    """Phase 3 (and phase 11 at VOC@448's shapes): every main-path shape of
    the kernel against its plain version, ``bg`` rows of each. Returns one
    dict per row."""
    results = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (name, n, m, d, k, dil, table, calls, dt, targets) in rows:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn((bg, n, d), generator=gen, device="cuda").to(dtype)
        y = x if targets == "self" else torch.randn(
            (bg, m, d), generator=gen, device="cuda").to(dtype)
        bias = None if table is None else torch.from_numpy(
            get_relative_pos_table(*table)).cuda()
        check(bias is None or tuple(bias.shape) == (n, m), f"{name} bias")
        row = forward_row(name, x, y, bias, k, dil, calls, gen, tag)
        results.append(row)
        del x, y, bias
        torch.cuda.empty_cache()
    return results


def check_forward(name: str, x, y, bias, k: int, dil: int, gen) -> dict:
    """(a)-(c) of phase 3 for one knn_mr call on inputs x, y (y is x for
    self-kNN) and its bias: the checks, and their figures returned with
    the kernel's idx and mr."""
    bg, n, d = x.shape
    dtype = x.dtype
    idx, mr, xn, yn = knn_mr.launch(x, y, bias, k, dil)
    torch.cuda.synchronize()
    check(idx.shape == (bg, n, k) and mr.shape == x.shape
          and mr.dtype == dtype, f"{name}: output shapes")
    # (a) mr against the plain max-relative of the kernel's own idx
    mr_plain = max_relative(x, idx, y)
    max_abs_err = (mr.float() - mr_plain.float()).abs().max().item()
    check(torch.equal(mr, mr_plain), f"{name}: mr not bitwise equal to "
          f"the plain max-relative of the kernel's idx "
          f"(max |diff| {max_abs_err})")
    # (b) fp64 ordering oracle on ORACLE_ROWS rows (all if fewer)
    total = bg * n
    sample = None if total <= ORACLE_ROWS else torch.randperm(
        total, generator=gen, device="cuda")[:ORACLE_ROWS]
    gaps = knn_mr.ordering_gaps(xn, yn, bias, idx, dil, sample)
    n_checked = gaps.shape[0]
    violations = int((gaps > ORACLE_TOL).sum().item())
    worst = gaps.max().item()
    check(violations == 0, f"{name}: {violations} slots off the fp64 "
          f"order by more than {ORACLE_TOL} (worst {worst:.3e})")
    # knn_topk on the kernel's own normalized rows, every d-th: the
    # same selection and arithmetic give bitwise knn_mr's idx
    t_idx = knn_topk.launch(xn, yn, k=k * dil, bias=bias)[..., ::dil]
    check(torch.equal(t_idx, idx), f"{name}: knn_topk(xn, yn, k*d)"
          f"[..., ::d] differs from knn_mr's idx")
    del t_idx
    # (c) agreement with the plain version's own idx (not asserted)
    idx_p, _ = knn_mr.knn_mr_reference(x, y, bias, k, dil)
    same = (idx_p == idx).all(-1).float().mean().item()
    del idx_p, xn, yn, mr_plain, gaps
    return dict(idx=idx, mr=mr, max_abs_err=max_abs_err,
                oracle_rows=n_checked, oracle_violations=violations,
                oracle_worst_gap=worst, idx_rows_equal_plain=same)


def forward_row(name: str, x, y, bias, k: int, dil: int, calls: int, gen,
                tag: str = "row") -> dict:
    """(a)-(d) of phase 3 for one knn_mr call on inputs x, y (y is x for
    self-kNN) and its bias: printed as a ``tag`` line and returned."""
    bg, n, d = x.shape
    m = y.shape[1]
    dtype = x.dtype
    dt = "bf16" if dtype == torch.bfloat16 else "fp32"
    checked = check_forward(name, x, y, bias, k, dil, gen)
    idx, mr = checked.pop("idx"), checked.pop("mr")
    # (d) times
    iters = 20 if n * m < 10**7 else 10
    ms = cuda_ms(lambda: knn_mr.launch(x, y, bias, k, dil), iters, 3)
    plain_ms = cuda_ms(
        lambda: knn_mr.knn_mr_reference(x, y, bias, k, dil), 3, 1)
    # least time for the same work: inputs read once, outputs written
    # once; the distance products at the dense peak of the input type
    nbytes = (x.nbytes + (0 if y is x else y.nbytes)
              + (0 if bias is None else bias.nbytes)
              + idx.nbytes + mr.nbytes)
    flops = 2.0 * bg * n * m * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    smem, chunked = knn_mr.block_layout(d, k * dil, dtype)
    row = dict(name=name, dtype=dt, BG=bg, N=n, M=m, D=d, kd=k * dil,
               smem_bytes=smem, chunked=chunked,
               calls_per_forward=calls, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               **checked)
    print(f"{tag} " + json.dumps(row), flush=True)
    del idx, mr
    return row


def tie_fixture(x: torch.Tensor, y: torch.Tensor) -> None:
    """Make query row 0 of every group tie exactly in its max on every
    channel: four equal target rows along its own direction (y rows 0-3 =
    3 x_0; with y = x, rows 0-3 equal) are its nearest targets, so the
    kept slots 0 and d hold two of them for a dilation d <= 3, and x_0 is
    large enough that every other rel is below theirs."""
    gen = torch.Generator().manual_seed(99)
    base = 5.0 * (1.0 + 0.1 * torch.randn(x.shape[-1], generator=gen))
    base = base.to(x.device)
    if y is x:
        x[:, :4] = base
    else:
        x[:, 0] = base
        y[:, :4] = 3.0 * base


def bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of a float tensor: bitwise comparisons that tell
    -0.0 from 0.0."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_backward(name: str, x, y, idx, g, out) -> tuple[float, float, int]:
    """(e) and (f) for one backward launch ``out = (gx, gy)``. Returns the
    largest |gy - the ordered plain gy| (0: bitwise), the largest
    |gy - exact fp64 sum| and the number of rows with a tie."""
    gx, gy = out
    check(gx.dtype == x.dtype and gy.shape == y.shape and gy.dtype == y.dtype,
          f"{name}: backward output shapes")
    check(torch.equal(gx, -g), f"{name}: gx is not -g")
    _, want = knn_mr.knn_mr_backward_ordered_reference(x, y, idx, g)
    err = (gy.float() - want.float()).abs().max().item()
    check(torch.equal(bits(gy), bits(want)), f"{name}: gy not bitwise the "
          f"ordered plain version's (max |diff| {err:.3e})")
    del want
    ge_ref = knn_mr.edge_gradients_reference(x, y, idx, g)
    tie_rows = int(((ge_ref != 0).sum(dim=2) > 1).any(dim=-1).sum())
    exact, bound = knn_mr.backward_gy_bound(ge_ref, idx, y.shape[1])
    del ge_ref
    gap = (gy.double() - exact).abs()
    over = int((gap > bound).sum())
    check(over == 0, f"{name}: gy off the fp64 sum beyond the bound at "
          f"{over} entries (worst {gap.max().item():.3e})")
    return err, gap.max().item(), tie_rows


def in_degrees(idx: torch.Tensor, m: int) -> tuple[int, float]:
    """The largest and the 99th-percentile number of edges into a target."""
    deg = torch.bincount(knn_mr._flat_targets(idx, m),
                         minlength=idx.shape[0] * m).float()
    return int(deg.max()), float(deg.quantile(0.99))


def backward_rows(rows: list = ROWS, bg: int = BG, tag: str = "bwd_row"
                  ) -> list[dict]:
    """Phase 3, backward (and phase 11 at VOC@448's shapes): every
    main-path shape of the backward kernel against its plain version, on
    tie fixtures, ``bg`` rows of each. Returns one dict per row."""
    results = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (name, n, m, d, k, dil, table, calls, dt, targets) in rows:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = torch.randn((bg, n, d), generator=gen, device="cuda")
        y = x if targets == "self" else torch.randn(
            (bg, m, d), generator=gen, device="cuda")
        tie_fixture(x, y)
        x = x.to(dtype)
        y = x if targets == "self" else y.to(dtype)
        bias = None if table is None else torch.from_numpy(
            get_relative_pos_table(*table)).cuda()
        idx, _, _, _ = knn_mr.launch(x, y, bias, k, dil)
        del bias
        g = torch.randn((bg, n, d), generator=gen, device="cuda").to(dtype)
        row = backward_row(name, x, y, idx, g, calls, tag)
        check(row["tie_rows"] >= bg, f"{name}: the tie fixture gave "
              f"{row['tie_rows']} rows with a tie")
        results.append(row)
        del x, y, idx, g
        torch.cuda.empty_cache()
    return results


def backward_row(name: str, x, y, idx, g, calls: int, tag: str = "bwd_row"
                 ) -> dict:
    """(e)-(g) of phase 3 for one backward call on x, y (y is x for
    self-kNN), the forward's idx and the output gradient g: printed as a
    ``tag`` line and returned."""
    bg, n, d = x.shape
    m, k = y.shape[1], idx.shape[2]
    dt = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    out = knn_mr.launch_backward(x, y, idx, g)
    torch.cuda.synchronize()
    max_abs_err, fp64_err, tie_rows = check_backward(name, x, y, idx, g, out)
    # (g) determinism, then times
    again = knn_mr.launch_backward(x, y, idx, g)
    check(torch.equal(bits(out[0]), bits(again[0]))
          and torch.equal(bits(out[1]), bits(again[1])),
          f"{name}: two launches differ")
    del again
    iters = 20 if n * m < 10**7 else 10
    ms = cuda_ms(lambda: knn_mr.launch_backward(x, y, idx, g), iters, 3)
    plain_ms = cuda_ms(
        lambda: knn_mr.knn_mr_backward_reference(x, y, idx, g), 3, 1)
    # least time: x, y, idx, g read once, gx and gy written once; per
    # edge and channel a subtraction, a comparison, a split and an add
    gx, gy = out
    nbytes = (x.nbytes + (0 if y is x else y.nbytes)
              + idx.nbytes + g.nbytes + gx.nbytes + gy.nbytes)
    flops = 4.0 * bg * n * k * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["fp32"] * 1e3
    max_deg, p99_deg = in_degrees(idx, m)
    row = dict(name=name, dtype=dt, BG=bg, N=n, M=m, D=d, k=k,
               calls_per_step=calls, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=max_abs_err, fp64_err=fp64_err,
               tie_rows=tie_rows, max_in_degree=max_deg,
               p99_in_degree=p99_deg)
    print(f"{tag} " + json.dumps(row), flush=True)
    return row


# The gather's backward (aggregate.gather_backward, csrc/knn_mr_bwd.cu) at
# the label-sharded build's calls of phase 13 (b) (BG 16, a graph rank's
# half of the stage's targets; its owner-side fetch clamps the other
# rank's winners onto two hub targets) and at the Grapher path's stage-1
# 'edge' gather: (name, BG, N, k, M, D, M of the whole stage or None, calls
# per train step of a (b) rank).
GATHER_ROWS = [
    ("label1_local", 16, 80, 9, 10368, 40, 20736, 1),
    ("label2_local", 16, 80, 9, 2592, 80, 5184, 1),
    ("label3_local", 16, 80, 9, 648, 200, 1296, 1),
    ("label4_local", 16, 80, 9, 162, 320, 324, 1),
    ("grapher1_edge", 8, 20736, 9, 1296, 80, None, 0),
]


def gather_rows() -> list[dict]:
    """Phase 3, the gather's backward: each row's kernel against its plain
    version (``gather_row``)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for (name, bg, n, k, m, d, whole, calls) in GATHER_ROWS:
        if whole is None:
            idx = torch.randint(0, m, (bg, n, k), generator=gen,
                                device="cuda", dtype=torch.int32)
        else:  # rank 0's lidx: the winners over the whole stage, clamped
            idx = torch.randint(0, whole, (bg, n, k), generator=gen,
                                device="cuda").clamp(0, m - 1).int()
        g = torch.randn((bg, n, k, d), generator=gen,
                        device="cuda").bfloat16()
        rows.append(gather_row(name, g, idx, m, calls))
        del idx, g
    torch.cuda.empty_cache()
    return rows


def gather_row(name: str, g, idx, m: int, calls: int) -> dict:
    """The gather backward kernel on g (BG, N, k, D) and idx: gy bitwise
    the ordered plain version (each target's fp32 sum in ascending edge
    id) and within the fp64 bound, a second launch bitwise the first (no
    float atomics), and the kernel's, the plain version's and one
    ``index_add_``'s times (the scatter-add that ``torch.gather``'s own
    backward is, with float atomics); printed as a ``gather_row`` line."""
    bg, n, k, d = g.shape
    gy = knn_mr.launch_gather_backward(g, idx, m)
    torch.cuda.synchronize()
    want = aggregate.gather_backward_ordered_reference(g, idx, m)
    err = (gy.float() - want.float()).abs().max().item()
    check(torch.equal(bits(gy), bits(want)), f"{name}: gy not bitwise the "
          f"ordered plain version's (max |diff| {err:.3e})")
    exact, bound = knn_mr.backward_gy_bound(g, idx, m)
    gap = (gy.double() - exact).abs()
    check(bool((gap <= bound).all()), f"{name}: gy off the fp64 sum beyond "
          f"the bound (worst {gap.max().item():.3e})")
    again = knn_mr.launch_gather_backward(g, idx, m)
    check(torch.equal(bits(again), bits(gy)), f"{name}: two launches differ")
    del want, exact, bound, again
    ms = cuda_ms(lambda: knn_mr.launch_gather_backward(g, idx, m), 20, 3)
    plain_ms = cuda_ms(
        lambda: aggregate.gather_backward_reference(g, idx, m), 5, 1)
    flat = aggregate._flat_targets(idx, m)
    rows, out = g.reshape(-1, d), torch.zeros((bg * m, d), dtype=g.dtype,
                                              device="cuda")
    library_ms = cuda_ms(lambda: out.index_add_(0, flat, rows), 20, 3)
    # least time: g and idx read once, gy written once; an add per edge
    # and channel
    nbytes = g.nbytes + idx.nbytes + gy.nbytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = bg * n * k * d / PEAK_FLOPS["fp32"] * 1e3
    max_deg, p99_deg = in_degrees(idx, m)
    row = dict(name=name, dtype="bf16", BG=bg, N=n, k=k, M=m, D=d,
               calls_per_step=calls, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=err, fp64_err=gap.max().item(),
               max_in_degree=max_deg, p99_in_degree=p99_deg)
    print("gather_row " + json.dumps(row), flush=True)
    return row


def topk_value_bounds(xn: torch.Tensor, yn: torch.Tensor,
                      bias: torch.Tensor | None, idx: torch.Tensor,
                      rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For the flat query ``rows`` (into BG*N) and their selected columns
    ``idx``: the fp64 distances (bias included) and the bound the kernel's
    computation of them meets, gamma(j) * (x_sq + 2 sum|x_e y_e| + y_sq +
    |bias|) with gamma(j) = j u / (1 - j u), u = 2**-24. Both (rows, k)
    fp64.

    fp32 rows (the CUDA-core kernel): j = D + 3, D products summed by fmaf
    in fp32, then three more roundings.

    bf16 rows (the tensor-core kernel, csrc/knn_scan.cuh): each product of
    two bf16 values is exact in fp32, and one mma.m16n8k16 step adds 16 of
    them to the fp32 accumulator. Taking the step as tensor cores are
    measured to add (the 17 terms aligned to the largest exponent and cut
    to fp32's 24 bits, summed, the sum cut to 24 bits again: truncation, no
    extra bits, the least precise of the reported behaviours), each of the
    16 cut terms loses less than 2u max|term| and the sum less than
    2u |sum|, so a step is off by less than 34u sum|x_e y_e|, and the
    ceil(D/16) steps' dot product by 34 ceil(D/16) u sum|x_e y_e|. The
    distance doubles it (exactly), then takes the three IEEE roundings of
    x_sq - 2 dot + y_sq (+ bias); x_sq and y_sq are fp32 sums of D exact
    squares, off by gamma(D - 1) < 34 ceil(D/16) u of themselves. So
    j = 34 ceil(D/16) + 3 (D = 80: 173 against the fp32 kernel's 83)."""
    bg, n, d = xn.shape
    k = idx.shape[-1]
    b_of, n_of = rows // n, rows % n
    q = xn.reshape(bg * n, d)[rows].double()                    # (R, D)
    cols = idx.reshape(bg * n, k)[rows].long()                  # (R, k)
    t = yn.double()[b_of[:, None], cols]                        # (R, k, D)
    prod = q[:, None, :] * t
    exact = (q * q).sum(-1)[:, None] - 2.0 * prod.sum(-1) + (t * t).sum(-1)
    scale = (q * q).sum(-1)[:, None] + 2.0 * prod.abs().sum(-1) \
        + (t * t).sum(-1)
    if bias is not None:
        b = (bias[b_of, n_of] if bias.dim() == 3 else bias[n_of]).double()
        bsel = b.gather(1, cols)
        exact = exact + bsel
        scale = scale + bsel.abs()
    j = 34 * ((d + 15) // 16) + 3 if xn.dtype == torch.bfloat16 else d + 3
    ju = j * 2.0 ** -24
    return exact, ju / (1.0 - ju) * scale


def check_topk(name: str, xn, yn, bias, idx, vals, rows=None,
               max_flip_share: float | None = None) -> dict:
    """A knn_topk result held to its contract on finite inputs: (1) the
    fp64 ordering oracle (each slot's fp64 distance within ORACLE_TOL of
    the true rank's) on ``rows`` (all by default) and on every row whose
    idx differs from the plain version's, where the plain idx must pass it
    too: a row may differ only at a near-tie, which fp32 sums taken in
    another order decide otherwise (with ``max_flip_share``, at most that
    share of the rows); (2) each returned distance within its fp32 bound of
    the fp64 distance. Returns the counts."""
    bg, n, _ = xn.shape
    plain = knn_topk_reference(xn, yn, k=idx.shape[-1], bias=bias)
    diff = (plain != idx).any(-1).reshape(-1).nonzero().squeeze(1)
    flips = diff.numel()
    check(max_flip_share is None or flips <= max_flip_share * bg * n,
          f"{name}: idx differs from the plain version's on {flips} of "
          f"{bg * n} rows")
    if rows is None:
        rows = torch.arange(bg * n, device=xn.device)
    rows = torch.unique(torch.cat([rows, diff]))
    worst = 0.0
    for got in (idx, plain):
        gaps = knn_mr.ordering_gaps(xn, yn, bias, got, 1, rows)
        worst = max(worst, gaps.max().item())
        check(worst <= ORACLE_TOL, f"{name}: a slot off the fp64 order by "
              f"{worst:.3e} (> {ORACLE_TOL})")
        if not flips:
            break
    max_err = 0.0
    if vals is not None:
        for part in rows.split(8192):
            exact, bound = topk_value_bounds(
                xn, yn, bias, idx, part)
            err = (vals.reshape(bg * n, -1)[part].double() - exact).abs()
            over = int((err > bound).sum())
            check(over == 0, f"{name}: {over} distances off the fp64 ones "
                  f"beyond the fp32 bound (worst {err.max().item():.3e})")
            max_err = max(max_err, err.max().item())
    return dict(flips=flips, oracle_rows=rows.numel(), oracle_worst_gap=worst,
                max_abs_err=max_err)


def topk_fixture(x: torch.Tensor, y: torch.Tensor, self_knn: bool
                 ) -> list[tuple[int, int]]:
    """Exact ties and NaN rows for a knn_topk call without bias, on fp32
    x and y: ``tie_fixture``'s tied targets (rows 0-3 of y equal along
    query 0's direction, or rows 0-3 of x equal when y is x), a NaN query
    row (group 0, row 10) and a NaN target row (group 1, row 5; with y = x
    a NaN query row as well). Returns the (group, row) of the queries whose
    idx must equal the plain version's bitwise."""
    tie_fixture(x, y if not self_knn else x)
    x[0, 10] = float("nan")
    (x if self_knn else y)[1, 5] = float("nan")
    rows = [(0, 0), (0, 10)] + ([(0, 1), (0, 2), (0, 3), (1, 5)]
                                if self_knn else [])
    return rows


def topk_rows() -> list[dict]:
    """Phase 3, knn_topk: every shape of this slice's path against the plain
    version. Returns one dict per row."""
    results = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    for (name, n, m, d, k, table, bg, pass_, dt, targets) in TOPK_ROWS:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        self_knn = targets == "self"
        x = torch.randn((bg, n, d), generator=gen, device="cuda")
        y = x if self_knn else torch.randn((bg, m, d), generator=gen,
                                           device="cuda")
        xn = l2_normalize(x.to(dtype))
        yn = xn if self_knn else l2_normalize(y.to(dtype))
        bias = None if table is None else torch.from_numpy(
            get_relative_pos_table(*table)).cuda()
        check(bias is None or tuple(bias.shape) == (n, m), f"{name} bias")

        idx, vals = knn_topk.launch(xn, yn, k=k, bias=bias,
                                    return_values=True)
        torch.cuda.synchronize()
        check(idx.shape == (bg, n, k) and idx.dtype == torch.int32
              and vals.shape == (bg, n, k), f"{name}: output shapes")
        total = bg * n
        rows = None if total <= ORACLE_ROWS else torch.randperm(
            total, generator=gen, device="cuda")[:ORACLE_ROWS]
        stats = check_topk(name, xn, yn, bias, idx, vals, rows)
        again = knn_topk.launch(xn, yn, k=k, bias=bias, return_values=True)
        check(torch.equal(again[0], idx) and torch.equal(again[1], vals),
              f"{name}: two launches differ")
        del again
        # exact ties and NaN rows (no bias: a bias would break the ties)
        fx = x.clone()
        fy = fx if self_knn else y.clone()
        fixed = topk_fixture(fx, fy, self_knn)
        fxn = l2_normalize(fx.to(dtype))
        fyn = fxn if self_knn else l2_normalize(fy.to(dtype))
        f_idx, f_vals = knn_topk.launch(fxn, fyn, k=k, return_values=True)
        p_idx, p_vals = knn_topk_reference(fxn, fyn, k=k,
                                           return_values=True)
        for g_, r_ in fixed:
            check(torch.equal(f_idx[g_, r_], p_idx[g_, r_]), f"{name}: "
                  f"fixture row ({g_}, {r_}): {f_idx[g_, r_].tolist()} vs "
                  f"plain {p_idx[g_, r_].tolist()}")
        check(f_idx[0, 0, :4].tolist() == [0, 1, 2, 3],
              f"{name}: tied targets not in column order")
        check(bool(torch.isnan(f_vals[0, 10]).all())
              and f_idx[0, 10].tolist() == list(range(k)),
              f"{name}: the NaN query row")
        finite = torch.isfinite(fxn[1]).all(-1)
        check(not bool((f_idx[1][finite] == 5).any()), f"{name}: the NaN "
              f"target row was chosen")
        del fx, fy, fxn, fyn, f_idx, f_vals, p_idx, p_vals
        # times: the kernel, the plain version, and the two-call PyTorch
        # route (fp32 baddbmm + topk: no single PyTorch call computes it)
        iters = 20 if n * m < 10**7 else 10
        ms = cuda_ms(lambda: knn_topk.launch(xn, yn, k=k, bias=bias), iters,
                     3)
        plain_ms = cuda_ms(
            lambda: knn_topk_reference(xn, yn, k=k, bias=bias), 3, 1)
        x32, y32 = xn.float(), yn.float()
        base = (x32 * x32).sum(-1)[:, :, None] \
            + (y32 * y32).sum(-1)[:, None, :]
        if bias is not None:
            base = base + bias
        two_call_ms = cuda_ms(lambda: torch.topk(torch.baddbmm(
            base, x32, y32.transpose(1, 2), alpha=-2.0), k, largest=False),
            3, 1)
        del x32, y32, base
        nbytes = (xn.nbytes + (0 if self_knn else yn.nbytes)
                  + (0 if bias is None else bias.nbytes) + idx.nbytes)
        flops = 2.0 * bg * n * m * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dt] * 1e3
        row = dict(name=name, dtype=dt, BG=bg, N=n, M=m, D=d, k=k,
                   smem_bytes=knn_topk.block_layout(d, k, dtype)[0],
                   calls_per_pass=1 if pass_ == "agg" else 0,
                   calls_per_stochastic_pass=1 if pass_ == "stoch" else 0,
                   ms=ms, plain_ms=plain_ms, two_call_ms=two_call_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   **stats)
        print("topk_row " + json.dumps(row), flush=True)
        results.append(row)
        del x, y, xn, yn, bias, idx, vals
        torch.cuda.empty_cache()
    return results


def make_blocks(conv: str, dtype: torch.dtype, batch: int, seed: int
                ) -> list[tuple[str, torch.nn.Module, tuple]]:
    """This slice's blocks for one aggregator at GKGNet-S@576 widths: the 5
    Graphers and 4 GrapherLabels without channel groups (drop_path 0.1,
    seeded weights and inputs, each Grapher with its stage's relative-
    position table), or, for conv 'stochastic', the 3 'mr' Graphers with
    stochastic dilation (epsilon 0.2, 2 groups). Returns (name, module,
    inputs) on the card."""
    wgen = torch.Generator().manual_seed(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    blocks = []
    specs = STOCHASTIC_BLOCKS if conv == "stochastic" else GRAPHER_BLOCKS
    for stage, c, side, r, dil in specs:
        if conv == "stochastic":
            m = grapher.Grapher(c, 9, dil, "mr", "gelu", r=r, stochastic=True,
                                epsilon=0.2, num_group=2, drop_path=0.1,
                                dtype=dtype)
        else:
            m = grapher.Grapher(c, 9, dil, conv, "gelu", r=r, drop_path=0.1,
                                use_multi_group=False, dtype=dtype)
        x = torch.randn((batch, side, side, c), generator=gen,
                        device="cuda").to(dtype)
        bias = torch.from_numpy(get_relative_pos_table(
            c, side * side, r)).cuda()
        blocks.append((f"grapher{stage}_d{dil}", m, (x, bias)))
    if conv != "stochastic":
        for stage, c, side in LABEL_BLOCKS:
            m = grapher.GrapherLabel(c, 9, conv=conv, act="gelu",
                                     drop_path=0.1, use_multi_group=False,
                                     dtype=dtype)
            labels = torch.randn((batch, 80, c), generator=gen,
                                 device="cuda").to(dtype)
            feats = torch.randn((batch, side, side, c), generator=gen,
                                device="cuda").to(dtype)
            blocks.append((f"label{stage}", m, (labels, feats)))
    for _, m, _ in blocks:
        init_block_parameters(m, wgen)
        m.cuda()
    return blocks


def run_block(module, inputs, train: bool, gen) -> torch.Tensor:
    """One pass of a block: the eval forward, or a train-mode forward and
    the backward of a scalar loss. Returns the output."""
    module.train(train)
    with torch.set_grad_enabled(train):
        out = module(*inputs, gen)
        out = out[0] if isinstance(out, tuple) else out
        if train:
            module.zero_grad(set_to_none=True)
            out.float().square().mean().backward()
    return out


def counted_pass(blocks, train: bool, gen) -> tuple[int, int, int, int]:
    """Every block once with the launch counts set to 0 just before; checks
    finite outputs and gradients; returns the counts read just after:
    (knn_topk, knn_mr forward, knn_mr backward, gather backward)."""
    knn_topk.launches = 0
    knn_mr.launches = 0
    knn_mr.backward_launches = 0
    knn_mr.gather_backward_launches = 0
    for name, m, inputs in blocks:
        out = run_block(m, inputs, train, gen)
        check(bool(torch.isfinite(out).all()), f"{name}: output not finite")
        if train:
            bad = [k for k, p in m.named_parameters()
                   if p.grad is None or not bool(torch.isfinite(p.grad).all())]
            check(not bad, f"{name}: missing or non-finite gradients "
                  f"{bad[:4]}")
    torch.cuda.synchronize()
    return (knn_topk.launches, knn_mr.launches, knn_mr.backward_launches,
            knn_mr.gather_backward_launches)


def grapher_phase() -> dict:
    """Phase 6: this slice's path. Per aggregator, the 9 blocks in eval and
    in train (9 knn_topk launches and no knn_mr launch each; in train a
    gather backward in each of the 5 Graphers), then ms per block; then the stochastic 'mr'
    blocks in train (3 knn_topk and 3 gather backward, no knn_mr) and in
    eval (the fused route: 3 knn_mr, no knn_topk). Returns the launches and
    the times."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    launches = gathers = 0
    times = {}
    for conv in AGGREGATORS + ("stochastic",):
        blocks = make_blocks(conv, torch.bfloat16, 8, seed=10)
        n = len(blocks)
        # the label blocks' targets are inputs, which take no gradient
        spatial = sum(not name.startswith("label") for name, _, _ in blocks)
        for train in (False, True):
            counts = counted_pass(blocks, train, gen)
            if conv == "stochastic" and not train:
                want = (0, n, 0, 0)
            else:
                want = (n, 0, 0, spatial if train else 0)
            check(counts == want, f"{conv} {'train' if train else 'eval'}: "
                  f"launches (knn_topk, knn_mr, knn_mr backward, gather "
                  f"backward) {counts}, expected {want}")
            if conv != "stochastic" or train:
                launches += counts[0]
            gathers += counts[3]
        for name, m, inputs in blocks:
            eval_ms = cuda_ms(lambda: run_block(m, inputs, False, gen), 3, 1)
            train_ms = cuda_ms(lambda: run_block(m, inputs, True, gen), 2, 1)
            times[f"{conv}/{name}"] = (eval_ms, train_ms)
            print(f"  block {conv:10s} {name:12s}: eval {eval_ms:8.3f} ms, "
                  f"train fwd+bwd {train_ms:8.3f} ms", flush=True)
        mine = [t for key, t in times.items() if key.startswith(conv + "/")]
        route = ("train: knn_topk; eval: the fused knn_mr route"
                 if conv == "stochastic" else "knn_topk in eval and train")
        log(f"grapher path {conv}: passed, {n} blocks ({route}); "
            f"{sum(t[0] for t in mine):.2f} ms eval, "
            f"{sum(t[1] for t in mine):.2f} ms train fwd+bwd in all")
        del blocks
        torch.cuda.empty_cache()
    return dict(launches=launches, gathers=gathers, times=times)


def compare_fp32_grapher() -> None:
    """This slice's blocks at batch 2 in fp32 (TF32 off): every knn_topk
    call held to the plain version on the block's own activations
    (check_topk), by patching ``knn_topk.launch``, which ``knn_graph`` looks
    up at call time: the 9 blocks of each aggregator in eval, and the 3
    stochastic 'mr' blocks in train."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = []
    kernel = knn_topk.launch

    def recording(x, y, *, k, bias=None, return_values=False):
        out = kernel(x, y, k=k, bias=bias, return_values=True)
        calls.append((x, y, bias, out))
        return out if return_values else out[0]

    gen = torch.Generator(device="cuda").manual_seed(8)
    knn_topk.launch = recording
    try:
        for conv in AGGREGATORS + ("stochastic",):
            for _, m, inputs in make_blocks(conv, torch.float32, 2, seed=11):
                with torch.no_grad():
                    m.train(conv == "stochastic")
                    m(*inputs, gen)
    finally:
        knn_topk.launch = kernel
    check(len(calls) == 9 * len(AGGREGATORS) + 3,
          f"{len(calls)} knn_topk calls, expected {9 * len(AGGREGATORS) + 3}")
    flips = worst = 0
    for i, (x, y, bias, (idx, vals)) in enumerate(calls):
        stats = check_topk(f"fp32 call {i}", x, y, bias, idx, vals,
                           max_flip_share=FLIP_SHARE)
        flips += stats["flips"]
        worst = max(worst, stats["oracle_worst_gap"])
    log(f"grapher fp32 batch 2: {len(calls)} knn_topk calls held to the plain "
        f"version on the blocks' own activations: {flips} rows differ in all "
        f"(near-ties, each within the fp64 oracle), worst fp64 gap "
        f"{worst:.2e}")


def train_phase() -> dict:
    """Phase 5: the training step's main path, 3 steps at batch 8 in bf16,
    then its time, memory and profile. Returns its launch counts and
    numbers."""
    fn, (state, batch) = train_entry(device="cuda", batch=8)
    model = state.model
    log("train: GKGNet-S@576 bf16, batch 8, drop_path 0.1, AdamW + EMA, "
        "built")
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    knn_mr.launches = 0
    knn_mr.grouped_launches = 0
    knn_mr.backward_launches = 0
    knn_topk.launches = 0
    for i in range(3):
        f0, b0 = knn_mr.launches, knn_mr.backward_launches
        t = time.perf_counter()
        state, logs = fn(state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        fwd, bwd = knn_mr.launches - f0, knn_mr.backward_launches - b0
        check(fwd == 16 and bwd == 16, f"train step {i}: {fwd} forward and "
              f"{bwd} backward launches, expected 16 and 16")
        values = {k: float(v) for k, v in logs.items()}
        if i == 0:  # phase 7 holds the grouped route's first step to these
            step1 = (values["loss"], {k: p.grad.detach().clone() for k, p in
                                      model.named_parameters()})
        for key in ("loss", "bce_loss", "asy_loss", "grad_norm"):
            check(math.isfinite(values[key]),
                  f"train step {i}: {key} = {values[key]}")
        log(f"train step {i}: {step_s * 1e3:.1f} ms host wall; " + ", ".join(
            f"{k} {v:.6g}" for k, v in values.items()))
    launches = (knn_mr.launches, knn_mr.backward_launches)
    check(knn_topk.launches == 0 and knn_mr.grouped_launches == 0,
          f"{knn_topk.launches} knn_topk and {knn_mr.grouped_launches} "
          f"grouped launches in 3 train steps, expected 0")
    unmoved = [k for k, v in model.named_parameters()
               if torch.equal(v.detach(), p0[k])]
    check(not unmoved, f"parameters that did not move: {unmoved[:5]}")
    sd = model.state_dict()
    still = [k for k, v in stats0.items() if torch.equal(sd[k], v)]
    check(not still, f"BatchNorm statistics that did not move: {still[:5]}")
    key = "backbone.stem.convs.0.weight"
    ema, p3 = state.ema_params[key], sd[key]
    check(not torch.equal(ema, p3) and not torch.equal(ema, p0[key])
          and (ema - p0[key]).abs().max() < (p3 - p0[key]).abs().max(),
          "the EMA is not between the initial and the new parameters")
    log(f"train: 3 steps passed: {launches[0]} forward and {launches[1]} "
        f"backward launches, every parameter and BatchNorm statistic moved, "
        f"the EMA between")

    torch.cuda.reset_peak_memory_stats()
    iters = 5
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / iters
    peak = torch.cuda.max_memory_allocated()
    log(f"train: {step_ms:.2f} ms/step at batch 8, {8e3 / step_ms:.1f} img/s "
        f"(bf16, mean of {iters} steps, host clock with synchronize); peak "
        f"memory {peak / 2**30:.2f} GiB")
    profile_device(lambda: fn(state, batch), "step", iters=2)
    del fn, state, batch, model, p0, stats0, sd
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms, peak_bytes=peak,
                step1=step1)


def compare_fp32_train() -> None:
    """One training step of GKGNet-S@576 at batch 2 in fp32 (TF32 off): each
    of the 16 backward calls held to the plain version on the step's own
    activations ((e) and (f)); then the same step from the same start on
    the plain path (both kernels replaced by their plain versions), and on
    the kernel path with every image value moved by one fp32 ulp. The
    losses and gradient norms are printed, not asserted: a near-tie
    neighbour flip in the forward changes the step (see
    compare_fp32_paths), and the one-ulp run shows how far the model
    itself moves the step for a change below any kernel's error."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = []
    kernel_bwd = knn_mr.launch_backward
    kernel_fwd = knn_mr.launch

    def recording(x, y, idx, g):
        out = kernel_bwd(x, y, idx, g)
        calls.append(((x, y, idx, g), out))
        return out

    def plain_fwd(x, y, bias, k, dilation):
        idx, mr = knn_mr.knn_mr_reference(x, y, bias, k, dilation)
        return idx, mr, l2_normalize(x), l2_normalize(y)

    def plain_bwd(x, y, idx, g):
        return knn_mr.knn_mr_backward_reference(x, y, idx, g)

    results = []
    for fwd, bwd, ulp in ((kernel_fwd, recording, False),
                          (plain_fwd, plain_bwd, False),
                          (kernel_fwd, kernel_bwd, True)):
        fn, (state, batch) = train_entry(device="cuda", batch=2,
                                         dtype=torch.float32)
        if ulp:
            batch["img"] = torch.nextafter(batch["img"],
                                           torch.full_like(batch["img"], 1e9))
        knn_mr.launch, knn_mr.launch_backward = fwd, bwd
        try:
            state, logs = fn(state, batch)
            torch.cuda.synchronize()
        finally:
            knn_mr.launch, knn_mr.launch_backward = kernel_fwd, kernel_bwd
        results.append({k: float(v) for k, v in logs.items()})
        del fn, state, batch
    check(len(calls) == 16, f"{len(calls)} backward calls, expected 16")
    worst = 0.0
    for i, ((x, y, idx, g), out) in enumerate(calls):
        _, err, tie_rows = check_backward(f"fp32 backward call {i}", x, y,
                                          idx, g, out)
        worst = max(worst, err)
        max_deg, p99_deg = in_degrees(idx, y.shape[1])
        print(f"  fp32 backward call {i:2d}: N={x.shape[1]:5d} "
              f"M={y.shape[1]:5d} D={x.shape[2]:3d} k={idx.shape[2]}: gy "
              f"bitwise the ordered plain version; {tie_rows} rows with a "
              f"tie; max |gy - fp64| {err:.3e}; in-degree max {max_deg}, "
              f"p99 {p99_deg:.0f}", flush=True)
    del calls
    torch.cuda.empty_cache()
    kernel, plain, moved = results

    def rel(key, other):
        return abs(kernel[key] - other[key]) / abs(kernel[key])

    log(f"train fp32 batch 2: 16 backward calls passed, gx bitwise -g and "
        f"gy bitwise the ordered plain version (worst |gy - fp64| "
        f"{worst:.3e}); loss: kernel {kernel['loss']:.7g}, plain "
        f"{plain['loss']:.7g} (rel diff {rel('loss', plain):.3e}), kernel on "
        f"images one ulp up {moved['loss']:.7g} (rel diff "
        f"{rel('loss', moved):.3e}); grad_norm: kernel "
        f"{kernel['grad_norm']:.7g}, plain {plain['grad_norm']:.7g} (rel diff "
        f"{rel('grad_norm', plain):.3e}), one ulp up {moved['grad_norm']:.7g} "
        f"(rel diff {rel('grad_norm', moved):.3e})")


GRAD_REL_TOL = 2.0 ** -6   # grouped vs default step-1 gradients where not
                           # bitwise; PERF.md section 6 states the reason


def record_grouped_calls(fn, model, x) -> list[tuple]:
    """The 16 ``knn_mr_fused_grouped`` calls of one forward ``fn(model, x)``
    on the grouped route: ``(args, (idx, mr))`` each, recorded by patching
    the name the Grapher convs call."""
    calls = []
    kernel_op = grapher.knn_mr_fused_grouped

    def recording(*args):
        out = kernel_op(*args)
        calls.append((args, out))
        return out

    grapher.knn_mr_fused_grouped = recording
    try:
        fn(model, x)
        torch.cuda.synchronize()
    finally:
        grapher.knn_mr_fused_grouped = kernel_op
    check(len(calls) == 16, f"{len(calls)} grouped calls, expected 16")
    return calls


def folded_route(x, y, bias, k, dil, g):
    """fold -> the folded kernel -> unfold, on unfolded rows: idx
    ``(B, N, g, k)``, mr ``(B, N, g*D)``; with y = x one fold serves both."""
    b, n, _ = x.shape
    xf = fold_groups(x, g)
    yf = xf if y is x else fold_groups(y, g)
    idx, mr, _, _ = knn_mr.launch(xf, yf, bias, k, dil)
    return (idx.reshape(b, g, n, k).permute(0, 2, 1, 3),
            unfold_groups(mr, g))


def check_grouped_calls(calls, label: str, timed: bool) -> list[dict]:
    """Each recorded call's grouped output held on its own rows to
    (a) fold -> the folded kernel -> unfold, bitwise, and (b) the plain
    version ``knn_mr_grouped_reference``: mr bitwise wherever idx agrees;
    the fp64 oracle on the kernel's idx at every (row, group) pair whose idx
    differs and at ORACLE_ROWS more; on the plain idx at every pair that
    differs, on the plain version's own normalized rows, so that each
    difference is a near-tie that fp32 rounding may decide either way; and
    idx equal on all but FLIP_SHARE of the pairs of the 16 calls. The share
    holds for the forward, not for each call as in ``compare_fp32_paths``:
    a label call of 1280 pairs would allow one flip, and label 4 in bf16
    has two, where the kernel's idx is the exact fp64 order.
    With ``timed``, the grouped kernel's, the folded route's (the copies
    and the folded kernel), the folded kernel's alone on the folded rows and
    the plain version's ms, and the bound (the folded row's bytes and
    operations). Returns one dict per call, with the largest |mr - plain mr|
    on the pairs whose idx agrees."""
    rows = []
    flips_all = pairs_all = 0
    for i, ((x, y, bias, k, dil, g), (idx, mr)) in enumerate(calls):
        b, n, c = x.shape
        m, d = y.shape[1], c // g
        ref_idx, ref_mr = folded_route(x, y, bias, k, dil, g)
        check(torch.equal(idx, ref_idx) and torch.equal(mr, ref_mr),
              f"{label} call {i}: the grouped kernel differs from fold -> "
              f"kernel -> unfold")
        idx_p, mr_p = knn_mr.knn_mr_grouped_reference(x, y, bias, k, dil, g)
        same = (idx_p == idx).all(-1)  # (B, N, g)
        flips = int((~same).sum())
        mr_s = mr.reshape(b, n, g, d)[same]
        mr_ps = mr_p.reshape(b, n, g, d)[same]
        err = ((mr_s.float() - mr_ps.float()).abs().max().item()
               if mr_s.numel() else math.nan)  # nan: no pair agrees
        # the oracle on the folded layout: flat row (b * g + gi) * N + i
        idx_k, _, xn, yn = knn_mr.launch_grouped(x, y, bias, k, dil, g)
        check(torch.equal(idx_k, idx), f"{label} call {i}: a second launch "
              f"gave another idx")
        gen = torch.Generator(device=x.device).manual_seed(i)
        flipped = (~same).permute(0, 2, 1).reshape(-1).nonzero().squeeze(1)
        checked = torch.cat([flipped, torch.randperm(
            b * g * n, generator=gen, device=x.device)[:ORACLE_ROWS]])
        gap = knn_mr.ordering_gaps(
            xn, yn, bias, idx.permute(0, 2, 1, 3).reshape(b * g, n, k), dil,
            checked).max().item()
        gap_p = 0.0
        if flips:
            xp = l2_normalize(fold_groups(x, g))
            yp = xp if y is x else l2_normalize(fold_groups(y, g))
            gap_p = knn_mr.ordering_gaps(
                xp, yp, bias, idx_p.permute(0, 2, 1, 3).reshape(b * g, n, k),
                dil, flipped).max().item()
            del xp, yp
        print(f"  grouped {label} call {i:2d}: N={n:5d} M={m:5d} D={d:3d} "
              f"k*d={k * dil:2d}: idx differs from the plain version's on "
              f"{flips}/{same.numel()} (row, group) pairs; worst fp64 gap "
              f"{gap:.2e} (the plain idx there {gap_p:.2e}); max|mr - plain| "
              f"where idx agrees {err:.3e}", flush=True)
        check(gap <= ORACLE_TOL and gap_p <= ORACLE_TOL, f"{label} call {i}: "
              f"fp64 gap {gap:.2e}, of the plain idx {gap_p:.2e}")
        flips_all += flips
        pairs_all += same.numel()
        check(torch.equal(mr_s, mr_ps), f"{label} call {i}: mr differs from "
              f"the plain version's where idx agrees")
        row = dict(call=i, dtype=label, B=b, groups=g, N=n, M=m, D=d,
                   kd=k * dil, max_abs_err=err, plain_idx_flips=flips,
                   oracle_gap=gap, plain_oracle_gap=gap_p)
        del idx_p, mr_p, mr_s, mr_ps, idx_k, xn, yn
        if timed:
            iters = 20 if n * m < 10**7 else 10
            row["ms"] = cuda_ms(lambda: knn_mr.launch_grouped(
                x, y, bias, k, dil, g), iters, 3)
            row["folded_ms"] = cuda_ms(lambda: folded_route(
                x, y, bias, k, dil, g), iters, 3)
            xf = fold_groups(x, g)
            yf = xf if y is x else fold_groups(y, g)
            row["folded_kernel_ms"] = cuda_ms(lambda: knn_mr.launch(
                xf, yf, bias, k, dil), iters, 3)
            del xf, yf
            row["plain_ms"] = cuda_ms(lambda: knn_mr.knn_mr_grouped_reference(
                x, y, bias, k, dil, g), 3, 1)
            nbytes = (x.nbytes + (0 if y is x else y.nbytes)
                      + (0 if bias is None else bias.nbytes)
                      + idx.nbytes + mr.nbytes)
            flops = 2.0 * b * n * m * c
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS["bf16"] * 1e3
            row.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       calls_per_forward=1)
            print("grouped_row " + json.dumps(row), flush=True)
        rows.append(row)
    log(f"grouped {label}: idx differs from the plain version's on "
        f"{flips_all}/{pairs_all} (row, group) pairs of the 16 calls")
    check(flips_all <= FLIP_SHARE * pairs_all, f"{label}: {flips_all} (row, "
          f"group) pairs differ from the plain idx")
    return rows


def folded_backward(x, y, idx, g, groups):
    """fold -> the folded backward kernel -> unfold, on the unfolded rows
    and idx ``(B, N, g, k)`` of one grouped backward call."""
    b, n, _, k = idx.shape
    xf = fold_groups(x, groups)
    yf = xf if y is x else fold_groups(y, groups)
    idxf = idx.permute(0, 2, 1, 3).reshape(b * groups, n, k).contiguous()
    gx, gy = knn_mr.launch_backward(xf, yf, idxf, fold_groups(g, groups))
    return unfold_groups(gx, groups), unfold_groups(gy, groups)


def check_grouped_backward(calls, label: str) -> None:
    """Each recorded grouped backward call's gx and gy bitwise fold -> the
    folded backward -> unfold on the call's own inputs. The folded launches
    made to compare are not counted."""
    saved = knn_mr.backward_launches
    try:
        for i, ((x, y, idx, g, groups), (gx, gy)) in enumerate(calls):
            want_gx, want_gy = folded_backward(x, y, idx, g, groups)
            check(torch.equal(bits(gx), bits(want_gx))
                  and torch.equal(bits(gy), bits(want_gy)),
                  f"{label}: grouped backward call {i} (N={x.shape[1]}, "
                  f"M={y.shape[1]}) differs from fold -> folded backward -> "
                  f"unfold")
    finally:
        knn_mr.backward_launches = saved
    log(f"{label}: its 16 grouped backward calls bitwise fold -> folded "
        f"backward -> unfold")


def grouped_phase(ref_logits: torch.Tensor, ref_step1: tuple) -> dict:
    """Phase 7: the grouped path, with GKGNET_GROUPED=1 for this phase only.
    Returns its launch counts, times and per-call rows."""
    saved = os.environ.get("GKGNET_GROUPED")
    os.environ["GKGNET_GROUPED"] = "1"
    try:
        return _grouped_phase(ref_logits, ref_step1)
    finally:
        if saved is None:
            del os.environ["GKGNET_GROUPED"]
        else:
            os.environ["GKGNET_GROUPED"] = saved


def _grouped_phase(ref_logits: torch.Tensor, ref_step1: tuple) -> dict:
    fn, (model, x) = entry(device="cuda", batch=8)
    log("grouped: GKGNet-S@576 bf16, batch 8, GKGNET_GROUPED=1, built")
    knn_mr.launches = knn_mr.grouped_launches = 0
    knn_mr.backward_launches = knn_topk.launches = 0
    logits = fn(model, x)
    torch.cuda.synchronize()
    counts = (knn_mr.grouped_launches, knn_mr.launches, knn_topk.launches)
    check(counts == (16, 0, 0), f"grouped: (grouped, folded, knn_topk) "
          f"launches {counts} in one forward, expected (16, 0, 0)")
    check(torch.equal(logits.cpu(), ref_logits), "grouped: the logits are "
          "not bitwise the default route's")
    for i in range(3):
        images = torch.randn((8, 576, 576, 3),
                             generator=torch.Generator().manual_seed(100 + i))
        scores = predict(model, images.to(torch.bfloat16))
        torch.cuda.synchronize()
        check(scores.shape == (8, 80) and bool(torch.isfinite(scores).all()),
              f"grouped request {i}: scores {tuple(scores.shape)}")
    eval_launches = knn_mr.grouped_launches
    check(eval_launches == 64 and knn_mr.launches == 0
          and knn_mr.backward_launches == 0,
          f"grouped: {eval_launches} grouped, {knn_mr.launches} folded and "
          f"{knn_mr.backward_launches} backward launches over one forward "
          f"and 3 requests, expected 64, 0 and 0")
    log("grouped eval: 16 grouped launches per forward, 64 over one forward "
        "and 3 requests, no folded one; logits bitwise the default route's")
    fwd_ms = {}
    for turn, flag in enumerate(("0", "1", "1", "0")):
        os.environ["GKGNET_GROUPED"] = flag
        fwd_ms[turn] = (flag, cuda_ms(lambda: fn(model, x), 10, 2))
    os.environ["GKGNET_GROUPED"] = "1"
    default = [ms for flag, ms in fwd_ms.values() if flag == "0"]
    grouped = [ms for flag, ms in fwd_ms.values() if flag == "1"]
    log(f"grouped eval: {grouped[0]:.2f} and {grouped[1]:.2f} ms/forward at "
        f"batch 8 (bf16); the default route in the same turns "
        f"{default[0]:.2f} and {default[1]:.2f} (default, grouped, grouped, "
        f"default)")
    profile_device(lambda: fn(model, x), "grouped forward")
    rows = check_grouped_calls(record_grouped_calls(fn, model, x), "bf16",
                               timed=True)
    del fn, model, x, logits
    torch.cuda.empty_cache()
    fn, (model, x) = entry(device="cuda", batch=2, dtype=torch.float32)
    fp32_rows = check_grouped_calls(record_grouped_calls(fn, model, x),
                                    "fp32", timed=False)
    log("grouped: the 16 calls of the forward bitwise fold -> kernel -> "
        "unfold and held to the plain version (near-tie flips only, mr "
        "bitwise where idx agrees) on their own activations, bf16 batch 8 "
        "and fp32 batch 2")
    del fn, model, x
    torch.cuda.empty_cache()

    fn, (state, batch) = train_entry(device="cuda", batch=8)
    model = state.model
    knn_mr.launches = knn_mr.grouped_launches = 0
    knn_mr.backward_launches = knn_topk.launches = 0
    ref_loss, ref_grads = ref_step1
    kernel_bwd = knn_mr.launch_backward_grouped
    for i in range(3):
        before = (knn_mr.grouped_launches, knn_mr.backward_launches)
        calls = []

        def recording(*args):
            out = kernel_bwd(*args)
            calls.append((args, out))
            return out

        knn_mr.launch_backward_grouped = recording
        try:
            state, logs = fn(state, batch)
            torch.cuda.synchronize()
        finally:
            knn_mr.launch_backward_grouped = kernel_bwd
        fwd = knn_mr.grouped_launches - before[0]
        bwd = knn_mr.backward_launches - before[1]
        check(fwd == 16 and bwd == 16 and knn_mr.launches == 0
              and len(calls) == 16,
              f"grouped train step {i}: {fwd} grouped, {bwd} backward and "
              f"{knn_mr.launches} folded launches, {len(calls)} grouped "
              f"backward calls, expected 16, 16, 0 and 16")
        check_grouped_backward(calls, f"grouped train step {i}")
        del calls
        values = {k: float(v) for k, v in logs.items()}
        for key in ("loss", "grad_norm"):
            check(math.isfinite(values[key]),
                  f"grouped train step {i}: {key} = {values[key]}")
        if i == 0:
            check(values["loss"] == ref_loss, f"grouped train step 0: loss "
                  f"{values['loss']!r}, the default route's {ref_loss!r}")
            worst, bitwise = 0.0, 0
            for key, p in model.named_parameters():
                ref = ref_grads[key]
                if torch.equal(p.grad, ref):
                    bitwise += 1
                    continue
                rel = ((p.grad - ref).abs().max()
                       / ref.abs().max().clamp(min=1e-30)).item()
                print(f"  grouped step-1 gradient {key}: max|diff| / "
                      f"max|grad| {rel:.3e}", flush=True)
                worst = max(worst, rel)
                check(rel <= GRAD_REL_TOL, f"grouped step-1 gradient {key}: "
                      f"{rel:.3e} of its largest entry")
            log(f"grouped train step 0: loss bitwise the default route's; "
                f"{bitwise} of {len(ref_grads)} gradients bitwise, the rest "
                f"within {worst:.3e} of their largest entry")
        log(f"grouped train step {i}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in values.items()))
    train_launches = (knn_mr.grouped_launches, knn_mr.backward_launches)
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / iters
    peak = torch.cuda.max_memory_allocated()
    log(f"grouped train: {step_ms:.2f} ms/step at batch 8 (bf16, mean of "
        f"{iters} steps, host clock with synchronize); peak memory "
        f"{peak / 2**30:.2f} GiB")
    del fn, state, batch, model
    torch.cuda.empty_cache()
    return dict(eval_launches=eval_launches, train_launches=train_launches,
                rows=rows, fp32_rows=fp32_rows, fwd_ms=fwd_ms,
                step_ms=step_ms)


def phases_phase() -> dict:
    """Phase 8: the four phase kernels at the tool's geometry: timed (each
    launched on that run), then each held to its plain version. Returns the
    launches, the times and the largest error."""
    x, y = phases.seeded_inputs("cuda")
    k = phases.K
    phases.launches = 0
    times = phases.time_phases(x, y, k, iters=10, warmup=2)
    torch.cuda.synchronize()
    launches = phases.launches
    check(launches == 4 * 12, f"{launches} phase launches, expected 48")
    # the least time of every phase: the distance products at the bf16
    # tensor-core peak (x and y read once, one float written per row, move
    # far less)
    nbytes = x.nbytes + y.nbytes + 4 * x.shape[0] * x.shape[1]
    t_ops = 2.0 * x.shape[0] * x.shape[1] * y.shape[1] * x.shape[2] \
        / PEAK_FLOPS["bf16"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    exact_d, bound_d = phases.dist_bound(x, y)
    kernel_idx = knn_mr.launch(x, y, None, k)[0]
    worst = 0.0
    rows = {}
    for phase in phases.PHASES:
        got = phases.launch(phase, x, y, k).double()
        plain = phases.phase_reference(phase, x, y, k).double()
        if phase == "sel":
            check(bool((got == -math.inf).all() and (plain == -math.inf).all()),
                  "sel: the checksums are not -inf")
            err = 0.0
        else:
            if phase == "dist":
                exact, bound = exact_d, bound_d
            else:
                cols = (phases.fixed_columns(x, k) if phase == "gfix"
                        else kernel_idx)
                exact, bound = phases.gather_bound(x, y, cols)
            over = int(((got - exact).abs() > bound).sum())
            check(over == 0, f"{phase}: {over} checksums off the fp64 ones "
                  f"beyond the fp32 bound")
            if phase != "selg":  # selg's plain selection may flip near-ties
                over = int(((got - plain).abs() > 2 * bound).sum())
                check(over == 0, f"{phase}: {over} checksums off the plain "
                      f"version's beyond twice the bound")
            err = (got - plain).abs().max().item()
            worst = max(worst, (got - exact).abs().max().item())
        plain_ms = cuda_ms(lambda: phases.phase_reference(phase, x, y, k),
                           3, 1)
        rows[phase] = dict(ms=times[phase], plain_ms=plain_ms,
                           bound_ms=max(t_ops, t_bytes),
                           bound_by="operations" if t_ops >= t_bytes
                           else "bytes", max_abs_err_vs_plain=err)
        print(f"phase_row {json.dumps(dict(phase=phase, **rows[phase]))}",
              flush=True)
    query_rows = x.shape[0] * x.shape[1]
    log("phases: " + ", ".join(
        f"{p} {r['ms']:.3f} ms ({r['ms'] / query_rows * 1e6:.3f} ns per "
        f"query row)" for p, r in rows.items())
        + f"; split of selg: scan {times['dist']:.3f} ms, selection "
        f"{times['sel'] - times['dist']:.3f} ms, gather "
        f"{times['gfix'] - times['dist']:.3f} ms")
    xs, ys = x[:2, :2048].contiguous(), y[:2].contiguous()
    for name, (differ, n_rows, gap) in phases.oracle(xs, ys, k).items():
        log(f"phases oracle[{name}]: order-mismatch rows {differ}/{n_rows}, "
            f"max fp64 gap {gap:.3e}")
        check(gap <= ORACLE_TOL, f"oracle[{name}]: fp64 gap {gap:.3e}")
    del x, y, exact_d, bound_d, kernel_idx
    torch.cuda.empty_cache()
    return dict(launches=launches, rows=rows, max_abs_err=worst)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def cli_phase(smi: str) -> tuple[dict, dict, dict]:
    """Phase 9: the config-driven train and test CLIs on a synthetic set
    made here, on the card nvidia-smi names ``smi``; then phase 10, the
    serving path, phase 11, the VOC path and the tools, and phase 13 (d),
    the CLIs on a world of ranks, in the same directory on phase 9's
    checkpoint and images. Returns the launch counts of phases 9-11 (and
    phase 11's kernel rows)."""
    t = time.perf_counter()
    native.lib()  # before the loader's spawned workers load it
    log(f"cli: native ops built in {native.build_seconds:.2f} s")
    with tempfile.TemporaryDirectory(prefix="gkgnet_cli_") as root:
        cli = _cli_phase(root, t, smi)
        served = serving_phase(root, cli, smi)
        voc = voc_phase(root, cli, smi)
        parallel_cli_phase(root, cli, smi)
        return cli, served, voc


def _cli_phase(root: str, t0: float, smi: str) -> dict:
    t = time.perf_counter()
    data = os.path.join(root, "synthetic")
    n_tr = make_synthetic_coco.make_split(
        os.path.join(data, "train"), os.path.join(data, "train.data"), 256, 0)
    n_va = make_synthetic_coco.make_split(
        os.path.join(data, "val"), os.path.join(data, "val.data"), 64, 1)
    log(f"cli: make_synthetic_coco wrote {n_tr} train / {n_va} val images "
        f"in {time.perf_counter() - t:.1f} s")
    work = os.path.join(root, "work")
    options = [
        f"data.train.dataset.data_prefix={data}/train",
        f"data.train.dataset.ann_file={data}/train.data",
        f"data.val.data_prefix={data}/val",
        f"data.val.ann_file={data}/val.data",
        f"data.test.data_prefix={data}/val",
        f"data.test.ann_file={data}/val.data",
    ]
    train_args = [CLI_CONFIG, "--work-dir", work, "--cfg-options", *options,
                  "runner.max_epochs=1", "evaluation.interval=1",
                  "checkpoint_config.interval=1",
                  "workflow=[('train',1),('val',1)]"]

    # the loader alone: one pass over the train loader, no model
    cfg = train_cli.load_config(CLI_CONFIG, options)
    per_batch = cfg.data["samples_per_device"]
    loader = build_dataloader(
        build_dataset(cfg.data["train"]), per_batch,
        cfg.data["workers"], shuffle=True, sampler=cfg.sampler["type"],
        seed=cfg.seed, drop_last=True, mode=cfg.data["loader_mode"])
    t = time.perf_counter()
    n_img = 0
    try:
        for b in loader:
            if not n_img:
                first_s = time.perf_counter() - t
            n_img += len(b["img"])
    finally:
        loader.close()
    loader_s = time.perf_counter() - t
    steady = (n_img - per_batch) / (loader_s - first_s)
    log(f"cli ({smi}): the train loader alone ({cfg.data['loader_mode']}, "
        f"{cfg.data['workers']} workers): {n_img} images in {loader_s:.2f} s,"
        f" {n_img / loader_s:.1f} img/s; the first batch after "
        f"{first_s:.2f} s (the workers' start), then {steady:.1f} img/s")

    # the train CLI: the main path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn_mr.launches = 0
    knn_mr.grouped_launches = 0
    knn_mr.backward_launches = 0
    knn_topk.launches = 0
    t = time.perf_counter()
    summary = train_cli.main(train_args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    fwd, bwd, grouped, topk = (knn_mr.launches, knn_mr.backward_launches,
                               knn_mr.grouped_launches, knn_topk.launches)
    peak = torch.cuda.max_memory_allocated()
    steps, batch = summary["steps"], summary["batch"]
    val_batches = -(-n_va // batch)
    want_fwd = 16 * (steps + 3 * val_batches)   # val_loss, raw, EMA
    check(steps == 32 and batch == 8, f"{steps} steps at batch {batch}, "
          f"expected 32 at 8")
    check(fwd == want_fwd and bwd == 16 * steps and grouped == 0
          and topk == 0,
          f"train CLI: {fwd} forward, {bwd} backward, {grouped} grouped and "
          f"{topk} knn_topk launches, expected {want_fwd}, {16 * steps}, 0, "
          f"0")
    with open(summary["log_json"]) as f:
        records = [json.loads(line) for line in f]
    by_mode = {}
    for r in records:
        by_mode.setdefault(r["mode"], []).append(r)
    check(set(by_mode) == {"train", "val_loss", "val"},
          f"log records {sorted(by_mode)}")
    for r in by_mode["train"] + by_mode["val_loss"]:
        for key in ("loss", "bce_loss", "asy_loss"):
            check(math.isfinite(r[key]), f"{r['mode']} {key} = {r[key]}")
    val = by_mode["val"][-1]
    check(all(math.isfinite(val[k]) for k in ("mAP", "mAP_ema")),
          f"val record {val}")
    ckpt = os.path.join(work, "checkpoints")
    check(os.path.isfile(os.path.join(ckpt, "1", "state.pt"))
          and os.path.isdir(os.path.join(work, "best", "1")),
          "the epoch's checkpoints")
    log(f"cli: train CLI: {steps} steps, {fwd} forward and {bwd} backward "
        f"knn_mr launches (exact), train loss {by_mode['train'][-1]['loss']:.6g}"
        f", val_loss {by_mode['val_loss'][-1]['loss']:.6g}, mAP "
        f"{val['mAP']:.4f}, mAP_ema {val['mAP_ema']:.4f}; {wall_s:.1f} s "
        f"for the whole run")
    step_ms = summary["train_s"] * 1e3 / steps
    # without the first batch's wait (the loader workers' start)
    later_s = summary["train_s"] - summary["first_data_s"]
    later_data_s = summary["data_s"] - summary["first_data_s"]
    log(f"cli ({smi}): {step_ms:.2f} ms/step wall with the real loader "
        f"(the epoch's "
        f"32 steps, the loader's start included), "
        f"{batch * 1e3 / step_ms:.1f} img/s; data_time "
        f"{summary['data_s'] * 1e3 / steps:.2f} ms/step "
        f"({100 * summary['data_s'] / summary['train_s']:.1f} % of the "
        f"step); after the first batch ({summary['first_data_s']:.2f} s): "
        f"{later_s * 1e3 / steps:.2f} ms/step, {batch * steps / later_s:.1f}"
        f" img/s, data_time {later_data_s * 1e3 / steps:.2f} ms/step "
        f"({100 * later_data_s / later_s:.1f} %); "
        f"val {summary['eval_images'] / summary['eval_s']:.1f} img/s "
        f"(raw + EMA, {summary['eval_images']} images in "
        f"{summary['eval_s']:.2f} s, the val loader included); val_loss pass "
        f"{summary['val_loss_s']:.2f} s; peak memory {peak / 2**30:.2f} GiB")

    # the checkpoint: size, save and restore seconds
    model = build_model(cfg.model).to("cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    load_params_only(ckpt, model)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    log(f"cli ({smi}): checkpoint {dir_bytes(os.path.join(ckpt, '1')) / 2**20:.1f} "
        f"MiB (model, AdamW state, EMA), saved in "
        f"{summary['ckpt_save_s']:.2f} s, weights restored onto the card in "
        f"{restore_s:.2f} s")
    del model

    # the test CLI on the epoch's checkpoint, raw and EMA
    test_fwd = 0
    test_map = {}
    for ema in (False, True):
        out = os.path.join(root, f"scores_{int(ema)}.pkl")
        f0 = knn_mr.launches
        metrics, scores = test_cli.main(
            [CLI_CONFIG, ckpt, "--out", out, "--cfg-options", *options]
            + (["--ema"] if ema else []))
        test_fwd += knn_mr.launches - f0
        key = "mAP_ema" if ema else "mAP"
        check(scores.shape == (n_va, 80) and bool(np.isfinite(scores).all()),
              f"test CLI scores {scores.shape}")
        check(os.path.isfile(out), f"{out} not written")
        diff = abs(metrics["mAP"] - val[key])
        check(diff <= CLI_MAP_TOL, f"test CLI mAP {metrics['mAP']} against "
              f"the log's {key} {val[key]}: |diff| {diff} > {CLI_MAP_TOL}")
        test_map[ema] = metrics["mAP"]
        if not ema:
            raw_scores = scores
        log(f"cli: test CLI{' --ema' if ema else ''}: scores "
            f"{scores.shape}, mAP {metrics['mAP']:.4f} = the log's {key} "
            f"(|diff| {diff})")
    check(test_fwd == 2 * 16 * val_batches and knn_mr.backward_launches == bwd,
          f"test CLI: {test_fwd} forward launches, expected "
          f"{2 * 16 * val_batches}")
    log(f"cli: phase 9 passed in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return dict(launches=(fwd + test_fwd, bwd), options=options,
                ckpt=ckpt, data=data, val_dir=os.path.join(data, "val"),
                n_val=n_va, test_map=test_map[False], test_scores=raw_scores)


SERVE_REQUESTS = 8      # POSTs to each server checked against its scorer
SERVE_TIMED = 64        # POSTs timed after those (one round of the 64 JPEGs)
PRECISE_BN_BATCHES = 4  # seeded batches of 8 for PreciseBN


def reset_launch_counts() -> None:
    knn_mr.launches = knn_mr.grouped_launches = 0
    knn_mr.backward_launches = knn_topk.launches = 0
    knn_mr.normalize_launches = knn_mr.gather_backward_launches = 0


def check_counts(what: str, want: tuple[int, int, int, int],
                 total: Counter) -> None:
    """The launches since the last reset must be ``want``; they are added
    to ``total`` (forward, grouped and backward)."""
    got = (knn_mr.launches, knn_mr.grouped_launches,
           knn_mr.backward_launches, knn_topk.launches)
    check(got == want, f"{what}: (forward, grouped, backward, knn_topk) "
          f"launches {got}, expected {want}")
    total.update(forward=got[0], grouped=got[1], backward=got[2])


def http(port: int, path: str, data: bytes | None = None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST" if data else "GET")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def serving_phase(root: str, cli: dict, smi: str) -> dict:
    """Phase 10: the serving path on phase 9's epoch checkpoint and val
    JPEGs, in its directory ``root``. Returns the phase's knn_mr and grouped
    launches."""
    t0 = time.perf_counter()
    ckpt = cli["ckpt"]
    cfg = train_cli.load_config(CLI_CONFIG, cli["options"])
    test_ds = build_dataset(cfg.data["test"])
    total = Counter()  # the launches of the paths below, as each is read

    # (a) PreciseBN on the checkpoint's model: 4 seeded batches of 8
    model, _ = inference.init_model(CLI_CONFIG, ckpt)
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    gen = torch.Generator().manual_seed(0)
    batches = [torch.randn((8, 576, 576, 3), generator=gen)
               for _ in range(PRECISE_BN_BATCHES)]
    reset_launch_counts()
    t = time.perf_counter()
    used = precise_bn(model, batches,
                      generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    pbn_s = time.perf_counter() - t
    check(used == PRECISE_BN_BATCHES, f"precise_bn used {used} batches")
    check_counts("precise_bn", (16 * used, 0, 0, 0), total)
    sd = model.state_dict()
    bad = [k for k in stats0 if not bool(torch.isfinite(sd[k]).all())]
    still = [k for k in stats0 if torch.equal(sd[k], stats0[k])]
    check(not bad and not still and not model.training,
          f"precise_bn: statistics not finite {bad[:3]}, not moved "
          f"{still[:3]}")
    pbn_state = {k: v.cpu() for k, v in sd.items()}
    log(f"serve: precise_bn over {used} batches of 8 in {pbn_s:.2f} s: "
        f"{16 * used} knn_mr launches, all {len(stats0)} statistics finite "
        f"and moved from the checkpoint's")
    del model, sd, batches
    torch.cuda.empty_cache()

    # (b) inference on one val JPEG, bitwise the test CLI's eval step
    model, _ = inference.init_model(CLI_CONFIG, ckpt)
    reset_launch_counts()
    scores, preds = inference.inference_model(model, cfg, test_ds.filepath(0))
    check_counts("inference_model", (16, 0, 0, 0), total)
    state = create_train_state(model, optimizer=None)
    want = make_eval_step()(state, torch.from_numpy(
        test_ds[0]["img"][None]).cuda())[0].cpu().numpy()
    check(scores.shape == (80,) and np.array_equal(scores, want),
          f"inference scores differ from the eval step's (max |diff| "
          f"{np.abs(scores - want).max()})")
    log(f"serve: inference_model on {os.path.basename(test_ds.filepath(0))}"
        f": scores bitwise the eval step's; top-1 {preds[0]['class_name']} "
        f"{preds[0]['score']:.4f}")
    del model, state
    torch.cuda.empty_cache()

    # (c) export on the card at batch 1 and 8 (--verify), then the grouped
    # route at batch 1; each artifact's graph and its launches per forward
    artifacts = {}
    for batch, route in ((1, "default"), (8, "default"), (1, "grouped")):
        out = os.path.join(root, f"gkgnet_s576_b{batch}_{route}.pt2")
        if route == "grouped":
            os.environ["GKGNET_GROUPED"] = "1"
        try:
            res = export_cli.main([CLI_CONFIG, ckpt, "--out", out, "--batch",
                                   str(batch)]
                                  + (["--verify"] if route == "default"
                                     else []))
        finally:
            os.environ.pop("GKGNET_GROUPED", None)
        ops = Counter(str(n.target) for n in res["program"].graph.nodes
                      if n.op == "call_function")
        name = "gkgnet_tpu_torch.knn_mr_fused" + (
            "_grouped" if route == "grouped" else "") + ".default"
        sorts = [o for o in ops if "sort" in o or "topk" in o]
        kernel_ops = {o: c for o, c in ops.items() if "gkgnet_tpu_torch" in o}
        check(kernel_ops == {name: 16} and not sorts,
              f"{route} artifact b{batch}: kernel nodes {kernel_ops}, sort "
              f"or topk nodes {sorts}")
        clf = load_exported_classifier(out, device="cuda")
        sample = np.random.default_rng(0).standard_normal(
            clf.input_shape).astype(np.float32)
        reset_launch_counts()
        got = clf(sample)
        check_counts(f"{route} artifact b{batch}, one forward",
                     (0, 16, 0, 0) if route == "grouped" else (16, 0, 0, 0),
                     total)
        if route == "grouped":
            check(np.array_equal(got, artifacts[(1, "default")][1]),
                  "the grouped artifact's scores differ from the default "
                  "artifact's")
        check(got.shape == (batch, 80) and bool(np.isfinite(got).all()),
              f"artifact scores {got.shape}")
        artifacts[(batch, route)] = (out, got)
        log(f"serve ({smi}): {route} artifact at batch {batch}: "
            f"{res['bytes'] / 2**20:.1f} MiB, exported in "
            f"{res['export_s']:.1f} s, {kernel_ops[name]} {name} nodes and no"
            f" sort or topk; one forward launched 16 kernels"
            + (f"; --verify max |artifact - eager| {res['max_diff']:.3e}"
               if "max_diff" in res else "; scores bitwise the default "
               "artifact's"))
        del res
    torch.cuda.empty_cache()

    # (d) the deployment test CLI over the 64 val images (batch 8)
    reset_launch_counts()
    metrics, dep_scores = deploy_test.main(
        [CLI_CONFIG, artifacts[(8, "default")][0], "--cfg-options",
         *cli["options"]])
    n_val = cli["n_val"]
    check_counts("deployment test", (16 * (-(-n_val // 8)), 0, 0, 0), total)
    diff = abs(metrics["mAP"] - cli["test_map"])
    check(dep_scores.shape == (n_val, 80) and diff <= CLI_MAP_TOL,
          f"deployment test mAP {metrics['mAP']} against the test CLI's "
          f"{cli['test_map']}: |diff| {diff} > {CLI_MAP_TOL}")
    log(f"serve: deployment test: {n_val} images, mAP {metrics['mAP']:.4f} "
        f"= the test CLI's (|diff| {diff})")

    # (e) the server, on the checkpoint and on the batch-1 artifact: the
    # first requests checked against its scorer (and its warm-up), then
    # SERVE_TIMED timed over the val JPEGs
    raws = []
    for i in range(n_val):
        with open(test_ds.filepath(i), "rb") as f:
            raws.append(f.read())
    checked = raws[:SERVE_REQUESTS]
    timed = [raws[i % n_val] for i in range(SERVE_TIMED)]
    for source, arg in (("checkpoint", ["--checkpoint", ckpt]),
                        ("artifact", ["--artifact",
                                      artifacts[(1, "default")][0]])):
        t = time.perf_counter()
        server = serve.main([CLI_CONFIG, *arg, "--port", "0"], block=False)
        start_s = time.perf_counter() - t
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            port = server.server_address[1]
            check(http(port, "/ping") == (200, {"status": "Healthy"}),
                  f"{source} server: /ping")
            reset_launch_counts()
            answers = [http(port, "/predictions/gkgnet", raw)
                       for raw in checked]
            ms = []
            for raw in timed:
                t = time.perf_counter()
                status, _ = http(port, "/predictions/gkgnet", raw)
                ms.append((time.perf_counter() - t) * 1e3)
                check(status == 200, f"{source} server: answer {status}")
            n_req = len(checked) + len(timed)
            check_counts(f"{source} server, {n_req} requests",
                         (16 * n_req, 0, 0, 0), total)
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        # the request's parts in process, over the val JPEGs: the host's
        # decode and pipeline, then the device's normalization and forward
        # (its scores copied back); not on the path, so not counted
        pre_ms, fwd_ms = [], []
        for raw in raws:
            t = time.perf_counter()
            img = server.preprocess(raw)
            t1 = time.perf_counter()
            server.score_fn(img)
            pre_ms.append((t1 - t) * 1e3)
            fwd_ms.append((time.perf_counter() - t1) * 1e3)
        for raw, (status, body) in zip(checked, answers):
            scores = server.score_bytes(raw)
            keep = np.where(scores >= 0.5)[0]
            check(status == 200 and body["pred_label"] == keep.tolist()
                  and body["pred_score"] == [round(float(scores[i]), 6)
                                             for i in keep],
                  f"{source} server: answer {status} {body} against the "
                  f"scorer's")
        log(f"serve ({smi}): {source} server: started in {start_s:.1f} s "
            f"(warm-up included), /ping, {len(checked)} POSTs answered with "
            f"the scorer's scores, then {len(ms)} timed, 16 knn_mr launches "
            f"each; ms/request over the {len(ms)} (client clock): p50 "
            f"{np.percentile(ms, 50):.2f}, p99 {np.percentile(ms, 99):.2f}, "
            f"max {max(ms):.2f}, mean {np.mean(ms):.2f}; in process over "
            f"{len(raws)} JPEGs, p50 ms: decode and pipeline (host) "
            f"{np.percentile(pre_ms, 50):.2f}, normalize and forward "
            f"(device, scores back) {np.percentile(fwd_ms, 50):.2f}")
        del server
        torch.cuda.empty_cache()

    # (f) the open parity question at PreciseBN statistics
    compare_precise_bn_paths(pbn_state, cfg, smi)
    log(f"serve: phase 10 passed in {time.perf_counter() - t0:.1f} s")
    return dict(launches=total["forward"], grouped_launches=total["grouped"])


def compare_precise_bn_paths(state_dict: dict, cfg, smi: str) -> None:
    """GKGNet-S@576 at batch 1 in fp32 (TF32 off), with the checkpoint's
    weights and PreciseBN's statistics: the logits of the kernel path, the
    plain path on the card and the plain path on the CPU, printed as
    compare_fp32_paths prints them at the seeded init (not asserted)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model({**cfg.model, "dtype": "float32"})
    model.load_state_dict(state_dict)
    model = model.cuda().eval()
    x = torch.randn((1, 576, 576, 3),
                    generator=torch.Generator().manual_seed(0))
    kernel_op = grapher.knn_mr_fused
    with torch.no_grad():
        reset_launch_counts()
        got = model(x.cuda())[0].cpu()
        kernel_launches = knn_mr.launches
        grapher.knn_mr_fused = knn_mr.knn_mr_reference
        try:
            plain_card = model(x.cuda())[0].cpu()
        finally:
            grapher.knn_mr_fused = kernel_op
        # the two card runs took their own routes (0 would be no comparison)
        check(kernel_launches == 16 and knn_mr.launches == 16,
              f"kernel path {kernel_launches} launches, plain path "
              f"{knn_mr.launches - kernel_launches}: expected 16 and 0")
        plain_cpu = copy.deepcopy(model).cpu()(x)[0]
    scale = float(plain_cpu.abs().max())

    def rel(a, b):
        return float((a - b).abs().max()) / scale

    log(f"serve ({smi}): s@576 fp32 batch 1, checkpoint weights with "
        f"PreciseBN statistics: max|logit| {scale:.3e}; max|diff| / "
        f"max|logit|: kernel vs plain (card) {rel(got, plain_card):.3e}, "
        f"kernel vs plain (CPU) {rel(got, plain_cpu):.3e}, plain (card) vs "
        f"plain (CPU) {rel(plain_card, plain_cpu):.3e}")
    del model
    torch.cuda.empty_cache()


def write_vocdevkit(root: str, splits: dict, seed: int) -> tuple[str, Counter]:
    """Test scaffolding: a PASCAL VOC 2007 tree under ``root``, made from
    COCO-style multi-label images. ``splits`` maps a split name to a list
    of ``(JPEG path, (80,) multi-hot)``; image i is copied to
    ``JPEGImages/<split>_<i>.jpg`` and gets ``Annotations/<id>.xml`` with one
    object per COCO label c, named ``VOC_CLASSES[c % 20]`` and marked
    difficult with probability VOC_DIFFICULT (drawn from ``seed``): a
    class whose objects are all difficult is -1 at eval and positive at
    train, one with both kinds is positive. ``ImageSets/Main/<split>.txt``
    lists the ids. Returns the VOC2007 directory and the count of
    (image, class) pairs that are ``difficult_only`` or ``mixed``."""
    voc = os.path.join(root, "VOCdevkit", "VOC2007")
    for sub in ("Annotations", "JPEGImages",
                os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    kinds = Counter()
    for split, items in splits.items():
        ids = []
        for i, (src, labels) in enumerate(items):
            img_id = f"{split}_{i:06d}"
            shutil.copyfile(src, os.path.join(voc, "JPEGImages",
                                              f"{img_id}.jpg"))
            objects, flags = [], {}
            for c in np.flatnonzero(labels):
                name = VOC_CLASSES[c % len(VOC_CLASSES)]
                difficult = bool(rng.random() < VOC_DIFFICULT)
                flags.setdefault(name, set()).add(difficult)
                objects.append(f"<object><name>{name}</name><difficult>"
                               f"{int(difficult)}</difficult></object>")
            kinds.update("difficult_only" if f == {True} else "mixed"
                         for f in flags.values() if True in f)
            with open(os.path.join(voc, "Annotations", f"{img_id}.xml"),
                      "w") as f:
                f.write(f"<annotation><filename>{img_id}.jpg</filename>"
                        f"{''.join(objects)}</annotation>")
            ids.append(img_id)
        with open(os.path.join(voc, "ImageSets", "Main", f"{split}.txt"),
                  "w") as f:
            f.write("\n".join(ids) + "\n")
    return voc, kinds


def voc_phase(root: str, cli: dict, smi: str) -> dict:
    """Phase 11: the VOC@448 path and the tools, in phase 9's directory
    ``root`` on its images and checkpoint. Returns the phase's knn_mr
    forward and backward launches and its kernel rows."""
    t0 = time.perf_counter()
    total = Counter()  # the launches of the paths below, as each is read

    # (a) a VOCdevkit from phase 9's synthetic images
    splits = {}
    for split, sub in (("trainval", "train"), ("test", "val")):
        with open(os.path.join(cli["data"], f"{sub}.data"), "rb") as f:
            records = pickle.load(f)
        splits[split] = [(os.path.join(cli["data"], sub, r["file_name"]),
                          r["objects"]) for r in records]
    voc, kinds = write_vocdevkit(root, splits, seed=0)
    options = [f"data.{s}.data_prefix={voc}" for s in ("train", "val",
                                                       "test")]
    options += [f"data.train.ann_file={voc}/ImageSets/Main/trainval.txt"]
    options += [f"data.{s}.ann_file={voc}/ImageSets/Main/test.txt"
                for s in ("val", "test")]
    cfg = train_cli.load_config(VOC_CONFIG, options)
    test_ds = build_dataset(cfg.data["test"])
    gt = test_ds.get_gt_labels()
    n_test = len(test_ds)
    check(kinds["difficult_only"] > 0 and kinds["mixed"] > 0
          and int((gt == -1).sum()) > 0 and gt.shape == (64, 20),
          f"the VOC set: {dict(kinds)}, test labels {gt.shape} with "
          f"{int((gt == -1).sum())} difficult-only entries")
    log(f"voc: VOCdevkit written: {len(splits['trainval'])} trainval and "
        f"{n_test} test images, {kinds['difficult_only']} (image, class) "
        f"pairs difficult only, {kinds['mixed']} with both kinds; "
        f"{int((gt == -1).sum())} entries of -1 in the test labels")

    # (b) the kernels at VOC@448's shapes (BG 32)
    rows = kernel_rows(VOC_ROWS, VOC_BG, "voc_row")
    bwd_rows = backward_rows(VOC_ROWS, VOC_BG, "voc_bwd_row")
    log("voc: every VOC@448 forward row passed (a)-(d) and every backward "
        "row (e)-(g)")

    # (c) the train CLI on configs/gkgnet_voc_448.py: the main path
    work = os.path.join(root, "voc_work")
    train_args = [VOC_CONFIG, "--work-dir", work, "--cfg-options", *options,
                  "runner.max_epochs=1", "evaluation.interval=1",
                  "checkpoint_config.interval=1", "log_config.interval=8"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    summary = train_cli.main(train_args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    steps, batch = summary["steps"], summary["batch"]
    val_batches = -(-n_test // batch)
    check(steps == 16 and batch == 16, f"{steps} steps at batch {batch}, "
          f"expected 16 at 16")
    check_counts("VOC train CLI", (16 * (steps + val_batches), 0,
                                   16 * steps, 0), total)
    with open(summary["log_json"]) as f:
        records = [json.loads(line) for line in f]
    train_recs = [r for r in records if r["mode"] == "train"]
    vals = [r for r in records if r["mode"] == "val"]
    check(len(train_recs) == 2 and len(vals) == 1,
          f"log records {[r['mode'] for r in records]}")
    for r in train_recs:
        for key in ("loss", "bce_loss", "asy_loss", "grad_norm"):
            check(math.isfinite(r[key]), f"train {key} = {r[key]}")
    val = vals[0]
    check(math.isfinite(val["mAP"]) and "mAP_ema" not in val,
          f"val record {val}")
    ckpt = os.path.join(work, "checkpoints")
    check(os.path.isfile(os.path.join(ckpt, "1", "state.pt")),
          "the epoch's checkpoint")
    step_ms = summary["train_s"] * 1e3 / steps
    later_s = summary["train_s"] - summary["first_data_s"]
    later_data_s = summary["data_s"] - summary["first_data_s"]
    losses = ", ".join(f"{r['loss']:.6g}" for r in train_recs)
    log(f"voc ({smi}): train CLI: {steps} steps at batch {batch} (workers "
        f"{cfg.data['workers']}, {cfg.data['loader_mode']}), 16 + 16 knn_mr "
        f"launches per step and 16 per val batch (exact), losses "
        f"{losses}, val mAP "
        f"{val['mAP']:.4f}; {wall_s:.1f} s for the whole run; "
        f"{step_ms:.2f} ms/step wall with the real loader (its start "
        f"included), {batch * 1e3 / step_ms:.1f} img/s, data_time "
        f"{summary['data_s'] * 1e3 / steps:.2f} ms/step "
        f"({100 * summary['data_s'] / summary['train_s']:.1f} %); after the "
        f"first batch ({summary['first_data_s']:.2f} s): "
        f"{later_s * 1e3 / steps:.2f} ms/step, {batch * steps / later_s:.1f}"
        f" img/s, data_time {later_data_s * 1e3 / steps:.2f} ms/step "
        f"({100 * later_data_s / later_s:.1f} %); val "
        f"{summary['eval_images'] / summary['eval_s']:.1f} img/s "
        f"({summary['eval_images']} images in {summary['eval_s']:.2f} s, the "
        f"val loader included); peak memory {peak / 2**30:.2f} GiB")

    # the CLI's step alone (its state and step function, one trainval batch
    # through the train pipeline, no loader): host-clock ms/step, then its
    # device time and busy share under the profiler
    device = torch.device("cuda")
    state = train_cli.build_train_state(cfg, 0, device, steps, ema=False)
    step = make_train_step(
        dynamic_loss_scale=train_cli.dynamic_loss_scale(cfg))
    train_ds = build_dataset(cfg.data["train"])
    rng = np.random.default_rng(0)
    data = next(train_cli.device_batches(
        [default_collate([train_ds.prepare_data(i, rng)
                          for i in range(batch)])], device,
        cfg.data["train"]))
    reset_launch_counts()
    for _ in range(2):
        step(state, data, 1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        step(state, data, 1)
    torch.cuda.synchronize()
    alone_ms = (time.perf_counter() - t) * 1e3 / 5
    prof = profile_device(lambda: step(state, data, 1), "VOC step", iters=3)
    check_counts("VOC step alone (2 + 5 + 3)", (160, 0, 160, 0), total)
    log(f"voc ({smi}): the CLI's step alone at batch {batch}: "
        f"{alone_ms:.2f} ms/step (host clock, mean of 5), against "
        f"{later_s * 1e3 / steps:.2f} in the CLI's epoch after its first "
        f"batch; device busy {prof['busy']:.2f} ms/step "
        f"({100 * prof['busy'] / alone_ms:.1f} % of the step alone, "
        f"{100 * prof['busy'] * steps / later_s / 1e3:.1f} % of the "
        f"epoch's), knn_mr forward and backward "
        f"{sum(prof['ours'].values()):.2f} ms of it")
    del state, step, data, train_ds
    torch.cuda.empty_cache()

    # (d) the test CLI on the epoch's checkpoint, its scores dumped
    out = os.path.join(root, "voc_scores.pkl")
    reset_launch_counts()
    metrics, scores = test_cli.main([VOC_CONFIG, ckpt, "--out", out,
                                     "--cfg-options", *options])
    check_counts("VOC test CLI", (16 * val_batches, 0, 0, 0), total)
    diff = abs(metrics["mAP"] - val["mAP"])
    check(scores.shape == (n_test, 20) and bool(np.isfinite(scores).all())
          and os.path.isfile(out) and diff <= CLI_MAP_TOL,
          f"VOC test CLI: scores {scores.shape}, mAP {metrics['mAP']} "
          f"against the log's {val['mAP']}")
    log(f"voc: test CLI: scores {scores.shape}, mAP {metrics['mAP']:.4f} = "
        f"the log's (|diff| {diff})")

    # (e) the analysis tools on the --out file and the log
    again = eval_metric.main([VOC_CONFIG, out, "--cfg-options", *options])
    check(again == metrics, f"eval_metric {again} against the test CLI's "
          f"{metrics}")
    report_path = os.path.join(root, "voc_analysis.json")
    report = analyze_results.main([VOC_CONFIG, out, "--topk", "5", "--out",
                                   report_path, "--cfg-options", *options])
    with open(report_path) as f:
        check(json.load(f) == report and len(report["best"]) == 5
              and len(report["worst"]) == 5, "analyze_results' report")
    log_dict = analyze_logs.main(["cal_train_time", summary["log_json"]])[0]
    check(log_dict[1]["mAP"] == [val["mAP"]]
          and len(log_dict[1].get("loss", [])) == 2,
          f"analyze_logs read {sorted(log_dict[1])}")
    log("voc: eval_metric's dict = the test CLI's; analyze_results wrote "
        "the 5 best and worst; analyze_logs read the epoch's log")

    # (f) vis_edges and vis_cam on one test JPEG, against the eval forward
    img = test_ds.filepath(0)
    reset_launch_counts()
    drawn = vis_edges.main([img, VOC_CONFIG, ckpt, "--out",
                            os.path.join(root, "edges.png")])
    check_counts("vis_edges", (16, 0, 0, 0), total)
    model, _ = inference.init_model(VOC_CONFIG, ckpt)

    @torch.no_grad()
    def forward(model, x):
        return model(x)[0]

    with torch.no_grad():
        score, edges = model(torch.from_numpy(test_ds[0]["img"][None]).cuda())
    want = torch.sigmoid(score.float())[0].cpu().numpy()
    top3 = [int(c) for c in np.argsort(-want)[:3]]
    check(np.array_equal(drawn["scores"], want)
          and np.array_equal(drawn["edges"], edges.cpu().numpy())
          and drawn["edges"].shape == (2, 20, 9)
          and drawn["class_ids"] == top3 and drawn["names"] == VOC_CLASSES
          and os.path.isfile(drawn["out"]),
          f"vis_edges: classes {drawn['class_ids']} against {top3}, edges "
          f"{drawn['edges'].shape}")
    reset_launch_counts()
    t = time.perf_counter()
    cam = vis_cam.main([img, VOC_CONFIG, ckpt, "--out",
                        os.path.join(root, "cam.png")])
    cam_s = time.perf_counter() - t
    check_counts("vis_cam", (16, 0, 16, 0), total)
    # the saliency's forward and backward against the eval forward, batch 1
    imgs = inference.image_batch(model, cfg, img)
    eval_ms = cuda_ms(lambda: forward(model, imgs), 5, 2)
    grad_ms = cuda_ms(lambda: vis_cam.cam_and_saliency(model, imgs), 5, 2)
    prof = profile_device(lambda: vis_cam.cam_and_saliency(model, imgs),
                          "saliency", iters=3)
    bwd_ms = sum(v for k, v in prof["ours"].items() if k in BACKWARD_KERNELS)
    fwd_ms = sum(v for k, v in prof["ours"].items()
                 if k not in BACKWARD_KERNELS)
    del model, score, edges, imgs
    sal = cam["saliency"]
    size = cfg.model["size"]
    check(sal.shape == (size, size) and bool(np.isfinite(sal).all())
          and sal.max() > 0 and bool(np.isfinite(cam["cam"]).all())
          and os.path.isfile(cam["out"]),
          f"vis_cam: saliency {sal.shape} max {sal.max()}")
    log(f"voc: vis_edges: classes {[VOC_CLASSES[c] for c in top3]} and "
        f"their (2, 20, 9) edges = the eval forward's; vis_cam: class "
        f"{VOC_CLASSES[cam['class']]}, 16 forward and 16 backward launches "
        f"(eval mode, BG 2), saliency finite, max 1, "
        f"{float((sal > 0).mean()):.3f} of the pixels nonzero; {cam_s:.2f} s "
        f"for the tool (model build included); at batch 1 the eval forward "
        f"{eval_ms:.2f} ms, the saliency's forward and backward "
        f"{grad_ms:.2f} ms; under the profiler the device busy "
        f"{prof['busy']:.2f} ms per saliency, the 16 knn_mr forwards "
        f"{fwd_ms:.3f} ms and the 16 backwards (BG 2) {bwd_ms:.3f} ms")

    # (g) get_flops --verify, a trace of 2 forwards, timeit at batch 16
    reset_launch_counts()
    flops = get_flops.main([VOC_CONFIG, "--verify"])
    check_counts("get_flops --verify", (16, 0, 0, 0), total)
    analytic = flops["flops"]["per_image_total"]
    model, _ = inference.init_model(VOC_CONFIG, ckpt)
    x = torch.randn((batch, size, size, 3),
                    generator=torch.Generator().manual_seed(0)).cuda()
    trace_dir = os.path.join(root, "voc_trace")
    reset_launch_counts()
    with profiling.trace(trace_dir) as prof:
        for _ in range(2):
            forward(model, x)
    trace_file = os.path.join(trace_dir, profiling.TRACE_FILE)
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    check(os.path.getsize(trace_file) > 0 and device_us > 0,
          f"trace: {trace_file}, device time {device_us} us")
    sec = profiling.timeit(forward, model, x, iters=10, warmup=2)
    check_counts("trace (2) and timeit (12)", (16 * 14, 0, 0, 0), total)
    edges = profiling.model_edge_count(cfg.model["arch"], size, batch,
                                       n_classes=20)
    log(f"voc ({smi}): get_flops: params {flops['params'] / 1e6:.2f} M, "
        f"analytic {analytic / 1e9:.3f} GFLOPs, executed (FlopCounterMode, "
        f"batch 1) {flops['executed'] / 1e9:.3f} G, ratio "
        f"{flops['executed'] / analytic:.4f}; trace of 2 forwards at batch "
        f"{batch}: {os.path.getsize(trace_file) / 2**20:.1f} MiB, device "
        f"time {device_us / 2e3:.2f} ms per forward; timeit "
        f"{sec * 1e3:.2f} ms/forward at batch {batch}, {batch / sec:.1f} "
        f"img/s, {edges} edges per "
        f"forward, {edges / sec:.4g} edges/s")
    del model, x
    torch.cuda.empty_cache()

    # (h) verify_dataset over trainval; print_config
    broken = verify_dataset.main([VOC_CONFIG, "--split", "train", "--out",
                                  os.path.join(root, "broken.txt"),
                                  "--cfg-options", *options])
    check(broken == [], f"verify_dataset: {broken[:3]}")
    text = print_config.main([VOC_CONFIG, "--cfg-options", *options])
    check('"n_classes": 20' in text and voc in text, "print_config's text")
    log(f"voc: verify_dataset: {len(splits['trainval'])} trainval images, 0 "
        f"bad; print_config printed the merged config")

    # (i) phase 9's epoch checkpoint as a reference container, imported
    state = torch.load(os.path.join(cli["ckpt"], "1", "state.pt"),
                       map_location="cpu", weights_only=True)
    pth = os.path.join(root, "reference.pth.tar")
    torch.save({"state_dict": {"module." + k: v
                               for k, v in state["model"].items()},
                "meta": {"epoch": 1, "CLASSES": list(COCO_CLASSES)}}, pth)
    del state
    imported = os.path.join(root, "imported")
    from_reference.main([pth, CLI_CONFIG, imported])
    reset_launch_counts()
    _, scores = test_cli.main([CLI_CONFIG, imported, "--cfg-options",
                               *cli["options"]])
    check_counts("test CLI on the import", (16 * (-(-cli["n_val"] // 8)), 0,
                                            0, 0), total)
    check(np.array_equal(scores, cli["test_scores"]),
          f"the imported checkpoint's scores differ from phase 9's (max "
          f"|diff| {np.abs(scores - cli['test_scores']).max()})")
    log("voc: from_reference on phase 9's epoch checkpoint as a reference "
        "container (module. prefix, meta): the test CLI's scores bitwise "
        "phase 9's")
    log(f"voc: phase 11 passed in {time.perf_counter() - t0:.1f} s")
    return dict(launches=(total["forward"], total["backward"]), rows=rows,
                bwd_rows=bwd_rows)


# Phase 12: arch b@576 (configs/gkgnet_b_coco_576.py: channels 128..1024, 18
# stage-3 blocks, bf16, batch 8, drop_path 0.2), its ungrouped backbone
# (stage 4 at D = 1024: the D-chunked scan) and a small config of the other
# new model features.
B_CONFIG = os.path.join(REPO_DIR, "configs", "gkgnet_b_coco_576.py")
B_BATCH = 8
B_SIZE = 576
B_CALLS = 28              # knn_mr calls per forward: 24 Graphers + 4 labels
# t@224 with a prelu arch, an FPN neck, mixup/cutmix and LAMB (batch 2):
# the perturbed build's dense indicator at s@576 would be ~310 GB
FEATURES_ARCH = "t_prelu"
FEATURES_MODEL = dict(
    arch=FEATURES_ARCH, k=9, k_label_gcn=9, num_group=2, n_classes=80,
    size=224, drop_path=0.1, dtype="bfloat16",
    neck=dict(type="FPN", out_channels=64, out_indices=(1, 2, 3)),
    train_cfg=dict(augments=[dict(type="BatchMixup", alpha=0.2, prob=0.5),
                             dict(type="BatchCutMix", alpha=1.0, prob=0.5)]))
FEATURES_BUDGET = 1 << 16  # knn_budget: tiles the t@224 stage-1 plain build


def record_calls(run) -> tuple[list, list]:
    """``run()`` with every knn_mr forward launch's ``(x, y, bias, k,
    dilation)`` and backward launch's ``(x, y, idx, g)`` recorded, in
    order (the launches themselves are the kernels' and count)."""
    fwd, bwd = [], []
    launch, launch_backward = knn_mr.launch, knn_mr.launch_backward

    def rec_fwd(x, y, bias, k, dilation=1):
        fwd.append((x, y, bias, k, dilation))
        return launch(x, y, bias, k, dilation)

    def rec_bwd(x, y, idx, g):
        bwd.append((x, y, idx, g))
        return launch_backward(x, y, idx, g)

    knn_mr.launch, knn_mr.launch_backward = rec_fwd, rec_bwd
    try:
        run()
    finally:
        knn_mr.launch, knn_mr.launch_backward = launch, launch_backward
    return fwd, bwd


def call_name(prefix: str, widths: tuple, x, y, bias, dil: int) -> str:
    """``<prefix>_stage<i>_d<dilation>`` for a spatial call (it has the
    relative-position bias), ``<prefix>_label<i>`` for a label call;
    ``widths`` holds each stage's D."""
    stage = widths.index(x.shape[2]) + 1
    return (f"{prefix}_stage{stage}_d{dil}" if bias is not None
            else f"{prefix}_label{stage}")


def distinct_calls(calls: list, key) -> dict:
    """The first call of each distinct ``key(call)``, with the number of
    calls of that key, in the order first met."""
    out = {}
    for call in calls:
        kk = key(call)
        out.setdefault(kk, [call, 0])[1] += 1
    return out


def topk_wide_row(name: str, xn, yn, bias, k: int) -> dict:
    """knn_topk on a call's normalized rows against its plain version (the
    fp64 oracle, the value bound, two launches bitwise equal), timed."""
    bg, n, d = xn.shape
    m = yn.shape[1]
    dt = "bf16" if xn.dtype == torch.bfloat16 else "fp32"
    idx, vals = knn_topk.launch(xn, yn, k=k, bias=bias, return_values=True)
    torch.cuda.synchronize()
    stats = check_topk(name, xn, yn, bias, idx, vals)
    again = knn_topk.launch(xn, yn, k=k, bias=bias, return_values=True)
    check(torch.equal(again[0], idx) and torch.equal(again[1], vals),
          f"{name}: two launches differ")
    ms = cuda_ms(lambda: knn_topk.launch(xn, yn, k=k, bias=bias), 20, 3)
    plain_ms = cuda_ms(lambda: knn_topk_reference(xn, yn, k=k, bias=bias),
                       3, 1)
    nbytes = (xn.nbytes + (0 if yn is xn else yn.nbytes)
              + (0 if bias is None else bias.nbytes) + idx.nbytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * bg * n * m * d / PEAK_FLOPS[dt] * 1e3
    smem, chunked = knn_topk.block_layout(d, k, xn.dtype)
    row = dict(name=name, dtype=dt, BG=bg, N=n, M=m, D=d, k=k,
               smem_bytes=smem, chunked=chunked, calls_per_pass=0,
               calls_per_stochastic_pass=0, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               **stats)
    print("topk_row " + json.dumps(row), flush=True)
    return row


@contextlib.contextmanager
def forced_chunked():
    """knn_mr's and knn_topk's D-chunked scans at every width, through the
    modules' test hooks (their results are bitwise the whole-row scans')."""
    saved = knn_mr._FORCE_CHUNKED, knn_topk._FORCE_CHUNKED
    knn_mr._FORCE_CHUNKED = knn_topk._FORCE_CHUNKED = True
    try:
        yield
    finally:
        knn_mr._FORCE_CHUNKED, knn_topk._FORCE_CHUNKED = saved


def chunk_row(name: str, x, y, bias, k: int, dil: int) -> dict:
    """A call whose whole-row layout fits, on that layout and on the
    D-chunked scan forced: knn_mr's idx, mr and normalized rows and
    knn_topk's idx and values bitwise equal, and the times of both (CUDA
    events, in turns: whole, chunked, chunked, whole)."""
    whole = knn_mr.launch(x, y, bias, k, dil)
    with forced_chunked():
        forced = knn_mr.launch(x, y, bias, k, dil)
    check(not knn_mr.block_layout(x.shape[2], k * dil, x.dtype)[1]
          and all(torch.equal(bits(a) if a.is_floating_point() else a,
                              bits(c) if c.is_floating_point() else c)
                  for a, c in zip(whole, forced)),
          f"{name}: the chunked scan differs from the whole-row layout")
    xn, yn = whole[2], whole[3]
    t_whole = knn_topk.launch(xn, yn, k=k * dil, bias=bias,
                              return_values=True)
    with forced_chunked():
        t_forced = knn_topk.launch(xn, yn, k=k * dil, bias=bias,
                                   return_values=True)
    check(torch.equal(t_whole[0], t_forced[0])
          and torch.equal(bits(t_whole[1]), bits(t_forced[1])),
          f"{name}: knn_topk's chunked scan differs")
    times = {}
    for key, forced, fn in (
            ("ms", False, lambda: knn_mr.launch(x, y, bias, k, dil)),
            ("chunked_ms", True, lambda: knn_mr.launch(x, y, bias, k, dil)),
            ("topk_ms", False, lambda: knn_topk.launch(xn, yn, k=k * dil,
                                                       bias=bias)),
            ("topk_chunked_ms", True, lambda: knn_topk.launch(
                xn, yn, k=k * dil, bias=bias))):
        with forced_chunked() if forced else contextlib.nullcontext():
            times[key] = cuda_ms(fn, 20, 3)
    times["ms"] = (times["ms"] + cuda_ms(lambda: knn_mr.launch(
        x, y, bias, k, dil), 20, 3)) / 2
    bg, n, d = x.shape
    row = dict(name=name, dtype="bf16" if x.dtype == torch.bfloat16
               else "fp32", BG=bg, N=n, M=y.shape[1], D=d, kd=k * dil,
               **times)
    print("chunk_row " + json.dumps(row), flush=True)
    return row


def init_backbone(model: torch.nn.Module, seed: int) -> None:
    """``init_parameters``' families for a bare GKGNet backbone."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        init_block_parameters(model, gen)
        model.label_lt.weight.normal_(0.0, 1.0, generator=gen)
        for seq in model.ffn_label:
            seq[0].weight.normal_(0.0, seq[0].in_features ** -0.5,
                                  generator=gen)
            seq[0].bias.zero_()


def arch_b_phase(smi: str) -> dict:
    """Phase 12: (a) arch b@576 from its config, eval and train; (b) its
    ungrouped backbone at D = 1024 in bf16 and fp32; (c) one train step of
    a small config of every other new module, then with the perturbed graph
    build; (d) the 1024-wide fp32 kernel against the plain version on the
    CPU. Returns the launch counts and the rows."""
    t0 = time.perf_counter()
    cfg = train_cli.load_config(B_CONFIG, [])
    check(cfg.model["arch"] == "b" and cfg.model["dtype"] == "bfloat16"
          and cfg.model["drop_path"] == 0.2
          and cfg.data["samples_per_device"] == B_BATCH,
          f"{B_CONFIG}: not the arch b recipe")
    widths = tuple(c // cfg.model["num_group"]
                   for c in ARCH_SETTINGS["b"]["channels"])
    rng = np.random.default_rng(12)
    images = torch.from_numpy(rng.standard_normal(
        (B_BATCH, B_SIZE, B_SIZE, 3), dtype=np.float32)).cuda()
    labels = torch.from_numpy(rng.random((B_BATCH, 80)) < 0.05).float().cuda()
    total = Counter()  # the phase's knn_mr forward and backward launches

    # (a) eval: the config's model, seeded, bf16
    model = build_model(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, _ = model(images)
    torch.cuda.synchronize()
    check_counts("b: one eval forward", (B_CALLS, 0, 0, 0), total)
    check(logits.shape == (B_BATCH, 80)
          and bool(torch.isfinite(logits).all()), "b: logits")
    reset_launch_counts()  # the first forward's are in total already
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(images), 10, 2)
    eval_peak = torch.cuda.max_memory_allocated()
    check(knn_mr.launches == 12 * B_CALLS,
          f"b: {knn_mr.launches} launches in 12 timed forwards")
    total.update(forward=knn_mr.launches)
    log(f"b: eval {fwd_ms:.2f} ms/forward at batch {B_BATCH}, "
        f"{B_BATCH * 1e3 / fwd_ms:.1f} img/s (bf16); {B_CALLS} knn_mr "
        f"launches per forward; peak memory {eval_peak / 2**30:.2f} GiB")
    with torch.no_grad():
        profile_device(lambda: model(images), "forward")
        calls, _ = record_calls(lambda: model(images))
    check(len(calls) == B_CALLS, f"b: {len(calls)} recorded calls")
    rows, chunk_rows = [], []
    gen = torch.Generator(device="cuda").manual_seed(3)
    for (n, m, d, kd, dil, biased), ((x, y, bias, k, _), count) in \
            distinct_calls(calls, lambda c: (
                c[0].shape[1], c[1].shape[1], c[0].shape[2],
                c[3] * c[4], c[4], c[2] is not None)).items():
        name = call_name("b", widths, x, y, bias, dil)
        rows.append(forward_row(name, x, y, bias, k, dil, count, gen))
        if name in ("b_stage3_d5", "b_stage4_d5", "b_label4"):
            # the D-chunked scan's cost where the whole-row layout fits
            for dtype in (torch.bfloat16, torch.float32):
                xx = x.to(dtype)
                chunk_rows.append(chunk_row(
                    name if dtype == torch.bfloat16 else f"{name}_fp32", xx,
                    xx if y is x else y.to(dtype), bias, k, dil))
                del xx
    check(sum(r["calls_per_forward"] for r in rows) == B_CALLS
          and not any(r["chunked"] for r in rows),
          "b: the rows do not cover the forward, or took the chunked scan")
    del model, calls, logits
    torch.cuda.empty_cache()

    # (a) train: the config's state (AdamW, EMA), make_train_step, dual loss
    state = train_cli.build_train_state(cfg, 0, torch.device("cuda"), 1000,
                                        ema=True)
    step = make_train_step(ema_momentum=2e-4)
    batch = {"img": images, "gt_label": labels}
    p0 = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    reset_launch_counts()
    for i in range(3):
        f0, b0 = knn_mr.launches, knn_mr.backward_launches
        state, logs = step(state, batch, 0)
        torch.cuda.synchronize()
        fwd, bwd = knn_mr.launches - f0, knn_mr.backward_launches - b0
        check(fwd == B_CALLS and bwd == B_CALLS, f"b: train step {i}: {fwd} "
              f"forward and {bwd} backward launches, expected 28 and 28")
        values = {k: float(v) for k, v in logs.items()}
        for key in ("loss", "bce_loss", "asy_loss", "grad_norm"):
            check(math.isfinite(values[key]), f"b: step {i}: {key}")
        log(f"b: train step {i}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in values.items()))
    check(knn_topk.launches == 0 and knn_mr.grouped_launches == 0,
          "b: knn_topk or grouped launches in training")
    unmoved = [k for k, v in state.model.named_parameters()
               if torch.equal(v.detach(), p0[k])]
    check(not unmoved, f"b: parameters that did not move: {unmoved[:5]}")
    del p0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        step(state, batch, 0)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / 5
    train_peak = torch.cuda.max_memory_allocated()
    total.update(forward=knn_mr.launches, backward=knn_mr.backward_launches)
    log(f"b: train {step_ms:.2f} ms/step at batch {B_BATCH}, "
        f"{B_BATCH * 1e3 / step_ms:.1f} img/s (bf16, mean of 5 steps, host "
        f"clock with synchronize); 28 + 28 knn_mr launches per step; peak "
        f"memory {train_peak / 2**30:.2f} GiB")
    profile_device(lambda: step(state, batch, 0), "step", iters=2)
    _, bwd_calls = record_calls(lambda: step(state, batch, 0))
    check(len(bwd_calls) == B_CALLS, f"b: {len(bwd_calls)} backward calls")
    bwd_rows = []
    for (n, m, d, k, self_knn), ((x, y, idx, g), count) in distinct_calls(
            bwd_calls, lambda c: (c[0].shape[1], c[1].shape[1],
                                  c[0].shape[2], c[2].shape[2],
                                  c[1] is c[0])).items():
        name = f"b_{'self' if self_knn else 'cross'}_N{n}_M{m}_D{d}"
        bwd_rows.append(backward_row(name, x, y, idx, g, count))
    del state, step, batch, bwd_calls
    torch.cuda.empty_cache()

    # (b) the ungrouped backbone: stage 4 at D = 1024
    wide = GKGNet(arch="b", size=B_SIZE, drop_path=0.2, dtype=torch.bfloat16,
                  use_multi_group=False, backbone_multi_group=False)
    init_backbone(wide, 1)
    wide = wide.cuda().train()

    def wide_step():
        out = wide(images, torch.Generator(device="cuda").manual_seed(0))
        (out[0].float().square().mean() + out[1].float().mean()).backward()

    reset_launch_counts()
    calls, bwd_calls = record_calls(wide_step)
    torch.cuda.synchronize()
    check_counts("b ungrouped: a forward and backward",
                 (B_CALLS, 0, B_CALLS, 0), total)
    wide_rows, wide_bwd, wide_topk = [], [], []
    wide_fwd = [c for c in calls if c[0].shape[2] == 1024]
    check(len(wide_fwd) == 3, f"b ungrouped: {len(wide_fwd)} D = 1024 calls")
    for (_, _, _, _, dil, _), ((x, y, bias, k, _), count) in distinct_calls(
            wide_fwd, lambda c: (c[0].shape[1], c[1].shape[1],
                                 c[0].shape[2], c[3], c[4],
                                 c[2] is not None)).items():
        name = call_name("b_ungrouped", (128, 256, 512, 1024), x, y, bias,
                         dil)
        for dtype in (torch.bfloat16, torch.float32):
            xx = x.detach().to(dtype)
            yy = xx if y is x else y.detach().to(dtype)
            tag = name if dtype == torch.bfloat16 else f"{name}_fp32"
            row = forward_row(tag, xx, yy, bias, k, dil, count, gen)
            check(row["chunked"], f"{tag}: not the chunked scan")
            wide_rows.append(row)
            xn, yn = l2_normalize(xx), (l2_normalize(yy) if yy is not xx
                                        else None)
            wide_topk.append(topk_wide_row(
                tag, xn, xn if yn is None else yn, bias, k * dil))
            del xx, yy, xn, yn
    for (n, m, d, k, self_knn), ((x, y, idx, g), count) in distinct_calls(
            [c for c in bwd_calls if c[0].shape[2] == 1024],
            lambda c: (c[0].shape[1], c[1].shape[1], c[0].shape[2],
                       c[2].shape[2], c[1] is c[0])).items():
        name = f"b_ungrouped_{'stage4' if self_knn else 'label4'}"
        wide_bwd.append(backward_row(name, x, y, idx, g, count))
    check(len(wide_bwd) == 2, "b ungrouped: the D = 1024 backward calls")
    log("b ungrouped: the D = 1024 calls (2 stage-4 Graphers, 1 label) "
        "passed in bf16 and fp32 through the chunked scan, knn_topk at "
        "D = 1024 too, and their backward gy bitwise the ordered plain "
        "version")
    del wide, calls, bwd_calls, wide_fwd
    torch.cuda.empty_cache()

    # (d) the 1024-wide fp32 kernel against the plain version on the CPU
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    wide = GKGNet(arch="b", size=B_SIZE, dtype=torch.float32,
                  use_multi_group=False, backbone_multi_group=False)
    init_backbone(wide, 2)
    wide = wide.cuda().eval()
    with torch.no_grad():
        calls, _ = record_calls(lambda: wide(images[:1]))
    for i, (x, y, bias, k, dil) in enumerate(
            c for c in calls if c[0].shape[2] == 1024):
        idx, mr, xn, yn = knn_mr.launch(x, y, bias, k, dil)
        xc = x.cpu()
        idx_p, mr_p = knn_mr.knn_mr_reference(
            xc, xc if y is x else y.cpu(), None if bias is None
            else bias.cpu(), k, dil)
        same = (idx_p == idx.cpu()).all(-1)
        flips = int((~same).sum())
        gap = knn_mr.ordering_gaps(xn, yn, bias, idx, dil).max().item()
        print(f"  fp32 D=1024 call {i}: N={x.shape[1]} M={y.shape[1]} "
              f"k*d={k * dil}: idx differs from the plain version's on the "
              f"CPU on {flips}/{same.numel()} rows; worst fp64 gap "
              f"{gap:.2e}", flush=True)
        check(flips <= max(1, FLIP_SHARE * same.numel()),
              f"fp32 D=1024 call {i}: {flips} rows differ")
        check(gap <= ORACLE_TOL, f"fp32 D=1024 call {i}: fp64 gap {gap:.2e}")
        check(torch.equal(mr.cpu()[same], mr_p[same]),
              f"fp32 D=1024 call {i}: mr differs where idx agrees")
    del wide, calls
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    torch.cuda.empty_cache()

    # (c) the other new modules: prelu, an FPN neck + linear head,
    # mixup/cutmix, LAMB; then the perturbed graph build
    ARCH_SETTINGS[FEATURES_ARCH] = dict(ARCH_SETTINGS["t"], act="prelu")
    feat_imgs = images[:2, :224, :224].contiguous()
    feat_batch = {"img": feat_imgs, "gt_label": labels[:2]}
    for builder in ("knn", "perturbed"):
        model = build_model(dict(FEATURES_MODEL, graph_builder=builder))
        init_parameters(model, torch.Generator().manual_seed(4))
        model = model.cuda()
        st = create_train_state(model, build_optimizer(model, 1e-3, "lamb"),
                                ema=True)
        step = make_train_step(
            ema_momentum=2e-4, batch_augment=build_batch_augment(
                FEATURES_MODEL["train_cfg"]["augments"]))
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        reset_launch_counts()
        for i in range(2):
            st, logs = step(st, feat_batch, i)
            torch.cuda.synchronize()
            check(math.isfinite(float(logs["loss"])),
                  f"features ({builder}): step {i} loss")
        moved = [k for k, v in model.named_parameters()
                 if not torch.equal(v.detach(), p0[k])]
        check("head.fc.weight" in moved and "backbone.stem.convs.2.weight"
              in moved and any(k.startswith("neck.") for k in moved)
              and len(moved) > len(p0) // 2,
              f"features ({builder}): {len(moved)}/{len(p0)} moved")
        want = 2 * 16 if builder == "knn" else 0
        check(knn_mr.launches == want and knn_topk.launches == 0,
              f"features ({builder}): {knn_mr.launches} knn_mr launches, "
              f"expected {want}")
        total.update(forward=knn_mr.launches,
                     backward=knn_mr.backward_launches)
        log(f"features ({builder} graph build): 2 train steps of t@224 "
            f"(prelu, FPN neck + MultiLabelLinearClsHead, mixup/cutmix, "
            f"LAMB, batch 2) finite, loss {float(logs['loss']):.6g}, "
            f"{len(moved)}/{len(p0)} parameters moved, {knn_mr.launches} "
            f"knn_mr launches")
        del model, st, step, p0
    del ARCH_SETTINGS[FEATURES_ARCH]
    # knn_budget: the plain build tiled by the budget's chunk, on the CPU
    # (the kernel holds no distance block), bitwise the untiled build
    chunk = gkgnet_mod._divisor_chunk(3136, 196, FEATURES_BUDGET)
    xq = torch.randn((4, 3136, 24), generator=torch.Generator().manual_seed(5))
    yq = torch.randn((4, 196, 24), generator=torch.Generator().manual_seed(6))
    table = torch.from_numpy(get_relative_pos_table(48, 3136, 4))
    tiled = knn_graph(xq, yq, k=9, bias=table, query_chunk=chunk)
    check(chunk is not None and torch.equal(
        tiled, knn_graph(xq, yq, k=9, bias=table)),
        f"knn_budget: the tiled plain build ({chunk}) differs")
    log(f"features: knn_budget {FEATURES_BUDGET} tiles the t@224 stage-1 "
        f"plain build in chunks of {chunk} query rows, bitwise the untiled "
        f"build")
    log(f"b: phase 12 passed in {time.perf_counter() - t0:.1f} s")
    return dict(launches=(total["forward"], total["backward"]),
                rows=rows + wide_rows,
                bwd_rows=bwd_rows + wide_bwd, topk_rows=wide_topk,
                chunk_rows=chunk_rows,
                fwd_ms=fwd_ms, step_ms=step_ms, eval_peak=eval_peak,
                train_peak=train_peak)


# ---------------------------------------------------------------- phase 14
# GKGNet-T@576 (configs/gkgnet_t_coco_576.py: channels 48..384, so the
# graph convs' rows are D = 24, 48, 120 and 192 wide; bf16, batch 8)
T_CONFIG = os.path.join(REPO_DIR, "configs", "gkgnet_t_coco_576.py")
T_BATCH = 8
T_SIZE = 576
T_CALLS = 16              # knn_mr calls per forward: 12 Graphers + 4 labels
T_BREAKDOWN_ITERS = 3     # profile_breakdown's BD_ITERS on t@576


def arch_t_phase(smi: str) -> dict:
    """Phase 14: t@576 from its config, eval and two train steps, every
    call held to its plain version, then profile_breakdown's eval tables.
    Returns the launch counts and the rows."""
    t0 = time.perf_counter()
    cfg = train_cli.load_config(T_CONFIG, [])
    # the model as the config has it, at the main path's batch of 8 (the
    # config's own samples_per_device is 16)
    check(cfg.model["arch"] == "t" and cfg.model["dtype"] == "bfloat16"
          and cfg.model["size"] == T_SIZE,
          f"{T_CONFIG}: not the t@576 model")
    widths = tuple(c // cfg.model["num_group"]
                   for c in ARCH_SETTINGS["t"]["channels"])
    rng = np.random.default_rng(14)
    images = torch.from_numpy(rng.standard_normal(
        (T_BATCH, T_SIZE, T_SIZE, 3), dtype=np.float32)).cuda().bfloat16()
    labels = torch.from_numpy(rng.random((T_BATCH, 80)) < 0.05).float().cuda()
    total = Counter()

    # eval: the config's model, seeded, bf16
    model = build_model(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    reset_launch_counts()
    with torch.no_grad():
        logits, _ = model(images)
    torch.cuda.synchronize()
    check_counts("t: one eval forward", (T_CALLS, 0, 0, 0), total)
    check(logits.shape == (T_BATCH, 80)
          and bool(torch.isfinite(logits).all()), "t: logits")
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(images), 10, 2)
    eval_peak = torch.cuda.max_memory_allocated()
    check(knn_mr.launches == 12 * T_CALLS,
          f"t: {knn_mr.launches} launches in 12 timed forwards")
    total.update(forward=knn_mr.launches)
    with torch.no_grad():
        eval_prof = profile_device(lambda: model(images), "forward")
        calls, _ = record_calls(lambda: model(images))
    log(f"t ({smi}): eval {fwd_ms:.2f} ms/forward at batch {T_BATCH}, "
        f"{T_BATCH * 1e3 / fwd_ms:.1f} img/s (bf16); {T_CALLS} knn_mr "
        f"launches per forward; peak memory {eval_peak / 2**30:.2f} GiB; "
        f"device busy {100 * eval_prof['busy'] / eval_prof['wall']:.1f} %")
    check(len(calls) == T_CALLS, f"t: {len(calls)} recorded calls")
    # every call held to its plain version; each distinct shape also timed
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(14)

    def shape_key(c):
        return (c[0].shape[1], c[1].shape[1], c[0].shape[2], c[3] * c[4],
                c[4], c[2] is not None)

    counts = {kk: count for kk, (_, count) in distinct_calls(
        calls, shape_key).items()}
    for i, (x, y, bias, k, dil) in enumerate(calls):
        name = call_name("t", widths, x, y, bias, dil)
        count = counts.pop(shape_key((x, y, bias, k, dil)), None)
        if count is None:  # a shape met before: checked, not timed
            check_forward(f"{name}_call{i}", x, y, bias, k, dil, gen)
            continue
        rows.append(forward_row(name, x, y, bias, k, dil, count, gen))
    check(sum(r["calls_per_forward"] for r in rows) == T_CALLS
          and {r["D"] for r in rows} == set(widths),
          "t: the rows do not cover the forward's calls and widths")
    log(f"t: all {len(calls)} forward calls held to their plain version; "
        f"{len(rows)} distinct shapes timed")
    del model, calls, logits
    torch.cuda.empty_cache()

    # two train steps: the config's state, make_train_step, dual loss
    state = train_cli.build_train_state(cfg, 0, torch.device("cuda"), 1000,
                                        ema=True)
    step = make_train_step(ema_momentum=2e-4)
    batch = {"img": images, "gt_label": labels}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    bwd_calls = []
    losses = []
    for i in range(2):
        f0, b0 = knn_mr.launches, knn_mr.backward_launches
        _, got = record_calls(
            lambda i=i: losses.append(float(step(state, batch, i)[1]["loss"])))
        torch.cuda.synchronize()
        bwd_calls += got
        fwd, bwd = knn_mr.launches - f0, knn_mr.backward_launches - b0
        check(fwd == T_CALLS and bwd == T_CALLS, f"t: train step {i}: {fwd} "
              f"forward and {bwd} backward launches, expected 16 and 16")
        check(math.isfinite(losses[-1]), f"t: step {i}: loss {losses[-1]}")
    total.update(forward=knn_mr.launches, backward=knn_mr.backward_launches)
    train_peak = torch.cuda.max_memory_allocated()
    # every backward call: gx bitwise -g, gy bitwise the ordered plain
    # version and within the fp64 bound; each distinct shape also timed
    bwd_rows, seen = [], set()
    for i, (x, y, idx, g) in enumerate(bwd_calls):
        key = (x.shape[1], y.shape[1], x.shape[2], y is x)
        if key in seen:
            check_backward(f"t_bwd_call{i}", x, y, idx, g,
                           knn_mr.launch_backward(x, y, idx, g))
            continue
        seen.add(key)
        name = (f"t_{'self' if y is x else 'cross'}_N{x.shape[1]}_"
                f"M{y.shape[1]}_D{x.shape[2]}")
        bwd_rows.append(backward_row(name, x, y, idx, g, sum(
            1 for c in bwd_calls[:T_CALLS]
            if (c[0].shape[1], c[1].shape[1], c[0].shape[2],
                c[1] is c[0]) == key)))
    del bwd_calls
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(3):
        step(state, batch, 2 + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / 3
    step_prof = profile_device(lambda: step(state, batch, 5), "step",
                               iters=2)
    log(f"t ({smi}): train {step_ms:.2f} ms/step at batch {T_BATCH} (bf16, "
        f"mean of 3 steps, host clock with synchronize); losses "
        f"{losses}; 16 + 16 knn_mr "
        f"launches per step; {len(bwd_rows)} distinct backward shapes and "
        f"all 32 backward calls held bitwise; peak memory "
        f"{train_peak / 2**30:.2f} GiB; device busy "
        f"{100 * step_prof['busy'] / step_prof['wall']:.1f} %")
    del state, step, batch
    torch.cuda.empty_cache()

    # profile_breakdown's eval tables on t@576 (its own launches)
    breakdown = profile_breakdown.eval_tables("t", T_SIZE, T_BATCH,
                                              T_BREAKDOWN_ITERS,
                                              torch.device("cuda"))
    check(len(breakdown["rows"]) == 9 and sum(
        r["count"] for r in breakdown["rows"]) == T_CALLS
          and all(r["fits"] for r in breakdown["rows"]),
          "t: profile_breakdown's rows")
    torch.cuda.empty_cache()
    log(f"t: phase 14 passed in {time.perf_counter() - t0:.1f} s")
    return dict(launches=(total["forward"], total["backward"]), rows=rows,
                bwd_rows=bwd_rows, fwd_ms=fwd_ms, step_ms=step_ms,
                eval_peak=eval_peak, train_peak=train_peak, losses=losses,
                breakdown=breakdown)


# ---------------------------------------------------------------- phase 13
# Data and graph parallelism (parallel/): worlds of ranks spawned on this
# one card (parallel/spawn.py), talking over gloo through pinned host
# buffers (the transport rule: NCCL refuses two ranks on one device). Ranks
# that share one card measure the partition's overhead, not its scaling.

PAR_GRAPH = 2             # the graph axis of (a) and (b)
PAR_TIMEOUT_S = 300.0     # each world's process groups and its join
# (a): a shard backward's gy summed over the graph group against the
# unpartitioned gy (bf16): each rank's gy is its fp32 sum rounded once to
# bf16 (half a bf16 ulp, 2**-9 of the value), their sum is taken in fp32
# and the unpartitioned gy is rounded once too; 2**-8 of the magnitudes
# bounds the three roundings, and 1e-6 of the largest |gy| the fp32 sums'
# other order
PAR_GY_REL = 2.0 ** -8
# (b) in fp32: the t@128 graph-only step's gradients against the
# one-process step's, per leaf, relative to the leaf's
# largest |g| (a leaf below this share of the model's largest holds only
# the rounding noise of an exact 0 and is held to the model's largest):
# the CPU tests' bound (tests/test_torch_parallel.py), the graph convs'
# target gradients being summed over the ranks in another order and
# carried back through the network (1.5e-5 measured there)
PAR_GRAD_REL = 1e-4
PAR_FP32_BATCH = 4
# (c): the 2 x 2 world's first step loss against the one-process step on
# the same weights and global batch, whose BatchNorm moments are summed in
# the two data ranks' blocks (par_split_moments), relative. It comes from
# the forward alone and was bitwise equal in every H100 run (PERF.md,
# section 6); any other rounding -- a convolution algorithm chosen
# otherwise at batch 4 than at 8 -- would flip kNN near-ties of this random
# model and move its loss by percents (5.3 % on the CPU's fp32 worlds).
# The second step's loss against the one process is printed, not held: it
# follows step 1's bf16 update, whose gradients round each graph rank's
# partial target sums to bf16 before their sum (as the JAX package's
# reduce-scatter does); the update is held in fp32 instead (the data mean,
# bitwise, in a world of 4). Both steps' losses are held bitwise to the
# same two steps run again.
PAR_LOSS_RTOL = 2e-2
# (d): the 4-rank test CLI's mAP against the 1-rank CLI's on the same
# checkpoint (mAP points): each data rank scores its rows in batches of the
# same size, through the same row-independent kernels
PAR_CLI_MAP_TOL = 1e-4
PAR_CLI_IMAGES = 16       # (d)'s train epoch: 2 steps at global batch 8
PAR_768_CONFIG = os.path.join(REPO_DIR, "configs", "gkgnet_coco_768_dist.py")


def par_timed(fn, iters: int = 3) -> float:
    """ms per call on a host clock around device synchronizations (the
    calls block on the host for their collectives)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def par_block(t: torch.Tensor, dim: int, parts: int, i: int) -> torch.Tensor:
    n = t.shape[dim] // parts
    return t.narrow(dim, i * n, n).contiguous()


def par_calls_rank(rows: list, bg: int) -> dict:
    """(a) on one rank of a (data 1, graph 2) world: every bf16 call of
    ``rows`` through the partitioned functions held to the unpartitioned
    kernel on the same inputs in this process, then (b)."""
    mesh = make_mesh(data=1, graph=PAR_GRAPH)
    s, me = mesh.graph, mesh.graph_rank
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(13)
    out = dict(rank=mesh.rank, device=str(dev), backend=mesh.backend,
               rows=[])
    for (name, n, m, d, k, dil, table, calls, dt, targets) in rows:
        if dt != "bf16":
            continue
        x = torch.randn((bg, n, d), generator=gen, device=dev).bfloat16()
        y = x if targets == "self" else torch.randn(
            (bg, m, d), generator=gen, device=dev).bfloat16()
        bias = None if table is None else torch.from_numpy(
            get_relative_pos_table(*table)).to(dev)
        g = torch.randn((bg, n, d), generator=gen, device=dev).bfloat16()
        idx_u, mr_u, _, _ = knn_mr.launch(x, y, bias, k, dil)
        if targets == "labels":
            y_l = par_block(y, 1, s, me)
            calls_ = {"label": lambda: edge_partition.label_sharded_knn_mr(
                mesh, x, y_l, k=k, dilation=dil)}
            want = (idx_u, mr_u)
        else:
            x_l = par_block(x, 1, s, me)
            y_l = None if targets == "self" else par_block(y, 1, s, me)
            b_l = None if bias is None else par_block(bias, 0, s, me)
            calls_ = {
                sched: (lambda ov=ov: edge_partition.edge_partitioned_knn_mr(
                    mesh, x_l, y_l, b_l, k=k, dilation=dil, overlap=ov))
                for sched, ov in (("gather", False), ("ring", True))}
            want = (par_block(idx_u, 1, s, me), par_block(mr_u, 1, s, me))
        first_row = len(out["rows"])
        for sched, call in calls_.items():
            c0 = entry_mod.launch_counts()
            with torch.no_grad():
                idx, mr = call()
            torch.cuda.synchronize()
            c1 = entry_mod.launch_counts()
            check(torch.equal(idx, want[0]),
                  f"parallel (a) {name} {sched}: idx differs from the "
                  f"unpartitioned kernel's on "
                  f"{int((idx != want[0]).any(-1).sum())} rows")
            check(torch.equal(mr, want[1]),
                  f"parallel (a) {name} {sched}: mr differs from the "
                  f"unpartitioned kernel's (max |diff| "
                  f"{(mr.float() - want[1].float()).abs().max().item()})")
            with torch.no_grad():
                ms = par_timed(call)
            out["rows"].append(dict(
                name=name, schedule=sched, BG=bg,
                N_local=idx.shape[1], M=m if targets != "labels" else m // s,
                ms=ms, launches={k_: c1[k_] - c0[k_] for k_ in c1}))
        if targets != "labels":
            # the gather shard's backward: the kernel on this rank's rows
            # against the whole targets, gy summed over the graph group
            rows_q = slice(me * (n // s), (me + 1) * (n // s))
            g_l = g[:, rows_q].contiguous()
            gx_l, gy_part = knn_mr.launch_backward(
                x[:, rows_q].contiguous(), y,
                idx_u[:, rows_q].contiguous(), g_l)
            check(torch.equal(gx_l, -g_l),
                  f"parallel (a) {name}: the shard backward's gx is not -g")
            _, gy_u = knn_mr.launch_backward(x, y, idx_u, g)
            gy_sum = collectives.all_reduce(gy_part.float(),
                                            mesh.graph_group)
            mag = collectives.all_reduce(gy_part.float().abs(),
                                         mesh.graph_group)
            err = (gy_sum - gy_u.float()).abs()
            bound = PAR_GY_REL * (mag + gy_u.float().abs()) \
                + 1e-6 * gy_u.float().abs().max()
            check(bool((err <= bound).all()),
                  f"parallel (a) {name}: gy summed over the graph group off "
                  f"the unpartitioned gy by {err.max().item():.3e}")
            out["rows"][first_row]["gy_max_abs_err"] = err.max().item()
        del x, y, bias, g, idx_u, mr_u
    torch.cuda.empty_cache()
    out.update(par_graph_only(mesh))
    out["fp32_grads"] = par_fp32_grads(mesh)
    return out


def par_fp32_grads(mesh=None, moments_parts: int = 1) -> dict:
    """The gradients the optimizer stepped with (after the data mean and
    the clip) in one t@128 fp32 train step (dryrun_multichip's model) at
    the global batch PAR_FP32_BATCH: under graph_sharding on this rank's
    rows of a mesh, or in one process without one (the reference, its
    BatchNorm moments summed in ``moments_parts`` data ranks' blocks); in
    full fp32 on both (TF32 off, as the phases before this one leave it)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state, data, step = entry_mod.dryrun_state("t128", "cuda",
                                               PAR_FP32_BATCH)
    if mesh is not None:
        data = shard_batch(data, mesh)
    else:
        data = {k: v.cuda() for k, v in data.items()}
    own = BatchNorm._moments
    if moments_parts > 1:
        BatchNorm._moments = par_split_moments(moments_parts)
    try:
        with (graph_sharding(mesh) if mesh is not None
              else contextlib.nullcontext()):
            step(state, data, 7)
    finally:
        BatchNorm._moments = own
    return {k: p.grad.detach().float().cpu()
            for k, p in state.model.named_parameters()}


def par_fp32_dp_rank() -> dict:
    """(c) in fp32 on one rank of a world of 4, mesh (data 2, graph 2):
    ``par_fp32_grads`` on this rank's rows, with the gradients as they
    entered and left the train step's data mean (``reduce_mean_``)."""
    mesh = make_mesh(data=2, graph=2)
    seen = []
    mean = collectives.reduce_mean_

    def recording(tensors, group, count):
        before = [t.detach().float().cpu() for t in tensors]
        mean(tensors, group, count)
        seen.append((before, [t.detach().float().cpu() for t in tensors]))

    collectives.reduce_mean_ = recording
    try:
        grads = par_fp32_grads(mesh)
    finally:
        collectives.reduce_mean_ = mean
    before, after = seen[0]  # the gradients' (the logged losses' follow)
    return dict(grads=grads, before=before, after=after,
                coords=(mesh.data_rank, mesh.graph_rank))


def par_leaf_gaps(got: dict, ref: dict) -> dict:
    """max|got - ref| / max|ref| per leaf; a leaf whose largest |ref| is
    below PAR_GRAD_REL of the model's largest is taken relative to the
    model's largest (see PAR_GRAD_REL)."""
    top = max(g.abs().max().item() for g in ref.values())
    gaps = {}
    for key, g in ref.items():
        scale = g.abs().max().item()
        if scale < PAR_GRAD_REL * top:
            scale = top
        gaps[key] = (got[key] - g).abs().max().item() / max(scale, 1e-30)
    return gaps


def par_graph_only(mesh) -> dict:
    """(b) on a (data 1, graph 2) rank: the eval forward of entry() and the
    first train step of train_entry() at batch 8 under graph_sharding."""
    fn, (model, x) = entry(device=mesh.device, batch=8)
    c0 = entry_mod.launch_counts()
    with graph_sharding(mesh):
        logits = fn(model, x)
        torch.cuda.synchronize()
        fwd_counts = {k: v - c0[k]
                      for k, v in entry_mod.launch_counts().items()}
        fwd_ms = par_timed(lambda: fn(model, x))
    logits = logits.float().cpu()
    del fn, model, x
    torch.cuda.empty_cache()
    fn, (state, batch) = train_entry(device=mesh.device, batch=8)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    c0 = entry_mod.launch_counts()
    with graph_sharding(mesh):
        state, logs = fn(state, batch)
        torch.cuda.synchronize()
        step_counts = {k: v - c0[k]
                       for k, v in entry_mod.launch_counts().items()}
        grads = {k: p.grad.detach().float().cpu()
                 for k, p in state.model.named_parameters()}
        step_ms = par_timed(lambda: fn(state, batch), iters=1)
    peak = torch.cuda.max_memory_allocated(mesh.device)
    # the same first step again, from the seeded state: bitwise alike
    del fn, state, batch
    torch.cuda.empty_cache()
    fn, (state, batch) = train_entry(device=mesh.device, batch=8)
    with graph_sharding(mesh):
        state, again = fn(state, batch)
        torch.cuda.synchronize()
    repeat_equal = float(again["loss"]) == float(logs["loss"]) and all(
        torch.equal(p.grad.detach().float().cpu(), grads[k])
        for k, p in state.model.named_parameters())
    return dict(logits=logits, loss=float(logs["loss"]), grads=grads,
                fwd_counts=fwd_counts, step_counts=step_counts,
                fwd_ms=fwd_ms, step_ms=step_ms, peak_bytes=peak,
                repeat_equal=repeat_equal)


def par_split_moments(parts: int):
    """``BatchNorm._moments`` of one process whose batch is ``parts`` data
    ranks' rows: each block's sums added in rank order, as the data group's
    all-reduce adds them (the reference of (c))."""
    def moments(self, x32):
        axes = tuple(range(x32.dim() - 1))
        c = x32.shape[-1]
        total = None
        for block in x32.chunk(parts, 0):
            sums = torch.cat([block.sum(dim=axes),
                              block.square().sum(dim=axes),
                              block.new_full((1,), block.numel() // c)])
            total = sums if total is None else total + sums
        count = total[2 * c]
        mean, mean_sq = total[:c] / count, total[c:2 * c] / count
        return mean, torch.clamp(mean_sq - mean.square(), min=0.0), count
    return moments


def par_expected(s: int) -> dict:
    """The launches per rank, worked out from ROWS' routes before the run:
    a spatial call whose N and M divide by s is partitioned (one knn_mr
    call on the gather; on the ring s knn_topk calls and s + 1 row
    normalizations, the queries' and each shard's), a label call whose M
    divides takes one knn_topk call and two normalizations (the label
    queries' and the target block's); anything else one knn_mr call."""
    spatial = [(n, m, c) for (_, n, m, _, _, _, _, c, dt, tg) in ROWS
               if dt == "bf16" and tg != "labels"]
    labels = [(n, m, c) for (_, n, m, _, _, _, _, c, dt, tg) in ROWS
              if dt == "bf16" and tg == "labels"]
    part = sum(c for n, m, c in spatial if n % s == 0 and m % s == 0)
    whole = sum(c for n, m, c in spatial) - part
    lab = sum(c for n, m, c in labels if m % s == 0)
    lab_whole = sum(c for n, m, c in labels) - lab
    return dict(
        gather=dict(knn_mr=part + whole + lab_whole, knn_topk=lab,
                    knn_mr_normalize=2 * lab),
        ring=dict(knn_mr=whole + lab_whole, knn_topk=s * part + lab,
                  knn_mr_normalize=(s + 1) * part + 2 * lab),
        backward=part + whole + lab_whole, gather_backward=lab)


def par_counts_are(counts: dict, want: dict) -> bool:
    return all(counts[key] == value for key, value in want.items())


def par_768_rank() -> dict:
    """(e) on one rank of a world of 4: one train step of
    configs/gkgnet_coco_768_dist.py at its own batch on its own mesh."""
    cfg = train_cli.load_config(PAR_768_CONFIG, [])
    mesh = make_mesh(cfg.mesh.get("data"), cfg.mesh.get("graph", 1))
    state = train_cli.build_train_state(cfg, 0, mesh.device, 1, False)
    batch = cfg.data["samples_per_device"] * mesh.data
    size, classes = cfg.model["size"], cfg.model["n_classes"]
    rng = np.random.default_rng(0)
    data = {"img": torch.from_numpy(rng.standard_normal(
                (batch, size, size, 3), dtype=np.float32)),
            "gt_label": torch.from_numpy(
                rng.random((batch, classes)) < 0.05).float()}
    torch.cuda.reset_peak_memory_stats(mesh.device)
    step = make_train_step()
    with graph_sharding(mesh):
        t = time.perf_counter()
        state, logs = step(state, shard_batch(data, mesh), 0)
        torch.cuda.synchronize()
    return dict(loss=float(logs["loss"]), batch=batch,
                mesh=(mesh.data, mesh.graph),
                ms=(time.perf_counter() - t) * 1e3,
                peak_bytes=torch.cuda.max_memory_allocated(mesh.device))


def par_nccl_rank() -> dict:
    """(f) on an NCCL world of one rank: every collective wrapper on CUDA
    tensors through NCCL (a world of one gives each its identity), then
    the t@128 data-parallel step of dryrun_multichip."""
    import torch.distributed as dist

    mesh = make_mesh()
    check(mesh.backend == "nccl", f"backend {mesh.backend}, expected nccl")
    world = dist.group.WORLD
    x = torch.randn((4, 6, 8), device=mesh.device).bfloat16()
    for fn in (collectives._AllGather, collectives._ScatterRows,
               collectives._GatherRows):
        xr = x.clone().requires_grad_()
        y = fn.apply(xr, world, 1)
        y.float().sum().backward()
        check(torch.equal(y, x) and bool((xr.grad == 1).all()),
              f"{fn.__name__} on NCCL")
    for fn in (collectives._AllReduce, collectives._AllReduceReplicated):
        xr = x.clone().requires_grad_()
        y = fn.apply(xr, world)
        y.float().sum().backward()
        check(torch.equal(y, x) and bool((xr.grad == 1).all()),
              f"{fn.__name__} on NCCL")
    t = x.float().clone()
    collectives.reduce_mean_([t], world, 1)
    collectives.broadcast_(t, 0)
    check(torch.equal(t, x.float()), "reduce_mean_ / broadcast_ on NCCL")
    out = entry_mod.dryrun_rank("t128", 2, 1, False, graph=1)
    return dict(backend=mesh.backend, loss=out["loss"][0])


def parallel_phase(smi: str, ref_logits: torch.Tensor,
                   ref_step1: tuple) -> dict:
    """Phase 13 (a), (b), (c), (e), (f); (d) runs in phase 9's directory
    (parallel_cli_phase). Returns (c)'s launch counts."""
    t0 = time.perf_counter()
    log(f"parallel ({smi}): worlds of ranks spawned on this one card over "
        f"gloo (pinned host buffers; NCCL refuses two ranks on one device): "
        f"ranks sharing one card measure the partition's overhead, not its "
        f"scaling")
    # (a) + (b): one world of 2 (data 1, graph 2)
    t = time.perf_counter()
    res = spawn.run_world(par_calls_rank, PAR_GRAPH, (ROWS, BG),
                          device="cuda", timeout_s=PAR_TIMEOUT_S)
    log(f"parallel (a)+(b): world {PAR_GRAPH}, mesh data 1 x graph "
        f"{PAR_GRAPH}, transport {res[0]['backend']}, rank devices "
        f"{[r['device'] for r in res]}; {time.perf_counter() - t:.1f} s")
    for i, row in enumerate(res[0]["rows"]):
        rank_ms = [r["rows"][i]["ms"] for r in res]
        row = dict(row, ms=max(rank_ms), ms_per_rank=rank_ms,
                   launches_per_rank=[r["rows"][i]["launches"]
                                      for r in res])
        row.pop("launches")
        print(f"par_row {json.dumps(row)}", flush=True)
    log(f"parallel (a) ({smi}): {len(res[0]['rows'])} calls at the s@576 "
        f"stage and label shapes (BG {BG}, bf16): idx and mr bitwise the "
        f"unpartitioned kernel's for the gather, ring and label-sharded "
        f"builds; each gather shard's backward gx bitwise -g, gy summed "
        f"over the graph group within {PAR_GY_REL:.3g} of the magnitudes")
    want = par_expected(PAR_GRAPH)
    fp32_ref = par_fp32_grads()
    for r in res:
        check(torch.equal(r["logits"], ref_logits.float()),
              f"parallel (b) rank {r['rank']}: logits differ from the "
              f"single-process forward's (max |diff| "
              f"{(r['logits'] - ref_logits.float()).abs().max().item()})")
        check(r["loss"] == ref_step1[0], f"parallel (b) rank {r['rank']}: "
              f"loss {r['loss']!r} against {ref_step1[0]!r}")
        check(par_counts_are(r["fwd_counts"], want["gather"])
              and r["step_counts"]["knn_mr_backward"] == want["backward"]
              and r["step_counts"]["gather_backward"]
              == want["gather_backward"],
              f"parallel (b) rank {r['rank']}: counts {r['fwd_counts']} / "
              f"{r['step_counts']}, expected {want}")
        check(r["repeat_equal"], f"parallel (b) rank {r['rank']}: the bf16 "
              f"graph-only step's loss and gradients differ over two runs")
        # bf16: printed; fp32 below holds the same backward
        gaps = sorted(par_leaf_gaps(r["grads"], {
            k: v.float().cpu() for k, v in ref_step1[1].items()}).values())
        fp32 = par_leaf_gaps(r["fp32_grads"], fp32_ref)
        worst = max(fp32, key=fp32.get)
        log(f"parallel (b) rank {r['rank']} ({smi}): logits bitwise the "
            f"single-process forward's, step-1 loss {r['loss']!r} bitwise; "
            f"the bf16 step's loss and gradients bitwise alike over two "
            f"runs; its gradients against the single process's, "
            f"max|diff| / max|grad| per leaf: median "
            f"{gaps[len(gaps) // 2]:.3e}, worst {gaps[-1]:.3e}; the t@128 "
            f"fp32 step's: median {sorted(fp32.values())[len(fp32) // 2]:.3e}"
            f", worst {fp32[worst]:.3e} ({worst}; bound {PAR_GRAD_REL}); "
            f"{r['fwd_ms']:.2f} ms/forward, {r['step_ms']:.2f} ms/step at "
            f"batch 8; peak {r['peak_bytes'] / 2**30:.2f} GiB; launches "
            f"{r['fwd_counts']} / {r['step_counts']}")
        check(fp32[worst] <= PAR_GRAD_REL,
              f"parallel (b) rank {r['rank']}: the fp32 graph-only "
              f"gradients off the one-process step's by {fp32[worst]:.3e} "
              f"of {worst}'s largest entry")
        for key in ("grads", "fp32_grads"):
            same = all(torch.equal(g, res[0][key][k])
                       for k, g in r[key].items())
            check(same, f"parallel (b) rank {r['rank']}: {key} differ from "
                  f"rank {res[0]['rank']}'s")
    del res

    # (c): data 2 x graph 2, a world of 4
    state, data, step = entry_mod.dryrun_state("s576", "cuda", 8)
    data = {k: v.cuda() for k, v in data.items()}
    own = BatchNorm._moments
    BatchNorm._moments = par_split_moments(2)
    ref_loss = []
    try:
        for _ in range(2):
            state, logs = step(state, data, 7)
            ref_loss.append(float(logs["loss"]))
    finally:
        BatchNorm._moments = own
    del state, data, step, logs
    torch.cuda.empty_cache()
    log(f"parallel (c): expected launches per rank and call, from the "
        f"routes: {json.dumps(want)}")
    t = time.perf_counter()
    res = entry_mod.dryrun_multichip_prod(4, device="cuda", batch=8,
                                          steps=2, report=True)
    log(f"parallel (c): world 4, mesh data 2 x graph 2, transport "
        f"{res[0]['backend']}, rank devices {[r['device'] for r in res]}; "
        f"{time.perf_counter() - t:.1f} s")
    # the two steps again from the seeded state, in a new world
    t = time.perf_counter()
    again = entry_mod.dryrun_multichip_prod(4, device="cuda", batch=8,
                                            steps=2)
    log(f"parallel (c): the two steps again in a new world of 4; "
        f"{time.perf_counter() - t:.1f} s")
    check([r["rank"] for r in again] == [r["rank"] for r in res],
          f"parallel (c): ranks {[r['rank'] for r in again]} in the second "
          f"world, {[r['rank'] for r in res]} in the first")
    counts = dict(knn_mr=0, knn_mr_backward=0, knn_topk=0,
                  knn_mr_normalize=0, gather_backward=0)
    for r, r2 in zip(res, again):
        eg, er = r["eval_gather"], r["eval_ring"]
        check(par_counts_are(eg["counts"], want["gather"])
              and par_counts_are(er["counts"], want["ring"]),
              f"parallel (c) rank {r['rank']}: eval launches "
              f"{eg['counts']} / {er['counts']}, expected {want}")
        for i, st in enumerate(r["steps"] + r2["steps"]):
            c = st["counts"]
            check(par_counts_are(c, want["gather"])
                  and c["knn_mr_backward"] == want["backward"]
                  and c["gather_backward"] == want["gather_backward"]
                  and c["knn_mr_grouped"] == 0,
                  f"parallel (c) rank {r['rank']} step {i}: launches {c}")
            if i < len(r["steps"]):  # the first call's steps
                for key in counts:
                    counts[key] += c[key]
        for key in ("knn_mr", "knn_topk", "knn_mr_normalize"):
            counts[key] += eg["counts"][key] + er["counts"][key]
        check(all(math.isfinite(v) for v in r["loss"])
              and r["loss"] == res[0]["loss"],
              f"parallel (c) rank {r['rank']}: losses {r['loss']}")
        check(r2["loss"] == r["loss"], f"parallel (c) rank "
              f"{r['rank']}: the two steps' losses {r['loss']} and, run "
              f"again, {r2['loss']}")
        check(r["params_digest"] == res[0]["params_digest"],
              f"parallel (c) rank {r['rank']}: the parameters after the "
              f"steps differ from rank {res[0]['rank']}'s")
        check(bool(eg["logits"].isfinite().all())
              and torch.equal(er["logits"], eg["logits"]),
              f"parallel (c) rank {r['rank']}: the ring's logits differ "
              f"from the gather's")
        log(f"parallel (c) rank {r['rank']} ({smi}): eval "
            f"{eg['ms']:.2f} ms/forward (gather), {er['ms']:.2f} (ring); "
            f"steps {[round(st['ms'], 2) for st in r['steps']]} ms; peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; launches per forward "
            f"{eg['counts']} (gather), {er['counts']} (ring), per step "
            f"{r['steps'][0]['counts']}")
    gaps = [abs(got - ref) / abs(ref)
            for got, ref in zip(res[0]["loss"], ref_loss)]
    log(f"parallel (c): the parameters after the steps bitwise alike on "
        f"the 4 ranks; both steps' losses bitwise alike over two runs; step "
        f"losses {res[0]['loss']!r} against the "
        f"one-process steps' {ref_loss!r} (moments summed by data rank): "
        f"relative gaps {[f'{g:.3e}' for g in gaps]} (step 1's tolerance "
        f"{PAR_LOSS_RTOL}; step 2's printed: it follows step 1's bf16 "
        f"update, whose gradients round the ranks' partial sums otherwise "
        f"than the one process, see (b); the fp32 world below holds the "
        f"update)")
    check(gaps[0] <= PAR_LOSS_RTOL, f"parallel (c): step-1 loss gap "
          f"{gaps[0]:.3e}")
    del res, again

    # (c) in fp32 and (f), NCCL in a world of one rank, alongside (e) (the
    # worlds' starts overlap; their t@128 steps are slivers of (e)'s)
    dp_ref = par_fp32_grads(moments_parts=2)
    pool = ThreadPoolExecutor(2)
    dp = pool.submit(spawn.run_world, par_fp32_dp_rank, 4, device="cuda",
                     timeout_s=PAR_TIMEOUT_S)
    nccl = pool.submit(spawn.run_world, par_nccl_rank, 1, device="cuda",
                       backend="nccl", timeout_s=PAR_TIMEOUT_S)
    # (e): configs/gkgnet_coco_768_dist.py, a world of 4, not a gate
    t = time.perf_counter()
    try:
        res = spawn.run_world(par_768_rank, 4, device="cuda",
                              timeout_s=PAR_TIMEOUT_S)
        log(f"parallel (e) ({smi}): configs/gkgnet_coco_768_dist.py, mesh "
            f"{res[0]['mesh']}, batch {res[0]['batch']}: loss "
            f"{res[0]['loss']:.6g}, {max(r['ms'] for r in res):.1f} ms for "
            f"the first step (with (c)'s fp32 and (f)'s worlds on the "
            f"card); peak "
            f"per rank {[round(r['peak_bytes'] / 2**30, 2) for r in res]} "
            f"GiB")
    except RuntimeError as err:
        last = str(err).strip().splitlines()[-1]
        log(f"parallel (e) ({smi}): configs/gkgnet_coco_768_dist.py: the "
            f"four ranks did not fit on one card ({last}); "
            f"{time.perf_counter() - t:.1f} s")
    finally:
        pool.shutdown(wait=True)
    res = {r["coords"]: r for r in dp.result()}
    for (d, g), r in res.items():
        check(all(torch.equal(a, b) for a, b in
                  zip(r["before"], res[(d, 1 - g)]["before"])),
              f"parallel (c) fp32: data rank {d}'s graph ranks entered the "
              f"data mean with different gradients")
        want = [(a + b) / 2 for a, b in zip(res[(0, g)]["before"],
                                            res[(1, g)]["before"])]
        check(all(torch.equal(a, b) for a, b in zip(r["after"], want)),
              f"parallel (c) fp32: rank {(d, g)}'s gradients after the "
              f"data mean are not the data ranks' mean")
        check(all(torch.equal(t, res[(0, 0)]["grads"][k])
                  for k, t in r["grads"].items()),
              "parallel (c) fp32: the 4 ranks stepped with different "
              "gradients")
    gaps = par_leaf_gaps(res[(0, 0)]["grads"], dp_ref)
    worst = max(gaps, key=gaps.get)
    log(f"parallel (c) fp32 ({smi}): t@128 on data 2 x graph 2, global "
        f"batch {PAR_FP32_BATCH}: each data rank's graph ranks entered the "
        f"train step's data mean with bitwise-equal gradients, left it with "
        f"the data ranks' mean bitwise, and stepped alike; against the "
        f"one-process step's (moments summed by data rank; batch 4 against "
        f"the ranks' 2, so other convolution algorithms), max|diff| / "
        f"max|grad| per leaf: median "
        f"{sorted(gaps.values())[len(gaps) // 2]:.3e}, worst "
        f"{gaps[worst]:.3e} ({worst}), printed")
    res = nccl.result()
    check(math.isfinite(res[0]["loss"]), f"parallel (f): {res[0]}")
    log(f"parallel (f): an NCCL world of one rank: every collective wrapper "
        f"on CUDA tensors, then the t@128 step (loss {res[0]['loss']:.6g})")
    log(f"parallel: phase 13 (a)-(c), (e), (f) passed in "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


def torchrun(nproc: int, module: str, args: list, timeout_s: float
             ) -> subprocess.CompletedProcess:
    """``python -m torch.distributed.run --standalone`` of a port module;
    the launcher's process group is killed at ``timeout_s``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", module, *args]
    env = dict(os.environ, PYTHONPATH=REPO_DIR)
    proc = subprocess.Popen(cmd, cwd=REPO_DIR, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise RuntimeError(f"{module} on {nproc} ranks outlasted "
                           f"{timeout_s:.0f} s")
    check(proc.returncode == 0, f"{module} on {nproc} ranks exited "
          f"{proc.returncode}:\n{err[-3000:]}")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def parallel_cli_phase(root: str, cli: dict, smi: str) -> None:
    """Phase 13 (d), in phase 9's directory: the train CLI through
    torch.distributed.run on 4 ranks (data 2 x graph 2) for an epoch of
    PAR_CLI_IMAGES of phase 9's images, then the test CLI on 4 ranks and on
    1 rank on its checkpoint: the scores in dataset order, their largest
    gap, the mAPs."""
    t0 = time.perf_counter()
    data = cli["data"]
    with open(os.path.join(data, "train.data"), "rb") as f:
        records = pickle.load(f)
    small = os.path.join(data, f"train{PAR_CLI_IMAGES}.data")
    with open(small, "wb") as f:
        pickle.dump(records[:PAR_CLI_IMAGES], f)
    options = [o for o in cli["options"]
               if not o.startswith("data.train.dataset.ann_file=")]
    # the epoch-seeded DistributedSampler: RepeatAugSampler keeps
    # multiples of 256 images, none of PAR_CLI_IMAGES
    options += [f"data.train.dataset.ann_file={small}",
                "data.samples_per_device=4", "data.loader_mode=threads",
                "sampler.type=None"]
    mesh = ["mesh.data=2", "mesh.graph=2"]
    work = os.path.join(root, "work_parallel")
    t = time.perf_counter()
    torchrun(4, "gkgnet_tpu_torch.tools.train",
             [CLI_CONFIG, "--work-dir", work, "--seed", "0",
              "--cfg-options", *options, *mesh, "runner.max_epochs=1",
              # no eval in the epoch (the test CLI below scores the set);
              # a train record for every step
              "evaluation.interval=2", "checkpoint_config.interval=1",
              "log_config.interval=1"],
             PAR_TIMEOUT_S)
    train_s = time.perf_counter() - t
    logs = [f for f in os.listdir(work) if f.endswith(".log.json")]
    check(len(logs) == 1, f"parallel (d): {logs}")
    with open(os.path.join(work, logs[0])) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if r["mode"] == "train"]
    check(steps and all(math.isfinite(r["loss"]) for r in steps),
          f"parallel (d): records {records}")
    with open(os.path.join(work, [f for f in os.listdir(work)
                                  if f.endswith(".log")][0])) as f:
        text = f.read()
    epoch = re.search(r"(\d+) steps in [0-9.]+ s \(([0-9.]+) ms/step\)",
                      text)
    check(epoch is not None, "parallel (d): no epoch line in the log")
    log(f"parallel (d) ({smi}): train CLI on 4 ranks (data 2 x graph 2, "
        f"global batch 8) in {train_s:.1f} s with the launch: "
        f"{epoch.group(1)} steps, {epoch.group(2)} ms/step, train loss "
        f"{steps[-1]['loss']:.6g}")
    ckpt = os.path.join(work, "checkpoints")
    out4 = os.path.join(root, "scores_par4.pkl")
    m4 = os.path.join(root, "metrics_par4.json")
    t = time.perf_counter()
    torchrun(4, "gkgnet_tpu_torch.tools.test",
             [CLI_CONFIG, ckpt, "--out", out4, "--metrics-out", m4,
              "--cfg-options", *options, *mesh], PAR_TIMEOUT_S)
    test4_s = time.perf_counter() - t
    with open(out4, "rb") as f:
        scores4 = pickle.load(f)
    with open(m4) as f:
        metrics4 = json.load(f)
    metrics1, scores1 = test_cli.main(
        [CLI_CONFIG, ckpt, "--cfg-options", *options])
    check(scores4.shape == scores1.shape == (cli["n_val"], 80),
          f"parallel (d): scores {scores4.shape} / {scores1.shape}")
    gap = float(np.abs(scores4 - scores1).max())
    diff = abs(metrics4["mAP"] - metrics1["mAP"])
    log(f"parallel (d) ({smi}): test CLI on 4 ranks in {test4_s:.1f} s with "
        f"the launch: scores in dataset order, largest gap to the 1-rank "
        f"CLI's {gap:.3e}; mAP {metrics4['mAP']:.4f} against "
        f"{metrics1['mAP']:.4f} (|diff| {diff}, tolerance "
        f"{PAR_CLI_MAP_TOL}); {time.perf_counter() - t0:.1f} s")
    check(diff <= PAR_CLI_MAP_TOL, f"parallel (d): mAP |diff| {diff}")


def per_step(rows: list[dict], calls_key: str) -> dict:
    """The rows' ms, plain_ms and bound_ms summed over the main path's calls,
    and the bound that holds for the larger part of that bound_ms."""
    main_rows = [r for r in rows if r[calls_key]]
    total = {key: sum(r[key] * r[calls_key] for r in main_rows)
             for key in ("ms", "plain_ms", "bound_ms")}
    by_ops = sum(r["bound_ms"] * r[calls_key] for r in main_rows
                 if r["bound_by"] == "operations")
    total["bound_by"] = ("operations" if by_ops > total["bound_ms"] / 2
                         else "bytes")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {kind} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")

    # 2. build: one nvcc per source, all started together
    t = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda load: load(), (knn_mr._lib, knn_mr._bwd_lib,
                                            knn_topk._lib)))
    for name in ("knn_mr", "knn_mr_bwd", "knn_topk"):
        seconds, compiler_log = _build.build_info[name]
        log(f"build: {name}.cu in {seconds:.1f} s")
        print_ptxas_summary(compiler_log)
    log(f"build: the three sources built and loaded in "
        f"{time.perf_counter() - t:.1f} s")

    # 3. kernels vs plain at every main-path shape
    rows = kernel_rows()
    log("kernels: every forward row passed (a) bitwise mr and (b) the fp64 "
        "oracle")
    bwd_rows = backward_rows()
    log("kernels: every backward row passed (e) gx bitwise -g, (f) gy "
        "bitwise the ordered plain version and within the fp64 bound, and "
        "(g) determinism")
    t_rows = topk_rows()
    log("kernels: every knn_topk row passed the fp64 oracle, the value bound, "
        "the plain idx up to near-ties, determinism and the tie and NaN "
        "fixtures")
    g_rows = gather_rows()
    log("kernels: every gather backward row passed gy bitwise the ordered "
        "plain version, within the fp64 bound, and determinism")

    # 4. eval: the main path, then requests
    fn, (model, x) = entry(device="cuda", batch=8)
    log("model: GKGNet-S@576 bf16, batch 8, built")
    knn_mr.launches = 0
    knn_mr.grouped_launches = 0
    knn_mr.backward_launches = 0
    knn_topk.launches = 0
    logits = fn(model, x)
    torch.cuda.synchronize()
    check(knn_mr.launches == 16 and knn_topk.launches == 0
          and knn_mr.grouped_launches == 0,
          f"{knn_mr.launches} knn_mr, {knn_mr.grouped_launches} grouped and "
          f"{knn_topk.launches} knn_topk launches in one forward, expected "
          f"16, 0 and 0")
    ref_logits = logits.cpu()
    check(logits.shape == (8, 80) and bool(torch.isfinite(logits).all()),
          f"logits {tuple(logits.shape)} finite={torch.isfinite(logits).all()}")
    for i in range(3):
        images = torch.randn((8, 576, 576, 3),
                             generator=torch.Generator().manual_seed(100 + i))
        scores = predict(model, images.to(torch.bfloat16))
        torch.cuda.synchronize()
        check(scores.shape == (8, 80) and bool(torch.isfinite(scores).all())
              and float(scores.min()) >= 0.0 and float(scores.max()) <= 1.0,
              f"request {i}: scores {tuple(scores.shape)}")
        log(f"request {i}: scores {tuple(scores.shape)} in "
            f"[{float(scores.min()):.4f}, {float(scores.max()):.4f}]")
    eval_launches = knn_mr.launches
    check(eval_launches == 64 and knn_mr.backward_launches == 0
          and knn_mr.grouped_launches == 0,
          f"{eval_launches} forward and {knn_mr.backward_launches} backward "
          f"launches over one forward and 3 requests, expected 64 and 0")
    fwd_ms = cuda_ms(lambda: fn(model, x), 10, 2)
    log(f"model: {fwd_ms:.2f} ms/forward at batch 8, "
        f"{8e3 / fwd_ms:.1f} img/s (bf16)")
    profile_device(lambda: fn(model, x), "forward")
    del model, x, logits
    torch.cuda.empty_cache()

    compare_fp32_paths()

    # 5. train: the main path, then the fp32 per-call check
    train = train_phase()
    compare_fp32_train()

    # 6. this slice's path: the Grapher blocks through knn_topk
    graph = grapher_phase()
    compare_fp32_grapher()

    # 7. the grouped path; 8. the phases
    step1 = train.pop("step1")
    grouped = grouped_phase(ref_logits, step1)
    phase = phases_phase()

    # 9. the config-driven CLIs; 10. the serving path on their checkpoint;
    # 11. the VOC path and the tools
    cli, served, voc = cli_phase(smi)
    cli_fwd, cli_bwd = cli["launches"]
    voc_fwd, voc_bwd = voc["launches"]

    # 12. arch b@576, its ungrouped backbone at D = 1024, the other new
    # model features
    arch_b = arch_b_phase(smi)
    b_fwd, b_bwd = arch_b["launches"]

    # 13. data and graph parallelism: worlds of ranks on this card ((d), the
    # CLIs on a world of ranks, ran in phase 9's directory)
    par = parallel_phase(smi, ref_logits, step1)
    del step1

    # 14. GKGNet-T@576 from its config, and profile_breakdown on it
    arch_t = arch_t_phase(smi)
    t_fwd, t_bwd = arch_t["launches"]

    # result lines
    fwd = per_step(rows, "calls_per_forward")
    bwd = per_step(bwd_rows, "calls_per_step")
    topk = per_step(t_rows, "calls_per_pass")
    gat = per_step(g_rows, "calls_per_step")
    g_fwd = per_step(grouped["rows"], "calls_per_forward")
    train_fwd, train_bwd = train["launches"]
    kernels = [{
        "name": "knn_mr_fused",
        "route": "cuda",
        "source": "gkgnet_tpu_torch/csrc/knn_mr.cu",
        "replaces": "gkgnet_tpu/ops/pallas/knn_mr.py:874",
        # the eval path (one forward + 3 requests), the train path (3
        # steps), the CLI path (32 steps, the val_loss pass, raw and EMA
        # evaluations, the test CLI raw and EMA), the serving path
        # (PreciseBN, inference, the artifacts' forwards, the deployment
        # test, both servers' requests), the VOC path (16 steps, val,
        # the test CLI, the tools, the test CLI on the imported weights)
        # phase 12 (arch b eval and train, the ungrouped backbone, the
        # features config's knn steps), phase 13 (c) (the 4 ranks' eval
        # forward and 2 steps on the gather schedule) and phase 14 (t@576
        # eval and train)
        "launches": eval_launches + train_fwd + cli_fwd + served["launches"]
        + voc_fwd + b_fwd + par["knn_mr"] + t_fwd,
        "max_abs_err": max(r["max_abs_err"] for r in
                           rows + voc["rows"] + arch_b["rows"]
                           + arch_t["rows"]),
        # per forward at batch 8: the sum over the 16 calls' shapes
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": None,  # no single PyTorch call computes kNN + mr
    }, {
        "name": "knn_mr_backward",
        "route": "cuda",
        "source": "gkgnet_tpu_torch/csrc/knn_mr_bwd.cu",
        "replaces": "gkgnet_tpu/ops/pallas/knn_mr.py:1054",
        # the train path, the CLI path, the VOC path (16 steps and
        # vis_cam's saliency), phase 12, phase 13 (c) (2 steps on 4 ranks)
        # and phase 14 (t@576's train steps)
        "launches": train_bwd + cli_bwd + voc_bwd + b_bwd
        + par["knn_mr_backward"] + t_bwd,
        # largest |gy - the ordered plain version's gy| over the rows (0:
        # bitwise; the rows print |gy - exact fp64 sum| as fp64_err)
        "max_abs_err": max(r["max_abs_err"] for r in
                           bwd_rows + voc["bwd_rows"] + arch_b["bwd_rows"]
                           + arch_t["bwd_rows"]),
        # per train step at batch 8: the sum over the 16 calls' shapes
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the tie-split
                             # VJP of gather + max
    }, {
        "name": "knn_topk",
        "route": "cuda",
        "source": "gkgnet_tpu_torch/csrc/knn_topk.cu",
        "replaces": "gkgnet_tpu/ops/pallas/knn_topk.py:140",
        # the Grapher path: 4 aggregators x 9 blocks x (eval + train) and
        # the 3 stochastic 'mr' blocks in train; phase 13 (c): the 4 ranks'
        # label-sharded builds and ring schedule
        "launches": graph["launches"] + par["knn_topk"],
        # largest |distance - fp64 distance| over the rows' checked values
        # (phase 3's and phase 12's D = 1024 rows)
        "max_abs_err": max(r["max_abs_err"]
                           for r in t_rows + arch_b["topk_rows"]),
        # per aggregator pass at batch 8: the sum over the 9 blocks' calls
        "ms": topk["ms"],
        "plain_ms": topk["plain_ms"],
        "bound_ms": topk["bound_ms"],
        "bound_by": topk["bound_by"],
        "library_ms": None,  # no single PyTorch call computes distance +
                             # top-k (the rows print the two-call route)
    }, {
        "name": "knn_mr_fused_grouped",
        "route": "cuda",
        "source": "gkgnet_tpu_torch/csrc/knn_mr.cu",
        "replaces": "gkgnet_tpu/ops/pallas/knn_mr.py:1167",
        # the grouped path: eval (one forward + 3 requests) and train (3
        # steps); the serving path's grouped artifact (one forward)
        "launches": grouped["eval_launches"] + grouped["train_launches"][0]
        + served["grouped_launches"],
        # largest |mr - the plain version's mr| over the 16 calls in bf16
        # and in fp32, on the (row, group) pairs whose idx agrees with the
        # plain idx (the rest are near-tie flips, held to the fp64 oracle)
        "max_abs_err": max(r["max_abs_err"] for r in
                           grouped["rows"] + grouped["fp32_rows"]),
        # per forward at batch 8: the sum over the 16 calls
        "ms": g_fwd["ms"],
        "plain_ms": g_fwd["plain_ms"],
        "bound_ms": g_fwd["bound_ms"],
        "bound_by": g_fwd["bound_by"],
        "library_ms": None,  # no single PyTorch call computes kNN + mr
    }, {
        "name": "exp_kernel_phases",
        "route": "cuda",
        # the phases are instantiations of the knn_mr forward kernel
        "source": "gkgnet_tpu_torch/csrc/knn_mr.cu",
        "replaces": "tools/exp_kernel_phases.py:108",
        # the tool's timing run: 4 phases x (2 warmup + 10 timed)
        "launches": phase["launches"],
        # largest |checksum - fp64 checksum| over dist, gfix and selg
        "max_abs_err": phase["max_abs_err"],
        # one launch of each of the four phases, summed
        "ms": sum(r["ms"] for r in phase["rows"].values()),
        "plain_ms": sum(r["plain_ms"] for r in phase["rows"].values()),
        "bound_ms": sum(r["bound_ms"] for r in phase["rows"].values()),
        "bound_by": phase["rows"]["selg"]["bound_by"],
        "library_ms": None,  # a phase is a piece of a kernel: no PyTorch
                             # call computes its checksum
    }, {
        "name": "gather_backward",
        "route": "cuda",
        "source": "gkgnet_tpu_torch/csrc/knn_mr_bwd.cu",
        # no Pallas kernel: the JAX package's gather_nodes, whose VJP XLA
        # computes (a scatter-add)
        "replaces": "gkgnet_tpu/ops/aggregate.py:27",
        # the Grapher path's train passes (phase 6) and phase 13 (c) (the
        # label-sharded builds' owner-side fetch in each step)
        "launches": graph["gathers"] + par["gather_backward"],
        # largest |gy - the ordered plain version's gy| over the rows
        "max_abs_err": max(r["max_abs_err"] for r in g_rows),
        # per train step of a (b) rank: the 4 label-sharded calls
        "ms": gat["ms"],
        "plain_ms": gat["plain_ms"],
        "bound_ms": gat["bound_ms"],
        "bound_by": gat["bound_by"],
        # one index_add_ (torch.gather's own backward, float atomics) on
        # the same rows, summed over the same calls
        "library_ms": sum(r["library_ms"] * r["calls_per_step"]
                          for r in g_rows),
    }]
    log(f"kernel knn_mr_fused: {eval_launches} launches on the eval path "
        f"(one forward + 3 requests), {train_fwd} on the train path (3 "
        f"steps), {cli_fwd} on the CLI path, {served['launches']} on "
        f"the serving path and {voc_fwd} on the VOC path; kernel "
        f"knn_mr_backward: {train_bwd} on the train path, {cli_bwd} on the "
        f"CLI path and {voc_bwd} on the VOC path; checks passed at "
        f"{len(rows)} + {len(voc['rows'])} (VOC@448) shapes each, 16 fp32 "
        f"forward calls "
        f"and 16 fp32 backward calls on the model's own activations; kernel "
        f"knn_topk: {graph['launches']} launches on the Grapher path, checks "
        f"passed at {len(t_rows)} shapes and on the blocks' fp32 calls; "
        f"kernel knn_mr_fused_grouped: {grouped['eval_launches']} launches "
        f"on the grouped eval path, {grouped['train_launches'][0]} on its "
        f"train path and {served['grouped_launches']} from the serving "
        f"path's grouped artifact, bitwise the folded route and held to the "
        f"plain "
        f"version at the 16 calls in bf16 and fp32; kernel "
        f"exp_kernel_phases: {phase['launches']} launches on the tool's "
        f"run, every phase held to its plain version; phase 12: {b_fwd} "
        f"knn_mr and {b_bwd} backward launches (arch b@576 eval "
        f"{arch_b['fwd_ms']:.2f} ms/forward, train {arch_b['step_ms']:.2f} "
        f"ms/step), {len(arch_b['rows'])} forward, "
        f"{len(arch_b['bwd_rows'])} backward and "
        f"{len(arch_b['topk_rows'])} knn_topk rows held to the plain "
        f"versions; phase 14: {t_fwd} knn_mr and {t_bwd} backward launches "
        f"(t@576 eval {arch_t['fwd_ms']:.2f} ms/forward, train "
        f"{arch_t['step_ms']:.2f} ms/step); kernel gather_backward: "
        f"{graph['gathers']} launches on the Grapher path and "
        f"{par['gather_backward']} in phase 13 (c), {len(g_rows)} rows "
        f"held bitwise to the ordered plain version")
    log(f"done: {time.perf_counter() - T0:.1f} s in all")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
