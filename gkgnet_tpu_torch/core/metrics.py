"""Evaluation metrics (host-side numpy; counterpart:
``gkgnet_tpu/core/metrics.py``, a copy) — the full reference family:

  * ``average_precision`` / ``mAP_coco`` — the COCO evaluator's own AP
    (reference datasets/coco.py:87-103: precision@i summed at positives /
    (n_pos + 1e-8), fraction in [0, 1]).
  * ``mAP_mmcls`` — mmcls core/evaluation/mean_ap.py:6-74 variant with
    difficult (-1) handling, returns percent.
  * ``average_performance`` — CP/CR/CF1/OP/OR/OF1 at a threshold or top-k
    (core/evaluation/multilabel_eval_metrics.py:8-72).
  * ``coco_metrics`` — the full dict emitted by COCO.evaluate
    (datasets/coco.py:126-176, 301-330): mAP + CP/CR/CF1/OP/OR/OF1 at
    thr=0.5 and with top-3 masking, all scaled x100.
  * ``mAP_area`` — size-stratified s/m/l AP (datasets/coco.py:67-124).
  * single-label accuracy / precision-recall-F1 / support / confusion matrix
    (core/evaluation/eval_metrics.py essentials).
"""

from __future__ import annotations

import numpy as np

EPS = np.finfo(np.float32).eps


def average_precision(pred: np.ndarray, target: np.ndarray) -> float:
    """COCO evaluator AP for one class (coco.py:87-103)."""
    order = np.argsort(-pred, kind="stable")
    t = target[order]
    total_count = np.arange(1, len(pred) + 1, dtype=np.float64)
    pos = t == 1
    pos_count = np.cumsum(pos).astype(np.float64)
    total = pos_count[-1] if len(pos_count) else 0.0
    pos_count[~pos] = 0
    return float(np.sum(pos_count / total_count) / (total + 1e-8))


def mAP_coco(target: np.ndarray, pred: np.ndarray) -> tuple[float, np.ndarray]:
    """(mean_ap, per_class_ap) as fractions (coco.py:105-124 order of args:
    targets first)."""
    if pred.size == 0:
        return 0.0, np.zeros(0)
    ap = np.array([
        average_precision(pred[:, k], target[:, k]) for k in range(pred.shape[1])
    ])
    return float(ap.mean()), ap


def _average_precision_mmcls(pred: np.ndarray, target: np.ndarray) -> float:
    """mean_ap.py:6-44: difficult (-1) samples excluded from the ranking
    denominator."""
    order = np.argsort(-pred, kind="stable")
    t = target[order]
    pos = t == 1
    tp = np.cumsum(pos).astype(np.float64)
    total_pos = tp[-1] if len(tp) else 0.0
    pn = np.cumsum(t != -1).astype(np.float64)
    tp[~pos] = 0
    precision = tp / np.maximum(pn, EPS)
    return float(np.sum(precision) / np.maximum(total_pos, EPS))


def mAP_mmcls(pred: np.ndarray, target: np.ndarray) -> float:
    """Percent-scale mAP with difficult handling (mean_ap.py:47-74)."""
    assert pred.shape == target.shape
    ap = np.array([
        _average_precision_mmcls(pred[:, k], target[:, k])
        for k in range(pred.shape[1])
    ])
    return float(ap.mean() * 100.0)


def average_performance(pred, target, thr=None, k=None):
    """(CP, CR, CF1, OP, OR, OF1), percent (multilabel_eval_metrics.py:8-72)."""
    pred = np.asarray(pred)
    target = np.asarray(target).copy()
    if thr is None and k is None:
        thr = 0.5
    assert pred.shape == target.shape
    target[target == -1] = 0
    if thr is not None:
        pos_inds = (pred >= thr).astype(np.float64)
    else:
        sort_inds = np.argsort(-pred, axis=1)[:, :k]
        pos_inds = np.zeros_like(pred, dtype=np.float64)
        np.put_along_axis(pos_inds, sort_inds, 1.0, axis=1)
    tp = (pos_inds * target) == 1
    fp = (pos_inds * (1 - target)) == 1
    fn = ((1 - pos_inds) * target) == 1
    precision_class = tp.sum(0) / np.maximum(tp.sum(0) + fp.sum(0), EPS)
    recall_class = tp.sum(0) / np.maximum(tp.sum(0) + fn.sum(0), EPS)
    CP = precision_class.mean() * 100.0
    CR = recall_class.mean() * 100.0
    CF1 = 2 * CP * CR / np.maximum(CP + CR, EPS)
    OP = tp.sum() / np.maximum(tp.sum() + fp.sum(), EPS) * 100.0
    OR = tp.sum() / np.maximum(tp.sum() + fn.sum(), EPS) * 100.0
    OF1 = 2 * OP * OR / np.maximum(OP + OR, EPS)
    return CP, CR, CF1, OP, OR, OF1


def _precision_recall(target: np.ndarray, binary_pred: np.ndarray, average: str):
    """sklearn-compatible macro/micro multi-label precision+recall (zero
    division -> 0)."""
    tp = ((binary_pred == 1) & (target == 1)).sum(0).astype(np.float64)
    fp = ((binary_pred == 1) & (target != 1)).sum(0).astype(np.float64)
    fn = ((binary_pred != 1) & (target == 1)).sum(0).astype(np.float64)
    if average == "micro":
        p_den, r_den = tp.sum() + fp.sum(), tp.sum() + fn.sum()
        p = tp.sum() / p_den if p_den > 0 else 0.0
        r = tp.sum() / r_den if r_den > 0 else 0.0
        return float(p), float(r)
    p = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1e-300), 0.0)
    r = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1e-300), 0.0)
    return float(p.mean()), float(r.mean())


def coco_metrics(all_targets: np.ndarray, all_predictions: np.ndarray,
                 threshold: float = 0.5) -> dict:
    """The exact metric dict of COCO.evaluate (coco.py:126-176 + x100 scale
    at coco.py:326)."""
    mean_ap, _ = mAP_coco(all_targets, all_predictions)

    top_3rd = np.sort(all_predictions, axis=1)[:, -3].reshape(-1, 1)
    top3 = all_predictions.copy()
    top3[top3 < top_3rd] = 0
    top3 = (top3 >= threshold).astype(np.float64)
    cp3, cr3 = _precision_recall(all_targets, top3, "macro")
    op3, or3 = _precision_recall(all_targets, top3, "micro")

    binary = (all_predictions >= threshold).astype(np.float64)
    cp, cr = _precision_recall(all_targets, binary, "macro")
    op, orr = _precision_recall(all_targets, binary, "micro")

    def f1(p, r):
        return (2 * p * r) / (p + r) if (p + r) > 0 else 0.0

    out = {
        "mAP": mean_ap,
        "CP": cp, "CR": cr, "CF1": f1(cp, cr),
        "OP": op, "OR": orr, "OF1": f1(op, orr),
        "CP_top3": cp3, "CR_top3": cr3, "CF1_top3": f1(cp3, cr3),
        "OP_top3": op3, "OR_top3": or3, "OF1_top3": f1(op3, or3),
    }
    return {k: round(v * 100, 4) for k, v in out.items()}


def mAP_area(target: np.ndarray, pred: np.ndarray, area: np.ndarray) -> list[float]:
    """Size-stratified s/m/l mAP (coco.py:67-124); ``area`` is the per-image,
    per-class object area (0 where absent)."""
    records = []
    for thr_name in ["s", "m", "l"]:
        aps = []
        for k in range(pred.shape[1]):
            order = np.argsort(-pred[:, k], kind="stable")
            t = target[order, k]
            a = area[order, k]
            if thr_name == "s":
                pn_inds = a < 32 * 32
            elif thr_name == "m":
                pn_inds = ((a < 96 * 96) & (a >= 32 * 32)) | (a == 0)
            else:
                pn_inds = (a >= 96 * 96) | (a == 0)
            pn = np.cumsum(pn_inds).astype(np.float64)
            pos = (t == 1) & pn_inds
            tp = np.cumsum(pos).astype(np.float64)
            total_pos = tp[-1] if len(tp) else 0.0
            tp[~pos] = 0
            precision = tp / np.maximum(pn, EPS)
            aps.append(np.sum(precision) / np.maximum(total_pos, EPS))
        records.append(float(np.mean(aps)))
    return records


# ---------------------------------------------------------------- single-label

def accuracy(pred: np.ndarray, target: np.ndarray, topk=(1,)) -> list[float]:
    """Top-k accuracy, percent."""
    maxk = max(topk)
    order = np.argsort(-pred, axis=1)[:, :maxk]
    correct = order == target.reshape(-1, 1)
    return [float(correct[:, :k].any(axis=1).mean() * 100.0) for k in topk]


def confusion_matrix(pred_label: np.ndarray, target: np.ndarray,
                     num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (target.astype(np.int64), pred_label.astype(np.int64)), 1)
    return cm


def precision_recall_f1(pred: np.ndarray, target: np.ndarray,
                        average_mode: str = "macro", thrs: float = 0.0):
    """Single-label PRF from argmax predictions."""
    num_classes = pred.shape[1]
    pred_label = np.argmax(pred, axis=1)
    cm = confusion_matrix(pred_label, target, num_classes)
    tp = np.diag(cm).astype(np.float64)
    p_den = cm.sum(axis=0).astype(np.float64)
    r_den = cm.sum(axis=1).astype(np.float64)
    precision = tp / np.maximum(p_den, EPS) * 100.0
    recall = tp / np.maximum(r_den, EPS) * 100.0
    f1 = 2 * precision * recall / np.maximum(precision + recall, EPS)
    if average_mode == "macro":
        return float(precision.mean()), float(recall.mean()), float(f1.mean())
    return precision, recall, f1


def support(target: np.ndarray, num_classes: int) -> np.ndarray:
    return np.bincount(target.astype(np.int64), minlength=num_classes)
