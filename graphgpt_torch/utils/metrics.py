"""Host-side metrics (numpy) and their registry: a copy of
`graphgpt_tpu/utils/metrics.py` (binary AUROC, accuracy, per-task
multi-label AUROC with NaN masking, MAE/MSE, and `compare_metrics_res` for
EMA-best selection).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .registry import Register

_metrics = Register()
get_metric_fns = _metrics.get


def binary_auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUROC (Mann-Whitney U), ties averaged."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    pos = labels > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, np.float64)
    sorted_scores = scores[order]
    # average ranks over ties
    i = 0
    r = np.arange(1, len(scores) + 1, dtype=np.float64)
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = r[i : j + 1].mean()
        i = j + 1
    auc = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    return float(auc)


def accuracy(preds: np.ndarray, labels: np.ndarray) -> float:
    preds = np.asarray(preds).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    valid = labels != -100
    if valid.sum() == 0:
        return float("nan")
    return float((preds[valid] == labels[valid]).mean())


def mae(preds, labels) -> float:
    return float(np.abs(np.asarray(preds, np.float64) - np.asarray(labels, np.float64)).mean())


def mse(preds, labels) -> float:
    d = np.asarray(preds, np.float64) - np.asarray(labels, np.float64)
    return float((d * d).mean())


def multilabel_auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Mean per-task AUROC over tasks with both classes present, skipping
    NaN labels (OGB molpcba convention; metrics_utils.py multi-label)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    aucs: List[float] = []
    for t in range(labels.shape[1]):
        valid = ~np.isnan(labels[:, t])
        if valid.sum() == 0:
            continue
        y = labels[valid, t]
        if y.min() == y.max():
            continue
        aucs.append(binary_auroc(scores[valid, t], y))
    return float(np.mean(aucs)) if aucs else float("nan")


@_metrics("single_label_classification")
def _single_label(scores, labels) -> Dict[str, float]:
    preds = np.asarray(scores).argmax(-1)
    out = {"acc": accuracy(preds, labels)}
    if np.asarray(scores).shape[-1] == 2:
        probs = _softmax(np.asarray(scores, np.float64))[:, 1]
        out["auroc"] = binary_auroc(probs, labels)
    return out


@_metrics("multi_label_classification")
def _multi_label(scores, labels) -> Dict[str, float]:
    return {"auroc": multilabel_auroc(scores, labels)}


@_metrics("regression")
def _regression(scores, labels) -> Dict[str, float]:
    return {"mae": mae(scores, labels), "mse": mse(scores, labels)}


@_metrics("graph_clustering")
def _graph_clustering(scores, labels) -> Dict[str, float]:
    """Token-level clustering metrics for OneID-style tasks: accuracy plus
    per-graph mean recall/precision over predicted groups
    (reference metrics_utils.py graph_clustering registry entry)."""
    preds = np.asarray(scores).argmax(-1).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    valid = labels != -100
    preds, labels = preds[valid], labels[valid]
    if len(labels) == 0:
        return {"acc": float("nan")}
    acc = float((preds == labels).mean())
    recalls, precisions = [], []
    for c in np.unique(labels):
        tp = float(((preds == c) & (labels == c)).sum())
        recalls.append(tp / max((labels == c).sum(), 1))
        if (preds == c).sum() > 0:
            precisions.append(tp / (preds == c).sum())
    return {
        "acc": acc,
        "recall": float(np.mean(recalls)),
        "precision": float(np.mean(precisions)) if precisions else float("nan"),
    }


def _softmax(x):
    x = x - x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)


def compute_metrics(problem_type: str, scores, labels) -> Dict[str, float]:
    return _metrics.build(problem_type, scores, labels)


# larger-is-better flags per metric (reference compare_metrics_res,
# metrics_utils.py:192-208)
_HIGHER_BETTER = {
    "acc": True,
    "auroc": True,
    "ap": True,
    "mae": False,
    "mse": False,
    "loss": False,
    "hits": True,
    "mrr": True,
}


def is_better(new: Dict[str, float], best: Dict[str, float], key: str) -> bool:
    if key not in best:
        return True
    # keys arrive prefixed (valid_mae, valid_ema_hits@100): resolve the
    # metric FAMILY (last _-component before any @K) — the bare-key lookup
    # silently treated valid_mae as higher-is-better and pinned "best" to
    # the first epoch (caught by the round-4 convergence artifact)
    fam = key.split("@")[0].split("_")[-1]
    hb = _HIGHER_BETTER.get(fam, True)
    return (new[key] > best[key]) if hb else (new[key] < best[key])


# priority order for picking the task's primary metric when an eval dict
# carries several (e.g. hits@20/50/100): the reference asserts exactly one
# 'ema' key (metrics_utils.py:192-208); our _epoch_eval prefixes every
# metric with ema_, so the primary must be chosen explicitly, never
# alphabetically.
_PRIMARY_PRIORITY = ("mrr", "hits", "ap", "auroc", "acc", "mae", "mse", "loss")


def primary_metric_key(keys) -> str:
    """Deterministic primary-metric choice: highest-priority metric family;
    within a hits@K family, the largest K (the OGB headline metric)."""
    keys = list(keys)
    for fam in _PRIMARY_PRIORITY:
        fam_keys = [k for k in keys if fam in k.lower()]
        if fam_keys:
            if fam == "hits":

                def _k(key):
                    tail = key.lower().split("hits@")[-1]
                    digits = "".join(c for c in tail if c.isdigit())
                    return int(digits) if digits else 0

                return max(fam_keys, key=_k)
            return sorted(fam_keys)[0]
    return sorted(keys)[0]


def compare_metrics_res(curr: Dict[str, float], prev_best: Dict[str, float]):
    """EMA-best comparison with the reference's key-selection rule
    (metrics_utils.py:192-208): a single-key dict compares on that key;
    otherwise the task's primary metric among the 'ema' keys is used
    (the reference asserts exactly one — see primary_metric_key). Direction
    is lower-better when the key mentions mae/loss/mse, else higher-better.
    Returns (improved_flag, best_res)."""
    if not curr:
        return False, prev_best
    if len(curr) == 1:
        key = next(iter(curr))
    else:
        ema_keys = [k for k in curr if "ema" in k.lower()]
        key = primary_metric_key(ema_keys if ema_keys else curr)
    if not prev_best or key not in prev_best:
        return True, dict(curr)
    lower_better = any(tok in key.lower() for tok in ("mae", "loss", "mse"))
    improved = curr[key] < prev_best[key] if lower_better else curr[key] > prev_best[key]
    return (True, dict(curr)) if improved else (False, prev_best)
