"""OGB evaluator semantics in numpy, to the published formulas (Hits@K,
MRR, MAE, AUROC, AP): a copy of `graphgpt_tpu/utils/ogb_eval.py`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .registry import Register

_ogb = Register()
evaluate_ogb = _ogb.build


def hits_at_k(y_pred_pos: np.ndarray, y_pred_neg: np.ndarray, k: int) -> float:
    """ogb.linkproppred Hits@K: fraction of positives scoring above the
    k-th highest *global* negative."""
    y_pred_pos = np.asarray(y_pred_pos, np.float64).reshape(-1)
    y_pred_neg = np.asarray(y_pred_neg, np.float64).reshape(-1)
    if len(y_pred_neg) < k:
        return 1.0
    kth_neg = np.sort(y_pred_neg)[-k]
    return float((y_pred_pos > kth_neg).mean())


def mrr(y_pred_pos: np.ndarray, y_pred_neg: np.ndarray) -> float:
    """ogb.linkproppred MRR: each positive ranked against its own row of
    negatives; rank = 1 + #{neg >= pos} (pessimistic, OGB formula)."""
    y_pred_pos = np.asarray(y_pred_pos, np.float64).reshape(-1, 1)
    y_pred_neg = np.asarray(y_pred_neg, np.float64)
    assert y_pred_neg.ndim == 2 and y_pred_neg.shape[0] == y_pred_pos.shape[0]
    optimistic = (y_pred_neg > y_pred_pos).sum(axis=1) + 1
    pessimistic = (y_pred_neg >= y_pred_pos).sum(axis=1) + 1
    ranking = 0.5 * (optimistic + pessimistic)
    return float((1.0 / ranking).mean())


@_ogb("ogbl-ppa")
def _eval_ppa(input_dict: Dict) -> Dict[str, float]:
    return {
        "hits@100": hits_at_k(input_dict["y_pred_pos"], input_dict["y_pred_neg"], 100)
    }


@_ogb("ogbl-ddi")
def _eval_ddi(input_dict: Dict) -> Dict[str, float]:
    return {
        "hits@20": hits_at_k(input_dict["y_pred_pos"], input_dict["y_pred_neg"], 20)
    }


@_ogb("ogbl-collab")
def _eval_collab(input_dict: Dict) -> Dict[str, float]:
    return {
        "hits@50": hits_at_k(input_dict["y_pred_pos"], input_dict["y_pred_neg"], 50)
    }


@_ogb("ogbl-citation2")
def _eval_citation2(input_dict: Dict) -> Dict[str, float]:
    return {"mrr": mrr(input_dict["y_pred_pos"], input_dict["y_pred_neg"])}


@_ogb("ogbl-wikikg2")
def _eval_wikikg2(input_dict: Dict) -> Dict[str, float]:
    """Head and tail negative batches are evaluated together (reference
    ogb_utils.py:105-128 merges them before the official evaluator)."""
    return {"mrr": mrr(input_dict["y_pred_pos"], input_dict["y_pred_neg"])}


@_ogb("pcqm4m-v2")
def _eval_pcqm4mv2(input_dict: Dict) -> Dict[str, float]:
    pred = np.asarray(input_dict["y_pred"], np.float64).reshape(-1)
    true = np.asarray(input_dict["y_true"], np.float64).reshape(-1)
    return {"mae": float(np.abs(pred - true).mean())}


@_ogb("ogbg-molhiv")
def _eval_molhiv(input_dict: Dict) -> Dict[str, float]:
    from .metrics import binary_auroc

    return {
        "auroc": binary_auroc(input_dict["y_pred"], input_dict["y_true"])
    }


@_ogb("ogbg-molpcba")
def _eval_molpcba(input_dict: Dict) -> Dict[str, float]:
    """Mean Average Precision over tasks with both classes, NaN-masked."""
    scores = np.asarray(input_dict["y_pred"], np.float64)
    labels = np.asarray(input_dict["y_true"], np.float64)
    aps = []
    for t in range(labels.shape[1]):
        valid = ~np.isnan(labels[:, t])
        y = labels[valid, t]
        if valid.sum() == 0 or y.min() == y.max():
            continue
        aps.append(_average_precision(scores[valid, t], y))
    return {"ap": float(np.mean(aps)) if aps else float("nan")}


def _average_precision(scores, labels) -> float:
    """sklearn.metrics.average_precision_score semantics (the official
    ogb.graphproppred `_eval_ap` defers to sklearn): thresholds are the
    unique score values descending, AP = sum((R_i - R_{i-1}) * P_i), so
    tied scores share one precision/recall point."""
    scores = np.asarray(scores, np.float64)
    y = np.asarray(labels, np.float64) > 0.5
    order = np.argsort(-scores, kind="mergesort")
    scores, y = scores[order], y[order]
    # indices where the score strictly drops: threshold boundaries
    distinct = np.flatnonzero(np.diff(scores)) if len(scores) > 1 else np.array([], int)
    bounds = np.concatenate([distinct, [len(scores) - 1]])
    tp = np.cumsum(y)[bounds]
    fp = (bounds + 1) - tp
    n_pos = y.sum()
    if n_pos == 0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / n_pos
    d_recall = np.diff(np.concatenate([[0.0], recall]))
    return float((d_recall * precision).sum())


def reformat_hits_inputs(scores: np.ndarray, labels: np.ndarray) -> Dict:
    """Split flat (score, 0/1-label) pairs into pos/neg arrays
    (reference ogb_utils.py:141-152)."""
    scores = np.asarray(scores).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    return {
        "y_pred_pos": scores[labels > 0.5],
        "y_pred_neg": scores[labels <= 0.5],
    }


def reformat_mrr_inputs(scores: np.ndarray, labels: np.ndarray, idx: np.ndarray, num_neg: int = 1000) -> Dict:
    """Group flat scores by source-positive id: each positive with its
    `num_neg` negatives (reference ogb_utils.py:155-170 sorts by idx)."""
    scores = np.asarray(scores).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    idx = np.asarray(idx)
    if idx.ndim > 1:
        idx = idx[:, 0]
    order = np.argsort(idx, kind="mergesort")
    scores, labels = scores[order], labels[order]
    pos = scores[labels > 0.5]
    neg = scores[labels <= 0.5].reshape(len(pos), num_neg)
    return {"y_pred_pos": pos, "y_pred_neg": neg}
