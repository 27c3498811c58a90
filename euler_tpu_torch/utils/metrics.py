"""Evaluation metrics: the supervised head's and the ranking heads'.

Copies of euler_tpu/utils/metrics.py (reference: tf_euler/python/utils/
metrics.py:23-98) in torch: ``accuracy`` and ``f1_score`` of labels and
predictions, and ``auc``, ``mrr``, ``mean_rank`` and ``hit_at_k`` of a
positive's logits [B, 1] against its negatives' [B, N]. Each returns a
0-d f32 tensor.
"""
from __future__ import annotations

import functools

import torch


def accuracy(labels, predictions, mask=None):
    """Argmax accuracy for one-hot/soft labels."""
    hit = (labels.argmax(-1) == predictions.argmax(-1)).to(torch.float32)
    if mask is not None:
        m = mask.reshape(hit.shape).to(torch.float32)
        return (hit * m).sum() / m.sum().clamp_min(1.0)
    return hit.mean()


def f1_score(labels, predictions, threshold=0.5, mask=None):
    """Micro-averaged multilabel F1 (reference f1: sigmoid outputs)."""
    pred = (predictions > threshold).to(torch.float32)
    lab = (labels > threshold).to(torch.float32)
    if mask is not None:
        m = mask.to(torch.float32)
        if m.dim() < pred.dim():
            m = m[..., None]
        pred, lab = pred * m, lab * m
    tp = (pred * lab).sum()
    fp = (pred * (1 - lab)).sum()
    fn = ((1 - pred) * lab).sum()
    return 2 * tp / (2 * tp + fp + fn).clamp_min(1e-7)


def auc(labels, scores):
    """Rank-based AUC (Mann-Whitney U) for binary labels. Ties keep index
    order, as the reference's stable ``jnp.argsort``."""
    labels = labels.reshape(-1)
    scores = scores.reshape(-1)
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(1, order.shape[0] + 1, device=order.device)
    pos = labels > 0.5
    n_pos = pos.sum()
    n_neg = labels.shape[0] - n_pos
    sum_pos_ranks = torch.where(pos, ranks, 0).sum()
    u = sum_pos_ranks - n_pos * (n_pos + 1) / 2.0
    return u / (n_pos * n_neg).clamp_min(1).to(torch.float32)


def _ranks(pos_logits, neg_logits):
    """rank of each positive among its negatives (1-based)."""
    return 1 + (neg_logits >= pos_logits).sum(-1)


def _masked_mean(x, mask):
    if mask is None:
        return x.mean()
    m = mask.reshape(x.shape).to(torch.float32)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def mrr(pos_logits, neg_logits, mask=None):
    """reference mrr (metrics.py): mean reciprocal rank of the positive."""
    return _masked_mean(
        1.0 / _ranks(pos_logits, neg_logits).to(torch.float32), mask)


def mean_rank(pos_logits, neg_logits, mask=None):
    return _masked_mean(_ranks(pos_logits, neg_logits).to(torch.float32),
                        mask)


def hit_at_k(pos_logits, neg_logits, k, mask=None):
    return _masked_mean(
        (_ranks(pos_logits, neg_logits) <= k).to(torch.float32), mask)


_METRICS = {
    "acc": accuracy,
    "accuracy": accuracy,
    "f1": f1_score,
    "auc": auc,
    "mrr": mrr,
    "mr": mean_rank,
    "hit1": functools.partial(hit_at_k, k=1),
    "hit3": functools.partial(hit_at_k, k=3),
    "hit10": functools.partial(hit_at_k, k=10),
}


def get(name: str):
    """reference: tf_euler.utils.metrics.get."""
    try:
        return _METRICS[name]
    except KeyError:
        raise NotImplementedError(
            f"metric {name!r} is not ported; known: {sorted(_METRICS)}"
        ) from None
