"""Evaluation metrics of the supervised head.

Copies of euler_tpu/utils/metrics.py ``accuracy`` and ``f1_score``
(reference: tf_euler/python/utils/metrics.py:23-98) in torch. Each
returns a 0-d f32 tensor. The ranking metrics come with the models that
report them.
"""
from __future__ import annotations

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


_METRICS = {
    "acc": accuracy,
    "accuracy": accuracy,
    "f1": f1_score,
}


def get(name: str):
    """reference: tf_euler.utils.metrics.get (the supervised metrics)."""
    try:
        return _METRICS[name]
    except KeyError:
        raise NotImplementedError(
            f"metric {name!r} is not ported; known: {sorted(_METRICS)}"
        ) from None
