"""Neighborhood aggregators over a padded neighbor stack.

Counterpart of euler_tpu/models/aggregators.py (reference:
tf_euler/python/utils/aggregators.py:25-118). Inputs are (self [B, D],
neighbors [B, n, D], mask [B, n] or None). The masked mean divides by the
valid count clamped at 1.0 (``max(count, 1.0)``), not by the block's
1e-7; the masked max gives 0 in a row with no valid neighbor.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from euler_tpu_torch.models.convs import dense


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return x.mean(dim=1)
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


def _masked_max(x: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return x.amax(dim=1)
    mask = mask.bool()
    out = torch.where(mask[..., None], x, torch.finfo(x.dtype).min).amax(1)
    return torch.where(mask.any(dim=1, keepdim=True), out, 0.0)


class GCNAggregator(nn.Module):
    """mean(self ++ neighbors) -> a bias-free Dense, then ``activation``
    (aggregators.py:37-53; flax's ``Dense_0`` is ``fc``)."""

    def __init__(self, in_dim: int, dim: int,
                 activation: Callable = torch.relu,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.fc = dense(in_dim, dim, bias=False, generator=generator)

    def forward(self, self_emb, neigh_emb, mask=None):
        both = torch.cat([self_emb[:, None, :], neigh_emb], dim=1)
        if mask is not None:
            mask = torch.cat([mask.new_ones((mask.shape[0], 1)), mask], 1)
        return self.activation(self.fc(_masked_mean(both, mask)))


class _BaseAggregator(nn.Module):
    """``act(self_fc(self)) + act(neigh_fc(aggregate(neighbors)))``, or the
    two concatenated with ``concat`` (each then ``dim // 2`` wide;
    aggregators.py:56-81). ``neigh_in`` is the width ``aggregate``
    returns."""

    def __init__(self, in_dim: int, dim: int, neigh_in: int,
                 activation: Callable = torch.relu, concat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if concat and dim % 2:
            raise ValueError("dim must be even when concat=True")
        self.activation, self.concat = activation, concat
        half = dim // 2 if concat else dim
        self.self_fc = dense(in_dim, half, bias=False, generator=generator)
        self.neigh_fc = dense(neigh_in, half, bias=False,
                              generator=generator)

    def aggregate(self, neigh_emb, mask):
        raise NotImplementedError

    def forward(self, self_emb, neigh_emb, mask=None):
        agg = self.aggregate(neigh_emb, mask)
        a = self.activation(self.self_fc(self_emb))
        b = self.activation(self.neigh_fc(agg))
        return torch.cat([a, b], dim=-1) if self.concat else a + b


class MeanAggregator(_BaseAggregator):
    """The masked mean of the neighbors (aggregators.py:84-86)."""

    def __init__(self, in_dim: int, dim: int, **kw):
        super().__init__(in_dim, dim, in_dim, **kw)

    def aggregate(self, neigh_emb, mask):
        return _masked_mean(neigh_emb, mask)


class MeanPoolAggregator(_BaseAggregator):
    """relu(pool_fc(neighbors)), ``dim`` wide with a bias, then the masked
    mean (aggregators.py:89-95)."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None, **kw):
        super().__init__(in_dim, dim, dim, generator=generator, **kw)
        self.pool_fc = dense(in_dim, dim, generator=generator)

    def aggregate(self, neigh_emb, mask):
        return _masked_mean(torch.relu(self.pool_fc(neigh_emb)), mask)


class MaxPoolAggregator(MeanPoolAggregator):
    """relu(pool_fc(neighbors)), then the masked max
    (aggregators.py:98-102)."""

    def aggregate(self, neigh_emb, mask):
        return _masked_max(torch.relu(self.pool_fc(neigh_emb)), mask)


_AGGREGATORS = {
    "gcn": GCNAggregator,
    "mean": MeanAggregator,
    "meanpool": MeanPoolAggregator,
    "maxpool": MaxPoolAggregator,
}


def get(name: str):
    """reference: aggregators.py get()."""
    return _AGGREGATORS[name]
