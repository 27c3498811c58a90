"""Graph convolutions over static-shape Blocks.

Counterpart of euler_tpu/models/convs.py. Call convention:
``conv((x_tgt [size0, D], x_src [size1, D]), block) -> [size0, dim]``
(``RelationConv`` also takes ``edge_attr``); on a whole-graph ELL block
``x_src`` may be the compact [N, D] table. Ported: ``GCNConv``,
``SAGEConv``, ``GATConv``, ``GINConv`` and ``RelationConv``, over every
block layout the port builds. Parameters are f32; low-precision
activations are cast up to them where flax's type promotion would (torch
refuses mixed-dtype products), and stay low where the reference keeps
them low.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.dataflow.block import Block


def dense(in_dim: int, out_dim: int, bias: bool = True,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A CPU ``nn.Linear`` initialised as flax's Dense default: a
    truncated-normal lecun kernel and a zero bias. ``generator`` is a CPU
    generator, so a seed gives the same weights whatever device the model
    later moves to."""
    lin = nn.Linear(in_dim, out_dim, bias=bias)
    # flax's variance_scaling(1, "fan_in", "truncated_normal") std
    std = math.sqrt(1.0 / in_dim) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


def _deg_inv_sqrt(block: Block):
    """deg ** -0.5 of targets [size0, 1] and sources [size1, 1] (a degree
    of 0 counts as 1), f32, from the masked edge counts, or from the
    block's ``src_deg`` where its source slots are node copies
    (reference: euler_tpu/models/convs.py:31-42, gcn_conv.py:38-46)."""
    ew = torch.ones((block.edge_index.shape[1], 1), dtype=torch.float32,
                    device=block.mask.device)
    deg_t = block.scatter("add", ew, block.mask)
    if block.src_deg is not None:
        deg_s = block.src_deg[:, None].to(torch.float32)
    else:
        deg_s = block.scatter_src_add(ew, block.mask)
    return tuple(torch.where(d > 0, d, 1.0) ** -0.5 for d in (deg_t, deg_s))


def _edge_scale(ni: torch.Tensor, nj: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[E, 1] multiplier: the sym-norm factors and the edge mask."""
    sc = ni * nj
    return sc if mask is None else sc * mask[:, None]


class GCNConv(nn.Module):
    """reference: gcn_conv.py:26-54 (convs.py:55-68): the sym-normalised
    sum ``sum_j x_j / sqrt(deg_i deg_j)`` over masked edges (self loops
    included where the block has them), then ``fc``, flax's bias-free
    ``Dense_0``. The degree math is f32; the scale is cast to the
    activation type inside ``aggregate_neighbors``."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = dense(in_dim, dim, bias=False, generator=generator)

    def forward(self, x, block: Block) -> torch.Tensor:
        _, x_src = x
        norm_i, norm_j = _deg_inv_sqrt(block)
        scale = _edge_scale(block.gather_tgt(norm_i),
                            block.gather_src(norm_j), block.mask)
        out = block.aggregate_neighbors("add", x_src, scale=scale)
        return self.fc(out.to(self.fc.weight.dtype))


class SAGEConv(nn.Module):
    """reference: sage_conv.py:26-44 (self_fc + neigh_fc, mean aggr).

    ``self_fc`` is flax's ``Dense_0`` (applied to x_tgt) and ``neigh_fc``
    its ``Dense_1`` (applied to the masked neighbor mean)."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.self_fc = dense(in_dim, dim, bias=False, generator=generator)
        self.neigh_fc = dense(in_dim, dim, bias=False, generator=generator)

    def forward(self, x, block: Block) -> torch.Tensor:
        x_tgt, x_src = x
        aggr = block.aggregate_neighbors("mean", x_src, block.mask)
        w = self.self_fc.weight
        # flax promotes low-precision activations to the f32 params
        return self.self_fc(x_tgt.to(w.dtype)) + self.neigh_fc(aggr.to(
            w.dtype))


def _trunc_normal(shape, std: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    return t


class GATConv(nn.Module):
    """reference: gat_conv.py:41-75, in the JAX package's
    project-after-aggregation form (convs.py:83-116).

    ``fc`` is flax's ``Dense_0``, ``a1``/``a2`` its ``Dense_1``/
    ``Dense_2``. The two attention projections compose with ``fc`` into
    one [D_in, 1] vector each, so the source set is never projected:
    scores are ``gather_tgt(x_tgt @ w1) + gather_src(x_src @ w2)``,
    leaky_relu with tf's slope 0.2 (not 0.01), the block softmax, and
    ``fc`` applied to the attention-weighted sum of raw features.
    """

    def __init__(self, in_dim: int, dim: int, improved: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.improved = improved
        self.fc = dense(in_dim, dim, bias=False, generator=generator)
        self.a1 = dense(dim, 1, bias=False, generator=generator)
        self.a2 = dense(dim, 1, bias=False, generator=generator)

    def forward(self, x, block: Block) -> torch.Tensor:
        x_tgt, x_src = x
        f32 = self.fc.weight.dtype
        w1 = self.fc.weight.T @ self.a1.weight.T            # [D_in, 1]
        w2 = self.fc.weight.T @ self.a2.weight.T
        alpha = (block.gather_tgt(x_tgt.to(f32) @ w1)
                 + block.gather_src(x_src.to(f32) @ w2))
        alpha = torch.nn.functional.leaky_relu(alpha, negative_slope=0.2)
        alpha = block.softmax(alpha, block.mask)
        out = self.fc(block.aggregate_neighbors("add", x_src, scale=alpha)
                      .to(f32))
        if self.improved:
            out = self.fc(x_tgt.to(f32)) + out
        return out


class GINConv(nn.Module):
    """reference: gin_conv.py:27-60 (convs.py:119-133):
    ``fc((1 + eps) * x_tgt + sum of neighbors)``; ``eps`` is a trainable
    [1] parameter from ``eps`` when ``train_eps``. ``fc`` is flax's
    ``Dense_0``."""

    def __init__(self, in_dim: int, dim: int, eps: float = 0.0,
                 train_eps: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.eps = nn.Parameter(torch.tensor([eps])) if train_eps else eps
        self.fc = dense(in_dim, dim, bias=False, generator=generator)

    def forward(self, x, block: Block) -> torch.Tensor:
        x_tgt, x_src = x
        aggr = block.aggregate_neighbors("add", x_src, block.mask)
        if isinstance(self.eps, torch.Tensor):
            # an f32 eps promotes a low-precision x_tgt, as in flax
            f32 = self.eps.dtype
            h = (1 + self.eps) * x_tgt.to(f32) + aggr.to(f32)
        else:
            h = (1 + self.eps) * x_tgt + aggr
        return self.fc(h.to(self.fc.weight.dtype))


class RelationConv(nn.Module):
    """reference: relation_conv.py:33-69 (convs.py:337-391): per-relation
    sums of raw source features, then one product with the relation
    matrices. The regular layout sums with one einsum over one-hot
    relations; an irregular block runs one masked scatter per relation.

    ``matrix`` [R, dim, D_in] is flax's ``matrix``, initialised as
    ``variance_scaling(1, "fan_avg", "truncated_normal")`` for that shape
    (fan_in = dim * R, fan_out = D_in * R); ``self_fc`` is ``Dense_0``.
    ``edge_attr`` [E] is clipped to [0, R); a self loop counts under its
    attr (``GNNNet`` feeds relation 0). The sum over valid edges is
    divided by their count (at least 1e-7), then ``self_fc(x_tgt)`` is
    added.
    """

    def __init__(self, in_dim: int, dim: int, num_relations: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        R = num_relations
        fan_avg = (dim * R + in_dim * R) / 2.0
        std = math.sqrt(1.0 / fan_avg) / 0.87962566103423978
        self.num_relations = R
        self.matrix = nn.Parameter(_trunc_normal((R, dim, in_dim), std,
                                                 generator))
        self.self_fc = dense(in_dim, dim, bias=False, generator=generator)

    def forward(self, x, block: Block,
                edge_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_tgt, x_src = x
        R = self.num_relations
        if block._is_compact(x_src):
            x_src = block._expand(x_src)
        dt = x_src.dtype
        if edge_attr is None:
            edge_attr = torch.zeros(block.edge_index.shape[1],
                                    dtype=torch.int64, device=x_src.device)
        attr = edge_attr.long().clamp(0, R - 1)
        m = block.mask.to(dt)
        if block.fanout is None:
            xj = block.gather_src(x_src)
            s = torch.stack([block.scatter("add", xj * (
                (attr == r).to(dt) * m)[:, None]) for r in range(R)], 1)
        else:
            T, C = block.size[0], block.fanout
            at_s, at_l = block._split(attr)
            m_s, m_l = block._split(m)
            oh_s = torch.nn.functional.one_hot(at_s, R).to(dt) \
                * m_s[..., None]
            xj_s = x_src[T:].reshape(T, C, -1)
            s = torch.einsum("tcf,tcr->trf", xj_s, oh_s)        # [T, R, f]
            if block.self_loops:
                oh_l = torch.nn.functional.one_hot(at_l, R).to(dt) \
                    * m_l[..., None]
                s = s + x_src[:T, None, :] * oh_l[..., None]
        f32 = self.matrix.dtype
        tot = torch.einsum("trf,rdf->td", s.to(f32), self.matrix)
        cnt = block.scatter("add", torch.ones((attr.shape[0], 1), dtype=dt,
                                              device=x_src.device),
                            block.mask)                       # valid edges
        aggr = tot / cnt.to(f32).clamp_min(1e-7)
        return self.self_fc(x_tgt.to(f32)) + aggr


_CONVS = {"gcn": GCNConv, "sage": SAGEConv, "graphsage": SAGEConv,
          "gat": GATConv, "gin": GINConv, "relation": RelationConv,
          "rgcn": RelationConv}


def get_conv_class(name: str):
    try:
        return _CONVS[name]
    except KeyError:
        raise NotImplementedError(
            f"conv {name!r} is not ported; known: {sorted(_CONVS)}") from None
