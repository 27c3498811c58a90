"""Solution kit: losses, logits heads, samplers, and the two models the
reference's solution examples build from them.

Counterpart of euler_tpu/models/solution.py (reference:
tf_euler/python/solution/ — losses.py, logits.py, samplers.py,
base_supervise.py:25-49, base_unsupervise.py). The samplers are split as
every draw of the port is: ``select_pos_with_types`` and
``select_neg_with_types`` take the uniforms that ``draw_sample_uniforms``
(over a ShardView, of the owner's rows: ``sampling.neighbor_rows``) and
``draw_node_uniforms`` give. ``SolutionModel`` and
``SampleSolutionModel`` are the models of examples/solution and
examples/sample_solution (defined there inside ``main``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.models.convs import dense
from euler_tpu_torch.models.gnn import _sigmoid_xent
from euler_tpu_torch.ops import feature_ops, sampling


# ---- losses (solution/losses.py) ------------------------------------------

def sigmoid_loss(logits, labels, mask=None):
    """Mean sigmoid cross-entropy; with ``mask`` [B, 1] over the masked
    rows' entries (at least 1)."""
    x = _sigmoid_xent(logits, labels)
    if mask is not None:
        m = mask.to(x.dtype)
        return (x * m).sum() / (m.sum() * x.shape[-1]).clamp_min(1.0)
    return x.mean()


def xent_loss(logits, neg_logits, pos_mask=None):
    """The positives' cross-entropy against 1 and the negatives' against
    0, over their count (the masked positives' with ``pos_mask``)."""
    t = _sigmoid_xent(logits, torch.ones_like(logits))
    n = _sigmoid_xent(neg_logits, torch.zeros_like(neg_logits))
    if pos_mask is not None:
        m = pos_mask.to(t.dtype)
        return ((t * m).sum() + n.sum()) / (m.sum() + n.numel()).clamp_min(
            1.0)
    return (t.sum() + n.sum()) / (t.numel() + n.numel())


# ---- logits heads (solution/logits.py) -------------------------------------

class DenseLogits(nn.Module):
    """A bias-free Dense to ``logits_dim`` (flax's ``Dense_0``)."""

    def __init__(self, in_dim: int, logits_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc = dense(in_dim, logits_dim, bias=False, generator=generator)

    def forward(self, emb):
        return self.fc(emb)


class PosNegLogits(nn.Module):
    """(emb . pos [B, 1], emb . each negative [B, N])."""

    def forward(self, emb, pos_emb, neg_emb):
        return ((emb * pos_emb).sum(-1, keepdim=True),
                torch.einsum("bd,bnd->bn", emb, neg_emb))


class CosineLogits(nn.Module):
    """Cosine similarity [B, 1], each norm clamped at 1e-12."""

    def forward(self, a, b):
        na = a / torch.linalg.norm(a, dim=-1, keepdim=True).clamp_min(1e-12)
        nb = b / torch.linalg.norm(b, dim=-1, keepdim=True).clamp_min(1e-12)
        return (na * nb).sum(-1, keepdim=True)


# ---- samplers (solution/samplers.py) ---------------------------------------

def select_pos_with_types(g: GraphTensors, roots, edge_types, uniforms):
    """(positives int32 [B, count], their validity) from the uniforms of
    ``sampling.draw_sample_uniforms(generator, B, count, device)`` (over a
    ShardView, of ``sampling.neighbor_rows(g, B)`` rows)."""
    pos = sampling.select_sampled_neighbors(g, roots, edge_types,
                                            *uniforms)[0]
    return pos, pos >= 0


def sample_pos_with_types(g: GraphTensors, roots, edge_types,
                          count: int = 1,
                          generator: Optional[torch.Generator] = None):
    return select_pos_with_types(g, roots, edge_types,
                                 sampling.draw_sample_uniforms(
                                     generator, sampling.neighbor_rows(
                                         g, roots.shape[0]), count,
                                     roots.device))


def select_neg_with_types(g: GraphTensors, roots, node_type, num_negs: int,
                          uniforms):
    """Negatives int32 [B, num_negs] from the uniforms of
    ``sampling.draw_node_uniforms(generator, B * num_negs, device)``."""
    return sampling.select_nodes(g, node_type, *uniforms).reshape(
        roots.shape[0], num_negs)


def sample_neg_with_types(g: GraphTensors, roots, node_type, num_negs: int,
                          generator: Optional[torch.Generator] = None):
    return select_neg_with_types(g, roots, node_type, num_negs,
                                 sampling.draw_node_uniforms(
                                     generator, roots.shape[0] * num_negs,
                                     roots.device, g))


# ---- the examples' models --------------------------------------------------

class SolutionModel(nn.Module):
    """embedder + ``DenseLogits`` + ``sigmoid_loss`` over the roots'
    ``label_name`` dense feature (examples/solution/run_solution.py;
    flax's ``DenseLogits_0``)."""

    def __init__(self, embedder: nn.Module, label_name: str, label_dim: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedder, self.label_name = embedder, label_name
        self.label_dim = label_dim
        self.logits = DenseLogits(embedder.dims[-1], label_dim, generator)
        self.to(resolve_device(device))

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None):
        emb = self.embedder(g, roots, generator=generator, uniforms=uniforms)
        logit = self.logits(emb)
        (label,) = feature_ops.get_dense_feature(g, roots, [self.label_name])
        label = label[:, : self.label_dim]
        loss = sigmoid_loss(logit, label, (roots >= 0)[:, None])
        return dict(embedding=emb, logit=logit, label=label, loss=loss)


class SampleSolutionModel(nn.Module):
    """Two towers as one ``GroupGNNNet`` (the roots; then the positives and
    the negatives in one call), ``PosNegLogits`` and ``xent_loss``
    (examples/sample_solution/run_sample_solution.py; flax's ``group``).

    ``uniforms``: [the positive draw (``draw_sample_uniforms`` of B, 1),
    the negative draw (``draw_node_uniforms`` of B * num_negs), the group
    net's list (one entry per tower)]."""

    def __init__(self, group: nn.Module, edge_types, node_type=-1,
                 num_negs: int = 5, device=None):
        super().__init__()
        self.group, self.edge_types = group, edge_types
        self.node_type, self.num_negs = node_type, num_negs
        self.head = PosNegLogits()
        self.to(resolve_device(device))

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None):
        roots = roots.to(torch.int32)
        B, dev = roots.shape[0], roots.device
        if uniforms is None:
            uniforms = (sampling.draw_sample_uniforms(
                            generator, sampling.neighbor_rows(g, B), 1, dev),
                        sampling.draw_node_uniforms(generator,
                                                    B * self.num_negs, dev,
                                                    g),
                        None)
        u_pos, u_neg, towers = uniforms
        pos, pos_ok = select_pos_with_types(g, roots, self.edge_types, u_pos)
        negs = select_neg_with_types(g, roots, self.node_type,
                                     self.num_negs, u_neg)
        ctx_ids = torch.cat([pos[:, 0], negs.reshape(-1)])
        emb, ctx = self.group(g, [roots, ctx_ids], generator=generator,
                              uniforms=towers)
        logits, neg_logits = self.head(
            emb, ctx[:B], ctx[B:].reshape(B, self.num_negs, -1))
        loss = xent_loss(logits, neg_logits, pos_ok[:, :1])
        return dict(embedding=emb, logits=logits, neg_logits=neg_logits,
                    loss=loss)
