"""Graph autoencoders and a contrastive model: GAE, VGAE, DGI.

Counterpart of euler_tpu/models/autoencoders.py (reference:
tf_euler/python/mp_utils/base_gae.py:23 with examples/gae/gae.py, and
examples/dgi/dgi.py). Each draw is split from its select, as elsewhere in
the port: a call takes ``generator`` or ``uniforms``, a list of the
model's draws in a fixed order (each class names it). The embedder is a
GNN net called three times (roots, positives, negatives) or twice (DGI);
each of its calls takes its own per-hop uniforms in that list (None for
one that draws nothing).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.models.convs import dense
from euler_tpu_torch.models.gnn import _sigmoid_xent
from euler_tpu_torch.ops import sampling


def draw_normals(generator: Optional[torch.Generator], shape,
                 device) -> torch.Tensor:
    """Standard normals of ``shape``: VGAE's eps."""
    return torch.randn(shape, generator=generator, device=device)


class GAE(nn.Module):
    """Inner-product edge decoder over the embedder's embeddings: each root
    against one neighbor drawn over ``edge_types`` (the general weighted
    draw, ``select_sampled_neighbors``) and ``num_negs`` nodes of
    ``node_type`` (reference: autoencoders.py:24-60).

    ``uniforms``: [the positive draw (``draw_sample_uniforms`` of B
    nodes, over a ShardView of ``sampling.neighbor_rows(g, B)``, 1
    draw), the negative draw (``draw_node_uniforms`` of
    B * num_negs), then the per-hop uniforms of the three embedder calls
    (roots, positives, negatives)]."""

    def __init__(self, embedder: nn.Module, edge_types, node_type=-1,
                 num_negs: int = 5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedder, self.edge_types = embedder, edge_types
        self.node_type, self.num_negs = node_type, num_negs
        self._build(generator)
        self.to(resolve_device(device))

    def _build(self, generator: Optional[torch.Generator]) -> None:
        """Parameters of the head beside the embedder's (none here)."""

    def _encode(self, g, ids, generator, tower, eps):
        """(z, mu, log_var) of ``ids``: here the embedding, and no
        distribution."""
        emb = self.embedder(g, ids, generator=generator, uniforms=tower)
        return emb, emb, None

    def _extra_loss(self, mu, log_var):
        return 0.0

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
                                                    g))
        u_pos, u_neg, *rest = uniforms
        towers = (list(rest[:3]) + [None] * 3)[:3]
        eps = rest[3:] or [None] * 3
        pos = sampling.select_sampled_neighbors(g, roots, self.edge_types,
                                                *u_pos)[0][:, 0]
        negs = sampling.select_nodes(g, self.node_type, *u_neg)
        z, mu, lv = self._encode(g, roots, generator, towers[0], eps[0])
        z_pos = self._encode(g, pos, generator, towers[1], eps[1])[0]
        z_negs = self._encode(g, negs, generator, towers[2], eps[2])[0]
        z_negs = z_negs.reshape(B, self.num_negs, -1)
        logits = (z * z_pos).sum(-1, keepdim=True)
        neg_logits = torch.einsum("bd,bnd->bn", z, z_negs)
        ok = ((roots >= 0) & (pos >= 0)).to(torch.float32)[:, None]
        pos_x = (_sigmoid_xent(logits, torch.ones_like(logits)) * ok).sum()
        neg_x = (_sigmoid_xent(neg_logits, torch.zeros_like(neg_logits))
                 * ok).sum()
        recon = (pos_x + neg_x) / (ok.sum() * (1 + self.num_negs)).clamp_min(
            1.0)
        return dict(loss=recon + self._extra_loss(mu, lv), embedding=mu,
                    logits=logits, neg_logits=neg_logits, pos_mask=ok)


class VGAE(GAE):
    """Variational GAE (reference: autoencoders.py:63-109): mu from the
    embedder, log_var from ``log_var_fc`` (a Dense with a bias over mu,
    shared by the three calls), z = mu + exp(log_var / 2) * eps decoded as
    in GAE, plus the KL term of the roots' mu and log_var. ``embedding``
    is mu.

    ``uniforms``: GAE's five entries, then the three calls' normals eps
    ([B, D], [B, D], [B * num_negs, D])."""

    def _build(self, generator: Optional[torch.Generator]) -> None:
        d = self.embedder.dims[-1]
        self.log_var_fc = dense(d, d, generator=generator)

    def _encode(self, g, ids, generator, tower, eps):
        mu = self.embedder(g, ids, generator=generator, uniforms=tower)
        lv = self.log_var_fc(mu)
        if eps is None:
            eps = draw_normals(generator, mu.shape, mu.device)
        return mu + torch.exp(0.5 * lv) * eps, mu, lv

    def _extra_loss(self, mu, log_var):
        return (-0.5 * (log_var - torch.exp(log_var) - mu ** 2 + 1)).mean()


class DGI(nn.Module):
    """Deep Graph Infomax (reference: autoencoders.py:112-135): the roots'
    embeddings against ``num_negs`` corrupting nodes' a root, both scored
    by the bilinear ``disc`` (bias-free) against the sigmoid of the
    roots' mean embedding.

    ``uniforms``: [the corrupting draw (``draw_node_uniforms`` of
    B * num_negs), the roots' embedder uniforms, the corrupting nodes']."""

    def __init__(self, embedder: nn.Module, node_type=-1, num_negs: int = 5,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedder, self.node_type, self.num_negs = (embedder, node_type,
                                                        num_negs)
        d = embedder.dims[-1]
        self.disc = dense(d, d, bias=False, generator=generator)
        self.to(resolve_device(device))

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None):
        roots = roots.to(torch.int32)
        B = roots.shape[0]
        if uniforms is None:
            uniforms = (sampling.draw_node_uniforms(
                generator, B * self.num_negs, roots.device, g), None, None)
        u_neg, t_roots, t_neg = uniforms
        corrupt = sampling.select_nodes(g, self.node_type, *u_neg)
        emb = self.embedder(g, roots, generator=generator, uniforms=t_roots)
        emb_neg = self.embedder(g, corrupt, generator=generator,
                                uniforms=t_neg).reshape(B, self.num_negs, -1)
        summary = torch.sigmoid(emb.mean(dim=0, keepdim=True))
        logits = (self.disc(emb) * summary).sum(-1, keepdim=True)
        neg_logits = torch.einsum("bnd,d->bn", self.disc(emb_neg),
                                  summary[0])
        loss = (_sigmoid_xent(logits, torch.ones_like(logits)).mean()
                + _sigmoid_xent(neg_logits,
                                torch.zeros_like(neg_logits)).mean()) / 2
        return dict(loss=loss, embedding=emb, logits=logits,
                    neg_logits=neg_logits)
