"""Walk and proximity embedding models: DeepWalk, Node2Vec and LINE.

Counterpart of euler_tpu/models/walk_models.py (reference:
examples/deepwalk/deepwalk.py:28-90, random_walk + gen_pair + skip-gram
with negative sampling; examples/line/line.py, first- and second-order
proximity). A step's randomness comes from the ``generator`` or the
replayed ``uniforms`` the caller passes: the walk's per-step draws
(``walk.draw_walk_uniforms``) or LINE's positive draw
(``sampling.draw_sample_uniforms`` of one draw a root), then the
negatives' ``sampling.draw_node_uniforms``; over a ShardView the
neighbor draws' uniforms are of the rows their owner answers
(``sampling.neighbor_rows``). Tables are ``Embed`` (flax's ``nn.Embed``)
of ``n_nodes + 1`` rows named ``target_emb`` and ``context_emb``; ids
clamp at 0 as the reference's do. A batch's ids are walk nodes and
weighted draws over the whole graph, and few repeat, so the tables'
backward sums them in a fixed order (``Embed(fixed_order=True)``): two
runs of a step, eager or replayed, agree bit for bit. With
``shard_embeddings`` both tables are ``layers.ShardedEmbedding``s, split
over the mesh's graph axis once ``parallel.train.init_sharded_params``
lays the model out (walk_models.py:41-48, :101-105).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.models.encoders import Embed
from euler_tpu_torch.models.gnn import _sigmoid_xent
from euler_tpu_torch.models.layers import ShardedEmbedding
from euler_tpu_torch.ops import sampling, walk


class _Table:
    """A walk model's table as a lookup of ids >= 0: an ``Embed``, or a
    ``ShardedEmbedding`` read over ``g``."""

    def __init__(self, module: nn.Module, g):
        self.module, self.g = module, g

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        if isinstance(self.module, ShardedEmbedding):
            return self.module(self.g, ids)
        return self.module(ids)


def _table(n: int, dim: int, sharded: bool,
           generator: Optional[torch.Generator]) -> nn.Module:
    if sharded:
        return ShardedEmbedding(n, dim, device="cpu", generator=generator)
    return Embed(n, dim, generator, fixed_order=True)


def skipgram(s: torch.Tensor, context, src: torch.Tensor,
             ctx: torch.Tensor, negs: torch.Tensor) -> dict:
    """The skip-gram loss of the center rows ``s`` [M, D] (of ids ``src``
    [M]) against contexts ``ctx`` [M] and negatives ``negs`` [M,
    num_negs], looked up in ``context`` (a lookup of ids >= 0):
    sigmoid cross-entropy of each
    positive and negative dot product over the pairs whose center and
    context are >= 0, divided by their count times (1 + num_negs), at
    least 1 (walk_models.py:384-393). Returns loss, logits [M, 1],
    neg_logits [M, num_negs] and pos_mask [M, 1]."""
    c = context(ctx.clamp_min(0))
    n = context(negs.clamp_min(0))
    logits = (s * c).sum(-1, keepdim=True)
    neg_logits = torch.einsum("md,mnd->mn", s, n)
    ok = ((src >= 0) & (ctx >= 0)).to(torch.float32)[:, None]
    loss = ((_sigmoid_xent(logits, torch.ones_like(logits)) * ok).sum()
            + (_sigmoid_xent(neg_logits, torch.zeros_like(neg_logits))
               * ok).sum()) / (ok.sum() * (1 + negs.shape[1])).clamp_min(1.0)
    return dict(loss=loss, logits=logits, neg_logits=neg_logits,
                pos_mask=ok)


class DeepWalk(nn.Module):
    """DeepWalk (reference: walk_models.py:24-84); ``walk_p``/``walk_q``
    other than 1 give Node2Vec on the same path. Each root walks
    ``walk_len`` steps over ``edge_types``; ``gen_pair`` makes the
    (center, context) pairs of windows ``left_win``/``right_win``; each
    pair draws ``num_negs`` negatives of ``node_type``. Node2vec's step is
    the exact one (``walk.select_walk``); ``bias_cap`` and
    ``bias_windows`` size its windows (``walk.check_bias_cap``). The
    embedding is the roots' ``target_emb`` rows. Tables are drawn from
    ``generator`` (a CPU generator), then moved to ``device``."""

    def __init__(self, n_nodes: int, dim: int, edge_types,
                 walk_len: int = 3, left_win: int = 1, right_win: int = 1,
                 num_negs: int = 5, node_type=-1, walk_p: float = 1.0,
                 walk_q: float = 1.0, bias_cap: int = 64,
                 bias_windows: int = 1, shard_embeddings: bool = False,
                 device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_nodes, self.dim = n_nodes, dim
        self.shard_embeddings = shard_embeddings
        self.edge_types = edge_types
        self.walk_len, self.left_win, self.right_win = (walk_len, left_win,
                                                        right_win)
        self.num_negs, self.node_type = num_negs, node_type
        self.walk_p, self.walk_q = walk_p, walk_q
        self.bias_cap, self.bias_windows = bias_cap, bias_windows
        self.target_emb = _table(n_nodes + 1, dim, shard_embeddings,
                                 generator)
        self.context_emb = _table(n_nodes + 1, dim, shard_embeddings,
                                  generator)
        self.to(resolve_device(device))

    def draw_uniforms(self, roots: torch.Tensor,
                      generator: Optional[torch.Generator],
                      g=None) -> list:
        """[the walk's per-step uniforms, the negatives'] of a batch (over
        a ShardView ``g``, the walk's of the owners' rows)."""
        B, dev = roots.shape[0], roots.device
        u_walk = walk.draw_walk_uniforms(
            generator, B, self.walk_len, self.walk_p, self.walk_q,
            bias_cap=self.bias_cap, bias_windows=self.bias_windows,
            device=dev, g=g)
        M = B * walk.pair_count(self.walk_len + 1, self.left_win,
                                self.right_win)
        return [u_walk, sampling.draw_node_uniforms(
            generator, M * self.num_negs, dev, g)]

    def walk(self, g: GraphTensors, roots: torch.Tensor,
             u_walk: Sequence) -> torch.Tensor:
        """The roots' walks from their uniforms; int32 [B, walk_len + 1]."""
        return walk.select_walk(g, roots, self.edge_types, self.walk_len,
                                u_walk, self.walk_p, self.walk_q,
                                bias_cap=self.bias_cap)

    def score(self, g: GraphTensors, roots: torch.Tensor,
              paths: torch.Tensor, u_neg: Sequence) -> dict:
        """The skip-gram outputs of walks ``paths``."""
        pairs = walk.gen_pair(paths, self.left_win, self.right_win)
        src = pairs[..., 0].reshape(-1)
        ctx = pairs[..., 1].reshape(-1)
        negs = sampling.select_nodes(g, self.node_type, *u_neg).reshape(
            src.shape[0], self.num_negs)
        target = _Table(self.target_emb, g)
        out = skipgram(target(src.clamp_min(0)),
                       _Table(self.context_emb, g), src, ctx, negs)
        out["embedding"] = target(roots.clamp_min(0))
        return out

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None) -> dict:
        roots = roots.to(torch.int32)
        u_walk, u_neg = (uniforms if uniforms is not None
                         else self.draw_uniforms(roots, generator, g))
        return self.score(g, roots, self.walk(g, roots, u_walk), u_neg)


class Node2Vec(DeepWalk):
    """DeepWalk with biased walks (p = return, q = in-out)."""


class LINE(nn.Module):
    """LINE (reference: walk_models.py:91-143): each root against one
    weighted neighbor over ``edge_types`` and ``num_negs`` negatives of
    ``node_type``. Order 1 scores both with the one ``target_emb``
    table; order 2 scores the neighbor and the negatives with
    ``context_emb``. The embedding is the roots' ``target_emb`` rows."""

    def __init__(self, n_nodes: int, dim: int, edge_types, order: int = 2,
                 num_negs: int = 5, node_type=-1,
                 shard_embeddings: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if order not in (1, 2):
            raise ValueError(f"LINE order {order} not in 1, 2")
        self.n_nodes, self.dim, self.order = n_nodes, dim, order
        self.shard_embeddings = shard_embeddings
        self.edge_types = edge_types
        self.num_negs, self.node_type = num_negs, node_type
        self.target_emb = _table(n_nodes + 1, dim, shard_embeddings,
                                 generator)
        if order == 2:
            self.context_emb = _table(n_nodes + 1, dim, shard_embeddings,
                                      generator)
        self.to(resolve_device(device))

    def draw_uniforms(self, roots: torch.Tensor,
                      generator: Optional[torch.Generator],
                      g=None) -> list:
        """[the positive draw's uniforms (over a ShardView ``g``, of the
        owner's rows), the negatives'] of a batch."""
        B, dev = roots.shape[0], roots.device
        return [sampling.draw_sample_uniforms(
                    generator, sampling.neighbor_rows(g, B), 1, dev),
                sampling.draw_node_uniforms(generator, B * self.num_negs,
                                            dev, g)]

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None) -> dict:
        roots = roots.to(torch.int32)
        u_pos, u_neg = (uniforms if uniforms is not None
                        else self.draw_uniforms(roots, generator, g))
        pos = sampling.select_sampled_neighbors(g, roots, self.edge_types,
                                                *u_pos)[0][:, 0]
        negs = sampling.select_nodes(g, self.node_type, *u_neg).reshape(
            roots.shape[0], self.num_negs)
        target = _Table(self.target_emb, g)
        s = target(roots.clamp_min(0))
        context = target if self.order == 1 else _Table(self.context_emb, g)
        return dict(skipgram(s, context, roots, pos, negs), embedding=s)
