"""GNN net, id-embedding net, and the supervised and unsupervised heads.

Counterpart of euler_tpu/models/gnn.py: ``GNNNet`` and ``JKGNNNet`` over
sampled and whole-graph flows, ``EmbedOnly``, ``SuperviseModel`` and
``UnsuperviseModel`` (reference: tf_euler/python/mp_utils/
base_gnn.py:74-139 and mp_utils/base.py:24-91). The dataflow
runs inside ``forward``; its randomness comes from the ``generator`` (or
the replayed ``uniforms``) the caller passes. Training differentiates
the loss with autograd; the whole-graph ELL aggregate and expansion have
their own backward (dataflow/block.py), and the features the encoder
gathers are inputs, not parameters.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.models import convs as convs_lib
from euler_tpu_torch.models.encoders import Embed
from euler_tpu_torch.ops import feature_ops, sampling, util_ops
from euler_tpu_torch.ops.sigmoid_xent import sigmoid_xent, sigmoid_xent_grad
from euler_tpu_torch.ops.sigmoid_xent import xent_terms as _sigmoid_xent
from euler_tpu_torch.utils.trace import span


class GNNNet(nn.Module):
    """Stack of graph convolutions over a dataflow, then ``out_fc``.

    ``dims`` holds the hidden dim of each layer and, last, the output dim
    (one conv per block of the flow, ``flow.num_layers``). Over a
    whole-graph flow every layer computes all N nodes and the roots' rows
    are picked at the end: ELL-pack blocks keep the activations compact,
    [N, D], and the convs aggregate from that table; dynamic whole-graph
    blocks (no transpose table) expand it through ``n_id`` each layer.
    ``in_dim`` is the width of the
    ``feature`` encoder's output; ``conv_kwargs`` go to every conv (e.g.
    ``{"num_relations": 4}``). With ``relation_from_etype`` each conv
    also gets ``edge_attr = max(block.e_type, 0)``, the sampled edge types
    of a typed or payload flow (self loops and invalid draws become
    relation 0).
    ``dtype`` casts the activations between stages (the parameters stay
    f32). With ``dedup_features`` the deepest block's features are
    fetched through ``util_ops.unique_gather``: each distinct id once,
    its repeats as -1 ids (zero rows), then a gather of the rows back to
    every position (the reference's gnn.py:73-76; not over whole-graph
    ELL blocks, whose fetch is already one row a node). Weights come from
    ``generator``, a CPU torch.Generator; the module is then moved to
    ``device``.
    """

    def __init__(self, conv: str, flow: Any, dims: Sequence[int],
                 feature: nn.Module, in_dim: int, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None,
                 conv_kwargs: Optional[dict] = None,
                 relation_from_etype: bool = False,
                 dedup_features: bool = False):
        super().__init__()
        dev = resolve_device(device)
        if relation_from_etype and \
                getattr(flow, "payload", True) is False and \
                not getattr(flow, "typed", False):
            raise ValueError(
                "relation_from_etype needs edge types: construct the "
                "flow with typed=True (fast path + per-draw types) or "
                "payload=True (fast ids-only sampling carries e_id=-1)")
        self.flow = flow
        self.dims = tuple(dims)
        self.feature = feature
        self.dtype = dtype
        self.relation_from_etype = relation_from_etype
        self.dedup_features = dedup_features
        self.convs, widths = _make_convs(conv, in_dim, self.dims, flow,
                                         generator, conv_kwargs)
        self.out_fc = convs_lib.dense(widths[-1], self.dims[-1],
                                      generator=generator)
        self.to(dev)

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None) -> torch.Tensor:
        with span("dataflow"):
            blocks = self.flow(g, roots, generator=generator,
                               uniforms=uniforms)
        if self.dedup_features and blocks[0].ell_tpos is None:
            x = util_ops.unique_gather(lambda ids: self.feature(g, ids),
                                       blocks[0].n_id)
        else:
            x = _input_features(self.feature, g, blocks, self.dtype)
        # a half-width feature table (load_graph's feature_dtype) reaches
        # f32 parameters in f32, as flax's Dense promotes its input
        x = x.to(self.dtype if self.dtype is not None else torch.float32)
        for conv, block in zip(self.convs, blocks):
            x = _source_set(x, block)
            kw = {}
            if self.relation_from_etype:
                kw["edge_attr"] = block.e_type.clamp_min(0)
            with span("conv"):
                h = conv((x[: block.size[0]], x), block, **kw)
            x = torch.relu(h)
            if self.dtype is not None:
                x = x.to(self.dtype)
        x = _pick_roots(x, roots)
        return self.out_fc(x.to(self.out_fc.weight.dtype))


def _make_convs(conv: str, in_dim: int, dims: Sequence[int], flow: Any,
                generator: Optional[torch.Generator],
                conv_kwargs: Optional[dict]):
    """One conv per block of ``flow``, at the leading entries of ``dims``,
    each reading the width the last one outputs (its ``out_dim``: AGNN
    and APPNP keep their input width, as flax's lazily shaped layers
    would); returns (convs, widths), the widths from ``in_dim`` to the
    last conv's output."""
    n_layers = flow.num_layers
    if len(dims) < n_layers:
        raise ValueError(f"dims {tuple(dims)} has fewer entries than "
                         f"the flow's {n_layers} hops")
    cls = convs_lib.get_conv_class(conv)
    widths, convs = [in_dim], []
    for dim in dims[:n_layers]:
        convs.append(cls(widths[-1], dim, generator=generator,
                         **(conv_kwargs or {})))
        widths.append(convs[-1].out_dim)
    return nn.ModuleList(convs), widths


def _input_features(feature: nn.Module, g: GraphTensors, blocks,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The encoder's rows of the deepest block's sources; over ELL-pack
    blocks the compact [N, D] table of their targets; over a typed
    whole-graph block, whose sources are every node in id order, the
    encoder's ``whole`` table where it has one (in ``dtype``)."""
    if blocks[0].rel is not None and hasattr(feature, "whole"):
        return feature.whole(g, dtype)
    if blocks[0].ell_tpos is not None:
        return feature(g, blocks[0].n_id[: blocks[0].size[0]])
    return feature(g, blocks[0].n_id)


def _source_set(x: torch.Tensor, block) -> torch.Tensor:
    """A dynamic whole-graph block (no transpose table) reads the expanded
    source set: rebuild it from the per-node rows ``x``."""
    if (x.shape[0] == block.size[0] != block.size[1]
            and block.ell_tpos is None):
        return torch.where((block.n_id >= 0)[:, None],
                           x[block.n_id.long().clamp_min(0)], 0)
    return x


def _pick_roots(x: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """After a whole-graph flow, the roots' rows (ids past N clamp, as
    XLA; ids < 0 give 0); a sampled flow's output is already theirs."""
    if x.shape[0] == roots.shape[0]:
        return x
    r = roots.reshape(-1).long()
    return torch.where((r >= 0)[:, None], x[r.clamp(0, x.shape[0] - 1)], 0)


class JKGNNNet(nn.Module):
    """Jumping-knowledge net (reference: base_gnn.py:94-139,
    euler_tpu/models/gnn.py:111-149): each conv's relu output, cut to the
    last block's targets, joined by ``jk_mode`` and fed to ``out_fc``.
    ``"concat"`` concatenates them; ``"maxpool"`` is, as in the reference,
    their SUM (``jnp.sum(jnp.stack(...), 1)``), not a max. No activation
    dtype and no relation types, as the reference has neither.
    """

    def __init__(self, conv: str, flow: Any, dims: Sequence[int],
                 feature: nn.Module, in_dim: int, jk_mode: str = "concat",
                 device=None, generator: Optional[torch.Generator] = None,
                 conv_kwargs: Optional[dict] = None):
        super().__init__()
        if jk_mode not in ("concat", "maxpool"):
            raise ValueError(f"jk_mode {jk_mode!r} not in concat, maxpool")
        self.flow = flow
        self.dims = tuple(dims)
        self.feature = feature
        self.jk_mode = jk_mode
        self.convs, widths = _make_convs(conv, in_dim, self.dims, flow,
                                         generator, conv_kwargs)
        if jk_mode == "maxpool" and len(set(widths[1:])) > 1:
            raise ValueError(f"jk_mode maxpool sums the layers' outputs, "
                             f"whose widths {widths[1:]} differ")
        jk_width = sum(widths[1:]) if jk_mode == "concat" else widths[-1]
        self.out_fc = convs_lib.dense(jk_width, self.dims[-1],
                                      generator=generator)
        self.to(resolve_device(device))

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None) -> torch.Tensor:
        blocks = self.flow(g, roots, generator=generator, uniforms=uniforms)
        x = _input_features(self.feature, g, blocks)
        hidden = []
        for conv, block in zip(self.convs, blocks):
            x = _source_set(x, block)
            x = torch.relu(conv((x[: block.size[0]], x), block))
            hidden = [h[: block.size[0]] for h in hidden] + [x]
        if self.jk_mode == "concat":
            x = torch.cat(hidden, dim=1)
        else:
            x = torch.stack(hidden, 1).sum(dim=1)
        x = _pick_roots(x, roots)
        return self.out_fc(x.to(self.out_fc.weight.dtype))


class EmbedOnly(nn.Module):
    """Pure id-embedding net (the DeepWalk/LINE context towers): a
    ``max_id + 2`` row table whose last row is the embedding of id -1
    (gnn.py:152-162). It draws nothing: ``generator`` and ``uniforms``
    are accepted and ignored, as a flow that draws nothing ignores them.
    """

    def __init__(self, max_id: int, dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_id, self.dim = max_id, dim
        self.embed = Embed(max_id + 2, dim, generator)
        self.to(resolve_device(device))

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None) -> torch.Tensor:
        return self.embed(torch.where(roots >= 0, roots, self.max_id + 1))


class SuperviseModel(nn.Module):
    """Multi-label supervised head: sigmoid cross-entropy
    (reference: mp_utils/base.py:24-48)."""

    def __init__(self, embedder: GNNNet, label_name: str, label_dim: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.embedder = embedder
        self.label_name = label_name
        self.label_dim = label_dim
        self.head_fc = convs_lib.dense(embedder.dims[-1], label_dim,
                                       bias=False, generator=generator)
        self.to(dev)

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None):
        (label,) = feature_ops.get_dense_feature(g, roots, [self.label_name])
        label = label[:, : self.label_dim]
        emb = self.embedder(g, roots, generator=generator, uniforms=uniforms)
        with span("head"):
            logit = self.head_fc(emb)
            valid = (roots >= 0).to(torch.float32)
            loss = _SigmoidXent.apply(logit, label, valid)
        return dict(embedding=emb, logit=logit, label=label, loss=loss,
                    valid=valid[:, None])


class UnsuperviseModel(nn.Module):
    """Skip-gram head: each root against one neighbor drawn over
    ``edge_types`` and ``num_negs`` nodes of ``node_type``, sigmoid
    cross-entropy (reference: mp_utils/base.py:50-91, gnn.py:188-218).

    ``embedder`` embeds the roots, ``context_embedder`` the positives and
    then the flattened negatives (two calls). ``uniforms`` replays every
    draw of a call, in this order: the positive hop (what
    ``sampling.draw_neighbor_uniforms`` gives for B nodes and 1 draw),
    the negative draw (``draw_node_uniforms`` of ``B * num_negs``), then
    the per-hop uniforms of the three tower calls (roots, positives,
    negatives; None for a tower that draws nothing).
    """

    def __init__(self, embedder: nn.Module, context_embedder: nn.Module,
                 edge_types, node_type=-1, num_negs: int = 20, device=None):
        super().__init__()
        self.embedder = embedder
        self.context_embedder = context_embedder
        self.edge_types = edge_types
        self.node_type = node_type
        self.num_negs = num_negs
        self.to(resolve_device(device))

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None):
        B, dev = roots.shape[0], roots.device
        roots = roots.to(torch.int32)
        if uniforms is None:
            u_pos = sampling.draw_neighbor_uniforms(g, self.edge_types,
                                                    generator, B, 1, dev)
            u_neg = sampling.draw_node_uniforms(generator, B * self.num_negs,
                                                dev, g)
            towers = (None,) * 3
        else:
            u_pos, u_neg, *towers = uniforms
        pos, _ = sampling.select_neighbors(g, roots, self.edge_types, u_pos)
        negs = sampling.select_nodes(g, self.node_type, *u_neg)
        emb = self.embedder(g, roots, generator=generator,
                            uniforms=towers[0])                     # [B, D]
        emb_pos = self.context_embedder(g, pos[:, 0], generator=generator,
                                        uniforms=towers[1])         # [B, D]
        emb_negs = self.context_embedder(
            g, negs, generator=generator,
            uniforms=towers[2]).reshape(B, self.num_negs, -1)
        logits = (emb * emb_pos).sum(-1, keepdim=True)             # [B, 1]
        neg_logits = torch.einsum("bd,bnd->bn", emb, emb_negs)      # [B, N]
        pos_ok = (pos[:, 0] >= 0).to(torch.float32)[:, None]
        true_xent = _sigmoid_xent(logits, torch.ones_like(logits)) * pos_ok
        neg_xent = _sigmoid_xent(neg_logits, torch.zeros_like(neg_logits))
        loss = (true_xent.sum() + neg_xent.sum()) / (
            pos_ok.sum().clamp_min(1.0) + neg_xent.numel())
        return dict(embedding=emb, logits=logits, neg_logits=neg_logits,
                    loss=loss, pos_mask=pos_ok)


class _SigmoidXent(torch.autograd.Function):
    """``SuperviseModel``'s loss: the masked mean sigmoid cross-entropy of
    the logits, ``_sigmoid_xent(logit, label) * valid`` summed over
    ``max(sum(valid) * C, 1)``, as one pass each way
    (``ops.sigmoid_xent``). Saves the logits, labels and weights, which
    the forward holds anyway, and the denominator. The backward runs in
    the span ``head.backward``: one pass writes the logits' gradient
    (autograd's gradient of the expression, a logit of 0 included); the
    labels and weights get none."""

    @staticmethod
    def forward(ctx, logit, label, valid):
        loss, den = sigmoid_xent(logit, label, valid)
        ctx.save_for_backward(logit, label, valid, den)
        return loss

    @staticmethod
    def backward(ctx, g):
        with span("head.backward"):
            logit, label, valid, den = ctx.saved_tensors
            return sigmoid_xent_grad(logit, label, valid, den, g), None, None
