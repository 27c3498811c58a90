"""GNN net + supervised head.

Counterpart of euler_tpu/models/gnn.py: ``GNNNet`` over sampled and
whole-graph flows, and ``SuperviseModel`` (reference: tf_euler/python/
mp_utils/base_gnn.py:74-92 and mp_utils/base.py:24-48). The dataflow
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
from euler_tpu_torch.ops import feature_ops


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
    of a typed flow (self loops and invalid draws become relation 0).
    ``dtype`` casts the activations between stages (the parameters stay
    f32). Weights come from ``generator``, a CPU torch.Generator; the
    module is then moved to ``device``.
    """

    def __init__(self, conv: str, flow: Any, dims: Sequence[int],
                 feature: nn.Module, in_dim: int, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None,
                 conv_kwargs: Optional[dict] = None,
                 relation_from_etype: bool = False):
        super().__init__()
        dev = resolve_device(device)
        n_layers = flow.num_layers
        if len(dims) < n_layers:
            raise ValueError(f"dims {tuple(dims)} has fewer entries than "
                             f"the flow's {n_layers} hops")
        if relation_from_etype and not getattr(flow, "typed", False):
            raise ValueError(
                "relation_from_etype needs edge types: construct the flow "
                "with typed=True (fast path + per-draw types)")
        self.flow = flow
        self.dims = tuple(dims)
        self.feature = feature
        self.dtype = dtype
        self.relation_from_etype = relation_from_etype
        cls = convs_lib.get_conv_class(conv)
        widths = [in_dim] + list(self.dims[:n_layers])
        self.convs = nn.ModuleList(
            cls(widths[i], widths[i + 1], generator=generator,
                **(conv_kwargs or {}))
            for i in range(n_layers))
        self.out_fc = convs_lib.dense(widths[-1], self.dims[-1],
                                      generator=generator)
        self.to(dev)

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None) -> torch.Tensor:
        blocks = self.flow(g, roots, generator=generator, uniforms=uniforms)
        if blocks[0].ell_tpos is not None:
            x = self.feature(g, blocks[0].n_id[: blocks[0].size[0]])
        else:
            x = self.feature(g, blocks[0].n_id)
        if self.dtype is not None:
            x = x.to(self.dtype)
        for conv, block in zip(self.convs, blocks):
            if (x.shape[0] == block.size[0] != block.size[1]
                    and block.ell_tpos is None):
                # dynamic whole-graph block: rebuild its source set
                x = torch.where((block.n_id >= 0)[:, None],
                                x[block.n_id.long().clamp_min(0)], 0)
            kw = {}
            if self.relation_from_etype:
                kw["edge_attr"] = block.e_type.clamp_min(0)
            x = torch.relu(conv((x[: block.size[0]], x), block, **kw))
            if self.dtype is not None:
                x = x.to(self.dtype)
        if x.shape[0] != roots.shape[0]:
            # whole-graph flow: the roots' rows (ids past N clamp, as XLA)
            r = roots.reshape(-1).long()
            x = torch.where((r >= 0)[:, None],
                            x[r.clamp(0, x.shape[0] - 1)], 0)
        return self.out_fc(x.to(self.out_fc.weight.dtype))


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
        logit = self.head_fc(emb)
        valid = (roots >= 0).to(torch.float32)[:, None]
        xent = _sigmoid_xent(logit, label) * valid
        loss = xent.sum() / (valid.sum() * self.label_dim).clamp_min(1.0)
        return dict(embedding=emb, logit=logit, label=label, loss=loss,
                    valid=valid)


def _sigmoid_xent(logits, labels):
    """tf.nn.sigmoid_cross_entropy_with_logits."""
    return logits.clamp_min(0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))
