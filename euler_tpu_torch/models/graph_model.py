"""Graph classification: a node-level GNN, a readout over each node's
graph, and a sigmoid cross-entropy head.

Counterpart of euler_tpu/models/graph_model.py (reference:
tf_euler/python/mp_utils/base_graph.py:23-46, graph_gnn.py:28), fed by
``estimator.GraphEstimator``, whose batch is the dict
``estimator.make_graph_batch`` builds.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.models.convs import dense
from euler_tpu_torch.models.gnn import _sigmoid_xent


class GraphModel(nn.Module):
    """``embedder`` embeds the batch's member nodes (flat, -1 padded),
    ``pool`` reads them out by ``node_graph_idx`` over the valid ones,
    ``head_fc`` (bias-free, flax's ``head_fc``) gives the logits; the
    loss is the mean sigmoid cross-entropy against the one-hot labels
    (reference: graph_model.py:21-39). ``pool.out_dim`` is its output
    width."""

    def __init__(self, embedder: nn.Module, pool: nn.Module, label_dim: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedder, self.pool, self.label_dim = embedder, pool, label_dim
        self.head_fc = dense(pool.out_dim, label_dim, bias=False,
                             generator=generator)
        self.to(resolve_device(device))

    def forward(self, g: GraphTensors, batch: dict,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None):
        label = batch["label"]
        x = self.embedder(g, batch["node_ids"], generator=generator,
                          uniforms=uniforms)
        pooled = self.pool(x, batch["node_graph_idx"],
                           batch["mask"].to(torch.float32))
        logit = self.head_fc(pooled)
        loss = _sigmoid_xent(logit, label).mean()
        return dict(embedding=pooled, logit=logit, label=label, loss=loss)
