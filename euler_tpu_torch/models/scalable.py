"""Scalable GNN encoders with historical-embedding stores.

Counterpart of euler_tpu/models/scalable.py (reference:
tf_euler/python/utils/encoders.py:294-410 and :629-749) on one device.
Layer l's neighbor inputs come from store l (a [n_nodes + 1, dim] table
of the roots' layer-l embeddings from earlier steps, row n_nodes the pad)
instead of a recursive expansion, read without gradient; in training the
batch's fresh embeddings are written back. The stores are buffers of the
module, updated in place and never rebound, so that a replayed CUDA graph
reads and writes the addresses it captured; they are saved with the
parameters. The write is deterministic on every device: where a root
repeats in the batch, its last occurrence wins (a scatter-max of the
positions picks it; ``index_put_`` alone leaves the winner open). In
evaluation (``model.eval()``) nothing is written, as the reference's
evaluate discards its store updates.

Over the mesh (scalable.py:40-75, :104-166), ``shard_over`` (which
``parallel.train.init_sharded_params`` calls) splits each store over the
graph axis: row r on shard r % S at local row r // S, marked
graph-sharded. A read goes through the owners (``sharded.owner_rows``);
a write gathers the roots and their embeddings over the WHOLE mesh, so
that every data replica of a shard applies the same writes, and each
owner writes its rows (the last occurrence in rank order wins).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.models import aggregators as aggr_lib
from euler_tpu_torch.ops import sampling
from euler_tpu_torch.ops.dispatch import is_shard_view
from euler_tpu_torch.parallel import comms
from euler_tpu_torch.parallel.mesh import mark_graph_sharded
from euler_tpu_torch.parallel.sharded import fold_seed, owner_rows


def last_write_rows(rows: torch.Tensor, ok: torch.Tensor, pad: int
                    ) -> torch.Tensor:
    """Where each of ``rows`` [B] writes so that, among positions sharing a
    row, only the last valid one does: that row for it, ``pad`` for every
    other position and for those not ``ok``. No host sync, so a CUDA
    graph can capture it."""
    pos = torch.arange(rows.shape[0], device=rows.device)
    idx = torch.where(ok, rows.long(), pad)
    last = torch.full((pad + 1,), -1, dtype=torch.int64, device=rows.device)
    last = last.scatter_reduce(0, idx, torch.where(ok, pos, -1), "amax")
    return torch.where(ok & (last[idx] == pos), idx, pad)


class ScalableGNNNet(nn.Module):
    """``num_layers`` aggregators (``agg_l``, by ``aggregator`` name) over
    one hop of ``fanout`` weighted draws (``select_sampled_neighbors``
    over ``edge_types``), with stores ``store_layer_1`` ..
    ``store_layer_{num_layers - 1}`` (reference: scalable.py:78-171).

    Layer 0 aggregates the encoder's rows of the roots and their
    neighbors; layer l > 0 the previous layer's output and store l's rows
    of the neighbors (row n_nodes for -1). With ``use_residual`` a layer
    whose output has its input's shape adds it. The output is the last
    layer's, zero for roots < 0. ``uniforms`` is the hop's
    ``draw_sample_uniforms`` tuple. The stores start uniform in [0,
    ``store_init_maxval``) from ``generator``."""

    def __init__(self, edge_types, num_layers: int, dim: int,
                 feature: nn.Module, in_dim: int, n_nodes: int,
                 fanout: int = 10, aggregator: str = "mean",
                 use_residual: bool = False, store_init_maxval: float = 0.05,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edge_types, self.num_layers = edge_types, num_layers
        self.dim, self.dims = dim, (dim,)
        self.feature, self.n_nodes, self.fanout = feature, n_nodes, fanout
        self.use_residual = use_residual
        agg = aggr_lib.get(aggregator)
        self.aggs = nn.ModuleList(
            agg(in_dim if i == 0 else dim, dim, generator=generator)
            for i in range(num_layers))
        self.store_init_maxval = store_init_maxval
        self.num_shards = None          # the graph axis after shard_over
        for i in range(1, num_layers):
            self.register_buffer(f"store_layer_{i}", torch.rand(
                (n_nodes + 1, dim), generator=generator) * store_init_maxval)
        self.to(resolve_device(device))

    def stores(self):
        return [getattr(self, f"store_layer_{i}")
                for i in range(1, self.num_layers)]

    def shard_over(self, mesh, seed: int = 0) -> None:
        """Hold this rank's block [ceil((n_nodes + 1) / S), dim] of each
        store, uniform in [0, store_init_maxval) from ``seed`` folded by
        the layer and the graph index."""
        S = mesh.graph
        for i in range(1, self.num_layers):
            gen = torch.Generator().manual_seed(
                fold_seed(fold_seed(seed, i), mesh.graph_index))
            block = torch.rand((-(-(self.n_nodes + 1) // S), self.dim),
                               generator=gen) * self.store_init_maxval
            setattr(self, f"store_layer_{i}", mark_graph_sharded(
                block.to(getattr(self, f"store_layer_{i}").device), mesh))
        self.num_shards = S

    def _write_sharded(self, g, roots: torch.Tensor, embs) -> None:
        """Every rank's roots and embeddings, gathered over the whole
        mesh in rank order; each owner writes the rows it holds."""
        S, world = g.num_shards, g.mesh.world_group
        ids = comms.all_gather(roots, world).reshape(-1)
        mine = (ids >= 0) & (ids % S == g.my_shard)
        for store, emb in zip(self.stores(), embs):
            vals = comms.all_gather(emb.detach(), world).reshape(
                -1, emb.shape[-1])
            n_local = store.shape[0]
            dst = last_write_rows(torch.where(mine, ids // S, 0), mine,
                                  n_local)
            hit = dst < n_local
            store[dst[hit]] = vals[hit]

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None) -> torch.Tensor:
        sharded = is_shard_view(g)
        if sharded != (self.num_shards is not None) or (
                sharded and g.num_shards != self.num_shards):
            raise ValueError(
                "a ScalableGNNNet over the mesh reads a ShardView of its "
                "mesh, after parallel.train.init_sharded_params (its graph "
                f"axis: {self.num_shards}; the graph's: "
                f"{getattr(g, 'num_shards', None)})")
        roots = roots.reshape(-1).to(torch.int32)
        B = roots.shape[0]
        u = uniforms if uniforms is not None else \
            sampling.draw_sample_uniforms(
                generator, sampling.neighbor_rows(g, B), self.fanout,
                roots.device)
        nbr = sampling.select_sampled_neighbors(g, roots, self.edge_types,
                                                *u)[0]
        nmask = nbr >= 0
        node_emb = self.feature(g, roots)
        neigh_emb = self.feature(g, nbr.reshape(-1)).reshape(
            B, self.fanout, -1)
        rows = torch.where(nmask, nbr.long(), self.n_nodes)
        stores, embs = self.stores(), []
        for layer, agg in enumerate(self.aggs):
            out = agg(node_emb, neigh_emb, nmask)
            if self.use_residual and out.shape == node_emb.shape:
                node_emb = node_emb + out
            else:
                node_emb = out
            embs.append(node_emb)
            if layer < self.num_layers - 1:
                neigh_emb = (owner_rows(g, stores[layer], rows) if sharded
                             else stores[layer][rows])
        if self.training and sharded:
            with torch.no_grad():
                self._write_sharded(g, roots, embs)
        elif self.training:
            ok = roots >= 0
            dst = last_write_rows(roots, ok, self.n_nodes)
            with torch.no_grad():
                for store, emb in zip(stores, embs):
                    pad = store[self.n_nodes].clone().expand(B, -1)
                    store.index_copy_(0, dst, torch.where(
                        (dst < self.n_nodes)[:, None], emb.detach(), pad))
        return torch.where((roots >= 0)[:, None], node_emb, 0.0)


class ScalableSageNet(ScalableGNNNet):
    """The reference's ScalableSageEncoder defaults (encoders.py:629-749):
    ``ScalableGNNNet`` as it is."""
