"""Sharded serving: a model's forward over the mesh's graph shards.

Counterpart of the serving half of euler_tpu/parallel/train.py:
``make_sharded_apply`` (:234-300) and ``place_sharded_graph`` (:303).
Every rank runs the model over its own ``ShardView``; the op modules
route each verb through the shard owners, so the model runs unchanged.
The train step, ``init_sharded_params`` and the gradient sync are left
to ROADMAP Queue A item 11b.

How a user serves over 4 graph shards, one process a rank::

    mesh = make_mesh(data=1, graph=4, init_method=..., rank=r)
    view = place_sharded_graph(build_sharded(graph, 4), mesh)
    # or load_shard(dir, mesh.graph_index, mesh.device, mesh)
    apply = make_sharded_apply(model, mesh)
    out = apply(view, batch, seed=0)   # batch: every rank's same ids
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from euler_tpu_torch.parallel import comms
from euler_tpu_torch.parallel.mesh import Mesh, rank_rows
from euler_tpu_torch.parallel.sharded import (ShardedGraphTensors, ShardView,
                                              fold_seed, take_shard)


def place_sharded_graph(sg: ShardedGraphTensors, mesh: Mesh) -> ShardView:
    """This rank's shard of ``sg`` on its device (the reference places
    every shard with its PartitionSpec; a rank holds its own)."""
    return take_shard(sg, mesh.graph_index, mesh.device, mesh)


def make_sharded_apply(model: torch.nn.Module, mesh: Mesh):
    """An evaluate/infer apply over the mesh:
    ``fn(view, batch, seed=0, uniforms=None) -> out dict``, called by
    every rank with the same ``batch``.

    The batch's leading dim is split over ALL ranks in row order (rank
    ``di * S + gi`` takes slice ``di * S + gi``), each rank draws from a
    generator seeded with ``seed`` folded with its rank (or reads
    ``uniforms``, the owner's per hop), scalar outputs come back
    ``pmean``'d over every rank and array outputs gathered back in rank
    order, so each rank returns the whole batch's. Runs without
    autograd, in eval mode.
    """
    def fn(view: ShardView, batch: torch.Tensor, seed: int = 0,
           uniforms: Optional[Sequence] = None):
        batch = batch.to(view.device)[rank_rows(batch.shape[0], mesh)]
        gen = None
        if uniforms is None:
            gen = torch.Generator(device=view.device)
            gen.manual_seed(fold_seed(seed, mesh.rank))
        model.eval()
        with torch.no_grad():
            out = model(view, batch, generator=gen, uniforms=uniforms)
        world = mesh.world_group
        return {k: comms.pmean(v, world) if v.dim() == 0 else
                comms.all_gather(v, world).reshape((-1,) + tuple(v.shape[1:]))
                for k, v in out.items()}

    return fn
