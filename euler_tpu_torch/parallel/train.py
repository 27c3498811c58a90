"""Training and serving over the mesh's graph shards.

Counterpart of euler_tpu/parallel/train.py: the batch sources
(``node_ids_fn``, ``edge_ids_fn``, ``graph_ids_fn``, :36-62), the train
step ``make_sharded_train_step`` with its partition-aware gradient sync
(:65-193), ``init_sharded_params`` (:196-231), the evaluate/infer
``make_sharded_apply`` (:234-300) and ``place_sharded_graph`` (:303).
Every rank runs the model over its own ``ShardView``; the op modules
route each verb through the shard owners, so the model runs unchanged.

The reference's one jitted SPMD step becomes one eager step a rank:
each rank's loss is ``pmean``'d over every rank and backpropagated (the
differentiable collectives of ``comms`` carry a gradient across ranks,
as the reference's transposes do), then ``_sync_grads`` combines the
gradients and each rank's optimizer steps its own copy. Gloo copies to
the host and waits, so the step cannot be captured in a CUDA graph, and
``steps_per_loop`` runs eager steps with the reference's per-step seeds.

How a user trains over 4 graph shards, one process a rank::

    mesh = make_mesh(data=1, graph=4, init_method=..., rank=r)
    view = place_sharded_graph(build_sharded(graph, 4), mesh)
    init_sharded_params(model, mesh, seed=0)
    opt = torch.optim.Adam(model.parameters(), 1e-3)
    step = make_sharded_train_step(model, opt, mesh, batch_per_rank=1024)
    loss = step(view, seed=i)          # every rank, the same seed
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from euler_tpu_torch.ops import sampling
from euler_tpu_torch.parallel import comms
from euler_tpu_torch.parallel.mesh import (Mesh, is_graph_sharded,
                                           rank_rows)
from euler_tpu_torch.parallel.sharded import (ShardedGraphTensors, ShardView,
                                              fold_seed, take_shard)


def node_ids_fn(node_type=-1):
    """The default batch source: weighted global node sampling
    (node_estimator.py:31-34)."""
    def ids_fn(view, generator, n):
        return sampling.sample_node(view, n, node_type, generator)
    return ids_fn


def edge_ids_fn(edge_type=-1):
    """The edge models' batch source: sampled (src, dst, etype) triples
    stacked [n, 3] (edge_estimator.py:32-45)."""
    def ids_fn(view, generator, n):
        src, dst, ty, _ = sampling.sample_edge(view, n, edge_type,
                                               generator)
        return torch.stack([src, dst, ty], dim=1)
    return ids_fn


def graph_ids_fn():
    """The graph classifiers' batch source: uniform graph indices
    (graph_estimator.py:45-56)."""
    def ids_fn(view, generator, n):
        return sampling.sample_graph_label(view, n, generator)
    return ids_fn


def param_specs(model: torch.nn.Module) -> Dict[str, str]:
    """Each parameter's and buffer's layout by name: "graph" for a block
    of a table split over the graph axis (``mesh.mark_graph_sharded``),
    "replicated" for the rest (the reference's PartitionSpec tree)."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    return {name: "graph" if is_graph_sharded(t) else "replicated"
            for name, t in named}


def _sync_grads(model: torch.nn.Module, mesh: Mesh) -> None:
    """The partition-aware gradient combine (train.py:85-104), in place:
    replicated parameters take the mean of every rank's gradient; a
    graph-sharded parameter the mean over its data group only (each
    shard owns its rows' gradient, which the backward of the lookup's
    collectives has already summed over its graph group). One flat
    all-reduce per kind and dtype, the parameters in the model's order;
    a parameter without a gradient joins with zeros, so every rank runs
    the same collectives."""
    params = list(model.parameters())
    for sharded, group, n in ((False, mesh.world_group, mesh.size),
                              (True, mesh.data_group, mesh.data)):
        mine = [p for p in params if is_graph_sharded(p) == sharded]
        if n == 1 or not mine:
            continue
        for dtype in sorted({p.dtype for p in mine}, key=str):
            ps = [p for p in mine if p.dtype == dtype]
            flat = torch.cat([(p.grad if p.grad is not None
                               else torch.zeros_like(p)).reshape(-1)
                              for p in ps])
            flat = comms.pmean(flat, group)
            at = 0
            for p in ps:
                p.grad = flat[at:at + p.numel()].view_as(p).clone()
                at += p.numel()


def _local_batch(view: ShardView, mesh: Mesh, seed: int, ids_fn: Callable,
                 expand_fn: Optional[Callable], b: int,
                 ids: Optional[torch.Tensor] = None):
    """One rank's model input and sample generator (train.py:96-107).
    The whole graph group draws one batch of ``b * S`` ids from one
    stream seeded by ``seed`` and the data index (or takes ``ids``, that
    draw) and each member takes its slice: the owner exchange needs the
    same queries on every member. The sample stream is then folded by
    the graph index."""
    S, gi = mesh.graph, mesh.graph_index
    base = fold_seed(seed, mesh.data_index)
    if ids is None:
        gen = torch.Generator(device=view.device)
        gen.manual_seed(fold_seed(base, 0))
        ids = ids_fn(view, gen, b * S)
    ids = ids.to(view.device)
    if ids.shape[0] != b * S:
        raise ValueError(f"the graph group's draw has {ids.shape[0]} rows, "
                         f"not {b} x {S}")
    mine = ids[gi * b:(gi + 1) * b]
    batch = expand_fn(view, mine) if expand_fn is not None else mine
    sample = torch.Generator(device=view.device)
    sample.manual_seed(fold_seed(fold_seed(base, 1), gi))
    return batch, sample


def make_sharded_train_step(model: torch.nn.Module,
                            optimizer: torch.optim.Optimizer, mesh: Mesh,
                            batch_per_rank: int, node_type=-1,
                            ids_fn: Optional[Callable] = None,
                            expand_fn: Optional[Callable] = None,
                            steps_per_loop: int = 1):
    """``step(view, seed=0, ids=None, uniforms=None) -> loss``: one
    optimizer step (``steps_per_loop`` of them, step ``i`` from
    ``fold_seed(seed, i)``) over the mesh, called by every rank with the
    same ``seed``; returns the last step's loss, ``pmean``'d over every
    rank (a 0-d tensor on the rank's device).

    Each rank trains on ``batch_per_rank`` roots (the global batch is
    ``batch_per_rank`` times the rank count) from ``ids_fn(view,
    generator, n)`` (``node_ids_fn(node_type)`` by default) and
    ``expand_fn(view, ids)``; ``ids`` (the graph group's ``b * S``
    draw) and ``uniforms`` (the owner's per model draw) replace the
    draws of a single step. The model's buffers (the scalable caches)
    are updated by its forward, as on one device.
    """
    if ids_fn is None:
        ids_fn = node_ids_fn(node_type)

    def one(view, seed, ids=None, uniforms=None):
        batch, gen = _local_batch(view, mesh, seed, ids_fn, expand_fn,
                                  batch_per_rank, ids)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = model(view, batch, generator=gen, uniforms=uniforms)
        loss = comms.pmean(out["loss"], mesh.world_group)
        loss.backward()
        _sync_grads(model, mesh)
        optimizer.step()
        return loss.detach()

    def step(view: ShardView, seed: int = 0,
             ids: Optional[torch.Tensor] = None,
             uniforms: Optional[Sequence] = None) -> torch.Tensor:
        if steps_per_loop <= 1:
            return one(view, seed, ids, uniforms)
        if ids is not None or uniforms is not None:
            raise ValueError("ids and uniforms replace one step's draws: "
                             "pass them with steps_per_loop=1")
        for i in range(steps_per_loop):
            loss = one(view, fold_seed(seed, i))
        return loss

    return step


def init_sharded_params(model: torch.nn.Module, mesh: Mesh,
                        seed: int = 0) -> Dict[str, str]:
    """Lay ``model`` out over the mesh (train.py:196-231): every module
    with a ``shard_over(mesh, seed)`` (``layers.ShardedEmbedding``, the
    scalable stores) replaces its table by this rank's block of it,
    drawn from ``seed`` folded by the graph index; replicated parameters
    stay as built, so they must be built from one seed on every rank
    (they then are bit-equal). Returns ``param_specs(model)``."""
    for m in model.modules():
        shard = getattr(m, "shard_over", None)
        if shard is not None:
            shard(mesh, seed)
    return param_specs(model)


def place_sharded_graph(sg: ShardedGraphTensors, mesh: Mesh) -> ShardView:
    """This rank's shard of ``sg`` on its device (the reference places
    every shard with its PartitionSpec; a rank holds its own)."""
    return take_shard(sg, mesh.graph_index, mesh.device, mesh)


def make_sharded_apply(model: torch.nn.Module, mesh: Mesh,
                       expand_fn: Optional[Callable] = None):
    """An evaluate/infer apply over the mesh:
    ``fn(view, batch, seed=0, uniforms=None) -> out dict``, called by
    every rank with the same ``batch``.

    The batch's leading dim is split over ALL ranks in row order (rank
    ``di * S + gi`` takes slice ``di * S + gi``) and each rank's slice
    goes through ``expand_fn(view, ids)`` where it is given; each rank
    draws from a generator seeded with ``seed`` folded with its rank (or
    reads ``uniforms``, the owner's per hop), scalar outputs come back
    ``pmean``'d over every rank and array outputs gathered back in rank
    order, so each rank returns the whole batch's. Runs without
    autograd, in eval mode (a scalable model writes no cache).

    A scalar output is each rank's value weighted by its live rows (ids
    >= 0, the first column of a triple), summed over every rank and
    divided by the live rows of the whole batch: a rank that holds only
    -1 pad rows adds nothing. The reference ``pmean``s it, which counts
    such a rank's value (0 for a masked loss) as an equal share; the two
    agree on a batch without pad rows.
    """
    def fn(view: ShardView, batch: torch.Tensor, seed: int = 0,
           uniforms: Optional[Sequence] = None):
        batch = batch.to(view.device)[rank_rows(batch.shape[0], mesh)]
        live = ((batch if batch.dim() == 1 else batch[:, 0]) >= 0).sum()
        gen = None
        if uniforms is None:
            gen = torch.Generator(device=view.device)
            gen.manual_seed(fold_seed(seed, mesh.rank))
        model.eval()
        with torch.no_grad():
            if expand_fn is not None:
                batch = expand_fn(view, batch)
            out = model(view, batch, generator=gen, uniforms=uniforms)
        world = mesh.world_group
        scalars = [k for k, v in out.items() if v.dim() == 0]
        live = live.to(torch.float32)
        sums = comms.psum(torch.stack(
            [out[k].to(torch.float32) * live for k in scalars] + [live]),
            world) if scalars else None
        return {k: sums[scalars.index(k)] / sums[-1].clamp_min(1.0)
                if v.dim() == 0 else
                comms.all_gather(v, world).reshape((-1,) + tuple(v.shape[1:]))
                for k, v in out.items()}

    return fn
