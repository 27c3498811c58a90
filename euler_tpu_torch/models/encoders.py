"""Feature encoders: node ids + graph features -> input vectors.

Counterpart of euler_tpu/models/encoders.py ``ShallowEncoder``
(reference: tf_euler/python/utils/encoders.py:32-120), and ``Embed``,
flax's ``nn.Embed`` as the encoder's tables, the KG tables and
``EmbedOnly`` use it.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.ops import feature_ops, mp_ops
from euler_tpu_torch.ops.dispatch import is_shard_view
from euler_tpu_torch.ops.gather_rows import gather_rows
from euler_tpu_torch.utils.trace import span


class ShallowEncoder(nn.Module):
    """Concat of [id embedding?, dense features?, sparse-id embeddings?]
    (encoders.py:23-67), in that order; rows of ids < 0 are 0 across the
    whole output, and the dense part's rows of ids >= N NaN, as in the
    reference.

    - ``use_id``: ``id_embedding``, an ``Embed`` of ``max_id + 2`` rows of
      ``id_dim``; id -1 reads row ``max_id + 1``, ids past the table NaN.
    - ``dense_names``: when the features share a dtype, one
      ``[M, sum of dims]`` block is allocated and each feature is gathered
      straight into its column range by ``gather_rows``, which writes the
      zero rows itself; features of mixed dtypes are gathered one by one
      and concatenated with the reference's type promotion.
    - ``sparse_names``: per name a ``sparse_<name>`` ``Embed`` of
      ``sparse_buckets`` rows of ``sparse_dim``, looked up by each valid
      id mod ``sparse_buckets`` and combined over the row's valid ids by
      ``sparse_combiner``, ``"sum"`` or ``"mean"`` (over at least 1). The
      reference's ``sparse_buckets=0`` sizes the table at its first call,
      by the graph's node count; the port builds its tables here, so it
      needs the count (``graph.meta.n_nodes`` for that default).

    Tables start as flax's ``default_embed_init`` from ``generator``, a
    CPU generator: the id table first, then one per sparse name.
    """

    def __init__(self, dense_names: Sequence[str] = (),
                 sparse_names: Sequence[str] = (), sparse_buckets: int = 0,
                 sparse_dim: int = 16, sparse_combiner: str = "sum",
                 use_id: bool = False, max_id: int = 0, id_dim: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not (dense_names or sparse_names or use_id):
            raise ValueError("ShallowEncoder configured with no inputs")
        if sparse_names and sparse_buckets <= 0:
            raise ValueError(
                "sparse_names need sparse_buckets > 0 (the reference's 0 "
                "means the graph's node count: pass graph.meta.n_nodes)")
        if sparse_combiner not in ("sum", "mean"):
            raise ValueError(f"sparse_combiner {sparse_combiner!r} not in "
                             f"sum, mean")
        self.dense_names = tuple(dense_names)
        self.sparse_combiner = sparse_combiner
        self.max_id = max_id
        self.id_embedding = Embed(max_id + 2, id_dim, generator) \
            if use_id else None
        self.sparse = nn.ModuleDict({
            name: Embed(sparse_buckets, sparse_dim, generator)
            for name in sparse_names})

    def _dense(self, g: GraphTensors, n_id: torch.Tensor) -> torch.Tensor:
        if is_shard_view(g):
            # each owner answers its rows through gather_rows
            parts = feature_ops.get_dense_feature(g, n_id, self.dense_names)
            return torch.cat(parts, dim=-1)
        with span("gather"):
            tables = [g.dense_nf[n] for n in self.dense_names]
            flat = n_id.reshape(-1).to(torch.int32).contiguous()
            dtypes = {t.dtype for t in tables}
            if len(dtypes) == 1:
                out = torch.empty(
                    (flat.shape[0], sum(t.shape[1] for t in tables)),
                    dtype=tables[0].dtype, device=flat.device)
                off = 0
                for t in tables:
                    gather_rows(t, flat, out, off)
                    off += t.shape[1]
            else:
                out = torch.cat([gather_rows(t, flat) for t in tables],
                                dim=-1)
            return out.reshape(tuple(n_id.shape) + (out.shape[1],))

    def _sparse(self, g: GraphTensors, n_id: torch.Tensor, name: str,
                table: Embed) -> torch.Tensor:
        (ids, mask), = feature_ops.get_sparse_feature(g, n_id, [name])
        hashed = torch.where(mask, ids.long() % table.weight.shape[0], 0)
        m = mask[..., None].to(table.weight.dtype)
        s = (table(hashed) * m).sum(dim=-2)
        if self.sparse_combiner == "mean":
            s = s / m.sum(dim=-2).clamp_min(1.0)
        return s

    def forward(self, g: GraphTensors, n_id: torch.Tensor) -> torch.Tensor:
        if self.id_embedding is None and not self.sparse:
            return self._dense(g, n_id)
        ok = n_id >= 0
        parts = []
        if self.id_embedding is not None:
            parts.append(self.id_embedding(
                torch.where(ok, n_id.long(), self.max_id + 1)))
        if self.dense_names:
            parts.append(self._dense(g, n_id))
        parts += [self._sparse(g, n_id, name, table)
                  for name, table in self.sparse.items()]
        dt = parts[0].dtype
        for p in parts[1:]:
            dt = torch.promote_types(dt, p.dtype)
        out = torch.cat([p.to(dt) for p in parts], dim=-1)
        return torch.where(ok[..., None], out, 0.0)


class TypedEncoder(nn.Module):
    """A heterogeneous graph's input rows, each node type's from its own
    source (OGB's R-GCN for ogbn-mag: the papers' features, a learned
    table for every other type, its ``emb_dict``). Node ids run by type
    in contiguous ranges, in the order of ``types``: (name, count, dense
    feature name or None). A type with a feature reads the graph's dense
    table of that name, whose row k is the type's k-th node, through
    ``gather_rows``; a type without one reads its ``emb[name]``, a
    [count, dim] table initialised as OGB's example initialises it
    (Glorot uniform over the table's shape), from ``generator``, a CPU
    generator.

    ``whole(g, dtype)`` gives every node's row in id order as one [N, dim]
    table (a typed whole-graph block's sources; the tables enter it
    whole, with no gather); ``forward(g, n_id)`` gives the rows of any
    ids, 0 for ids < 0."""

    def __init__(self, types: Sequence[Tuple[str, int, Optional[str]]],
                 dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.types = [(name, int(count), feat) for name, count, feat in types]
        self.dim = dim
        self.type_lo = [0]
        for _, count, _ in self.types:
            self.type_lo.append(self.type_lo[-1] + count)
        self.emb = nn.ParameterDict()
        for name, count, feat in self.types:
            if feat is None:
                bound = math.sqrt(6.0 / (count + dim))
                self.emb[name] = nn.Parameter(
                    (torch.rand((count, dim), generator=generator) * 2 - 1)
                    * bound)

    def whole(self, g: GraphTensors,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if g.meta.n_nodes != self.type_lo[-1]:
            raise ValueError(f"the encoder's types hold {self.type_lo[-1]} "
                             f"nodes, the graph {g.meta.n_nodes}")
        dev = g.node_type.device
        feats = [g.dense_nf[f] for _, _, f in self.types if f is not None]
        dt = dtype or (feats[0].dtype if feats else torch.float32)
        out = torch.empty((self.type_lo[-1], self.dim), dtype=dt, device=dev)
        for (name, count, feat), lo in zip(self.types, self.type_lo):
            if feat is not None:
                with span("gather"):
                    ids = torch.arange(count, dtype=torch.int32, device=dev)
                    table = g.dense_nf[feat]
                    if table.dtype == dt:
                        gather_rows(table, ids, out[lo:lo + count])
                    else:
                        out[lo:lo + count] = gather_rows(table, ids)
        for (name, count, feat), lo in zip(self.types, self.type_lo):
            if feat is None:
                out[lo:lo + count] = self.emb[name]
        return out

    def forward(self, g: GraphTensors, n_id: torch.Tensor) -> torch.Tensor:
        ids = n_id.reshape(-1).long()
        out = None
        for (name, count, feat), lo in zip(self.types, self.type_lo):
            mine = (ids >= lo) & (ids < lo + count)
            local = torch.where(mine, ids - lo, -1)
            if feat is not None:
                with span("gather"):
                    rows = gather_rows(g.dense_nf[feat],
                                       local.to(torch.int32).contiguous())
            else:
                rows = torch.where(mine[:, None],
                                   self.emb[name][local.clamp_min(0)], 0.0)
            out = rows.float() if out is None else out + rows.float()
        return out.reshape(tuple(n_id.shape) + (self.dim,))


class _Lookup(torch.autograd.Function):
    """Rows ``weight[ids]``; the backward sums each row's cotangent into a
    zero table with ``mp_ops.scatter_add``. On the card that sums
    repeated ids with atomics, in no fixed order, and never waits for the
    card (the dense backward of ``F.embedding`` sorts the ids and spends
    host time waiting), so a step through it can be captured in a CUDA
    graph. With ``fixed_order`` the sum takes a fixed order (see
    ``mp_ops``) and captures too; on an H100 it took 330 ms a step where
    2,300 ids share a row of a hashed sparse table, against 7.3 ms with
    atomics, so only tables whose ids rarely repeat take it."""

    @staticmethod
    def forward(ctx, weight, ids, fixed_order):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.fixed_order = weight.shape, fixed_order
        return weight.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + (weight.shape[1],))

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        grad = mp_ops.scatter_add(g.reshape(-1, ctx.shape[1]),
                                  ids.reshape(-1), ctx.shape[0],
                                  ctx.fixed_order)
        return grad, None, None


class Embed(nn.Module):
    """flax's ``nn.Embed``: a [num, features] table looked up by id.

    flax looks up with ``jnp.take``, whose default mode fills the row of
    an id past the table with NaN, where ``nn.Embedding`` would raise.
    Here ids clamp to the last row and those rows become NaN with a
    ``where``, so the clamped row takes no gradient from them. Callers
    clamp ids below 0, as the reference's do. The gradient of the table
    is a ``mp_ops.scatter_add`` of the rows' cotangents (``_Lookup``): on the
    card its sums over repeated ids run in no fixed order, unless
    ``fixed_order``. The table starts as flax's ``default_embed_init``:
    normal with variance 1 / features, drawn from ``generator``, a CPU
    generator.
    """

    def __init__(self, num: int, features: int,
                 generator: Optional[torch.Generator] = None,
                 fixed_order: bool = False):
        super().__init__()
        self.fixed_order = fixed_order
        self.weight = nn.Parameter(torch.randn(
            (num, features), generator=generator) / math.sqrt(features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        n = self.weight.shape[0]
        ids = ids.long()
        out = _Lookup.apply(self.weight, ids.clamp_max(n - 1),
                            self.fixed_order)
        return torch.where((ids < n)[..., None], out, float("nan"))
