"""Node and edge feature lookup.

Counterpart of euler_tpu/ops/feature_ops.py (reference: tf_euler
feature_ops.py:57-188). Handed a ``parallel.sharded.ShardView``, each
lookup routes to its owner-served counterpart, as the reference's do
(:38, :48, :62, :70, :90). Row i belongs to ``nodes[i]`` (or
``eids[i]``).

- Dense features (``get_dense_feature``, ``get_edge_dense_feature``):
  zeros for ids < 0 (padding) and NaN for ids >= N, as the reference's
  ``jnp.take`` (which fills an out-of-range row with NaN) and its
  ``where`` give. The gather is ``gather_rows``: the CUDA kernel for CUDA
  tensors, its plain version for CPU tensors.
- Sparse features (``get_sparse_feature``, ``get_edge_sparse_feature``):
  (ids [*, L] padded with -1, mask ``ids >= 0``). An id row < 0 is all -1;
  an id row >= N is ``jnp.take``'s integer fill, INT32_MIN, which the mask
  drops. A plain torch take: ``gather_rows`` reads float rows, and its NaN
  row read as an int32 would be a positive "id" that the mask keeps.
- ``get_edge_type``: the type of each original edge row, -1 for eids < 0
  (eids past E clamp, as XLA's gather).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.ops.dispatch import is_shard_view as _is_shard_view
from euler_tpu_torch.ops.gather_rows import gather_rows
from euler_tpu_torch.utils.trace import span


def _sharded():
    from euler_tpu_torch.parallel import sharded
    return sharded


def _take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table`` f32/bf16 [N, D] rows of ``ids`` (any shape) -> [*ids, D]."""
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    rows = gather_rows(table, flat)
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def _take_id_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Integer ``table`` [N, L] rows of ``ids`` -> [*ids, L]: -1 rows for
    ids < 0, ``jnp.take``'s fill (the dtype's minimum) for ids >= N."""
    flat = ids.reshape(-1).long()
    n = table.shape[0]
    rows = table[flat.clamp(0, max(n - 1, 0))]
    rows = torch.where((flat < n)[:, None], rows,
                       torch.iinfo(table.dtype).min)
    rows = torch.where((flat >= 0)[:, None], rows, -1)
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def _sparse(tables, ids, names) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    out = []
    for n in names:
        vals = _take_id_rows(tables[n][0], ids)
        out.append((vals, vals >= 0))
    return out


def get_dense_feature(g: GraphTensors, nodes: torch.Tensor,
                      names: Sequence[str]) -> List[torch.Tensor]:
    """Dense (float) node features; [*, dim] per name."""
    with span("gather"):
        if _is_shard_view(g):
            return _sharded().get_dense_feature_sharded(g, nodes, names)
        return [_take_rows(g.dense_nf[n], nodes) for n in names]


def get_sparse_feature(g: GraphTensors, nodes: torch.Tensor,
                       names: Sequence[str]
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Sparse (id-list) node features: (ids [*, L] padded -1, mask) per
    name (reference: feature_ops.py:44-54)."""
    if _is_shard_view(g):
        return _sharded().get_sparse_feature_sharded(g, nodes, names)
    return _sparse(g.sparse_nf, nodes, names)


def get_edge_dense_feature(g: GraphTensors, eids: torch.Tensor,
                           names: Sequence[str]) -> List[torch.Tensor]:
    """Dense edge features by original edge row; [*, dim] per name
    (reference: feature_ops.py:57-63)."""
    if _is_shard_view(g):
        return _sharded().get_edge_feature_sharded(g, eids, names, "dense")
    return [_take_rows(g.dense_ef[n], eids) for n in names]


def get_edge_sparse_feature(g: GraphTensors, eids: torch.Tensor,
                            names: Sequence[str]
                            ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Sparse edge features: (ids [*, L] padded -1, mask) per name
    (reference: feature_ops.py:66-76)."""
    if _is_shard_view(g):
        return _sharded().get_edge_feature_sharded(g, eids, names, "sparse")
    return _sparse(g.sparse_ef, eids, names)


def get_edge_type(g: GraphTensors, eids: torch.Tensor) -> torch.Tensor:
    """Edge type of each original edge row, -1 for eids < 0
    (reference: feature_ops.py:79-94). ``eid_type`` is ordered by edge
    row; the CSR's ``adj_type`` is ordered by slot and would permute
    relations."""
    if _is_shard_view(g):
        return _sharded().get_edge_type_sharded(g, eids)
    e = eids.long()
    ty = g.eid_type[e.clamp(0, g.eid_type.shape[0] - 1)]
    return torch.where(e >= 0, ty, -1).to(torch.int32)
