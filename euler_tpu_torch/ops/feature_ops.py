"""Dense node-feature lookup.

Counterpart of euler_tpu/ops/feature_ops.py ``_take_rows`` and
``get_dense_feature`` (reference: tf_euler feature_ops.py:126). Row i is
the feature row of ``nodes[i]``, zeros for ids < 0 (padding) and NaN for
ids >= N, as the reference's ``jnp.take`` (which fills an out-of-range
row with NaN) and its ``where`` give. The gather is ``gather_rows``: the
CUDA kernel for CUDA tensors, its plain version for CPU tensors.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.ops.gather_rows import gather_rows


def _take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table`` f32/bf16 [N, D] rows of ``ids`` (any shape) -> [*ids, D]."""
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    rows = gather_rows(table, flat)
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def get_dense_feature(g: GraphTensors, nodes: torch.Tensor,
                      names: Sequence[str]) -> List[torch.Tensor]:
    """Dense (float) node features; [*, dim] per name."""
    return [_take_rows(g.dense_nf[n], nodes) for n in names]
