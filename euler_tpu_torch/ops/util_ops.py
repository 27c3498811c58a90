"""Utility ops: ``inflate_idx``, ``unique_gather`` and ``sparse_gather``.

Counterparts of euler_tpu/ops/util_ops.py (reference: tf_euler/ops/
util_ops.cc:22-59 InflateIdx/SparseGather and the optimizer's
unique+gather rewrite, euler/parser/optimizer.cc:91-229). Every op is
integer index arithmetic and gathers on the device: no unique count is
read on the host, so a step that a CUDA graph captures can use them.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def inflate_idx(idx: torch.Tensor) -> torch.Tensor:
    """Given ``idx`` (each position's index into a unique-value array, all
    in [0, n)), each position's slot in the inflated layout where unique
    value ``v`` holds ``count[v]`` consecutive slots in value order and
    a value's positions take them in input order (reference: InflateIdx,
    util_ops.cc:22-35); int32 [n]."""
    idx = idx.to(torch.int64)
    n = idx.shape[0]
    counts = torch.zeros(n, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    start = torch.cumsum(counts, 0) - counts
    order = torch.argsort(idx, stable=True)
    pos = torch.arange(n, dtype=torch.int64, device=idx.device)
    occ = torch.empty_like(pos).scatter_(0, order, pos - start[idx[order]])
    return (start[idx] + occ).to(torch.int32)


def unique_gather(fetch_fn: Callable[[torch.Tensor], torch.Tensor],
                  ids: torch.Tensor) -> torch.Tensor:
    """Unique-before-gather: run ``fetch_fn`` (ids -> [S, ...] rows, ids
    < 0 -> zero rows) on ``ids`` sorted, each repeat of an id replaced by
    -1, then give every original position the row of its id's first
    sorted slot (reference: util_ops.py ``unique_gather``). The rows
    equal ``fetch_fn(ids)``'s; ``fetch_fn`` reads each distinct id once.
    """
    ids = ids.to(torch.int32)
    S = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    is_new = torch.ones(S, dtype=torch.bool, device=ids.device)
    is_new[1:] = sid[1:] != sid[:-1]
    rows = fetch_fn(torch.where(is_new, sid, -1))
    pos = torch.arange(S, dtype=torch.int64, device=ids.device)
    # the first sorted slot of each run of equal ids, by a scatter-min as
    # the reference takes it (a cummax of the slots took 0.8 ms of a
    # 1.95 ms sage step at 292,864 ids on an H100)
    seg = torch.cumsum(is_new, 0) - 1
    head = torch.full_like(pos, S - 1).scatter_reduce_(0, seg, pos, "amin")
    inv = torch.empty_like(pos).scatter_(0, order, pos)
    return rows[head[seg][inv]]


def sparse_gather(gather_idx: torch.Tensor, ids: torch.Tensor,
                  mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows ``gather_idx`` of a padded sparse block (ids [N, L], mask
    [N, L]): (ids, mask) of [len(gather_idx), L], ids -1 where masked
    (reference: SparseGather, util_ops.cc:37-59). A row index < 0 gives
    an empty row. One past the block takes ``jnp.take``'s fill, as the
    reference: ids INT32_MIN (for an int32 block) and the mask true."""
    gi = gather_idx.to(torch.int64)
    n = ids.shape[0]
    r = gi.clamp(0, n - 1)
    past = (gi >= n)[:, None]
    rows = torch.where(past, torch.iinfo(ids.dtype).min, ids[r])
    m = torch.where(past, True, mask[r]) & (gi >= 0)[:, None]
    return torch.where(m, rows, -1), m
