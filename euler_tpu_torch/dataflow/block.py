"""Mini-batch bipartite blocks with static shapes (regular fanout layout).

Counterpart of euler_tpu/dataflow/block.py for the sampled flows
(reference: tf_euler/python/dataflow/base_dataflow.py:23-52). Layered node
sets are ``N_{d+1} = concat(N_d, sampled_neighbors)`` with duplicates
allowed, so every shape is a function of (batch, fanouts); dead neighbors
carry an edge mask instead of being dropped.

A fanout block has exactly ``fanout`` sampled edges per target, laid out
contiguously (edge t*fanout+c has dst=t, src=T+t*fanout+c), optionally
followed by T self-loop edges, so aggregation is a reshape and a reduce,
the per-edge views are a slice and a broadcast, and the per-target
softmax runs over a [T, C(+1)] grid. The irregular (``fanout`` None),
ELL, shared-source and distributed (``psum_axis``) variants of the
reference wait for the slices that use them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class Block:
    n_id: torch.Tensor            # int32 [S_src] source node ids (-1 = pad)
    res_n_id: torch.Tensor        # int32 [S_dst] target positions in sources
    edge_index: torch.Tensor      # int32 [2, E_blk]
    e_id: Optional[torch.Tensor]  # int32 [E_blk] original edge rows (-1 pad)
    edge_weight: Optional[torch.Tensor]  # f32 [E_blk]
    mask: torch.Tensor            # f32 [E_blk] 1=real edge, 0=padding
    size: Tuple[int, int]
    fanout: int
    self_loops: bool = False
    # edge type per block edge (-1 for invalid draws and self loops), from
    # a typed sampling hop; RGCN's relation_from_etype reads it
    e_type: Optional[torch.Tensor] = None

    def gather_src(self, x_src: torch.Tensor) -> torch.Tensor:
        """Per-edge view of source values: x_src[edge_index[1]]."""
        T = self.size[0]
        if not self.self_loops:
            return x_src[T:]
        return torch.cat([x_src[T:], x_src[:T]])

    def gather_tgt(self, v: torch.Tensor) -> torch.Tensor:
        """Per-edge view of target values: v[edge_index[0]] (v has size[0]
        rows), a broadcast instead of a gather."""
        T, C = self.size[0], self.fanout
        tail = tuple(v.shape[1:])
        rep = v[:, None].expand((T, C) + tail).reshape((T * C,) + tail)
        return torch.cat([rep, v]) if self.self_loops else rep

    def _split(self, edge_vals: torch.Tensor):
        """(sampled [T,C,...], loop [T,...]|None) views of a [E,...] tensor."""
        T, C = self.size[0], self.fanout
        tail = tuple(edge_vals.shape[1:])
        sampled = edge_vals[:T * C].reshape((T, C) + tail)
        loop = edge_vals[T * C:] if self.self_loops else None
        return sampled, loop

    def _reduce(self, op: str, up_s, up_l, m_s, m_l):
        """Aggregate (sampled [T,C,...], loop [T,...]) with masks of the
        same leading shapes."""
        if op == "add":
            out = (up_s * m_s if m_s is not None else up_s).sum(dim=1)
            if up_l is not None:
                out = out + (up_l * m_l if m_l is not None else up_l)
            return out
        if op == "mean":
            if m_s is None:
                tot = up_s.sum(dim=1)
                cnt = float(self.fanout)
                if up_l is not None:
                    tot, cnt = tot + up_l, cnt + 1.0
                return tot / (cnt + 1e-7)             # scatter_mean parity
            tot = (up_s * m_s).sum(dim=1)
            cnt = m_s.sum(dim=1)
            if up_l is not None:
                tot = tot + up_l * m_l
                cnt = cnt + m_l
            return tot / cnt.clamp_min(1e-7)          # masked_scatter_ parity
        raise ValueError(f"aggregation {op!r} is not ported (add, mean)")

    def _split_mask(self, mask, dtype, tail_nd):
        if mask is None:
            return None, None
        return self._split(mask.to(dtype).reshape((-1,) + (1,) * tail_nd))

    def scatter(self, op: str, updates: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Aggregate per-edge updates into targets; mask drops padded
        edges."""
        up_s, up_l = self._split(updates)
        m_s, m_l = self._split_mask(mask, updates.dtype, updates.dim() - 1)
        return self._reduce(op, up_s, up_l, m_s, m_l)

    def aggregate_neighbors(self, op: str, x_src: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """``scatter(op, gather_src(x_src) * scale, mask)`` read through
        strided views of ``x_src``, without the per-edge copy. ``scale``
        is an optional per-edge multiplier ([E] or [E, 1], e.g. GAT's
        attention), taken in the dtype of ``x_src`` as the reference
        does."""
        T, C = self.size[0], self.fanout
        tail = tuple(x_src.shape[1:])
        up_s = x_src[T:].reshape((T, C) + tail)
        up_l = x_src[:T] if self.self_loops else None
        if scale is not None:
            if scale.dim() == 1:
                scale = scale[:, None]
            s_s, s_l = self._split(scale.to(x_src.dtype))
            up_s = up_s * s_s
            if up_l is not None:
                up_l = up_l * s_l
        m_s, m_l = self._split_mask(mask, x_src.dtype, x_src.dim() - 1)
        return self._reduce(op, up_s, up_l, m_s, m_l)

    def softmax(self, scores: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-target softmax of per-edge scores [E, ...]: each target's
        sampled edges and its self loop (joined as column C) share one
        softmax; masked edges get probability 0, and a target whose edges
        are all masked gets 0 on every edge, not NaN (its max is reset to
        0 and the denominator clamped at 1e-16, as the reference does)."""
        T, C = self.size[0], self.fanout
        tail = tuple(scores.shape[1:])
        s_s, s_l = self._split(scores)
        grp = s_s if s_l is None else torch.cat([s_s, s_l[:, None]], 1)
        neg = -1e30
        if mask is not None:
            m_s, m_l = self._split(mask.to(scores.dtype).reshape(
                (-1,) + (1,) * len(tail)))
            mg = m_s if m_l is None else torch.cat([m_s, m_l[:, None]], 1)
            grp = torch.where(mg > 0, grp, neg)
        mx = grp.amax(dim=1, keepdim=True)
        mx = torch.where(mx <= neg * 0.5, 0.0, mx)
        e = torch.exp(grp - mx)
        if mask is not None:
            e = torch.where(mg > 0, e, 0.0)
        p = e / e.sum(dim=1, keepdim=True).clamp_min(1e-16)
        p_s = p[:, :C].reshape((T * C,) + tail)
        return p_s if s_l is None else torch.cat([p_s, p[:, C]])


def fanout_block(targets: torch.Tensor, sampled: torch.Tensor,
                 weights: torch.Tensor, eids: torch.Tensor, count: int,
                 add_self_loops: bool = True,
                 etypes: Optional[torch.Tensor] = None) -> Block:
    """Build the block for one sampled hop.

    targets: [T] node ids of this hop's frontier.
    sampled/weights/eids: [T, count] from the sampling verb; etypes
    [T, count] the drawn edge types of a typed hop (self loops get -1).
    Sources = concat(targets, sampled.flatten()); the self-loop edges mirror
    the reference's add_self_loops in NeighborDataFlow
    (tf_euler/python/dataflow/neighbor_dataflow.py:45-76).
    """
    dev = targets.device
    T = targets.shape[0]
    flat = sampled.reshape(-1)
    n_id = torch.cat([targets, flat])
    dst = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(
        count)
    src = T + torch.arange(T * count, dtype=torch.int32, device=dev)
    tgt_ok = (targets >= 0)[:, None].expand(T, count).reshape(-1)
    mask = ((flat >= 0) & tgt_ok).to(torch.float32)
    w = weights.reshape(-1)
    e_id = eids.reshape(-1)
    e_type = None if etypes is None else etypes.reshape(-1)
    if add_self_loops:
        loop = torch.arange(T, dtype=torch.int32, device=dev)
        dst = torch.cat([dst, loop])
        src = torch.cat([src, loop])
        mask = torch.cat([mask, (targets >= 0).to(torch.float32)])
        w = torch.cat([w, torch.ones((T,), dtype=w.dtype, device=dev)])
        e_id = torch.cat([e_id, torch.full((T,), -1, dtype=torch.int32,
                                           device=dev)])
        if e_type is not None:
            e_type = torch.cat([e_type, torch.full((T,), -1,
                                                   dtype=torch.int32,
                                                   device=dev)])
    return Block(
        n_id=n_id,
        res_n_id=torch.arange(T, dtype=torch.int32, device=dev),
        edge_index=torch.stack([dst, src]),
        e_id=e_id,
        edge_weight=w,
        mask=mask,
        size=(T, int(n_id.shape[0])),
        fanout=count,
        self_loops=add_self_loops,
        e_type=e_type,
    )
