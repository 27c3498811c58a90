"""Bipartite blocks with static shapes: regular fanout, irregular and
whole-graph ELL layouts.

Counterpart of euler_tpu/dataflow/block.py (reference: tf_euler/python/
dataflow/base_dataflow.py:23-52). Layered node sets are
``N_{d+1} = concat(N_d, sampled_neighbors)`` with duplicates allowed, so
every shape is a function of (batch, fanouts); dead neighbors carry an
edge mask instead of being dropped.

A fanout block has exactly ``fanout`` sampled edges per target, laid out
contiguously (edge t*fanout+c has dst=t, src=T+t*fanout+c), optionally
followed by T self-loop edges, so aggregation is a reshape and a reduce,
the per-edge views are a slice and a broadcast, and the per-target
softmax runs over a [T, C(+1)] grid. An irregular block (``fanout``
None, e.g. the whole graph's edge list) gathers and scatters through
``ops.mp_ops``. A whole-graph ELL block is a fanout block over every node
that also carries ``ell_tpos``: a conv may hand it the compact [N, D]
table instead of the expanded source set, and ``aggregate_neighbors``
then runs ``_ell_agg``, whose backward is a gather over the transpose
positions and never a scatter. A shared-source block (the layerwise
flows') is a fanout block whose ``fanout`` sources are one layer shared
by every target: edge t*fanout+j has dst=t and src=T+j, so the per-edge
views broadcast the layer and the source-side sums reduce over the
targets. A distributed whole-graph block (``psum_axis``, the graph
group of a ShardView; ``flows.full_graph_block_sharded``) holds one
shard's edges over the global node set: its segment reductions are
partial, and ``scatter``, ``aggregate_neighbors``, ``softmax`` and
``scatter_src_add`` complete them over the group with ``comms.psum``
(the max with ``comms.pmax``, which has no derivative: the max
aggregate cannot be differentiated there, as in the reference; the
softmax's max shift stops its gradient before the pmax).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from euler_tpu_torch.ops import mp_ops
from euler_tpu_torch.ops.ell_agg import ell_agg
from euler_tpu_torch.ops.ell_attn import (ell_gat, ell_gat_sddmm, ell_gat_tr,
                                          ell_sddmm, live_tpos, pad_heads)
from euler_tpu_torch.ops.rel_agg import rel_mean, rel_mean_tr
from euler_tpu_torch.ops.sampling import as_etypes, etype_tensor
from euler_tpu_torch.parallel import comms
from euler_tpu_torch.utils.trace import span


@dataclasses.dataclass
class Block:
    n_id: torch.Tensor            # int32 [S_src] source node ids (-1 = pad)
    res_n_id: torch.Tensor        # int32 [S_dst] target positions in sources
    edge_index: torch.Tensor      # int32 [2, E_blk]
    e_id: Optional[torch.Tensor]  # int32 [E_blk] original edge rows (-1 pad)
    edge_weight: Optional[torch.Tensor]  # f32 [E_blk]
    mask: torch.Tensor            # f32 [E_blk] 1=real edge, 0=padding
    size: Tuple[int, int]
    # regular layout marker (see the module docstring); None = irregular
    fanout: Optional[int] = None
    self_loops: bool = False
    # shared-source variant of the regular layout (layerwise blocks): edge
    # t*fanout+j connects dst=t to src=T+j, the same ``fanout`` sources
    # for every target
    shared_src: bool = False
    # edge type per block edge (-1 for invalid draws and self loops), from
    # a typed sampling hop; RGCN's relation_from_etype reads it
    e_type: Optional[torch.Tensor] = None
    # the source-side degree of each source slot [size[1]], for sym-norm
    # convs on blocks whose source slots are copies of nodes (the
    # whole-graph ELL layouts), where a per-slot count would be 1
    src_deg: Optional[torch.Tensor] = None
    # transpose positions [N, C_in] of the whole-graph ELL pack
    # (GraphTensors.ell_tpos): expand and aggregate from the compact table
    # with a scatter-free backward (ell_expand, _ell_agg below)
    ell_tpos: Optional[torch.Tensor] = None
    # the process group over which a distributed whole-graph block's
    # partial per-node results complete (a ShardView's graph group)
    psum_axis: Optional[object] = None
    # a typed whole-graph block's CSR grouped by (node, edge type) and
    # its pack (``RelBlock``): R-GCN's per-relation mean reads them
    rel: Optional["RelBlock"] = None

    @functools.cached_property
    def _edges64(self) -> torch.Tensor:
        """edge_index as int64, converted once per block for the scatters
        of the irregular layout."""
        return self.edge_index.long()

    @functools.cached_property
    def _live_tpos(self) -> torch.Tensor:
        """ell_tpos naming this block's live cells only
        (``ops.ell_attn.live_tpos``), made once a block for the layers
        that share it."""
        T = self.size[0]
        return live_tpos(self.ell_tpos, self.n_id[T:].reshape(T, -1))

    def _is_compact(self, x_src: torch.Tensor) -> bool:
        """True when x_src is the per-node [N, ...] table of a whole-graph
        ELL block rather than its expanded source set."""
        return (self.ell_tpos is not None
                and x_src.shape[0] == self.size[0] != self.size[1])

    def _expand(self, x: torch.Tensor) -> torch.Tensor:
        """Compact [N, ...] -> the expanded source set, through
        ``ell_expand``'s transpose-gather backward for 2-D tables."""
        if x.dim() == 2:
            return ell_expand(x, self.n_id, self.ell_tpos)
        ok = (self.n_id >= 0).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(ok, x[self.n_id.long().clamp_min(0)], 0)

    def source_set(self, x_src: torch.Tensor) -> torch.Tensor:
        """The block's source set [size[1], ...]: ``x_src`` itself, or
        expanded from the compact [N, ...] table of a whole-graph ELL
        block (through ``ell_expand``'s transpose-gather backward for 2-D
        tables)."""
        return self._expand(x_src) if self._is_compact(x_src) else x_src

    def gather_src(self, x_src: torch.Tensor) -> torch.Tensor:
        """Per-edge view of source values: x_src[edge_index[1]]."""
        x_src = self.source_set(x_src)
        if self.fanout is None:
            return mp_ops.gather(x_src, self._edges64[1])
        T = self.size[0]
        sampled = x_src[T:]
        if self.shared_src:
            tail = tuple(sampled.shape[1:])
            sampled = sampled[None].expand((T, self.fanout) + tail).reshape(
                (T * self.fanout,) + tail)
        if not self.self_loops:
            return sampled
        return torch.cat([sampled, x_src[:T]])

    def gather_tgt(self, v: torch.Tensor) -> torch.Tensor:
        """Per-edge view of target values: v[edge_index[0]] (v has size[0]
        rows); regular blocks broadcast instead of gathering."""
        if self.fanout is None:
            return mp_ops.gather(v, self._edges64[0])
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
        if op == "max":
            # the reference's sentinel, reset to 0 where no edge is valid
            neg = torch.finfo(up_s.dtype).min
            vals = torch.where(m_s > 0, up_s, neg) if m_s is not None \
                else up_s
            out = vals.amax(dim=1)
            if up_l is not None:
                lv = torch.where(m_l > 0, up_l, neg) if m_l is not None \
                    else up_l
                out = torch.maximum(out, lv)
            return torch.where(out <= neg * 0.5, 0.0, out)
        raise ValueError(f"aggregation {op!r} (add, mean, max)")

    def _split_mask(self, mask, dtype, tail_nd):
        if mask is None:
            return None, None
        return self._split(mask.to(dtype).reshape((-1,) + (1,) * tail_nd))

    def _raw_max(self, vals: torch.Tensor, idx: torch.Tensor,
                 size: int) -> torch.Tensor:
        """Segment max with -inf in empty segments (jax's segment_max)."""
        full = idx.reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
        out = vals.new_full((size,) + tuple(vals.shape[1:]), float("-inf"))
        return out.scatter_reduce(0, full, vals, "amax")

    def _psum_scatter(self, op: str, updates: torch.Tensor,
                      mask: Optional[torch.Tensor]) -> torch.Tensor:
        """``scatter`` of a distributed block (block.py:176-209): the
        partial reductions of this shard's edges, completed over
        ``psum_axis``."""
        ax, dst, T = self.psum_axis, self._edges64[0], self.size[0]
        tail = (1,) * (updates.dim() - 1)
        if op == "add":
            return comms.psum(mp_ops.masked_scatter_(
                "add", updates, dst, T, mask), ax)
        if op == "mean":
            m = (updates.new_ones((updates.shape[0],)) if mask is None
                 else mask.to(updates.dtype))
            tot = comms.psum(mp_ops.scatter_add(
                updates * m.reshape((-1,) + tail), dst, T), ax)
            cnt = comms.psum(mp_ops.scatter_add(m[:, None], dst, T), ax)
            return tot / cnt.reshape((T,) + tail).clamp_min(1e-7)
        if op == "max":
            neg = torch.finfo(updates.dtype).min
            up = updates if mask is None else torch.where(
                mask.reshape((-1,) + tail) > 0, updates, neg)
            glob = comms.pmax(self._raw_max(up, dst, T), ax)
            return torch.where(glob <= neg * 0.5, 0.0, glob)
        raise ValueError(f"aggregation {op!r} (add, mean, max)")

    def scatter(self, op: str, updates: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Aggregate per-edge updates into targets (a segment reduction
        over edge_index[0] into size[0] rows); mask drops padded edges."""
        if self.psum_axis is not None:
            return self._psum_scatter(op, updates, mask)
        if self.fanout is None:
            return mp_ops.masked_scatter_(op, updates, self._edges64[0],
                                          self.size[0], mask)
        up_s, up_l = self._split(updates)
        m_s, m_l = self._split_mask(mask, updates.dtype, updates.dim() - 1)
        return self._reduce(op, up_s, up_l, m_s, m_l)

    def aggregate_neighbors(self, op: str, x_src: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """``scatter(op, gather_src(x_src) * scale, mask)``. Regular
        blocks read strided views of ``x_src`` without the per-edge copy;
        a shared-source block sums add and mean of a 2-D ``x_src`` as one
        product with its layer (``_shared_aggregate``); a compact table of
        a whole-graph ELL block goes through ``_ell_agg`` for add and
        mean with no scale or a one-head scale. ``scale`` is an optional
        per-edge multiplier ([E] or [E, 1], e.g. GCN's sym-norm or GAT's
        attention), taken in the dtype of ``x_src`` as the reference does.
        A scale [E, H] with H > 1 is one a head: it multiplies the H equal
        segments of each row (multi-head attention); a compact table is
        expanded for it and takes the path of the other blocks (multi-head
        GAT over an ELL block with self loops runs fused instead,
        ``gat_attention``)."""
        if scale is not None and scale.dim() == 1:
            scale = scale[:, None]
        heads = 1 if scale is None else scale.shape[1]
        if self._is_compact(x_src):
            if op in ("add", "mean") and x_src.dim() == 2 and heads == 1:
                return self._ell_aggregate(op, x_src, mask, scale)
            x_src = self._expand(x_src)
        if self.fanout is None:
            xj = mp_ops.gather(x_src, self._edges64[1])
            if scale is not None:
                xj = _scaled(xj, scale.to(xj.dtype))
            if self.psum_axis is not None:
                return self._psum_scatter(op, xj, mask)
            return mp_ops.masked_scatter_(op, xj, self._edges64[0],
                                          self.size[0], mask)
        if self.shared_src and op in ("add", "mean") and x_src.dim() == 2 \
                and heads == 1:
            return self._shared_aggregate(op, x_src, mask, scale)
        T, C = self.size[0], self.fanout
        tail = tuple(x_src.shape[1:])
        if self.shared_src:
            up_s = x_src[T:][None].expand((T, C) + tail)
        else:
            up_s = x_src[T:].reshape((T, C) + tail)
        up_l = x_src[:T] if self.self_loops else None
        if scale is not None:
            s_s, s_l = self._split(scale.to(x_src.dtype))
            up_s = _scaled(up_s, s_s)
            if up_l is not None:
                up_l = _scaled(up_l, s_l)
        m_s, m_l = self._split_mask(mask, x_src.dtype, x_src.dim() - 1)
        return self._reduce(op, up_s, up_l, m_s, m_l)

    def _shared_aggregate(self, op: str, x_src: torch.Tensor, mask,
                          scale) -> torch.Tensor:
        """add or mean over a shared-source block as one product: the
        per-edge weights (scale times mask, in the dtype of ``x_src``)
        [T, C] times the shared layer [C, D], plus the self loops; never
        the [T, C, D] broadcast. The mean divides as ``_reduce`` does."""
        T, C = self.size[0], self.fanout
        dt = x_src.dtype
        w = torch.ones((self.edge_index.shape[1],), dtype=dt,
                       device=x_src.device)
        if scale is not None:
            w = w * scale.reshape(-1).to(dt)
        if mask is not None:
            w = w * mask.to(dt)
        out = w[:T * C].reshape(T, C) @ x_src[T:]
        if self.self_loops:
            out = out + x_src[:T] * w[T * C:, None]
        if op == "add":
            return out
        if mask is None:
            return out / (float(C) + (1.0 if self.self_loops else 0.0)
                          + 1e-7)
        cnt = mask[:T * C].reshape(T, C).to(dt).sum(dim=1)
        if self.self_loops:
            cnt = cnt + mask[T * C:].to(dt)
        return out / cnt.clamp_min(1e-7)[:, None]

    def ell_weights(self, mask: Optional[torch.Tensor] = None,
                    scale: Optional[torch.Tensor] = None):
        """The arguments ``_ell_agg`` takes from this whole-graph ELL
        block besides the table: (w_s f32 [T, C], w_l f32 [T], nbr
        [T, C]), the mask and the per-edge scale ([E] or [E, 1], one
        head) folded into the weights (w_l is 0 without self loops)."""
        T, C = self.size[0], self.fanout
        eff = torch.ones((self.edge_index.shape[1],), dtype=torch.float32,
                         device=self.n_id.device)
        if scale is not None:
            eff = eff * scale.reshape(-1).to(torch.float32)
        if mask is not None:
            eff = eff * mask.to(torch.float32)
        w_l = eff[T * C:] if self.self_loops else torch.zeros(
            (T,), dtype=torch.float32, device=eff.device)
        return eff[:T * C].reshape(T, C), w_l, self.n_id[T:].reshape(T, C)

    def _ell_aggregate(self, op: str, x: torch.Tensor, mask, scale
                       ) -> torch.Tensor:
        """add or mean straight from the compact [N, D] table through
        ``_ell_agg``. The mean divides by C (+1) + 1e-7 without a mask and
        by the valid count (at least 1e-7) with one, as the other layouts
        do."""
        T, C = self.size[0], self.fanout
        out = _ell_agg(C, x, *self.ell_weights(mask, scale), self.ell_tpos)
        if op == "add":
            return out
        if mask is None:
            cnt = float(C) + (1.0 if self.self_loops else 0.0)
            return out / (cnt + 1e-7)
        cnt = mask[:T * C].reshape(T, C).sum(dim=1)
        if self.self_loops:
            cnt = cnt + mask[T * C:]
        return out / cnt.clamp_min(1e-7)[:, None].to(out.dtype)

    def fuses_gat(self, x_src: torch.Tensor) -> bool:
        """True where ``gat_attention`` takes GAT's attention over this
        block: x_src the compact f32 or bf16 [N, D] table of a whole-graph
        ELL block with self loops, whose mask is its live cells (as
        ``fanout_block`` builds it)."""
        return (self._is_compact(x_src) and self.self_loops
                and x_src.dim() == 2
                and x_src.dtype in (torch.float32, torch.bfloat16))

    def gat_attention(self, z: torch.Tensor, xs: torch.Tensor,
                      w: torch.Tensor, attn_l: torch.Tensor,
                      attn_r: torch.Tensor, dtype: torch.dtype
                      ) -> torch.Tensor:
        """Multi-head GAT's attention over this block (only where
        ``fuses_gat``), fused into the attention kernels (``_EllGat``),
        from fc's input xs [N, D_in], its weight w [H * F, D_in] and output
        z = xs w^T [N, H * F], and a_l, a_r [H, F]:

            el = xs (W_h^T a_l[h]), er = xs (W_h^T a_r[h])    [N, H], f32
            s  = leaky_relu_0.2(el[t] + er[nbr[t, c]])  (el[t] + er[t]:
                 the self loop), p its softmax over the row's live cells
                 and the self loop, a head at a time
            out[t, h] = sum over c of z[nbr[t, c], h] p + z[t, h] p_self

        with z read in ``dtype`` and summed in f32, [N, H * F] in
        ``dtype``; no [E, H] tensor is built. The backward gives z's
        gradient in f32 with el's and er's terms routed into it (d_el[u,
        h] a_l[h] + d_er[u, h] a_r[h]), so that fc's backward carries them
        to w and xs; a_l's and a_r's gradients are W_h (xs^T d_el[:, h])
        and W_h (xs^T d_er[:, h]). xs and w take no gradient here beyond
        z's."""
        T, C = self.size[0], self.fanout
        return _EllGat.apply(z, xs, w, attn_l, attn_r,
                             self.n_id[T:].reshape(T, C), self._live_tpos,
                             dtype)

    def relation_mean(self, x: torch.Tensor, matrix: torch.Tensor,
                      root_w: torch.Tensor, root_b: torch.Tensor,
                      type_lo: Sequence[int], dtype: torch.dtype
                      ) -> torch.Tensor:
        """R-GCN's layer over a typed whole-graph block (``rel``), from the
        node table x [N, D_in]: for node t of type k (ids [type_lo[k],
        type_lo[k + 1])),

            out[t] = root_w[k] x_t + root_b[k]
                     + sum over edge types r taken, with c(t, r) > 0, of
                       matrix[r] (1 / c(t, r) sum over t's out-neighbours
                       j of type r of x_j)

        [N, F] f32, through ``_RelConv``: W_r x_j is taken once a
        neighbour (a GEMM over the ids its edge type's neighbours lie in,
        one with the root's rows where those ids are a node type's), in
        f32 with x cast up, the messages rounded to ``dtype``; then the
        typed mean kernel (``ops.rel_agg``) sums them with the roots. No
        [E, F] tensor is built."""
        return _RelConv.apply(x, matrix, root_w, root_b, self.rel,
                              tuple(type_lo), dtype)

    def softmax(self, scores: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-target softmax of per-edge scores [E, ...]: each target's
        sampled edges and its self loop (joined as column C) share one
        softmax; masked edges get probability 0, and a target whose edges
        are all masked gets 0 on every edge, not NaN (its max is reset to
        0 and the denominator clamped at 1e-16, as the reference does).
        Irregular blocks run ``mp_ops.masked_scatter_softmax``; a
        distributed one completes its max and its sums over
        ``psum_axis`` (block.py:286-306)."""
        if self.psum_axis is not None:
            ax, dst, T = self.psum_axis, self._edges64[0], self.size[0]
            neg = -1e30
            tail = (1,) * (scores.dim() - 1)
            z = scores if mask is None else torch.where(
                mask.reshape((-1,) + tail) > 0, scores, neg)
            # the max shift only steadies the exponent: its gradient
            # cancels, and pmax has none, so it stops before the pmax
            mx = comms.pmax(self._raw_max(z.detach(), dst, T), ax)
            mx = torch.where(mx <= neg * 0.5, 0.0, mx)
            e = torch.exp(z - mp_ops.gather(mx, dst))
            if mask is not None:
                e = torch.where(mask.reshape((-1,) + tail) > 0, e, 0.0)
            denom = comms.psum(mp_ops.scatter_add(e, dst, T), ax)
            return e / mp_ops.gather(denom, dst).clamp_min(1e-16)
        if self.fanout is None:
            return mp_ops.masked_scatter_softmax(scores, self._edges64[0],
                                                 self.size[0], mask)
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

    def scatter_src_add(self, updates: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Segment sum over edge_index[1] into the source set (size[1]
        rows); sym-norm convs read source-side degrees from it."""
        if mask is not None:
            updates = updates * mask.reshape(
                (-1,) + (1,) * (updates.dim() - 1)).to(updates.dtype)
        if self.fanout is None:
            out = mp_ops.scatter_add(updates, self._edges64[1],
                                     self.size[1])
            if self.psum_axis is not None:
                out = comms.psum(out, self.psum_axis)
            return out
        T, C = self.size[0], self.fanout
        tail = tuple(updates.shape[1:])
        if self.shared_src:
            # one source column per layer node, summed over the targets
            sampled = updates[:T * C].reshape((T, C) + tail).sum(dim=0)
        else:
            sampled = updates[:T * C]                    # slots T.. are 1:1
        if self.self_loops:
            head = updates[T * C:]
        else:
            head = updates.new_zeros((T,) + tail)
        return torch.cat([head, sampled])


def _scaled(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [..., D] times s [..., H]: the whole row where H is 1, else each of
    the row's H equal segments by its own column of s."""
    H = s.shape[-1]
    if H == 1:
        return x * s
    lead = tuple(x.shape[:-1])
    return (x.reshape(lead + (H, -1)) * s[..., None]).reshape(x.shape)


class _EllExpand(torch.autograd.Function):
    """euler_tpu/dataflow/block.py ``ell_expand`` (:367-393)."""

    @staticmethod
    def forward(ctx, x, n_id, tpos):
        ctx.save_for_backward(tpos)
        ctx.n = x.shape[0]
        ok = (n_id >= 0)[:, None]
        return torch.where(ok, x[n_id.long().clamp_min(0)], 0)

    @staticmethod
    def backward(ctx, g):
        (tpos,) = ctx.saved_tensors
        n = ctx.n
        rows = g[n:][tpos.long().clamp_min(0)]                # [N, C_in, D]
        rows = torch.where((tpos >= 0)[..., None], rows, 0)
        return g[:n] + rows.sum(dim=1).to(g.dtype), None, None


def ell_expand(x: torch.Tensor, n_id: torch.Tensor,
               tpos: torch.Tensor) -> torch.Tensor:
    """Expand a per-node [N, D] table into a whole-graph ELL block's
    source set ``concat(x, x[nbr_flat])`` (``n_id = concat(arange(N),
    nbr_flat)``, -1 rows 0), with the transpose adjacency driving the
    backward:

        grad_x[u] = g[u] + sum over c of g[N + tpos[u, c]]

    a gather over the precomputed transpose positions instead of the
    scatter-add that autograd gives a plain gather (pads -1 add 0)."""
    return _EllExpand.apply(x, n_id, tpos)


class _EllAgg(torch.autograd.Function):
    """euler_tpu/dataflow/block.py ``_ell_agg`` (:399-443) and its VJP.
    The forward and the gradient to x are ``ops.ell_agg`` (the CUDA
    kernel on the card, its plain version on the CPU), forward and
    transpose; ``grad_w_s`` is ``ops.ell_sddmm`` with one head. None of
    them builds the [N, C, D] rows on the card. Saves x, not the rows.
    Each gradient is computed only where its input asks for one
    (``needs_input_grad``)."""

    @staticmethod
    def forward(ctx, C, x, w_s, w_l, nbr, tpos):
        ctx.save_for_backward(x, w_s, w_l, nbr, tpos)
        ctx.C = C
        return ell_agg(x.contiguous(), nbr, w_s, w_l, C, False)

    @staticmethod
    def backward(ctx, g):
        x, w_s, w_l, nbr, tpos = ctx.saved_tensors
        need_x, need_ws, need_wl = ctx.needs_input_grad[1:4]
        grad_x = grad_ws = grad_wl = None
        if need_x:
            grad_x = ell_agg(g.contiguous(), tpos, w_s, w_l, ctx.C,
                             True).to(x.dtype)
        if need_ws:
            grad_ws = ell_sddmm(pad_heads(g.contiguous(), 1, x.dtype),
                                pad_heads(x, 1), nbr, False)[0]
            grad_ws = grad_ws.reshape(w_s.shape).to(w_s.dtype)
        if need_wl:
            grad_wl = torch.einsum("td,td->t", g.float(),
                                   x.float()).to(w_l.dtype)
        return None, grad_x, grad_ws, grad_wl, None, None


def _ell_agg(C: int, x: torch.Tensor, w_s: torch.Tensor, w_l: torch.Tensor,
             nbr: torch.Tensor, tpos: torch.Tensor) -> torch.Tensor:
    """Fused whole-graph ELL aggregate from the compact [N, D] table:

        out[t] = sum over c of x[nbr[t, c]] * w_s[t, c]  +  x[t] * w_l[t]

    (pads nbr = -1 read 0). Its backward gathers only from [N, ...]
    arrays, never scatters:

        grad_x[u]   = sum over cells p = tpos[u, c] of g[p // C] * w_s[p]
                      + g[u] * w_l[u]
        grad_w_s    = g[t] . x[nbr[t, c]]   (f32)
        grad_w_l    = g[t] . x[t]           (f32)
    """
    return _EllAgg.apply(C, x, w_s, w_l, nbr, tpos)


class _EllGat(torch.autograd.Function):
    """``Block.gat_attention``: GAT's attention fused into the ELL
    attention kernels (``ops.ell_attn.ell_gat``, ``ell_gat_sddmm``,
    ``ell_gat_tr``; tpos of the live cells). Saves the padded rows, el,
    er and lse [N, H], never an [E, H] tensor; the backward runs in the
    span ``attention.backward``."""

    @staticmethod
    def forward(ctx, z, xs, w, attn_l, attn_r, nbr, tpos, dtype):
        H, F = attn_l.shape
        wh = w.reshape(H, F, -1)
        a = torch.cat([torch.einsum("hfd,hf->dh", wh, attn_l),
                       torch.einsum("hfd,hf->dh", wh, attn_r)], 1)
        e = xs @ a                                          # [N, 2H]
        el, er = e[:, :H].contiguous(), e[:, H:].contiguous()
        xp = pad_heads(z, H, dtype)
        out, lse = ell_gat(xp, nbr, el, er, F)
        ctx.save_for_backward(xp, el, er, lse, nbr, tpos, attn_l, attn_r,
                              xs, w)
        ctx.z_dtype = z.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        with span("attention.backward"):
            xp, el, er, lse, nbr, tpos, a_l, a_r, xs, w = ctx.saved_tensors
            H, F = a_l.shape
            gp = pad_heads(g.contiguous(), H, xp.dtype)
            de, de_self, d_el = ell_gat_sddmm(gp, xp, nbr, el, er, lse)
            d_z, d_er = ell_gat_tr(gp, tpos, nbr, el, er, lse, de, de_self,
                                   d_el, a_l, a_r, F)
            d_al = d_ar = None
            if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
                # a . z's gradient to a over the z rows that fc makes from xs
                v = xs.T @ torch.cat([d_el, d_er], 1)       # [D_in, 2H]
                wh = w.reshape(H, F, -1)
                d_al = torch.einsum("hfd,dh->hf", wh, v[:, :H])
                d_ar = torch.einsum("hfd,dh->hf", wh, v[:, H:])
        return (d_z.to(ctx.z_dtype), None, None, d_al, d_ar, None, None,
                None)


@dataclasses.dataclass
class RelBlock:
    """What a typed whole-graph block carries for R-GCN's per-relation
    mean: the graph's CSR grouped by (node, edge type), ``seg_ptr``
    (``GraphTensors.group_ptr``) and ``cells`` (``adj_dst``, each cell's
    neighbour), its ``graph.store.RelPack``, and ``mask``, bit r set for
    each edge type r the flow's metapath takes."""

    seg_ptr: torch.Tensor
    cells: torch.Tensor
    pack: object
    mask: int

    def plan(self, type_lo: Sequence[int]) -> List[tuple]:
        """The GEMMs of a layer: (lo, hi, edge types, root type or -1), one
        a row range [lo, hi): each taken edge type's neighbours' ids
        (``RelPack.row_lo``/``row_hi``), edge types of one range together,
        and node type k's root rows [type_lo[k], type_lo[k + 1]) with the
        edge types of that range or alone."""
        p = self.pack
        groups: dict = {}
        for r, (lo, hi) in enumerate(zip(p.row_lo, p.row_hi)):
            if hi > lo and (self.mask >> r) & 1:
                groups.setdefault((lo, hi), []).append(r)
        roots = {(type_lo[k], type_lo[k + 1]): k
                 for k in range(len(type_lo) - 1)}
        out = [(lo, hi, tuple(rels), roots.pop((lo, hi), -1))
               for (lo, hi), rels in groups.items()]
        return out + [(lo, hi, (), k) for (lo, hi), k in roots.items()]


class _RelConv(torch.autograd.Function):
    """``Block.relation_mean``: one GEMM a row range of the plan
    (``RelBlock.plan``) makes each edge type's messages W_r x_j and the
    roots, the typed mean kernel sums them (``ops.rel_agg.rel_mean``).
    Saves x and the weights, never the messages. The backward runs in the
    span ``relation.backward``: the cotangent rounded to the messages'
    type, the transposed kernel (``rel_mean_tr``) gives each range's
    messages' f32 gradient, the root columns take the cotangent itself,
    and one GEMM a range each gives the weights' and x's gradients."""

    @staticmethod
    def _weights(matrix, root_w, rels, k):
        return torch.cat([matrix[r] for r in rels]
                         + ([root_w[k]] if k >= 0 else []))

    @staticmethod
    def forward(ctx, x, matrix, root_w, root_b, rel, type_lo, dtype):
        R, F = matrix.shape[0], matrix.shape[1]
        plan = rel.plan(type_lo)
        msgs: List[Optional[torch.Tensor]] = [None] * R
        roots: List[Optional[torch.Tensor]] = [None] * (len(type_lo) - 1)
        for lo, hi, rels, k in plan:
            w = _RelConv._weights(matrix, root_w, rels, k)
            xf = x[lo:hi].to(matrix.dtype)
            if k >= 0:
                b = torch.cat([root_b.new_zeros(len(rels) * F), root_b[k]])
                z = torch.addmm(b, xf, w.T)
            else:
                z = xf @ w.T
            m = z[:, :len(rels) * F].to(dtype)
            for q, r in enumerate(rels):
                msgs[r] = m[:, q * F:(q + 1) * F]
            if k >= 0:
                roots[k] = z[:, len(rels) * F:]
        p = rel.pack
        out = rel_mean(msgs, p.row_lo, rel.seg_ptr, rel.cells, roots,
                       type_lo, rel.mask, p.hubs)
        ctx.save_for_backward(x, matrix, root_w)
        ctx.rel, ctx.plan, ctx.dtype = rel, plan, dtype
        return out

    @staticmethod
    def backward(ctx, g):
        with span("relation.backward"):
            x, matrix, root_w = ctx.saved_tensors
            F = matrix.shape[1]
            p = ctx.rel.pack
            g = g.contiguous()
            d_msgs: List[Optional[torch.Tensor]] = [None] * matrix.shape[0]
            dzs = []
            for lo, hi, rels, k in ctx.plan:
                dz = torch.empty((hi - lo, (len(rels) + (k >= 0)) * F),
                                 dtype=torch.float32, device=g.device)
                for q, r in enumerate(rels):
                    d_msgs[r] = dz[:, q * F:(q + 1) * F]
                if k >= 0:
                    dz[:, len(rels) * F:] = g[lo:hi]
                dzs.append(dz)
            rel_mean_tr(g.to(ctx.dtype).contiguous(), p.tptr, p.tsrc, p.tw,
                        d_msgs, p.row_lo, ctx.rel.mask, p.tr_hubs)
            d_matrix = torch.zeros_like(matrix)
            d_root_w = torch.zeros_like(root_w)
            d_root_b = root_w.new_zeros(root_w.shape[:2])
            need_x = ctx.needs_input_grad[0]
            dx = torch.zeros(x.shape, dtype=matrix.dtype,
                             device=x.device) if need_x else None
            for (lo, hi, rels, k), dz in zip(ctx.plan, dzs):
                xf = x[lo:hi].to(matrix.dtype)
                dw = dz.T @ xf
                for q, r in enumerate(rels):
                    d_matrix[r] = dw[q * F:(q + 1) * F]
                if k >= 0:
                    d_root_w[k] = dw[len(rels) * F:]
                    d_root_b[k] = g[lo:hi].sum(0)
                if need_x:
                    dx[lo:hi].addmm_(dz, _RelConv._weights(matrix, root_w,
                                                           rels, k))
        return (None if dx is None else dx.to(x.dtype), d_matrix, d_root_w,
                d_root_b, None, None, None)


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


def full_graph_block(g, edge_types, add_self_loops: bool = True) -> Block:
    """Whole-graph edge-list block: every stored edge, masked to the
    requested types, messages flowing from each edge's destination (the
    source slot) into its source (the target), as GetFullNeighbor
    aggregates out-neighbors; then N self loops.

    reference: euler_tpu/dataflow/block.py ``full_graph_block``
    (tf_euler/python/dataflow/whole_dataflow.py:26-63)."""
    ets = etype_tensor(as_etypes(g, edge_types), torch.int32, g.device)
    n = g.meta.n_nodes
    dev = g.device
    mask = torch.isin(g.adj_type, ets).to(torch.float32)
    dst, src, e_id, w = g.adj_src, g.adj_dst, g.adj_eid, g.adj_w
    if add_self_loops:
        loop = torch.arange(n, dtype=torch.int32, device=dev)
        dst = torch.cat([dst, loop])
        src = torch.cat([src, loop])
        mask = torch.cat([mask, torch.ones((n,), dtype=torch.float32,
                                           device=dev)])
        w = torch.cat([w, torch.ones((n,), dtype=w.dtype, device=dev)])
        e_id = torch.cat([e_id, torch.full((n,), -1, dtype=torch.int32,
                                           device=dev)])
    all_nodes = torch.arange(n, dtype=torch.int32, device=dev)
    return Block(n_id=all_nodes, res_n_id=all_nodes,
                 edge_index=torch.stack([dst, src]), e_id=e_id,
                 edge_weight=w, mask=mask, size=(n, n))
