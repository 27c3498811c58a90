"""Random walks and skip-gram pair generation.

Counterpart of euler_tpu/ops/walk.py (reference: tf_euler/kernels/
random_walk_op.cc:34-140 and gen_pair_op.cc:28-96): ``random_walk`` with
its three step kinds (the unbiased weighted draw, node2vec's exact
reweighting by Gumbel-max over windows of the neighborhood, and
node2vec's rejection sampling), per-step edge types, the membership
test ``_is_neighbor`` (from the owner over a ShardView),
``check_bias_cap`` and ``gen_pair``. As every
random verb of the port, the walk is split in two: ``draw_walk_uniforms``
draws every step's uniforms from a torch.Generator in the order the
reference's key chain consumes them, and ``select_walk`` walks from given
uniforms. Nothing reads the card from the host, so a captured step can
walk.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.ops import sampling
from euler_tpu_torch.ops.dispatch import is_shard_view as _is_shard_view
from euler_tpu_torch.ops.sampling import (SEARCH_STEPS, as_etypes,
                                          draw_gumbel_uniforms,
                                          draw_sample_uniforms, gumbel)

#: tries of a rejection step before it takes its last candidate
REJECT_TRIES = 8


def _is_neighbor(g: GraphTensors, src: torch.Tensor, etypes,
                 cand: torch.Tensor) -> torch.Tensor:
    """Whether ``cand`` is a neighbor of ``src`` under any of ``etypes``
    (same shapes): the reference's 32 halving steps over each (src,
    type) group, whose neighbors are sorted by id (walk.py:31-59); over
    a ShardView, from src's owner (walk.py:38)."""
    if _is_shard_view(g):
        from euler_tpu_torch.parallel import sharded
        return sharded.is_neighbor_sharded(g, src, etypes, cand)
    E = g.adj_dst.shape[0]
    found = torch.zeros(src.shape, dtype=torch.bool, device=src.device)
    for t in etypes:
        lo0, hi0 = sampling._group_bounds(g, src, torch.full_like(src, t))
        lo, hi = lo0.long(), hi0.long()
        for _ in range(SEARCH_STEPS):
            mid = (lo + hi) // 2
            active = lo < hi
            right = active & (g.adj_dst[mid.clamp(0, E - 1)] < cand)
            lo, hi = (torch.where(right, mid + 1, lo),
                      torch.where(active & ~right, mid, hi))
        hit = ((lo < hi0) & (lo >= lo0)
               & (g.adj_dst[lo.clamp(0, E - 1)] == cand))
        found = found | hit
    return found


def _per_step(g: GraphTensors, edge_types, walk_len: int) -> List[tuple]:
    """The edge types of each step: one tuple for every step, or a list
    of ``walk_len`` tuples."""
    if edge_types and isinstance(edge_types, list) and \
            isinstance(edge_types[0], (list, tuple)):
        if len(edge_types) != walk_len:
            raise ValueError("per-step edge_types must have len == walk_len")
        return [as_etypes(g, e) for e in edge_types]
    return [as_etypes(g, edge_types)] * walk_len


def _biased(p: float, q: float) -> bool:
    return not (p == 1.0 and q == 1.0)


def draw_walk_uniforms(generator: Optional[torch.Generator], B: int,
                       walk_len: int, p: float = 1.0, q: float = 1.0,
                       exact: bool = True, bias_cap: int = 64,
                       bias_windows: int = 1, device=None,
                       g=None) -> list:
    """One entry per step of a walk from B nodes, in the order the
    reference's key chain draws them (each step's key ``sub``); over a
    ShardView ``g`` each neighbor draw's for the rows the owner answers
    (``sampling.neighbor_rows``):

    - unbiased (p = q = 1): ``draw_sample_uniforms`` of one draw a node,
      (u_type, u1, u2) each [B, 1];
    - exact node2vec: the Gumbel keys of each window, a tuple of
      ``bias_windows`` [B, bias_cap] tensors in [1e-20, 1);
    - rejection node2vec: per try, (u_type, u1, u2) [B, 1] and the
      acceptance uniform [B], a tuple of REJECT_TRIES such tuples.
    """
    out, R = [], sampling.neighbor_rows(g, B)
    for _ in range(walk_len):
        if not _biased(p, q):
            out.append(draw_sample_uniforms(generator, R, 1, device))
        elif exact:
            out.append(tuple(draw_gumbel_uniforms(generator, (B, bias_cap),
                                                  device)
                             for _ in range(bias_windows)))
        else:
            out.append(tuple(
                draw_sample_uniforms(generator, R, 1, device)
                + (torch.rand((B,), generator=generator, device=device),)
                for _ in range(REJECT_TRIES)))
    return out


def _node2vec_factor(p: float, q: float, is_prev: torch.Tensor,
                     in_prev_nbrs: torch.Tensor) -> torch.Tensor:
    """m(c) = 1/p where c is the previous node, 1 where c neighbors it,
    1/q otherwise, in f32 (the reference's weak-typed constants)."""
    return torch.where(is_prev, 1.0 / p,
                       torch.where(in_prev_nbrs, 1.0, 1.0 / q))


def exact_keys(g: GraphTensors, cur: torch.Tensor, prev: torch.Tensor,
               ets: Tuple[int, ...], p: float, q: float, default_id: int,
               bias_cap: int, win: int, u: torch.Tensor):
    """The neighbors of window ``win`` of an exact node2vec step from
    ``cur`` (after ``prev``, -1 for none) and their Gumbel-max keys
    log(w * m) + Gumbel(u), -inf where no neighbor: (nbr int32, keys
    f32), each [B, bias_cap] (reference: walk.py:120-137)."""
    nbr, w, _, _, ok = sampling.get_full_neighbor(
        g, cur, ets, bias_cap, default_id, offset=win * bias_cap)
    has_prev = (prev >= 0)[:, None]
    prev_b = prev[:, None].expand_as(nbr)
    is_prev = (nbr == prev_b) & has_prev
    in_pn = _is_neighbor(g, prev_b.clamp_min(0), ets, nbr) & has_prev
    m = torch.where(has_prev, _node2vec_factor(p, q, is_prev, in_pn), 1.0)
    score = torch.where(ok & (w > 0),
                        torch.log(w.clamp_min(1e-30)) + torch.log(m),
                        float("-inf"))
    return nbr, torch.where(torch.isfinite(score), score + gumbel(u),
                            float("-inf"))


def _exact_step(g, cur, prev, ets, p, q, default_id, bias_cap, keys):
    """One exact node2vec step: the running argmax (first maximum) of
    ``exact_keys`` over the windows picks the next node."""
    B = cur.shape[0]
    best = torch.full((B,), float("-inf"), device=cur.device)
    nxt = torch.full((B,), default_id, dtype=torch.int32, device=cur.device)
    for win, u in enumerate(keys):
        nbr, sc = exact_keys(g, cur, prev, ets, p, q, default_id, bias_cap,
                             win, u)
        # torch.max names the first maximum, as jnp.argmax
        val, pick = sc.max(dim=1)
        better = val > best
        nxt = torch.where(better,
                          torch.gather(nbr, 1, pick[:, None])[:, 0], nxt)
        best = torch.maximum(best, val)
    return nxt


def _rejection_step(g, cur, prev, ets, p, q, default_id, tries):
    """One node2vec step by rejection: a weighted candidate, accepted
    with probability m(c) / max(m); the last try takes its candidate."""
    B = cur.shape[0]
    # max(m) rounded to f32 first: the quotient is then f32 / f32
    max_m = float(np.float32(max(1.0 / p, 1.0, 1.0 / q)))
    chosen = torch.full((B,), default_id, dtype=torch.int32,
                        device=cur.device)
    done = torch.zeros((B,), dtype=torch.bool, device=cur.device)
    for t, (u_type, u1, u2, ua) in enumerate(tries):
        cand = sampling.select_sampled_neighbors(
            g, cur, ets, u_type, u1, u2, default_id)[0][:, 0]
        in_pn = _is_neighbor(g, prev.clamp_min(0), ets, cand) & (prev >= 0)
        m = _node2vec_factor(p, q, cand == prev, in_pn)
        accept = (ua < m / max_m) | (prev < 0)
        take = ~done & (accept | (t == len(tries) - 1)) & (cand >= 0)
        chosen = torch.where(take, cand, chosen)
        done = done | take | (cand < 0)
    return chosen


def select_walk(g: GraphTensors, nodes: torch.Tensor, edge_types,
                walk_len: int, uniforms: Sequence, p: float = 1.0,
                q: float = 1.0, default_id: int = -1, exact: bool = True,
                bias_cap: int = 64) -> torch.Tensor:
    """Walk ``walk_len`` steps from each node from the uniforms
    ``draw_walk_uniforms`` gives (reference: walk.py:62-170); int32
    [B, walk_len + 1], the nodes first. A walk that reaches a node
    without neighbors (or starts at -1) gives ``default_id`` from there
    on. With p = q = 1 a step is ``select_sampled_neighbors``' draw;
    otherwise node2vec's: with ``exact`` the reweighted Gumbel-max over
    the first ``bias_cap * bias_windows`` neighbors (``bias_windows`` is
    the number of key tensors a step holds; see ``check_bias_cap``),
    else rejection sampling."""
    cur = nodes.to(torch.int32).reshape(-1)
    per_step = _per_step(g, edge_types, walk_len)
    if len(uniforms) != walk_len:
        raise ValueError(f"a walk of {walk_len} steps reads {walk_len} "
                         f"uniform entries, got {len(uniforms)}")
    out = [cur]
    prev = torch.full_like(cur, -1)
    for ets, u in zip(per_step, uniforms):
        if not _biased(p, q):
            nxt = sampling.select_sampled_neighbors(g, cur, ets, *u,
                                                    default_id)[0][:, 0]
        elif exact:
            nxt = _exact_step(g, cur, prev, ets, p, q, default_id, bias_cap,
                              u)
        else:
            nxt = _rejection_step(g, cur, prev, ets, p, q, default_id, u)
        nxt = torch.where(cur >= 0, nxt, default_id)
        out.append(nxt)
        prev, cur = cur, nxt
    return torch.stack(out, dim=1)


def random_walk(g: GraphTensors, nodes: torch.Tensor, edge_types,
                walk_len: int, p: float = 1.0, q: float = 1.0,
                default_id: int = -1, exact: bool = True,
                bias_cap: int = 64, bias_windows: int = 1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Walk ``walk_len`` steps from each node; [B, walk_len + 1] (see
    ``select_walk``). ``edge_types`` is a tuple of edge types for every
    step or a list of ``walk_len`` such tuples (reference API,
    tf_euler/python/euler_ops/walk_ops.py:30-43)."""
    nodes = nodes.reshape(-1)
    u = draw_walk_uniforms(generator, nodes.shape[0], walk_len, p, q, exact,
                           bias_cap, bias_windows, nodes.device, g)
    return select_walk(g, nodes, edge_types, walk_len, u, p, q, default_id,
                       exact, bias_cap)


def check_bias_cap(graph_or_tensors, edge_types, bias_cap: int = 64,
                   bias_windows: int = 1,
                   warn: bool = True) -> Tuple[int, int, int]:
    """Host-side exactness check of node2vec's windowed reweighting
    (reference: walk.py:173-205): ``(max_union_degree, windows_needed,
    n_truncated_nodes)`` over the union of ``edge_types`` groups, from
    the CSR pointers. With ``warn`` a warning names the ``bias_windows``
    that makes the walk exact where ``bias_cap * bias_windows``
    truncates a node. It copies the pointers to the host: call it at
    setup, never inside a captured step."""
    g = getattr(graph_or_tensors, "tensors", graph_or_tensors)
    ets = as_etypes(g, edge_types)
    gp = g.group_ptr.cpu().numpy().astype(np.int64)
    deg = (gp[1:] - gp[:-1]).reshape(-1, g.meta.num_edge_types)
    union = deg[:, list(ets)].sum(axis=1)
    max_deg = int(union.max(initial=0))
    span = bias_cap * bias_windows
    n_trunc = int((union > span).sum())
    need = max(1, -(-max_deg // bias_cap))
    if warn and n_trunc:
        import warnings
        warnings.warn(
            f"node2vec bias reweighting covers {span} neighbors but "
            f"{n_trunc} node(s) have union degree up to {max_deg}; the "
            f"walk distribution deviates there. Pass bias_windows="
            f"{need} (with bias_cap={bias_cap}) for exactness.",
            stacklevel=2)
    return max_deg, need, n_trunc


def _pairs(L: int, left: int, right: int) -> List[Tuple[int, int]]:
    """(center, context) positions of ``gen_pair``'s pairs of a walk of L
    nodes, in the reference's order."""
    pairs = []
    for j in range(L):
        pairs += [(j, j - k - 1) for k in range(left) if j - k - 1 >= 0]
        pairs += [(j, j + k + 1) for k in range(right) if j + k + 1 < L]
    return pairs


def pair_count(L: int, left: int, right: int) -> int:
    """The pairs ``gen_pair`` makes of one walk of L nodes."""
    return len(_pairs(L, left, right))


@functools.lru_cache(maxsize=64)
def _pair_index(L: int, left: int, right: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(center, context) positions of ``gen_pair``'s pairs, built once per
    (L, left, right, device): a captured step may not copy them from the
    host, so the copy happens at the first, eager call."""
    pairs = _pairs(L, left, right)
    ctr, ctx = zip(*pairs) if pairs else ((), ())
    return (torch.tensor(ctr, dtype=torch.int64, device=device),
            torch.tensor(ctx, dtype=torch.int64, device=device))


def gen_pair(paths: torch.Tensor, left_win_size: int,
             right_win_size: int) -> torch.Tensor:
    """Skip-gram (center, context) pairs of walks [B, L]; [B, P, 2]. The
    reference's layout (gen_pair_op.cc:60-77): for each position j, the
    left contexts j-1 .. j-lw, then the right ones j+1 .. j+rw, dropping
    those past the walk."""
    ctr, ctx = _pair_index(paths.shape[1], left_win_size, right_win_size,
                           paths.device)
    return torch.stack([paths[:, ctr], paths[:, ctx]], dim=-1)
