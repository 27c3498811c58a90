"""Alias tables: the host-side builders, the fan-row layout and the
device-side draw.

The builders are copies of euler_tpu/ops/alias.py's numpy builders
(Vose's alias method, reference: euler/common/alias_method.h:28), using
the port's own native loader. Tables are built once on the host at
graph-load time; the device only reads them. The reference's
``alias_draw`` (ops/alias.py:236-252) is split in two, as the port splits
every random verb: ``draw_alias_uniforms`` draws (u1, u2) from a
torch.Generator, and ``alias_select`` is the deterministic select.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from euler_tpu_torch.native import loader as _native


def build_alias_table(weights: np.ndarray):
    """Build (prob, alias) arrays for Vose's alias method.

    prob[i]  : probability of keeping slot i on the first draw
    alias[i] : slot used otherwise
    Empty input yields empty tables. Zero/negative total weight falls back to
    uniform (matching the reference's behavior of normalizing sums).
    """
    w = np.asarray(weights, np.float64)
    n = len(w)
    if n == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    if n > 4096:  # native fast path for big tables
        res = _native.build_alias_native(w.astype(np.float32))
        if res is not None:
            return res
    total = w.sum()
    if not np.isfinite(total) or total <= 0:
        w = np.ones(n, np.float64)
        total = float(n)
    p = w * (n / total)
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias


def build_typed_alias_tables(type_of: np.ndarray, weights: np.ndarray,
                             num_types: int):
    """Per-type alias tables over a typed population, concatenated.

    Mirrors the reference's per-node-type/per-edge-type global samplers
    (euler/core/graph/graph.h:203-208 ``BuildGlobalSampler``).

    Returns dict of numpy arrays:
      ids      int32 [n]  — population sorted by type (values = member index)
      type_ptr int64 [num_types+1]
      prob     f32   [n]
      alias    int32 [n]  — *within-type* alias slot
      w_sum    f32   [num_types] — per-type total weight
    """
    n = len(type_of)
    order = np.argsort(type_of, kind="stable").astype(np.int32)
    sorted_types = type_of[order]
    type_ptr = np.searchsorted(sorted_types, np.arange(num_types + 1)).astype(
        np.int64)
    prob = np.zeros(n, np.float32)
    alias = np.zeros(n, np.int32)
    w_sum = np.zeros(num_types, np.float32)
    for t in range(num_types):
        lo, hi = type_ptr[t], type_ptr[t + 1]
        p, a = build_alias_table(weights[order[lo:hi]])
        prob[lo:hi] = p
        alias[lo:hi] = a
        w_sum[t] = float(weights[order[lo:hi]].sum())
    return dict(ids=order, type_ptr=type_ptr, prob=prob, alias=alias,
                w_sum=w_sum)


def build_group_alias(group_ptr: np.ndarray, weights: np.ndarray):
    """Per-CSR-group alias tables: one Vose table per group segment.

    Returns (prob f32 [E], alias int32 [E]); ``alias`` holds *within-group*
    slots.
    """
    gp = np.asarray(group_ptr, np.int64)
    w = np.asarray(weights, np.float32)
    res = _native.build_group_alias_native(gp, w)
    if res is not None:
        return res
    m = len(w)
    prob = np.ones(m, np.float32)
    alias = np.zeros(m, np.int32)
    for k in range(len(gp) - 1):
        a, b = gp[k], gp[k + 1]
        if b > a:
            p, al = _vose(w[a:b].astype(np.float64))
            prob[a:b] = p
            alias[a:b] = al
    return prob, alias


def _vose(w: np.ndarray):
    """Plain-python Vose build (fallback when the native core is absent)."""
    n = len(w)
    total = w.sum()
    p = (w * (n / total)) if (np.isfinite(total) and total > 0) \
        else np.ones(n)
    prob = np.ones(n, np.float32)
    alias = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    return prob, alias


# --------------------------------------------------------------------------
# Per-(node, edge type) packed "fan rows": the neighbor-sampling layout.
# One 128-lane int32 row holds a whole group's alias table, so `count`
# draws of one node read one row:
#
#   lane 0                      : effective degree (0 = empty group)
#   lane 1                      : group weight-sum, f32 bits
#   lanes  2..44  (FAN_D = 42)  : alias keep-probability, f32 bits
#   lanes 44..86                : kept neighbor id per slot
#   lanes 86..128               : alias neighbor id per slot
#
# Groups with degree <= FAN_D store their exact Vose alias table. Larger
# groups store a RESERVOIR of FAN_D i.i.d. draws from the exact
# distribution (prob=1): the per-draw marginal stays exact, but draws share
# the reservoir until it is redrawn.
# --------------------------------------------------------------------------

FAN_D = 42
FAN_LANES = 128
FAN_PROB_OFF = 2
FAN_KEPT_OFF = FAN_PROB_OFF + FAN_D
FAN_ALIAS_OFF = FAN_KEPT_OFF + FAN_D

# Union fan rows (the "fanu" pack): one row per NODE over the union of all
# edge types, whose kept and alias lanes pack (etype << FANU_SHIFT) | dst.
# Fits graphs of fewer than 2^27 nodes and at most 16 edge types; a
# multi-type draw then reads one row and decodes the lane.
FANU_SHIFT = 27
FANU_MASK = (1 << FANU_SHIFT) - 1
FANU_MAX_TYPES = 16


def build_fan_pack(group_ptr: np.ndarray, adj_dst: np.ndarray,
                   prob: np.ndarray, alias: np.ndarray,
                   group_w_sum: np.ndarray, seed: int = 0) -> np.ndarray:
    """Build the [G, 128] fan rows from per-group alias tables.

    group_ptr [G+1], adj_dst/prob/alias [E] (alias = within-group slots),
    group_w_sum [G] f32. Returns int32 [G, FAN_LANES].
    """
    gp = np.asarray(group_ptr, np.int64)
    G = len(gp) - 1
    E = len(adj_dst)
    deg = np.diff(gp)
    adj_dst = np.asarray(adj_dst, np.int32)
    pack = np.zeros((G, FAN_LANES), np.int32)
    pack[:, 1] = np.asarray(group_w_sum, np.float32).reshape(-1).view(
        np.int32)

    seg = np.repeat(np.arange(G, dtype=np.int64), deg)
    j = np.arange(E, dtype=np.int64) - gp[seg]

    small = (deg <= FAN_D)
    sel = small[seg]
    rows, cols = seg[sel], j[sel]
    pack[rows, FAN_PROB_OFF + cols] = np.asarray(prob, np.float32)[sel].view(
        np.int32)
    pack[rows, FAN_KEPT_OFF + cols] = adj_dst[sel]
    alias_global = gp[seg] + np.asarray(alias, np.int64)
    pack[rows, FAN_ALIAS_OFF + cols] = adj_dst[alias_global[sel]]
    pack[small, 0] = deg[small]

    big = np.nonzero(~small)[0]
    if len(big):
        pack[big] = _fan_reservoir_rows(
            gp, adj_dst, prob, alias_global, big,
            np.asarray(group_w_sum, np.float32).reshape(-1)[big],
            np.random.default_rng(seed))
    return pack


def _fan_reservoir_rows(gp, adj_dst, prob, alias_global, big, w_sum, rng):
    """FAN_D i.i.d. exact alias draws per overflow group (prob=1 rows)."""
    n = len(big)
    deg = (gp[big + 1] - gp[big])[:, None]
    lo = gp[big][:, None]
    u1 = rng.random((n, FAN_D))
    u2 = rng.random((n, FAN_D))
    s = np.minimum((u1 * deg).astype(np.int64), deg - 1)
    idx = lo + s
    keep = u2 < np.asarray(prob, np.float32)[idx]
    res = np.where(keep, adj_dst[idx], adj_dst[alias_global[idx]])
    rows = np.zeros((n, FAN_LANES), np.int32)
    rows[:, 0] = FAN_D
    rows[:, 1] = w_sum.view(np.int32)
    rows[:, FAN_PROB_OFF:FAN_PROB_OFF + FAN_D] = \
        np.float32(1.0).view(np.int32)
    rows[:, FAN_KEPT_OFF:FAN_KEPT_OFF + FAN_D] = res
    rows[:, FAN_ALIAS_OFF:FAN_ALIAS_OFF + FAN_D] = res
    return rows


# --------------------------------------------------------------------------
# Device-side draw from a table segment
# --------------------------------------------------------------------------

def draw_alias_uniforms(generator: Optional[torch.Generator], shape,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u1, u2), f32 uniforms in [0, 1) of ``shape``: the slot pick and the
    keep-vs-alias test of an alias draw."""
    u1 = torch.rand(shape, generator=generator, device=device)
    u2 = torch.rand(shape, generator=generator, device=device)
    return u1, u2


def alias_select(prob: torch.Tensor, alias: torch.Tensor, lo, size,
                 u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Alias draws from the table segment [lo, lo + size) given uniforms.

    ``lo`` and ``size`` are int tensors broadcastable to ``u1`` (or
    ints). Returns int32 positions into the table's population, -1 where
    the segment is empty. The arithmetic is the reference's: one f32
    multiply ``u1 * size`` truncated to int32. On an empty segment the
    reference reads ``prob[lo]``, which may be one past the end, and XLA
    clamps it; here every table index is clamped to the table.
    """
    n = prob.shape[0]
    # an int becomes a fill on the device, never a copy from the host
    lo, size = (x.to(torch.int32) if torch.is_tensor(x) else
                torch.full((), x, dtype=torch.int32, device=u1.device)
                for x in (lo, size))
    safe = size.clamp_min(1)
    slot = torch.minimum((u1 * safe.to(torch.float32)).to(torch.int32),
                         safe - 1)
    idx = (lo + slot).long().clamp(0, n - 1)
    keep = u2 < prob[idx]
    picked = torch.where(keep, slot, alias[idx])
    return torch.where(size > 0, lo + picked, -1).to(torch.int32)
