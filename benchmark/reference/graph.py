"""The graph as the plain reference sees it, rebuilt from the edge arrays
the benchmark made: plain PyTorch, nothing of the port.

Neighbors are out-neighbors (edge src -> dst), over every edge type. A
weighted neighbor draw picks ``c`` for parent ``p`` with probability
``W(p, c) / W(p)``: the weight of the edges from p to c over the weight of
every edge from p (Node::SampleNeighbor's distribution, with replacement).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


class RefGraph:
    """Sorted (src, dst) pairs with their summed weights, and per-node
    out-degree, in-degree and weight moments, on ``device``."""

    def __init__(self, arrays: Dict[str, np.ndarray], n_nodes: int, device):
        dev = torch.device(device)
        self.n = n_nodes
        src = torch.from_numpy(arrays["src"]).to(dev).long()
        dst = torch.from_numpy(arrays["dst"]).to(dev).long()
        w = torch.from_numpy(arrays["ew"]).to(dev).double()
        self.src, self.dst = src, dst
        self.out_deg = torch.bincount(src, minlength=n_nodes)
        self.in_deg = torch.bincount(dst, minlength=n_nodes)
        keys = src * n_nodes + dst
        self.pair_keys, inv = torch.unique(keys, sorted=True,
                                           return_inverse=True)
        self.pair_w = torch.zeros(self.pair_keys.shape[0], dtype=torch.float64,
                                  device=dev).index_add_(0, inv, w)
        psrc = self.pair_keys // n_nodes
        zeros = torch.zeros(n_nodes, dtype=torch.float64, device=dev)
        self.w_row = zeros.clone().index_add_(0, psrc, self.pair_w)
        self.w2_row = zeros.clone().index_add_(0, psrc, self.pair_w ** 2)
        self.w3_row = zeros.clone().index_add_(0, psrc, self.pair_w ** 3)

    def draw_stats(self, parents: torch.Tensor, children: torch.Tensor
                   ) -> Tuple[int, float, float, float]:
        """(misses, sum of drawn pair weights, its mean and its variance
        under the weighted draw) over draws ``children`` of ``parents``
        (int tensors of one shape). A miss is a child that is no
        out-neighbor of its live parent, or a -1 child of a parent that
        has out-neighbors; parents < 0 draw nothing and are skipped."""
        p = parents.reshape(-1).to(self.pair_keys.device).long()
        c = children.reshape(-1).to(self.pair_keys.device).long()
        live = p >= 0
        p, c = p[live], c[live]
        has = self.out_deg[p.clamp(0, self.n - 1)] > 0
        empty = c < 0
        misses = int(((empty & has) | ((~empty) & ~has)).sum())
        p, c = p[~empty & has], c[~empty & has]
        bad = (p >= self.n) | (c >= self.n)
        misses += int(bad.sum())
        p, c = p[~bad], c[~bad]
        key = p * self.n + c
        idx = torch.searchsorted(self.pair_keys, key).clamp_max(
            self.pair_keys.shape[0] - 1)
        found = self.pair_keys[idx] == key
        misses += int((~found).sum())
        p, idx = p[found], idx[found]
        q = self.pair_w[idx]
        mean = self.w2_row[p] / self.w_row[p]
        var = self.w3_row[p] / self.w_row[p] - mean ** 2
        return misses, float(q.sum()), float(mean.sum()), float(var.sum())


def draw_check(ref: RefGraph, hops) -> Dict[str, float]:
    """Judge neighbor draws: ``hops`` is a sequence of (parents, children)
    pairs. Returns ``draw_misses`` (draws that are no out-neighbor) and
    ``draw_weight_z``, |z| of the summed drawn pair weights against their
    mean under the weighted draw (about N(0, 1) for exact draws; a uniform
    draw over the neighbors reads in the hundreds at the cells' sizes)."""
    misses, tot, mean, var = 0, 0.0, 0.0, 0.0
    for parents, children in hops:
        m, q, mu, v = ref.draw_stats(parents, children)
        misses, tot, mean, var = misses + m, tot + q, mean + mu, var + v
    z = abs(tot - mean) / math.sqrt(var) if var > 0 else 0.0
    return {"draw_misses": float(misses), "draw_weight_z": z}


def sampled_hops(roots: torch.Tensor, n_id: torch.Tensor, fanouts
                 ) -> list:
    """(parents, children) of each hop of a sampled flow, read from the
    deepest block's source ids ``n_id`` = [roots, hop-1 draws, hop-2
    draws, ...], each hop's frontier the ids before its draws."""
    hops, t = [], roots.shape[0]
    for f in fanouts:
        frontier = n_id[:t]
        drawn = n_id[t:t * (1 + f)]
        hops.append((frontier.repeat_interleave(f), drawn))
        t *= 1 + f
    return hops
