"""Dataflow samplers: sampling strategy -> sequence of bipartite Blocks.

Counterpart of euler_tpu/dataflow/flows.py. Only ``SageDataFlow`` on its
fast path (ids-only fan-row sampling; the reference's ``payload=False``,
with or without ``typed``) is ported.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from euler_tpu_torch.dataflow.block import fanout_block
from euler_tpu_torch.ops import sampling


class SageDataFlow:
    """Per-hop weighted neighbor sampling (GraphSAGE).

    reference: SageDataFlow (tf_euler/python/dataflow/sage_dataflow.py:24-50).
    Blocks carry edge_weight = the 0/1 validity mask and e_id = -1; with
    ``typed=True`` also ``e_type``, each draw's edge type (-1 where
    invalid), which RGCN's ``relation_from_etype`` reads.

    A hop over one edge type draws from the fan rows, a hop over every
    type from the union rows where the graph has them, any other
    multi-type hop from one fan row per type (ops/sampling.py). A call
    takes either ``generator`` (a torch.Generator on the graph's device,
    or None for the default one) or ``uniforms``, a list with one tuple
    per hop, so that a caller can replay given draws: ``(u1, u2)`` for
    one-type and union hops, ``(ut, u1, u2)`` for per-type hops
    (``sampling.draw_neighbor_uniforms``).
    """

    def __init__(self, fanouts: Sequence[int], metapath,
                 add_self_loops: bool = True, default_id: int = -1,
                 typed: bool = False):
        if len(fanouts) != len(metapath):
            raise ValueError("need one metapath entry per fanout")
        self.fanouts = list(fanouts)
        self.metapath = list(metapath)
        self.add_self_loops = add_self_loops
        self.default_id = default_id
        self.typed = typed

    def __call__(self, g, roots: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Sequence] = None):
        if uniforms is not None and len(uniforms) != len(self.fanouts):
            raise ValueError(f"need {len(self.fanouts)} uniform tuples, "
                             f"got {len(uniforms)}")
        cur = roots.reshape(-1).to(torch.int32)
        blocks = []
        for hop, (ets, cnt) in enumerate(zip(self.metapath, self.fanouts)):
            u = uniforms[hop] if uniforms is not None else \
                sampling.draw_neighbor_uniforms(g, ets, generator,
                                                cur.shape[0], cnt, cur.device)
            nbr, valid, *ty = sampling.select_neighbors(
                g, cur, ets, u, self.default_id, return_types=self.typed)
            blk = fanout_block(cur, nbr, valid.to(torch.float32),
                               torch.full_like(nbr, -1), cnt,
                               self.add_self_loops,
                               etypes=ty[0] if ty else None)
            blocks.append(blk)
            cur = blk.n_id
        return blocks[::-1]
