"""Plain-PyTorch reference of the ``rgcn`` configuration: R-GCN over the
whole heterogeneous graph, in float32 with TF32 off, from the edge arrays.
It imports nothing of the port and nothing of JAX.

The layer is Schlichtkrull et al., "Modeling Relational Data with Graph
Convolutional Networks" (arXiv:1703.06103), eq. 2, as OGB's full-batch
R-GCN for ogbn-mag runs it (examples/nodeproppred/mag/rgcn.py,
``RGCNConv``). For node i of type t(i), over relations r:

    h_i' = W_root[t(i)] h_i + b[t(i)]
           + sum over r with N_i^r not empty of W_r mean_{j in N_i^r} h_j

where N_i^r are i's neighbours of relation r: the edges of type r stored
from i (src i -> dst j). The input rows are the papers' features and the
other types' learned tables, in id order (node ids run by type). Each
mean is taken by sorted segments: a relation's edges sorted by target,
their rows summed into the targets in blocks of ``CHUNK`` edges, each
block under ``torch.utils.checkpoint`` so that no [E, D] rows are kept
for the backward, then divided by the target's count.

Then the head of Euler's GNNNet and SuperviseModel (``reference/gnn.py``):
relu after every layer, ``emb = h W_out^T + b_out``, the sigmoid
cross-entropy over the roots' labels, and Adam (``gnn.train_steps``).

Departures from the paper and the example, as the configuration runs it:
no basis or block decomposition of W_r (the example has none either);
relu after the last layer, then ``out_fc`` and a sigmoid head, where the
example's last layer maps to the classes with a log-softmax loss; no
dropout; no edge or node attribute besides the papers' features.

``q`` is applied where the configuration keeps activations in a lower
precision: the input rows, each relation's mean, each layer's output
after relu (the program rounds W_r h_j, the messages, where this rounds
the means: the same precision at the same depth). The faults of the
readings (``benchmark/readings_rgcn.py``) are options of ``rgcn_embed``:
Euler's mean over all relations (``all_relation_mean``), one relation's
messages dropped (``drop_relation``), one root linear for every type
(``shared_root``), the tables frozen (``frozen_tables``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

Q = Callable[[torch.Tensor], torch.Tensor]

#: edges a block of a mean: [CHUNK, D] f32 rows at a time
CHUNK = 1 << 20


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class RelGraph:
    """Each relation's edges sorted by target (src), with the targets'
    counts, from the edge arrays (src -> dst, type), on ``device``."""

    def __init__(self, src, dst, etype, n: int, relations: int, device):
        dev = torch.device(device)
        src = torch.as_tensor(src).to(dev).long()
        dst = torch.as_tensor(dst).to(dev).long()
        etype = torch.as_tensor(etype).to(dev).long()
        self.n = n
        self.rel: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        for r in range(relations):
            sel = torch.nonzero(etype == r).reshape(-1)
            t, j = src[sel], dst[sel]
            order = torch.argsort(t, stable=True)
            self.rel.append((t[order], j[order],
                             torch.bincount(t, minlength=n)))
        self.total = sum(c for _, _, c in self.rel)


def _rows(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return x[j]


def segment_sum(x: torch.Tensor, t: torch.Tensor, j: torch.Tensor,
                n: int) -> torch.Tensor:
    """[n, D]: for each target, the sum of its neighbours' rows, over the
    sorted (t, j) edges in blocks of ``CHUNK``."""
    out = x.new_zeros((n, x.shape[1]))
    for a in range(0, t.shape[0], CHUNK):
        s = slice(a, a + CHUNK)
        rows = checkpoint(_rows, x, j[s], use_reentrant=False,
                          preserve_rng_state=False)
        out = out.index_add(0, t[s], rows)
    return out


def rgcn_layer(x: torch.Tensor, w: Dict[str, torch.Tensor], layer: int,
               graph: RelGraph, type_lo: Sequence[int], q: Q = identity,
               all_relation_mean: bool = False, drop_relation: int = -1,
               shared_root: bool = False) -> torch.Tensor:
    """One R-GCN layer [N, F] (before relu) over the node rows x [N, D]."""
    root, root_b = w[f"l{layer}.root"], w[f"l{layer}.root_b"]
    h = torch.cat([x[a:b] @ root[0 if shared_root else k].T
                   + root_b[0 if shared_root else k]
                   for k, (a, b) in enumerate(zip(type_lo[:-1],
                                                  type_lo[1:]))])
    matrix = w[f"l{layer}.matrix"]
    for r, (t, j, cnt) in enumerate(graph.rel):
        if r == drop_relation or t.shape[0] == 0:
            continue
        den = graph.total if all_relation_mean else cnt
        mean = segment_sum(x, t, j, graph.n) / den.clamp_min(1)[:, None]
        h = h + q(mean) @ matrix[r].T
    return h


def rgcn_embed(w: Dict[str, torch.Tensor], feat: torch.Tensor,
               tables: Sequence[str], graph: RelGraph,
               type_lo: Sequence[int], layers: int, q: Q = identity,
               frozen_tables: bool = False, **fault) -> torch.Tensor:
    """Embeddings [N, out] of every node: the input rows (``feat``, the
    first type's, then the tables ``emb.<name>`` of ``tables`` in type
    order), ``layers`` R-GCN layers with relu, then ``out_fc``. Weights:
    ``l<i>.matrix`` [R, F, D_in], ``l<i>.root`` [T, F, D_in],
    ``l<i>.root_b`` [T, F], ``out.w``, ``out.b``. ``fault``:
    ``rgcn_layer``'s options."""
    embs = [w[f"emb.{name}"] for name in tables]
    if frozen_tables:        # no gradient; the tables stay leaves
        embs = [e.detach() + 0.0 * e for e in embs]
    x = q(torch.cat([feat.to(torch.float32)] + embs))
    for layer in range(layers):
        x = q(torch.relu(rgcn_layer(x, w, layer, graph, type_lo, q,
                                    **fault)))
    return x @ w["out.w"].T + w["out.b"]
