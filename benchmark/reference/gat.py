"""Plain-PyTorch reference of the ``gat`` configuration: multi-head GAT
over the whole graph, in float32 with TF32 off, over the edge list and
self loops. It imports nothing of the port and nothing of JAX.

The layer is Velickovic et al., "Graph Attention Networks" (ICLR 2018,
arXiv:1710.10903), section 2.1, eqs. (1)-(5). For node i over its
out-edges (i -> j), each stored edge counted once, and a self loop
(i -> i), with H heads of F channels:

- ``z = x W^T`` ([N, H, F]; head k's W^k is rows k*F to k*F + F of W);
- ``el_i = z_i . a_l``, ``er_j = z_j . a_r`` per head;
- ``e_ij = LeakyReLU_0.2(el_i + er_j)``;
- ``alpha_ij = softmax over j in N(i) and i`` per head (the max shift
  carries no gradient, as it cancels);
- ``h_i = concat over heads of sum_j alpha_ij z_j``, then relu.

Then the head of Euler's GNNNet and SuperviseModel, as in
``reference/gnn.py``: ``emb = h W_out^T + b_out``, the sigmoid
cross-entropy over the roots' labels, and Adam (``gnn.train_steps``).

Departures from the paper, as the configuration runs it: no bias in the
layer; relu between layers where the paper's transductive model uses
ELU; every layer concatenates its heads, the last too (the paper averages
the last layer's heads into the classes, and here ``out_fc`` and the label
projection follow); a stored self edge is a neighbour besides the self
loop; no dropout or weight decay.

``q`` is applied where the configuration keeps activations in a lower
precision: the features, the z rows the weighted sum reads, each layer's
sum and its output after relu. The faults of the readings
(``benchmark/readings_gat.py``) are options of ``gat_embed``: another
``slope``, no ``self_loop`` in the softmax, the probabilities detached
from autograd (``detach_probs``).

The weighted sum runs over chunks of ``CHUNK`` edges, each under
``torch.utils.checkpoint``, so that it keeps no [E, H, F] rows for the
backward: at the configuration's size it fits on one card once the
program's state is freed.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

Q = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


#: edges a chunk of the weighted sum: [CHUNK, H, F] f32 rows at a time
CHUNK = 1 << 18


def _rows(alpha: torch.Tensor, z: torch.Tensor, dst: torch.Tensor
          ) -> torch.Tensor:
    return alpha[..., None] * z[dst]


def attend(z: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
           src: torch.Tensor, dst: torch.Tensor, slope: float = 0.2,
           self_loop: bool = True, detach_probs: bool = False
           ) -> torch.Tensor:
    """Per-head attention of every node i over its edges (src i -> dst j)
    and its self loop: [N, H, F] = sum_j alpha_ij z_j, with the scores
    from el [N, H] and er [N, H] and the rows z [N, H, F]."""
    n, heads = el.shape
    lrelu = torch.nn.functional.leaky_relu
    e = lrelu(el[src] + er[dst], slope)                      # [E, H]
    e_self = lrelu(el + er, slope)                           # [N, H]
    idx = src[:, None].expand_as(e)
    m = torch.full((n, heads), float("-inf"), device=el.device)
    if self_loop:
        m = torch.maximum(m, e_self.detach())
    m = m.scatter_reduce(0, idx, e.detach(), "amax")
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(e - m[src])
    p_self = torch.exp(e_self - m) if self_loop else torch.zeros_like(e_self)
    den = p_self.index_add(0, src, p).clamp_min(1e-16)
    alpha, alpha_self = p / den[src], p_self / den
    if detach_probs:      # no gradient through them; a_l, a_r stay leaves
        alpha, alpha_self = (a.detach() + 0.0 * a for a in (alpha,
                                                             alpha_self))
    out = z * alpha_self[..., None]
    for a in range(0, src.shape[0], CHUNK):
        s = slice(a, a + CHUNK)
        rows = checkpoint(_rows, alpha[s], z, dst[s], use_reentrant=False,
                          preserve_rng_state=False)
        out = out.index_add(0, src[s], rows)
    return out


def gat_embed(w: Dict[str, torch.Tensor], feat: torch.Tensor,
              src: torch.Tensor, dst: torch.Tensor, layers: int, heads: int,
              q: Q = identity, **fault) -> torch.Tensor:
    """Embeddings [N, out] of every node: ``layers`` GAT layers over the
    edges (src -> dst, long) with ``heads`` heads, then ``out_fc``.
    Weights: ``l<i>.fc`` [H * F, D_in], ``l<i>.attn_l`` and
    ``l<i>.attn_r`` [H, F], ``out.w``, ``out.b``. ``fault``: ``attend``'s
    options."""
    x = q(feat.to(torch.float32))
    n = x.shape[0]
    for layer in range(layers):
        W = w[f"l{layer}.fc"]
        z = (x @ W.T).reshape(n, heads, -1)
        el = (z * w[f"l{layer}.attn_l"]).sum(-1)
        er = (z * w[f"l{layer}.attn_r"]).sum(-1)
        h = attend(q(z), el, er, src, dst, **fault)
        x = q(torch.relu(q(h.reshape(n, -1))))
    return x @ w["out.w"].T + w["out.b"]
