"""Plain-PyTorch reference of the supervised GNN configurations: GraphSAGE
over sampled blocks and GCN over the whole graph, the sigmoid
cross-entropy head and Adam, in float32 with TF32 off. It imports nothing
of the port.

Semantics (the configuration files give the sizes):

- SAGE layer over targets T with fanout f: the mean over the valid
  sampled neighbors and the target itself (a self loop), then
  ``relu(x_t W_self^T + mean W_neigh^T)``. A draw is valid where it is a
  node (>= 0) and its target is one. The layered node sets are
  [targets, their draws], so the deepest block's source ids hold every
  hop's draws.
- GCN layer over the whole graph: for node i, the sum over its
  out-edges (i -> j) and a self loop of ``x_j / sqrt(d_i d_j)``, where
  ``d_i`` is i's out-degree + 1 and ``d_j`` j's in-degree + 1, then
  ``relu(sum W^T)``. Edge weights are not read.
- Head: ``emb = h W_out^T + b_out``, ``logit = emb W_head^T``, loss the
  mean of the sigmoid cross-entropy over the valid roots' labels.
- Adam: torch's defaults (betas 0.9, 0.999, eps 1e-8), bias-corrected.

``q`` is applied where the configuration keeps activations in a lower
precision (the features, each aggregate, each layer's output): the
reference passes the identity, the control a round trip through a lower
type.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

Q = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def round_trip(dtype: torch.dtype) -> Q:
    """``q`` of a control: activations rounded to ``dtype`` and back in
    the forward; the gradient passes through unrounded."""
    def q(x):
        return x + (x.detach().to(dtype).to(torch.float32) - x.detach())
    return q


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """f32 rows of ``table`` for ``ids``, zero rows for ids < 0."""
    ok = ids >= 0
    out = table[ids.clamp_min(0).long()].to(torch.float32)
    return torch.where(ok[:, None], out, 0.0)


def sage_layer(x: torch.Tensor, t: int, f: int, tgt_ok: torch.Tensor,
               src_ok: torch.Tensor, w_self, w_neigh, q: Q) -> torch.Tensor:
    """One SAGE layer over the source set ``x`` [t * (1 + f), D] whose
    first ``t`` rows are the targets."""
    xt, xs = x[:t], x[t:].reshape(t, f, -1)
    m = (src_ok.reshape(t, f) & tgt_ok[:, None]).to(torch.float32)
    ml = tgt_ok.to(torch.float32)
    tot = (xs * m[..., None]).sum(dim=1) + xt * ml[:, None]
    cnt = (m.sum(dim=1) + ml).clamp_min(1e-7)
    aggr = q(tot / cnt[:, None])
    return q(torch.relu(xt @ w_self.T + aggr @ w_neigh.T))


def sage_embed(w: Dict[str, torch.Tensor], feat: torch.Tensor,
               n_id: torch.Tensor, batch: int, fanouts, q: Q = identity
               ) -> torch.Tensor:
    """Embeddings [batch, out] of the roots n_id[:batch] over the
    deepest block's source ids ``n_id`` (every hop's draws)."""
    sizes = [batch]
    for f in fanouts:
        sizes.append(sizes[-1] * (1 + f))
    x = q(rows(feat, n_id))
    ok = n_id >= 0
    for layer, f in enumerate(reversed(fanouts)):
        t = sizes[len(fanouts) - 1 - layer]
        x = sage_layer(x, t, f, ok[:t], ok[t:t * (1 + f)],
                       w[f"l{layer}.self"], w[f"l{layer}.neigh"], q)
    return x @ w["out.w"].T + w["out.b"]


class WholeGraph:
    """The GCN's normalised whole-graph sum over a ``RefGraph``."""

    def __init__(self, ref):
        self.src, self.dst = ref.src, ref.dst
        d_t = (ref.out_deg + 1).to(torch.float32) ** -0.5
        d_s = (ref.in_deg + 1).to(torch.float32) ** -0.5
        self.edge_scale = (d_t[self.src] * d_s[self.dst])[:, None]
        self.loop_scale = (d_t * d_s)[:, None]

    def aggregate(self, x: torch.Tensor) -> torch.Tensor:
        out = x * self.loop_scale
        return out.index_add(0, self.src, x[self.dst] * self.edge_scale)


def gcn_embed(w: Dict[str, torch.Tensor], feat: torch.Tensor,
              whole: WholeGraph, layers: int, q: Q = identity
              ) -> torch.Tensor:
    x = q(feat.to(torch.float32))
    for layer in range(layers):
        x = q(torch.relu(q(whole.aggregate(x)) @ w[f"l{layer}.fc"].T))
    return x @ w["out.w"].T + w["out.b"]


def sigmoid_xent_loss(logit: torch.Tensor, label: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    x = (torch.clamp_min(logit, 0) - logit * label
         + torch.log1p(torch.exp(-logit.abs())))
    v = valid.to(torch.float32)[:, None]
    return (x * v).sum() / (v.sum() * logit.shape[1]).clamp_min(1.0)


class Adam:
    """torch.optim.Adam's update, by its formula."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt() + self.eps
            params[k].sub_(self.lr * (self.m[k] / c1) / denom)


def train_steps(weights0: Dict[str, torch.Tensor], lr: float,
                loss_of: Callable[[Dict[str, torch.Tensor], int],
                                  torch.Tensor], steps: int) -> dict:
    """Follow ``steps`` Adam steps from ``weights0``; ``loss_of(w, i)`` is
    step i's loss at weights w. Returns each step's loss, the first
    step's gradients and the weights after the last step."""
    w = {k: v.clone().to(torch.float32) for k, v in weights0.items()}
    opt = Adam(w, lr)
    losses: List[float] = []
    grad1: Optional[Dict[str, torch.Tensor]] = None
    for i in range(steps):
        leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        loss = loss_of(leaves, i)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        if i == 0:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            opt.step(w, grads)
    return {"loss": losses, "grad1": grad1, "weights": w}
