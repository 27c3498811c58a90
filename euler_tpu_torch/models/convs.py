"""Graph convolutions over static-shape Blocks.

Counterpart of euler_tpu/models/convs.py. Call convention:
``conv((x_tgt [size0, D], x_src [size1, D]), block) -> [size0, dim]``
(``RelationConv`` also takes ``edge_attr``); on a whole-graph ELL block
``x_src`` may be the compact [N, D] table. Every conv of the
reference's registry is ported, over every block layout the port builds.
Each conv's ``out_dim`` is the width it outputs: ``dim``, but the input
width for ``AGNNConv`` and ``APPNPConv``, which propagate without a
projection. Parameters are f32; low-precision activations are cast up to
them where flax's type promotion would (torch refuses mixed-dtype
products), and stay low where the reference keeps them low.

The multi-hop convs (TAG, SGCN, APPNP, Gated) feed each hop's output to
the next as the reference does, ``_next_src``: the targets' rows replace
the first ``size[0]`` rows of the source set when the block has more
sources than targets. On a compact ELL table the rest is empty, so the
source set stays compact. ARMA keeps its own rule.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from euler_tpu_torch.dataflow.block import Block
from euler_tpu_torch.utils.trace import span


def dense(in_dim: int, out_dim: int, bias: bool = True,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A CPU ``nn.Linear`` initialised as flax's Dense default: a
    truncated-normal lecun kernel and a zero bias. ``generator`` is a CPU
    generator, so a seed gives the same weights whatever device the model
    later moves to."""
    lin = nn.Linear(in_dim, out_dim, bias=bias)
    # flax's variance_scaling(1, "fan_in", "truncated_normal") std
    std = math.sqrt(1.0 / in_dim) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


def _deg_inv_sqrt(block: Block):
    """deg ** -0.5 of targets [size0, 1] and sources [size1, 1] (a degree
    of 0 counts as 1), f32, from the masked edge counts, or from the
    block's ``src_deg`` where its source slots are node copies
    (reference: euler_tpu/models/convs.py:31-42, gcn_conv.py:38-46)."""
    ew = torch.ones((block.edge_index.shape[1], 1), dtype=torch.float32,
                    device=block.mask.device)
    deg_t = block.scatter("add", ew, block.mask)
    if block.src_deg is not None:
        deg_s = block.src_deg[:, None].to(torch.float32)
    else:
        deg_s = block.scatter_src_add(ew, block.mask)
    return tuple(torch.where(d > 0, d, 1.0) ** -0.5 for d in (deg_t, deg_s))


def _edge_scale(ni: torch.Tensor, nj: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[E, 1] multiplier: the sym-norm factors and the edge mask."""
    sc = ni * nj
    return sc if mask is None else sc * mask[:, None]


def _sym_scale(block: Block) -> torch.Tensor:
    """The [E, 1] f32 sym-norm scale of every edge, mask folded in."""
    norm_i, norm_j = _deg_inv_sqrt(block)
    return _edge_scale(block.gather_tgt(norm_i), block.gather_src(norm_j),
                       block.mask)


def _next_src(cur: torch.Tensor, src: torch.Tensor, size) -> torch.Tensor:
    """The reference's propagation rule: ``cat([cur, src[size0:]])`` when
    the block has more sources than targets, else ``cur`` (the type
    promoted as ``jnp.concatenate`` does)."""
    if size[1] <= size[0]:
        return cur
    rest = src[size[0]:]
    dt = torch.promote_types(cur.dtype, rest.dtype)
    return torch.cat([cur.to(dt), rest.to(dt)])


class GCNConv(nn.Module):
    """reference: gcn_conv.py:26-54 (convs.py:55-68): the sym-normalised
    sum ``sum_j x_j / sqrt(deg_i deg_j)`` over masked edges (self loops
    included where the block has them), then ``fc``, flax's bias-free
    ``Dense_0``. The degree math is f32; the scale is cast to the
    activation type inside ``aggregate_neighbors``."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = dim
        self.fc = dense(in_dim, dim, bias=False, generator=generator)

    def forward(self, x, block: Block) -> torch.Tensor:
        _, x_src = x
        out = block.aggregate_neighbors("add", x_src, scale=_sym_scale(block))
        return self.fc(out.to(self.fc.weight.dtype))


class SAGEConv(nn.Module):
    """reference: sage_conv.py:26-44 (self_fc + neigh_fc, mean aggr).

    ``self_fc`` is flax's ``Dense_0`` (applied to x_tgt) and ``neigh_fc``
    its ``Dense_1`` (applied to the masked neighbor mean)."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = dim
        self.self_fc = dense(in_dim, dim, bias=False, generator=generator)
        self.neigh_fc = dense(in_dim, dim, bias=False, generator=generator)

    def forward(self, x, block: Block) -> torch.Tensor:
        x_tgt, x_src = x
        aggr = block.aggregate_neighbors("mean", x_src, block.mask)
        w = self.self_fc.weight
        # flax promotes low-precision activations to the f32 params
        return self.self_fc(x_tgt.to(w.dtype)) + self.neigh_fc(aggr.to(
            w.dtype))


def _trunc_normal(shape, std: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    return t


class GATConv(nn.Module):
    """reference: gat_conv.py:41-75, in the JAX package's
    project-after-aggregation form (convs.py:83-116), and with ``heads``
    H > 1 the multi-head layer of Velickovic et al., "Graph Attention
    Networks" (arXiv:1710.10903, section 2.1, eqs. 1-5).

    ``heads=1`` (Euler's form): ``fc`` is flax's ``Dense_0``, ``a1``/
    ``a2`` its ``Dense_1``/``Dense_2``. The two attention projections
    compose with ``fc`` into one [D_in, 1] vector each, so the source set
    is never projected: scores are ``gather_tgt(x_tgt @ w1) +
    gather_src(x_src @ w2)``, leaky_relu with tf's slope 0.2 (not 0.01),
    the block softmax, and ``fc`` applied to the attention-weighted sum of
    raw features.

    ``heads=H > 1`` (the paper's form): ``dim`` is the concatenated width,
    H heads of F = dim / H. ``fc`` holds every head's W^k, [H * F, D_in]
    (head k's rows k*F to k*F + F), and ``attn_l``/``attn_r`` [H, F] the
    a_l^k (target side) and a_r^k (source side). Per head k: z^k = W^k x
    (f32, the activations promoted to the f32 weights); el = z^k . a_l^k
    of the targets and er = z^k . a_r^k of the sources, in f32, each
    computed as x . (W^k^T a^k); scores ``leaky_relu_0.2(el[t] +
    er[src])`` over each target's edges and its self loop; the block's
    masked softmax a head, in f32; then the per-head weighted sum of the
    z rows, read in the activation type (x_src's), the heads
    concatenated, [T, dim] in the activation type. The targets are the
    first ``size[0]`` rows of the source set, as every block of the port
    lays them out. On the compact table of a whole-graph ELL block with
    self loops (``Block.fuses_gat``) the scores, softmax and sum run
    fused in the attention kernels (``Block.gat_attention``), which
    build no [E, H] tensor, sum in f32 and route el's and er's gradients
    into z's; every other block (sampled, edge list, an ELL block without
    self loops) runs them as torch ops, ``Block.softmax`` and
    ``Block.aggregate_neighbors`` with a scale a head. The scores,
    softmax and aggregate run in the span ``attention``.
    """

    def __init__(self, in_dim: int, dim: int, improved: bool = False,
                 heads: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if heads < 1 or dim % heads:
            raise ValueError(f"GATConv: dim {dim} is no multiple of heads "
                             f"{heads}")
        if heads > 1 and improved:
            raise ValueError("GATConv: improved is Euler's single-head "
                             "form (heads=1)")
        self.out_dim = dim
        self.improved = improved
        self.heads = heads
        self.fc = dense(in_dim, dim, bias=False, generator=generator)
        if heads == 1:
            self.a1 = dense(dim, 1, bias=False, generator=generator)
            self.a2 = dense(dim, 1, bias=False, generator=generator)
            return
        F = dim // heads
        std = math.sqrt(1.0 / F) / 0.87962566103423978
        self.attn_l = nn.Parameter(_trunc_normal((heads, F), std, generator))
        self.attn_r = nn.Parameter(_trunc_normal((heads, F), std, generator))

    def forward(self, x, block: Block) -> torch.Tensor:
        if self.heads > 1:
            return self._multi_head(x, block)
        x_tgt, x_src = x
        f32 = self.fc.weight.dtype
        w1 = self.fc.weight.T @ self.a1.weight.T            # [D_in, 1]
        w2 = self.fc.weight.T @ self.a2.weight.T
        alpha = (block.gather_tgt(x_tgt.to(f32) @ w1)
                 + block.gather_src(x_src.to(f32) @ w2))
        alpha = torch.nn.functional.leaky_relu(alpha, negative_slope=0.2)
        alpha = block.softmax(alpha, block.mask)
        out = self.fc(block.aggregate_neighbors("add", x_src, scale=alpha)
                      .to(f32))
        if self.improved:
            out = self.fc(x_tgt.to(f32)) + out
        return out

    def _multi_head(self, x, block: Block) -> torch.Tensor:
        _, x_src = x
        H = self.heads
        xs = x_src.to(self.fc.weight.dtype)
        z = self.fc(xs)                                     # [S, H * F]
        if block.fuses_gat(x_src):
            with span("attention"):
                return block.gat_attention(z, xs, self.fc.weight,
                                           self.attn_l, self.attn_r,
                                           x_src.dtype)
        w = self.fc.weight.reshape(H, -1, xs.shape[1])      # [H, F, D_in]
        al = torch.einsum("hfd,hf->dh", w, self.attn_l)     # [D_in, H]
        ar = torch.einsum("hfd,hf->dh", w, self.attn_r)
        with span("attention"):
            scores = (block.gather_tgt(xs[:block.size[0]] @ al)
                      + block.gather_src(xs @ ar))          # [E, H]
            scores = torch.nn.functional.leaky_relu(scores,
                                                    negative_slope=0.2)
            alpha = block.softmax(scores, block.mask)
            return block.aggregate_neighbors("add", z.to(x_src.dtype),
                                             scale=alpha)


class GINConv(nn.Module):
    """reference: gin_conv.py:27-60 (convs.py:119-133):
    ``fc((1 + eps) * x_tgt + sum of neighbors)``; ``eps`` is a trainable
    [1] parameter from ``eps`` when ``train_eps``. ``fc`` is flax's
    ``Dense_0``."""

    def __init__(self, in_dim: int, dim: int, eps: float = 0.0,
                 train_eps: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = dim
        self.eps = nn.Parameter(torch.tensor([eps])) if train_eps else eps
        self.fc = dense(in_dim, dim, bias=False, generator=generator)

    def forward(self, x, block: Block) -> torch.Tensor:
        x_tgt, x_src = x
        aggr = block.aggregate_neighbors("add", x_src, block.mask)
        if isinstance(self.eps, torch.Tensor):
            # an f32 eps promotes a low-precision x_tgt, as in flax
            f32 = self.eps.dtype
            h = (1 + self.eps) * x_tgt.to(f32) + aggr.to(f32)
        else:
            h = (1 + self.eps) * x_tgt + aggr
        return self.fc(h.to(self.fc.weight.dtype))


class TAGConv(nn.Module):
    """reference: tag_conv.py (convs.py:136-159): K sym-normalised hops
    (each hop propagates the last, ``_next_src``), concatenated after
    x_tgt, then ``fc``, flax's bias-free ``Dense_0`` on (K+1)·D_in."""

    def __init__(self, in_dim: int, dim: int, K: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K, self.out_dim = K, dim
        self.fc = dense(in_dim * (K + 1), dim, bias=False,
                        generator=generator)

    def forward(self, x, block: Block) -> torch.Tensor:
        x_tgt, x_src = x
        scale = _sym_scale(block)
        xs, cur_src = [x_tgt], x_src
        for _ in range(self.K):
            cur = block.aggregate_neighbors("add", cur_src, scale=scale)
            xs.append(cur)
            cur_src = _next_src(cur, cur_src, block.size)
        h = torch.cat([v.to(self.fc.weight.dtype) for v in xs], dim=-1)
        return self.fc(h)


class SGCNConv(nn.Module):
    """reference: sgcn_conv.py (convs.py:162-181): K sym-normalised
    propagations, then ``fc``, flax's bias-free ``Dense_0``."""

    def __init__(self, in_dim: int, dim: int, K: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K, self.out_dim = K, dim
        self.fc = dense(in_dim, dim, bias=False, generator=generator)

    def forward(self, x, block: Block) -> torch.Tensor:
        cur_tgt, cur_src = x
        scale = _sym_scale(block)
        for _ in range(self.K):
            cur_tgt = block.aggregate_neighbors("add", cur_src, scale=scale)
            cur_src = _next_src(cur_tgt, cur_src, block.size)
        return self.fc(cur_tgt.to(self.fc.weight.dtype))


def _l2norm(v: torch.Tensor) -> torch.Tensor:
    """Rows over their L2 norm (at least 1e-12), in v's dtype. At a zero
    row the gradient is 1e12 times the cotangent, where the reference's
    (``jnp.linalg.norm``'s sqrt at 0) is NaN; both die at the previous
    layer's relu, so parameter gradients agree."""
    return v / torch.linalg.vector_norm(v, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


class AGNNConv(nn.Module):
    """reference: agnn_conv.py (convs.py:184-200): cosine attention
    ``beta * <x_i/|x_i|, x_j/|x_j|>`` (``beta`` a trainable [1], flax's
    ``beta``), the block softmax, and the attention-weighted sum of the raw
    sources. No projection: ``dim`` is unused and the output is as wide as
    the input. An f32 ``beta`` promotes the scores to f32; the sum stays in
    the dtype of x_src."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = in_dim
        self.beta = nn.Parameter(torch.ones(1))

    def forward(self, x, block: Block) -> torch.Tensor:
        x_tgt, x_src = x
        ni = block.gather_tgt(_l2norm(x_tgt))
        nj = block.gather_src(_l2norm(x_src))
        alpha = (self.beta * (ni * nj)).sum(dim=-1, keepdim=True)
        alpha = block.softmax(alpha, block.mask)
        return block.aggregate_neighbors("add", x_src, scale=alpha)


class APPNPConv(nn.Module):
    """reference: appnp_conv.py (convs.py:203-224): K personalised-pagerank
    steps ``(1 - alpha) * sym_norm_sum + alpha * x_tgt``. No parameters;
    the output is as wide as the input and in its dtype (the reference's
    Python-float weights are weak)."""

    def __init__(self, in_dim: int, dim: int, K: int = 10,
                 alpha: float = 0.1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K, self.alpha, self.out_dim = K, alpha, in_dim

    def forward(self, x, block: Block) -> torch.Tensor:
        x_tgt, x_src = x
        scale = _sym_scale(block)
        out_tgt, out_src = x_tgt, x_src
        for _ in range(self.K):
            aggr = block.aggregate_neighbors("add", out_src, scale=scale)
            out_tgt = (1 - self.alpha) * aggr + self.alpha * x_tgt
            out_src = _next_src(out_tgt, out_src, block.size)
        return out_tgt


class GraphConv(nn.Module):
    """reference: graph_conv.py (convs.py:227-236): the masked mean of
    ``src_fc(x_j)`` plus ``self_fc(x_tgt)``. ``src_fc`` is flax's
    bias-free ``Dense_0``, ``self_fc`` its ``Dense_1``, with a bias."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = dim
        self.src_fc = dense(in_dim, dim, bias=False, generator=generator)
        self.self_fc = dense(in_dim, dim, bias=True, generator=generator)

    def forward(self, x, block: Block) -> torch.Tensor:
        x_tgt, x_src = x
        f32 = self.src_fc.weight.dtype
        aggr = block.aggregate_neighbors("mean", self.src_fc(x_src.to(f32)),
                                         block.mask)
        return self.self_fc(x_tgt.to(f32)) + aggr


class ARMAConv(nn.Module):
    """reference: arma_conv.py (convs.py:239-275): K parallel stacks of T
    recursive layers, ``relu(sym_norm_sum(w(cur_src)) + v(x_tgt))``, then
    the mean over the K stacks. ``ws[t]`` are flax's ``Dense_0..nW-1`` and
    ``vs[t]`` its ``Dense_nW..2nW-1`` (nW = 1 with ``shared_weights``,
    else T), all bias-free and K·dim wide; ``ws[t]`` reads D_in at t = 0
    and K·dim after. Its own propagation rule: where x_src is the
    expanded source set (more rows than targets), the next source set is
    ``cat([out, v(x_src[size0:])])``; elsewhere (the edge list, the
    compact ELL table) it is ``out``."""

    def __init__(self, in_dim: int, dim: int, K: int = 2, T: int = 1,
                 shared_weights: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K, self.T, self.dim, self.out_dim = K, T, dim, dim
        self.shared_weights = shared_weights
        nW = 1 if shared_weights else T
        self.ws = nn.ModuleList(
            dense(in_dim if t == 0 else K * dim, K * dim, bias=False,
                  generator=generator) for t in range(nW))
        self.vs = nn.ModuleList(
            dense(in_dim, K * dim, bias=False, generator=generator)
            for _ in range(nW))

    def forward(self, x, block: Block) -> torch.Tensor:
        x_tgt, x_src = x
        size = block.size
        f32 = self.vs[0].weight.dtype
        scale = _sym_scale(block)
        cur_src, out = x_src, None
        for t in range(self.T):
            i = 0 if self.shared_weights else t
            w, v = self.ws[i], self.vs[i]
            aggr = block.aggregate_neighbors("add", w(cur_src.to(f32)),
                                             scale=scale)
            out = torch.relu(aggr + v(x_tgt.to(f32)))
            if size[1] > size[0] and x_src.shape[0] == size[1]:
                cur_src = torch.cat([out, v(x_src[size[0]:].to(f32))])
            else:
                cur_src = out
        return out.reshape(-1, self.K, self.dim).mean(dim=1)


class DNAConv(nn.Module):
    """reference: dna_conv.py (convs.py:278-310): a shared bias-free
    ``in_fc`` (flax's ``Dense_0``) on both endpoints, per-edge
    ``q_i . k_j / sqrt(d / heads)`` per head through a sigmoid gate (the
    reference's restricted softmax over one key), the gated ``v_j``, and
    the masked mean over each target's edges. ``q``, ``k`` and ``v`` are
    ``Dense_1``-``Dense_3``, each with a bias."""

    def __init__(self, in_dim: int, dim: int, heads: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.out_dim = heads, dim
        self.in_fc = dense(in_dim, dim, bias=False, generator=generator)
        self.q = dense(dim, dim, generator=generator)
        self.k = dense(dim, dim, generator=generator)
        self.v = dense(dim, dim, generator=generator)

    def forward(self, x, block: Block) -> torch.Tensor:
        x_tgt, x_src = x
        f32 = self.in_fc.weight.dtype
        d, h = self.out_dim, self.heads
        dh = d // h
        x_tgt, x_src = self.in_fc(x_tgt.to(f32)), self.in_fc(x_src.to(f32))
        q = block.gather_tgt(self.q(x_tgt)).reshape(-1, h, dh)
        k = block.gather_src(self.k(x_src)).reshape(-1, h, dh)
        v = block.gather_src(self.v(x_src)).reshape(-1, h, dh)
        gate = torch.sigmoid((q * k).sum(dim=-1) / math.sqrt(dh))   # [E, h]
        msg = (gate[:, :, None] * v).reshape(-1, d)
        return block.scatter("mean", msg, block.mask)


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell`` (not ``torch.nn.GRUCell``, which also has
    biases on the hidden-state gates ``hr`` and ``hz``):

        r = sigmoid(ir(x) + hr(h)),  z = sigmoid(iz(x) + hz(h))
        n = tanh(in(x) + r * hn(h)),  h' = (1 - z) * n + z * h

    ``ir``, ``iz``, ``in`` and ``hn`` have a bias, ``hr`` and ``hz`` none.
    Input kernels start lecun-normal (flax's Dense default), recurrent
    kernels orthogonal, biases zero; called as flax's ``cell(h, x)``."""

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gates = nn.ModuleDict()
        for name in ("ir", "iz", "in"):
            self.gates[name] = dense(in_dim, dim, generator=generator)
        for name in ("hr", "hz", "hn"):
            lin = nn.Linear(dim, dim, bias=name == "hn")
            with torch.no_grad():
                nn.init.orthogonal_(lin.weight, generator=generator)
                if lin.bias is not None:
                    lin.bias.zero_()
            self.gates[name] = lin

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        f = self.gates
        f32 = f["ir"].weight.dtype
        h, x = h.to(f32), x.to(f32)
        r = torch.sigmoid(f["ir"](x) + f["hr"](h))
        z = torch.sigmoid(f["iz"](x) + f["hz"](h))
        n = torch.tanh(f["in"](x) + r * f["hn"](h))
        return (1.0 - z) * n + z * h


class GatedConv(nn.Module):
    """reference: gated_graph_conv.py (convs.py:313-334): a bias-free
    ``proj`` to ``dim`` where D_in != dim (flax's ``Dense_0``, which then
    shifts the per-step Denses by one), then ``processing_steps`` rounds
    of a masked sum of ``fcs[i](h_src)`` (flax's ``Dense_{i(+1)}``, bias-
    free) fed to a shared ``GRUCell`` (``GRUCell_0``) as
    ``gru(h_tgt, aggr)``, each round propagating ``h_tgt``
    (``_next_src``)."""

    def __init__(self, in_dim: int, dim: int, processing_steps: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_dim = dim
        self.proj = dense(in_dim, dim, bias=False, generator=generator) \
            if in_dim != dim else None
        self.gru = GRUCell(dim, dim, generator=generator)
        self.fcs = nn.ModuleList(
            dense(dim, dim, bias=False, generator=generator)
            for _ in range(processing_steps))

    def forward(self, x, block: Block) -> torch.Tensor:
        h_tgt, h_src = x
        f32 = self.gru.gates["ir"].weight.dtype
        if self.proj is not None:
            h_tgt, h_src = self.proj(h_tgt.to(f32)), self.proj(h_src.to(f32))
        for fc in self.fcs:
            aggr = block.aggregate_neighbors("add", fc(h_src.to(f32)),
                                             block.mask)
            h_tgt = self.gru(h_tgt, aggr)
            h_src = _next_src(h_tgt, h_src, block.size)
        return h_tgt


class RelationConv(nn.Module):
    """reference: relation_conv.py:33-69 (convs.py:337-391): per-relation
    sums of raw source features, then one product with the relation
    matrices. The regular layout sums with one einsum over one-hot
    relations; an irregular or a shared-source block (whose sources are
    not a per-target [T, C] stack) runs one masked scatter per relation,
    as the reference's ``not block.shared_src`` guard does.

    ``matrix`` [R, dim, D_in] is flax's ``matrix``, initialised as
    ``variance_scaling(1, "fan_avg", "truncated_normal")`` for that shape
    (fan_in = dim * R, fan_out = D_in * R); ``self_fc`` is ``Dense_0``.
    ``edge_attr`` [E] is clipped to [0, R); a self loop counts under its
    attr (``GNNNet`` feeds relation 0). The sum over valid edges is
    divided by their count (at least 1e-7), then ``self_fc(x_tgt)`` is
    added.

    ``per_relation=True`` is R-GCN's layer instead (Schlichtkrull et al.,
    arXiv:1703.06103, eq. 2, as OGB's full-batch R-GCN for ogbn-mag runs
    it): each relation's sum divided by its own count (a relation with no
    valid edge adds 0), and in place of ``self_fc`` a root linear with
    bias for each of ``node_types`` node types, ``root_weight`` [T, dim,
    D_in] and ``root_bias`` [T, dim]. It runs over a typed whole-graph
    block (``Block.rel``, ``WholeDataFlow(layout="rel")``): the relation
    of each edge is its edge type, node type k's nodes are ids
    [type_lo[k], type_lo[k + 1]) of the graph's ``rel`` pack (one type:
    every node), and the layer runs fused (``Block.relation_mean``, in the
    span ``relation``), its messages rounded to x's type; ``edge_attr`` is
    not read."""

    def __init__(self, in_dim: int, dim: int, num_relations: int = 1,
                 per_relation: bool = False, node_types: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        R = num_relations
        fan_avg = (dim * R + in_dim * R) / 2.0
        std = math.sqrt(1.0 / fan_avg) / 0.87962566103423978
        self.num_relations = R
        self.out_dim = dim
        self.per_relation = per_relation
        self.matrix = nn.Parameter(_trunc_normal((R, dim, in_dim), std,
                                                 generator))
        if per_relation:
            std = math.sqrt(1.0 / in_dim) / 0.87962566103423978
            self.root_weight = nn.Parameter(_trunc_normal(
                (node_types, dim, in_dim), std, generator))
            self.root_bias = nn.Parameter(torch.zeros(node_types, dim))
        else:
            self.self_fc = dense(in_dim, dim, bias=False,
                                 generator=generator)

    def forward(self, x, block: Block,
                edge_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_tgt, x_src = x
        if self.per_relation:
            if block.rel is None:
                raise ValueError("per_relation needs a typed whole-graph "
                                 "block (WholeDataFlow(layout='rel'))")
            T = self.root_weight.shape[0]
            type_lo = block.rel.pack.type_lo if T > 1 else (0, block.size[0])
            if len(type_lo) != T + 1:
                raise ValueError(f"{T} root linears, but the graph's rel "
                                 f"pack has node type ranges {type_lo}")
            with span("relation"):
                return block.relation_mean(
                    x_src, self.matrix, self.root_weight, self.root_bias,
                    type_lo, x_src.dtype)
        R = self.num_relations
        x_src = block.source_set(x_src)
        dt = x_src.dtype
        if edge_attr is None:
            edge_attr = torch.zeros(block.edge_index.shape[1],
                                    dtype=torch.int64, device=x_src.device)
        attr = edge_attr.long().clamp(0, R - 1)
        m = block.mask.to(dt)
        if block.fanout is None or block.shared_src:
            xj = block.gather_src(x_src)
            s = torch.stack([block.scatter("add", xj * (
                (attr == r).to(dt) * m)[:, None]) for r in range(R)], 1)
        else:
            T, C = block.size[0], block.fanout
            at_s, at_l = block._split(attr)
            m_s, m_l = block._split(m)
            oh_s = torch.nn.functional.one_hot(at_s, R).to(dt) \
                * m_s[..., None]
            xj_s = x_src[T:].reshape(T, C, -1)
            s = torch.einsum("tcf,tcr->trf", xj_s, oh_s)        # [T, R, f]
            if block.self_loops:
                oh_l = torch.nn.functional.one_hot(at_l, R).to(dt) \
                    * m_l[..., None]
                s = s + x_src[:T, None, :] * oh_l[..., None]
        f32 = self.matrix.dtype
        tot = torch.einsum("trf,rdf->td", s.to(f32), self.matrix)
        cnt = block.scatter("add", torch.ones((attr.shape[0], 1), dtype=dt,
                                              device=x_src.device),
                            block.mask)                       # valid edges
        aggr = tot / cnt.to(f32).clamp_min(1e-7)
        return self.self_fc(x_tgt.to(f32)) + aggr


#: registry names, as the reference's ``_CONVS`` (convs.py:394-413)
_CONVS = {
    "gcn": GCNConv,
    "sage": SAGEConv,
    "graphsage": SAGEConv,
    "gat": GATConv,
    "gin": GINConv,
    "tag": TAGConv,
    "tagcn": TAGConv,
    "sgcn": SGCNConv,
    "agnn": AGNNConv,
    "appnp": APPNPConv,
    "graph": GraphConv,
    "graphgcn": GraphConv,
    "arma": ARMAConv,
    "dna": DNAConv,
    "gated": GatedConv,
    "gated_graph": GatedConv,
    "relation": RelationConv,
    "rgcn": RelationConv,
}


def get_conv_class(name: str):
    """reference: mp_utils/utils.py get_conv_class."""
    return _CONVS[name]
