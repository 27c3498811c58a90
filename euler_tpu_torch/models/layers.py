"""Building-block layers: embeddings (plain, sparse, hashed, and
sharded over the mesh's graph axis), additive attention, and flax's LSTM
cell with a layer over it.

Counterpart of euler_tpu/models/layers.py (reference:
tf_euler/python/utils/layers.py:119-270). The embedding tables are
``encoders.Embed`` (flax's ``nn.Embed``: ids past the table read NaN
rows, the gradient an ``index_add_``), but for ``ShardedEmbedding``,
which reads as a jnp index does: one table on one device, and over the
mesh (after ``shard_over``) one block of it a rank, read through the
shard owners. Weights come from ``generator``, a CPU torch.Generator;
the module is then moved to ``device``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.models.convs import dense
from euler_tpu_torch.models.encoders import Embed, _Lookup
from euler_tpu_torch.ops.dispatch import is_shard_view
from euler_tpu_torch.parallel.mesh import mark_graph_sharded
from euler_tpu_torch.parallel.sharded import fold_seed, owner_rows


def _combine(emb: torch.Tensor, mask: torch.Tensor,
             combiner: str) -> torch.Tensor:
    """Sum (or mean over at least 1) of ``emb`` [..., L, D] over the
    valid entries of ``mask`` [..., L]."""
    m = mask[..., None].to(emb.dtype)
    s = (emb * m).sum(dim=-2)
    if combiner == "mean":
        s = s / m.sum(dim=-2).clamp_min(1.0)
    return s


class Embedding(nn.Module):
    """Id -> dense vector (reference: layers.py:25-37): a ``max_id + 2``
    row table ``embeddings`` whose last row serves id -1 and is zeroed on
    output."""

    def __init__(self, max_id: int, dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_id = max_id
        self.embeddings = Embed(max_id + 2, dim, generator)
        self.to(resolve_device(device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ok = ids >= 0
        out = self.embeddings(torch.where(ok, ids.long(), self.max_id + 1))
        return torch.where(ok[..., None], out, 0.0)


class ShardedEmbedding(nn.Module):
    """The reference's graph-axis-sharded table (layers.py:62-124).

    On one device it is the reference's non-mesh branch: a [num, dim]
    table ``embedding`` read as a jnp index reads it: an id past the
    table reads the last row and sends it no gradient (XLA clamps the
    gather and drops the scatter of its transpose); rows of ids < 0 are
    zeroed.

    Over the mesh, ``shard_over(mesh, seed)`` (which
    ``parallel.train.init_sharded_params`` calls) replaces the table by
    this rank's block [ceil(num / S), dim], drawn from ``seed`` folded by
    the graph index (the reference's ``shard_init``) and marked
    graph-sharded: row r lives on shard r % S at local row r // S. It is
    then read over a ``ShardView`` of that mesh through the owners
    (``sharded.owner_rows``: all_gather, a local take, a tiled
    all_to_all and a sum over S), so its gradient is the sum of the
    graph group's contributions to each owned row. A mesh checkpoint's
    table layout differs from a one-device one (layers.py:79)."""

    def __init__(self, num: int, dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num, self.dim = num, dim
        self.num_shards = None          # the graph axis after shard_over
        # nn.Embed's default init, variance_scaling(1, fan_in, normal)
        self.embedding = nn.Parameter(torch.randn(
            (num, dim), generator=generator) / math.sqrt(dim))
        self.to(resolve_device(device))

    def shard_over(self, mesh, seed: int = 0) -> None:
        """Hold this rank's block of the table over ``mesh``'s graph axis."""
        S = mesh.graph
        gen = torch.Generator().manual_seed(fold_seed(seed,
                                                      mesh.graph_index))
        block = torch.randn((-(-self.num // S), self.dim),
                            generator=gen) / math.sqrt(self.dim)
        self.embedding = mark_graph_sharded(
            nn.Parameter(block.to(self.embedding.device)), mesh)
        self.num_shards = S

    def forward(self, g, ids: torch.Tensor) -> torch.Tensor:
        if self.num_shards is not None or is_shard_view(g):
            if not is_shard_view(g) or g.num_shards != self.num_shards:
                raise ValueError(
                    "a ShardedEmbedding over the mesh reads a ShardView of "
                    "its mesh, after parallel.train.init_sharded_params "
                    f"(its graph axis: {self.num_shards}; the graph's: "
                    f"{getattr(g, 'num_shards', None)})")
            return owner_rows(g, self.embedding, ids)
        ids = ids.to(torch.int64)
        rows = _Lookup.apply(self.embedding,
                             ids.clamp(0, self.num - 1), False)
        rows = torch.where((ids < self.num)[..., None], rows, rows.detach())
        return torch.where((ids >= 0)[..., None], rows, 0.0)


class SparseEmbedding(nn.Module):
    """A padded sparse-id block (ids [..., L], -1 padding) -> the sum or
    mean of its rows (reference: layers.py:127-143)."""

    def __init__(self, max_id: int, dim: int, combiner: str = "sum",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if combiner not in ("sum", "mean"):
            raise ValueError(f"combiner {combiner!r} not in sum, mean")
        self.max_id, self.combiner = max_id, combiner
        self.embeddings = Embed(max_id + 2, dim, generator)
        self.to(resolve_device(device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        mask = ids >= 0
        emb = self.embeddings(torch.where(mask, ids.long(), self.max_id + 1))
        return _combine(emb, mask, self.combiner)


class HashEmbedding(nn.Module):
    """Unbounded ids mod ``buckets`` into a table (reference:
    layers.py:146-170); with ``sparse`` the ids are a padded block whose
    rows are combined, else one row per id (0 for ids < 0)."""

    def __init__(self, buckets: int, dim: int, combiner: str = "sum",
                 sparse: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if combiner not in ("sum", "mean"):
            raise ValueError(f"combiner {combiner!r} not in sum, mean")
        self.buckets, self.combiner, self.sparse = buckets, combiner, sparse
        self.embeddings = Embed(buckets, dim, generator)
        self.to(resolve_device(device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        mask = ids >= 0
        hashed = torch.where(mask, ids.long() % self.buckets, 0)
        emb = torch.where(mask[..., None], self.embeddings(hashed), 0.0)
        if not self.sparse:
            return emb
        return _combine(emb, mask, self.combiner)


class AttLayer(nn.Module):
    """Multi-head additive attention pooling of a sequence [B, L, D] ->
    [B, head_num[-1] * out_dim] (reference: layers.py:173-215).

    Each head of block i scores every position with ``att_{i}_{j}``
    (Dense to 1, bias), takes the softmax over the sequence (masked
    positions -1e9) and sums ``val_{i}_{j}(h)``; a block's heads are
    concatenated. Each hidden block (``hidden_dim[i]`` wide,
    ``head_num[i]`` heads, ``activation`` on each head) then mixes its
    context back into every position: ``h = act(mix_i(h) + ctx_i(ctx))``.
    The last block has ``head_num[-1]`` heads of ``out_dim`` and no
    activation.
    """

    def __init__(self, in_dim: int, out_dim: int,
                 hidden_dim: Sequence[int] = (),
                 head_num: Sequence[int] = (1,),
                 activation: Callable = nn.functional.elu, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(head_num) != len(hidden_dim) + 1:
            raise ValueError("head_num must have len(hidden_dim)+1 entries")
        self.hidden_dim, self.head_num = tuple(hidden_dim), tuple(head_num)
        self.activation = activation
        self.fcs = nn.ModuleDict()
        width = in_dim
        dims = list(self.hidden_dim) + [out_dim]
        for i, (dim, heads) in enumerate(zip(dims, self.head_num)):
            for j in range(heads):
                self.fcs[f"att_{i}_{j}"] = dense(width, 1,
                                                 generator=generator)
                self.fcs[f"val_{i}_{j}"] = dense(width, dim,
                                                 generator=generator)
            if i < len(self.hidden_dim):
                self.fcs[f"mix_{i}"] = dense(width, dim, generator=generator)
                self.fcs[f"ctx_{i}"] = dense(heads * dim, dim,
                                             generator=generator)
                width = dim
        self.to(resolve_device(device))

    def _block(self, h, idx: int, heads: int, act, mask):
        outs = []
        for j in range(heads):
            score = self.fcs[f"att_{idx}_{j}"](h)                 # [B, L, 1]
            if mask is not None:
                score = torch.where(mask[..., None], score, -1e9)
            w = torch.softmax(score, dim=1)
            outs.append(act((w * self.fcs[f"val_{idx}_{j}"](h)).sum(dim=1)))
        return torch.cat(outs, dim=-1)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(f"AttLayer needs [B, L, D], got "
                             f"{tuple(x.shape)}")
        h = x
        for i, heads in enumerate(self.head_num[:-1]):
            ctx = self._block(h, i, heads, self.activation, mask)
            h = self.activation(self.fcs[f"mix_{i}"](h)
                                + self.fcs[f"ctx_{i}"](ctx)[:, None, :])
        return self._block(h, len(self.hidden_dim), self.head_num[-1],
                           lambda v: v, mask)


class LSTMCell(nn.Module):
    """flax's ``nn.OptimizedLSTMCell`` (which computes what
    ``nn.LSTMCell`` does, with its kernels fused):

        i = sigmoid(ii(x) + hi(h)),  f = sigmoid(if(x) + hf(h))
        g = tanh(ig(x) + hg(h)),     o = sigmoid(io(x) + ho(h))
        c' = f * c + i * g,          h' = o * tanh(c')

    The input kernels ``ii``, ``if``, ``ig``, ``io`` have no bias, the
    hidden ones ``hi``, ``hf``, ``hg``, ``ho`` have one (``torch.nn.
    LSTMCell`` has both bias sets, which Adam would train). Input kernels
    start lecun-normal (flax's Dense default), hidden kernels orthogonal,
    biases zero. Called as flax's ``cell((c, h), x) -> ((c', h'), h')``;
    ``zero_carry`` is flax's ``initialize_carry``."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, in_dim: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = dim
        self.gates = nn.ModuleDict()
        for k in self.GATES:
            self.gates[f"i{k}"] = dense(in_dim, dim, bias=False,
                                        generator=generator)
        for k in self.GATES:
            lin = nn.Linear(dim, dim)
            with torch.no_grad():
                nn.init.orthogonal_(lin.weight, generator=generator)
                lin.bias.zero_()
            self.gates[f"h{k}"] = lin

    def zero_carry(self, batch: int, like: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = like.new_zeros((batch, self.dim))
        return z, z

    def forward(self, carry, x: torch.Tensor):
        c, h = carry
        f = self.gates
        pre = {k: f[f"i{k}"](x) + f[f"h{k}"](h) for k in self.GATES}
        c = torch.sigmoid(pre["f"]) * c + torch.sigmoid(pre["i"]) \
            * torch.tanh(pre["g"])
        h = torch.sigmoid(pre["o"]) * torch.tanh(c)
        return (c, h), h


class LSTMLayer(nn.Module):
    """An LSTM over [B, L, D] from a zero carry (reference:
    layers.py:218-233, a scanned ``OptimizedLSTMCell``): (outputs
    [B, L, out_dim], the final carry (c, h))."""

    def __init__(self, in_dim: int, out_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cell = LSTMCell(in_dim, out_dim, generator)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor):
        carry = self.cell.zero_carry(x.shape[0], x)
        ys = []
        for t in range(x.shape[1]):
            carry, y = self.cell(carry, x[:, t])
            ys.append(y)
        return torch.stack(ys, dim=1), carry
