"""GeniePath and LGCN nets.

Counterpart of euler_tpu/models/extra_nets.py (reference: examples/
geniepath and examples/lgcn with tf_euler/python/utils/encoders.py's
GenieEncoder and LGCNEncoder). Both run the blocks of a sampled flow
deepest first and pick the roots' rows at the end, as ``GNNNet`` does.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.models.convs import dense
from euler_tpu_torch.models.gnn import _pick_roots
from euler_tpu_torch.models.layers import LSTMCell


class GeniePathLazyNet(nn.Module):
    """GeniePath, lazy form (reference: extra_nets.py:24-71): ``in_fc`` to
    ``dims[0]``; per block i a breadth step, an additive attention
    (``w_src_i``, ``w_dst_i``, ``att_i``, tanh) whose weighted sum of the
    sources goes through ``b_fc_i`` and tanh, then a depth step, the LSTM
    cell (``OptimizedLSTMCell_0``, one for all blocks) on that sum with
    the previous block's carry cut to this block's targets (zeros at the
    first); ``out_fc`` to ``dims[-1]``."""

    def __init__(self, flow: Any, dims: Sequence[int], feature: nn.Module,
                 in_dim: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.flow, self.dims, self.feature = flow, tuple(dims), feature
        dim = self.dims[0]
        self.in_fc = dense(in_dim, dim, generator=generator)
        self.lstm = LSTMCell(dim, dim, generator)
        self.layers = nn.ModuleList(nn.ModuleDict(dict(
            w_src=dense(dim, dim, bias=False, generator=generator),
            w_dst=dense(dim, dim, bias=False, generator=generator),
            att=dense(dim, 1, bias=False, generator=generator),
            b_fc=dense(dim, dim, generator=generator)))
            for _ in range(flow.num_layers))
        self.out_fc = dense(dim, self.dims[-1], generator=generator)
        self.to(resolve_device(device))

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None) -> torch.Tensor:
        blocks = self.flow(g, roots, generator=generator, uniforms=uniforms)
        x = self.in_fc(self.feature(g, blocks[0].n_id))
        carry = None
        for fc, block in zip(self.layers, blocks):
            T, mask = block.size[0], block.mask
            hi = block.gather_tgt(fc["w_dst"](x[:T]))
            hj = block.gather_src(fc["w_src"](x))
            alpha = block.softmax(fc["att"](torch.tanh(hi + hj)), mask)
            msg = block.gather_src(x) * alpha * mask[:, None]
            aggr = torch.tanh(fc["b_fc"](block.scatter("add", msg, None)))
            if carry is None:
                carry = self.lstm.zero_carry(T, aggr)
            else:
                carry = (carry[0][:T], carry[1][:T])
            carry, x = self.lstm(carry, aggr)
        return _pick_roots(self.out_fc(x), roots)


class LGCNNet(nn.Module):
    """LGCN's ranked channel pooling (reference: extra_nets.py:74-104): per
    block i, each target's ``min(k, fanout)`` largest values of every
    channel over its valid sampled neighbors (0 where fewer), joined to
    its own row, through ``fc_i`` to ``dims[i]`` and relu; ``out_fc`` to
    ``dims[-1]``. Needs a fanout flow (``flow.fanouts``): a target's
    neighbors are its ``fanout`` contiguous source rows. Only the top
    values are kept, so ties among them do not matter."""

    def __init__(self, flow: Any, dims: Sequence[int], feature: nn.Module,
                 in_dim: int, k: int = 4, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.flow, self.dims, self.feature, self.k = (flow, tuple(dims),
                                                      feature, k)
        width, fcs = in_dim, []
        # blocks run deepest first: block i samples hop n - 1 - i
        for i, cnt in enumerate(list(flow.fanouts)[::-1]):
            fcs.append(dense(width * (1 + min(k, cnt)), self.dims[i],
                             generator=generator))
            width = self.dims[i]
        self.fcs = nn.ModuleList(fcs)
        self.out_fc = dense(width, self.dims[-1], generator=generator)
        self.to(resolve_device(device))

    def forward(self, g: GraphTensors, roots: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None) -> torch.Tensor:
        blocks = self.flow(g, roots, generator=generator, uniforms=uniforms)
        x = self.feature(g, blocks[0].n_id)
        for fc, block in zip(self.fcs, blocks):
            T, S = block.size
            cnt = (S - T) // T
            nbrs = x[T:].reshape(T, cnt, -1)
            ok = (block.n_id[T:] >= 0).reshape(T, cnt, 1)
            vals = torch.where(ok, nbrs, float("-inf")).transpose(1, 2)
            top = vals.topk(min(self.k, cnt), dim=2).values      # [T, D, k]
            top = torch.where(torch.isfinite(top), top, 0.0)
            x = torch.relu(fc(torch.cat([x[:T], top.reshape(T, -1)], -1)))
        return _pick_roots(self.out_fc(x), roots)
