"""Multi-group GNN nets: one root group per tower.

Counterpart of euler_tpu/models/group_gnn.py (reference:
tf_euler/python/mp_utils/group_gnn.py:29-138). ``GroupGNNNet`` runs one
independent net per root group; ``SharedGroupGNNNet`` shares one conv
stack and ``out_fc`` across the groups, each group sampling through its
own flow. ``uniforms`` is a list with one entry per group (that group's
per-hop uniforms), or None.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.dataflow.flows import WholeDataFlow
from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.models import convs as convs_lib


def _group_uniforms(uniforms, n: int):
    if uniforms is None:
        return [None] * n
    if len(uniforms) != n:
        raise ValueError(f"need {n} uniform entries, one per group, got "
                         f"{len(uniforms)}")
    return uniforms


class GroupGNNNet(nn.Module):
    """Independent per-group nets: ``out[i] = gnns[i](roots[i])``, each
    with its own parameters (reference: group_gnn.py:25-40; flax's
    ``gnns_i``)."""

    def __init__(self, gnns: Sequence[nn.Module], device=None):
        super().__init__()
        self.gnns = nn.ModuleList(gnns)
        self.dims = self.gnns[0].dims
        self.to(resolve_device(device))

    def forward(self, g: GraphTensors, group_roots: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None):
        if len(group_roots) != len(self.gnns):
            raise ValueError(
                f"GroupGNNNet has {len(self.gnns)} towers but got "
                f"{len(group_roots)} root groups")
        u = _group_uniforms(uniforms, len(self.gnns))
        return [tower(g, roots, generator=generator, uniforms=ui)
                for tower, roots, ui in zip(self.gnns, group_roots, u)]


class SharedGroupGNNNet(nn.Module):
    """One conv stack (``conv_i`` at ``dims[:-1]``) and one ``out_fc`` (to
    ``dims[-1]``) shared by the root groups; group i samples through
    ``group_flows[i]`` and runs as many convs as its flow has blocks
    (reference: group_gnn.py:43-82). Whole-graph flows are refused.
    ``feature`` is the shared encoder, ``in_dim`` its width; ``dtype``
    casts the activations between stages."""

    def __init__(self, conv: str, group_flows: Sequence[Any],
                 dims: Sequence[int], feature: nn.Module, in_dim: int,
                 conv_kwargs: Optional[dict] = None, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for flow in group_flows:
            if isinstance(flow, WholeDataFlow):
                raise ValueError("Group GNN does not support whole dataflow")
        self.group_flows = list(group_flows)
        self.dims, self.feature, self.dtype = tuple(dims), feature, dtype
        cls = convs_lib.get_conv_class(conv)
        widths, convs = [in_dim], []
        for d in self.dims[:-1]:
            convs.append(cls(widths[-1], d, generator=generator,
                             **(conv_kwargs or {})))
            widths.append(convs[-1].out_dim)
        self.convs = nn.ModuleList(convs)
        self.out_fc = convs_lib.dense(widths[-1], self.dims[-1],
                                      generator=generator)
        self.to(resolve_device(device))

    def forward(self, g: GraphTensors, group_roots: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence] = None):
        if len(group_roots) != len(self.group_flows):
            raise ValueError(
                f"SharedGroupGNNNet has {len(self.group_flows)} flows but "
                f"got {len(group_roots)} root groups")
        outs = []
        for flow, roots, u in zip(self.group_flows, group_roots,
                                  _group_uniforms(uniforms,
                                                  len(self.group_flows))):
            blocks = flow(g, roots, generator=generator, uniforms=u)
            x = self.feature(g, blocks[0].n_id)
            if self.dtype is not None:
                x = x.to(self.dtype)
            for conv, block in zip(self.convs, blocks):
                x = torch.relu(conv((x[: block.size[0]], x), block))
                if self.dtype is not None:
                    x = x.to(self.dtype)
            outs.append(self.out_fc(x.to(self.out_fc.weight.dtype)))
        return outs
