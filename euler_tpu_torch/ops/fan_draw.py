"""Fused fan-row neighbor draw: the CUDA kernel and its plain version.

``fan_draw`` replaces euler_tpu/ops/pallas_fan.py::fan_draw (the Pallas
TPU kernel) and the XLA gather, mask and lane decode around it in the K=1
and union branches of euler_tpu/ops/sampling.py::sample_neighbor_fast.
For each frontier node and each draw it reads the node's fan row
(ops/alias.py FAN_* layout), picks a slot from ``u1``, keeps or aliases
it by ``u2``, and masks invalid rows to ``default_id``. With
``union=True`` the rows are union rows (ops/alias.py FANU_*): the picked
lane is decoded into its id and its edge type. With ``return_types`` it
also returns each draw's edge type (-1 where invalid).

For a CUDA tensor the wrapper launches csrc/fan_draw.cu (built with nvcc
for sm_90a on first use, bound with ctypes) or raises; for a CPU tensor
it runs ``fan_draw_plain``, the same function in plain PyTorch. There is
no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from euler_tpu_torch._build import kernel_device, launch, load_cuda_library
from euler_tpu_torch.ops.alias import (FAN_ALIAS_OFF, FAN_D, FAN_KEPT_OFF,
                                       FAN_LANES, FAN_PROB_OFF, FANU_MASK,
                                       FANU_SHIFT)

def build():
    """The kernel library's ctypes handle (``load_cuda_library``);
    ``etpu_fan_draw_path`` is the same draw with its path named
    (chip_smoke.py times both)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    args = [vp, i64, vp, i64, i32, i32, i32, vp, vp, i32, vp, vp, vp, i32,
            vp]
    return load_cuda_library("fan_draw", {"etpu_fan_draw": args,
                                          "etpu_fan_draw_path": args + [i32]})


def _check(fan_pack, nodes, et, num_edge_types, u1, u2, union):
    dev = fan_pack.device
    for name, t, dt in (("fan_pack", fan_pack, torch.int32),
                        ("nodes", nodes, torch.int32),
                        ("u1", u1, torch.float32),
                        ("u2", u2, torch.float32)):
        if t.device != dev:
            raise ValueError(f"fan_draw: {name} is on {t.device}, "
                             f"fan_pack on {dev}")
        if t.dtype != dt:
            raise TypeError(f"fan_draw: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fan_draw: {name} must be contiguous")
    if fan_pack.dim() != 2 or fan_pack.shape[1] != FAN_LANES \
            or fan_pack.shape[0] == 0:
        raise ValueError(f"fan_draw: fan_pack must be [G>0, {FAN_LANES}], "
                         f"got {tuple(fan_pack.shape)}")
    if nodes.dim() != 1 or u1.dim() != 2 or u1.shape != u2.shape \
            or u1.shape[0] != nodes.shape[0]:
        raise ValueError(
            f"fan_draw: need nodes [B], u1/u2 [B, C]; got "
            f"{tuple(nodes.shape)}, {tuple(u1.shape)}, {tuple(u2.shape)}")
    if not 0 <= et < num_edge_types:
        raise ValueError(f"fan_draw: edge type {et} not in "
                         f"[0, {num_edge_types})")
    if union and num_edge_types != 1:
        raise ValueError("fan_draw: union rows are one per node; pass "
                         "num_edge_types=1, et=0")


def fan_draw_plain(fan_pack, nodes, et: int, num_edge_types: int, u1, u2,
                   default_id: int = -1, union: bool = False,
                   return_types: bool = False):
    """Plain PyTorch version of the kernel, on any device.

    Returns (ids int32 [B, C], valid bool [B, C]), and types int32 [B, C]
    with ``return_types``. Prob and weight-sum lanes are reinterpreted
    with ``.view(torch.float32)``, never cast.
    """
    G = fan_pack.shape[0]
    rows = (nodes.clamp_min(0).long() * num_edge_types + et).clamp_max(G - 1)
    packs = fan_pack.index_select(0, rows)                      # [B, 128]
    deg = packs[:, 0:1]                                         # [B, 1]
    wsum = packs[:, 1].view(torch.float32)
    slot = (u1 * deg.to(torch.float32)).to(torch.int32)         # truncates
    slot = torch.minimum(slot.clamp_min(0), (deg - 1).clamp_min(0))
    slot = slot.clamp_max(FAN_D - 1).long()
    prob = torch.gather(packs, 1, FAN_PROB_OFF + slot).view(torch.float32)
    draw = torch.where(u2 < prob,
                       torch.gather(packs, 1, FAN_KEPT_OFF + slot),
                       torch.gather(packs, 1, FAN_ALIAS_OFF + slot))
    valid = ((nodes >= 0)[:, None] & (deg > 0) & (wsum > 0)[:, None]
             ).expand(draw.shape).contiguous()
    ids = torch.where(valid, draw & FANU_MASK if union else draw, default_id)
    if not return_types:
        return ids, valid
    ty = draw >> FANU_SHIFT if union else torch.full_like(draw, et)
    return ids, valid, torch.where(valid, ty, -1)


def fan_draw(fan_pack, nodes, et: int, num_edge_types: int, u1, u2,
             default_id: int = -1, union: bool = False,
             return_types: bool = False):
    """Weighted in-row draws for each node of ``nodes``.

    fan_pack int32 [G, 128] (G = N * num_edge_types; union rows: G = N,
    ``num_edge_types=1``, ``et=0``), nodes int32 [B] (-1 = no node),
    u1/u2 f32 [B, C] uniforms in [0, 1). Returns (ids int32 [B, C], valid
    bool [B, C]) and, with ``return_types``, types int32 [B, C]: the
    decoded type of a union lane, else ``et``; -1 where invalid. Invalid
    draws hold ``default_id``. ``fan_draw.launches`` counts kernel
    launches.
    """
    _check(fan_pack, nodes, et, num_edge_types, u1, u2, union)
    if not kernel_device("fan_draw", fan_pack):
        return fan_draw_plain(fan_pack, nodes, et, num_edge_types, u1, u2,
                              default_id, union, return_types)
    lib = build()
    B, C = u1.shape
    dev = fan_pack.device
    ids = torch.empty((B, C), dtype=torch.int32, device=dev)
    valid = torch.empty((B, C), dtype=torch.bool, device=dev)
    types = torch.empty((B, C), dtype=torch.int32, device=dev) \
        if return_types else None
    launch("fan_draw", lib.etpu_fan_draw, dev, fan_pack.data_ptr(),
           fan_pack.shape[0], nodes.data_ptr(), B, C, et, num_edge_types,
           u1.data_ptr(), u2.data_ptr(), default_id, ids.data_ptr(),
           valid.data_ptr(), None if types is None else types.data_ptr(),
           int(union))
    fan_draw.launches += 1
    return (ids, valid, types) if return_types else (ids, valid)


fan_draw.launches = 0
