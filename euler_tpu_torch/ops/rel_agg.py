"""Typed mean aggregate over the CSR grouped by (node, relation), and its
transpose: the CUDA kernels and their plain versions.

R-GCN's per-relation mean (Schlichtkrull et al., arXiv:1703.06103, eq. 2)
over a whole graph whose CSR groups each node's out-edges by edge type,
``GraphTensors.group_ptr[t * R + r]``. For each node t::

    forward:    out[t] = root[t] + sum over relations r with c(t, r) > 0
                         of 1 / c(t, r) * sum over the cells e of segment
                         (t, r) of rows[r][cells[e] - lo[r]]
    transpose:  d[r][u - lo[r]] = sum over the cells e of segment (u, r) of
                         the transposed CSR of w[e] * g[cells[e]]

``rows[r]`` is relation r's message table, a 2-D view [hi - lo, F] (any
row stride) holding a row for each neighbour id in [lo[r], hi[r]), and
``roots[k]`` a view [type_lo[k + 1] - type_lo[k], F] f32 of node type k's
root rows, or None for no root. The transpose reads the transposed CSR
(``graph.store.RelPack``: segment (u, r) lists the nodes t whose segment
(t, r) reads u, with w = 1 / c(t, r)) and writes relation r's f32 gradient
rows into ``d[r]``, a view like ``rows[r]``, zero where the segment is
empty. Relations outside ``mask`` take no part: no term of the forward and
zero rows in the transpose.

Sums are f32 in a fixed order with no atomics, on the card and here. A
segment longer than ``HUB`` cells is summed in chunks of at most ``HUB``
cells (``RelHubs``, built once with the pack), so that a node with
tens of thousands of neighbours holds no warp for the whole kernel.

For a CUDA tensor each wrapper launches csrc/rel_agg.cu (built with nvcc
for sm_90a on first use, bound with ctypes) or raises; for a CPU tensor
it runs the plain version. There is no fallback from the kernel to the
plain version, and no path builds a row a cell (an [E, F] tensor).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from euler_tpu_torch._build import kernel_device, launch, load_cuda_library

DTYPES = (torch.float32, torch.bfloat16)
#: the longest segment one warp sums; longer ones go in chunks this long
HUB = 256
#: the kernels' limits on relations and node types (csrc/rel_agg.cu)
MAX_RELATIONS = 31
MAX_TYPES = 16


@dataclasses.dataclass
class RelHubs:
    """The segments longer than ``HUB`` cells of one CSR, in chunks:
    ``chunks`` int32 [K, 3] (segment, first cell, end cell), ``seg`` int32
    [H] the long segments, sorted, and ``ptr`` int32 [H + 1], segment
    seg[h]'s chunks ptr[h] .. ptr[h + 1]."""

    chunks: torch.Tensor
    seg: torch.Tensor
    ptr: torch.Tensor

    @staticmethod
    def build_np(seg_ptr: np.ndarray, hub: int = HUB) -> dict:
        """The three arrays of a CSR's ``seg_ptr`` [S + 1], numpy."""
        sp = np.asarray(seg_ptr, np.int64)
        cnt = np.diff(sp)
        seg = np.nonzero(cnt > hub)[0]
        per = -(-cnt[seg] // hub)
        ptr = np.zeros(len(seg) + 1, np.int64)
        ptr[1:] = np.cumsum(per)
        owner = np.repeat(seg, per)
        k = np.arange(ptr[-1], dtype=np.int64) - np.repeat(ptr[:-1], per)
        lo = sp[owner] + k * hub
        hi = np.minimum(lo + hub, sp[owner + 1])
        chunks = np.stack([owner, lo, hi], axis=1) if len(owner) else \
            np.zeros((0, 3), np.int64)
        return dict(chunks=chunks.astype(np.int32), seg=seg.astype(np.int32),
                    ptr=ptr.astype(np.int32))

    def to(self, device) -> "RelHubs":
        return RelHubs(*(t.to(device) for t in (self.chunks, self.seg,
                                                self.ptr)))


class _Layout(ctypes.Structure):
    """csrc/rel_agg.cu's ``struct Layout``, field for field."""
    _fields_ = [("rel_base", ctypes.c_int64 * 32),
                ("rel_stride", ctypes.c_int64 * 32),
                ("rel_lo", ctypes.c_int32 * 32),
                ("rel_hi", ctypes.c_int32 * 32),
                ("root_base", ctypes.c_int64 * MAX_TYPES),
                ("root_stride", ctypes.c_int64 * MAX_TYPES),
                ("type_lo", ctypes.c_int32 * (MAX_TYPES + 1)),
                ("n_rel", ctypes.c_int32),
                ("n_types", ctypes.c_int32),
                ("mask", ctypes.c_uint32),
                ("hub", ctypes.c_int32)]


def build():
    """The kernel library's ctypes handle (``load_cuda_library``)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return load_cuda_library("rel_agg", {
        "etpu_rel_mean": [vp, vp, vp, i64, i64, i32, vp, i64, vp, vp, i64,
                          vp, vp],
        "etpu_rel_mean_tr": [vp, vp, vp, vp, vp, i64, i64, i32, vp, i64, vp,
                             vp, i64, vp]})


def _check_views(name: str, views, lo, F: int, dtypes, device) -> None:
    R = len(views)
    if R > MAX_RELATIONS or len(lo) != R:
        raise ValueError(f"{name}: {R} relations (at most {MAX_RELATIONS}) "
                         f"and {len(lo)} lower ids")
    for r, v in enumerate(views):
        if v is None:
            continue
        if v.dim() != 2 or v.shape[1] != F or v.stride(1) != 1 \
                or v.dtype not in dtypes or v.device != device:
            raise TypeError(
                f"{name}: relation {r}'s rows must be [rows, {F}] "
                f"{'/'.join(str(d) for d in dtypes)} with unit column stride "
                f"on {device}, got {v.dtype} {tuple(v.shape)} stride "
                f"{v.stride()} on {v.device}")


def _check_csr(name: str, seg_ptr, cells, n: int, R: int) -> None:
    if seg_ptr.dtype != torch.int32 or cells.dtype != torch.int32 \
            or seg_ptr.shape != (n * R + 1,) or cells.dim() != 1:
        raise TypeError(f"{name}: segment pointers int32 [{n * R + 1}] and "
                        f"cells int32 [E], got {seg_ptr.dtype} "
                        f"{tuple(seg_ptr.shape)} and {cells.dtype} "
                        f"{tuple(cells.shape)}")


def _layout(views, lo, roots, type_lo, mask: int, hub: int) -> _Layout:
    """The kernel's layout; every base and row stride a whole number of
    16-byte words."""
    L = _Layout()
    L.n_rel, L.n_types, L.mask, L.hub = len(views), len(type_lo) - 1, \
        mask, hub
    for r, v in enumerate(views):
        if v is None:
            continue
        elt = v.element_size()
        base, stride = v.data_ptr(), v.stride(0) * elt
        if base % 16 or stride % 16 or (v.shape[1] * elt) % 16:
            raise ValueError(f"rel_mean: relation {r}'s rows are not whole "
                             f"16-byte words (base {base}, stride {stride} "
                             f"B, {v.shape[1] * elt} B a row)")
        L.rel_base[r], L.rel_stride[r] = base, stride
        L.rel_lo[r], L.rel_hi[r] = lo[r], lo[r] + v.shape[0]
    for k, v in enumerate(roots):
        if v is not None:
            if v.data_ptr() % 16 or (v.stride(0) * 4) % 16:
                raise ValueError(f"rel_mean: type {k}'s root rows are not "
                                 f"whole 16-byte words")
            L.root_base[k], L.root_stride[k] = v.data_ptr(), v.stride(0) * 4
    for k, t in enumerate(type_lo):
        L.type_lo[k] = t
    return L


def _hub_args(name: str, hubs: RelHubs, device):
    """The chunk list's pointers and counts. On the card a segment longer
    than ``HUB`` is summed from its chunks alone, so a CSR's calls take
    the pack's ``RelHubs`` of that CSR (empty where it has no long
    segment)."""
    if hubs.chunks.device != device:
        raise ValueError(f"{name}: the hub chunks are on "
                         f"{hubs.chunks.device}, the CSR on {device}")
    if hubs.chunks.shape[0] == 0:
        return None, 0, None, None, 0
    return (hubs.chunks.data_ptr(), hubs.chunks.shape[0], hubs.seg.data_ptr(),
            hubs.ptr.data_ptr(), hubs.seg.shape[0])


def rel_mean_plain(rows: Sequence[Optional[torch.Tensor]], lo: Sequence[int],
                   seg_ptr: torch.Tensor, cells: torch.Tensor,
                   roots: Sequence[Optional[torch.Tensor]],
                   type_lo: Sequence[int], mask: int) -> torch.Tensor:
    """Plain PyTorch version of the forward, for CPU tensors: each
    relation's cells' rows summed into their segments (``index_add_``, in
    cell order), each segment scaled by 1 / its length, the relations
    summed in order, then the roots added."""
    R = len(rows)
    n = (seg_ptr.shape[0] - 1) // R
    F = next(v.shape[1] for v in list(rows) + list(roots) if v is not None)
    sp = seg_ptr.long()
    cnt = sp[1:] - sp[:-1]
    seg = torch.repeat_interleave(torch.arange(n * R), cnt)
    rel = seg % R
    sums = torch.zeros((n * R, F), dtype=torch.float32)
    for r, v in enumerate(rows):
        if v is None or not (mask >> r) & 1:
            continue
        sel = rel == r
        ids = (cells[sel].long() - lo[r]).clamp(0, v.shape[0] - 1)
        sums.index_add_(0, seg[sel], v[ids].float())
    inv = torch.where(cnt > 0, 1.0 / cnt.clamp_min(1).float(), 0.0)
    out = torch.zeros((n, F), dtype=torch.float32)
    per = (sums * inv[:, None]).reshape(n, R, F)
    for r in range(R):
        out += per[:, r]
    for k, v in enumerate(roots):
        if v is not None:
            out[type_lo[k]:type_lo[k + 1]] += v.float()
    return out


def rel_mean(rows: Sequence[Optional[torch.Tensor]], lo: Sequence[int],
             seg_ptr: torch.Tensor, cells: torch.Tensor,
             roots: Sequence[Optional[torch.Tensor]], type_lo: Sequence[int],
             mask: int, hubs: RelHubs) -> torch.Tensor:
    """The forward (module docstring): out [n, F] f32, n = (len(seg_ptr)
    - 1) / R. ``rows`` f32 or bf16 views, one dtype, one a relation (None:
    no rows); ``roots`` f32 views, one a node type (None: no root);
    ``type_lo`` the node types' first ids and n last; seg_ptr and cells
    int32; ``hubs`` the segments longer than ``HUB`` of ``seg_ptr``
    (read on the card only). ``rel_mean.launches``
    counts kernel launches (the chunk kernel's too)."""
    R = len(rows)
    n = (seg_ptr.shape[0] - 1) // max(R, 1)
    present = [v for v in list(rows) + list(roots) if v is not None]
    if not present:
        raise ValueError("rel_mean: no rows and no roots")
    F, dev = present[0].shape[1], seg_ptr.device
    dts = {v.dtype for v in rows if v is not None}
    if len(dts) > 1:
        raise TypeError(f"rel_mean: the rows' dtypes differ: {dts}")
    _check_views("rel_mean", rows, lo, F, DTYPES, dev)
    _check_views("rel_mean", roots, [0] * len(roots), F, (torch.float32,),
                 dev)
    _check_csr("rel_mean", seg_ptr, cells, n, R)
    if len(type_lo) != len(roots) + 1 or len(roots) > MAX_TYPES \
            or type_lo[0] != 0 or type_lo[-1] != n:
        raise ValueError(f"rel_mean: type_lo {list(type_lo)} does not split "
                         f"{n} nodes into {len(roots)} types")
    if not kernel_device("rel_mean", seg_ptr):
        return rel_mean_plain(rows, lo, seg_ptr, cells, roots, type_lo, mask)
    lib = build()
    elt = next(iter(dts)).itemsize if dts else 4
    L = _layout(rows, lo, roots, type_lo, mask, HUB)
    chunks, n_chunks, hub_seg, hub_ptr, n_hub = _hub_args("rel_mean", hubs, dev)
    partial = torch.empty((n_chunks, F), dtype=torch.float32, device=dev)
    out = torch.empty((n, F), dtype=torch.float32, device=dev)
    launch("rel_mean", lib.etpu_rel_mean, dev, ctypes.addressof(L),
           seg_ptr.data_ptr(), cells.data_ptr(), n, F * elt, elt, chunks,
           n_chunks, hub_seg, hub_ptr, n_hub, partial.data_ptr(),
           out.data_ptr())
    rel_mean.launches += 2 if n_chunks else 1
    return out


rel_mean.launches = 0


def rel_mean_tr_plain(g: torch.Tensor, tptr: torch.Tensor,
                      tsrc: torch.Tensor, tw: torch.Tensor,
                      out: Sequence[Optional[torch.Tensor]],
                      lo: Sequence[int], mask: int) -> None:
    """Plain PyTorch version of the transpose, for CPU tensors: each
    transposed cell's g row times its weight summed into its segment
    (``index_add_``, in cell order), then each relation's rows copied into
    its view."""
    R = len(out)
    n = (tptr.shape[0] - 1) // R
    sp = tptr.long()
    seg = torch.repeat_interleave(torch.arange(n * R), sp[1:] - sp[:-1])
    sums = torch.zeros((n * R, g.shape[1]), dtype=torch.float32)
    sums.index_add_(0, seg, g[tsrc.long()].float() * tw[:, None])
    sums = sums.reshape(n, R, -1)
    for r, v in enumerate(out):
        if v is None:
            continue
        if (mask >> r) & 1:
            v.copy_(sums[lo[r]:lo[r] + v.shape[0], r])
        else:
            v.zero_()


def rel_mean_tr(g: torch.Tensor, tptr: torch.Tensor, tsrc: torch.Tensor,
                tw: torch.Tensor, out: Sequence[Optional[torch.Tensor]],
                lo: Sequence[int], mask: int, hubs: RelHubs) -> None:
    """The transpose (module docstring), written into ``out``: f32 views,
    one a relation (None: no rows), relation r's rows for ids lo[r] ..
    lo[r] + len. g [n, F] f32 or bf16 contiguous, the cotangent of the
    forward's output; tptr int32 [n * R + 1], tsrc int32 [E] and tw f32
    [E] the transposed CSR; ``hubs`` its segments longer than ``HUB``.
    ``rel_mean_tr.launches`` counts kernel launches."""
    R = len(out)
    n = g.shape[0]
    if g.dim() != 2 or g.dtype not in DTYPES or not g.is_contiguous():
        raise TypeError(f"rel_mean_tr: g must be contiguous 2-D f32 or bf16, "
                        f"got {g.dtype} {tuple(g.shape)}")
    F, dev = g.shape[1], g.device
    _check_views("rel_mean_tr", out, lo, F, (torch.float32,), dev)
    _check_csr("rel_mean_tr", tptr, tsrc, n, R)
    if tw.dtype != torch.float32 or tw.shape != tsrc.shape:
        raise TypeError(f"rel_mean_tr: tw must be f32 {tuple(tsrc.shape)}, "
                        f"got {tw.dtype} {tuple(tw.shape)}")
    if not kernel_device("rel_mean_tr", g):
        rel_mean_tr_plain(g, tptr, tsrc, tw, out, lo, mask)
        return
    lib = build()
    L = _layout(out, lo, [], [0, n], mask, HUB)
    chunks, n_chunks, hub_seg, hub_ptr, n_hub = _hub_args("rel_mean_tr",
                                                          hubs, dev)
    partial = torch.empty((n_chunks, F), dtype=torch.float32, device=dev)
    launch("rel_mean_tr", lib.etpu_rel_mean_tr, dev, ctypes.addressof(L),
           tptr.data_ptr(), tsrc.data_ptr(), tw.data_ptr(), g.data_ptr(), n,
           F * g.element_size(), g.element_size(), chunks, n_chunks,
           hub_seg, hub_ptr, n_hub, partial.data_ptr())
    rel_mean_tr.launches += 2 if n_chunks else 1


rel_mean_tr.launches = 0
