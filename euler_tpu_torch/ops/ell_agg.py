"""Whole-graph ELL aggregate and its transpose: the CUDA kernel and its
plain version.

For each row t of the output::

    out[t] = sum over c of x[idx(t, c)] * w(t, c)  +  x[t] * w_l[t]

with, in the forward mode, ``idx = nbr[t, c]`` and ``w = w_s[t, c]`` (a
pad is ``nbr < 0``), and in the transpose mode ``p = tpos[t, c]``,
``idx = p // C`` and ``w = w_s.flat[p]`` (a pad is ``p < 0``). The
forward is ``dataflow.block._ell_agg``; the transpose with the cotangent
as x is its gradient to x. The weights are f32 and are rounded to x's
type before they multiply it, as euler_tpu/dataflow/block.py's
``_ell_agg`` (:397-443) does.

For a CUDA tensor the wrapper launches csrc/ell_agg.cu (built with nvcc
for sm_90a on first use, bound with ctypes) or raises; for a CPU tensor
it runs ``ell_agg_plain``. There is no fallback from the kernel to the
plain version. The kernel replaces no Pallas kernel (the reference's
``_ell_agg`` is jnp code left to XLA): it reads each live neighbour row
once, where the plain version writes and reads the padded [N, C, D]
rows.
"""
from __future__ import annotations

import ctypes

import torch

from euler_tpu_torch._build import kernel_device, launch, load_cuda_library

DTYPES = (torch.float32, torch.bfloat16)


def build():
    """The kernel library's ctypes handle (``load_cuda_library``)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return load_cuda_library("ell_agg", {"etpu_ell_agg": [
        vp, i64, i64, i32, vp, i64, vp, i64, vp, vp, i32, vp]})


def _check(x, index, w_s, w_l, C, transpose):
    if x.dim() != 2 or x.dtype not in DTYPES:
        raise TypeError(f"ell_agg: x must be 2-D f32 or bf16, got "
                        f"{x.dtype} {tuple(x.shape)}")
    N = x.shape[0]
    if index.dim() != 2 or index.dtype != torch.int32 \
            or index.shape[0] != N:
        raise TypeError(f"ell_agg: index must be int32 [{N}, width], got "
                        f"{index.dtype} {tuple(index.shape)}")
    if w_s.dtype != torch.float32 or w_l.dtype != torch.float32:
        raise TypeError(f"ell_agg: w_s and w_l must be f32, got "
                        f"{w_s.dtype} and {w_l.dtype}")
    if tuple(w_s.shape) != (N, C) or tuple(w_l.shape) != (N,) or (
            not transpose and index.shape[1] != C):
        raise ValueError(
            f"ell_agg: w_s {tuple(w_s.shape)}, w_l {tuple(w_l.shape)} and "
            f"index {tuple(index.shape)} do not fit {N} rows of C = {C}")
    for name, t in (("index", index), ("w_s", w_s), ("w_l", w_l)):
        if t.device != x.device:
            raise ValueError(f"ell_agg: {name} is on {t.device}, x on "
                             f"{x.device}")
    for name, t in (("x", x), ("index", index), ("w_s", w_s), ("w_l", w_l)):
        if not t.is_contiguous():
            raise ValueError(f"ell_agg: {name} must be contiguous")


def ell_rows(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """x[nbr] [N, C, D], rows of pads (-1) exactly 0: a gather from x with
    a zero row appended, in one pass over the output."""
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return xz[torch.where(nbr >= 0, nbr, x.shape[0]).long()]


def ell_agg_plain(x: torch.Tensor, index: torch.Tensor, w_s: torch.Tensor,
                  w_l: torch.Tensor, C: int, transpose: bool
                  ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the forward
    gathers the [N, C, D] rows (``ell_rows``), the transpose the rows
    ``x[tpos // C]`` (clamped into the table) with the weights
    ``w_s.flat[tpos]`` (0 at pads), each then summed by a batched product
    in x's type, plus ``x * w_l``."""
    if transpose:
        n = x.shape[0]
        tp = index.long()
        rows = x[torch.div(tp, C, rounding_mode="floor").clamp(0, n - 1)]
        w = torch.where(index >= 0,
                        w_s.reshape(-1)[tp.clamp(0, w_s.numel() - 1)], 0.0)
    else:
        rows, w = ell_rows(x, index), w_s
    return (torch.einsum("tc,tcd->td", w.to(x.dtype), rows)
            + x * w_l[:, None].to(x.dtype))


def ell_agg(x: torch.Tensor, index: torch.Tensor, w_s: torch.Tensor,
            w_l: torch.Tensor, C: int, transpose: bool) -> torch.Tensor:
    """``out[t] = sum_c x[idx(t, c)] * w(t, c) + x[t] * w_l[t]`` (module
    docstring), [N, D] in x's type.

    x f32 or bf16 [N, D]; index int32 [N, C] (nbr) or [N, C_in] (tpos,
    ``transpose``); w_s f32 [N, C]; w_l f32 [N]; all contiguous, on one
    device. ``ell_agg.launches`` counts kernel launches.
    """
    _check(x, index, w_s, w_l, C, transpose)
    if not kernel_device("ell_agg", x):
        return ell_agg_plain(x, index, w_s, w_l, C, transpose)
    lib = build()
    N, D = x.shape
    out = torch.empty_like(x)
    launch("ell_agg", lib.etpu_ell_agg, x.device, x.data_ptr(), N, D,
           x.element_size(), index.data_ptr(), index.shape[1],
           w_s.data_ptr(), C, w_l.data_ptr(), out.data_ptr(), int(transpose))
    ell_agg.launches += 1
    return out


ell_agg.launches = 0
