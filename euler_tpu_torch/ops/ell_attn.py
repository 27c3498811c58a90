"""Multi-head whole-graph ELL attention: the per-head aggregate, its
transpose and the weights' gradient (an SDDMM), the CUDA kernels and
their plain versions.

The rows are in the padded-heads layout, [N, H, Fp] (``pad_heads``): each
head's F values padded with zeros to Fp, so that a head is a whole number
of 16-byte words (``head_words``). For each row t and head h::

    ell_attn:  out[t, h] = sum over c of x[idx(t, c), h] * w(t, c, h)
                           + x[t, h] * w_l[t, h]
    ell_sddmm: gw_s[t, c, h] = g[t, h] . x[nbr[t, c], h]
               gw_l[t, h]    = g[t, h] . x[t, h]

``ell_attn``'s forward mode reads ``idx = nbr[t, c]`` and ``w = w_s[t, c,
h]`` (a pad is ``nbr < 0``); its transpose mode ``p = tpos[t, c]``, ``idx =
p // C`` and ``w = w_s.flat[p * H + h]`` (a pad is ``p < 0``), which is
the forward's gradient to x with the cotangent as x. ``ell_sddmm`` is its
gradient to the weights. The weights are f32 and are not rounded; products
and sums are f32, and the aggregate rounds once to x's type. A pad adds 0
and its weight's gradient is 0. With H = 1 the layout is the table itself
wherever a row is a whole number of 16-byte words (``pad_heads`` then
returns a view).

For CUDA tensors the wrappers launch csrc/ell_attn.cu (built with nvcc for
sm_90a on first use, bound with ctypes) or raise; for CPU tensors they run
the plain versions. There is no fallback from a kernel to its plain
version. The kernels replace no Pallas kernel (the JAX package's GAT is
single-head, its ELL aggregate jnp code left to XLA): they read each live
neighbour row once, where the plain versions build the padded [N, C, H,
Fp] rows.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from euler_tpu_torch._build import load_cuda_library
from euler_tpu_torch.ops import ell_agg as _ell_agg

DTYPES = (torch.float32, torch.bfloat16)


def build():
    """The kernel library's ctypes handle (``load_cuda_library``)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return load_cuda_library("ell_attn", {
        "etpu_ell_attn": [vp, i64, i64, i64, i32, vp, i64, vp, i64, vp, vp,
                          i64, i64, i64, i32, i32, vp],
        "etpu_ell_sddmm": [vp, vp, i64, i64, i64, i32, vp, i64, vp, vp, vp]})


def head_words(F: int, elt: int) -> int:
    """16-byte words a head of F elements of ``elt`` bytes takes in the
    padded layout: a power of two up to 32, else a multiple of 32, so that
    a warp's 32 words split into whole heads or a head into whole passes
    of 32 words."""
    w = max(1, -(-F * elt // 16))
    if w <= 32:
        return 1 << (w - 1).bit_length()
    return -(-w // 32) * 32


def padded_width(F: int, dtype: torch.dtype) -> int:
    """Fp: a head's padded width in elements of ``dtype``."""
    elt = torch.empty((), dtype=dtype).element_size()
    return head_words(F, elt) * 16 // elt


def pad_heads(x: torch.Tensor, heads: int,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[N, H * F] -> the padded layout [N, H, Fp] in ``dtype`` (x's by
    default), pads 0, in one copy (a view of x where nothing is padded,
    cast, made contiguous or aligned to 16 bytes). Differentiable: the
    gradient is the padded cotangent's first F values of each head."""
    N, D = x.shape
    F = D // heads
    dt = dtype or x.dtype
    Fp = padded_width(F, dt)
    if Fp == F and dt == x.dtype and x.is_contiguous() \
            and x.data_ptr() % 16 == 0:
        return x.view(N, heads, F)
    out = torch.empty((N, heads, Fp), dtype=dt, device=x.device)
    out[..., F:].zero_()
    out[..., :F].copy_(x.view(N, heads, F))
    return out


def _check_rows(name: str, x: torch.Tensor):
    if x.dim() != 3 or x.dtype not in DTYPES:
        raise TypeError(f"{name}: rows must be [N, H, Fp] f32 or bf16, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.shape[2] != padded_width(x.shape[2], x.dtype):
        raise ValueError(f"{name}: {x.shape[2]} is no padded head width "
                         f"(ops.ell_attn.padded_width)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous")
    if x.device.type == "cuda" and x.data_ptr() % 16 != 0:
        raise ValueError(f"{name}: rows must be 16-byte aligned")


def _check_index(name: str, index: torch.Tensor, N: int, device):
    if index.dim() != 2 or index.dtype != torch.int32 \
            or index.shape[0] != N:
        raise TypeError(f"{name}: index must be int32 [{N}, width], got "
                        f"{index.dtype} {tuple(index.shape)}")
    if not index.is_contiguous():
        raise ValueError(f"{name}: index must be contiguous")
    if index.device != device:
        raise ValueError(f"{name}: index is on {index.device}, the rows "
                         f"on {device}")


def _check_weights(w_s, w_l, N, C, H, device):
    for name, t, shape in (("w_s", w_s, (N, C, H)), ("w_l", w_l, (N, H))):
        if t.dtype != torch.float32:
            raise TypeError(f"ell_attn: {name} must be f32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ell_attn: {name} {tuple(t.shape)} does not "
                             f"fit {shape}")
        if not t.is_contiguous():
            raise ValueError(f"ell_attn: {name} must be contiguous")
        if t.device != device:
            raise ValueError(f"ell_attn: {name} is on {t.device}, the rows "
                             f"on {device}")


def _kernel_device(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain version);
    raises on any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {x.device}")
    return x.device.type == "cuda"


def ell_attn_plain(x: torch.Tensor, index: torch.Tensor, w_s: torch.Tensor,
                   w_l: torch.Tensor, C: int, F: int, transpose: bool,
                   out_padded: bool) -> torch.Tensor:
    """Plain PyTorch version of ``ell_attn``, on any device: the padded
    rows [N, C, H, Fp] (``ell_agg.ell_rows``, or the transpose's
    ``x[tpos // C]`` clamped into the table with ``w_s.flat[tpos]``, 0 at
    pads) summed in f32 against the weights, plus ``x * w_l``, rounded
    once to x's type."""
    N, H, _ = x.shape
    xf = x.float()
    if transpose:
        tp = index.long()
        rows = xf[torch.div(tp, C, rounding_mode="floor").clamp(0, N - 1)]
        w = w_s.reshape(-1, H)[tp.clamp(0, max(w_s.numel() // H - 1, 0))]
        w = torch.where((index >= 0)[..., None], w, 0.0)
    else:
        rows, w = _ell_agg.ell_rows(xf, index), w_s
    out = (torch.einsum("tch,tchf->thf", w, rows)
           + xf * w_l[..., None]).to(x.dtype)
    return out if out_padded else out[..., :F].reshape(N, H * F)


def ell_attn(x: torch.Tensor, index: torch.Tensor, w_s: torch.Tensor,
             w_l: torch.Tensor, C: int, F: int, transpose: bool,
             out_padded: bool) -> torch.Tensor:
    """The per-head aggregate (module docstring) of the padded rows x [N,
    H, Fp] (f32 or bf16): [N, H, Fp] where ``out_padded``, else [N, H * F],
    in x's type. index int32 [N, C] (nbr) or [N, C_in] (tpos,
    ``transpose``); w_s f32 [N, C, H]; w_l f32 [N, H]; all contiguous, on
    one device. ``ell_attn.launches`` counts kernel launches."""
    _check_rows("ell_attn", x)
    N, H, Fp = x.shape
    _check_index("ell_attn", index, N, x.device)
    _check_weights(w_s, w_l, N, C, H, x.device)
    if not transpose and index.shape[1] != C:
        raise ValueError(f"ell_attn: nbr {tuple(index.shape)} does not fit "
                         f"C = {C}")
    if not 0 < F <= Fp or padded_width(F, x.dtype) != Fp:
        raise ValueError(f"ell_attn: F = {F} does not pad to {Fp}")
    if not _kernel_device("ell_attn", x):
        return ell_attn_plain(x, index, w_s, w_l, C, F, transpose,
                              out_padded)
    lib = build()
    if out_padded:
        out = torch.empty_like(x)
        out_ld, out_hs = H * Fp, Fp
    else:
        out = torch.empty((N, H * F), dtype=x.dtype, device=x.device)
        out_ld, out_hs = H * F, F
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.etpu_ell_attn(
            x.data_ptr(), N, H, Fp * x.element_size() // 16,
            x.element_size(), index.data_ptr(), index.shape[1],
            w_s.data_ptr(), C, w_l.data_ptr(), out.data_ptr(), out_ld,
            out_hs, F, int(out_padded), int(transpose), stream)
    if rc != 0:
        raise RuntimeError(f"ell_attn: kernel launch failed (CUDA error "
                           f"{rc})")
    ell_attn.launches += 1
    return out


ell_attn.launches = 0


def ell_sddmm_plain(g: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                    want_wl: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of ``ell_sddmm``, on any device: the padded
    rows [N, C, H, Fp] (``ell_agg.ell_rows``) against g, in f32."""
    gf = g.float()
    gw_s = torch.einsum("thf,tchf->tch", gf,
                        _ell_agg.ell_rows(x, nbr).float())
    gw_l = torch.einsum("thf,thf->th", gf, x.float()) if want_wl else None
    return gw_s, gw_l


def ell_sddmm(g: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
              want_wl: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The weights' gradient of ``ell_attn``'s forward (module docstring):
    (gw_s f32 [N, C, H], gw_l f32 [N, H] or None where not ``want_wl``)
    from the padded cotangent g and rows x [N, H, Fp] (one type, pads 0)
    and nbr int32 [N, C]. ``ell_sddmm.launches`` counts kernel
    launches."""
    _check_rows("ell_sddmm", g)
    _check_rows("ell_sddmm", x)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"ell_sddmm: g {g.dtype} {tuple(g.shape)} on "
                         f"{g.device} and x {x.dtype} {tuple(x.shape)} on "
                         f"{x.device} differ")
    N, H, Fp = x.shape
    _check_index("ell_sddmm", nbr, N, x.device)
    if not _kernel_device("ell_sddmm", x):
        return ell_sddmm_plain(g, x, nbr, want_wl)
    lib = build()
    C = nbr.shape[1]
    gw_s = torch.empty((N, C, H), dtype=torch.float32, device=x.device)
    gw_l = (torch.empty((N, H), dtype=torch.float32, device=x.device)
            if want_wl else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.etpu_ell_sddmm(
            g.data_ptr(), x.data_ptr(), N, H, Fp * x.element_size() // 16,
            x.element_size(), nbr.data_ptr(), C, gw_s.data_ptr(),
            None if gw_l is None else gw_l.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ell_sddmm: kernel launch failed (CUDA error "
                           f"{rc})")
    ell_sddmm.launches += 1
    return gw_s, gw_l


ell_sddmm.launches = 0
