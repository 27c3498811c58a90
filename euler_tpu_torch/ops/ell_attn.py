"""Multi-head whole-graph ELL attention: GAT's fused attention, its
backward, and the weights' gradient of a weighted aggregate (an SDDMM),
the CUDA kernels and their plain versions.

The rows are in the padded-heads layout, [N, H, Fp] (``pad_heads``): each
head's F values padded with zeros to Fp, so that a head is a whole number
of 16-byte words (``head_words``). For each row t and head h, the
per-head aggregate ``ell_attn_plain`` computes::

    out[t, h] = sum over c of x[idx(t, c), h] * w(t, c, h)
                + x[t, h] * w_l[t, h]

reading ``idx = nbr[t, c]`` and ``w = w_s[t, c, h]`` (a pad is ``nbr <
0``), or in its transpose ``p = tpos[t, c]``, ``idx = p // C`` and ``w =
w_s.flat[p * H + h]`` (a pad is ``p < 0``), the forward's gradient to x
with the cotangent as x. ``ell_sddmm`` is the forward's gradient to the
weights::

    gw_s[t, c, h] = g[t, h] . x[nbr[t, c], h]
    gw_l[t, h]    = g[t, h] . x[t, h]

(at one head, ``_ell_agg``'s gradient to its weights). The weights are
f32 and are not rounded; products and sums are f32, and the aggregate
rounds once to x's type. A pad adds 0 and its weight's gradient is 0.
With H = 1 the layout is the table itself wherever a row is a whole
number of 16-byte words (``pad_heads`` then returns a view).

GAT's fused attention (``ell_gat``, ``ell_gat_sddmm``, ``ell_gat_tr``)
takes no weights: the kernels compute them from the per-head score terms
el and er [N, H] (f32), as GAT's softmax over each row's live cells and
its self loop of the scores ``s = leaky_relu_0.2(el[t] + er[nbr[t, c]])``
(``el[t] + er[t]`` for the self loop)::

    ell_gat:       lse[t, h] = log(sum over the row of exp(s)), then
                   the aggregate with w = p = exp(s - lse)
    ell_gat_sddmm: dp as ell_sddmm's, then the scores' gradients
                   de = p (dp - sum over the row of p dp) leaky_relu'
                   ([N, C, H] and the self loop's [N, H]) and d_el, their
                   row sums
    ell_gat_tr:    the aggregate's transpose with w = p, in f32, plus
                   d_el[u, h] a_l[h] + d_er[u, h] a_r[h], [N, H * F]; and
                   d_er, the sum of de over u's cells and its self loop;
                   its tpos names live cells only (``live_tpos``)

so that no [N, C, H] score, probability or mask tensor is built, and the
gradients of el = z . a_l and er = z . a_r go to the rows z with the
aggregate's. ``ell_gat.launches`` counts all three kernels' launches.

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

from euler_tpu_torch._build import kernel_device, launch, load_cuda_library
from euler_tpu_torch.ops import ell_agg as _ell_agg

DTYPES = (torch.float32, torch.bfloat16)


def build():
    """The kernel library's ctypes handle (``load_cuda_library``)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return load_cuda_library("ell_attn", {
        "etpu_ell_sddmm": [vp, vp, i64, i64, i64, i32, vp, i64, vp, vp, vp],
        "etpu_ell_gat": [vp, i64, i64, i64, i32, vp, i64, vp, vp, vp, vp,
                         i64, vp],
        "etpu_ell_gat_sddmm": [vp, vp, i64, i64, i64, i32, vp, i64, vp, vp,
                               vp, vp, vp, vp, vp],
        "etpu_ell_gat_tr": [vp, i64, i64, i64, i32, vp, i64, i64, vp, vp,
                            vp, vp, vp, vp, vp, vp, vp, vp, i64, vp]})


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


def _check_terms(name: str, shape: tuple, device, **terms):
    """Each term an f32 tensor of ``shape``, contiguous, on ``device``."""
    for key, t in terms.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"{name}: {key} must be f32 {list(shape)}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, the rows on "
                             f"{device}")


def _check_f(name: str, F: int, x: torch.Tensor):
    if not 0 < F <= x.shape[2] or padded_width(F, x.dtype) != x.shape[2]:
        raise ValueError(f"{name}: F = {F} does not pad to {x.shape[2]}")


def ell_attn_plain(x: torch.Tensor, index: torch.Tensor, w_s: torch.Tensor,
                   w_l: torch.Tensor, C: int, F: int, transpose: bool,
                   out_padded: bool) -> torch.Tensor:
    """The per-head aggregate (module docstring) of the padded rows x [N,
    H, Fp], in plain PyTorch, on any device: the padded rows [N, C, H, Fp]
    (``ell_agg.ell_rows``, or the transpose's ``x[tpos // C]`` clamped
    into the table with ``w_s.flat[tpos]``, 0 at pads) summed in f32
    against the weights w_s f32 [N, C, H], plus ``x * w_l`` (w_l f32 [N,
    H]), rounded once to x's type: [N, H, Fp] where ``out_padded``, else
    [N, H * F]. The reference of GAT's fused kernels' plain versions."""
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
    """The weights' gradient of the per-head aggregate (module docstring):
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
    if not kernel_device("ell_sddmm", x):
        return ell_sddmm_plain(g, x, nbr, want_wl)
    lib = build()
    C = nbr.shape[1]
    gw_s = torch.empty((N, C, H), dtype=torch.float32, device=x.device)
    gw_l = (torch.empty((N, H), dtype=torch.float32, device=x.device)
            if want_wl else None)
    launch("ell_sddmm", lib.etpu_ell_sddmm, x.device, g.data_ptr(),
           x.data_ptr(), N, H, Fp * x.element_size() // 16,
           x.element_size(), nbr.data_ptr(), C, gw_s.data_ptr(),
           None if gw_l is None else gw_l.data_ptr())
    ell_sddmm.launches += 1
    return gw_s, gw_l


ell_sddmm.launches = 0


# ------------------------------------------------------- GAT's fused modes --

def _gat_pre(el: torch.Tensor, er: torch.Tensor, nbr: torch.Tensor):
    """The scores' arguments: el[t] + er[nbr[t, c]] [N, C, H] (0 at pads;
    ids past the table read its last row), el + er [N, H] (the self loop)
    and the live cells [N, C, 1]."""
    live = (nbr >= 0)[..., None]
    pre = el[:, None, :] + er[nbr.long().clamp(0, el.shape[0] - 1)]
    return torch.where(live, pre, 0.0), el + er, live


def _lrelu(v: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(v, negative_slope=0.2)


def _lrelu_grad(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0, 1.0, 0.2)


def gat_weights(el: torch.Tensor, er: torch.Tensor, lse: torch.Tensor,
                nbr: torch.Tensor):
    """GAT's softmax weights from the score terms and the row's lse: p
    [N, C, H] (0 at pads) and the self loop's p_self [N, H], exp(s -
    lse)."""
    pre, pre_self, live = _gat_pre(el, er, nbr)
    p = torch.where(live, torch.exp(_lrelu(pre) - lse[:, None]), 0.0)
    return p, torch.exp(_lrelu(pre_self) - lse)


def gat_lse(el: torch.Tensor, er: torch.Tensor,
            nbr: torch.Tensor) -> torch.Tensor:
    """lse [N, H]: the log of the sum of exp(s) over each row's live cells
    and its self loop, shifted by their max (``Block.softmax``'s: reset to
    0 where no score is finite, the sum at least 1e-16)."""
    pre, pre_self, live = _gat_pre(el, er, nbr)
    s, s_self = _lrelu(pre), _lrelu(pre_self)
    m = torch.maximum(torch.where(live, s, float("-inf")).amax(1), s_self)
    m = torch.where(m > -1e30, m, 0.0)
    den = (torch.where(live, torch.exp(s - m[:, None]), 0.0).sum(1)
           + torch.exp(s_self - m))
    return m + torch.log(den.clamp_min(1e-16))


def ell_gat_plain(xp: torch.Tensor, nbr: torch.Tensor, el: torch.Tensor,
                  er: torch.Tensor, F: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``ell_gat``, on any device: ``gat_lse``,
    ``gat_weights`` and ``ell_attn_plain``'s forward."""
    lse = gat_lse(el, er, nbr)
    p, p_self = gat_weights(el, er, lse, nbr)
    return (ell_attn_plain(xp, nbr, p, p_self, nbr.shape[1], F, False,
                           False), lse)


def ell_gat(xp: torch.Tensor, nbr: torch.Tensor, el: torch.Tensor,
            er: torch.Tensor, F: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAT's fused attention (module docstring) over the padded rows xp
    [N, H, Fp] (f32 or bf16) and nbr int32 [N, C], with the score terms
    el and er f32 [N, H]: (out [N, H * F] in xp's type, lse f32 [N, H]).
    ``ell_gat.launches`` counts the launches of the three GAT kernels."""
    _check_rows("ell_gat", xp)
    N, H, Fp = xp.shape
    _check_index("ell_gat", nbr, N, xp.device)
    _check_terms("ell_gat", (N, H), xp.device, el=el, er=er)
    _check_f("ell_gat", F, xp)
    if not kernel_device("ell_gat", xp):
        return ell_gat_plain(xp, nbr, el, er, F)
    lib = build()
    out = torch.empty((N, H * F), dtype=xp.dtype, device=xp.device)
    lse = torch.empty((N, H), dtype=torch.float32, device=xp.device)
    launch("ell_gat", lib.etpu_ell_gat, xp.device, xp.data_ptr(), N, H,
           Fp * xp.element_size() // 16, xp.element_size(), nbr.data_ptr(),
           nbr.shape[1], el.data_ptr(), er.data_ptr(), lse.data_ptr(),
           out.data_ptr(), F)
    ell_gat.launches += 1
    return out, lse


ell_gat.launches = 0


def ell_gat_sddmm_plain(gp: torch.Tensor, xp: torch.Tensor,
                        nbr: torch.Tensor, el: torch.Tensor,
                        er: torch.Tensor, lse: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``ell_gat_sddmm``, on any device:
    ``ell_sddmm_plain``'s dot products, then the softmax's and
    leaky_relu's gradients."""
    dp, dp_self = ell_sddmm_plain(gp, xp, nbr, True)
    pre, pre_self, live = _gat_pre(el, er, nbr)
    p, p_self = gat_weights(el, er, lse, nbr)
    D = (p * dp).sum(1) + p_self * dp_self
    de = torch.where(live, p * (dp - D[:, None]) * _lrelu_grad(pre), 0.0)
    de_self = p_self * (dp_self - D) * _lrelu_grad(pre_self)
    return de, de_self, de.sum(1) + de_self


def ell_gat_sddmm(gp: torch.Tensor, xp: torch.Tensor, nbr: torch.Tensor,
                  el: torch.Tensor, er: torch.Tensor, lse: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """The scores' gradients of ``ell_gat`` (module docstring) from the
    padded cotangent gp and rows xp [N, H, Fp] (one type, pads 0), nbr,
    the score terms and the forward's lse: (de f32 [N, C, H], 0 at pads;
    de_self f32 [N, H], the self loop's; d_el f32 [N, H])."""
    _check_rows("ell_gat_sddmm", gp)
    _check_rows("ell_gat_sddmm", xp)
    if gp.shape != xp.shape or gp.dtype != xp.dtype \
            or gp.device != xp.device:
        raise ValueError(f"ell_gat_sddmm: gp {gp.dtype} {tuple(gp.shape)} "
                         f"on {gp.device} and xp {xp.dtype} "
                         f"{tuple(xp.shape)} on {xp.device} differ")
    N, H, Fp = xp.shape
    _check_index("ell_gat_sddmm", nbr, N, xp.device)
    _check_terms("ell_gat_sddmm", (N, H), xp.device, el=el, er=er,
                 lse=lse)
    if not kernel_device("ell_gat_sddmm", xp):
        return ell_gat_sddmm_plain(gp, xp, nbr, el, er, lse)
    lib = build()
    C = nbr.shape[1]
    de = torch.empty((N, C, H), dtype=torch.float32, device=xp.device)
    de_self, d_el = (torch.empty((N, H), dtype=torch.float32,
                                 device=xp.device) for _ in range(2))
    launch("ell_gat_sddmm", lib.etpu_ell_gat_sddmm, xp.device,
           gp.data_ptr(), xp.data_ptr(), N, H,
           Fp * xp.element_size() // 16, xp.element_size(), nbr.data_ptr(),
           C, el.data_ptr(), er.data_ptr(), lse.data_ptr(), de.data_ptr(),
           de_self.data_ptr(), d_el.data_ptr())
    ell_gat.launches += 1
    return de, de_self, d_el


def ell_gat_tr_plain(gp: torch.Tensor, tpos: torch.Tensor,
                     nbr: torch.Tensor, el: torch.Tensor, er: torch.Tensor,
                     lse: torch.Tensor, de: torch.Tensor,
                     de_self: torch.Tensor, d_el: torch.Tensor,
                     a_l: torch.Tensor, a_r: torch.Tensor, F: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``ell_gat_tr``, on any device:
    ``ell_attn_plain``'s transpose in f32 with ``gat_weights``, d_er
    gathered over tpos, then el's and er's terms."""
    N, H, _ = gp.shape
    p, p_self = gat_weights(el, er, lse, nbr)
    agg = ell_attn_plain(gp.float(), tpos, p, p_self, nbr.shape[1], F, True,
                         True)[..., :F]
    cells = de.reshape(-1, H)[tpos.long().clamp(0, max(de.numel() // H - 1,
                                                       0))]
    d_er = torch.where((tpos >= 0)[..., None], cells, 0.0).sum(1) + de_self
    d_z = agg + d_el[..., None] * a_l + d_er[..., None] * a_r
    return d_z.reshape(N, H * F), d_er


def live_tpos(tpos: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """tpos with -1 where it names a cell that nbr drops (-1 there), as an
    edge-type filter of an ELL pack leaves them: the transpose positions
    ``ell_gat_tr`` takes."""
    cells = nbr.reshape(-1)[tpos.long().clamp(0, max(nbr.numel() - 1, 0))]
    return torch.where((tpos >= 0) & (cells >= 0), tpos, -1)


def ell_gat_tr(gp: torch.Tensor, tpos: torch.Tensor, nbr: torch.Tensor,
               el: torch.Tensor, er: torch.Tensor, lse: torch.Tensor,
               de: torch.Tensor, de_self: torch.Tensor, d_el: torch.Tensor,
               a_l: torch.Tensor, a_r: torch.Tensor, F: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows' gradient of ``ell_gat`` (module docstring) from the
    padded cotangent gp [N, H, Fp], tpos int32 [N, C_in] naming live cells
    of nbr only (``live_tpos``: the kernel weighs every cell it names),
    nbr int32 [N, C], the score terms, lse, ``ell_gat_sddmm``'s results
    and a_l, a_r f32 [H, F]: (d_z f32 [N, H * F], d_er f32 [N, H])."""
    _check_rows("ell_gat_tr", gp)
    N, H, Fp = gp.shape
    _check_index("ell_gat_tr", tpos, N, gp.device)
    _check_index("ell_gat_tr", nbr, N, gp.device)
    C = nbr.shape[1]
    _check_terms("ell_gat_tr", (N, H), gp.device, el=el, er=er, lse=lse,
                 de_self=de_self, d_el=d_el)
    _check_terms("ell_gat_tr", (N, C, H), gp.device, de=de)
    _check_terms("ell_gat_tr", (H, F), gp.device, a_l=a_l, a_r=a_r)
    _check_f("ell_gat_tr", F, gp)
    if not kernel_device("ell_gat_tr", gp):
        return ell_gat_tr_plain(gp, tpos, nbr, el, er, lse, de, de_self,
                                d_el, a_l, a_r, F)
    lib = build()
    d_z = torch.empty((N, H * F), dtype=torch.float32, device=gp.device)
    d_er = torch.empty((N, H), dtype=torch.float32, device=gp.device)
    launch("ell_gat_tr", lib.etpu_ell_gat_tr, gp.device, gp.data_ptr(), N,
           H, Fp * gp.element_size() // 16, gp.element_size(),
           tpos.data_ptr(), tpos.shape[1], C,
           el.data_ptr(), er.data_ptr(), lse.data_ptr(), de.data_ptr(),
           de_self.data_ptr(), d_el.data_ptr(), a_l.data_ptr(),
           a_r.data_ptr(), d_z.data_ptr(), d_er.data_ptr(), F)
    ell_gat.launches += 1
    return d_z, d_er
