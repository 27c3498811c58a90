"""The supervised head's masked mean sigmoid cross-entropy and its
gradient: the CUDA kernels and their plain versions.

For logits x [R, C], labels y [R, C] and a row weight valid [R] (1 for a
root, 0 for a padded one)::

    loss = sum over r, c of xent_terms(x, y)[r, c] * valid[r] / den
    den  = max(sum(valid) * C, 1)

``xent_terms`` is tf.nn.sigmoid_cross_entropy_with_logits as the
reference writes it, ``max(x, 0) - x y + log1p(exp(-|x|))``, with the
reference's gradient at a logit of 0: ``maximum`` splits its tie and
``xla_abs`` takes the slope 1, so there the gradient is ``-y`` (times
the row's weight over den), not the textbook ``sigmoid(x) - y``.
``sigmoid_xent_grad`` gives that gradient to x, term by term as autograd
adds it; labels and weights get none.

The labels may be a view with its own row stride (the first C columns of
a wider feature) in f32 or bf16; nothing copies them. For a CUDA tensor
each wrapper launches csrc/sigmoid_xent.cu (built with nvcc for sm_90a on
first use, bound with ctypes) or raises: the forward one pass of partial
sums in a fixed order and one short pass adding them, the backward one
pass writing the gradient; no [R, C] tensor but the gradient is built.
For a CPU tensor each runs its plain version. There is no fallback from
the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from euler_tpu_torch._build import kernel_device, launch, load_cuda_library

LABEL_DTYPES = (torch.float32, torch.bfloat16)
#: the forward's partial sums a call at most (csrc/sigmoid_xent.cu)
MAX_BLOCKS = 2048


def xla_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with XLA's gradient: 1 at x = 0 (torch's ``abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def xent_terms(logits, labels):
    """tf.nn.sigmoid_cross_entropy_with_logits, with the reference's
    gradient at a logit of 0 (``maximum`` splits its tie, ``xla_abs``)."""
    return torch.maximum(logits, torch.zeros_like(logits)) - \
        logits * labels + torch.log1p(torch.exp(-xla_abs(logits)))


def build():
    """The kernel library's ctypes handle (``load_cuda_library``)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    args = [vp, i64, vp, i64, i32, vp, i64, i64, vp, vp, vp, vp]
    return load_cuda_library("sigmoid_xent", {"etpu_sigmoid_xent": args,
                                              "etpu_sigmoid_xent_grad": args})


def _check(name: str, logit, label, valid) -> None:
    if logit.dim() != 2 or label.shape != logit.shape \
            or valid.shape != logit.shape[:1]:
        raise ValueError(f"{name}: logits [R, C], labels [R, C] and valid "
                         f"[R], got {tuple(logit.shape)}, "
                         f"{tuple(label.shape)} and {tuple(valid.shape)}")
    for what, t in (("labels", label), ("valid", valid)):
        if t.device != logit.device:
            raise ValueError(f"{name}: {what} on {t.device}, logits on "
                             f"{logit.device}")
        if t.requires_grad:
            raise ValueError(f"{name}: {what} require grad, and the loss "
                             f"gives them none")


def _check_kernel(name: str, logit, label, valid) -> None:
    """What the kernels take: f32 logits and weights, f32 or bf16 labels,
    unit column strides, contiguous weights."""
    if logit.dtype != torch.float32 or label.dtype not in LABEL_DTYPES \
            or valid.dtype != torch.float32:
        raise TypeError(f"{name}: f32 logits, f32 or bf16 labels and f32 "
                        f"valid, got {logit.dtype}, {label.dtype} and "
                        f"{valid.dtype}")
    if (logit.shape[1] > 1 and (logit.stride(1) != 1
                                or label.stride(1) != 1)) \
            or not valid.is_contiguous():
        raise ValueError(f"{name}: logits and labels need a unit column "
                         f"stride (got {logit.stride()} and "
                         f"{label.stride()}), valid contiguous")


def _args(logit, label, valid) -> tuple:
    R, C = logit.shape
    return (logit.data_ptr(), logit.stride(0), label.data_ptr(),
            label.stride(0), label.element_size(), valid.data_ptr(), R, C)


def sigmoid_xent_plain(logit: torch.Tensor, label: torch.Tensor,
                       valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward, for CPU tensors: (loss, den),
    the supervised head's expression as it was written."""
    xent = xent_terms(logit, label) * valid[:, None]
    den = (valid.sum() * logit.shape[1]).clamp_min(1.0)
    return xent.sum() / den, den


def sigmoid_xent(logit: torch.Tensor, label: torch.Tensor,
                 valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, den), both 0-dim f32 (module docstring); ``den`` is what
    ``sigmoid_xent_grad`` takes. ``sigmoid_xent.launches`` counts the
    calls of both wrappers that launched their kernels (one a call)."""
    _check("sigmoid_xent", logit, label, valid)
    if not kernel_device("sigmoid_xent", logit):
        return sigmoid_xent_plain(logit, label, valid)
    _check_kernel("sigmoid_xent", logit, label, valid)
    dev = logit.device
    lib = build()
    partial = torch.empty(2 * MAX_BLOCKS, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    den = torch.empty((), dtype=torch.float32, device=dev)
    launch("sigmoid_xent", lib.etpu_sigmoid_xent, dev,
           *_args(logit, label, valid), partial.data_ptr(), loss.data_ptr(),
           den.data_ptr())
    sigmoid_xent.launches += 1
    return loss, den


sigmoid_xent.launches = 0


def sigmoid_xent_grad_plain(logit: torch.Tensor, label: torch.Tensor,
                            valid: torch.Tensor, den: torch.Tensor,
                            upstream: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gradient to the logits, for CPU
    tensors: each term's gradient as autograd gives it for the plain
    expression (log1p's ``g / (1 + e)``, exp's ``* e``, ``xla_abs``'s
    sign; the product's ``-g * y``; ``maximum``'s half at a tie), added in
    the order autograd adds them."""
    g = (upstream / den) * valid[:, None]
    e = torch.exp(-xla_abs(logit))
    t3 = g / (1 + e) * e
    t1 = torch.where(logit > 0, g, torch.where(logit == 0, g * 0.5, 0.0))
    return (torch.where(logit >= 0, -t3, t3) - g * label) + t1


def sigmoid_xent_grad(logit: torch.Tensor, label: torch.Tensor,
                      valid: torch.Tensor, den: torch.Tensor,
                      upstream: torch.Tensor) -> torch.Tensor:
    """The loss's gradient to the logits, [R, C] f32 contiguous: ``den``
    the forward's, ``upstream`` the loss's own gradient (0-dim, on the
    logits' device; read there, never on the host). Counted in
    ``sigmoid_xent.launches``."""
    _check("sigmoid_xent_grad", logit, label, valid)
    if not kernel_device("sigmoid_xent_grad", logit):
        return sigmoid_xent_grad_plain(logit, label, valid, den, upstream)
    _check_kernel("sigmoid_xent_grad", logit, label, valid)
    dev = logit.device
    for what, t in (("den", den), ("upstream", upstream)):
        if t.numel() != 1 or t.device != dev:
            raise ValueError(f"sigmoid_xent_grad: {what} must be one value "
                             f"on {dev}, got {tuple(t.shape)} on {t.device}")
    upstream = upstream.to(torch.float32).contiguous()
    den = den.to(torch.float32).contiguous()
    lib = build()
    d = torch.empty(logit.shape, dtype=torch.float32, device=dev)
    launch("sigmoid_xent_grad", lib.etpu_sigmoid_xent_grad, dev,
           *_args(logit, label, valid), upstream.data_ptr(), den.data_ptr(),
           d.data_ptr())
    sigmoid_xent.launches += 1
    return d
