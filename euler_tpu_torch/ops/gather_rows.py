"""Row gather with the reference's fills: the CUDA kernel and its plain
version.

``gather_rows`` replaces tools/micro/micro_pallas_gather.py::pallas_gather
(the Pallas TPU row gather) and is the port's only dense-feature gather:
``feature_ops._take_rows`` and ``ShallowEncoder`` go through it. Row i of
the result is ``table[ids[i]]`` for ``0 <= ids[i] < N``, zeros for
``ids[i] < 0`` (padding) and NaN for ``ids[i] >= N``, which is what
euler_tpu's ``jnp.take`` + ``where`` gives.

For a CUDA tensor the wrapper launches csrc/gather_rows.cu (built with
nvcc for sm_90a on first use, bound with ctypes) or raises; for a CPU
tensor it runs ``gather_rows_plain``, the same function in plain PyTorch.
There is no fallback from the kernel to the plain version.

The tables are inputs, not parameters: there is no backward, and the
wrapper raises for a table that requires grad.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from euler_tpu_torch._build import kernel_device, launch, load_cuda_library

DTYPES = (torch.float32, torch.bfloat16)

def build():
    """The kernel library's ctypes handle (``load_cuda_library``)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    return load_cuda_library("gather_rows", {"etpu_gather_rows": [
        vp, i64, i64, i32, vp, i64, vp, i64, i64, vp]})


def _check(table, ids, out, col_offset):
    if table.dim() != 2 or table.dtype not in DTYPES:
        raise TypeError(f"gather_rows: table must be 2-D f32 or bf16, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if table.requires_grad:
        raise ValueError("gather_rows: the table requires grad, and the "
                         "gather has no backward")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise TypeError(f"gather_rows: ids must be int32 [M], got "
                        f"{ids.dtype} {tuple(ids.shape)}")
    for name, t in (("table", table), ("ids", ids), ("out", out)):
        if t is None:
            continue
        if t.device != table.device:
            raise ValueError(f"gather_rows: {name} is on {t.device}, "
                             f"table on {table.device}")
        if not t.is_contiguous():
            raise ValueError(f"gather_rows: {name} must be contiguous")
    if out is not None:
        D = table.shape[1]
        if out.dtype != table.dtype or out.dim() != 2 \
                or out.shape[0] != ids.shape[0] or col_offset < 0 \
                or out.shape[1] < col_offset + D:
            raise ValueError(
                f"gather_rows: out {out.dtype} {tuple(out.shape)} cannot "
                f"take {ids.shape[0]} rows of {D} {table.dtype} at column "
                f"{col_offset}")


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                      out: Optional[torch.Tensor] = None,
                      col_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: ``index_select``
    over clamped ids, then the zero and NaN fills."""
    N, D = table.shape
    ids = ids.long()
    rows = table.index_select(0, ids.clamp(0, N - 1))
    rows = torch.where((ids >= 0)[:, None], rows, 0.0)
    rows = torch.where((ids < N)[:, None], rows, float("nan"))
    if out is None:
        return rows
    out[:, col_offset:col_offset + D] = rows
    return out


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                out: Optional[torch.Tensor] = None,
                col_offset: int = 0) -> torch.Tensor:
    """Rows ``table[ids]`` with zeros for ids < 0 and NaN for ids >= N.

    table f32 or bf16 [N, D], ids int32 [M]. With ``out`` ([M, W], the
    table's dtype, W >= col_offset + D) the rows are written into
    ``out[:, col_offset:col_offset + D]`` and ``out`` is returned; else a
    new [M, D] tensor. ``gather_rows.launches`` counts kernel launches.
    """
    _check(table, ids, out, col_offset)
    if not kernel_device("gather_rows", table):
        return gather_rows_plain(table, ids, out, col_offset)
    lib = build()
    M, (N, D) = ids.shape[0], table.shape
    if out is None:
        out = torch.empty((M, D), dtype=table.dtype, device=table.device)
    launch("gather_rows", lib.etpu_gather_rows, table.device,
           table.data_ptr(), N, D, table.element_size(), ids.data_ptr(), M,
           out.data_ptr(), out.shape[1], col_offset)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
