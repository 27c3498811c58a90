"""The collectives of the sharded plane and their byte accounting.

Counterpart of euler_tpu/parallel/comms.py. Each wrapper runs one
torch.distributed collective over a process group and, while an
``account()`` context is active, records the bytes each rank moves by
the reference's cost model (comms.py:1-20, unchanged):

  all_gather  of n local bytes over S ranks : rx (S-1) * n
  all_to_all  of n total bytes              : tx (S-1)/S * n
  psum/pmean  (ring all-reduce) of n bytes  : 2 (S-1)/S * n

The reference counts at trace time, once per compiled step; here each
call counts when it runs. The transport follows the group's backend:
NCCL moves the tensors where they lie (one card a rank); gloo is the
CPU backend, so a device tensor is copied to the host before a gloo
collective and its result copied back, every time. Those copies are
counted apart, under "host_staged" (both directions), which is not a
collective and stays out of "total".

Usage::

    with comms.account() as acc:
        out = apply(batch)
    print(acc.totals())
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

_ACTIVE: List["Accounting"] = []

#: the key of the host copies of gloo collectives in ``totals()``
HOST_STAGED = "host_staged"


class Accounting:
    def __init__(self):
        # (collective, group size, bytes per rank)
        self.events: List[Tuple[str, int, int]] = []
        self.host_staged = 0

    def add(self, kind: str, size: int, nbytes: float):
        self.events.append((kind, size, int(nbytes)))

    def totals(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for kind, _size, b in self.events:
            out[kind] = out.get(kind, 0) + b
        out["total"] = sum(out.values())
        out[HOST_STAGED] = self.host_staged
        return out


@contextlib.contextmanager
def account():
    acc = Accounting()
    _ACTIVE.append(acc)
    try:
        yield acc
    finally:
        _ACTIVE.remove(acc)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _log(kind: str, size: int, nbytes: float):
    for acc in _ACTIVE:
        acc.add(kind, size, nbytes)


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _to_wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` contiguous, on the host where the group is gloo's."""
    if _staged(group) and x.device.type != "cpu":
        for acc in _ACTIVE:
            acc.host_staged += _nbytes(x)
        return x.detach().to("cpu").contiguous()
    return x.contiguous()


def _from_wire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if y.device != like.device:
        for acc in _ACTIVE:
            acc.host_staged += _nbytes(y)
        return y.to(like.device)
    return y


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[S, *x.shape]: row i is rank i's ``x`` (the reference's
    ``jax.lax.all_gather(x, axis)``)."""
    S = group_size(group)
    w = _to_wire(x, group)
    parts = [torch.empty_like(w) for _ in range(S)]
    dist.all_gather(parts, w, group=group)
    _log("all_gather", S, (S - 1) * _nbytes(x))
    return _from_wire(torch.stack(parts), x)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled along dim 0: x [S*k, ...] sends rows [j*k, (j+1)*k) to rank
    j; row block i of the result came from rank i (the reference's
    ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    S = group_size(group)
    if x.shape[0] % S:
        raise ValueError(f"all_to_all: {x.shape[0]} rows do not split over "
                         f"{S} ranks")
    w = _to_wire(x, group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    _log("all_to_all", S, (S - 1) / S * _nbytes(x))
    return _from_wire(out, x)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``."""
    S = group_size(group)
    w = _to_wire(x, group).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    _log("psum", S, 2 * (S - 1) / S * _nbytes(x))
    return _from_wire(w, x)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of every rank's ``x``."""
    S = group_size(group)
    w = _to_wire(x, group).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    _log("pmean", S, 2 * (S - 1) / S * _nbytes(x))
    return _from_wire(w / S, x)
