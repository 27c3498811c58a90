"""The collectives of the sharded plane and their byte accounting.

Counterpart of euler_tpu/parallel/comms.py. Each wrapper runs one
torch.distributed collective over a process group and, while an
``account()`` context is active, records the bytes each rank moves by
the reference's cost model (comms.py:1-20, unchanged):

  all_gather  of n local bytes over S ranks : rx (S-1) * n
  all_to_all  of n total bytes              : tx (S-1)/S * n
  psum/pmean  (ring all-reduce) of n bytes  : 2 (S-1)/S * n
  ppermute    of n bytes                    : n

The reference counts at trace time, once per compiled step; here each
call counts when it runs, and a call made by a backward pass counts
under ``"backward"`` (``totals("backward")``). The transport follows the
group's backend: NCCL moves the tensors where they lie (one card a
rank); gloo is the CPU backend, so a device tensor is copied to the host
before a gloo collective and its result copied back, every time. Those
copies are counted apart, under "host_staged" (both directions), which
is not a collective and stays out of "total".

``all_gather``, ``all_to_all``, ``psum``, ``pmean`` and ``ppermute`` are
differentiable.
Each backward is the reference's transpose under
``shard_map(check_vma=False)``, which treats every cotangent as varying
over the ranks:

  all_gather  -> a sum-scatter: rank i gets the sum over ranks j of
                 row i of j's cotangent (an all_to_all and a sum; gloo
                 has no reduce_scatter)
  all_to_all  -> the reverse all_to_all (the tiled exchange is its own
                 transpose)
  psum        -> psum of the cotangent
  pmean       -> psum of the cotangent over S
  ppermute    -> ppermute of the cotangent over the inverted pairs

so that d/dw of ``pmean(w * x_g)`` is ``x_g`` on rank g, not ``x_g / S``.
``pmax`` has no derivative: it raises where autograd would record it, as
the reference's "Differentiation rule for 'pmax' not implemented". A
backward runs its collective on every rank that ran the forward, so every
rank must backpropagate through the same collectives in the same order:
a backward depends on nothing that differs by rank.

Usage::

    with comms.account() as acc:
        out = apply(batch)
    print(acc.table())
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_ACTIVE: List["Accounting"] = []

#: the key of the host copies of gloo collectives in ``totals()``
HOST_STAGED = "host_staged"
FORWARD, BACKWARD = "forward", "backward"


class Accounting:
    def __init__(self):
        # (collective, group size, bytes per rank, direction)
        self.events: List[Tuple[str, int, int, str]] = []
        self.staged: Dict[str, int] = {FORWARD: 0, BACKWARD: 0}

    @property
    def host_staged(self) -> int:
        return sum(self.staged.values())

    def add(self, kind: str, size: int, nbytes: float,
            direction: str = FORWARD):
        self.events.append((kind, size, int(nbytes), direction))

    def totals(self, direction: Optional[str] = None) -> Dict[str, int]:
        """Bytes a rank by collective and their ``total``, with
        ``host_staged`` apart; of one direction where it is given."""
        out: Dict[str, int] = {}
        for kind, _size, b, d in self.events:
            if direction in (None, d):
                out[kind] = out.get(kind, 0) + b
        out["total"] = sum(out.values())
        out[HOST_STAGED] = (self.host_staged if direction is None
                            else self.staged[direction])
        return out

    def table(self) -> str:
        t = self.totals()
        lines = [f"  {k:12s} {v / 1e6:10.3f} MB/step/rank"
                 for k, v in sorted(t.items())
                 if k not in ("total", HOST_STAGED)]
        lines.append(f"  {'total':12s} {t['total'] / 1e6:10.3f} "
                     f"MB/step/rank")
        lines.append(f"  {HOST_STAGED:12s} {t[HOST_STAGED] / 1e6:10.3f} "
                     f"MB/step/rank (not a collective)")
        return "\n".join(lines)

    def predicted_efficiency(self, step_time_s: float,
                             link_bytes_per_s: float) -> float:
        """The scaling efficiency the counted bytes predict with no
        overlap of compute and communication (pessimistic): t_comp /
        (t_comp + t_link), ``step_time_s`` the measured one-rank step
        time and ``link_bytes_per_s`` a measured rate of the link each
        rank sends on (the reference's default is its TPU's, which says
        nothing of a GPU's, so there is none here)."""
        t_link = self.totals()["total"] / link_bytes_per_s
        return step_time_s / (step_time_s + t_link)


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


def _log(kind: str, size: int, nbytes: float, direction: str):
    for acc in _ACTIVE:
        acc.add(kind, size, nbytes, direction)


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _to_wire(x: torch.Tensor, group, direction: str) -> torch.Tensor:
    """``x`` contiguous, on the host where the group is gloo's."""
    if _staged(group) and x.device.type != "cpu":
        for acc in _ACTIVE:
            acc.staged[direction] += _nbytes(x)
        return x.detach().to("cpu").contiguous()
    return x.detach().contiguous()


def _from_wire(y: torch.Tensor, like: torch.Tensor,
               direction: str) -> torch.Tensor:
    if y.device != like.device:
        for acc in _ACTIVE:
            acc.staged[direction] += _nbytes(y)
        return y.to(like.device)
    return y


def group_size(group) -> int:
    return dist.get_world_size(group)


# ---------------------------------------------------------------------------
# the collectives themselves (no autograd)
# ---------------------------------------------------------------------------

def _all_gather(x: torch.Tensor, group, direction: str) -> torch.Tensor:
    S = group_size(group)
    w = _to_wire(x, group, direction)
    parts = [torch.empty_like(w) for _ in range(S)]
    dist.all_gather(parts, w, group=group)
    _log("all_gather", S, (S - 1) * _nbytes(x), direction)
    return _from_wire(torch.stack(parts), x, direction)


def _all_to_all(x: torch.Tensor, group, direction: str) -> torch.Tensor:
    S = group_size(group)
    if x.shape[0] % S:
        raise ValueError(f"all_to_all: {x.shape[0]} rows do not split over "
                         f"{S} ranks")
    w = _to_wire(x, group, direction)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    _log("all_to_all", S, (S - 1) / S * _nbytes(x), direction)
    return _from_wire(out, x, direction)


def _all_reduce(x: torch.Tensor, group, kind: str, op,
                direction: str) -> torch.Tensor:
    S = group_size(group)
    w = _to_wire(x, group, direction).clone()
    dist.all_reduce(w, op=op, group=group)
    _log(kind, S, 2 * (S - 1) / S * _nbytes(x), direction)
    return _from_wire(w, x, direction)


def _ppermute(x: torch.Tensor, group, perm, direction: str) -> torch.Tensor:
    """Rank ``src`` of each (src, dst) pair of ``perm`` (group-local
    indices) sends its ``x`` to rank ``dst``; a rank that no pair sends to
    gets zeros. One ``batch_isend_irecv`` of this rank's sends and
    receives; a rank in no pair posts nothing."""
    S, me = group_size(group), dist.get_rank(group)
    w = _to_wire(x, group, direction)
    out = torch.zeros_like(w)
    ops = []
    for src, dst in perm:
        if src == dst == me:
            out.copy_(w)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, w,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _log("ppermute", S, _nbytes(x), direction)
    return _from_wire(out, x, direction)


def _sum_scatter(g: torch.Tensor, group, direction: str) -> torch.Tensor:
    """[S, *shape] on every rank -> this rank's [*shape]: the sum over
    ranks j of row (this rank) of j's ``g``."""
    S = g.shape[0]
    return _all_to_all(g.reshape((S, -1)), group, direction).sum(0).reshape(
        g.shape[1:])


# ---------------------------------------------------------------------------
# differentiable wrappers
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group, FORWARD)

    @staticmethod
    def backward(ctx, g):
        return _sum_scatter(g.contiguous(), ctx.group, BACKWARD), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group, FORWARD)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group, BACKWARD), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mean):
        ctx.group, ctx.mean = group, mean
        S = group_size(group)
        y = _all_reduce(x, group, "pmean" if mean else "psum",
                        dist.ReduceOp.SUM, FORWARD)
        return y / S if mean else y

    @staticmethod
    def backward(ctx, g):
        S = group_size(ctx.group)
        y = _all_reduce(g.contiguous(), ctx.group, "psum",
                        dist.ReduceOp.SUM, BACKWARD)
        return (y / S if ctx.mean else y), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm, FORWARD)

    @staticmethod
    def backward(ctx, g):
        back = [(dst, src) for src, dst in ctx.perm]
        return (_ppermute(g.contiguous(), ctx.group, back, BACKWARD), None,
                None)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[S, *x.shape]: row i is rank i's ``x`` (the reference's
    ``jax.lax.all_gather(x, axis)``)."""
    return _AllGather.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled along dim 0: x [S*k, ...] sends rows [j*k, (j+1)*k) to rank
    j; row block i of the result came from rank i (the reference's
    ``all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    return _AllToAll.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``."""
    return _PSum.apply(x, group, False)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of every rank's ``x``."""
    return _PSum.apply(x, group, True)


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """Rank ``dst`` gets rank ``src``'s ``x`` for each ``(src, dst)`` pair
    of ``perm`` (indices within ``group``), and zeros where no pair sends
    to it (the reference's ``jax.lax.ppermute(x, axis, perm)``). Every
    rank of the group passes the same ``perm``; no index may be a source,
    or a destination, twice."""
    S = group_size(group)
    perm = [(int(s), int(d)) for s, d in perm]
    for end in (0, 1):
        seen = [p[end] for p in perm]
        if len(set(seen)) != len(seen) or any(not 0 <= i < S for i in seen):
            raise ValueError(f"ppermute: {perm} is not a permutation of "
                             f"the group's {S} ranks")
    return _PPermute.apply(x, group, tuple(perm))


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of every rank's ``x``. Not differentiable:
    it raises where autograd would record it (detach its input, as the
    reference's softmax stops the gradient before its pmax)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("pmax has no derivative (the reference: "
                           "\"Differentiation rule for 'pmax' not "
                           "implemented\"); detach its input")
    return _all_reduce(x, group, "pmax", dist.ReduceOp.MAX, FORWARD)

