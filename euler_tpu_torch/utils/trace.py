"""Spans at the port's layer boundaries, the one span recorder of the port.

``with span(name):`` marks a layer's work. Tracing is off by default, and
then ``span`` costs one test of a module flag and returns a shared no-op
object: it allocates nothing, creates no CUDA event and makes no profiler
call. ``recording()`` turns tracing on and yields the list of the spans
that finish while it is open. Each span then records its ``name``, its
``parent`` (the span open around it on the same thread, or None), its
``request`` (the id of the request it serves, taken from the parent where
not given), ``t0_ns`` and ``t1_ns`` (``time.perf_counter_ns()``) and its
``thread``, and it enters ``torch.profiler.record_function(name)``, so a
running ``torch.profiler`` holds it as a host annotation on the clock of
the card's kernels: a layer's device time is that of the kernels launched
inside its annotation.

Spans run on the host only. Inside a CUDA-graph capture they run once and
are absent from the replays, and on or off they change no value the
program computes.

The spans (name: where):

- ``loop`` (``TrainLoop.__call__``) around ``loop.capture`` (the warm-up
  step and the capture) and ``loop.replay`` (each ``graph.replay()``);
- ``step`` (``BaseEstimator.step``) around ``forward`` (the model call),
  ``backward`` (``loss.backward()``) and ``optimizer``
  (``optimizer.step()``);
- ``infer`` (``BaseEstimator.infer``, carrying the estimator's
  ``requests`` count as its request id) around ``infer.pad`` (padding and
  the generator), then per batch ``infer.h2d`` and ``forward`` (the model
  call; on the card, after the warm-up batch and the capture, a replay of
  ``InferGraph``'s captured forward and the hooks' calls, with no
  ``dataflow``, ``gather``, ``conv`` or ``head`` span inside), and
  ``infer.d2h`` (the answer to host memory);
- ``dataflow`` (``GNNNet.forward``: the flow's sampling or whole-graph
  blocks), ``gather`` (``feature_ops.get_dense_feature`` and
  ``ShallowEncoder``'s dense fetch: the labels' and the features' rows),
  ``conv`` (each conv call of ``GNNNet.forward``) and ``head``
  (``SuperviseModel``'s ``head_fc`` and loss), inside ``forward``;
  ``head.backward`` (the loss's backward, ``models.gnn._SigmoidXent``:
  the logits' gradient), opened on autograd's thread;
- ``attention`` (each multi-head ``GATConv``'s scores, softmax and
  per-head weighted sum), inside its ``conv``; ``attention.backward``
  (the backward of GAT's fused attention, ``dataflow.block._EllGat``:
  the SDDMM with the softmax's gradient, the transpose, and a_l's and
  a_r's gradients), opened on autograd's thread;
- ``relation`` (R-GCN's layer over a typed whole-graph block,
  ``RelationConv`` with ``per_relation``: the W_r and root GEMMs and the
  typed mean kernel), inside its ``conv``; ``relation.backward`` (its
  backward, ``dataflow.block._RelConv``: the transposed kernel and the
  weights' and input's GEMMs), opened on autograd's thread. The
  ``TypedEncoder``'s feature fetch is a ``gather``.

The counters beside them: the kernel wrappers' ``launches``
(``ops.COUNTED``: ``fan_draw``, ``gather_rows``, ``ell_agg``,
``ell_sddmm``, ``ell_gat``, ``rel_mean``, ``rel_mean_tr``, the last two
counting their chunk kernels' launches too, and ``sigmoid_xent``, one a
call of the loss's forward or backward), ``TrainLoop.held``,
``InferGraph.held`` and ``BaseEstimator.requests``, ``infer_batches``,
``infer_replays`` and ``infer_captures``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from torch.profiler import record_function

#: the lists that ``recording()`` contexts collect finished spans in
_sinks: Tuple[List["Span"], ...] = ()
#: whether any ``recording()`` is open: the one test an off span costs
_on = False
_local = threading.local()


class Span:
    """One span: ``name``, ``parent`` (a ``Span`` or None), ``request``
    (an int or None), ``t0_ns``, ``t1_ns`` and ``thread``. ``span()``
    makes it and the ``with`` statement fills it in; records may also be
    built whole, as the self-time helpers take any."""

    __slots__ = ("name", "parent", "request", "t0_ns", "t1_ns", "thread",
                 "_annotation")

    def __init__(self, name: str, parent: Optional["Span"] = None,
                 request: Optional[int] = None, t0_ns: int = 0,
                 t1_ns: int = 0, thread: int = 0):
        self.name, self.parent, self.request = name, parent, request
        self.t0_ns, self.t1_ns, self.thread = t0_ns, t1_ns, thread

    @property
    def duration_ns(self) -> int:
        return self.t1_ns - self.t0_ns

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.request is None and self.parent is not None:
            self.request = self.parent.request
        self.thread = threading.get_ident()
        self._annotation = record_function(self.name)
        self._annotation.__enter__()
        stack.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.perf_counter_ns()
        self._annotation.__exit__(*exc)
        self._annotation = None
        _stack().pop()
        for sink in _sinks:
            sink.append(self)
        return False


class _Off:
    """The shared span of tracing off: entering and leaving do nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, request: Optional[int] = None):
    """A span named ``name`` around a ``with`` block; ``request``, where
    given, is the id its children inherit. Off: the shared ``OFF``."""
    if not _on:
        return OFF
    return Span(name, request=request)


def enabled() -> bool:
    """Whether tracing is on (some ``recording()`` is open)."""
    return _on


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Turn tracing on for the ``with`` block; yields the list that the
    spans finishing inside it are appended to, in the order they finish.
    Tracing goes off again when the last open ``recording()`` closes.
    Nothing is written anywhere."""
    global _sinks, _on
    sink: List[Span] = []
    _sinks = _sinks + (sink,)
    _on = True
    try:
        yield sink
    finally:
        _sinks = tuple(s for s in _sinks if s is not sink)
        _on = bool(_sinks)


def self_times(spans: Sequence[Span], cover: Optional[Iterable[str]] = None
               ) -> Dict[Span, int]:
    """Each span's self time in ns: its duration less the part of its
    interval that its children in ``spans`` cover (each instant once),
    counting only the children named in ``cover`` where it is given."""
    names = None if cover is None else set(cover)
    kids: Dict[Span, List[Tuple[int, int]]] = {}
    for s in spans:
        if s.parent is not None and (names is None or s.name in names):
            kids.setdefault(s.parent, []).append((s.t0_ns, s.t1_ns))
    out = {}
    for s in spans:
        covered, end = 0, s.t0_ns
        for a, b in sorted(kids.get(s, ())):
            a, b = max(a, end), min(b, s.t1_ns)
            if b > a:
                covered += b - a
                end = b
        out[s] = s.duration_ns - covered
    return out
