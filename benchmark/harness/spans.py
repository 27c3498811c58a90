"""The port's spans (``euler_tpu_torch.utils.trace``) in short runs of a
cell's own work after the window, for the span metrics' readers.

- Training: eager steps of the cell's own ``TrainLoop`` step
  (``loop._step``: the estimator, optimizer, generator and roots feed of
  the window) under torch.profiler with tracing on. A span's device time
  is the summed duration of the kernels and copies whose launching host
  call (the CUDA runtime call with the same correlation id) falls inside
  one of the span's annotations, by time and not by thread: the backward's
  kernels are launched from autograd's own thread. Kernel durations, not
  event intervals, so an eager step's launch gaps count nowhere.
- Inference: the mix's traced requests with tracing on and no profiler
  (host ms a request from the spans), then again under torch.profiler
  (the card's idle time while the host is inside a ``forward`` span).

Each run is made once a run of the cell and kept on the run's
``Context``, so the readers share it and it is freed with the context. A
program without the span recorder gives no span: every reader then
returns None.
"""
from __future__ import annotations

import bisect
import statistics
import sys
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from benchmark.harness.trace import WINDOW, gaps, merge

#: the spans the five training metrics read, in their order
TRAIN_SPANS = ("dataflow", "gather", "conv", "backward", "optimizer")
#: eager steps counted; one more runs first, its kernels not counted (the
#: profiler may drop a run's first events)
TRAIN_STEPS = 5
#: the annotation around each profiled eager step
STEP = "benchmark.step"

Interval = Tuple[float, float]


def port_trace():
    """The port's span recorder, or None where the program has none."""
    try:
        from euler_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


class Events:
    """A profiled run reduced: ``device`` [(start, end, correlation)] of
    the card's kernels and copies, ``launches`` {correlation: start} of
    the host's CUDA API calls (``cuda*``, ``cu*``), ``marks`` {name:
    [(start, end)]} of every other host event (the spans' annotations
    among them); times in us on the profiler's clock."""

    def __init__(self, device: List[Tuple[float, float, int]],
                 launches: Dict[int, float],
                 marks: Dict[str, List[Interval]]):
        self.device, self.launches, self.marks = device, launches, marks

    def kernels(self) -> List[Tuple[Optional[float], float]]:
        """(launch time or None where no launch matched, duration) of
        each device event."""
        return [(self.launches.get(c), b - a) for a, b, c in self.device]

    def window(self) -> Interval:
        (w,) = self.marks[WINDOW]
        return w


def reduce(events: Iterable, device_kind) -> Events:
    """``Events`` from torch.profiler's events (``prof.events()``, or
    objects with their ``name``, ``id``, ``device_type``, ``time_range``
    and ``is_user_annotation``); ``device_kind`` is the card's
    ``DeviceType``. A runtime call shares its correlation id (``id``)
    with the kernel it launched; its name starts with ``cu``."""
    found, launches, marks = [], {}, {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == device_kind:
            if not getattr(e, "is_user_annotation", False):
                found.append((e.name, a, b, e.id))
        elif e.name.startswith("cu"):
            launches[e.id] = a
        else:
            marks.setdefault(e.name, []).append((a, b))
    # a host annotation's copy on the card's timeline is no device work
    device = [(a, b, c) for name, a, b, c in found if name not in marks]
    return Events(device, launches, marks)


def profiled(fn: Callable[[], object], cuda: bool) -> Events:
    """Run ``fn`` under torch.profiler (the card's activity too where
    ``cuda``) inside a ``WINDOW`` annotation, waiting for the card inside
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    return reduce(prof.events(), DeviceType.CUDA)


def inside(kernels, intervals: List[Interval]
           ) -> List[Tuple[Optional[float], float]]:
    """The kernels whose launch lies in one of ``intervals``."""
    iv = merge(intervals)
    starts = [a for a, _ in iv]
    out = []
    for t, d in kernels:
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= iv[i][1]:
            out.append((t, d))
    return out


def device_us(kernels, marks: Dict[str, List[Interval]],
              names: Iterable[str]) -> Dict[str, float]:
    """Per span name, the summed duration (us) of the kernels launched
    inside one of its annotations."""
    return {n: sum(d for _, d in inside(kernels, marks.get(n, [])))
            for n in names}


def overlap(a: List[Interval], b: List[Interval]) -> float:
    """The length of the intersection of two unions of intervals."""
    a, b = merge(a), merge(b)
    total, j = 0.0, 0
    for x0, x1 in a:
        while j < len(b) and b[j][1] <= x0:
            j += 1
        k = j
        while k < len(b) and b[k][0] < x1:
            total += max(0.0, min(x1, b[k][1]) - max(x0, b[k][0]))
            k += 1
    return total


def idle_inside(ev: Events, name: str) -> Tuple[float, float, float]:
    """(the card's idle share of the profiled window, the share in which
    it was idle while the host was inside a span ``name``, both in %, and
    its busy ms): busy is the union of the device's intervals, clipped to
    the window."""
    w0, w1 = ev.window()
    busy = merge([(max(a, w0), min(b, w1)) for a, b, _ in ev.device
                  if b > w0 and a < w1])
    idle = gaps(busy, w0, w1)
    span = w1 - w0
    busy_us = sum(b - a for a, b in busy)
    return (100.0 * (1.0 - busy_us / span),
            100.0 * overlap(idle, ev.marks.get(name, [])) / span,
            busy_us / 1e3)


def _cached(ctx, key: str, make: Callable[[], Optional[dict]]
            ) -> Optional[dict]:
    if key not in ctx.__dict__:
        ctx.__dict__[key] = make()
    return ctx.__dict__[key]


def _cuda(ctx) -> bool:
    return torch.device(ctx.device).type == "cuda"


# ---- training -------------------------------------------------------------
def _train(ctx) -> Optional[dict]:
    """{span: device ms a step} of the profiled eager steps (empty where
    the card ran nothing), or None without spans."""
    trace = port_trace()
    if trace is None:
        return None
    from torch.profiler import record_function
    loop = ctx.system.loop
    loop._step()

    def run():
        with trace.recording():
            for _ in range(TRAIN_STEPS + 1):
                with record_function(STEP):
                    loop._step()
    ev = profiled(run, _cuda(ctx))
    all_k = ev.kernels()
    if not all_k:
        return {}
    steps = sorted(ev.marks.get(STEP, []))[1:]
    counted = inside(all_k, steps)
    per = {n: us / TRAIN_STEPS / 1e3 for n, us in device_us(
        counted, ev.marks, TRAIN_SPANS + ("forward", "head", "step")
    ).items()}
    total = sum(d for _, d in counted) / TRAIN_STEPS / 1e3
    five = sum(per[n] for n in TRAIN_SPANS)
    fwd_rest = per["forward"] - sum(per[n] for n in
                                    ("dataflow", "gather", "conv", "head"))
    step_rest = per["step"] - sum(per[n] for n in
                                  ("forward", "backward", "optimizer"))
    line = (f"span device ms a step ({TRAIN_STEPS} eager steps): "
            + ", ".join(f"{n} {per[n]:.5f}" for n in TRAIN_SPANS)
            + f"; remainder {total - five:.5f} = head {per['head']:.5f}"
            f" + forward's rest (casts, out_fc) {fwd_rest:.5f}"
            f" + step's rest (zero_grad) {step_rest:.5f}"
            f" + outside step (root draw) {total - per['step']:.5f}"
            f"; kernel time {total:.5f}; {len(counted)} of {len(all_k)}"
            f" device events counted, "
            f"{sum(1 for t, _ in all_k if t is None)} with no launch found")
    t = getattr(ctx, "trace", None)
    if t and t.get("units"):
        busy = t["busy_s"] / t["units"] * 1e3
        line += (f"; the replayed step's busy ms {busy:.5f} "
                 f"(eager kernel time / busy {total / busy:.4f})")
    print(line, file=sys.stderr)
    return per


def train_ms(ctx, name: str) -> Optional[float]:
    """Span ``name``'s device ms a step, or None."""
    per = _cached(ctx, "_span_train", lambda: _train(ctx))
    return per.get(name) if per else None


# ---- inference ------------------------------------------------------------
def _infer(ctx) -> Optional[dict]:
    """``serve_self_ms``, ``forward_host_ms`` (medians over the traced
    requests) and ``forward_idle`` (%, None where the card ran nothing),
    or None without spans."""
    trace = port_trace()
    drive = ctx.drive
    if trace is None:
        return None
    with trace.recording() as spans:
        n = drive.traced()
    infers = [s for s in spans if s.name == "infer"]
    if not infers:
        return None
    outside = trace.self_times(spans, cover=("forward",))
    own = trace.self_times(spans)
    by_req: Dict[object, Dict[str, int]] = {}
    for s in spans:
        if s.parent is not None and s.parent.name == "infer":
            d = by_req.setdefault(s.request, {})
            d[s.name] = d.get(s.name, 0) + s.duration_ns
    med = {name: statistics.median(by_req.get(s.request, {}).get(name, 0)
                                   for s in infers) / 1e6
           for name in ("forward", "infer.pad", "infer.h2d", "infer.d2h")}
    out = dict(serve_self_ms=statistics.median(outside[s] for s in infers)
               / 1e6, forward_host_ms=med["forward"], forward_idle=None)
    host = statistics.median(s.duration_ns for s in infers) / 1e6
    line = (f"infer spans, host ms a request (median of {len(infers)}): "
            f"infer {host:.4f}, forward {med['forward']:.4f}, outside "
            f"forward {out['serve_self_ms']:.4f} (pad "
            f"{med['infer.pad']:.4f}, h2d {med['infer.h2d']:.4f}, d2h "
            f"{med['infer.d2h']:.4f}, infer's own "
            f"{statistics.median(own[s] for s in infers) / 1e6:.4f})")

    def run():
        with trace.recording():
            drive.traced()
    ev = profiled(run, _cuda(ctx))
    if ev.device:
        idle, out["forward_idle"], busy_ms = idle_inside(ev, "forward")
        line += (f"; profiled: idle {idle:.3f}% of the run, idle inside "
                 f"forward {out['forward_idle']:.3f}%, card busy "
                 f"{busy_ms / n:.4f} ms a request")
    print(line, file=sys.stderr)
    return out


def infer_value(ctx, name: str) -> Optional[float]:
    """``name`` of the inference runs' figures, or None."""
    got = _cached(ctx, "_span_infer", lambda: _infer(ctx))
    return got.get(name) if got else None
