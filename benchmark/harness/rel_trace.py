"""The traced eager steps that the ``rgcn`` configuration's relation
metrics read: ``spans.TRAIN_STEPS`` eager steps of the cell's own
``TrainLoop`` step (one more first, not counted) under torch.profiler
with the port's spans recording, reduced once a run and kept on the
run's ``Context``:

- ``spans``: the device ms a step of ``relation`` and
  ``relation.backward``, the kernels launched inside their annotations,
  by time and whatever the thread (``spans.inside``);
- ``kernels``: by kernel name, the device ms a step and the launches a
  step of the kernels of the counted steps.

A program without the span recorder reads None; one without a span or a
kernel reads nothing for it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from benchmark.harness import spans as spans_lib
from benchmark.harness.arith import PEAKS
from benchmark.harness.rgcn_arith import call_bytes
from benchmark.harness.supervised import DTYPES

SPANS = ("relation", "relation.backward")


def _run(ctx) -> Optional[dict]:
    trace = spans_lib.port_trace()
    if trace is None:
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.device(ctx.device).type == "cuda"
    loop = ctx.system.loop
    loop._step()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with trace.recording():
            for _ in range(spans_lib.TRAIN_STEPS + 1):
                with record_function(spans_lib.STEP):
                    loop._step()
        if cuda:
            torch.cuda.synchronize()
    events = list(prof.events())
    ev = spans_lib.reduce(events, DeviceType.CUDA)
    steps = sorted(ev.marks.get(spans_lib.STEP, []))[1:]
    n = spans_lib.TRAIN_STEPS
    counted = spans_lib.inside(ev.kernels(), steps)
    per_span = {name: us / n / 1e3 for name, us in spans_lib.device_us(
        counted, ev.marks, SPANS).items()}
    kernels: Dict[str, list] = {}
    for e in events:
        if e.device_type != DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False) or \
                e.name in ev.marks:
            continue
        t = ev.launches.get(e.id)
        if t is None or not spans_lib.inside([(t, 0.0)], steps):
            continue
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / n / 1e3
        k[1] += 1
    return {"spans": per_span,
            "kernels": {name: (ms, count / n)
                        for name, (ms, count) in kernels.items()}}


def rel_trace(ctx) -> Optional[dict]:
    """The reduced run (module docstring), made once a run."""
    if "_rel_trace" not in ctx.__dict__:
        ctx.__dict__["_rel_trace"] = _run(ctx)
    return ctx.__dict__["_rel_trace"]


def span_ms(ctx, name: str) -> Optional[float]:
    got = rel_trace(ctx)
    return got["spans"].get(name) or None if got else None


def _kernel(ctx, part: str) -> Optional[tuple]:
    """(device ms a step, launches a step) of the kernels whose name holds
    ``part``, or None where none ran."""
    got = rel_trace(ctx)
    if not got:
        return None
    hits = [v for name, v in got["kernels"].items() if part in name]
    if not hits:
        return None
    return sum(ms for ms, _ in hits), sum(c for _, c in hits)


def roofline(ctx, main: str, extra: Sequence[str], transpose: bool
             ) -> Optional[float]:
    """The roofline share, in %, of the typed mean kernel ``main`` (with
    the chunk kernels ``extra`` that its calls launch before it): the
    compulsory bytes of its calls a step (``rgcn_arith.call_bytes``, times
    ``main``'s launches a step) over 3.35 TB/s, divided by the device ms a
    step of them all; None outside an ``rgcn`` configuration or where
    ``main`` did not run."""
    cfg = ctx.cfg
    if cfg["model"]["conv"] != "rgcn":
        return None
    got = _kernel(ctx, main)
    if got is None:
        return None
    ms, calls = got
    ms += sum(k[0] for k in (_kernel(ctx, e) for e in extra) if k)
    elt = DTYPES[cfg["model"]["activation_dtype"]].itemsize
    nbytes = call_bytes(cfg, transpose, elt)
    return 100.0 * calls * nbytes / PEAKS["hbm_bytes_per_s"] / (ms / 1e3)
