"""The traced eager steps that ``head_ms.train`` reads: ``spans.TRAIN_STEPS``
eager steps of the cell's own ``TrainLoop`` step (one more first, not
counted) under torch.profiler with the port's spans recording, reduced
once a run and kept on the run's ``Context``: the device ms a step of
each of ``SPANS``, the kernels launched inside its annotations, by time
and whatever the thread (``spans.inside``, as the other span metrics
attribute them).

``head`` is SuperviseModel's forward head (``head_fc`` and the loss);
``head.backward`` the loss's backward, where the program has that span.
A program without the span recorder reads None; one without a span reads
nothing for it, and the metric is the sum of the spans it has.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from benchmark.harness import spans as spans_lib

SPANS = ("head", "head.backward")


def _run(ctx) -> Optional[dict]:
    trace = spans_lib.port_trace()
    if trace is None:
        return None
    from torch.profiler import record_function
    loop = ctx.system.loop
    loop._step()

    def run():
        with trace.recording():
            for _ in range(spans_lib.TRAIN_STEPS + 1):
                with record_function(spans_lib.STEP):
                    loop._step()
    ev = spans_lib.profiled(run, torch.device(ctx.device).type == "cuda")
    steps = sorted(ev.marks.get(spans_lib.STEP, []))[1:]
    counted = spans_lib.inside(ev.kernels(), steps)
    per = {name: us / spans_lib.TRAIN_STEPS / 1e3 for name, us in
           spans_lib.device_us(counted, ev.marks, SPANS).items()}
    print("head spans, device ms a step "
          f"({spans_lib.TRAIN_STEPS} eager steps): "
          + ", ".join(f"{n} {per[n]:.5f}" for n in SPANS)
          + f"; {sum(1 for n in SPANS if n in ev.marks)} of {len(SPANS)} "
          "spans present", file=sys.stderr)
    return per


def head_trace(ctx) -> Optional[dict]:
    """The reduced run (module docstring), made once a run."""
    if "_head_trace" not in ctx.__dict__:
        ctx.__dict__["_head_trace"] = _run(ctx)
    return ctx.__dict__["_head_trace"]


def head_ms(ctx) -> Optional[float]:
    """The device ms a step of ``head`` and ``head.backward`` together,
    or None where neither launched a kernel (the CPU, or no spans)."""
    got = head_trace(ctx)
    return sum(got.values()) or None if got else None
