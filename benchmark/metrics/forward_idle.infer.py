"""forward_idle.infer: the share of a profiled run of the mix's traced
requests, with tracing on, in which no kernel or copy ran on the card
while the host was inside a ``forward`` span (the idle gaps of
``harness.trace`` intersected with the spans' annotations), in %; at most
that run's whole idle share (``harness.spans``)."""
from benchmark.harness.spans import infer_value

LAYER = "serve (estimator.infer)"
MOVES = "infer_p95_ms"


def read(ctx):
    return infer_value(ctx, "forward_idle")
