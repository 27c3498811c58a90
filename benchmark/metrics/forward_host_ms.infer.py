"""forward_host_ms.infer: the median host ms of a request inside its
``forward`` spans (the eager model calls, one a batch: the host's launches
of the draws, gathers, convs and head), over the mix's traced requests run
with tracing on and no profiler (``harness.spans``)."""
from benchmark.harness.spans import infer_value

LAYER = "serve (estimator.infer)"
MOVES = "infer_p95_ms"


def read(ctx):
    return infer_value(ctx, "forward_host_ms")
