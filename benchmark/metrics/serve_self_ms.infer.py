"""serve_self_ms.infer: the median host ms of a request's ``infer`` span
outside its ``forward`` children (the ids' checks, padding and the fresh
generator, the copy to the card, the answer's copy to host memory with its
wait for the card), over the mix's traced requests run with tracing on and
no profiler (``harness.spans``)."""
from benchmark.harness.spans import infer_value

LAYER = "serve (estimator.infer)"
MOVES = "infer_p95_ms"


def read(ctx):
    return infer_value(ctx, "serve_self_ms")
