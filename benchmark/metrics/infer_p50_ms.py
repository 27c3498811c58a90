"""infer_p50_ms: the median latency of the measured window's requests,
host clock, each from the call of ``infer`` to its answer in host
memory."""
import statistics

LAYER = "serve (estimator.infer)"
MOVES = "infer_p95_ms"


def read(ctx):
    lat = getattr(ctx.drive, "latencies", None)
    return statistics.median(lat) if lat else None
