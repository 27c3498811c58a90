"""kernels_per_request.infer: the device's kernel events (copies and
fills left out) in the traced window, per request the window served."""
LAYER = "serve (estimator.infer)"
MOVES = "infer_p95_ms"


def read(ctx):
    t = ctx.trace
    if not t or not t["units"] or not t["kernels"]:
        return None
    return t["kernels"] / t["units"]
