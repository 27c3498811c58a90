"""device_idle.train: the share of the traced window (a run of the
cell's own steps under torch.profiler) in which no kernel or copy ran
on the card, 1 - (union of the device's intervals) / window, in %."""
LAYER = "device"
MOVES = "train_step_ms"


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
