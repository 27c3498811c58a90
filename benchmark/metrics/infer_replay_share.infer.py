"""infer_replay_share.infer: the share of the padded batches that the
estimator's ``infer`` served by a replay of its captured forward, in %:
``100 * infer_replays / infer_batches``, the program's own counters over
the whole run (set-up, the window and the traced requests). None where
the batches ran on no card, or where the program keeps no such counters.
"""
import torch

LAYER = "serve (estimator.infer)"
MOVES = "infer_p95_ms"


def read(ctx):
    est = getattr(ctx.system, "est", None)
    batches = getattr(est, "infer_batches", 0)
    if torch.device(ctx.device).type != "cuda" or not batches:
        return None
    return 100.0 * getattr(est, "infer_replays", 0) / batches
