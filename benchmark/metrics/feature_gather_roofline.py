"""feature_gather_roofline: the step's deepest feature fetch through the
gather's public entry, ``feature_ops.get_dense_feature`` (sampled: the
first recorded step's source ids, B (1 + f1)(1 + f2) of them; whole
graph: every node once): the bytes it needs (``arith.gather_bytes``) over
3.35 TB/s, divided by the entry's CUDA-event time with a cold L2, in %."""
import torch

from benchmark.harness.arith import PEAKS, gather_bytes
from benchmark.harness.timing import device_ms

LAYER = "feature gather (ops.feature_ops, ops.gather_rows)"
MOVES = "train_step_ms"


def read(ctx):
    system, rec = ctx.system, getattr(ctx.drive, "record", None)
    if rec is None:
        return None
    from euler_tpu_torch.ops import feature_ops
    dev = system.device
    g = system.graph.tensors
    table = g.dense_nf["feature"]
    if system.cfg["model"]["flow"] == "sampled":
        ids = rec["n_id"][0].to(dev).to(torch.int32)
    else:
        ids = torch.arange(table.shape[0], dtype=torch.int32, device=dev)
    ms = device_ms(lambda: feature_ops.get_dense_feature(g, ids,
                                                         ["feature"]))
    nbytes = gather_bytes(table.shape[0],
                          table.shape[1] * table.element_size(), ids)
    return 100.0 * nbytes / PEAKS["hbm_bytes_per_s"] / (ms / 1e3)
