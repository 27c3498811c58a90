"""gat_step_mfu.train: the model FLOPs a multi-head GAT training step
needs (``gat_arith.gat_step_flops``: forward, the weight gradients, the
input gradients that are needed, the attention's sums and their
transposes, from the configuration's shapes) per second of a step of the
run's measured window (``train_step_ms``, untraced), as a share of the
card's float32 peak, 67 TFLOP/s (NVIDIA's figure for an H100 SXM at its
700 W limit): the layers' matmuls run in float32 without TF32, the
activations promoted to the float32 weights."""
from benchmark.harness.arith import PEAKS
from benchmark.harness.gat_arith import cfg_flops
from benchmark.harness.supervised import edge_count

LAYER = "whole step (estimator, models.gnn)"
MOVES = "train_step_ms"


def read(ctx):
    step_ms = ctx.window["metrics"].get("train_step_ms")
    if not step_ms or ctx.cfg["model"]["conv"] != "gat":
        return None
    flops = cfg_flops(ctx.cfg, edge_count(ctx.cfg["graph"]))
    return 100.0 * flops / (step_ms / 1e3) / PEAKS["float32_flops"]
