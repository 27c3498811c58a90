"""rgcn_step_mfu.train: the model FLOPs an R-GCN training step needs
(``rgcn_arith.rgcn_step_flops``: the forward, the weight gradients and
the input gradients that are needed, the first layer's into the
embedding tables, from the configuration's shapes) per second of a step
of the run's measured window (``train_step_ms``, untraced), as a share of
the card's float32 peak, 67 TFLOP/s (NVIDIA's figure for an H100 SXM at
its 700 W limit): the layers' matmuls run in float32 without TF32."""
from benchmark.harness.arith import PEAKS
from benchmark.harness.rgcn_arith import rgcn_step_flops

LAYER = "whole step (estimator, models.gnn)"
MOVES = "train_step_ms"


def read(ctx):
    step_ms = ctx.window["metrics"].get("train_step_ms")
    if not step_ms or ctx.cfg["model"]["conv"] != "rgcn":
        return None
    return (100.0 * rgcn_step_flops(ctx.cfg) / (step_ms / 1e3)
            / PEAKS["float32_flops"])
