"""step_mfu.train: the model FLOPs a training step needs (forward, the
weight gradients and the input gradients that are needed, counted from
the configuration's shapes in ``harness.arith``) per second of a step of
the run's measured window (``train_step_ms``, untraced: the profiler
slows the host's launches), as a share of the card's published peak for
the precision the step's matmuls run in.

That precision is float32 without TF32: the convs' Linear layers take
bfloat16 activations up to their float32 weights (``SAGEConv.forward``,
``GCNConv.forward``), so the peak is 67 TFLOP/s, NVIDIA's figure for an
H100 SXM at its 700 W limit."""
from benchmark.harness.arith import PEAKS, gcn_step_flops, sage_step_flops
from benchmark.harness.supervised import edge_count

LAYER = "whole step (estimator, models.gnn)"
MOVES = "train_step_ms"
PRECISION = "float32_flops"


def step_flops(cfg: dict) -> int:
    m, d, g = cfg["model"], cfg["data"], cfg["graph"]
    if m["flow"] == "sampled":
        return sage_step_flops(cfg["train"]["batch"], m["fanouts"],
                               d["feature_dim"], m["dims"], d["classes"])
    return gcn_step_flops(g["nodes"], edge_count(g), m["layers"],
                          d["feature_dim"], m["dims"], d["classes"],
                          roots=cfg["train"]["batch"])


def read(ctx):
    step_ms = ctx.window["metrics"].get("train_step_ms")
    if not step_ms:
        return None
    return 100.0 * step_flops(ctx.cfg) / (step_ms / 1e3) / PEAKS[PRECISION]
