"""rel_agg_grad_roofline: the typed mean kernel's transpose
(``rel_mean_tr_kernel``, with the chunk kernel ``rel_mean_tr_hub_kernel``
its calls launch first) against its bound: the compulsory bytes of its
calls a step (``rgcn_arith.call_bytes`` of the configuration's shapes,
times the launches a step) over 3.35 TB/s, divided by the kernels' device
ms a step in the traced eager steps (``harness.rel_trace``), in %."""
from benchmark.harness.rel_trace import roofline

LAYER = "conv (models.convs, dataflow.block)"
MOVES = "train_step_ms"


def read(ctx):
    return roofline(ctx, "rel_mean_tr_kernel", ("rel_mean_tr_hub_kernel",),
                    True)
