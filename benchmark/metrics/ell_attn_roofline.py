"""ell_attn_roofline: the multi-head ELL aggregate's forward kernel
(``ell_attn_fwd_kernel``) against its bound: the compulsory bytes of its
calls a step (``gat_arith.call_bytes`` of the configuration's shapes,
times the launches a step) over 3.35 TB/s, divided by the kernel's device
ms a step in the traced eager steps (``harness.attn_trace``), in %."""
from benchmark.harness.attn_trace import roofline

LAYER = "conv (models.convs, dataflow.block)"
MOVES = "train_step_ms"


def read(ctx):
    return roofline(ctx, ("ell_attn_fwd_kernel",))
