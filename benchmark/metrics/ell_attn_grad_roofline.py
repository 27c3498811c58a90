"""ell_attn_grad_roofline: the multi-head ELL aggregate's backward kernels
(the transpose ``ell_attn_tr_kernel`` and the weights' gradient
``ell_sddmm_kernel``) against their bound: the compulsory bytes of their
calls a step over 3.35 TB/s, divided by their device ms a step in the
traced eager steps (``harness.attn_trace.roofline``), in %."""
from benchmark.harness.attn_trace import roofline

LAYER = "conv (models.convs, dataflow.block)"
MOVES = "train_step_ms"


def read(ctx):
    return roofline(ctx, ("ell_attn_tr_kernel", "ell_sddmm_kernel"))
