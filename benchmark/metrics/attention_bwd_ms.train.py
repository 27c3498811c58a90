"""attention_bwd_ms.train: the device ms a training step spends in the
``attention.backward`` spans (the multi-head ELL aggregate's backward,
``dataflow.block._EllAttn``: the cotangent's padding, the transpose and
the weights' gradient), in eager steps of the cell's own step under
torch.profiler (``harness.attn_trace``)."""
from benchmark.harness.attn_trace import attn_trace

LAYER = "conv (models.convs, dataflow.block)"
MOVES = "train_step_ms"


def read(ctx):
    got = attn_trace(ctx)
    return got["spans"].get("attention.backward") or None if got else None
