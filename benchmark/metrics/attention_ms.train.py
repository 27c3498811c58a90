"""attention_ms.train: the device ms a training step's forward spends in
the ``attention`` spans (each multi-head ``GATConv``'s scores, softmax and
per-head weighted sum), in eager steps of the cell's own step under
torch.profiler (``harness.attn_trace``)."""
from benchmark.harness.attn_trace import attn_trace

LAYER = "conv (models.convs, dataflow.block)"
MOVES = "train_step_ms"


def read(ctx):
    got = attn_trace(ctx)
    return got["spans"].get("attention") or None if got else None
