"""relation_bwd_ms.train: the device ms a training step spends in the
``relation.backward`` spans (each R-GCN layer's backward,
``dataflow.block._RelConv``: the transposed typed mean kernel and the
weights' and input's GEMMs), in eager steps of the cell's own step under
torch.profiler (``harness.rel_trace``)."""
from benchmark.harness.rel_trace import span_ms

LAYER = "conv (models.convs, dataflow.block)"
MOVES = "train_step_ms"


def read(ctx):
    return span_ms(ctx, "relation.backward")
