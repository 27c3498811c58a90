"""relation_ms.train: the device ms a training step's forward spends in
the ``relation`` spans (each R-GCN layer over the typed whole-graph
block: the W_r and root GEMMs and the typed mean kernel), in eager steps
of the cell's own step under torch.profiler (``harness.rel_trace``)."""
from benchmark.harness.rel_trace import span_ms

LAYER = "conv (models.convs, dataflow.block)"
MOVES = "train_step_ms"


def read(ctx):
    return span_ms(ctx, "relation")
