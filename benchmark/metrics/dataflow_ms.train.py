"""dataflow_ms.train: the device ms a training step spends in the
``dataflow`` span (``GNNNet.forward``'s flow: sage's two hops of neighbor
draws, gcn's whole-graph blocks): the kernels launched inside it, in eager
steps of the cell's own step under torch.profiler (``harness.spans``)."""
from benchmark.harness.spans import train_ms

LAYER = "sample (ops.sampling, ops.fan_draw)"
MOVES = "train_step_ms"


def read(ctx):
    return train_ms(ctx, "dataflow")
