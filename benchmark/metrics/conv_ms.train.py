"""conv_ms.train: the device ms a training step's forward spends in the
``conv`` spans (each conv call of ``GNNNet.forward``, every layer): the
kernels launched inside them, in eager steps of the cell's own step under
torch.profiler (``harness.spans``). Their backward counts under
``backward_ms.train``."""
from benchmark.harness.spans import train_ms

LAYER = "conv (models.convs, dataflow.block)"
MOVES = "train_step_ms"


def read(ctx):
    return train_ms(ctx, "conv")
