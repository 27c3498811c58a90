"""gather_ms.train: the device ms a training step spends in the ``gather``
spans (the features' and the labels' row gathers: ``ShallowEncoder``'s
dense fetch and ``feature_ops.get_dense_feature``): the kernels launched
inside them, in eager steps of the cell's own step under torch.profiler
(``harness.spans``)."""
from benchmark.harness.spans import train_ms

LAYER = "feature gather (ops.feature_ops, ops.gather_rows)"
MOVES = "train_step_ms"


def read(ctx):
    return train_ms(ctx, "gather")
