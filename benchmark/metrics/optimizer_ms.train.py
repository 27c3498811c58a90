"""optimizer_ms.train: the device ms a training step spends in the
``optimizer`` span (``optimizer.step()`` in ``BaseEstimator.step``, Adam):
the kernels launched inside it, in eager steps of the cell's own step
under torch.profiler (``harness.spans``)."""
from benchmark.harness.spans import train_ms

LAYER = "whole step (estimator, models.gnn)"
MOVES = "train_step_ms"


def read(ctx):
    return train_ms(ctx, "optimizer")
