"""backward_ms.train: the device ms a training step spends in the
``backward`` span (``loss.backward()`` in ``BaseEstimator.step``): the
kernels launched inside it from any thread (autograd launches from its
own), in eager steps of the cell's own step under torch.profiler
(``harness.spans``)."""
from benchmark.harness.spans import train_ms

LAYER = "whole step (estimator, models.gnn)"
MOVES = "train_step_ms"


def read(ctx):
    return train_ms(ctx, "backward")
