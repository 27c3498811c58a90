"""head_ms.train: the device ms a training step spends in the supervised
head, the ``head`` span (``head_fc`` and the loss's forward) and the
``head.backward`` span (the loss's backward, ``models.gnn._SigmoidXent``),
in eager steps of the cell's own step under torch.profiler
(``harness.head_trace``). A program without ``head.backward`` reads
``head`` alone."""
from benchmark.harness.head_trace import head_ms

LAYER = "whole step (estimator, models.gnn)"
MOVES = "train_step_ms"


def read(ctx):
    return head_ms(ctx)
