"""aggregate_roofline: the whole-graph conv's aggregate through its public
entry, ``Block.aggregate_neighbors("add", x, scale=...)``, called as
``GCNConv`` calls it: forward, over the flow's whole-graph block, with the
compact [N, D] feature table as x and the symmetric-norm scale. Bytes
(``arith.aggregate_bytes``): x, one id a real edge and one weight an edge
and self loop, each read once, and the output written once, over
3.35 TB/s, divided by the entry's CUDA-event time with a cold L2, in %."""
import torch

from benchmark.harness.arith import PEAKS, aggregate_bytes
from benchmark.harness.supervised import edge_count
from benchmark.harness.timing import device_ms

LAYER = "conv (models.convs, dataflow.block)"
MOVES = "train_step_ms"


def read(ctx):
    system = ctx.system
    cfg = system.cfg
    if cfg["model"]["flow"] != "whole" or cfg["model"]["conv"] != "gcn":
        return None
    from euler_tpu_torch.models import convs
    dev = system.device
    g = system.graph.tensors
    x = g.dense_nf["feature"]
    n = x.shape[0]
    roots = torch.arange(n, dtype=torch.int32, device=dev)
    with torch.no_grad():
        block = system.model.embedder.flow(g, roots)[0]
        scale = convs._sym_scale(block)
        ms = device_ms(lambda: block.aggregate_neighbors("add", x,
                                                         scale=scale))
    nbytes = aggregate_bytes(n, edge_count(cfg["graph"]), x.shape[1],
                             x.element_size())
    return 100.0 * nbytes / PEAKS["hbm_bytes_per_s"] / (ms / 1e3)
