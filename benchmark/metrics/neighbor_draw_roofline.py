"""neighbor_draw_roofline: both hops' weighted neighbor draws through the
sampler's public entry, ``sampling.select_neighbors``, at the step's
shapes (the first recorded step's roots [B] with fanout f1, then its
frontier [B (1 + f1)] with f2) over the cell's own graph: the bytes the
draws need (``arith.draw_bytes``) over 3.35 TB/s, divided by the entry's
CUDA-event time with a cold L2, summed over the hops, in %."""
import torch

from benchmark.harness.arith import PEAKS, draw_bytes
from benchmark.harness.drive import sub_seed
from benchmark.harness.timing import device_ms

LAYER = "sample (ops.sampling, ops.fan_draw)"
MOVES = "train_step_ms"


def read(ctx):
    system, rec = ctx.system, getattr(ctx.drive, "record", None)
    if system.cfg["model"]["flow"] != "sampled" or rec is None:
        return None
    from euler_tpu_torch.ops import sampling
    dev = system.device
    g = system.graph.tensors
    n_id = rec["n_id"][0].to(dev)
    src = torch.from_numpy(system.arrays["src"]).to(dev).long()
    out_deg = torch.bincount(src, minlength=system.cfg["graph"]["nodes"])
    del src
    gen = torch.Generator(device=dev).manual_seed(sub_seed(system.seed,
                                                           "roofline"))
    t = rec["roots"][0].shape[0]
    nbytes, ms = 0, 0.0
    for f in system.cfg["model"]["fanouts"]:
        nodes = n_id[:t].contiguous()
        u = sampling.draw_neighbor_uniforms(g, (0,), gen, t, f, dev)
        ms += device_ms(lambda: sampling.select_neighbors(g, nodes, (0,), u))
        nbytes += draw_bytes(nodes, u[0], out_deg)
        t *= 1 + f
    return 100.0 * nbytes / PEAKS["hbm_bytes_per_s"] / (ms / 1e3)
