"""Profile the sampled sage train step of one tree of this package on the
card: the CUDA kernels a step launches, their device time, and the step's
host-clock time.

    python euler_tpu_torch/profile_step.py [--tree DIR] [--out FILE]

The step is ``chip_smoke.py``'s sage train step: bench.py's graph
(200,000 nodes, average degree 25, 128 features, 16 labels, seed 0) and
model (dims (128, 128), fanouts [25, 10]) in f32, batch 1024, Adam 1e-3.
``--tree`` names the root of a checkout whose ``euler_tpu_torch`` is
imported (default: the one this file lies in), so that two trees (for
example a parent commit unpacked with ``git archive``) can be run in turns
on one card. Prints one JSON line; ``--out`` also writes the kernel
counts by name.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

WARMUP, STEPS, PROFILED = 10, 50, 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_step: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import euler_tpu_torch
    from euler_tpu_torch import bench
    from euler_tpu_torch.datasets import random_graph
    from euler_tpu_torch.estimator import (NodeEstimator, RunConfig,
                                           get_optimizer)
    assert os.path.dirname(os.path.dirname(euler_tpu_torch.__file__)) == tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    graph = random_graph(200_000, 25, feat_dim=128, n_classes=16, seed=0,
                         device=dev)
    model = bench.make_model("sage", dev,
                             generator=torch.Generator().manual_seed(0))
    est = NodeEstimator(model, graph, RunConfig(batch_size=1024), device=dev)
    opt = get_optimizer("adam", 1e-3, model.parameters())
    gen = torch.Generator(device=dev).manual_seed(6)

    def step():
        est.step(opt, est.train_batch(graph.tensors, gen), generator=gen)

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    host_ms = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            step()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(dict(
        tree=args.tree, card=smi, steps=STEPS,
        host_ms_median=statistics.median(host_ms),
        host_ms_min=min(host_ms),
        device_events_per_step=sum(n for _, n in by_name.values()) / PROFILED,
        device_busy_ms_per_step=sum(us for us, _ in by_name.values())
        / PROFILED / 1e3)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({name: dict(calls_per_step=n / PROFILED,
                                  us_per_step=us / PROFILED)
                       for name, (us, n) in sorted(by_name.items())}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
