"""The readings that a cell's correctness limits are set from. The
benchmark's own runs never run this.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 1,2,3 [--window 2] [--out FILE]

In one process (the graph is built once): for every seed of ``--seeds``
the program runs as a run of the cell does (set-up with its first steps
through the window's own call, or a short window of requests at the
cell's load), and its numbers against the reference are its lower
readings. For every seed of ``--control-seeds`` it also reads:

- the control: the reference put in the program's place with its
  activations in float8 (e4m3), the precision below the bfloat16 the
  configuration states, against the reference;
- the faults a cell can have, planted in the reference put in the
  program's place: training, half of the batch left out with the loss's
  mean over the rest (a state left unchanged reads 1 by the measure and
  needs no run); inference, half of a request's answers left out and one
  answer altered; sampled cells, draws uniform over a parent's edges
  instead of weighted (``draw_weight_z``'s fault).

Prints one JSON object a seed and writes them all to ``--out``.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import drive as drive_lib  # noqa: E402
from benchmark.harness import judge  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402
from benchmark.harness.drive import sub_seed  # noqa: E402
from benchmark.harness.supervised import Supervised, build_graph  # noqa
from benchmark.reference import gnn as ref_gnn  # noqa: E402
from benchmark.reference.graph import (RefGraph, draw_check,  # noqa: E402
                                       sampled_hops)

CONTROL = torch.float8_e4m3fn


def uniform_draws(ref: RefGraph, parents: torch.Tensor, seed: int
                  ) -> torch.Tensor:
    """Children drawn uniformly over each parent's out-edges, ignoring the
    weights (-1 for parents without any)."""
    order = torch.argsort(ref.src)
    dst = ref.dst[order]
    ptr = torch.zeros(ref.n + 1, dtype=torch.long, device=dst.device)
    ptr[1:] = torch.cumsum(ref.out_deg, 0)
    p = parents.reshape(-1).long().clamp(0, ref.n - 1)
    gen = torch.Generator(device=dst.device).manual_seed(seed)
    u = torch.rand(p.shape, generator=gen, device=dst.device)
    deg = ref.out_deg[p]
    pick = ptr[p] + (u * deg).long().clamp_max((deg - 1).clamp_min(0))
    out = torch.where(deg > 0, dst[pick.clamp_max(dst.shape[0] - 1)], -1)
    return torch.where(parents.reshape(-1) >= 0, out, -1)


def fault_z(ref: judge.Reference, roots_list, n_id_list, seed: int) -> float:
    hops = []
    for roots, n_id in zip(roots_list, n_id_list):
        for parents, _ in sampled_hops(roots.to(ref.device),
                                       n_id.to(ref.device),
                                       ref.cfg["model"]["fanouts"]):
            hops.append((parents, uniform_draws(ref.graph, parents, seed)))
    return draw_check(ref.graph, hops)["draw_weight_z"]


def train_extra(ref: judge.Reference, rec: dict, seed: int) -> dict:
    base = ref.follow(rec)
    ctrl = ref.follow(rec, q=ref_gnn.round_trip(CONTROL))
    b = rec["roots"][0].shape[0]

    def first_half(roots):
        ok = roots >= 0
        ok[b // 2:] = False
        return ok
    half = ref.follow(rec, valid=first_half)
    out = {"control": judge.train_gaps(ctrl, base),
           "fault_half_batch": judge.train_gaps(half, base),
           "fault_state_unchanged": {"update_gap": 1.0}}
    if ref.sampled:
        out["fault_uniform_draws"] = {"draw_weight_z": fault_z(
            ref, rec["roots"], rec["n_id"], seed)}
    return out


def infer_extra(ref: judge.Reference, samples: list, seed: int) -> dict:
    def with_answers(fn):
        return [dict(s, answer=fn(s)) for s in samples]

    def control(s):
        return judge.reference_answer(
            ref, s, ref_gnn.round_trip(CONTROL)).cpu().numpy()

    def half(s):
        a = np.array(s["answer"], copy=True)
        a[len(a) // 2:] = 0
        return a

    def altered(s):
        a = np.array(s["answer"], copy=True)
        a[0, 0] += np.abs(a).max()
        return a
    out = {name: judge.check_infer(ref, with_answers(fn))
           for name, fn in (("control", control), ("fault_half_answers", half),
                            ("fault_answer_altered", altered))}
    batches = [b for s in samples for b in judge.request_batches(ref, s)]
    out["fault_uniform_draws"] = {"draw_weight_z": fault_z(
        ref, [r for r, _, _ in batches], [n for _, n, _ in batches], seed)}
    return out


def read(spec: Spec, workload: str, seeds, controls, device,
         window: float = 2.0, log=print) -> list:
    """One row of readings a seed (see the module's docstring)."""
    w = spec.workload(workload)
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    dev = torch.device(device)
    arrays, graph = build_graph(cfg, dev)
    ref_graph = RefGraph(arrays, cfg["graph"]["nodes"], dev)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        system = Supervised(cfg, seed, dev, graph)
        drv = drive_lib.make(spec, mix, system, seed)
        drv.setup()
        if mix["kind"] == "requests":
            drv.window(window)
        evidence = drv.evidence()
        weights0 = system.release()["weights0"]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = judge.Reference(cfg, arrays, seed, dev, weights0,
                              graph=ref_graph)
        if "steps" in evidence:
            row = {"seed": seed,
                   "program": judge.check_train(ref, evidence["steps"])}
        else:
            row = {"seed": seed,
                   "program": judge.check_infer(ref, evidence["answers"])}
        if seed in controls:
            if "answers" in evidence:
                row.update(infer_extra(ref, evidence["answers"],
                                       sub_seed(seed, "fault")))
            else:
                row.update(train_extra(ref, evidence["steps"],
                                       sub_seed(seed, "fault")))
        row["seconds"] = time.perf_counter() - t0
        log(json.dumps(row))
        rows.append(row)
        del system, drv, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--window", type=float, default=2.0,
                    help="seconds of requests a seed (inference cells)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = read(Spec(), args.workload,
                [int(s) for s in args.seeds.split(",") if s],
                {int(s) for s in args.control_seeds.split(",") if s},
                args.device, args.window,
                log=lambda line: print(line, flush=True))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
