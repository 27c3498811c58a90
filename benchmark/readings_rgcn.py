"""The readings that the ``rgcn-train`` cell's correctness limits are set
from (``benchmark/readings.py``'s counterpart for the ``rgcn``
configuration). The benchmark's own runs never run this.

    python3 benchmark/readings_rgcn.py --seeds 1,2,...,12 \\
        --control-seeds 1,2,3 [--workload rgcn-train] [--out FILE]

In one process (the graph is built once): for every seed of ``--seeds``
the program runs as a run of the cell does (set-up with its first steps
through the window's own call), and its numbers against the reference
are its lower readings. For every seed of ``--control-seeds`` it also
reads, each put in the program's place against the sound reference:

- ``control``: the reference with its activations in float8 (e4m3), the
  precision below the bfloat16 the configuration states;
- the planted faults (``FAULTS``): Euler's mean over all relations in
  place of the per-relation mean, one relation's messages dropped (the
  papers' authors, ``writes``), one root linear shared by every node
  type, the embedding tables frozen; a state left unchanged reads 1 by
  ``update_gap`` and needs no run.

Prints one JSON object a seed and writes them all to ``--out``.
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark.harness import drive as drive_lib  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402
from benchmark.reference import gnn as ref_gnn  # noqa: E402
from benchmark.reference.rgcn import RelGraph  # noqa: E402

CONTROL = torch.float8_e4m3fn
#: relation 2 is ``writes`` (the papers' authors) in the example's order
FAULTS = {"fault_all_relation_mean": {"all_relation_mean": True},
          "fault_writes_dropped": {"drop_relation": 2},
          "fault_shared_root": {"shared_root": True},
          "fault_tables_frozen": {"frozen_tables": True}}


def leaves(ref, rec: dict, module) -> dict:
    """Per leaf, the program against the reference: the reference
    gradient's norm over the median leaf's, 1 - cos of the gradients and
    the norm gap over the leaf's own norm."""
    base = ref.follow(rec)
    g = module.per_leaf(rec["grad1"], ref.cfg)
    norms = {k: float(v.double().norm()) for k, v in base["grad1"].items()}
    med = statistics.median(norms.values())
    rows = {}
    for k, v in base["grad1"].items():
        a, b = g[k].double().reshape(-1).cpu(), v.double().reshape(-1).cpu()
        den = float(a.norm() * b.norm())
        rows[k] = [norms[k] / med, 1 - float(a @ b) / den if den else 0.0,
                   abs(float(a.norm()) - norms[k]) / max(norms[k], 1e-30)]
    return rows


def extra(ref, rec: dict, module) -> dict:
    """The control's and each fault's numbers against the sound
    reference's steps (the configuration's ``train_gaps``)."""
    base = ref.follow(rec)
    out = {"control": module.train_gaps(
        ref.follow(rec, q=ref_gnn.round_trip(CONTROL)), base)}
    for name, fault in FAULTS.items():
        ref.fault = fault
        try:
            out[name] = module.train_gaps(ref.follow(rec), base)
        finally:
            ref.fault = {}
    out["fault_state_unchanged"] = {"update_gap": 1.0}
    return out


def read(spec: Spec, workload: str, seeds, controls, device,
         log=print) -> list:
    """One row of readings a seed (see the module's docstring)."""
    w = spec.workload(workload)
    cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
    module = spec.config_module(w["config"])
    dev = torch.device(device)
    arrays = module.graph_arrays(cfg["graph"])
    graph = module.program_graph(cfg, arrays, dev)
    ref_graph = RelGraph(arrays["src"], arrays["dst"], arrays["etype"],
                         module.type_lo(cfg["graph"])[-1],
                         len(module.relations(cfg["graph"])), dev)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        system = module.Rgcn(cfg, seed, dev, graph)
        drv = drive_lib.make(spec, mix, system, seed)
        drv.setup()
        rec = drv.evidence()["steps"]
        weights0 = system.release()["weights0"]
        del system, drv
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = module.RgcnReference(cfg, arrays, seed, dev, weights0,
                                   graph=ref_graph)
        row = {"seed": seed, "program": module.check_train(ref, rec),
               "leaves": leaves(ref, rec, module)}
        if seed in controls:
            row.update(extra(ref, rec, module))
        row["seconds"] = time.perf_counter() - t0
        log(json.dumps(row))
        rows.append(row)
        del ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="rgcn-train")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = read(Spec(), args.workload,
                [int(s) for s in args.seeds.split(",") if s],
                {int(s) for s in args.control_seeds.split(",") if s},
                args.device, log=lambda line: print(line, flush=True))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
