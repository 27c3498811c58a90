"""Accuracy-parity harness: BASELINE.md's rows through the port's examples.

Counterpart of tools/parity_run.py. For every (model, dataset) row of
``TABLE`` (a copy of the reference's: the same run names, datasets,
reference values, metric keys and extra argv, the script path mapped to
its module under ``euler_tpu_torch.examples``) whose raw files are
present under the data root, train the example with
``train_and_evaluate`` and report the metric against the published
number. Rows without raw data are skipped, or with ``--allow-synthetic``
run on the dataset's synthetic stand-in, which proves the pipeline and
never gets a delta against the reference. A row that raises is recorded
as ``error`` and the sweep goes on; the CLI then exits 1.

    python -m euler_tpu_torch.tools.parity_run [--data_dir DIR]
        [--only SUBSTR] [--steps N] [--model_dir DIR] [--json OUT]
        [--allow-synthetic] [--device cpu]

Raw files, as the reference reads them:

    <data_root>/cora/cora.content + cora.cites
    <data_root>/pubmed/Pubmed-Diabetes.{NODE.paper,DIRECTED.cites}.tab
    <data_root>/citeseer/citeseer.content + citeseer.cites
    <data_root>/ppi/ppi-{G.json,feats.npy,id_map.json,class_map.json}
    <data_root>/reddit/reddit-{G.json,feats.npy,id_map.json,class_map.json}
    <data_root>/mutag/MUTAG_{A,graph_indicator,graph_labels,node_labels}.txt
    <data_root>/fb15k/{train,valid,test}.txt      (tab-separated triples)

Prints one line a run and a final JSON summary line, which ``--json``
(default ``build/euler_tpu_torch/parity_run.json``) also receives.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

from euler_tpu_torch._build import BUILD_DIR

# (run name, example script, extra argv, dataset, reference value,
#  metric key): reference values from BASELINE.md (examples/*/README.md)
TABLE = []


def _node_rows(model, script, refs, extra=()):
    for ds, ref in refs.items():
        TABLE.append((f"{model}_{ds}", script, list(extra), ds, ref, "f1"))


_node_rows("gcn", "gcn/run_gcn.py",
           {"cora": 0.822, "pubmed": 0.871, "citeseer": 0.752})
_node_rows("graphsage", "graphsage/run_graphsage.py",
           {"cora": 0.774, "pubmed": 0.884, "citeseer": 0.731})
_node_rows("gat", "gat/run_gat.py",
           {"cora": 0.823, "pubmed": 0.876, "citeseer": 0.755})
_node_rows("agnn", "agnn/run_agnn.py",
           {"cora": 0.813, "pubmed": 0.894, "citeseer": 0.719})
_node_rows("appnp", "appnp/run_appnp.py",
           {"cora": 0.813, "pubmed": 0.870, "citeseer": 0.723})
_node_rows("arma", "arma/run_arma.py",
           {"cora": 0.822, "pubmed": 0.880, "citeseer": 0.755})
_node_rows("adaptivegcn", "adaptivegcn/run_adaptivegcn.py",
           {"cora": 0.821, "pubmed": 0.859, "citeseer": 0.751})
_node_rows("fastgcn", "fastgcn/run_fastgcn.py",
           {"cora": 0.803, "pubmed": 0.860, "citeseer": 0.740})
_node_rows("sgcn", "sgcn/run_sgcn.py",
           {"cora": 0.825, "pubmed": 0.866, "citeseer": 0.716})
_node_rows("tagcn", "tagcn/run_tagcn.py",
           {"cora": 0.817, "pubmed": 0.867, "citeseer": 0.727})
_node_rows("dna", "dna/run_dna.py",
           {"cora": 0.811, "pubmed": 0.867, "citeseer": 0.710})
_node_rows("geniepath", "geniepath/run_geniepath.py",
           {"cora": 0.742, "pubmed": 0.872, "citeseer": 0.735})
_node_rows("lgcn", "lgcn/run_lgcn.py",
           {"cora": 0.641, "pubmed": 0.848, "citeseer": 0.675})
for ds, ref in {"cora": 0.905, "pubmed": 0.983, "citeseer": 0.976}.items():
    TABLE.append((f"deepwalk_{ds}", "deepwalk/run_deepwalk.py", [], ds,
                  ref, "mrr"))
for ds, ref in {"cora": 0.900, "pubmed": 0.987, "citeseer": 0.956}.items():
    TABLE.append((f"line_{ds}", "line/run_line.py", [], ds, ref, "mrr"))
for model, script, ref in (("gin", "gin/run_gin.py", 0.923),
                           ("gated_graph", "gated_graph/run_gated_graph.py",
                            0.920),
                           ("set2set", "set2set/run_set2set.py", 0.901),
                           ("graphgcn", "graphgcn/run_graphgcn.py", 0.891)):
    TABLE.append((f"{model}_mutag", script, [], "mutag", ref, "accuracy"))
for model in ("transe", "transh", "transr", "transd"):
    mr = {"transe": 197, "transh": 179, "transr": 191, "transd": 163}
    TABLE.append((f"{model}_fb15k", "TransX/run_transX.py",
                  ["--model", model, "--embedding_dim", "50",
                   "--margin", "0.5"], "fb15k", mr[model], "mr"))


def module_of(script: str) -> str:
    """The port's module of a reference example script path."""
    return "euler_tpu_torch.examples." + script[:-len(".py")].replace(
        "/", ".")


def _dataset_has_raw(name, data_dir):
    from euler_tpu_torch.datasets import get_dataset
    try:
        ds = get_dataset(name, data_dir)
    except KeyError:
        return False
    return bool(getattr(ds, "has_raw", lambda: False)())


def _run_example(script, argv):
    return importlib.import_module(module_of(script)).main(argv=argv)


def run_parity(data_dir=None, only=None, steps=0, model_dir=None,
               log=print, allow_synthetic=False, device=None):
    """One result dict a row of ``TABLE`` whose name holds ``only``:
    ``status`` "ran" (with ``delta``), "ran_synthetic" (``delta`` None),
    "skipped" or "error" (with ``reason``). ``device`` is the examples'
    ``--device`` (default: theirs, the card)."""
    results = []
    for name, script, extra, ds_name, ref, metric in TABLE:
        if only and only not in name:
            continue
        synthetic = not _dataset_has_raw(ds_name, data_dir)
        if synthetic and not allow_synthetic:
            results.append(dict(run=name, dataset=ds_name, status="skipped",
                                reason="raw data absent"))
            log(f"{name:24s} {ds_name:9s} SKIP (no raw data)")
            continue
        argv = list(extra) + [
            "--dataset", ds_name, "--run_mode", "train_and_evaluate",
            "--log_steps", "0"]
        if data_dir:
            argv += ["--data_dir", data_dir]
        if steps:
            argv += ["--total_steps", str(steps)]
        if model_dir:
            argv += ["--model_dir", os.path.join(model_dir, name)]
        if device:
            argv += ["--device", device]
        try:
            out = _run_example(script, argv)
            got = out.get(metric)
            # a synthetic stand-in proves the pipeline, not the number:
            # never report a delta against the reference for it
            delta = None if got is None or ref is None or synthetic \
                else float(got) - ref
            status = "ran_synthetic" if synthetic else "ran"
            tag = " (SYNTHETIC stand-in; no reference comparison)" \
                if synthetic else f"  ref={ref}  delta=" + str(
                    None if delta is None else round(delta, 4))
            log(f"{name:24s} {ds_name:9s} "
                f"{metric}={got if got is None else round(float(got), 4)}"
                f"{tag}")
            results.append(dict(run=name, dataset=ds_name, status=status,
                                metric=metric, value=got,
                                reference=None if synthetic else ref,
                                delta=delta))
        except Exception as e:   # a broken run must not kill the sweep
            log(f"{name:24s} {ds_name:9s} ERROR {e!r}")
            results.append(dict(run=name, dataset=ds_name, status="error",
                                reason=repr(e)))
    return results


def summarize(results) -> dict:
    ran = [r for r in results if r["status"].startswith("ran")]
    return dict(ran=len(ran),
                skipped=sum(r["status"] == "skipped" for r in results),
                errors=sum(r["status"] == "error" for r in results),
                results=results)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", default=None,
                   help="data root holding <dataset>/<raw files>")
    p.add_argument("--only", default=None,
                   help="substring filter on run names (e.g. gcn_cora)")
    p.add_argument("--steps", type=int, default=0,
                   help="override total_steps (0 = example default)")
    p.add_argument("--model_dir", default=os.path.join(BUILD_DIR,
                                                       "parity"))
    p.add_argument("--json", dest="json_out",
                   default=os.path.join(BUILD_DIR, "parity_run.json"))
    p.add_argument("--allow-synthetic", action="store_true",
                   help="run rows without raw data on their synthetic "
                        "stand-ins (pipeline smoke; results are NOT "
                        "compared to the reference)")
    p.add_argument("--device", default=None,
                   help="the examples' --device (default: cuda)")
    args = p.parse_args(argv)
    summary = summarize(run_parity(args.data_dir, args.only, args.steps,
                                   args.model_dir,
                                   allow_synthetic=args.allow_synthetic,
                                   device=args.device))
    print(json.dumps(summary, default=float))
    os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(summary, f, default=float)
    return summary


if __name__ == "__main__":
    sys.exit(1 if main()["errors"] else 0)
