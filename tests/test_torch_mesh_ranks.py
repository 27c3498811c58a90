"""One rank of the sharded tests' CPU mesh: a process over gloo.

The tests of tests/test_torch_sharded.py and tests/test_torch_cuda.py
write a work directory (``spec.json``, ``inputs.npz``, one directory of
shard files a graph, made by ``sharded.write_shards``) and start every
rank with ``launch``; each rank joins the mesh through a file store,
loads only its own shards, runs every case of the spec in order (the
collectives need one order on every rank) and writes its outputs to
``out_<rank>.npz``. It imports neither jax nor euler_tpu.

    python -m tests.test_torch_mesh_ranks WORK_DIR RANK
"""
import json
import os
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.models import GNNNet, ShallowEncoder, SuperviseModel
from euler_tpu_torch.ops import feature_ops, index as index_ops, sampling
from euler_tpu_torch.ops import walk as walk_ops
from euler_tpu_torch.parallel import comms, mesh as mesh_lib, sharded, train
from euler_tpu_torch.query import Query


def sage_model(feat_dim: int, label_dim: int, fanouts, dims, seed: int,
               device="cpu") -> SuperviseModel:
    """The sage model of the apply cases: bench.make_model("sage")'s
    layout at the given widths, its weights from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    flow = SageDataFlow(list(fanouts), [(0,)] * len(fanouts))
    net = GNNNet("sage", flow, tuple(dims), ShallowEncoder(("feature",)),
                 in_dim=feat_dim, device=device, generator=gen)
    return SuperviseModel(net, "label", label_dim, device=device,
                          generator=gen)


def apply_inputs(g, data: int, graph: int, roots_per_rank: int, opts: dict,
                 seed: int):
    """The apply case's inputs for a ``data`` x ``graph`` mesh over the
    one-device graph ``g``: every rank's batch, and per hop its group's
    U_all (the concatenation, in member order, of the uniforms each
    member's one-device forward of its own roots draws); and that
    forward's outputs for each rank, in rank order."""
    W = data * graph
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, g.meta.n_nodes, W * roots_per_rank).astype(
        np.int32)
    model = sage_model(**opts, device=g.device)
    flow = model.embedder.flow
    gen = torch.Generator(device=g.device).manual_seed(seed)
    per_rank, want = [], []
    for r in range(W):
        roots = torch.from_numpy(
            batch[r * roots_per_rank:(r + 1) * roots_per_rank]).to(g.device)
        # hop i draws for the roots, then each hop's targets and draws
        # (fanout_block's n_id)
        hops, rows = [], roots_per_rank
        for ets, cnt in zip(flow.metapath, flow.fanouts):
            hops.append(flow.draw_hop(g, ets, gen, rows, cnt, g.device))
            rows *= cnt + 1
        per_rank.append(hops)
        with torch.no_grad():
            want.append(model(g, roots, uniforms=hops))
    arrays = {"batch": np.stack([batch] * W)}
    for hop in range(len(flow.fanouts)):
        for i in range(len(per_rank[0][hop])):
            arrays[f"h{hop}_u{i}"] = np.stack([
                torch.cat([per_rank[m][hop][i]
                           for m in range(r // graph * graph,
                                          (r // graph + 1) * graph)])
                .cpu().numpy() for r in range(W)])
    return arrays, want


def write_work(work: str, data: int, graph: int, shards: dict, arrays: dict,
               cases: list, timeout_s: float, device: str = "cpu",
               backend: str = "gloo") -> None:
    """The work directory of one start of the ranks: each sharded graph's
    files (``shards``: name -> ShardedGraphTensors), the spec and the
    inputs."""
    for name, sg in shards.items():
        sharded.write_shards(sg, os.path.join(work, name))
    spec = dict(data=data, graph=graph, timeout=timeout_s, device=device,
                backend=backend, graphs=sorted(shards), cases=cases)
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(work, "inputs.npz"), **arrays)


def _uniforms(a, prefix="u"):
    return tuple(a[f"{prefix}{i}"] for i in range(4) if f"{prefix}{i}" in a)


def _apply(view, a, o, mesh):
    """The sharded sage apply of ``a["batch"]`` from the owners' uniforms;
    the weights are ``a``'s ``p/<name>`` arrays where it holds them (the
    reference's, carried across), else drawn from ``o["seed"]``."""
    model = sage_model(o["feat_dim"], o["label_dim"], o["fanouts"],
                       o["dims"], o["seed"], view.device)
    state = {k[2:]: v for k, v in a.items() if k.startswith("p/")}
    if state:
        model.load_state_dict(state)
    hops = [_uniforms(a, f"h{h}_u") for h in range(len(o["fanouts"]))]
    out = train.make_sharded_apply(model, mesh)(view, a["batch"],
                                                uniforms=hops)
    return [out[k] for k in ("embedding", "logit", "label", "loss")]


def _comms(view, a, o, mesh):
    """Each collective over the graph group, and the accounting of one
    all_to_all."""
    g = view.group
    x = a["x"]
    with comms.account() as acc:
        a2a = comms.all_to_all(x, g)
    return (comms.all_gather(x, g), a2a, comms.psum(x, g),
            comms.pmean(x.to(torch.float32), g),
            torch.tensor([acc.totals()["all_to_all"]]))


def _query(view, a, o, mesh):
    q = (Query(view).v(a["nodes"]).sampleNB(tuple(o["ets"]), o["count"])
         .alias("nb").values(o["feature"]).alias("f"))
    res = q.run(uniforms=[_uniforms(a)])
    return res["nb"].ids, res["f"]


#: verb name -> fn(view, arrays, opts, mesh); each mirrors one reference
#: call of the test module
VERBS = {
    "fast": lambda v, a, o, m: sampling.select_neighbors(
        v, a["nodes"], tuple(o["ets"]), _uniforms(a),
        return_types=o.get("types", False)),
    "payload": lambda v, a, o, m: sampling.select_sampled_neighbors(
        v, a["nodes"], tuple(o["ets"]), *_uniforms(a)),
    "in_payload": lambda v, a, o, m: sampling.select_in_neighbors(
        v, a["nodes"], tuple(o["ets"]), *_uniforms(a)),
    "dense": lambda v, a, o, m: feature_ops.get_dense_feature(
        v, a["nodes"], o["names"]),
    "sparse": lambda v, a, o, m: feature_ops.get_sparse_feature(
        v, a["nodes"], o["names"]),
    "node_type": lambda v, a, o, m: sampling.get_node_type(v, a["nodes"]),
    "edge": lambda v, a, o, m: (
        feature_ops.get_edge_dense_feature(v, a["eids"], o["dense"]),
        feature_ops.get_edge_sparse_feature(v, a["eids"], o["sparse"]),
        feature_ops.get_edge_type(v, a["eids"])),
    "full": lambda v, a, o, m: sampling.get_full_neighbor(
        v, a["nodes"], tuple(o["ets"]), o["cap"],
        sorted_by_id=o["sorted"], offset=o.get("offset", 0)),
    "full_in": lambda v, a, o, m: sampling.get_full_in_neighbor(
        v, a["nodes"], tuple(o["ets"]), o["cap"], sorted_by_id=o["sorted"]),
    "top_k": lambda v, a, o, m: sampling.get_top_k_neighbor(
        v, a["nodes"], tuple(o["ets"]), o["k"]),
    "adj": lambda v, a, o, m: sampling.sparse_get_adj(
        v, a["nodes"], a["nb"], tuple(o["ets"])),
    "is_nb": lambda v, a, o, m: walk_ops._is_neighbor(
        v, a["src"], tuple(o["ets"]), a["cand"]),
    "nodes": lambda v, a, o, m: sampling.select_nodes(
        v, o["type"], *_uniforms(a)),
    "edges": lambda v, a, o, m: sampling.select_edges(
        v, o["type"], *_uniforms(a)),
    "with_src": lambda v, a, o, m: sampling.select_nodes_with_src(
        v, a["src"], *_uniforms(a)),
    "condition": lambda v, a, o, m: index_ops.select_node_with_condition(
        v, [[index_ops.Pred(*p) for p in c] for c in o["dnf"]], -1,
        _uniforms(a)),
    "index_ids": lambda v, a, o, m: index_ops.query_index_ids(
        v, [[index_ops.Pred(*p) for p in c] for c in o["dnf"]], o["cap"]),
    "query": _query,
    "comms": _comms,
    "apply": _apply,
}


def flatten(x) -> List[torch.Tensor]:
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in flatten(y)]
    return [x]


def run(work: str, rank: int) -> None:
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    dev = spec["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
        dev = "cuda:0"
    mesh = mesh_lib.make_mesh(
        spec["data"], spec["graph"], backend=spec["backend"], device=dev,
        init_method="file://" + os.path.join(work, "rendezvous"),
        rank=rank, timeout_s=spec["timeout"])
    views = {name: sharded.load_shard(os.path.join(work, name),
                                      mesh.graph_index, mesh.device, mesh)
             for name in spec["graphs"]}
    out: Dict[str, np.ndarray] = {}
    with np.load(os.path.join(work, "inputs.npz")) as inputs:
        for case in spec["cases"]:
            pre = case["name"] + "/"
            arrays = {k[len(pre):]: torch.from_numpy(inputs[k][rank]).to(
                mesh.device) for k in inputs.files if k.startswith(pre)}
            sharded.set_owner_compute(case.get("owner_compute"))
            try:
                res = VERBS[case["verb"]](views[case["graph"]], arrays,
                                          case.get("opts", {}), mesh)
            finally:
                sharded.set_owner_compute(None)
            for i, t in enumerate(flatten(res)):
                out[f"{pre}{i}"] = t.cpu().numpy()
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
    mesh_lib.close()


def launch(work: str, world: int, timeout_s: float) -> List[dict]:
    """Start ``world`` ranks on this machine, wait for all (killing every
    rank at ``timeout_s``) and return each rank's outputs; raises with a
    failed rank's errors."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_mesh_ranks", work, str(r)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    errs = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                errs.append(f"rank {r}: timed out after {timeout_s} s")
                break
            if p.returncode != 0:
                errs.append(f"rank {r}: exit {p.returncode}\n"
                            + err.decode()[-4000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        raise RuntimeError("\n".join(errs))
    outs = []
    for r in range(world):
        with np.load(os.path.join(work, f"out_{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs


if __name__ == "__main__":
    run(sys.argv[1], int(sys.argv[2]))
