"""One rank of the sharded tests' CPU mesh: a process over gloo.

The tests of tests/test_torch_sharded.py, tests/test_torch_sharded_*.py,
tests/test_torch_spmd.py and tests/test_torch_cuda.py write a work
directory (``spec.json``, ``inputs.npz``, one directory of
shard files a graph, made by ``sharded.write_shards``) and start every
rank with ``launch``; each rank joins the mesh through a file store,
loads only its own shards, runs every case of the spec in order (the
collectives need one order on every rank) and writes its outputs to
``out_<rank>.npz``. It imports neither jax nor euler_tpu.

    python -m tests.test_torch_mesh_ranks WORK_DIR RANK
"""
import contextlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from euler_tpu_torch.dataflow import SageDataFlow, WholeDataFlow
from euler_tpu_torch.estimator import (RunConfig, SpmdEdgeEstimator,
                                       SpmdGraphEstimator, SpmdNodeEstimator,
                                       get_optimizer, make_graph_batch)
from euler_tpu_torch.models import (DeepWalk, GNNNet, GraphModel,
                                    ScalableGNNNet, SegmentPool,
                                    ShallowEncoder, ShardedEmbedding,
                                    SuperviseModel, TransE, load_flax_params)
from euler_tpu_torch.ops import feature_ops, index as index_ops, sampling
from euler_tpu_torch.ops import walk as walk_ops
from euler_tpu_torch.parallel import (comms, distributed, mesh as mesh_lib,
                                      sharded, train)
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


def build_model(o: dict, device="cpu") -> torch.nn.Module:
    """The model of a train case, by ``o["model"]``, its weights from
    ``o["seed"]`` (a case carries the reference's in ``p/<name>``)."""
    kind = o.get("model", "sage")
    if kind == "sage":
        return sage_model(o["feat_dim"], o["label_dim"], o["fanouts"],
                          o["dims"], o["seed"], device)
    gen = torch.Generator().manual_seed(o["seed"])
    feat = ShallowEncoder(("feature",))
    if kind == "transe":
        return TransE(o["n"], o["r"], o["dim"], o["dim"],
                      num_negs=o["num_negs"], shard_embeddings=True,
                      device=device, generator=gen)
    if kind == "deepwalk":
        return DeepWalk(o["n"], o["dim"], (0,), walk_len=o["walk_len"],
                        num_negs=o["num_negs"], shard_embeddings=True,
                        device=device, generator=gen)
    if kind == "scalable":
        net = ScalableGNNNet((0,), 2, o["dim"], feat, o["feat_dim"], o["n"],
                             fanout=o["fanout"], device=device,
                             generator=gen)
        return SuperviseModel(net, "label", o["label_dim"], device=device,
                              generator=gen)
    if kind == "gcn":
        net = GNNNet("gcn", WholeDataFlow(2, [(0,)] * 2), (o["dim"],) * 3,
                     feat, o["feat_dim"], device=device, generator=gen)
        return SuperviseModel(net, "label", o["label_dim"], device=device,
                              generator=gen)
    if kind == "graph":
        net = GNNNet("gin", SageDataFlow(o["fanouts"], [(0,)]),
                     (o["dim"],) * 2, feat, o["feat_dim"], device=device,
                     generator=gen)
        return GraphModel(net, SegmentPool(o["dim"], o["b"], "mean"),
                          o["n_classes"], device=device, generator=gen)
    raise ValueError(kind)


def nest(a: dict, spec, prefix: str = ""):
    """The nested uniforms that ``spec`` (lists of array names) names."""
    if spec is None:
        return None
    if isinstance(spec, str):
        return a[prefix + spec]
    return [nest(a, x, prefix) for x in spec]


def _expand(o):
    if o.get("model") != "graph":
        return None
    return lambda v, gidx: make_graph_batch(v, gidx, "label",
                                            o["n_classes"])


class GradRecorder(torch.optim.Optimizer):
    """An optimizer whose step keeps each parameter's gradient (after
    the sync) and changes nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = []

    def step(self, closure=None):
        self.grads = [p.grad.detach().clone()
                      for grp in self.param_groups for p in grp["params"]]


def _model_for(view, a, o, mesh):
    model = build_model(o, view.device)
    train.init_sharded_params(model, mesh, seed=o["seed"])
    state = {k[2:]: v for k, v in a.items() if k.startswith("p/")}
    if state:
        model.load_state_dict(state)
    return model


def _state_out(model) -> List[torch.Tensor]:
    """A copy of the state dict's tensors, in sorted names."""
    state = model.state_dict()
    return [state[k].clone() for k in sorted(state)]


def _train(view, a, o, mesh):
    """``o["steps"]`` Adam steps of ``make_sharded_train_step`` from the
    given ids (``t<i>/ids``, the graph group's draw) and uniforms (the
    owner's, named by ``o["u_spec"]``): each step's loss, then the
    state dict in sorted names."""
    model = _model_for(view, a, o, mesh)
    opt = get_optimizer("adam", o["lr"], model.parameters())
    step = train.make_sharded_train_step(model, opt, mesh, o["b"],
                                         expand_fn=_expand(o))
    losses = [step(view, ids=a[f"t{t}/ids"],
                   uniforms=nest(a, o["u_spec"], f"t{t}/"))
              for t in range(o["steps"])]
    return losses + _state_out(model)


def _grads(view, a, o, mesh):
    """One step's synced gradients (``GradRecorder``), in parameter
    order, and the loss."""
    model = _model_for(view, a, o, mesh)
    opt = GradRecorder(model.parameters())
    step = train.make_sharded_train_step(model, opt, mesh, o["b"],
                                         expand_fn=_expand(o))
    loss = step(view, ids=a["t0/ids"], uniforms=nest(a, o["u_spec"], "t0/"))
    return [loss] + opt.grads


def _emb_grad(view, a, o, mesh):
    """A ShardedEmbedding over the mesh: its lookup of ``ids`` and the
    synced gradient of its block under sum(w * rows), pmean'd."""
    mod = ShardedEmbedding(o["num"], o["dim"], device=view.device)
    train.init_sharded_params(mod, mesh)
    load_flax_params(mod, {"embedding": a["table"].numpy()})
    out = mod(view, a["ids"])
    loss = comms.pmean((out * a["w"]).sum(), mesh.world_group)
    loss.backward()
    train._sync_grads(mod, mesh)
    return out, mod.embedding.grad


def _comms_grad(view, a, o, mesh):
    """Each differentiable collective's backward: the gradient of
    sum(c * f(x)) for f in all_gather, all_to_all, psum and pmean over
    the graph group; then whether pmax refuses a tensor that needs a
    gradient."""
    g = view.group
    fns = [(comms.all_gather, a["c_ag"]), (comms.all_to_all, a["c"]),
           (comms.psum, a["c"]), (comms.pmean, a["c"])]
    out = []
    with comms.account() as acc:
        for f, c in fns:
            x = a["x"].clone().requires_grad_(True)
            (f(x, g) * c).sum().backward()
            out.append(x.grad)
    out.append(torch.tensor([acc.totals("forward")["total"],
                             acc.totals("backward")["total"]]))
    try:
        comms.pmax(a["x"].clone().requires_grad_(True), g)
        refused = 0
    except RuntimeError:
        refused = 1
    out.append(comms.pmax(a["x"], g))
    return out + [torch.tensor([refused])]


def _psum_block(view, a, o, mesh):
    """The shard's whole-graph block over node features ``x`` [N, d]:
    its max aggregate and a softmax-weighted sum (scores x . w), each
    completed over the graph group, without autograd; then whether the
    max aggregate refuses ``x`` that needs a gradient (pmax has no
    derivative)."""
    from euler_tpu_torch.dataflow.flows import full_graph_block_sharded
    blk = full_graph_block_sharded(view, (0,), True)
    x = a["x"]
    with torch.no_grad():
        mx = blk.aggregate_neighbors("max", x, blk.mask)
        xj = blk.gather_src(x)
        p = blk.softmax((xj * a["w"]).sum(-1), blk.mask)
        att = blk.scatter("add", p[:, None] * xj, blk.mask)
    try:
        blk.aggregate_neighbors("max", x.clone().requires_grad_(True),
                                blk.mask)
        refused = 0
    except RuntimeError:
        refused = 1
    return mx, att, torch.tensor([refused])


def _estimator(view, a, o, mesh):
    """The Spmd estimator surface: train (loops, a refresh, saves),
    evaluate with pad rows, infer, then a second estimator that restores
    the checkpoint."""
    model = build_model(o, view.device)
    cls = {"node": SpmdNodeEstimator, "edge": SpmdEdgeEstimator,
           "graph": SpmdGraphEstimator}[o["kind"]]
    kw = dict(num_classes=o["n_classes"]) if o["kind"] == "graph" else {}
    cfg = RunConfig(batch_size=o["batch"], total_steps=o["total"],
                    learning_rate=0.05, log_steps=0, metric=o["metric"],
                    steps_per_loop=o.get("spl", 1),
                    reservoir_refresh=o.get("refresh", 0),
                    save_steps=o.get("save", 0), model_dir=o["model_dir"])
    est = cls(model, view, cfg, mesh=mesh, **kw)
    before = _state_out(model)
    res = est.train()
    after = _state_out(model)
    ev = est.evaluate(a["eval_ids"])
    few = est.evaluate(a["eval_ids"][:o["few"]])
    emb = est.infer(a["infer_ids"], out_dir=o.get("infer_dir"))
    ranking = (est.evaluate_ranking(a["eval_ids"])["mr"]
               if o["kind"] == "edge" else 0.0)
    est2 = cls(build_model(o, view.device), view, cfg, mesh=mesh, **kw)
    est2._restore()
    restored = _state_out(est2.model)
    keys = sorted(est.model.state_dict())
    specs = est.pspecs
    sharded_names = [k for k in keys if specs.get(k) == "graph"]
    return ([torch.tensor([res["loss"], ev["loss"], few["loss"],
                           ev[o["metric"]], len(sharded_names), ranking],
                          dtype=torch.float64), torch.from_numpy(emb)]
            + before + after + restored)


def _load(view, a, o, mesh):
    """``load_graph_sharded`` of the partition files under
    ``o["path"]`` (this rank's shard only) and a health check."""
    got = distributed.load_graph_sharded(o["path"], mesh)
    hc = distributed.health_check(mesh, timeout_s=60)
    loc = got.local
    return [loc.node_type, loc.group_ptr, loc.adj_dst, loc.adj_w,
            got.eid_sorted, got.shard_node_w, got.shard_edge_w,
            torch.tensor([hc["ok"], hc["devices"],
                          hc["latency_s"] is not None])] + [
        loc.dense_nf[k] for k in sorted(loc.dense_nf)]


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
    "train": _train,
    "grads": _grads,
    "emb_grad": _emb_grad,
    "comms_grad": _comms_grad,
    "psum_block": _psum_block,
    "estimator": _estimator,
    "load": _load,
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
    views[None] = next(iter(views.values()), None)
    out: Dict[str, np.ndarray] = {}
    with np.load(os.path.join(work, "inputs.npz")) as inputs:
        for case in spec["cases"]:
            pre = case["name"] + "/"
            arrays = {k[len(pre):]: torch.from_numpy(inputs[k][rank]).to(
                mesh.device) for k in inputs.files if k.startswith(pre)}
            sharded.set_owner_compute(case.get("owner_compute"))
            try:
                res = VERBS[case["verb"]](views[case.get("graph")], arrays,
                                          case.get("opts", {}), mesh)
            finally:
                sharded.set_owner_compute(None)
            for i, t in enumerate(flatten(res)):
                out[f"{pre}{i}"] = t.detach().cpu().numpy()
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
    mesh_lib.close()


@contextlib.contextmanager
def one_rank_mesh(work: str):
    """A one-rank gloo mesh in this process (a file rendezvous under
    ``work``), left at the end."""
    mesh = mesh_lib.make_mesh(
        1, 1, device="cpu", init_method="file://" + os.path.join(
            work, "rendezvous"), rank=0, timeout_s=60)
    try:
        yield mesh
    finally:
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
