"""The sharded paths of the models over a CPU mesh of 4 gloo ranks
(``data=1, graph=4``), against euler_tpu's ``make_sharded_train_step``
on the 8-device virtual CPU mesh: TransE and DeepWalk with
``shard_embeddings=True`` (their tables split over the graph axis), a
graph classifier (gin, ``make_graph_batch`` as the expand hook), the
scalable cache (stores split over the graph axis, written over the whole
mesh) and gcn over whole-graph blocks completed with ``psum``.

Each case runs two Adam steps from the reference's initial weights (a
graph-sharded table gives each rank its block); the batch source is a
uniform draw from the step key, so the test gives each graph group its
ids, and each owner's uniforms are derived from the keys its rank's
model hands the sampling verbs (recorded from a one-device ``init``
with the rank's sample key): the cooperative node draw's as
tests/test_torch_sharded.py's ``coop_u``, a neighbor draw's over the
spread rows. Each step's loss and every parameter and store block must
equal the reference's within 1e-5 (tests/test_torch_estimators_rest.py's
tolerance). Beside them, a whole-graph block's max aggregate and
softmax equal the one-device block's, and the max refuses autograd.
"""
import contextlib
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euler_tpu.ops.sampling as jax_sampling_mod
import euler_tpu.ops.walk as jax_walk_mod
from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.datasets.synthetic import MotifDataset
from euler_tpu.estimator.estimator import get_optimizer as jax_optimizer
from euler_tpu.estimator.estimator import make_graph_batch as jax_graph_batch
from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu.models import graph_model as jax_graph_model
from euler_tpu.models import kg as jax_kg
from euler_tpu.models import pooling as jax_pooling
from euler_tpu.models import scalable as jax_scalable
from euler_tpu.models import walk_models as jax_walk_models
from euler_tpu.parallel import mesh as jax_mesh
from euler_tpu.parallel import sharded as jax_sharded
from euler_tpu.parallel import train as jax_train
from euler_tpu_torch.dataflow.block import full_graph_block
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import load_flax_params
from euler_tpu_torch.ops import walk as walk_ops
from euler_tpu_torch.parallel import sharded, train
from tests import test_torch_mesh_ranks as ranks
from tests.test_torch_graph import native_off
from tests.test_torch_sharded import coop_u, fan_u, typed_u

S = 4
B = 4                      # roots (graphs) a rank
LR = 0.05
STEPS = 2
TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT_S = 240
FEAT, LABELS, DIM = 8, 3, 8
WALK_LEN, NEGS = 2, 3


def uniform_ids(high: int, cols: int = 0):
    """A batch source of ids uniform in [0, high) from the key; with
    ``cols`` > 0, [count, 3] (src, dst, relation < cols) triples."""
    def ids_fn(view, key, count):
        if not cols:
            return jax.random.randint(key, (count,), 0, high, jnp.int32)
        k1, k2 = jax.random.split(key)
        nodes = jax.random.randint(k1, (count, 2), 0, high, jnp.int32)
        rel = jax.random.randint(k2, (count, 1), 0, cols, jnp.int32)
        return jnp.concatenate([nodes, rel], axis=1)
    return ids_fn


@contextlib.contextmanager
def recording(*targets):
    """Record the key each ``(module, name)`` function is called with, in
    call order, as (name, key)."""
    seen, saved = [], []
    for mod, name in targets:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def rec(g, key, *a, _fn=fn, _name=name, **kw):
            seen.append((_name, key))
            return _fn(g, key, *a, **kw)
        setattr(mod, name, rec)
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def graphs():
    """(reference, port) random graphs of the node and kg cases, and of
    the graph classifier, with the ``fan`` pack and the numpy CSR sort."""
    kw = dict(feat_dim=FEAT, n_classes=LABELS, seed=4)
    with native_off(("build_csr_native",)):
        return (jax_random_graph(120, 5, packs=("fan",), num_edge_types=2,
                                 **kw),
                random_graph(120, 5, device="cpu", num_edge_types=2, **kw))


def motif_graphs(tmp_path_factory):
    ds = MotifDataset(str(tmp_path_factory.mktemp("motif_mesh")),
                      n_graphs=16, seed=2)
    ds.load_graph()                        # converts on first use
    with native_off(("build_csr_native",)):
        gj = jax_load_graph(ds.data_dir, packs=("fan",))
        return gj, load_graph(ds.data_dir, packs=("fan",), device="cpu")


def ref_models(gj):
    """Each case's reference model, its port options, batch source,
    expand hook and the recorded functions."""
    N, R = gj.meta.n_nodes, gj.meta.num_edge_types
    feat = jax_encoders.ShallowEncoder(dense_names=("feature",))
    base = dict(seed=0, n=N, r=R, dim=DIM, num_negs=NEGS, feat_dim=FEAT,
                label_dim=LABELS, walk_len=WALK_LEN, fanout=3)
    return {
        "transe": (jax_kg.TransE(n_entities=N, n_relations=R, ent_dim=DIM,
                                 rel_dim=DIM, num_negs=NEGS,
                                 shard_embeddings=True),
                   dict(base, model="transe"), uniform_ids(N, R), None,
                   [(jax_sampling_mod, "sample_node")]),
        "deepwalk": (jax_walk_models.DeepWalk(
            n_nodes=N, dim=DIM, edge_types=(0,), walk_len=WALK_LEN,
            num_negs=NEGS, shard_embeddings=True),
            dict(base, model="deepwalk"), uniform_ids(N), None,
            [(jax_walk_mod, "random_walk"),
             (jax_sampling_mod, "sample_node")]),
        "scalable": (jax_gnn.SuperviseModel(
            embedder=jax_scalable.ScalableGNNNet(
                edge_types=(0,), num_layers=2, dim=DIM, feature=feat,
                n_nodes=N, fanout=3),
            label_name="label", label_dim=LABELS),
            dict(base, model="scalable"), uniform_ids(N), None,
            [(jax_sampling_mod, "sample_neighbor")]),
        "gcn": (jax_gnn.SuperviseModel(
            embedder=jax_gnn.GNNNet(
                conv="gcn", flow=jax_flows.WholeDataFlow(2, [(0,)] * 2),
                dims=(DIM,) * 3, feature=feat),
            label_name="label", label_dim=LABELS),
            dict(base, model="gcn"), uniform_ids(N), None, []),
    }


def graph_model_case(gj):
    feat = jax_encoders.ShallowEncoder(dense_names=("feature",))
    model = jax_graph_model.GraphModel(
        embedder=jax_gnn.GNNNet(conv="gin",
                                flow=jax_flows.SageDataFlow([3], [(0,)]),
                                dims=(DIM, DIM), feature=feat),
        pool=jax_pooling.SegmentPool(aggr="mean", num_graphs=B),
        label_dim=2)
    opts = dict(model="graph", seed=0, dim=DIM, feat_dim=4, fanouts=[3],
                b=B, n_classes=2)
    return (model, opts, uniform_ids(gj.tensors.graph_members.shape[0]),
            lambda view, gidx: jax_graph_batch(view, gidx, "label", 2),
            [(jax_sampling_mod, "sample_neighbor_fast")])


def owner_uniforms(kind, seen, rows):
    """The owner's uniforms of one rank from the keys its model handed
    the verbs, named as the case's ``u_spec`` reads them; the node draws'
    keys apart (their uniforms come from every member's keys)."""
    u, node_keys = {}, []
    for name, key in seen:
        if name == "sample_node":
            node_keys.append(key)
        elif name == "random_walk":
            kw = key
            for s in range(WALK_LEN):
                kw, sub = jax.random.split(kw)
                for i, x in enumerate(typed_u(sub, S * rows, 1)):
                    u[f"w{s}_u{i}"] = x
        elif name == "sample_neighbor":
            for i, x in enumerate(typed_u(key, S * rows, 3)):
                u[f"s_u{i}"] = x
        elif name == "sample_neighbor_fast":
            for i, x in enumerate(fan_u(key, S * rows, 3)):
                u[f"h0_u{i}"] = x
    return u, node_keys


U_SPECS = {
    "transe": [f"n_u{i}" for i in range(4)],
    "deepwalk": [[[f"w{s}_u{i}" for i in range(3)] for s in range(WALK_LEN)],
                 [f"n_u{i}" for i in range(4)]],
    "scalable": [f"s_u{i}" for i in range(3)],
    "gcn": None,
    "graph": [[f"h0_u{i}" for i in range(2)]],
}


def neg_count(kind):
    if kind == "transe":
        return B * NEGS
    return B * walk_ops.pair_count(WALK_LEN + 1, 1, 1) * NEGS


def rank_states(opts, variables):
    """The port's state dict of each rank (sorted names) after loading
    the unboxed reference ``variables`` into its layout over the mesh."""
    out = []
    for gi in range(S):
        model = ranks.build_model(opts)
        train.init_sharded_params(
            model, types.SimpleNamespace(graph=S, graph_index=gi),
            seed=opts["seed"])
        load_flax_params(model, variables)
        state = model.state_dict()
        out.append([state[k].numpy() for k in sorted(state)])
    return out


def ref_case(kind, model, opts, ids_fn, expand_fn, targets, gj, seed):
    """The reference's two sharded Adam steps, and the ranks' arrays."""
    mesh = jax_mesh.make_mesh(data=1, graph=S)
    sg = jax_sharded.build_sharded(gj, S)
    with mesh:
        variables = dict(jax_train.init_sharded_params(
            model, sg, mesh, B, seed=seed, ids_fn=ids_fn,
            expand_fn=expand_fn))
    unboxed = jax.tree.map(np.asarray, nn.meta.unbox(variables))
    arrays = {}
    for name, states in (("p", rank_states(opts, unboxed)),):
        keys_ = sorted(ranks.build_model(opts).state_dict())
        for i, k in enumerate(keys_):
            arrays[f"{name}/{k}"] = np.stack([st[i] for st in states])
    specs = jax_train.param_specs(variables)
    mut = [k for k in variables if k != "params"]
    if mut:
        params = variables.pop("params")
        state, ps = variables, specs["params"]
        ss = {k: v for k, v in specs.items() if k != "params"}
    else:
        params, state, ps, ss = variables, {}, specs, None
    tx = jax_optimizer("adam", LR)
    step = jax_train.make_sharded_train_step(
        model, sg, tx, mesh, B, ids_fn=ids_fn, expand_fn=expand_fn,
        pspecs=ps, mutable=mut, sspecs=ss)
    keys = jax.random.split(jax.random.PRNGKey(seed + 2), STEPS)
    opt, losses = tx.init(params), []
    for t, k in enumerate(keys):
        per_rank, node_keys = [], []
        for r in range(S):
            kroots, ksample = jax.random.split(jax.random.fold_in(k, 0))
            ksample = jax.random.fold_in(ksample, r)
            ids = np.asarray(ids_fn(None, kroots, B * S))
            batch = jnp.asarray(ids[r * B:(r + 1) * B])
            rows = B
            if expand_fn is not None:
                batch = expand_fn(gj.tensors, batch)
                rows = batch["node_ids"].shape[0]
            with recording(*targets) as seen:
                model.init({"params": jax.random.PRNGKey(0),
                            "sample": ksample}, gj.tensors, batch)
            u, nk = owner_uniforms(kind, seen, rows)
            u["ids"] = ids
            per_rank.append(u)
            node_keys.append(nk)
        if node_keys[0]:
            for r, us in enumerate(coop_u([nk[0] for nk in node_keys],
                                          neg_count(kind))):
                per_rank[r].update({f"n_u{i}": x for i, x in enumerate(us)})
        for name in per_rank[0]:
            arrays[f"t{t}/{name}"] = np.stack([u[name] for u in per_rank])
        with mesh:
            if mut:
                params, state, opt, loss = step(params, state, opt, sg, k)
            else:
                params, opt, loss = step(params, opt, sg, k)
        losses.append(float(loss))
    final = {"params": params, **state} if mut else params
    final = jax.tree.map(np.asarray, nn.meta.unbox(final))
    return arrays, (losses, rank_states(opts, final))


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    gj, gt = graphs()
    mj, mt = motif_graphs(tmp_path_factory)
    arrays, cases, want = {}, [], {}
    for kind, (model, opts, ids_fn, expand, targets) in list(
            ref_models(gj).items()) + [("graph", graph_model_case(mj))]:
        g_ref = mj if kind == "graph" else gj
        a, want[kind] = ref_case(kind, model, opts, ids_fn, expand, targets,
                                 g_ref, seed=7)
        arrays.update({f"{kind}/{k}": v for k, v in a.items()})
        cases.append(dict(name=kind, verb="train",
                          graph="motif" if kind == "graph" else "rand",
                          opts=dict(opts, b=B, lr=LR, steps=STEPS,
                                    u_spec=U_SPECS[kind])))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(gt.meta.n_nodes, 4)).astype(np.float32)
    w = rng.normal(size=(4,)).astype(np.float32)
    arrays.update({"block/x": np.stack([x] * S), "block/w": np.stack([w] * S)})
    cases.append(dict(name="block", verb="psum_block", graph="rand"))
    with native_off(("build_csr_native",)):
        shards = dict(rand=sharded.build_sharded(gt, S),
                      motif=sharded.build_sharded(mt, S))
    work = str(tmp_path_factory.mktemp("models4"))
    ranks.write_work(work, 1, S, shards, arrays, cases, TIMEOUT_S / 2)
    return dict(outs=ranks.launch(work, S, TIMEOUT_S), want=want, port=gt,
                x=x, w=w)


def outputs(run, case: str, rank: int):
    got = run["outs"][rank]
    n = sum(1 for k in got if k.startswith(case + "/"))
    return [got[f"{case}/{i}"] for i in range(n)]


@pytest.mark.parametrize("kind", ["transe", "deepwalk", "scalable", "gcn",
                                  "graph"])
def test_sharded_model_steps_equal_reference(mesh4, kind):
    losses, states = mesh4["want"][kind]
    for r in range(S):
        got = outputs(mesh4, kind, r)
        np.testing.assert_allclose([float(x) for x in got[:STEPS]], losses,
                                   err_msg=f"{kind} losses rank {r}", **TOL)
        for i, (a, b) in enumerate(zip(got[STEPS:], states[r])):
            np.testing.assert_allclose(a, b, err_msg=f"{kind} state {i} "
                                                     f"rank {r}", **TOL)


def test_psum_blocks_equal_the_one_device_block(mesh4):
    """A shard's whole-graph block completed over the group: its max
    aggregate and its softmax-weighted sum equal the one-device block's;
    the max aggregate refuses a tensor that needs a gradient."""
    blk = full_graph_block(mesh4["port"].tensors, (0,), True)
    x, w = torch.from_numpy(mesh4["x"]), torch.from_numpy(mesh4["w"])
    mx = blk.aggregate_neighbors("max", x, blk.mask)
    xj = blk.gather_src(x)
    p = blk.softmax((xj * w).sum(-1), blk.mask)
    att = blk.scatter("add", p[:, None] * xj, blk.mask)
    for r in range(S):
        got_mx, got_att, refused = outputs(mesh4, "block", r)
        np.testing.assert_array_equal(got_mx, mx.numpy())
        np.testing.assert_allclose(got_att, att.numpy(), **TOL)
        assert refused[0] == 1
