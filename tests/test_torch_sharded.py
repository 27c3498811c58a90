"""The port's sharded verbs and sharded sage apply over a CPU mesh of
gloo ranks, against euler_tpu's sharded verbs on the 8-device virtual
CPU mesh.

Ranks are processes (``tests/test_torch_mesh_ranks.py``) that join
through a file store; each loads only its own shard. A module fixture
starts the ranks once per mesh (4 ranks as ``data=1, graph=4``, then
``data=2, graph=2``), every case runs in that one start, and the tests
read the
ranks' outputs. The reference runs the same call under ``shard_map`` at
``graph=4`` with one key a shard (tests/test_sharded.py's harness); the
test derives each owner's uniforms from that owner's key as the
reference's verb does inside and hands them to the port's rank, so ids,
weights, types and features must be equal bit for bit. The cooperative
draws read member 0's uniforms for the shard choice: the other ranks get
uniforms of their own there, which must not matter. Both the spread
path and the request-routed path (``set_owner_compute(True)``, as
tests/test_sharded.py:430-540 forces it) are held, with a hub id
repeated in every row and a mixed batch.

The apply: each rank's batch goes through ``make_sharded_apply`` over
the shards with every owner given ``U_all``, the concatenation of the
per-hop uniforms of its group members' one-device forwards, so its
embeddings and logits must equal the one-device forward of its own
roots within 1e-6, at ``data=1, graph=4`` and ``data=2, graph=2``.
Beside it, at both meshes, the reference's ``make_sharded_apply`` runs
under ``shard_map`` on the same batch with the same weights (carried
across with ``load_flax_params``); each owner's uniforms are derived
from the key the reference's rank folds in, so the ranks' embeddings,
logits and loss must equal the reference's within 1e-5 (the summation
order of the CPU matmuls, as tests/test_torch_models.py) and the labels
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu.ops import feature_ops as jax_feature_ops
from euler_tpu.ops import index as jax_index
from euler_tpu.ops import sampling as jax_sampling
from euler_tpu.ops import walk as jax_walk
from euler_tpu.parallel import mesh as jax_mesh
from euler_tpu.parallel import sharded as jax_sharded
from euler_tpu.parallel import train as jax_train
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import load_flax_params
from euler_tpu_torch.parallel import sharded
from tests import test_torch_mesh_ranks
from tests.test_torch_graph import native_off
from tests.test_torch_models import RecordingFlow

S = 4
B = 6                      # query rows a rank on the spread path
ALL_PACKS = ("group", "adj", "sample", "fan", "ell")
RAND_KW = dict(num_edge_types=4, seed=3, build_in_edges=True)
APPLY = dict(feat_dim=8, label_dim=3, fanouts=[4, 3], dims=[8, 6], seed=5)
APPLY_B = 8                # roots a rank
REF_TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT_S = 240


def uni(key, shape):
    return np.asarray(jax.random.uniform(key, shape), np.float32)


def fan_u(key, rows, c):
    """(u1, u2) of a fan or union hop's draw from ``key``."""
    k1, k2 = jax.random.split(key)
    return [uni(k1, (rows, c)), uni(k2, (rows, c))]


def typed_u(key, rows, c):
    """(ut, u1, u2): ``kt, kd = split(key); k1, k2 = split(kd)``."""
    kt, kd = jax.random.split(key)
    k1, k2 = jax.random.split(kd)
    return [uni(kt, (rows, c)), uni(k1, (rows, c)), uni(k2, (rows, c))]


def shard_keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), S)


def coop_u(keys, count, fold_shape=None):
    """Per rank (u_type, u_shard, u1, u2) of a cooperative draw: member
    0's key gives the synced pair (the other ranks draw theirs from
    their own keys), ``fold_in(kd, rank)`` the alias pair."""
    out = []
    kt0, ks0, kd0 = jax.random.split(keys[0], 3)
    for r in range(S):
        kt, ks, _ = jax.random.split(keys[r], 3)
        k1, k2 = jax.random.split(jax.random.fold_in(kd0, r))
        out.append([uni(kt, (count,)), uni(ks, (count,)),
                    uni(k1, (count,)), uni(k2, (count,))])
    return out


def stack_u(per_rank):
    return {f"u{i}": np.stack([u[i] for u in per_rank])
            for i in range(len(per_rank[0]))}


def rows_routed(b, n_local):
    return S * max(1, min(b, -(-2 * b // S), n_local))


def graphs(toy_dir):
    """(reference toy Graph, port toy Graph, reference random Graph, port
    random Graph), with the same packs and the numpy CSR sort."""
    with native_off(("build_csr_native",)):
        return (jax_load_graph(toy_dir),
                load_graph(toy_dir, packs=ALL_PACKS, device="cpu"),
                jax_random_graph(203, 9, packs=("fan",), **RAND_KW),
                random_graph(203, 9, device="cpu", **RAND_KW))


def make_cases(gj):
    """[(case, reference fn(view, *shard arrays), reference shard
    arrays)]: every case of the 4-rank run."""
    rng = np.random.default_rng(0)
    click = gj.meta.edge_types.index("click")
    nodes = rng.integers(-1, 8, (S, B)).astype(np.int32)
    nodes16 = rng.integers(0, 8, (S, 16)).astype(np.int32)
    hub = np.zeros((S, 16), np.int32)
    mixed = np.where(rng.random((S, 16)) < 0.9, 0,
                     rng.integers(0, 8, (S, 16))).astype(np.int32)
    nodes64 = rng.integers(-1, 8, (S, 64)).astype(np.int32)
    rnodes = rng.integers(-1, 203, (S, 24)).astype(np.int32)
    cases = []

    def add(name, verb, graph, opts, arrays, ref, ref_arrays, oc=None):
        cases.append((dict(name=name, verb=verb, graph=graph, opts=opts,
                           owner_compute=oc),
                      {f"{name}/{k}": v for k, v in arrays.items()},
                      ref, ref_arrays, oc))

    def fast_case(name, graph, nb, ets, count, seed, kind, types, oc=None,
                  n_local=2):
        keys = shard_keys(seed)
        b = nb.shape[1]
        rows = rows_routed(b, n_local) if oc else S * b
        draw = fan_u if kind == "fan" else typed_u
        u = [draw(keys[r], rows, count) for r in range(S)]
        add(name, "fast", graph, dict(ets=list(ets), types=types),
            dict(nodes=nb, **stack_u(u)),
            lambda v, n, k: jax_sampling.sample_neighbor_fast(
                v, k, n, ets, count, return_types=types), [nb, keys], oc)

    fast_case("fast_k1", "toy", nodes, (click,), 5, 1, "fan", False)
    fast_case("fast_union", "toy", nodes, (0, 1), 5, 2, "fan", True)
    fast_case("fast_routed", "toy", nodes16, (click,), 4, 3, "fan", False,
              True)
    fast_case("fast_hub", "toy", hub, (click,), 4, 4, "fan", False, True)
    fast_case("fast_mixed", "toy", mixed, (0, 1), 4, 5, "fan", True, True)
    fast_case("fast_typed", "rand", rnodes, (0, 2), 6, 6, "typed", True)
    fast_case("fast_union4", "rand", rnodes, (0, 1, 2, 3), 6, 7, "fan",
              True)
    fast_case("fast_typed_routed", "rand", rnodes, (1, 3), 5, 8, "typed",
              True, True, n_local=51)

    for name, nb, seed, oc in (("payload", nodes, 9, None),
                               ("payload_routed", mixed, 10, True)):
        keys = shard_keys(seed)
        b = nb.shape[1]
        rows = rows_routed(b, 2) if oc else S * b
        add(name, "payload", "toy", dict(ets=[0, 1]),
            dict(nodes=nb, **stack_u([typed_u(keys[r], rows, 4)
                                      for r in range(S)])),
            lambda v, n, k: jax_sampling.sample_neighbor(v, k, n, (0, 1), 4),
            [nb, keys], oc)
    keys = shard_keys(11)
    add("in_payload", "in_payload", "toy", dict(ets=[0, 1]),
        dict(nodes=nodes, **stack_u([typed_u(keys[r], S * B, 6)
                                     for r in range(S)])),
        lambda v, n, k: jax_sampling.sample_in_neighbor(v, k, n, (0, 1), 6),
        [nodes, keys])

    for name, nb, oc in (("feat", nodes, None), ("feat_auto", nodes64, None),
                         ("feat_routed", mixed, True)):
        add(name + "_dense", "dense", "toy", dict(names=["dense2", "price"]),
            dict(nodes=nb),
            lambda v, n: jax_feature_ops.get_dense_feature(
                v, n, ["dense2", "price"]), [nb], oc)
        add(name + "_sparse", "sparse", "toy", dict(names=["sparse_ids"]),
            dict(nodes=nb),
            lambda v, n: jax_feature_ops.get_sparse_feature(
                v, n, ["sparse_ids"]), [nb], oc)
        add(name + "_type", "node_type", "toy", {}, dict(nodes=nb),
            lambda v, n: jax_sampling.get_node_type(v, n), [nb], oc)
    eids = rng.integers(-1, 11, (S, 7)).astype(np.int32)
    add("edge", "edge", "toy", dict(dense=["edense"], sparse=["esparse"]),
        dict(eids=eids),
        lambda v, e: (jax_feature_ops.get_edge_dense_feature(
            v, e, ["edense"]), jax_feature_ops.get_edge_sparse_feature(
            v, e, ["esparse"]), jax_feature_ops.get_edge_type(v, e)),
        [eids])
    for name, opts in (("full_sorted", dict(cap=6, sorted=True)),
                       ("full_offset", dict(cap=2, sorted=False,
                                            offset=1))):
        add(name, "full", "toy", dict(ets=[0, 1], **opts), dict(nodes=nodes),
            lambda v, n, o=opts: jax_sampling.get_full_neighbor(
                v, n, (0, 1), o["cap"], sorted_by_id=o["sorted"],
                offset=o.get("offset", 0)), [nodes])
    add("full_in", "full_in", "toy", dict(ets=[0, 1], cap=8, sorted=True),
        dict(nodes=nodes),
        lambda v, n: jax_sampling.get_full_in_neighbor(
            v, n, (0, 1), 8, sorted_by_id=True), [nodes])
    add("top_k", "top_k", "rand", dict(ets=[0, 1, 2, 3], k=3),
        dict(nodes=rnodes),
        lambda v, n: jax_sampling.get_top_k_neighbor(v, n, (0, 1, 2, 3), 3),
        [rnodes])
    nbl = rng.integers(-1, 8, (S, 5)).astype(np.int32)
    add("adj", "adj", "toy", dict(ets=[0, 1]), dict(nodes=nodes, nb=nbl),
        lambda v, n, m: jax_sampling.sparse_get_adj(v, n, m, (0, 1)),
        [nodes, nbl])
    src = rng.integers(-1, 203, (S, 30)).astype(np.int32)
    cand = rng.integers(-1, 203, (S, 30)).astype(np.int32)
    add("is_nb", "is_nb", "rand", dict(ets=[0, 2]), dict(src=src, cand=cand),
        lambda v, s, c: jax_walk._is_neighbor(v, s, (0, 2), c), [src, cand])

    for name, verb, typ, seed, graph in (
            ("nodes_any", "nodes", -1, 12, "toy"),
            ("nodes_user", "nodes", 1, 13, "toy"),
            ("edges_any", "edges", -1, 14, "toy"),
            ("edges_rand", "edges", 2, 15, "rand")):
        keys = shard_keys(seed)
        count = 64
        u = coop_u(keys, count)
        ref_fn = (jax_sampling.sample_node if verb == "nodes"
                  else jax_sampling.sample_edge)
        add(name, verb, graph, dict(type=typ), stack_u(u),
            lambda v, k, f=ref_fn, t=typ: f(v, k, count, t), [keys])
    keys = shard_keys(16)
    srcs = rng.integers(-1, 8, (S, 5)).astype(np.int32)
    ks0, kd0 = jax.random.split(keys[0])
    u = []
    for r in range(S):
        ks, _ = jax.random.split(keys[r])
        k1, k2 = jax.random.split(jax.random.fold_in(kd0, r))
        u.append([uni(ks, (S * 5, 7)), uni(k1, (S * 5, 7)),
                  uni(k2, (S * 5, 7))])
    add("with_src", "with_src", "toy", {}, dict(src=srcs, **stack_u(u)),
        lambda v, s, k: jax_sampling.sample_node_with_src(v, k, s, 7),
        [srcs, keys])
    dnf = [[("price", "gt", 5.0)], [("dense2", "lt", 102.5)]]
    jdnf = [[jax_index.Pred(*p) for p in c] for c in dnf]
    keys = shard_keys(17)
    ks0, kd0 = jax.random.split(keys[0])
    u = []
    for r in range(S):
        ks, _ = jax.random.split(keys[r])
        u.append([uni(ks, (40,)),
                  uni(jax.random.fold_in(kd0, r), (40,))])
    add("condition", "condition", "toy", dict(dnf=dnf), stack_u(u),
        lambda v, k: jax_index.sample_node_with_condition(v, k, 40, jdnf),
        [keys])
    add("index_ids", "index_ids", "toy", dict(dnf=dnf, cap=8),
        dict(_unused=np.zeros((S, 1), np.int32)),
        lambda v, z: jax_index.query_index_ids(v, jdnf, 8), [np.zeros(
            (S, 1), np.int32)])
    add("comms", "comms", "toy", {},
        dict(x=np.arange(S * S * 3, dtype=np.int32).reshape(S, S * 3)),
        None, None)
    # the query chain reads the payload draw's uniforms for its sampleNB
    keys = shard_keys(18)
    add("query", "query", "toy",
        dict(ets=[click], count=4, feature="dense2"),
        dict(nodes=nodes, **stack_u([typed_u(keys[r], S * B, 4)
                                     for r in range(S)])),
        lambda v, n, k: jax_sampling.sample_neighbor(v, k, n, (click,), 4)[0],
        [nodes, keys])
    return cases


def ref_run(sg, fn, arrays, owner_compute=None):
    """``fn(view, *shard arrays)`` under shard_map at graph=4: each
    shard's outputs, stacked [S, ...], flattened as the ranks flatten."""
    mesh = jax_mesh.make_mesh(data=1, graph=S)
    gspecs = jax_sharded.shard_specs(sg)

    def body(sgb, *a):
        view = jax_sharded.to_view(sgb, "graph")
        outs = test_torch_mesh_ranks.flatten(fn(view, *[x[0] for x in a]))
        return tuple(jnp.asarray(o)[None] for o in outs)

    jax_sharded.set_owner_compute(owner_compute)
    try:
        with mesh:
            res = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(gspecs,) + (P("graph"),) * len(
                    arrays), out_specs=P("graph"), check_vma=False))(
                sg, *[jnp.asarray(x) for x in arrays])
    finally:
        jax_sharded.set_owner_compute(None)
    return [np.asarray(r) for r in res]


def apply_graphs():
    """(reference Graph, port Graph) of the apply cases: the same edges,
    the ``fan`` pack, the numpy CSR sort."""
    kw = dict(feat_dim=APPLY["feat_dim"], n_classes=APPLY["label_dim"],
              seed=2)
    with native_off(("build_csr_native",)):
        return (jax_random_graph(160, 6, packs=("fan",), **kw),
                random_graph(160, 6, device="cpu", **kw))


def ref_model():
    """bench.make_model("sage")'s layout in the reference, at APPLY's
    widths (the ranks' ``sage_model``)."""
    flow = jax_flows.SageDataFlow(APPLY["fanouts"],
                                  [(0,)] * len(APPLY["fanouts"]))
    net = jax_gnn.GNNNet(
        conv="sage", flow=flow, dims=tuple(APPLY["dims"]),
        feature=jax_encoders.ShallowEncoder(dense_names=("feature",)))
    return jax_gnn.SuperviseModel(embedder=net, label_name="label",
                                  label_dim=APPLY["label_dim"])


def ref_apply_inputs(gj, data: int, graph: int, seed: int):
    """The reference's sharded apply case on a ``data`` x ``graph`` mesh:
    the ranks' arrays (the batch; per hop each owner's (u1, u2) over its
    graph group's spread rows, drawn from the flow key that its rank's
    ``fold_in(key, rank)`` gives, as sample_neighbor_fast_sharded draws
    them; the flax weights as the port's state dict) and the reference's
    call (variables, batch, key)."""
    W = data * graph
    batch = np.random.default_rng(seed).integers(
        0, gj.meta.n_nodes, W * APPLY_B).astype(np.int32)
    model = ref_model()
    rec = RecordingFlow(model.embedder.flow)
    recording = model.clone(embedder=model.embedder.clone(flow=rec))
    variables = model.init({"params": jax.random.PRNGKey(seed),
                            "sample": jax.random.PRNGKey(seed + 1)},
                           gj.tensors, jnp.asarray(batch[:APPLY_B]))
    key = jax.random.PRNGKey(seed + 2)
    per_rank = []
    for r in range(W):
        recording.apply(variables, gj.tensors,
                        jnp.asarray(batch[r * APPLY_B:(r + 1) * APPLY_B]),
                        rngs={"sample": jax.random.fold_in(key, r)})
        k, rows, hops = rec.keys[-1], APPLY_B, []
        for c in APPLY["fanouts"]:
            k, sub = jax.random.split(k)
            hops.append(fan_u(sub, graph * rows, c))
            rows *= 1 + c
        per_rank.append(hops)
    arrays = {"batch": np.stack([batch] * W)}
    for h in range(len(APPLY["fanouts"])):
        for i in range(2):
            arrays[f"h{h}_u{i}"] = np.stack([u[h][i] for u in per_rank])
    port = load_flax_params(test_torch_mesh_ranks.sage_model(**APPLY),
                            jax.tree.map(np.asarray, variables))
    arrays.update({f"p/{k}": np.stack([v.numpy()] * W)
                   for k, v in port.state_dict().items()})
    return arrays, (variables, batch, key)


def ref_sharded_apply(gj, data: int, graph: int, call) -> dict:
    """The reference's make_sharded_apply on the virtual CPU mesh."""
    variables, batch, key = call
    mesh = jax_mesh.make_mesh(data=data, graph=graph)
    sg = jax_sharded.build_sharded(gj, graph)
    fn = jax_train.make_sharded_apply(ref_model(), sg, mesh)
    with mesh:
        out = fn(sg, variables, jnp.asarray(batch), key)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def mesh4(toy_dir, tmp_path_factory):
    """Every case at data=1, graph=4: (reference graphs, cases, each
    rank's outputs, the apply's one-device outputs and batch)."""
    gj, gt, rj, rt = graphs(toy_dir)
    with native_off(("build_csr_native",)):
        sgs = dict(toy=sharded.build_sharded(gt, S),
                   rand=sharded.build_sharded(rt, S))
        refs = dict(toy=jax_sharded.build_sharded(gj, S),
                    rand=jax_sharded.build_sharded(rj, S))
    cases = make_cases(gj)
    arrays = {}
    for _, a, *_ in cases:
        arrays.update(a)
    gja, ga = apply_graphs()
    sgs["apply"] = sharded.build_sharded(ga, S)
    a, want = test_torch_mesh_ranks.apply_inputs(ga.tensors, 1, S, APPLY_B,
                                                 APPLY, seed=1)
    arrays.update({f"apply/{k}": v for k, v in a.items()})
    a, ref_call = ref_apply_inputs(gja, 1, S, seed=3)
    arrays.update({f"apply_ref/{k}": v for k, v in a.items()})
    specs = [c[0] for c in cases] + [
        dict(name=name, verb="apply", graph="apply", opts=APPLY)
        for name in ("apply", "apply_ref")]
    work = str(tmp_path_factory.mktemp("mesh4"))
    test_torch_mesh_ranks.write_work(work, 1, S, sgs, arrays, specs,
                                     TIMEOUT_S / 2)
    outs = test_torch_mesh_ranks.launch(work, S, TIMEOUT_S)
    return dict(refs=refs, cases={c[0]["name"]: c for c in cases},
                outs=outs, want=want, arrays=arrays, apply_graph=gja,
                ref_call=ref_call)


CASES = ["fast_k1", "fast_union", "fast_routed", "fast_hub", "fast_mixed",
         "fast_typed", "fast_union4", "fast_typed_routed", "payload",
         "payload_routed", "in_payload", "feat_dense", "feat_sparse",
         "feat_type", "feat_auto_dense", "feat_auto_sparse", "feat_auto_type",
         "feat_routed_dense", "feat_routed_sparse", "feat_routed_type",
         "edge", "full_sorted", "full_offset", "full_in", "top_k", "adj",
         "is_nb", "nodes_any", "nodes_user", "edges_any", "edges_rand",
         "with_src", "condition", "index_ids"]


@pytest.mark.parametrize("name", CASES)
def test_sharded_verb_equals_reference(mesh4, name):
    spec, _, ref_fn, ref_arrays, oc = mesh4["cases"][name]
    want = ref_run(mesh4["refs"][spec["graph"]], ref_fn, ref_arrays, oc)
    for r in range(S):
        got = mesh4["outs"][r]
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[f"{name}/{i}"], w[r],
                                          err_msg=f"{name} output {i} "
                                                  f"rank {r}")


def test_routed_paths_serve_every_row(mesh4):
    """The hub and mixed batches on the request-routed path: every row
    with neighbors is served (dedup keeps the request table small)."""
    for r in range(S):
        got = mesh4["outs"][r]
        assert got["fast_hub/1"].all()
        mixed = mesh4["arrays"]["fast_mixed/nodes"][r]
        assert got["fast_mixed/1"][mixed == 0].all()


def test_collectives_over_the_graph_group(mesh4):
    """all_gather, the tiled all_to_all, psum and pmean over the 4
    ranks, and the cost model's all_to_all bytes (3/4 of the
    tensor)."""
    x = mesh4["arrays"]["comms/x"]                     # [rank, 12]
    for r in range(S):
        got = mesh4["outs"][r]
        np.testing.assert_array_equal(got["comms/0"], x)
        np.testing.assert_array_equal(
            got["comms/1"], x.reshape(S, S, 3)[:, r].reshape(-1))
        np.testing.assert_array_equal(got["comms/2"], x.sum(0))
        np.testing.assert_array_equal(got["comms/3"], x.sum(0) / S)
        assert got["comms/4"][0] == 3 * 4 * 12 // 4


def test_query_chain_over_a_view(mesh4, toy_dir):
    """Query(view).v(ids).sampleNB(...).values(...) runs unchanged over
    the shards: its neighbors are the sharded payload draw's from the
    same uniforms, its values the one-device features of them."""
    spec, _, ref_fn, ref_arrays, _ = mesh4["cases"]["query"]
    want_nb = ref_run(mesh4["refs"]["toy"], ref_fn, ref_arrays)[0]
    gj = jax_load_graph(toy_dir)
    for r in range(S):
        got = mesh4["outs"][r]
        np.testing.assert_array_equal(got["query/0"], want_nb[r])
        feats = np.asarray(jax_feature_ops.get_dense_feature(
            gj.tensors, jnp.asarray(want_nb[r]), ["dense2"])[0])
        np.testing.assert_array_equal(got["query/1"],
                                      feats.reshape(-1, feats.shape[-1]))


def check_apply(outs, want, W):
    emb = torch.cat([w["embedding"] for w in want]).numpy()
    logit = torch.cat([w["logit"] for w in want]).numpy()
    label = torch.cat([w["label"] for w in want]).numpy()
    loss = np.mean([float(w["loss"]) for w in want])
    for r in range(W):
        got = outs[r]
        np.testing.assert_allclose(got["apply/0"], emb, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["apply/1"], logit, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["apply/2"], label)
        np.testing.assert_allclose(got["apply/3"], loss, rtol=0, atol=1e-6)


def check_ref_apply(outs, want, W):
    for r in range(W):
        got = outs[r]
        for i, k in enumerate(("embedding", "logit")):
            np.testing.assert_allclose(got[f"apply_ref/{i}"], want[k],
                                       err_msg=f"{k} rank {r}", **REF_TOL)
        np.testing.assert_array_equal(got["apply_ref/2"], want["label"])
        np.testing.assert_allclose(got["apply_ref/3"], want["loss"],
                                   **REF_TOL)


def test_sharded_apply_equals_one_device_forward_graph4(mesh4):
    check_apply(mesh4["outs"], mesh4["want"], S)


def test_sharded_apply_equals_reference_graph4(mesh4):
    want = ref_sharded_apply(mesh4["apply_graph"], 1, S, mesh4["ref_call"])
    check_ref_apply(mesh4["outs"], want, S)


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    gja, ga = apply_graphs()
    a, want = test_torch_mesh_ranks.apply_inputs(ga.tensors, 2, 2, APPLY_B,
                                                 APPLY, seed=2)
    arrays = {f"apply/{k}": v for k, v in a.items()}
    a, ref_call = ref_apply_inputs(gja, 2, 2, seed=4)
    arrays.update({f"apply_ref/{k}": v for k, v in a.items()})
    work = str(tmp_path_factory.mktemp("mesh22"))
    test_torch_mesh_ranks.write_work(
        work, 2, 2, dict(apply=sharded.build_sharded(ga, 2)), arrays,
        [dict(name=name, verb="apply", graph="apply", opts=APPLY)
         for name in ("apply", "apply_ref")], TIMEOUT_S / 2)
    return dict(outs=test_torch_mesh_ranks.launch(work, 4, TIMEOUT_S),
                want=want, apply_graph=gja, ref_call=ref_call)


def test_sharded_apply_equals_one_device_forward_data2_graph2(mesh22):
    check_apply(mesh22["outs"], mesh22["want"], 4)


def test_sharded_apply_equals_reference_data2_graph2(mesh22):
    want = ref_sharded_apply(mesh22["apply_graph"], 2, 2, mesh22["ref_call"])
    check_ref_apply(mesh22["outs"], want, 4)
