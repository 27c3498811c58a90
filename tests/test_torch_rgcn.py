"""R-GCN over a typed whole graph on the CPU: the ``rel`` pack, the typed
mean's plain versions, ``RelationConv(per_relation=True)`` with the
``TypedEncoder`` over ``WholeDataFlow(layout="rel")`` against the
benchmark's plain reference (``benchmark/reference/rgcn.py``), and
Euler's default ``RelationConv`` unchanged.

The graph (``typed_graph``): 4 node types, 7 edge types as OGB's
ogbn-mag R-GCN has them, about 2,000 nodes, a hub past the ELL gate's cap
and past the kernel's ``HUB`` both ways (a field reading 600 papers, a
paper citing 400, a field read by 400 papers), and targets that have no
edge of some relation."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import rgcn as ref_rgcn
from euler_tpu_torch.dataflow import WholeDataFlow
from euler_tpu_torch.dataflow.block import full_graph_block
from euler_tpu_torch.graph.convert import build_csr
from euler_tpu_torch.graph.meta import FeatureSpec, GraphMeta
from euler_tpu_torch.graph.store import Graph, _ell_pack_np
from euler_tpu_torch.models import (GNNNet, RelationConv, SuperviseModel,
                                    TypedEncoder)
from euler_tpu_torch.ops import rel_agg

#: node types (name, count); the papers have features
TYPES = (("paper", 700), ("author", 1000), ("institution", 40),
         ("field", 260))
#: edge types (target type, neighbour type), as OGB's mag R-GCN orders
#: its relations: affiliated_with, institution_to_author, writes,
#: paper_to_author, cites, has_topic, field_to_paper
RELATIONS = ((2, 1), (1, 2), (0, 1), (1, 0), (0, 0), (3, 0), (0, 3))
FEAT, CLASSES = 12, 5


def typed_graph(device="cpu", seed=0, dtype=torch.float32):
    """(graph, arrays) of the module's typed graph: ids by type in
    contiguous ranges, distinct edges, the features and labels of the
    papers in ``dtype``."""
    rng = np.random.default_rng(seed)
    lo = np.cumsum([0] + [c for _, c in TYPES])
    src, dst, ety = [], [], []
    for r, (a, b) in enumerate(RELATIONS):
        m = 1500
        s = rng.integers(lo[a], lo[a + 1], m)
        d = rng.integers(lo[b], lo[b + 1], m)
        if r == 5:                   # one field reading 600 papers
            s[:600], d[:600] = lo[3], rng.permutation(lo[1] - lo[0])[:600]
        if r == 4:                   # one paper citing 400 others
            s[:400], d[:400] = lo[0] + 5, lo[0] + 100 + np.arange(400)
        if r == 6:                   # one field read by 400 papers
            s[:400], d[:400] = rng.permutation(lo[1])[:400], lo[3] + 1
        key = np.unique(s * lo[-1] + d)
        src.append(key // lo[-1])
        dst.append(key % lo[-1])
        ety.append(np.full(len(key), r))
    src, dst, ety = (np.concatenate(v).astype(np.int32)
                     for v in (src, dst, ety))
    n, e = int(lo[-1]), len(src)
    arrays = dict(ext_ids=np.arange(n), node_local=np.arange(n, dtype=np.int32),
                  node_type=np.repeat(np.arange(4), [c for _, c in TYPES])
                  .astype(np.int32),
                  node_w=np.ones(n, np.float32), src=src, dst=dst, etype=ety,
                  ew=np.ones(e, np.float32), eid=np.arange(e, dtype=np.int32))
    meta = GraphMeta(n_nodes=n, n_edges=e,
                     node_types=tuple(t for t, _ in TYPES),
                     edge_types=tuple(str(r) for r in range(7)),
                     node_features=(), edge_features=())
    graph = Graph(meta, arrays, packs=("rel",), device=device)
    graph.meta = dataclasses.replace(meta, node_features=(
        FeatureSpec("feature", "dense", FEAT),
        FeatureSpec("label", "dense", CLASSES)))
    gen = torch.Generator().manual_seed(seed + 1)
    feat = torch.randn(TYPES[0][1], FEAT, generator=gen).to(dtype)
    label = torch.nn.functional.one_hot(
        torch.randint(0, CLASSES, (TYPES[0][1],), generator=gen),
        CLASSES).float()
    graph.tensors = dataclasses.replace(
        graph.tensors, meta=graph.meta,
        dense_nf=dict(feature=feat.to(device), label=label.to(device)))
    return graph, arrays


def rgcn_model(device="cpu", dtype=None, dims=(8, 8), seed=0):
    """GNNNet with R-GCN convs over the typed whole graph and the typed
    encoder, in SuperviseModel, as the rgcn configuration builds it."""
    gen = torch.Generator().manual_seed(seed)
    enc = TypedEncoder([(t, c, "feature" if t == "paper" else None)
                        for t, c in TYPES], FEAT, generator=gen)
    net = GNNNet("rgcn", WholeDataFlow(len(dims), [tuple(range(7))],
                                       add_self_loops=False, layout="rel"),
                 dims, enc, in_dim=FEAT, dtype=dtype, device=device,
                 generator=gen, conv_kwargs=dict(
                     num_relations=7, per_relation=True, node_types=4))
    return SuperviseModel(net, "label", CLASSES, device=device,
                          generator=gen)


@pytest.fixture(scope="module")
def typed():
    return typed_graph()


def test_the_hubs_pass_the_ell_cap_and_the_kernels_hub(typed):
    graph, arrays = typed
    g = graph.tensors
    n, net = graph.meta.n_nodes, 7
    gp = g.group_ptr.numpy()
    assert _ell_pack_np(n, net, gp, g.adj_dst.numpy(), g.adj_w.numpy(),
                        g.adj_eid.numpy(), g.adj_type.numpy()) is None
    assert np.diff(gp).max() > rel_agg.HUB
    assert np.diff(g.rel.tptr.numpy()).max() > rel_agg.HUB
    # some targets have no edge of a relation their type receives
    cnt = np.diff(gp).reshape(n, net)
    assert (cnt[:TYPES[0][1], 2] == 0).any()


def test_pack_arrays_match_a_numpy_build(typed):
    graph, arrays = typed
    g, p = graph.tensors, graph.tensors.rel
    n, R = graph.meta.n_nodes, 7
    src, dst, et = g.adj_src.numpy(), g.adj_dst.numpy(), g.adj_type.numpy()
    order = np.lexsort((src, et, dst))
    tptr = np.zeros(n * R + 1, np.int64)
    np.add.at(tptr, dst.astype(np.int64) * R + et + 1, 1)
    assert np.array_equal(p.tptr.numpy(), np.cumsum(tptr))
    assert np.array_equal(p.tsrc.numpy(), src[order])
    cnt = np.diff(g.group_ptr.numpy().astype(np.int64))
    want_tw = (1.0 / cnt[src.astype(np.int64) * R + et])[order]
    assert np.array_equal(p.tw.numpy(), want_tw.astype(np.float32))
    lo = list(np.cumsum([0] + [c for _, c in TYPES]))
    assert p.type_lo == tuple(lo)
    assert p.row_lo == tuple(lo[b] for _, b in RELATIONS)
    assert p.row_hi == tuple(lo[b + 1] for _, b in RELATIONS)
    for hubs, ptr in ((p.hubs, g.group_ptr), (p.tr_hubs, p.tptr)):
        sp = ptr.numpy().astype(np.int64)
        long = np.nonzero(np.diff(sp) > rel_agg.HUB)[0]
        assert np.array_equal(hubs.seg.numpy(), long)
        ch = hubs.chunks.numpy()
        for h, s in enumerate(long):
            mine = ch[hubs.ptr[h]:hubs.ptr[h + 1]]
            assert (mine[:, 0] == s).all()
            assert mine[0, 1] == sp[s] and mine[-1, 2] == sp[s + 1]
            assert (mine[1:, 1] == mine[:-1, 2]).all()
            assert (mine[:, 2] - mine[:, 1] <= rel_agg.HUB).all()


def test_a_mixed_relation_spans_its_neighbours_ids():
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([3, 1, 4], np.int32)
    arrays = dict(ext_ids=np.arange(5), node_local=np.arange(5,
                                                             dtype=np.int32),
                  node_type=np.array([0, 0, 1, 1, 1], np.int32),
                  node_w=np.ones(5, np.float32), src=src, dst=dst,
                  etype=np.zeros(3, np.int32), ew=np.ones(3, np.float32),
                  eid=np.arange(3, dtype=np.int32))
    meta = GraphMeta(n_nodes=5, n_edges=3, node_types=("a", "b"),
                     edge_types=("x", "y"), node_features=(),
                     edge_features=())
    p = Graph(meta, arrays, packs=("rel",), device="cpu").tensors.rel
    assert (p.row_lo, p.row_hi) == ((1, 0), (5, 0))


def relation_views(graph, F, dtype, seed=0, device="cpu"):
    """Random message rows a relation ([row_hi - row_lo, F], column blocks
    of one wider table, as the layer's GEMMs lay them) and f32 roots a
    type (column blocks too), on ``device``."""
    p = graph.tensors.rel
    gen = torch.Generator().manual_seed(seed)
    R = len(p.row_lo)
    table = torch.randn(graph.meta.n_nodes, R * F, generator=gen).to(
        dtype).to(device)
    rows = [table[lo:hi, r * F:(r + 1) * F]
            for r, (lo, hi) in enumerate(zip(p.row_lo, p.row_hi))]
    wide = torch.randn(graph.meta.n_nodes, 2 * F, generator=gen).to(device)
    roots = [wide[a:b, F:] for a, b in zip(p.type_lo[:-1], p.type_lo[1:])]
    return rows, roots


def index_add_mean(graph, rows, roots, mask):
    """The forward by ``index_add_`` over the edge list."""
    g, p = graph.tensors, graph.tensors.rel
    n, R = graph.meta.n_nodes, len(rows)
    out = torch.zeros(n, rows[0].shape[1])
    for r in range(R):
        if not (mask >> r) & 1:
            continue
        sel = g.adj_type == r
        t, j = g.adj_src[sel].long(), g.adj_dst[sel].long()
        s = torch.zeros_like(out).index_add_(0, t, rows[r][j - p.row_lo[r]]
                                             .float())
        c = torch.bincount(t, minlength=n).float()
        out += s / c.clamp_min(1)[:, None]
    for k, v in enumerate(roots):
        out[p.type_lo[k]:p.type_lo[k + 1]] += v
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [0b1111111, 0b1011011])
def test_plain_forward_against_index_add(typed, dtype, mask):
    graph, _ = typed
    g, p = graph.tensors, graph.tensors.rel
    rows, roots = relation_views(graph, 8, dtype)
    got = rel_agg.rel_mean(rows, p.row_lo, g.group_ptr, g.adj_dst, roots,
                           p.type_lo, mask, p.hubs)
    want = index_add_mean(graph, rows, roots, mask)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [0b1111111, 0b1011011])
def test_plain_transpose_against_index_add(typed, dtype, mask):
    """The transpose is the forward's gradient to the message rows, the
    roots' left out: autograd of ``index_add_mean`` gives it."""
    graph, _ = typed
    g, p = graph.tensors, graph.tensors.rel
    rows, _ = relation_views(graph, 8, torch.float32)
    rows = [v.detach().clone().requires_grad_(True) for v in rows]
    cot = torch.randn(graph.meta.n_nodes, 8,
                      generator=torch.Generator().manual_seed(3)).to(dtype)
    index_add_mean(graph, rows, [], mask).backward(cot.float())
    out = [torch.full(v.shape, float("nan")) for v in rows]
    rel_agg.rel_mean_tr(cot, p.tptr, p.tsrc, p.tw, out, p.row_lo, mask,
                        p.tr_hubs)
    for r, (a, v) in enumerate(zip(out, rows)):
        want = v.grad if (mask >> r) & 1 else torch.zeros_like(a)
        torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-6)


def test_rel_flow_refuses_self_loops_and_a_graph_without_the_pack():
    with pytest.raises(ValueError, match="self loops"):
        WholeDataFlow(2, [(0,)], layout="rel")
    from euler_tpu_torch.datasets import random_graph
    g = random_graph(50, 4, feat_dim=4, n_classes=2, seed=0, device="cpu")
    with pytest.raises(ValueError, match="'rel' pack"):
        WholeDataFlow(2, [(0,)], add_self_loops=False, layout="rel")(
            g.tensors, torch.arange(4))


def test_plan_groups_relations_by_neighbour_type(typed):
    graph, _ = typed
    blk = WholeDataFlow(1, [tuple(range(7))], add_self_loops=False,
                        layout="rel")(graph.tensors, torch.arange(3))[0]
    p = graph.tensors.rel
    plan = blk.rel.plan(p.type_lo)
    lo = p.type_lo
    assert sorted(plan) == sorted([
        (lo[0], lo[1], (3, 4, 5), 0), (lo[1], lo[2], (0, 2), 1),
        (lo[2], lo[3], (1,), 2), (lo[3], lo[4], (6,), 3)])
    assert blk.rel.mask == 0b1111111
    assert torch.equal(blk.e_type, graph.tensors.adj_type)


def reference_weights(model):
    """The benchmark reference's weights from the port's parameters."""
    enc = model.embedder.feature
    w = {f"emb.{t}": enc.emb[t] for t, _ in TYPES[1:]}
    for i, conv in enumerate(model.embedder.convs):
        w.update({f"l{i}.matrix": conv.matrix,
                  f"l{i}.root": conv.root_weight,
                  f"l{i}.root_b": conv.root_bias})
    w.update({"out.w": model.embedder.out_fc.weight,
              "out.b": model.embedder.out_fc.bias,
              "head.w": model.head_fc.weight})
    return w


def test_forward_loss_and_every_gradient_match_the_reference(typed):
    """In f32 the port's step (the fused layer over the typed pack, the
    typed encoder, out_fc and the sigmoid head) equals the plain
    reference's: embeddings, loss and every gradient, the tables'
    included, with weights drawn at random (biases too)."""
    graph, arrays = typed
    model = rgcn_model()
    with torch.no_grad():
        gen = torch.Generator().manual_seed(11)
        for prm in model.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.3)
    roots = torch.arange(500, dtype=torch.int32)
    out = model(graph.tensors, roots)
    out["loss"].backward()
    ref_graph = ref_rgcn.RelGraph(arrays["src"], arrays["dst"],
                                  arrays["etype"], graph.meta.n_nodes, 7,
                                  "cpu")
    w = {k: v.detach().clone().requires_grad_(True)
         for k, v in reference_weights(model).items()}
    emb = ref_rgcn.rgcn_embed(w, graph.tensors.dense_nf["feature"],
                              [t for t, _ in TYPES[1:]], ref_graph,
                              graph.tensors.rel.type_lo, 2)[roots.long()]
    torch.testing.assert_close(out["embedding"], emb, rtol=1e-5, atol=1e-5)
    logit = emb @ w["head.w"].T
    from benchmark.reference.gnn import sigmoid_xent_loss
    loss = sigmoid_xent_loss(logit, graph.tensors.dense_nf["label"][:500],
                             torch.ones(500, dtype=torch.bool))
    torch.testing.assert_close(out["loss"], loss, rtol=1e-6, atol=1e-6)
    loss.backward()
    got = reference_weights(model)
    for k, v in w.items():
        torch.testing.assert_close(got[k].grad, v.grad, rtol=1e-4,
                                   atol=1e-6, msg=k)
    # the second layer's roots of types no root reads take no gradient
    assert float(model.embedder.convs[1].root_weight.grad[1:].abs().max()) \
        == 0.0


def test_bf16_activations_stay_near_the_f32_step(typed):
    graph, _ = typed
    roots = torch.arange(500, dtype=torch.int32)
    losses = []
    for dt in (None, torch.bfloat16):
        model = rgcn_model(dtype=dt)
        losses.append(float(model(graph.tensors, roots)["loss"].detach()))
    assert abs(losses[0] - losses[1]) < 1e-2 * abs(losses[0])


def test_one_root_type_runs_over_every_node(typed):
    """RelationConv(per_relation=True) with one node type: one root linear
    over all nodes, the same layer as the reference's with the root's
    weight and bias shared by every type."""
    graph, arrays = typed
    g = graph.tensors
    x = torch.randn(graph.meta.n_nodes, 6,
                    generator=torch.Generator().manual_seed(4))
    conv = RelationConv(6, 5, num_relations=7, per_relation=True,
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        conv.root_bias.normal_()
    blk = WholeDataFlow(1, [tuple(range(7))], add_self_loops=False,
                        layout="rel")(g, torch.arange(3))[0]
    got = conv((x, x), blk)
    ref_graph = ref_rgcn.RelGraph(arrays["src"], arrays["dst"],
                                  arrays["etype"], graph.meta.n_nodes, 7,
                                  "cpu")
    w = {"l0.matrix": conv.matrix, "l0.root": conv.root_weight,
         "l0.root_b": conv.root_bias}
    want = ref_rgcn.rgcn_layer(x, w, 0, ref_graph, (0, graph.meta.n_nodes))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_per_relation_needs_the_typed_block(typed):
    graph, _ = typed
    blk = full_graph_block(graph.tensors, tuple(range(7)), False)
    x = torch.zeros(graph.meta.n_nodes, 4)
    for types in (1, 4):
        conv = RelationConv(4, 3, num_relations=7, per_relation=True,
                            node_types=types)
        with pytest.raises(ValueError, match="typed whole-graph block"):
            conv((x, x), blk, edge_attr=graph.tensors.adj_type)


def test_typed_encoder_rows_by_id_match_its_whole_table(typed):
    graph, _ = typed
    enc = TypedEncoder([(t, c, "feature" if t == "paper" else None)
                        for t, c in TYPES], FEAT,
                       generator=torch.Generator().manual_seed(0))
    whole = enc.whole(graph.tensors)
    ids = torch.tensor([0, 699, 700, 1699, 1700, 1739, 1740, 1999, -1, 5])
    rows = enc(graph.tensors, ids)
    ok = ids >= 0
    assert torch.equal(rows[ok], whole[ids[ok]])
    assert float(rows[~ok].detach().abs().max()) == 0.0
    assert torch.equal(whole[:700], graph.tensors.dense_nf["feature"])
    bound = (6.0 / (1000 + FEAT)) ** 0.5
    assert float(enc.emb["author"].detach().abs().max()) <= bound


def test_euler_relation_conv_default_is_unchanged(typed):
    """The default RelationConv (Euler's): the sum over every relation of
    W_r times the relation's sum, divided by the count of all valid
    edges, plus the bias-free self_fc; no root_weight."""
    graph, _ = typed
    g = graph.tensors
    blk = full_graph_block(g, tuple(range(7)), add_self_loops=True)
    attr = torch.cat([g.adj_type, torch.zeros(graph.meta.n_nodes,
                                              dtype=torch.int32)]).long()
    x = torch.randn(graph.meta.n_nodes, 6,
                    generator=torch.Generator().manual_seed(4))
    conv = RelationConv(6, 5, num_relations=7,
                        generator=torch.Generator().manual_seed(2))
    assert not hasattr(conv, "root_weight")
    got = conv((x, x), blk, edge_attr=attr)
    t, j = blk.edge_index[0].long(), blk.edge_index[1].long()
    tot = torch.zeros(graph.meta.n_nodes, 5)
    for r in range(7):
        sel = attr == r
        s = torch.zeros_like(x).index_add_(0, t[sel], x[j[sel]])
        tot += s @ conv.matrix[r].T
    cnt = torch.bincount(t, minlength=graph.meta.n_nodes).float()
    want = conv.self_fc(x) + tot / cnt.clamp_min(1e-7)[:, None]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_build_csr_order_is_what_the_transposed_pack_reads(typed):
    """tsrc within a transposed segment ascends: the sums' fixed order."""
    graph, _ = typed
    p = graph.tensors.rel
    tp, ts = p.tptr.numpy(), p.tsrc.numpy()
    seg = np.repeat(np.arange(len(tp) - 1), np.diff(tp))
    same = seg[1:] == seg[:-1]
    assert (ts[1:][same] > ts[:-1][same]).all()
    assert callable(build_csr)
