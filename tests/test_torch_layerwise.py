"""The layerwise flows of the PyTorch port against euler_tpu on the CPU:
the shared-source block layout, ``LayerwiseDataFlow`` and
``FastDataFlow``, the flow registry, and ``GNNNet`` (gcn, sage, gat and
relation) over a layerwise flow.

The shared-source paths of a block must give what the same block made
irregular gives (after the reference's tests/test_models.py:107), and
what the reference's block of the same arrays gives, within 1e-5. The
flows' ids, masks and weights must be equal bit for bit from the
reference's uniforms (each hop's ``key, k1 = split(key)``, then
``sample_layer``'s ``k1, k2 = split(k1)``): the layer draw ranks its
candidates by Gumbel keys through ``log``, which XLA and torch may round
differently, so a hop is held bit for bit where no two of its best keys
lie within 4 ulps (none in these draws; a hop with such a near tie is
reported and ends the comparison of deeper hops). Models: forward, loss
and every gradient within rtol = atol = 1e-5 from the same flax tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import block as jax_block
from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.models import convs as jax_convs
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu_torch.dataflow import (FastDataFlow, LayerwiseDataFlow,
                                      get_flow_class)
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.models import (GNNNet, RelationConv, ShallowEncoder,
                                    SuperviseModel, load_flax_params)
from euler_tpu_torch.ops import sampling
from tests.test_torch_graph import native_off

TOL = dict(rtol=1e-5, atol=1e-5)
PACKS = ("group", "adj", "sample", "fan")
N, FEAT, CLASSES = 300, 8, 4
SIZES, CPN, METAPATH = [12, 8], 4, [(0, 1)] * 2
FLOWS = {"layerwise": (LayerwiseDataFlow, jax_flows.LayerwiseDataFlow),
         "fast": (FastDataFlow, jax_flows.FastDataFlow)}
BLOCK_FIELDS = ("n_id", "res_n_id", "edge_index", "e_id", "edge_weight",
                "mask")


@pytest.fixture(scope="module")
def pair():
    kw = dict(feat_dim=FEAT, n_classes=CLASSES, num_edge_types=2, seed=4,
              packs=PACKS)
    with native_off(("build_csr_native",)):
        return jax_random_graph(N, 12, **kw), random_graph(N, 12,
                                                           device="cpu", **kw)


@pytest.fixture(scope="module")
def roots():
    r = np.arange(7, 17, dtype=np.int32)
    r[3] = -1                                    # a padded batch row
    return r


def layer_uniforms(key, T):
    """The uniforms ``sample_layer`` draws from ``key`` over T frontier
    nodes: ((u_type, u1, u2) [T, CPN], Gumbel uniforms [T * CPN])."""
    k1, k2 = jax.random.split(key)
    kt, kd = jax.random.split(k1)
    ka, kb = jax.random.split(kd)
    cand = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (T, CPN))))
                 for k in (kt, ka, kb))
    gum = jax.random.uniform(k2, (T * CPN,), minval=1e-20, maxval=1.0)
    return cand, torch.from_numpy(np.array(gum))


def flow_uniforms(key, T, sizes=SIZES):
    """One ``layer_uniforms`` tuple per hop, as the reference's flow
    splits its key; the frontier grows by each layer's size."""
    out = []
    for m in sizes:
        key, k1 = jax.random.split(key)
        out.append(layer_uniforms(k1, T))
        T += m
    return out


def near_tie(g, frontier, ets, u, m, weight_func) -> bool:
    """Whether two of the m + 1 best Gumbel keys of a layer draw lie
    within 4 ulps (where XLA's log and torch's may order them
    otherwise)."""
    keyed = sampling.layer_keys(g, frontier, ets, CPN, u, weight_func)[2]
    top = torch.sort(keyed[torch.isfinite(keyed)], descending=True)[0]
    top = top[:m + 1].numpy()
    gaps = top[:-1] - top[1:]
    return bool((gaps <= 4 * np.spacing(np.abs(top[:-1]))).any())


def assert_blocks_equal(got, want):
    assert got.size == tuple(want.size) and got.fanout == want.fanout
    assert got.shared_src and want.shared_src
    assert got.self_loops == want.self_loops
    for name in BLOCK_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def compare_flows(gj, gt, kind, roots, key, self_loops=True):
    """The reference's blocks and the port's from the same draws, bit for
    bit hop by hop (deepest last) while no hop has a near tie; returns
    the number of hops compared."""
    ours, theirs = FLOWS[kind]
    fj = theirs(SIZES, METAPATH, add_self_loops=self_loops,
                candidates_per_node=CPN)
    want = jax.jit(lambda g, r: fj(g, key, r))(gj.tensors,
                                               jnp.asarray(roots))
    u = flow_uniforms(key, len(roots))
    ft = ours(SIZES, METAPATH, add_self_loops=self_loops,
              candidates_per_node=CPN)
    got = ft(gt.tensors, torch.from_numpy(roots), uniforms=u)
    assert len(got) == len(want) == 2
    frontier = torch.from_numpy(roots)
    for hop, (bt, bj) in enumerate(zip(got[::-1], want[::-1])):
        if near_tie(gt.tensors, frontier, METAPATH[hop], u[hop], SIZES[hop],
                    ft.weight_func):
            return hop
        assert_blocks_equal(bt, bj)
        layer = bt.n_id[bt.size[0]:]
        live = layer[layer >= 0]
        assert len(torch.unique(live)) == len(live)       # deduplicated
        frontier = bt.n_id
    return 2


@pytest.mark.parametrize("kind", ["layerwise", "fast"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flow_blocks_bit_exact(pair, roots, kind, seed):
    gj, gt = pair
    assert compare_flows(gj, gt, kind, roots, jax.random.PRNGKey(seed)) == 2


def test_flow_without_self_loops_bit_exact(pair, roots):
    gj, gt = pair
    assert compare_flows(gj, gt, "layerwise", roots, jax.random.PRNGKey(9),
                         self_loops=False) == 2


def test_flow_masks_only_true_edges(pair, roots):
    """Every unmasked edge of a layerwise block is an edge of the graph
    with that weight, and every pair of adjacent live nodes is unmasked
    (the full frontier x layer adjacency)."""
    _, gt = pair
    g = gt.tensors
    blk = LayerwiseDataFlow([12], [(0, 1)], add_self_loops=False,
                            candidates_per_node=CPN)(
        g, torch.from_numpy(roots),
        generator=torch.Generator().manual_seed(5))[0]
    adj = {}
    src = g.adj_src.numpy()
    for s, d, t, w in zip(src, g.adj_dst.numpy(), g.adj_type.numpy(),
                          g.adj_w.numpy()):
        if t in (0, 1):
            adj[(int(s), int(d))] = w
    n_id = blk.n_id.numpy()
    mask, w = blk.mask.numpy(), blk.edge_weight.numpy()
    ei = blk.edge_index.numpy()
    for e in range(ei.shape[1]):
        t, s = n_id[ei[0, e]], n_id[ei[1, e]]
        hit = adj.get((int(t), int(s))) if t >= 0 and s >= 0 else None
        assert mask[e] == (hit is not None), (t, s)
        assert w[e] == (hit if hit is not None else 0.0)
    assert mask.sum() > 0


def test_flow_takes_a_generator_and_checks_its_uniforms(pair, roots):
    _, gt = pair
    flow = FastDataFlow(SIZES, METAPATH, candidates_per_node=CPN)
    assert flow.weight_func == "uniform" and flow.num_layers == 2
    a, b = (flow(gt.tensors, torch.from_numpy(roots),
                 generator=torch.Generator().manual_seed(s))
            for s in (3, 3))
    assert all(torch.equal(x.n_id, y.n_id) for x, y in zip(a, b))
    assert [blk.size for blk in a] == [(22, 30), (10, 22)]
    with pytest.raises(ValueError, match="2 uniform tuples"):
        flow(gt.tensors, torch.from_numpy(roots), uniforms=[None])


def test_flow_registry_matches_the_reference():
    assert set(jax_flows._FLOWS) == {"sage", "sample", "full", "gcn",
                                     "whole", "layerwise", "adapt", "fast"}
    for name, cls in jax_flows._FLOWS.items():
        assert get_flow_class(name).__name__ == cls.__name__, name
    with pytest.raises(KeyError):
        get_flow_class("neighbor")


# ------------------------------------------------------ shared-source block --

@pytest.fixture(scope="module")
def shared_blocks(pair, roots):
    """(port block, the port's block made irregular, the reference's
    block of the same arrays)."""
    _, gt = pair
    blk = LayerwiseDataFlow([6], [(0, 1)], candidates_per_node=CPN)(
        gt.tensors, torch.from_numpy(roots),
        generator=torch.Generator().manual_seed(11))[0]
    assert blk.shared_src and blk.mask.sum() > 0
    irregular = dataclasses.replace(blk, fanout=None, shared_src=False)
    ref = jax_block.Block(
        **{k: jnp.asarray(getattr(blk, k).numpy()) for k in BLOCK_FIELDS},
        size=blk.size, fanout=blk.fanout, self_loops=True, shared_src=True)
    return blk, irregular, ref


def _close(a, b):
    np.testing.assert_allclose(a.detach().numpy() if isinstance(
        a, torch.Tensor) else np.asarray(a), b.detach().numpy() if
        isinstance(b, torch.Tensor) else np.asarray(b), **TOL)


@pytest.mark.parametrize("path", ["gather_src", "gather_tgt", "scatter_add",
                                  "scatter_mean", "scatter_max", "softmax",
                                  "scatter_src_add", "aggregate_add",
                                  "aggregate_mean", "aggregate_max"])
def test_shared_src_paths_match_irregular_and_reference(shared_blocks, path):
    blk, irr, ref = shared_blocks
    rng = np.random.default_rng(3)
    E, (T, S) = blk.edge_index.shape[1], blk.size
    x = rng.normal(size=(S, 5)).astype(np.float32)
    v = rng.normal(size=(T, 5)).astype(np.float32)
    e = rng.normal(size=(E, 5)).astype(np.float32)
    scale = rng.normal(size=(E,)).astype(np.float32)

    def run(b, lib):
        arr = torch.from_numpy if lib == "torch" else jnp.asarray
        mask = b.mask
        if path == "gather_src":
            return b.gather_src(arr(x))
        if path == "gather_tgt":
            return b.gather_tgt(arr(v))
        if path.startswith("scatter_") and path != "scatter_src_add":
            return b.scatter(path[8:], arr(e), mask)
        if path == "softmax":
            return b.softmax(arr(e[:, 0]), mask)
        if path == "scatter_src_add":
            return b.scatter_src_add(arr(e), mask)
        op = path[10:]
        return b.aggregate_neighbors(op, arr(x), mask,
                                     arr(scale) if op != "max" else None)

    got = run(blk, "torch")
    _close(got, run(irr, "torch"))
    _close(got, run(ref, "jax"))


def test_relation_conv_over_a_shared_block(shared_blocks):
    """RelationConv takes the per-relation scatter on a shared-source
    block (the reference's ``not block.shared_src`` guard, convs.py:364),
    not the regular layout's per-target reshape of the source set."""
    blk, irr, ref = shared_blocks
    rng = np.random.default_rng(4)
    T, S = blk.size
    x = rng.normal(size=(S, 6)).astype(np.float32)
    attr = rng.integers(0, 3, blk.edge_index.shape[1]).astype(np.int32)
    conv = jax_convs.RelationConv(dim=4, num_relations=3)
    xj = jnp.asarray(x)
    variables = conv.init(jax.random.PRNGKey(0), (xj[:T], xj), ref,
                          edge_attr=jnp.asarray(attr))
    want = conv.apply(variables, (xj[:T], xj), ref,
                      edge_attr=jnp.asarray(attr))
    port = RelationConv(6, 4, num_relations=3)
    p = variables["params"]
    with torch.no_grad():
        port.matrix.copy_(torch.from_numpy(np.array(p["matrix"])))
        port.self_fc.weight.copy_(torch.from_numpy(
            np.array(p["Dense_0"]["kernel"]).T))
    xt = torch.from_numpy(x)
    for b in (blk, irr):
        _close(port((xt[:T], xt), b, edge_attr=torch.from_numpy(attr)), want)


# --------------------------------------------------------- GNNNet on top --

class Recording:
    """Wraps a JAX flow and keeps the keys it is called with."""

    def __init__(self, flow):
        self.flow, self.keys = flow, []

    def __call__(self, g, key, roots):
        self.keys.append(key)
        return self.flow(g, key, roots)


CONV_KW = {"relation": {"num_relations": 2}}


@pytest.mark.parametrize("conv,kind", [
    ("gcn", "layerwise"), ("gcn", "fast"), ("sage", "layerwise"),
    ("gat", "layerwise"), ("relation", "layerwise")])
def test_gnn_over_a_layerwise_flow_matches(pair, roots, conv, kind):
    """FastDataFlow is LayerwiseDataFlow at another weight function (its
    blocks are held bit for bit above), so it runs under gcn alone."""
    gj, gt = pair
    ours, theirs = FLOWS[kind]
    flow = Recording(theirs(SIZES, METAPATH, candidates_per_node=CPN))
    net = jax_gnn.GNNNet(
        conv=conv, flow=flow, dims=(8, 8, 8),
        feature=jax_encoders.ShallowEncoder(dense_names=("feature",)),
        conv_kwargs=CONV_KW.get(conv, {}))
    mj = jax_gnn.SuperviseModel(embedder=net, label_name="label",
                                label_dim=CLASSES)
    rj = jnp.asarray(roots)
    shapes = jax.eval_shape(mj.init, {"params": jax.random.PRNGKey(0),
                                      "sample": jax.random.PRNGKey(1)},
                            gj.tensors, rj)
    rng = np.random.default_rng(5)
    variables = jax.tree.map(lambda s: (rng.standard_normal(s.shape)
                                        * s.shape[-1] ** -0.5).astype(
        s.dtype), shapes)

    def loss_fn(p, g, r):
        flow.keys.clear()
        out = mj.apply(p, g, r, rngs={"sample": jax.random.PRNGKey(8)})
        return out["loss"], (out, flow.keys[0])

    (_, (want, key)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables, gj.tensors, rj)
    port_net = GNNNet(conv, ours(SIZES, METAPATH, candidates_per_node=CPN),
                      (8, 8, 8), ShallowEncoder(("feature",)), in_dim=FEAT,
                      device="cpu", conv_kwargs=CONV_KW.get(conv))
    mt = load_flax_params(SuperviseModel(port_net, "label", CLASSES,
                                         device="cpu"),
                          jax.tree.map(np.asarray, variables))
    u = flow_uniforms(key, len(roots))
    blocks = port_net.flow(gt.tensors, torch.from_numpy(roots), uniforms=u)
    frontier = torch.from_numpy(roots)
    for hop, blk in enumerate(blocks[::-1]):
        assert not near_tie(gt.tensors, frontier, METAPATH[hop], u[hop],
                            SIZES[hop], port_net.flow.weight_func)
        frontier = blk.n_id
    got = mt(gt.tensors, torch.from_numpy(roots), uniforms=u)
    for name in ("embedding", "logit", "label"):
        _close(got[name], want[name])
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               **TOL)
    got["loss"].backward()
    holder = load_flax_params(SuperviseModel(
        GNNNet(conv, ours(SIZES, METAPATH), (8, 8, 8),
               ShallowEncoder(("feature",)), in_dim=FEAT, device="cpu",
               conv_kwargs=CONV_KW.get(conv)), "label", CLASSES,
        device="cpu"), jax.tree.map(np.asarray, grads))
    want_g = dict(holder.named_parameters())
    for name, p in mt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want_g[name].detach().numpy(),
                                   err_msg=name, **TOL)
