"""Whole-graph GCN of the PyTorch port against euler_tpu, in f32 on the
CPU: the ``ell`` pack and the edge-list fields, ``get_full_neighbor``,
the blocks of ``WholeDataFlow`` (ELL pack, dynamic cap, edge list) and
``GCNDataFlow``, ``ell_expand`` and ``_ell_agg`` with their backward, the
irregular ``Block`` methods, ``GCNConv`` and whole models.

Graphs are built with the numpy CSR sort forced on both sides
(``native_off``), so that both hold the same tie order. Tolerances: equal
where nothing is summed; rtol = atol = 1e-5 for a conv or a block
reduction; the whole-model layout test keeps the reference's own
(tests/test_models.py:293-333: forward rtol 2e-5 / atol 2e-6, gradients
rtol 2e-4 / atol 2e-5). The gcn training step and the off-card bench
are in tests/test_torch_gcn_train.py.

Every reference call runs under one ``jax.jit``: one XLA compile per case
instead of one per primitive, which is most of these tests' time on the
CPU.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import block as jax_block
from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.models import convs as jax_convs
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu.ops import sampling as jax_sampling
from euler_tpu_torch.dataflow import (GCNDataFlow, WholeDataFlow,
                                      full_graph_block)
from euler_tpu_torch.dataflow import block as block_lib
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import (GCNConv, GNNNet, RelationConv,
                                    ShallowEncoder, load_flax_params)
from euler_tpu_torch.models.from_flax import load_conv
from euler_tpu_torch.ops import ell_agg as ell_agg_ops
from euler_tpu_torch.ops import sampling
from tests.test_torch_graph import native_off
from tests.test_torch_train import _as_port

TOL = dict(rtol=1e-5, atol=1e-5)
ELL_FIELDS = ("ell_nbr", "ell_w", "ell_eid", "ell_ty", "ell_tpos",
              "ell_in_deg")
EDGE_FIELDS = ("adj_src", "adj_dst", "adj_type", "adj_w", "adj_eid")
BLOCK_FIELDS = ("n_id", "res_n_id", "edge_index", "e_id", "edge_weight",
                "mask", "e_type", "src_deg", "ell_tpos")


def t(x):
    return torch.from_numpy(np.array(x))


def jit(fn, *args):
    """``fn(*args)`` compiled once by ``jax.jit``."""
    return jax.jit(fn)(*args)


@pytest.fixture(scope="module")
def toy_pair(toy_dir):
    with native_off():
        gj = jax_load_graph(toy_dir)
        gt = load_graph(toy_dir, packs=("fan", "ell"), device="cpu")
    return gj, gt


@pytest.fixture(scope="module")
def typed_pair():
    """300 nodes, 4 edge types, 16-wide features and 4 labels."""
    kw = dict(feat_dim=16, n_classes=4, num_edge_types=4, seed=3)
    with native_off():
        gj = jax_random_graph(300, 6, packs=("ell",), **kw)
        gt = random_graph(300, 6, packs=("ell",), device="cpu", **kw)
    return gj, gt


def assert_block_equal(bt, bj):
    assert bt.size == bj.size and bt.fanout == bj.fanout
    assert bt.self_loops == bj.self_loops
    for name in BLOCK_FIELDS:
        a, b = getattr(bt, name), getattr(bj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


# --------------------------------------------------------------- store --

@pytest.mark.parametrize("which", ["toy", "typed"])
def test_ell_and_edge_list_fields_equal(which, toy_pair, typed_pair):
    gj, gt = toy_pair if which == "toy" else typed_pair
    assert gt.tensors.ell_nbr is not None
    for name in ELL_FIELDS + EDGE_FIELDS:
        np.testing.assert_array_equal(getattr(gt.tensors, name).numpy(),
                                      np.asarray(getattr(gj.tensors, name)),
                                      err_msg=name)
    moved = gt.tensors.to("meta")
    assert all(getattr(moved, n).device.type == "meta"
               for n in ELL_FIELDS + EDGE_FIELDS)


def test_ell_pack_is_skipped_past_the_degree_gate():
    # a hub of degree 80 > max(64, 4 * average degree): no pack, as in the
    # reference
    n = 100
    src = np.concatenate([np.zeros(80, np.int32), np.arange(1, 41)])
    dst = np.concatenate([np.arange(1, 81), np.zeros(40, np.int32)])
    from euler_tpu.graph.store import _ell_pack_np as jax_pack
    from euler_tpu_torch.graph.store import _ell_pack_np
    gp = np.zeros(n + 1, np.int64)
    np.add.at(gp, src + 1, 1)
    gp = np.cumsum(gp)
    args = (n, 1, gp, dst[np.argsort(src, kind="stable")].astype(np.int32),
            np.ones(120, np.float32), np.arange(120, dtype=np.int32),
            np.zeros(120, np.int32))
    assert jax_pack(*args) is None and _ell_pack_np(*args) is None


# ------------------------------------------------------ full neighbors --

@pytest.mark.parametrize("edge_types", [(0,), (2, 0), (0, 1, 2, 3)])
@pytest.mark.parametrize("sorted_by_id,offset", [(False, 0), (True, 0),
                                                 (False, 3), (True, 5)])
def test_get_full_neighbor_matches(typed_pair, edge_types, sorted_by_id,
                                   offset):
    gj, gt = typed_pair
    nodes = np.arange(-2, 60, dtype=np.int32)
    nodes[10] = 299
    want = jit(lambda g, n: jax_sampling.get_full_neighbor(
        g, n, edge_types, 8, -1, sorted_by_id, offset),
        gj.tensors, jnp.asarray(nodes))
    got = sampling.get_full_neighbor(gt.tensors, torch.from_numpy(nodes),
                                     edge_types, 8, -1, sorted_by_id, offset)
    for name, a, b in zip(("nbr", "w", "type", "eid", "ok"), got, want):
        assert a.dtype == torch.from_numpy(np.array(b)).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    assert got[-1].any() and not got[-1].all()


def test_get_full_neighbor_clamps_nodes_past_the_graph(typed_pair):
    # XLA clamps the group index of a node >= N; torch would raise
    gj, gt = typed_pair
    nodes = np.array([0, 299, 300, 10_000], np.int32)
    want = jit(lambda g, n: jax_sampling.get_full_neighbor(g, n, (1, 3), 6),
               gj.tensors, jnp.asarray(nodes))
    got = sampling.get_full_neighbor(gt.tensors, torch.from_numpy(nodes),
                                     (1, 3), 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------------------- flows --

def _jax_whole(gj, layout, cap, drop_pack):
    g = gj.tensors
    if drop_pack:
        g = g.replace(**{n: None for n in ELL_FIELDS})
    return g, jax_flows.WholeDataFlow(2, [(0, 2)], cap=cap, layout=layout)


@pytest.mark.parametrize("layout,cap,drop_pack", [
    ("auto", None, False),          # the build-time pack
    ("ell", None, False),
    ("auto", 40, True),             # the dynamic cap, no pack
    ("edge_list", None, False),
    ("auto", None, True)])          # no pack, no cap: the edge list
def test_whole_flow_blocks_match(typed_pair, layout, cap, drop_pack):
    gj, gt = typed_pair
    g_j, flow_j = _jax_whole(gj, layout, cap, drop_pack)
    g_t = gt.tensors
    if drop_pack:
        g_t = dataclasses.replace(g_t, **{n: None for n in ELL_FIELDS})
    roots = np.arange(7, dtype=np.int32)
    want = jit(lambda g, r: flow_j(g, jax.random.PRNGKey(0), r), g_j,
               jnp.asarray(roots))
    got = WholeDataFlow(2, [(0, 2)], cap=cap, layout=layout)(
        g_t, torch.from_numpy(roots))
    assert len(got) == len(want) == 2 and got[0] is got[1]
    assert_block_equal(got[0], want[0])


def test_gcn_flow_blocks_match(typed_pair):
    gj, gt = typed_pair
    roots = np.array([3, -1, 7, 42, 299], np.int32)
    caps, path = [6, 4], [(0, 1), (3,)]
    want = jit(lambda g, r: jax_flows.GCNDataFlow(caps, path)(
        g, jax.random.PRNGKey(0), r), gj.tensors, jnp.asarray(roots))
    flow = GCNDataFlow(caps, path)
    got = flow(gt.tensors, torch.from_numpy(roots))
    assert flow.num_layers == 2 and len(got) == len(want)
    for bt, bj in zip(got, want):
        assert_block_equal(bt, bj)


def test_whole_flow_rejects_unknown_layouts():
    with pytest.raises(ValueError, match="layout"):
        WholeDataFlow(2, [(0,)], layout="csr")


# ---------------------------------------------- ELL autograd Functions --

@pytest.fixture(scope="module")
def ell_blocks(typed_pair):
    """(reference, port) ELL-pack blocks over edge types (0, 2): cells of
    the other types and past each row's degree are -1 pads."""
    gj, gt = typed_pair
    bj = jit(lambda g: jax_flows.WholeDataFlow(1, [(0, 2)])(
        g, jax.random.PRNGKey(0), jnp.arange(3))[0], gj.tensors)
    bt = WholeDataFlow(1, [(0, 2)])(gt.tensors, torch.arange(3))[0]
    assert (bt.n_id < 0).any() and bt.ell_tpos is not None
    return bj, bt


def test_ell_expand_forward_and_vjp_match(ell_blocks):
    bj, bt = ell_blocks
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    g = rng.normal(size=(bt.size[1], 5)).astype(np.float32)

    def ref(a, ga):
        out, vjp = jax.vjp(lambda z: jax_block.ell_expand(z, bj.n_id,
                                                          bj.ell_tpos), a)
        return out, vjp(ga)[0]
    out_j, gx_j = jit(ref, jnp.asarray(x), jnp.asarray(g))
    xt = t(x).requires_grad_(True)
    out_t = block_lib.ell_expand(xt, bt.n_id, bt.ell_tpos)
    (gx_t,) = torch.autograd.grad(out_t, xt, t(g))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), **TOL)


def _ell_args(bt, seed=1, D=4):
    rng = np.random.default_rng(seed)
    N = bt.size[0]
    C = bt.fanout
    nbr = bt.n_id[N:].reshape(N, C).numpy()
    return dict(x=rng.normal(size=(N, D)).astype(np.float32),
                w_s=(rng.random((N, C)) * (nbr >= 0)).astype(np.float32),
                w_l=rng.random(N).astype(np.float32), nbr=nbr,
                g=rng.normal(size=(N, D)).astype(np.float32))


def test_ell_agg_forward_and_vjp_match(ell_blocks):
    bj, bt = ell_blocks
    a = _ell_args(bt)
    C = bt.fanout
    diff = ("x", "w_s", "w_l")

    def ref(ins, g):
        out, vjp = jax.vjp(
            lambda x, ws, wl: jax_block._ell_agg(C, x, ws, wl,
                                                 jnp.asarray(a["nbr"]),
                                                 bj.ell_tpos), *ins)
        return out, vjp(g)
    out_j, grads_j = jit(ref, [jnp.asarray(a[k]) for k in diff],
                         jnp.asarray(a["g"]))
    ins = [t(a[k]).requires_grad_(True) for k in diff]
    out_t = block_lib._ell_agg(C, *ins, t(a["nbr"]), bt.ell_tpos)
    grads_t = torch.autograd.grad(out_t, ins, t(a["g"]))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **TOL)
    for k, gt_, gj_ in zip(diff, grads_t, grads_j):
        assert gt_.dtype == torch.float32
        np.testing.assert_allclose(gt_.numpy(), np.asarray(gj_),
                                   err_msg=k, **TOL)


def test_ell_agg_backward_computes_only_the_gradients_asked_for(
        ell_blocks, monkeypatch):
    # gcn's first layer: neither x (the feature table) nor the weights
    # (degrees and mask) take a gradient; its second: x only. The
    # recomputed [N, C, D] rows belong to grad_w_s alone (the plain
    # forward and the plain one-head ops.ell_sddmm both read
    # ops.ell_agg.ell_rows)
    _, bt = ell_blocks
    a = _ell_args(bt)
    calls = []
    real = ell_agg_ops.ell_rows
    monkeypatch.setattr(ell_agg_ops, "ell_rows",
                        lambda *z: calls.append(1) or real(*z))
    x = t(a["x"]).requires_grad_(True)
    w_s = t(a["w_s"])
    out = block_lib._ell_agg(bt.fanout, x, w_s, t(a["w_l"]), t(a["nbr"]),
                             bt.ell_tpos)
    assert len(calls) == 1                                   # the forward
    (gx,) = torch.autograd.grad(out, x, t(a["g"]))
    assert len(calls) == 1 and gx.shape == x.shape
    w_s.requires_grad_(True)
    out = block_lib._ell_agg(bt.fanout, x.detach(), w_s, t(a["w_l"]),
                             t(a["nbr"]), bt.ell_tpos)
    torch.autograd.grad(out, w_s, t(a["g"]))
    assert len(calls) == 3                          # forward + grad_w_s


def _old_ell_agg(x, w_s, w_l, nbr, tpos, C, g):
    """The forward and the x-gradient as ``_EllAgg`` computed them before
    ``ops.ell_agg``: the padded rows and batched products, written out."""
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    rows = xz[torch.where(nbr >= 0, nbr, x.shape[0]).long()]
    out = torch.einsum("tc,tcd->td", w_s.to(x.dtype), rows)
    out = out + x * w_l[:, None].to(x.dtype)
    n = g.shape[0]
    tp = tpos.long()
    gv = g[torch.div(tp, C, rounding_mode="floor").clamp(0, n - 1)]
    wv = torch.where(tpos >= 0,
                     w_s.reshape(-1)[tp.clamp(0, w_s.numel() - 1)], 0.0)
    grad_x = (torch.einsum("tc,tcd->td", wv.to(g.dtype), gv)
              + g * w_l[:, None].to(g.dtype)).to(x.dtype)
    return out, grad_x


ELL_WRAPPER_CASES = ("forward_f32", "transpose_f32", "forward_bf16",
                     "transpose_bf16", "function_bf16", "x_dtype", "x_rank",
                     "index_dtype", "index_rows", "weight_dtype",
                     "weight_shape", "device", "contiguous", "no_kernel")


@pytest.mark.parametrize("case", ELL_WRAPPER_CASES)
def test_ell_agg_wrapper(ell_blocks, case):
    # ops.ell_agg on the CPU is the plain version, which must equal the
    # formulas _EllAgg used before it bit for bit (the CUDA kernel is held
    # to it on the card); its checks raise on what the kernel does not
    # take, on every device
    _, bt = ell_blocks
    a = _ell_args(bt, seed=4, D=6)
    C, tpos = bt.fanout, bt.ell_tpos
    dt = torch.bfloat16 if case.endswith("bf16") else torch.float32
    x, g = t(a["x"]).to(dt), t(a["g"]).to(dt)
    w_s, w_l, nbr = t(a["w_s"]), t(a["w_l"]), t(a["nbr"])
    want_out, want_gx = _old_ell_agg(x, w_s, w_l, nbr, tpos, C, g)
    ell_agg = ell_agg_ops.ell_agg
    if case.startswith("forward"):
        got = ell_agg(x, nbr, w_s, w_l, C, False)
        assert got.dtype == dt and torch.equal(got, want_out)
        assert torch.equal(ell_agg_ops.ell_agg_plain(x, nbr, w_s, w_l, C,
                                                     False), want_out)
    elif case.startswith("transpose"):
        got = ell_agg(g, tpos, w_s, w_l, C, True)
        assert got.dtype == dt and torch.equal(got, want_gx)
    elif case == "function_bf16":
        xg = x.clone().requires_grad_(True)
        out = block_lib._ell_agg(C, xg, w_s, w_l, nbr, tpos)
        (gx,) = torch.autograd.grad(out, xg, g)
        assert torch.equal(out.detach(), want_out)
        assert gx.dtype == dt and torch.equal(gx, want_gx)
    elif case == "x_dtype":
        with pytest.raises(TypeError, match="f32 or bf16"):
            ell_agg(x.double(), nbr, w_s, w_l, C, False)
    elif case == "x_rank":
        with pytest.raises(TypeError, match="2-D"):
            ell_agg(x[:, :, None], nbr, w_s, w_l, C, False)
    elif case == "index_dtype":
        with pytest.raises(TypeError, match="int32"):
            ell_agg(x, nbr.long(), w_s, w_l, C, False)
    elif case == "index_rows":
        with pytest.raises(TypeError, match="int32"):
            ell_agg(x, nbr[:-1], w_s, w_l, C, False)
    elif case == "weight_dtype":
        with pytest.raises(TypeError, match="f32"):
            ell_agg(x, nbr, w_s.to(torch.bfloat16), w_l, C, False)
    elif case == "weight_shape":
        with pytest.raises(ValueError, match="do not fit"):
            ell_agg(x, nbr[:, :-1].contiguous(), w_s, w_l, C, False)
        with pytest.raises(ValueError, match="do not fit"):
            ell_agg(x, nbr, w_s, w_l[:-1], C, False)
    elif case == "device":
        with pytest.raises(ValueError, match="is on meta"):
            ell_agg(x, nbr.to("meta"), w_s, w_l, C, False)
    elif case == "contiguous":
        with pytest.raises(ValueError, match="x must be contiguous"):
            ell_agg(x.t().contiguous().t(), nbr, w_s, w_l, C, False)
        with pytest.raises(ValueError, match="index must be contiguous"):
            ell_agg(g, torch.cat([tpos, tpos], 1)[:, ::2], w_s, w_l, C,
                    True)
    else:
        # no kernel and no plain fallback for a device other than cpu or
        # cuda
        meta = [z.to("meta") for z in (x, nbr, w_s, w_l)]
        with pytest.raises(ValueError, match="no kernel"):
            ell_agg(*meta, C, False)


# ------------------------------------------------- irregular blocks --

@pytest.fixture(scope="module")
def edge_list_blocks(typed_pair):
    gj, gt = typed_pair
    bj = jit(lambda g: jax_block.full_graph_block(g, (1, 3)), gj.tensors)
    bt = full_graph_block(gt.tensors, (1, 3))
    assert_block_equal(bt, bj)
    assert bt.fanout is None and bool((bt.mask == 0).any())
    return bj, bt


@pytest.mark.parametrize("op", ["add", "mean", "max"])
@pytest.mark.parametrize("masked", [True, False])
def test_irregular_block_reductions_match(edge_list_blocks, op, masked):
    bj, bt = edge_list_blocks
    rng = np.random.default_rng(2)
    E = bt.edge_index.shape[1]
    e = rng.normal(size=(E, 3)).astype(np.float32)
    x = rng.normal(size=(bt.size[1], 3)).astype(np.float32)
    scale = rng.random((E, 1)).astype(np.float32)
    mt = bt.mask if masked else None
    want = jit(lambda b, e, x, s: (
        b.scatter(op, e, b.mask if masked else None),
        b.aggregate_neighbors(op, x, b.mask if masked else None, scale=s)),
        bj, *map(jnp.asarray, (e, x, scale)))
    np.testing.assert_allclose(bt.scatter(op, t(e), mt).numpy(),
                               np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(
        bt.aggregate_neighbors(op, t(x), mt, scale=t(scale)).numpy(),
        np.asarray(want[1]), **TOL)


def test_irregular_block_views_softmax_and_source_sums_match(
        edge_list_blocks):
    bj, bt = edge_list_blocks
    rng = np.random.default_rng(3)
    E, N = bt.edge_index.shape[1], bt.size[0]
    x = rng.normal(size=(N, 2)).astype(np.float32)
    scores = (rng.normal(size=(E, 2)) * 4).astype(np.float32)
    ones = np.ones((E, 1), np.float32)
    src, tgt, soft_m, soft, src_add = jit(lambda b, x, sc, o: (
        b.gather_src(x), b.gather_tgt(x), b.softmax(sc, b.mask),
        b.softmax(sc, None), b.scatter_src_add(o, b.mask)),
        bj, *map(jnp.asarray, (x, scores, ones)))
    np.testing.assert_array_equal(bt.gather_src(t(x)).numpy(),
                                  np.asarray(src))
    np.testing.assert_array_equal(bt.gather_tgt(t(x)).numpy(),
                                  np.asarray(tgt))
    for want, mt in ((soft_m, bt.mask), (soft, None)):
        got = bt.softmax(t(scores), mt).numpy()
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        assert np.isfinite(got).all()
    np.testing.assert_array_equal(
        bt.scatter_src_add(t(ones), bt.mask).numpy(), np.asarray(src_add))


def test_regular_block_max_and_source_sums_match():
    rng = np.random.default_rng(4)
    T, C = 10, 3
    targets = np.arange(T, dtype=np.int32)
    sampled = rng.integers(-1, 30, (T, C)).astype(np.int32)
    sampled[2] = -1                          # a target with no neighbor
    args = (targets, sampled, (sampled >= 0).astype(np.float32),
            np.full((T, C), -1, np.int32))

    def ref(args, e, loops):
        bj = jax_block.fanout_block(*args, C, loops)
        return [(bj.scatter("max", e, m), bj.scatter_src_add(e, m))
                for m in (bj.mask, None)]
    for loops in (True, False):
        bt = block_lib.fanout_block(*map(torch.from_numpy, args), C, loops)
        E = bt.edge_index.shape[1]
        e = rng.integers(-3, 3, (E, 2)).astype(np.float32)
        want = jit(lambda a, e: ref(a, e, loops),
                   [jnp.asarray(a) for a in args], jnp.asarray(e))
        for (w_max, w_src), mt in zip(want, (bt.mask, None)):
            np.testing.assert_array_equal(
                bt.scatter("max", t(e), mt).numpy(), np.asarray(w_max))
            np.testing.assert_array_equal(
                bt.scatter_src_add(t(e), mt).numpy(), np.asarray(w_src))


# --------------------------------------------------------------- convs --

def _flax_conv(conv, x, block):
    def ref(xj, block):
        xs = (xj[:block.size[0]], xj)
        params = conv.init(jax.random.PRNGKey(0), xs, block)
        return params, conv.apply(params, xs, block)
    return jit(ref, jnp.asarray(x), block)


@pytest.mark.parametrize("layout", ["ell", "edge_list"])
def test_gcn_conv_matches_flax(typed_pair, layout):
    gj, gt = typed_pair
    bj = jit(lambda g: jax_flows.WholeDataFlow(1, [(0, 2)], layout=layout)(
        g, jax.random.PRNGKey(0), jnp.arange(3))[0], gj.tensors)
    bt = WholeDataFlow(1, [(0, 2)], layout=layout)(gt.tensors,
                                                   torch.arange(3))[0]
    x = np.random.default_rng(5).normal(size=(300, 6)).astype(np.float32)
    params, want = _flax_conv(jax_convs.GCNConv(dim=4), x, bj)
    conv = GCNConv(6, 4)
    load_conv(conv, jax.tree.map(np.asarray, params["params"]))
    got = conv((t(x), t(x)), bt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_relation_conv_on_the_edge_list_matches_flax(typed_pair,
                                                     edge_list_blocks):
    bj, bt = edge_list_blocks
    x = np.random.default_rng(6).normal(size=(300, 5)).astype(np.float32)
    attr = np.asarray(bj.edge_index[1]) % 5 - 1            # -1 .. 3, clipped
    conv = jax_convs.RelationConv(dim=4, num_relations=3)

    def ref(xj, b, a):
        params = conv.init(jax.random.PRNGKey(0), (xj, xj), b, edge_attr=a)
        return params, conv.apply(params, (xj, xj), b, edge_attr=a)
    params, want = jit(ref, jnp.asarray(x), bj, jnp.asarray(attr))
    port = RelationConv(5, 4, num_relations=3)
    load_conv(port, jax.tree.map(np.asarray, params["params"]))
    got = port((t(x), t(x)), bt, edge_attr=t(attr))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------ whole models --

def _whole_model_parity(graphs, conv, feature, in_dim, metapath, layouts,
                        max_deg=None):
    """The port's GNNNet over each of ``layouts`` against the reference's
    edge-list GNNNet with the same flax weights: the forward, and the
    gradients of sum(out ** 2)."""
    gj, gt = graphs
    g = gj.tensors
    roots = jnp.arange(8, dtype=jnp.int32)
    base = jax_gnn.GNNNet(
        conv=conv, flow=jax_flows.WholeDataFlow(2, metapath,
                                                layout="edge_list"),
        dims=(16, 8),
        feature=jax_encoders.ShallowEncoder(dense_names=(feature,)))

    def ref(g, roots):
        params = base.init({"params": jax.random.PRNGKey(0),
                            "sample": jax.random.PRNGKey(1)}, g, roots)

        def loss(p):
            o = base.apply(p, g, roots,
                           rngs={"sample": jax.random.PRNGKey(2)})
            return jnp.sum(o * o), o
        return params, jax.value_and_grad(loss, has_aux=True)(params)
    params, ((_, want), grads) = jit(ref, g, roots)
    no_pack = dataclasses.replace(gt.tensors,
                                  **{n: None for n in ELL_FIELDS})
    kwargs = {"pack": ({}, gt.tensors),
              "dynamic": ({"cap": max_deg}, no_pack),
              "edge_list": ({"layout": "edge_list"}, gt.tensors)}
    for layout in layouts:
        kw, graph = kwargs[layout]
        net = GNNNet(conv, WholeDataFlow(2, metapath, **kw), (16, 8),
                     ShallowEncoder((feature,)), in_dim=in_dim,
                     device="cpu")
        load_flax_params(net, jax.tree.map(np.asarray, params))
        out = net(graph, torch.from_numpy(np.asarray(roots)))
        (out * out).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-6, err_msg=layout)
        g_want = _as_port(net, grads)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), g_want[name],
                                       rtol=2e-4, atol=2e-5,
                                       err_msg=f"{layout} {name}")


@pytest.mark.parametrize("conv", ["gcn", "sage"])
def test_whole_ell_matches_edge_list_whole(toy_pair, conv):
    # tests/test_models.py::test_whole_ell_matches_edge_list_whole, with
    # each of the port's layouts held against the reference's edge list
    gp = np.asarray(toy_pair[0].tensors.group_ptr)
    max_deg = int((gp[1:] - gp[:-1]).reshape(-1, 2).sum(1).max())
    _whole_model_parity(toy_pair, conv, "dense2", 2, [(0, 1)],
                        ("pack", "dynamic", "edge_list"), max_deg)


def test_gat_over_the_edge_list_matches(typed_pair):
    # the irregular block softmax under GATConv, on features of unit scale
    # (the toy graph's 100-wide features saturate every softmax)
    _whole_model_parity(typed_pair, "gat", "feature", 16, [(0, 1, 2, 3)],
                        ("edge_list", "pack"))


def test_whole_flow_picks_the_roots_rows(typed_pair):
    gj, gt = typed_pair
    roots = np.array([5, -1, 299, 0, 17], np.int32)
    net = jax_gnn.GNNNet(
        conv="gcn", flow=jax_flows.WholeDataFlow(2, [(0, 1, 2, 3)]),
        dims=(8, 4),
        feature=jax_encoders.ShallowEncoder(dense_names=("feature",)))

    def ref(g, r):
        v = net.init({"params": jax.random.PRNGKey(3),
                      "sample": jax.random.PRNGKey(1)}, g, r)
        return v, net.apply(v, g, r, rngs={"sample": jax.random.PRNGKey(2)})
    v, want = jit(ref, gj.tensors, jnp.asarray(roots))
    port = GNNNet("gcn", WholeDataFlow(2, [(0, 1, 2, 3)]), (8, 4),
                  ShallowEncoder(("feature",)), in_dim=16, device="cpu")
    load_flax_params(port, jax.tree.map(np.asarray, v))
    with torch.no_grad():
        got = port(gt.tensors, torch.from_numpy(roots))
    assert got.shape == (5, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
