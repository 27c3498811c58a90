"""The eight other convs of the registry (TAG, SGCN, AGNN, APPNP,
Graph, ARMA, DNA, Gated) of the PyTorch port against euler_tpu, in f32 on
the CPU.

- Each conv, with its flax parameters loaded, on the regular fanout block
  (masked, with and without self loops), the irregular edge-list block
  and the compact whole-graph ELL block: the forward within rtol = 2e-5,
  atol = 2e-6 (tests/test_models.py:329's tolerance), and the gradient
  of ``sum(out * cot)`` with respect to every parameter and to the input
  within rtol = atol = 1e-4.
- The numpy goldens of tests/test_parity.py:130-317, re-derived from the
  reference formulas, as a second reference (rtol 1e-4, atol 1e-5).
- flax's GRU cell and its parameter layout; AGNN's gradient at a zero
  row, pinned on both sides; each conv's flax tree loads by name.

Every reference case runs under one ``jax.jit`` (init, apply and grad
together), cached per case for the file.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from euler_tpu.dataflow import block as jax_block
from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.models import convs as jax_convs
from euler_tpu_torch.dataflow import WholeDataFlow, fanout_block
from euler_tpu_torch.dataflow import full_graph_block
from euler_tpu_torch.dataflow.block import Block
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.models import convs, get_conv_class
from euler_tpu_torch.models.from_flax import load_conv
from tests.test_torch_graph import native_off

FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
GOLDEN_TOL = dict(rtol=1e-4, atol=1e-5)
T, C, D_IN = 12, 3, 6

# (case id, registry name, dim, conv kwargs): the reference's defaults,
# plus the options that take another path (several hops, several heads,
# ARMA's recursion, shared weights, Gated without its projection)
CASES = [
    ("tag", "tag", 4, {}),
    ("tagcn_K1", "tagcn", 4, {"K": 1}),
    ("sgcn", "sgcn", 4, {}),
    ("sgcn_K2", "sgcn", 4, {"K": 2}),
    ("agnn", "agnn", 4, {}),
    ("appnp", "appnp", 4, {}),
    ("graph", "graph", 4, {}),
    ("arma", "arma", 4, {}),
    ("arma_T2", "arma", 4, {"T": 2}),
    ("arma_shared", "arma", 2, {"K": 3, "T": 2, "shared_weights": True}),
    ("dna", "dna", 4, {}),
    ("dna_heads2", "dna", 4, {"heads": 2}),
    ("gated", "gated", 4, {}),
    ("gated_graph_nodproj", "gated_graph", D_IN, {"processing_steps": 3}),
]
LAYOUTS = ["regular_loops", "regular", "edge_list", "ell"]


def t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def whole_pair():
    """(reference graph, port graph): 300 nodes, 4 edge types, the ELL
    pack, the numpy CSR sort on both sides."""
    kw = dict(num_edge_types=4, seed=3, packs=("ell",))
    with native_off():
        return (jax_random_graph(300, 6, **kw),
                random_graph(300, 6, device="cpu", **kw))


@functools.lru_cache(maxsize=None)
def blocks(layout):
    """(reference Block, port Block, source rows) of ``layout``."""
    if layout.startswith("regular"):
        rng = np.random.default_rng(0)
        targets = np.arange(T, dtype=np.int32)
        sampled = rng.integers(-1, 40, (T, C)).astype(np.int32)
        targets[0], sampled[0] = -1, -1      # a dead target
        sampled[1] = -1                      # a live target, no neighbor
        args = (targets, sampled, (sampled >= 0).astype(np.float32),
                np.full((T, C), -1, np.int32))
        loops = layout == "regular_loops"
        bj = jax_block.fanout_block(*map(jnp.asarray, args), C, loops)
        bt = fanout_block(*map(torch.from_numpy, args), C, loops)
        return bj, bt, bt.size[1]
    gj, gt = whole_pair()
    if layout == "edge_list":
        bj = jax.jit(lambda g: jax_block.full_graph_block(g, (1, 3)))(
            gj.tensors)
        bt = full_graph_block(gt.tensors, (1, 3))
    else:
        bj = jax.jit(lambda g: jax_flows.WholeDataFlow(1, [(0, 2)])(
            g, jax.random.PRNGKey(0), jnp.arange(3))[0])(gj.tensors)
        bt = WholeDataFlow(1, [(0, 2)])(gt.tensors, torch.arange(3))[0]
        assert bt.ell_tpos is not None and bool((bt.n_id < 0).any())
    return bj, bt, bt.size[0]


def inputs(rows, out_shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, D_IN)).astype(np.float32)
    cot = rng.normal(size=out_shape).astype(np.float32)
    return x, cot


@functools.lru_cache(maxsize=None)
def reference(case, layout):
    """The reference's (params, out, param grads, x grad) of one case,
    one jit, and the port conv with those parameters loaded, and x, cot."""
    _, name, dim, kw = next(c for c in CASES if c[0] == case)
    bj, bt, rows = blocks(layout)
    port = get_conv_class(name)(D_IN, dim, **kw)
    x, cot = inputs(rows, (bt.size[0], port.out_dim), seed=len(case))
    conv = jax_convs.get_conv_class(name)(dim=dim, **kw)

    def run(xj, cj, b):
        n = b.size[0]
        params = conv.init(jax.random.PRNGKey(1), (xj[:n], xj), b)

        def loss(p, z):
            return jnp.sum(conv.apply(p, (z[:n], z), b) * cj)
        out = conv.apply(params, (xj[:n], xj), b)
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, xj)
        return params, out, gp, gx
    params, out, gp, gx = jax.jit(run)(jnp.asarray(x), jnp.asarray(cot), bj)
    load_conv(port, jax.tree.map(np.asarray, params.get("params", {})))
    return port, bt, x, cot, np.asarray(out), gp, np.asarray(gx)


def _port_grads(port, tree):
    """A flax-layout gradient tree in the port's parameter names."""
    twin = copy.deepcopy(port)
    load_conv(twin, jax.tree.map(np.asarray, tree.get("params", {})))
    return dict(twin.named_parameters())


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_conv_forward_and_gradients_match(case, layout):
    port, bt, x, cot, want, gp, gx = reference(case, layout)
    xt = t(x).requires_grad_(True)
    n = bt.size[0]
    out = port((xt[:n], xt), bt)
    np.testing.assert_allclose(out.detach().numpy(), want, **FWD_TOL)
    (out * t(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx, err_msg="x",
                               **GRAD_TOL)
    want_g = _port_grads(port, gp)
    names = [k for k, _ in port.named_parameters()]
    assert names == list(want_g)
    for k, p in port.named_parameters():
        assert p.grad is not None, k
        np.testing.assert_allclose(p.grad.numpy(),
                                   want_g[k].detach().numpy(), err_msg=k,
                                   **GRAD_TOL)


def test_registry_resolves_every_reference_name():
    assert set(convs._CONVS) == set(jax_convs._CONVS)
    for name, cls in jax_convs._CONVS.items():
        assert get_conv_class(name).__name__ == cls.__name__, name


@pytest.mark.parametrize("name", ["agnn", "appnp"])
def test_propagation_convs_keep_their_input_width(name):
    conv = get_conv_class(name)(4, 16)
    assert conv.out_dim == 4
    assert get_conv_class("tag")(4, 16).out_dim == 16


def test_gated_projects_only_when_widths_differ():
    assert convs.GatedConv(6, 4).proj is not None
    assert convs.GatedConv(4, 4).proj is None


# ------------------------------------------------------------- goldens --
# tests/test_parity.py's fixed block: 3 targets, 5 sources (targets are
# sources 0..2), 6 real edges and 1 masked one

G_DST = np.array([0, 0, 1, 1, 2, 2, 2], np.int32)
G_SRC = np.array([3, 4, 0, 3, 1, 4, 2], np.int32)
G_MASK = np.array([1, 1, 1, 1, 1, 1, 0], np.float32)
G_T, G_S, G_D = 3, 5, 2
G_RNG = np.random.default_rng(7)
G_X = G_RNG.normal(size=(G_S, G_D)).astype(np.float32)
G_EDGES = [(d, s) for d, s, m in zip(G_DST, G_SRC, G_MASK) if m > 0]


def golden_block():
    return Block(n_id=torch.arange(G_S, dtype=torch.int32),
                 res_n_id=torch.arange(G_T, dtype=torch.int32),
                 edge_index=t(np.stack([G_DST, G_SRC])),
                 e_id=torch.full((7,), -1, dtype=torch.int32),
                 edge_weight=torch.ones(7), mask=t(G_MASK), size=(G_T, G_S))


def golden_apply(conv):
    x = t(G_X)
    with torch.no_grad():
        return conv((x[:G_T], x), golden_block()).numpy()


def set_linear(lin, kernel, bias=None):
    with torch.no_grad():
        lin.weight.copy_(t(kernel).T)
        if bias is not None:
            lin.bias.copy_(t(bias))


def sym_hop(h):
    """sum over real edges of h[s] / sqrt(deg_t[d] deg_s[s])."""
    dt, ds = np.zeros(G_T), np.zeros(G_S)
    for d, s in G_EDGES:
        dt[d] += 1
        ds[s] += 1
    out = np.zeros((G_T, h.shape[1]))
    for d, s in G_EDGES:
        out[d] += h[s] / np.sqrt(dt[d] * ds[s])
    return out


def per_target_mean(h):
    out, cnt = np.zeros((G_T, h.shape[1])), np.zeros(G_T)
    for d, s in G_EDGES:
        out[d] += h[s]
        cnt[d] += 1
    return out / np.maximum(cnt, 1)[:, None]


def golden(name, rng):
    """(port conv with golden weights, numpy output) of tests/
    test_parity.py's golden of ``name``."""
    D = G_D
    if name == "tag":
        conv, W = convs.TAGConv(D, D, K=1), rng.normal(size=(2 * D, D))
        set_linear(conv.fc, W)
        return conv, np.concatenate([G_X[:G_T], sym_hop(G_X)], 1) @ W
    if name == "sgcn":
        conv, W = convs.SGCNConv(D, D, K=1), rng.normal(size=(D, D))
        set_linear(conv.fc, W)
        return conv, sym_hop(G_X) @ W
    if name == "appnp":
        conv = convs.APPNPConv(D, D, K=1, alpha=0.25)
        return conv, 0.75 * sym_hop(G_X) + 0.25 * G_X[:G_T]
    if name == "agnn":
        conv, beta = convs.AGNNConv(D, D), 1.7
        conv.beta.data.fill_(beta)
        xn = G_X / np.linalg.norm(G_X, axis=1, keepdims=True)
        want = np.zeros((G_T, D))
        for tg in range(G_T):
            es = [s for d, s in G_EDGES if d == tg]
            sc = np.array([beta * xn[tg] @ xn[s] for s in es])
            a = np.exp(sc - sc.max())
            want[tg] = sum(w * G_X[s] for w, s in zip(a / a.sum(), es))
        return conv, want
    if name == "graph":
        conv = convs.GraphConv(D, D)
        k0, k1, b1 = (rng.normal(size=(D, D)), rng.normal(size=(D, D)),
                      rng.normal(size=D))
        set_linear(conv.src_fc, k0)
        set_linear(conv.self_fc, k1, b1)
        return conv, G_X[:G_T] @ k1 + b1 + per_target_mean(G_X @ k0)
    if name == "arma":
        conv = convs.ARMAConv(D, D, K=1, T=1)
        Wk, Vk = rng.normal(size=(D, D)), rng.normal(size=(D, D))
        set_linear(conv.ws[0], Wk)
        set_linear(conv.vs[0], Vk)
        return conv, np.maximum(sym_hop(G_X @ Wk) + G_X[:G_T] @ Vk, 0)
    if name == "dna":
        conv = convs.DNAConv(D, D, heads=1)
        W1, Wq, Wk, Wv = (rng.normal(size=(D, D)) for _ in range(4))
        bq, bk, bv = (rng.normal(size=D) for _ in range(3))
        for lin, k, b in ((conv.in_fc, W1, None), (conv.q, Wq, bq),
                          (conv.k, Wk, bk), (conv.v, Wv, bv)):
            set_linear(lin, k, b)
        h = G_X @ W1
        q, k, v = h @ Wq + bq, h @ Wk + bk, h @ Wv + bv
        want = np.zeros((G_T, D))
        for tg in range(G_T):
            msgs = [v[s] / (1 + np.exp(-(q[tg] @ k[s]) / np.sqrt(D)))
                    for d, s in G_EDGES if d == tg]
            want[tg] = np.mean(msgs, axis=0)
        return conv, want
    assert name == "gated"
    conv = convs.GatedConv(D, D, processing_steps=1)
    Wfc = rng.normal(size=(D, D))
    set_linear(conv.fcs[0], Wfc)
    gates = {k: (rng.normal(size=(D, D)), rng.normal(size=D))
             for k in ("ir", "iz", "in", "hr", "hz", "hn")}
    for k, (w, b) in gates.items():
        set_linear(conv.gru.gates[k], w,
                   b if conv.gru.gates[k].bias is not None else None)
    aggr = np.zeros((G_T, D))
    for d, s in G_EDGES:
        aggr[d] += (G_X @ Wfc)[s]
    h = G_X[:G_T]

    def lin(k, v, bias=True):
        w, b = gates[k]
        return v @ w + (b if bias else 0)

    def sig(v):
        return 1 / (1 + np.exp(-v))
    r = sig(lin("ir", aggr) + lin("hr", h, False))
    z = sig(lin("iz", aggr) + lin("hz", h, False))
    n = np.tanh(lin("in", aggr) + r * lin("hn", h))
    return conv, (1 - z) * n + z * h


@pytest.mark.parametrize("name", ["tag", "sgcn", "agnn", "appnp", "graph",
                                  "arma", "dna", "gated"])
def test_numpy_goldens(name):
    conv, want = golden(name, np.random.default_rng(11))
    np.testing.assert_allclose(golden_apply(conv), want, **GOLDEN_TOL)


# ----------------------------------------------------------------- GRU --

def test_gru_cell_matches_flax_and_has_its_layout():
    rng = np.random.default_rng(4)
    h, xin = (rng.normal(size=(7, 5)).astype(np.float32) for _ in range(2))
    cot = rng.normal(size=(7, 5)).astype(np.float32)
    cell = flax_nn.GRUCell(features=5)

    def run(h, x):
        p = cell.init(jax.random.PRNGKey(2), h, x)

        def loss(p, h, x):
            return jnp.sum(cell.apply(p, h, x)[0] * cot)
        return p, cell.apply(p, h, x)[0], jax.grad(loss, (0, 1, 2))(p, h, x)
    p, want, (gp, gh, gx) = jax.jit(run)(jnp.asarray(h), jnp.asarray(xin))
    tree = jax.tree.map(np.asarray, p["params"])
    assert {k: set(v) for k, v in tree.items()} == {
        "ir": {"kernel", "bias"}, "iz": {"kernel", "bias"},
        "in": {"kernel", "bias"}, "hn": {"kernel", "bias"},
        "hr": {"kernel"}, "hz": {"kernel"}}
    port = convs.GRUCell(5, 5)
    assert {k for k, _ in port.named_parameters()} == {
        f"gates.{g}.{w}" for g, v in tree.items() for w in
        (("weight", "bias") if "bias" in v else ("weight",))}
    for g, lin in port.gates.items():
        lin.weight.data.copy_(t(tree[g]["kernel"]).T)
        if lin.bias is not None:
            lin.bias.data.copy_(t(tree[g]["bias"]))
    ht, xt = t(h).requires_grad_(True), t(xin).requires_grad_(True)
    got = port(ht, xt)                             # flax's cell(carry, x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    (got * t(cot)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), **GRAD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    for g, lin in port.gates.items():
        np.testing.assert_allclose(lin.weight.grad.numpy(),
                                   np.asarray(gp["params"][g]["kernel"]).T,
                                   err_msg=g, **GRAD_TOL)


def test_gru_cell_initialises_as_flax():
    port = convs.GRUCell(64, 64, generator=torch.Generator().manual_seed(0))
    for g in ("hr", "hz", "hn"):
        w = port.gates[g].weight.detach()
        np.testing.assert_allclose((w @ w.T).numpy(), np.eye(64), atol=1e-5)
    for g in ("ir", "iz", "in"):
        np.testing.assert_allclose(
            float(port.gates[g].weight.detach().std()), 64 ** -0.5, rtol=0.05)
    for g in ("ir", "iz", "in", "hn"):
        assert not port.gates[g].bias.any()
    assert port.gates["hr"].bias is None and port.gates["hz"].bias is None


# ------------------------------------------------------ AGNN zero row --

def test_agnn_l2norm_gradient_at_a_zero_row_is_pinned():
    """The reference's gradient at a zero row is NaN (jnp.linalg.norm's
    sqrt at 0); the port's clamp gives 1e12 times the cotangent. Neither
    is 'fixed': padded rows' cotangents die at the previous relu."""
    v = np.array([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0]], np.float32)
    cot = np.array([[0.0, 1.0, 2.0], [1.0, 1.0, 1.0]], np.float32)
    gj = jax.grad(lambda z: jnp.sum(jax_convs._l2norm(z) * cot))(
        jnp.asarray(v))
    gj = np.asarray(gj)
    assert np.isnan(gj[0]).all()
    vt = t(v).requires_grad_(True)
    (convs._l2norm(vt) * t(cot)).sum().backward()
    np.testing.assert_allclose(vt.grad[0].numpy(), [0.0, 1e12, 2e12],
                               rtol=1e-6)
    np.testing.assert_allclose(vt.grad[1].numpy(), gj[1], rtol=1e-6)
    np.testing.assert_array_equal(
        convs._l2norm(t(v)).numpy(), np.asarray(jax_convs._l2norm(
            jnp.asarray(v))))
