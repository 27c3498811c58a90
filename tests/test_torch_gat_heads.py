"""Multi-head GAT of the PyTorch port on the CPU: ``GATConv(heads=H)``
over the whole-graph ELL block (the plain versions of the attention
kernels) against the benchmark's plain reference
(benchmark/reference/gat.py: the paper's layer over the edge list with
self loops), the block layouts against each other for heads 1, 2 and 3,
with and without self loops, the plain versions of ``ops.ell_attn``
against their definitions written out, ``_ell_agg``'s weight gradient,
the wrappers' checks and the ``attention`` spans; and GAT's fused
attention (``_EllGat`` through the plain versions of
``ops.ell_attn.ell_gat``, ``ell_gat_sddmm`` and ``ell_gat_tr``) against
the unfused chain (``Block.softmax`` and the per-head aggregate
``ell_attn_plain`` under autograd), and where ``GATConv`` takes it. The
kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py).

Tolerances: f32 throughout (but the fused attention's bf16 cases, whose
bounds their test states); rtol = atol = 1e-5 between two sums of the
same terms in other orders (layouts, definitions), and the forward within
2e-5 / gradients within 2e-4 of the reference (another order of the whole
model, as tests/test_torch_whole.py holds whole models).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from benchmark.reference import gat as ref_gat
from benchmark.reference.gnn import sigmoid_xent_loss
from euler_tpu_torch.dataflow import WholeDataFlow
from euler_tpu_torch.dataflow import block as block_lib
from euler_tpu_torch.dataflow.block import fanout_block
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.models import (GATConv, GNNNet, ShallowEncoder,
                                    SuperviseModel)
from euler_tpu_torch.ops import ell_agg as ell_agg_ops
from euler_tpu_torch.ops import ell_attn as attn
from euler_tpu_torch.utils import trace

TOL = dict(rtol=1e-5, atol=1e-5)
ELL_FIELDS = ("ell_nbr", "ell_w", "ell_eid", "ell_ty", "ell_tpos",
              "ell_in_deg")


@pytest.fixture(scope="module")
def graph():
    """300 nodes, one edge type, 16-wide features and 4 labels."""
    return random_graph(300, 6, feat_dim=16, n_classes=4, seed=3,
                        packs=("ell",), device="cpu")


def model(heads: int, dims=(24, 24), **flow_kw):
    net = GNNNet("gat", WholeDataFlow(len(dims), [(0,)], **flow_kw), dims,
                 ShallowEncoder(("feature",)), in_dim=16,
                 generator=torch.Generator().manual_seed(0), device="cpu",
                 conv_kwargs={"heads": heads})
    return SuperviseModel(net, "label", 4, device="cpu",
                          generator=torch.Generator().manual_seed(1))


def reference_weights(m) -> dict:
    """The reference's weights (benchmark/configs/gat.py's names) from
    the port model's parameters, as leaves of their own."""
    net = m.embedder
    w = {"out.w": net.out_fc.weight, "out.b": net.out_fc.bias,
         "head.w": m.head_fc.weight}
    for i, conv in enumerate(net.convs):
        w[f"l{i}.fc"] = conv.fc.weight
        w[f"l{i}.attn_l"], w[f"l{i}.attn_r"] = conv.attn_l, conv.attn_r
    return {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}


@pytest.mark.parametrize("heads", [2, 3])
def test_multi_head_gat_matches_the_plain_reference(graph, heads):
    """The port's GNNNet and SuperviseModel over the ELL pack (the plain
    versions of GAT's fused kernels) against ``reference/gat.py`` on the
    same weights: embeddings of every node, the loss over 100 roots and
    every parameter's gradient."""
    g = graph.tensors
    m = model(heads)
    roots = torch.arange(100, dtype=torch.int32)
    out = m(g, roots)
    out["loss"].backward()
    w = reference_weights(m)
    ok = g.adj_type == 0
    src, dst = g.adj_src[ok].long(), g.adj_dst[ok].long()
    emb = ref_gat.gat_embed(w, g.dense_nf["feature"], src, dst, 2, heads)
    label = g.dense_nf["label"][:100].to(torch.float32)
    loss = sigmoid_xent_loss(emb[:100] @ w["head.w"].T, label,
                             torch.ones(100, dtype=torch.bool))
    loss.backward()
    np.testing.assert_allclose(out["embedding"].detach().numpy(),
                               emb[:100].detach().numpy(), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(float(out["loss"].detach()),
                               float(loss.detach()), rtol=2e-5)
    params = dict(m.named_parameters())
    names = {"out.w": "embedder.out_fc.weight",
             "out.b": "embedder.out_fc.bias", "head.w": "head_fc.weight"}
    for i in range(2):
        names.update({f"l{i}.fc": f"embedder.convs.{i}.fc.weight",
                      f"l{i}.attn_l": f"embedder.convs.{i}.attn_l",
                      f"l{i}.attn_r": f"embedder.convs.{i}.attn_r"})
    assert set(names.values()) == set(params)
    for k, name in names.items():
        np.testing.assert_allclose(params[name].grad.numpy(),
                                   w[k].grad.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def _run(m, g, roots):
    out = m(g, roots)["loss"]
    out.backward()
    return float(out.detach()), {k: p.grad.clone()
                                 for k, p in m.named_parameters()}


@pytest.mark.parametrize(
    "heads,add_self_loops",
    [(1, True), (2, True), (3, True), (1, False), (2, False), (3, False)],
    ids=["1", "2", "3", "1-no_loops", "2-no_loops", "3-no_loops"])
def test_whole_graph_layouts_agree(graph, heads, add_self_loops):
    """The ELL pack (the compact table: GAT's fused attention at H > 1
    with self loops, ``_ell_agg`` at one head, the expanded source set at
    H > 1 without), the dynamic layout (a regular fanout block over the
    expanded source set) and the edge list (an irregular block) give one
    loss and one gradient from the same weights."""
    g = graph.tensors
    roots = torch.arange(300, dtype=torch.int32)
    deg = int(torch.bincount(g.adj_src.long(), minlength=300).max())
    no_pack = dataclasses.replace(g, **{n: None for n in ELL_FIELDS})
    kw = dict(add_self_loops=add_self_loops)
    runs = {"pack": _run(model(heads, **kw), g, roots),
            "dynamic": _run(model(heads, cap=deg, **kw), no_pack, roots),
            "edge_list": _run(model(heads, layout="edge_list", **kw), g,
                              roots)}
    loss, grads = runs["pack"]
    for name in ("dynamic", "edge_list"):
        np.testing.assert_allclose(runs[name][0], loss, **TOL)
        for k, v in grads.items():
            np.testing.assert_allclose(runs[name][1][k].numpy(), v.numpy(),
                                       err_msg=f"{name} {k}", **TOL)


@pytest.mark.parametrize("heads", [1, 2, 3])
def test_sampled_block_equals_its_irregular_twin(heads):
    """A sampled hop's fanout block (some draws -1) and the same edges as
    an irregular block (``fanout`` None: ``mp_ops`` gathers, scatters and
    the masked scatter softmax) give one output and one gradient."""
    rng = np.random.default_rng(heads)
    T, count = 40, 5
    targets = torch.arange(T, dtype=torch.int32)
    sampled = torch.from_numpy(rng.integers(0, 200, (T, count))
                               .astype(np.int32))
    sampled[rng.random((T, count)) < 0.3] = -1
    sampled[0] = -1                             # a row of its self loop
    blk = fanout_block(targets, sampled, torch.ones((T, count)),
                       torch.zeros((T, count), dtype=torch.int32), count)
    twin = dataclasses.replace(blk, fanout=None)
    x = torch.from_numpy(rng.normal(size=(blk.size[1], 12))
                         .astype(np.float32))
    outs = []
    for b in (blk, twin):
        conv = GATConv(12, 6 * heads, heads=heads,
                       generator=torch.Generator().manual_seed(0))
        xs = x.clone().requires_grad_(True)
        out = conv((xs[:T], xs), b)
        (out * out).sum().backward()
        outs.append((out.detach(), xs.grad,
                     {k: p.grad for k, p in conv.named_parameters()}))
    (o1, gx1, gp1), (o2, gx2, gp2) = outs
    np.testing.assert_allclose(o2.numpy(), o1.numpy(), **TOL)
    np.testing.assert_allclose(gx2.numpy(), gx1.numpy(), **TOL)
    for k in gp1:
        np.testing.assert_allclose(gp2[k].numpy(), gp1[k].numpy(),
                                   err_msg=k, **TOL)


def test_gat_conv_arguments():
    conv = GATConv(8, 12, heads=3)
    assert conv.out_dim == 12 and tuple(conv.attn_l.shape) == (3, 4)
    assert {n for n, _ in conv.named_parameters()} == {
        "fc.weight", "attn_l", "attn_r"}
    assert {n for n, _ in GATConv(8, 12).named_parameters()} == {
        "fc.weight", "a1.weight", "a2.weight"}
    with pytest.raises(ValueError, match="multiple of heads"):
        GATConv(8, 10, heads=3)
    with pytest.raises(ValueError, match="single-head"):
        GATConv(8, 12, improved=True, heads=3)


# ---------------------------------------------- ops.ell_attn's plain --

def attn_case(N=8, C=4, H=2, F=3, seed=0):
    """Rows x and a cotangent g [N, H * F]; nbr [N, C] with row 0 all pads
    (its self loop alone), row 1's live cells weighted 0 (a masked row),
    pads interleaved elsewhere; tpos [N, C_in] the transpose positions of
    every live cell, pads interleaved; weights w_s [N, C, H] (0 at pads)
    and w_l [N, H]."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, N, (N, C)).astype(np.int32)
    nbr[rng.random((N, C)) < 0.35] = -1
    nbr[0] = -1
    nbr[1, :2] = (2, 3)
    into = [[] for _ in range(N)]
    for p in np.flatnonzero(nbr.reshape(-1) >= 0):
        into[nbr.flat[p]].append(p)
    C_in = max(len(c) for c in into) + 2
    tpos = np.full((N, C_in), -1, np.int32)
    for u, cells in enumerate(into):
        tpos[u, np.sort(rng.choice(C_in, len(cells), replace=False))] = cells
    w_s = (rng.random((N, C, H)) * (nbr >= 0)[..., None]).astype(np.float32)
    w_s[1] = 0.0
    w_l = rng.random((N, H)).astype(np.float32)
    x, g = (torch.from_numpy(rng.normal(size=(N, H * F)).astype(np.float32))
            for _ in range(2))
    return dict(x=x, g=g, nbr=torch.from_numpy(nbr),
                tpos=torch.from_numpy(tpos), w_s=torch.from_numpy(w_s),
                w_l=torch.from_numpy(w_l), N=N, C=C, H=H, F=F)


def definition(a, x, transpose):
    """The aggregate written out cell by cell in f64: [N, H, F]."""
    N, C, H, F = a["N"], a["C"], a["H"], a["F"]
    xv = x.double().reshape(N, H, F)
    out = xv * a["w_l"].double()[..., None]
    index = a["tpos"] if transpose else a["nbr"]
    for t in range(N):
        for c in range(index.shape[1]):
            v = int(index[t, c])
            if v < 0:
                continue
            if transpose:
                u, w = v // C, a["w_s"].reshape(-1, H)[v]
            else:
                u, w = v, a["w_s"][t, c]
            out[t] += xv[u] * w.double()[:, None]
    return out


@pytest.mark.parametrize("transpose", [False, True])
def test_ell_attn_plain_matches_its_definition(transpose):
    a = attn_case()
    x = a["g"] if transpose else a["x"]
    index = a["tpos"] if transpose else a["nbr"]
    xp = attn.pad_heads(x, a["H"])
    assert tuple(xp.shape) == (8, 2, 4) and bool((xp[..., 3:] == 0).all())
    want = definition(a, x, transpose)
    for padded in (False, True):
        got = attn.ell_attn_plain(xp, index, a["w_s"], a["w_l"], a["C"],
                                  a["F"], transpose, padded)
        if padded:
            assert bool((got[..., 3:] == 0).all())
            got = got[..., :3]
        np.testing.assert_allclose(got.reshape(8, 2, 3).numpy(),
                                   want.numpy(), **TOL)
    if not transpose:
        # row 0 reads its self loop alone, row 1 live cells weighted 0
        got = attn.ell_attn_plain(xp, index, a["w_s"], a["w_l"], a["C"],
                                  a["F"], False, False)
        for t in (0, 1):
            np.testing.assert_allclose(
                got[t].numpy(), (x[t].reshape(2, 3) * a["w_l"][t][:, None])
                .reshape(-1).numpy(), **TOL)


def test_ell_sddmm_plain_matches_its_definition():
    a = attn_case(seed=2)
    N, C, H, F = a["N"], a["C"], a["H"], a["F"]
    gp, xp = attn.pad_heads(a["g"], H), attn.pad_heads(a["x"], H)
    gw_s, gw_l = attn.ell_sddmm(gp, xp, a["nbr"], True)
    gv, xv = (v.double().reshape(N, H, F) for v in (a["g"], a["x"]))
    want = torch.zeros((N, C, H), dtype=torch.float64)
    for t in range(N):
        for c in range(C):
            if a["nbr"][t, c] >= 0:
                want[t, c] = (gv[t] * xv[int(a["nbr"][t, c])]).sum(-1)
    np.testing.assert_allclose(gw_s.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(gw_l.numpy(), (gv * xv).sum(-1).numpy(),
                               **TOL)
    assert bool((gw_s[0] == 0).all())                  # pads: 0
    assert attn.ell_sddmm(gp, xp, a["nbr"], False)[1] is None


def test_pad_heads():
    x = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    p = attn.pad_heads(x, 2)                         # F 3 -> 4 f32
    assert tuple(p.shape) == (2, 2, 4)
    assert torch.equal(p[..., :3].reshape(2, 6), x)
    assert bool((p[..., 3:] == 0).all())
    assert attn.pad_heads(p[..., :4].reshape(2, 8), 2).data_ptr() \
        == p.data_ptr()                              # nothing to pad: a view
    b = attn.pad_heads(x, 2, torch.bfloat16)
    assert b.dtype == torch.bfloat16 and tuple(b.shape) == (2, 2, 8)
    xg = x.clone().requires_grad_(True)
    (attn.pad_heads(xg, 2) * 2).sum().backward()
    assert torch.equal(xg.grad, torch.full_like(x, 2.0))
    assert [attn.padded_width(f, torch.bfloat16) for f in (8, 64, 250, 256,
                                                           300)] \
        == [8, 64, 256, 256, 512]
    assert [attn.padded_width(f, torch.float32) for f in (8, 64, 250, 3)] \
        == [8, 64, 256, 4]


WRAPPER_CASES = ("rows_dtype", "rows_rank", "rows_width", "index_dtype",
                 "index_rows", "sddmm_pair", "device")


@pytest.mark.parametrize("case", WRAPPER_CASES)
def test_ell_attn_wrappers_refuse_what_the_kernels_do_not_take(case):
    """The rows' and the index's checks that every wrapper of
    ``ops.ell_attn`` shares, through ``ell_gat``; ``ell_sddmm``'s pair."""
    a = attn_case()
    xp = attn.pad_heads(a["x"], 2)
    el, er = a["w_l"], a["w_l"].flip(0).contiguous()
    args = dict(xp=xp, nbr=a["nbr"], el=el, er=er, F=3)

    def call(**kw):
        return attn.ell_gat(**dict(args, **kw))
    if case == "rows_dtype":
        with pytest.raises(TypeError, match="f32 or bf16"):
            call(xp=xp.double())
    elif case == "rows_rank":
        with pytest.raises(TypeError, match=r"\[N, H, Fp\]"):
            call(xp=a["x"])
    elif case == "rows_width":
        with pytest.raises(ValueError, match="no padded head width"):
            call(xp=xp[..., :3].contiguous())
    elif case == "index_dtype":
        with pytest.raises(TypeError, match="int32"):
            call(nbr=a["nbr"].long())
    elif case == "index_rows":
        with pytest.raises(TypeError, match="int32"):
            call(nbr=a["nbr"][:-1])
    elif case == "sddmm_pair":
        with pytest.raises(ValueError, match="differ"):
            attn.ell_sddmm(xp[:-1], xp, a["nbr"])
    else:
        meta = {k: args[k].to("meta") for k in ("xp", "nbr", "el", "er")}
        with pytest.raises(ValueError, match="no kernel"):
            call(**meta)


def test_ell_agg_weight_gradient_is_the_one_head_sddmm():
    """``_ell_agg``'s gradient to w_s (now ``ops.ell_sddmm`` with one
    head) equals the f32 row-dot formula it had, g[t] . x[nbr[t, c]]."""
    a = attn_case(H=1, F=5, seed=5)
    x, nbr, C = a["x"], a["nbr"], a["C"]
    w_s = a["w_s"][..., 0].clone().requires_grad_(True)
    out = block_lib._ell_agg(C, x, w_s, a["w_l"][:, 0], nbr, a["tpos"])
    (got,) = torch.autograd.grad(out, w_s, a["g"])
    want = torch.einsum("td,tcd->tc", a["g"], ell_agg_ops.ell_rows(x, nbr))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_attention_spans_in_a_train_step(graph):
    """``attention`` inside each multi-head conv's ``conv`` span, and
    ``attention.backward`` in the Function's backward; neither in a
    one-head model."""
    g = graph.tensors
    roots = torch.arange(50, dtype=torch.int32)
    for heads, want in ((3, 2), (1, 0)):
        m = model(heads)
        with trace.recording() as spans:
            m(g, roots)["loss"].backward()
        att = [s for s in spans if s.name == "attention"]
        back = [s for s in spans if s.name == "attention.backward"]
        assert len(att) == len(back) == want
        assert all(s.parent is not None and s.parent.name == "conv"
                   for s in att)


# ------------------------------------------------- GAT's fused attention --

def gat_block(N: int, C: int, seed: int):
    """A compact whole-graph ELL block of N nodes and C cells a row (pads
    about half, interleaved): row 0 all pads (its self loop alone), row 1
    all live (over 32 cells: two chunks); tpos the transpose positions of
    every live cell, pads interleaved."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, N, (N, C)).astype(np.int32)
    nbr[rng.random((N, C)) < 0.5] = -1
    nbr[0] = -1
    nbr[1] = rng.integers(0, N, C)
    into = [[] for _ in range(N)]
    for p in np.flatnonzero(nbr.reshape(-1) >= 0):
        into[nbr.flat[p]].append(p)
    C_in = max(len(c) for c in into) + 2
    tpos = np.full((N, C_in), -1, np.int32)
    for u, cells in enumerate(into):
        tpos[u, np.sort(rng.choice(C_in, len(cells), replace=False))] = cells
    blk = fanout_block(torch.arange(N, dtype=torch.int32),
                       torch.from_numpy(nbr), torch.ones((N, C)),
                       torch.zeros((N, C), dtype=torch.int32), C)
    return dataclasses.replace(blk, ell_tpos=torch.from_numpy(tpos))


def unfused_attention(blk, z, xs, w, a_l, a_r, dtype):
    """GAT's attention over the compact table, unfused, at any H: el and
    er through W^T a, the [E, H] scores, ``Block.softmax``, and the
    per-head aggregate ``ell_attn_plain`` (f32 sums with f32 weights,
    rounded once to ``dtype``) under autograd, over the sampled cells'
    and the self loops' probabilities."""
    H, F = a_l.shape
    N, C = blk.size[0], blk.fanout
    wh = w.reshape(H, F, -1)
    scores = (blk.gather_tgt(xs @ torch.einsum("hfd,hf->dh", wh, a_l))
              + blk.gather_src(xs @ torch.einsum("hfd,hf->dh", wh, a_r)))
    alpha = blk.softmax(torch.nn.functional.leaky_relu(scores, 0.2),
                        blk.mask)
    return attn.ell_attn_plain(attn.pad_heads(z, H, dtype),
                               blk.n_id[N:].reshape(N, C),
                               alpha[:N * C].reshape(N, C, H),
                               alpha[N * C:], C, F, False, False)


def gat_run(blk, H, F, dtype, fused, seed):
    """out, the gradients to x, W, a_l, a_r and z, and x and W, of one
    attention call from weights drawn from ``seed`` (x the f32 rows that
    fc reads), under a cotangent in ``dtype``."""
    N, D_in = blk.size[0], 12
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).requires_grad_(True)
    leaves = [draw(N, D_in), draw(H * F, D_in, scale=D_in ** -0.5),
              draw(H, F, scale=F ** -0.5), draw(H, F, scale=F ** -0.5)]
    g = torch.from_numpy(rng.normal(size=(N, H * F)).astype(np.float32)
                         ).to(dtype)
    x, w, a_l, a_r = leaves
    z = x @ w.T
    fn = blk.gat_attention if fused else functools.partial(
        unfused_attention, blk)
    out = fn(z, x, w, a_l, a_r, dtype)
    grads = torch.autograd.grad(out, leaves + [z], g)
    return out.detach(), grads, z.detach(), x.detach(), w.detach()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [8, 64, 250])
@pytest.mark.parametrize("heads", [1, 2, 3, 8])
def test_fused_gat_attention_matches_the_unfused_chain(heads, F, dtype):
    """``Block.gat_attention`` (``_EllGat``: the plain versions of the
    fused kernels, z's gradient in f32 with el's and er's terms) against
    the unfused chain, on a block with pads, a row of its self loop alone
    and rows of two chunks: the output, and the gradients to x, W, a_l and
    a_r. f32: within 1e-5 of each tensor's largest value (sums in other
    orders; the softmax through its log-sum-exp). The activation type
    rounds the output once on either side (an ulp of it) and, in the
    unfused chain alone, z's gradient from the aggregate (half an ulp of
    it, bounded by 2^-8 of the unfused one, dz), which reaches x's and W's
    gradients through W and x: the bounds dz |W| and dz^T |x|. a_l's and
    a_r's gradients pass no rounding."""
    blk = gat_block(50, 40, seed=heads * 10 + F)
    got, g_got, z, x, w = gat_run(blk, heads, F, dtype, True, seed=F)
    want, g_want = gat_run(blk, heads, F, dtype, False, seed=F)[:2]
    assert got.dtype == dtype and got.shape == (50, heads * F)
    low = dtype == torch.bfloat16
    dz = (2.0 ** -8 if low else 0.0) * g_want[4].abs()
    checks = (("out", got.float(), want.float(),
               (2.0 ** -7 if low else 0.0) * want.float().abs()),
              ("x", g_got[0], g_want[0], dz @ w.abs()),
              ("W", g_got[1], g_want[1], dz.T @ x.abs()),
              ("a_l", g_got[2], g_want[2], 0.0),
              ("a_r", g_got[3], g_want[3], 0.0))
    for name, a, b, bound in checks:
        gap = (a - b).abs() - bound - 1e-5 * float(b.abs().max())
        assert float(gap.max()) <= 0.0, name
    # row 0, its self loop alone, reads its own z row at weight 1
    assert torch.equal(got[0], z[0].to(dtype))


@pytest.mark.parametrize("heads", [1, 2, 3])
def test_gat_conv_takes_the_fused_path_on_a_compact_table_only(
        graph, heads, monkeypatch):
    """Multi-head GAT on the ELL pack runs ``Block.gat_attention`` once a
    layer; GAT at one head, the dynamic layout, the edge list and a pack
    without self loops run the unfused attention of the other blocks."""
    calls = []
    real = block_lib.Block.gat_attention

    def spy(self, *args):
        calls.append(self.size)
        return real(self, *args)
    monkeypatch.setattr(block_lib.Block, "gat_attention", spy)
    g = graph.tensors
    roots = torch.arange(50, dtype=torch.int32)
    deg = int(torch.bincount(g.adj_src.long(), minlength=300).max())
    no_pack = dataclasses.replace(g, **{n: None for n in ELL_FIELDS})
    runs = (("pack", g, {}), ("dynamic", no_pack, dict(cap=deg)),
            ("edge_list", g, dict(layout="edge_list")),
            ("no_loops", g, dict(add_self_loops=False)))
    for name, tensors, flow_kw in runs:
        del calls[:]
        model(heads, **flow_kw)(tensors, roots)["loss"].backward()
        want = 2 if name == "pack" and heads > 1 else 0
        assert len(calls) == want, name


GAT_WRAPPER_CASES = ("terms_dtype", "terms_shape", "lse_shape", "de_shape",
                     "a_shape", "f_width", "sddmm_pair", "device")


@pytest.mark.parametrize("case", GAT_WRAPPER_CASES)
def test_ell_gat_wrappers_refuse_what_the_kernels_do_not_take(case):
    a = attn_case(C=4, H=2, F=3)
    N, H, F = a["N"], a["H"], a["F"]
    xp, gp = attn.pad_heads(a["x"], H), attn.pad_heads(a["g"], H)
    el, er = a["w_l"], a["w_l"].flip(0).contiguous()
    out, lse = attn.ell_gat(xp, a["nbr"], el, er, F)
    de, de_self, d_el = attn.ell_gat_sddmm(gp, xp, a["nbr"], el, er, lse)
    tr = dict(gp=gp, tpos=a["tpos"], nbr=a["nbr"], el=el, er=er, lse=lse,
              de=de, de_self=de_self, d_el=d_el, a_l=torch.ones(H, F),
              a_r=torch.ones(H, F), F=F)
    if case == "terms_dtype":
        with pytest.raises(TypeError, match=r"el must be f32"):
            attn.ell_gat(xp, a["nbr"], el.double(), er, F)
    elif case == "terms_shape":
        with pytest.raises(TypeError, match=r"er must be f32"):
            attn.ell_gat(xp, a["nbr"], el, er[:, :1].contiguous(), F)
    elif case == "lse_shape":
        with pytest.raises(TypeError, match=r"lse must be f32"):
            attn.ell_gat_sddmm(gp, xp, a["nbr"], el, er, lse[:-1])
    elif case == "de_shape":
        with pytest.raises(TypeError, match=r"de must be f32"):
            attn.ell_gat_tr(**dict(tr, de=de[:, :3].contiguous()))
    elif case == "a_shape":
        with pytest.raises(TypeError, match=r"a_l must be f32"):
            attn.ell_gat_tr(**dict(tr, a_l=torch.ones(H, F + 1)))
    elif case == "f_width":
        with pytest.raises(ValueError, match="does not pad"):
            attn.ell_gat(xp, a["nbr"], el, er, 5)
    elif case == "sddmm_pair":
        with pytest.raises(ValueError, match="differ"):
            attn.ell_gat_sddmm(gp[:-1], xp, a["nbr"], el, er, lse)
    else:
        with pytest.raises(ValueError, match="no kernel"):
            attn.ell_gat(xp.to("meta"), a["nbr"].to("meta"),
                         el.to("meta"), er.to("meta"), F)
    assert out.shape == (N, H * F) and lse.shape == (N, H)


def test_live_tpos_drops_the_cells_that_nbr_drops():
    """``live_tpos`` keeps the transpose positions of live cells and sets
    those of cells that nbr drops (an edge-type filter) and pads to -1;
    the fused transpose's plain version gives the same with either."""
    a = attn_case(seed=7)
    nbr = a["nbr"].clone()
    nbr[3, :] = -1                             # row 3's cells dropped
    got = attn.live_tpos(a["tpos"], nbr)
    cells = nbr.reshape(-1)[a["tpos"].long().clamp_min(0)]
    want = torch.where((a["tpos"] >= 0) & (cells >= 0), a["tpos"], -1)
    assert torch.equal(got, want)
    assert int((got // a["C"] == 3).sum()) == 0
    assert int((a["tpos"] // a["C"] == 3).sum()) > 0
    H, F = a["H"], a["F"]
    xp, gp = attn.pad_heads(a["x"], H), attn.pad_heads(a["g"], H)
    el, er = a["w_l"], a["w_l"].flip(0).contiguous()
    lse = attn.gat_lse(el, er, nbr)
    grads = attn.ell_gat_sddmm_plain(gp, xp, nbr, el, er, lse)
    a_lr = (torch.ones(H, F), torch.full((H, F), 0.5))
    runs = [attn.ell_gat_tr_plain(gp, tp, nbr, el, er, lse, *grads, *a_lr,
                                  F) for tp in (a["tpos"], got)]
    for u, v in zip(*runs):
        assert torch.equal(u, v)
