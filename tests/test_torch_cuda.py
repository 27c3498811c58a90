"""On-card tests of the PyTorch port (marker ``cuda``).

They need an NVIDIA GPU and skip themselves where
``torch.cuda.is_available()`` is false. This file imports neither jax nor
euler_tpu, so it also runs where jax is not installed, without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Each kernel must equal its plain PyTorch version bit for bit (the row
gather's NaN rows compared as integers); the whole slice on the card must
sample the ids the CPU samples from the same uniforms and give embeddings,
and a training step's loss and gradients, within rtol = atol = 1e-4 (f32
on both, different summation order). The whole-graph autograd Functions
(``_ell_agg``, ``ell_expand``) and ``scatter_max`` on the card must match
themselves on the CPU within the same tolerance (exactly for the max).
GAT's fused modes of the attention kernels (``ell_gat``,
``ell_gat_sddmm``, ``ell_gat_tr``) must match their plain versions
within 1e-4 of each result's largest value (and an ulp of a bf16
output), and a multi-head GAT loop must launch 9 of them a step.
The edge draw on the card must equal the CPU's bit for bit from the same
uniforms; a TransE step and an unsupervised GraphSAGE step must match the
CPU within 1e-4, the latter with 7 ``fan_draw`` and 3 ``gather_rows``
launches. A loop of ``steps_per_loop`` steps, one captured step replayed
(``TrainLoop``), must equal the eager steps from the same generator state
bit for bit (transe within 1e-5: its ``Embed`` backward sums with
atomics), advance the generator as they do, and count each replay's
kernel launches. ``infer``'s captured forward (``InferGraph``: the first
batch eager, the second captured, the rest replayed) must give the eager
forward's answers within 1e-4 and its draws bit for bit (sage, and sage
with ``dedup_features``), draw anew at each replay, fire a hook
registered after the capture, stay eager under a hook that returns a
value (a request whose hook starts returning one after the capture
raises) and for a forward that reads a value on the host (the card then
serving another estimator by replay), answer concurrent calls from six
threads as the eager forward does, and count each replay's launches;
so must a loop of each of the eight other convs of the
registry (tag, sgcn, agnn, appnp, graph, arma, dna, gated; bit for bit)
and of sage over the id and sparse-id encoder (within rtol 1e-4, atol
1e-5, trained with SGD: its tables sum with atomics too). DeepWalk,
Node2Vec and LINE (orders 1 and 2): a step on the card must match the
CPU's on the same uniforms (walks equal but for near ties of node2vec's
Gumbel keys; loss and gradients within 1e-4), and a replayed loop under
SGD must equal its eager steps bit for bit, launching no kernel. Each
family of the layerwise and remaining model slice (adaptivegcn, fastgcn,
GAE, VGAE, DGI, GeniePath, LGCN, scalable, the solution models, gin with
mean and set2set pooling): a step on the card must match the CPU's on the
same weights, batch and draws within 1e-4 (``chip_smoke.rest_vs_cpu``,
the layer draws equal but for near ties), and a replayed loop must equal
its eager steps bit for bit (the pools sum in a fixed order), the
scalable store included, with the family's launches a step. The
fan-less hop (a graph without the ``fan`` pack) and the payload hop
(``SageDataFlow(payload=True)``) must equal the CPU's bit for bit from
the same uniforms and launch no ``fan_draw``; a bf16 feature table
(``load_graph(feature_dtype=torch.bfloat16)``) must gather through
``gather_rows`` bit for bit; a sage step without the ``fan`` pack makes
0 ``fan_draw`` and 2 ``gather_rows`` launches. Each query of
``chip_smoke.smoke_queries`` must give on the card what it gives on the
CPU from the card's uniforms, bit for bit (the UDFs within 1e-6), with
its ``gather_rows`` launches (``values`` gathers through the kernel, each
launch equal to its plain version) and no ``fan_draw``; the layer query
equal but for near ties; the index's draws and the blocked running sum
equal to the CPU's bit for bit; the IVF index's centroids within 1e-4 of
the CPU's build, its members and search ids equal, one ``gather_rows``
launch a search; ``k`` past the corpus raises on the card too. The
supervised head's loss kernels (``ops.sigmoid_xent``) must match their
plain versions within f32 round-off (the loss's sums in another order, the
card's ``expf`` and ``log1pf``) at odd shapes and strided views, give the
same bits on a second call, give -g y at a logit of 0, and run inside a
replayed loop (two launches a step) and a replayed infer batch (one).
"""
import copy
import dataclasses
import gc
import math
import sys
import threading

import numpy as np
import pytest
import torch

from chip_smoke import (REST_FAMILIES, REST_LAUNCHES, REST_PACKS,
                        WALK_PACKS, DrawReplay, KernelRecorder,
                        eager_infer, int_view, record_draws, rest_estimator,
                        rest_model, rest_vs_cpu,
                        same_query_results, smoke_queries,
                        synthetic_fan_pack, synthetic_union_pack,
                        to_device, walk_grads, xent_gap)
from euler_tpu_torch import knn
from euler_tpu_torch.ops import index as index_ops
from euler_tpu_torch.query import Query
from euler_tpu_torch import bench
from euler_tpu_torch.dataflow import SageDataFlow, WholeDataFlow
from euler_tpu_torch.dataflow import block as block_lib
from euler_tpu_torch.datasets import SBMDataset, motif_graph, random_graph
from euler_tpu_torch.estimator import (EdgeEstimator, NodeEstimator,
                                       RunConfig, TrainLoop, get_optimizer)
from euler_tpu_torch.models import gnn as gnn_lib
from euler_tpu_torch.models import (LINE, DeepWalk, GNNNet, Node2Vec,
                                    ShallowEncoder, SuperviseModel, TransE,
                                    UnsuperviseModel)
from euler_tpu_torch.ops import ell_agg as ell
from euler_tpu_torch.ops import ell_attn as attn
from euler_tpu_torch.ops import fan_draw as fd
from euler_tpu_torch.ops import gather_rows as gr
from euler_tpu_torch.ops import mp_ops, rel_agg, sampling
from euler_tpu_torch.ops import sigmoid_xent as sx

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def fan_inputs(dev, B, C, n_et, G=4096):
    gen = torch.Generator(device=dev).manual_seed(B + C)
    packs = torch.from_numpy(synthetic_fan_pack(np.random.default_rng(B),
                                                G)).to(dev)
    high = G if n_et == 1 else G + 50
    nodes = torch.randint(0, high, (B,), generator=gen, dtype=torch.int32,
                          device=dev)
    nodes[::17] = -1
    u1, u2 = sampling.draw_fan_uniforms(gen, B, C, dev)
    return packs, nodes, u1, u2


@pytest.mark.parametrize("B,C,n_et,et", [
    (1024, 25, 1, 0), (26_624, 10, 1, 0), (1021, 25, 1, 0),
    (1, 1, 1, 0),
    (333, 50, 1, 0),      # more draws per row than a warp has lanes
    (4097, 10, 1, 0),     # one row past a multiple of a block's rows
    (5000, 25, 1, 0),     # many rows of many draws: the row path
    (1000, 10, 3, 1)])    # nodes up to G + 49: rows past the pack clamp
def test_kernel_matches_plain(dev, B, C, n_et, et):
    packs, nodes, u1, u2 = fan_inputs(dev, B, C, n_et)
    before = fd.fan_draw.launches
    ids, valid = fd.fan_draw(packs, nodes, et, n_et, u1, u2, -1)
    torch.cuda.synchronize()
    assert fd.fan_draw.launches == before + 1
    ref_ids, ref_valid = fd.fan_draw_plain(packs, nodes, et, n_et, u1, u2,
                                           -1)
    assert torch.equal(ids, ref_ids)
    assert torch.equal(valid, ref_valid)


def test_unaligned_pack_takes_the_draw_path(dev):
    # a pack that is not 16-byte aligned, at a size that would take the
    # row path: the kernel draws it all the same
    packs, nodes, u1, u2 = fan_inputs(dev, 1024, 25, 1)
    flat = torch.empty(packs.numel() + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(packs.shape)
    shifted.copy_(packs)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    ids, valid = fd.fan_draw(shifted, nodes, 0, 1, u1, u2, -1)
    ref_ids, ref_valid = fd.fan_draw_plain(packs, nodes, 0, 1, u1, u2, -1)
    assert torch.equal(ids, ref_ids)
    assert torch.equal(valid, ref_valid)


@pytest.mark.parametrize("path", [1, 2])        # row path, draw path
@pytest.mark.parametrize("B,C,n_et,et", [(1, 1, 1, 0), (333, 50, 1, 0),
                                         (26_624, 10, 1, 0),
                                         (1000, 10, 3, 1)])
def test_fan_draw_paths_match_plain(dev, path, B, C, n_et, et):
    # each path of the kernel at sizes where the wrapper takes the other
    packs, nodes, u1, u2 = fan_inputs(dev, B, C, n_et)
    ids = torch.full((B, C), 7, dtype=torch.int32, device=dev)
    valid = torch.ones((B, C), dtype=torch.bool, device=dev)
    rc = fd.build().etpu_fan_draw_path(
        packs.data_ptr(), packs.shape[0], nodes.data_ptr(), B, C, et, n_et,
        u1.data_ptr(), u2.data_ptr(), -1, ids.data_ptr(), valid.data_ptr(),
        None, 0, torch.cuda.current_stream().cuda_stream, path)
    torch.cuda.synchronize()
    assert rc == 0
    ref_ids, ref_valid = fd.fan_draw_plain(packs, nodes, et, n_et, u1, u2,
                                           -1)
    assert torch.equal(ids, ref_ids)
    assert torch.equal(valid, ref_valid)


@pytest.mark.parametrize("path", [0, 1, 2])     # wrapper's choice, row, draw
@pytest.mark.parametrize("union", [True, False])
@pytest.mark.parametrize("B,C", [(1024, 25), (26_624, 10), (333, 50)])
def test_typed_epilogue_matches_plain(dev, path, union, B, C):
    # union rows (types 0..15, ids up to FANU_MASK) decoded into ids and
    # types, or the one-type typed output on a 3-type pack whose rows past
    # the pack clamp; without types too
    rng = np.random.default_rng(B + C)
    G = 4096
    make = synthetic_union_pack if union else synthetic_fan_pack
    packs = torch.from_numpy(make(rng, G)).to(dev)
    n_et, et = (1, 0) if union else (3, 2)
    gen = torch.Generator(device=dev).manual_seed(C)
    nodes = torch.randint(0, G + 50, (B,), generator=gen, dtype=torch.int32,
                          device=dev)
    nodes[::17] = -1
    u1, u2 = sampling.draw_fan_uniforms(gen, B, C, dev)
    want = fd.fan_draw_plain(packs, nodes, et, n_et, u1, u2, -3, union, True)
    for typed in (True, False):
        out = (torch.full((B, C), 7, dtype=torch.int32, device=dev),
               torch.ones((B, C), dtype=torch.bool, device=dev),
               torch.full((B, C), 7, dtype=torch.int32, device=dev))
        rc = fd.build().etpu_fan_draw_path(
            packs.data_ptr(), G, nodes.data_ptr(), B, C, et, n_et,
            u1.data_ptr(), u2.data_ptr(), -3, out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr() if typed else None,
            int(union), torch.cuda.current_stream().cuda_stream, path)
        torch.cuda.synchronize()
        assert rc == 0
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
        assert torch.equal(out[2], want[2] if typed else torch.full_like(
            out[2], 7))
    got = fd.fan_draw(packs, nodes, et, n_et, u1, u2, -3, union, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    types = set(torch.unique(want[2]).tolist())
    assert types == ({-1} | set(range(16)) if union else {-1, et})


@pytest.mark.parametrize("family", ["gin", "gat", "rgcn"])
def test_family_step_on_card_matches_cpu(dev, family):
    # one step of each bench family, card vs CPU from the same weights,
    # roots and uniforms: equal sampled ids and types, loss and every
    # gradient within 1e-4
    rgcn = family == "rgcn"
    graph = random_graph(3000, 25, feat_dim=128, n_classes=16, seed=0,
                         num_edge_types=bench.RGCN_TYPES if rgcn else 1,
                         packs=("fanu",) if rgcn else ("fan",), device=dev)
    model = bench.make_model(family, dev,
                             generator=torch.Generator().manual_seed(0))
    ugen = torch.Generator(device=dev).manual_seed(3)
    roots = sampling.sample_node(graph.tensors, 64, -1, ugen)
    flow = model.embedder.flow
    uniforms, n = [], 64
    for ets, c in zip(flow.metapath, flow.fanouts):
        uniforms.append(sampling.draw_neighbor_uniforms(
            graph.tensors, ets, ugen, n, c, dev))
        n *= 1 + c
    cpu = torch.device("cpu")
    g_cpu = graph.tensors.to(cpu)
    u_cpu = [tuple(u.cpu() for u in hop) for hop in uniforms]
    with torch.no_grad():
        for bk, bc in zip(flow(graph.tensors, roots, uniforms=uniforms),
                          flow(g_cpu, roots.cpu(), uniforms=u_cpu)):
            assert torch.equal(bk.n_id.cpu(), bc.n_id)
            assert (bk.e_type is None) == (bc.e_type is None) == (not rgcn)
            if rgcn:
                assert torch.equal(bk.e_type.cpu(), bc.e_type)
    before = fd.fan_draw.launches
    runs = []
    for m, g, r, u in ((model, graph.tensors, roots, uniforms),
                       (copy.deepcopy(model).to(cpu), g_cpu, roots.cpu(),
                        u_cpu)):
        loss = m(g, r, uniforms=u)["loss"]
        loss.backward()
        runs.append((loss.detach().cpu(),
                     {k: p.grad.cpu() for k, p in m.named_parameters()}))
    assert fd.fan_draw.launches == before + 2
    (lk, gk), (lc, gc) = runs
    np.testing.assert_allclose(lk.numpy(), lc.numpy(), rtol=1e-4, atol=1e-4)
    for k in gk:
        np.testing.assert_allclose(gk[k].numpy(), gc[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_slice_on_card_matches_cpu(dev):
    graph = random_graph(3000, 25, feat_dim=16, n_classes=4, seed=0)
    gen = torch.Generator().manual_seed(0)
    net = GNNNet("sage", SageDataFlow([25, 10], [(0,), (0,)]), (16, 16),
                 ShallowEncoder(("feature",)), in_dim=16, generator=gen)
    model = SuperviseModel(net, "label", 4, generator=gen)
    roots = torch.arange(64, dtype=torch.int32, device=dev)
    roots[-1] = -1
    ugen = torch.Generator(device=dev).manual_seed(1)
    uniforms = [sampling.draw_fan_uniforms(ugen, 64, 25, dev),
                sampling.draw_fan_uniforms(ugen, 64 * 26, 10, dev)]
    cpu = torch.device("cpu")
    g_cpu = graph.tensors.to(cpu)
    u_cpu = [(a.cpu(), b.cpu()) for a, b in uniforms]
    with torch.no_grad():
        blocks = net.flow(graph.tensors, roots, uniforms=uniforms)
        blocks_cpu = net.flow(g_cpu, roots.cpu(), uniforms=u_cpu)
        for bk, bc in zip(blocks, blocks_cpu):
            assert torch.equal(bk.n_id.cpu(), bc.n_id)
        out = model(graph.tensors, roots, uniforms=uniforms)
        out_cpu = copy.deepcopy(model).to(cpu)(g_cpu, roots.cpu(),
                                               uniforms=u_cpu)
    for name in ("embedding", "logit", "loss"):
        np.testing.assert_allclose(out[name].cpu().numpy(),
                                   out_cpu[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("N,D,M,dtype,W,off,kind", [
    (200_000, 128, 292_864, torch.float32, None, 0, "mixed"),
    (200_000, 128, 292_864, torch.bfloat16, None, 0, "mixed"),
    (200_000, 16, 1024, torch.float32, None, 0, "mixed"),
    (5000, 1, 10_007, torch.float32, None, 0, "mixed"),
    (5000, 3, 10_007, torch.float32, None, 0, "mixed"),
    (5000, 127, 10_007, torch.float32, None, 0, "mixed"),
    (5000, 5, 10_007, torch.bfloat16, None, 0, "mixed"),
    (5000, 128, 4099, torch.float32, 256, 128, "mixed"),
    (5000, 128, 4099, torch.bfloat16, 264, 8, "mixed"),
    (5000, 64, 4099, torch.float32, 300, 37, "mixed"),
    (5000, 128, 1, torch.float32, None, 0, "mixed"),
    (5000, 128, 33, torch.float32, None, 0, "mixed"),     # one past a tile
    (5000, 128, 1000, torch.float32, None, 0, "mixed"),   # ragged last stage
    (5000, 128, 1000, torch.bfloat16, 200, 64, "mixed"),
    (5000, 128, 4099, torch.float32, None, 0, "minus1"),
    (5000, 128, 4099, torch.bfloat16, None, 0, "beyond"),
    (5000, 128, 4099, torch.float32, 256, 0, "beyond"),
    (5000, 128, 65_536, torch.float32, None, 0, "repeat"),
    (200_000, 16, 1024, torch.bfloat16, None, 0, "mixed")])
def test_gather_kernel_matches_plain(dev, N, D, M, dtype, W, off, kind):
    gen = torch.Generator(device=dev).manual_seed(M + D)
    table = torch.randn((N, D), generator=gen, device=dev, dtype=dtype)
    ids = torch.randint(0, N, (M,), generator=gen, dtype=torch.int32,
                        device=dev)
    if kind == "mixed":
        ids[::13] = -1
        ids[5::101] = N + 3
    elif kind == "minus1":
        ids[:] = -1
    elif kind == "beyond":
        ids += N
    else:                           # "repeat": eight rows, over and over
        ids %= 8
    base = None if W is None else torch.full((M, W), 7.0, dtype=dtype,
                                             device=dev)
    before = gr.gather_rows.launches
    got = gr.gather_rows(table, ids, None if base is None else base.clone(),
                         off)
    torch.cuda.synchronize()
    assert gr.gather_rows.launches == before + 1
    want = gr.gather_rows_plain(table, ids,
                                None if base is None else base.clone(), off)
    assert torch.equal(int_view(got), int_view(want))
    nan_rows = torch.isnan(got[:, off:off + D]).all(1)
    assert torch.equal(nan_rows, ids >= N)
    assert bool((got[ids < 0, off:off + D] == 0).all())


def test_gather_on_the_card_never_runs_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain gather ran on a CUDA tensor")

    monkeypatch.setattr(gr, "gather_rows_plain", boom)
    table = torch.randn((100, 8), device=dev)
    ids = torch.tensor([0, -1, 99, 100], dtype=torch.int32, device=dev)
    out = gr.gather_rows(table, ids)
    graph = random_graph(500, 10, feat_dim=8, n_classes=4, seed=0)
    enc = ShallowEncoder(("feature", "label"))
    x = enc(graph.tensors, ids)
    torch.cuda.synchronize()
    assert torch.isnan(out[3]).all() and (out[1] == 0).all()
    assert x.shape == (4, 12) and (x[1] == 0).all()


def test_train_step_on_card_matches_cpu(dev):
    graph = random_graph(3000, 25, feat_dim=16, n_classes=4, seed=0)
    gen = torch.Generator().manual_seed(0)
    net = GNNNet("sage", SageDataFlow([25, 10], [(0,), (0,)]), (16, 16),
                 ShallowEncoder(("feature",)), in_dim=16, generator=gen)
    model = SuperviseModel(net, "label", 4, generator=gen)
    ugen = torch.Generator(device=dev).manual_seed(2)
    roots = sampling.sample_node(graph.tensors, 64, -1, ugen)
    uniforms = [sampling.draw_fan_uniforms(ugen, 64, 25, dev),
                sampling.draw_fan_uniforms(ugen, 64 * 26, 10, dev)]
    cpu = torch.device("cpu")
    runs = []
    for m, g, r, u in (
            (model, graph.tensors, roots, uniforms),
            (copy.deepcopy(model).to(cpu), graph.tensors.to(cpu), roots.cpu(),
             [(a.cpu(), b.cpu()) for a, b in uniforms])):
        loss = m(g, r, uniforms=u)["loss"]
        loss.backward()
        runs.append((loss.detach().cpu(),
                     {k: p.grad.cpu() for k, p in m.named_parameters()}))
    (lk, gk), (lc, gc) = runs
    np.testing.assert_allclose(lk.numpy(), lc.numpy(), rtol=1e-4, atol=1e-4)
    assert len(gk) == 7
    for k in gk:
        np.testing.assert_allclose(gk[k].numpy(), gc[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


# ---------------------------------------------------- whole-graph gcn --

def ell_block(dev, n=3000):
    graph = random_graph(n, 25, feat_dim=16, n_classes=4, seed=0,
                         packs=("ell",), device=dev)
    roots = torch.arange(n, dtype=torch.int32, device=dev)
    return graph, WholeDataFlow(1, [(0,)])(graph.tensors, roots)[0]


def grads_on(where, fn, tensors, cot):
    """fn(*tensors) on ``where`` and the gradient of <out, cot> for each
    tensor, all returned on the CPU."""
    ins = [x.to(where).detach().requires_grad_(x.is_floating_point())
           for x in tensors]
    out = fn(*ins)
    diff = [x for x in ins if x.requires_grad]
    grads = torch.autograd.grad(out, diff, cot.to(where))
    return out.detach().cpu(), [g.cpu() for g in grads]


def test_ell_agg_on_card_matches_cpu(dev):
    _, blk = ell_block(dev)
    T, C = blk.size[0], blk.fanout
    gen = torch.Generator(device=dev).manual_seed(5)
    nbr = blk.n_id[T:].reshape(T, C)
    x = torch.randn((T, 32), generator=gen, device=dev)
    w_s = torch.rand((T, C), generator=gen, device=dev) * (nbr >= 0)
    w_l = torch.rand((T,), generator=gen, device=dev)
    cot = torch.randn((T, 32), generator=gen, device=dev)

    def fn(x, w_s, w_l, nbr, tpos):
        return block_lib._ell_agg(C, x, w_s, w_l, nbr, tpos)
    args = (x, w_s, w_l, nbr, blk.ell_tpos)
    out_k, grads_k = grads_on(dev, fn, args, cot)
    out_c, grads_c = grads_on("cpu", fn, args, cot)
    np.testing.assert_allclose(out_k.numpy(), out_c.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert len(grads_k) == 3
    for a, b in zip(grads_k, grads_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


def ell_case(dev, N, C, D, dtype, seed):
    """Inputs of both modes of ``ops.ell_agg``: x and a cotangent g [N, D];
    nbr [N, C] about 40% live with the pads interleaved; tpos [N, C_in]
    the transpose positions of every live cell, pads interleaved too and
    C_in past 32 where C is; then a tenth of the live cells dropped from
    nbr (weight 0) but kept in tpos, as an edge-type filter of the pack
    leaves them. Row 0 is all pads; row 1 is all pads, no cell reads
    node 1 and its w_l is 0, so its result is 0 in both modes; row 2 has
    every cell live."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(2, N, (N, C)).astype(np.int32)
    nbr[rng.random((N, C)) < 0.6] = -1
    nbr[:2] = -1
    nbr[2] = rng.integers(2, N, C)
    into = [[] for _ in range(N)]
    for p in np.flatnonzero(nbr.reshape(-1) >= 0):
        into[nbr.flat[p]].append(p)
    C_in = max(len(c) for c in into) + 3
    tpos = np.full((N, C_in), -1, np.int32)
    for u, cells in enumerate(into):
        tpos[u, np.sort(rng.choice(C_in, len(cells), replace=False))] = cells
    drop = (nbr >= 0) & (rng.random((N, C)) < 0.1)
    drop[2] = False
    nbr[drop] = -1
    w_s = (rng.random((N, C)) * (nbr >= 0)).astype(np.float32)
    w_l = rng.random(N).astype(np.float32)
    w_l[1] = 0.0
    x, g = (torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
            .to(dev, dtype) for _ in range(2))
    return dict(x=x, g=g, nbr=torch.from_numpy(nbr).to(dev),
                tpos=torch.from_numpy(tpos).to(dev),
                w_s=torch.from_numpy(w_s).to(dev),
                w_l=torch.from_numpy(w_l).to(dev))


def ell_exact(x, index, w_s, w_l, C, transpose):
    """The exact aggregate (f64 on the CPU) of x and the weights rounded
    to x's type, and the same over their magnitudes, which bounds every
    partial sum."""
    r = [w.to(x.dtype).double().cpu() for w in (w_s, w_l)]
    x64, idx = x.double().cpu(), index.cpu()
    return (ell.ell_agg_plain(x64, idx, *r, C, transpose),
            ell.ell_agg_plain(x64.abs(), idx, *(w.abs() for w in r), C,
                              transpose))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1, 20, 40, 128, 256])
@pytest.mark.parametrize("C", [5, 36, 70])
def test_ell_agg_kernel_matches_plain(dev, C, D, dtype, transpose):
    """The kernel within one rounding of the exact sum (f32 sums in
    another order: 1e-5 of the sum of magnitudes; bf16 adds half an ulp
    of the result, its one rounding), and within a stated tolerance of
    the plain version on the card: f32 1e-5 of the magnitudes (summation
    order alone); bf16 2^-6 of them, since the plain version rounds to
    bf16 three times (its batched product, x * w_l, their sum), each
    within half an ulp of a partial sum, where the kernel rounds once."""
    a = ell_case(dev, 500, C, D, dtype, seed=C * 1000 + D)
    x, index = (a["g"], a["tpos"]) if transpose else (a["x"], a["nbr"])
    args = (x, index, a["w_s"], a["w_l"], C, transpose)
    before = ell.ell_agg.launches
    got = ell.ell_agg(*args)
    torch.cuda.synchronize()
    assert ell.ell_agg.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    plain = ell.ell_agg_plain(*args).double().cpu()
    exact, mag = ell_exact(*args)
    got = got.double().cpu()
    half_ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    assert bool(((got - exact).abs()
                 <= half_ulp * exact.abs() + 1e-5 * mag).all())
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5
    assert bool(((got - plain).abs() <= tol * mag + 1e-30).all())
    assert bool((got[1] == 0).all())                    # no cell, w_l 0


def test_ell_agg_kernel_edges(dev, monkeypatch):
    """Rows without cells (width 0, forward and transpose), a table whose
    address is not 16-byte aligned (the element path at D = 128), and no
    plain version on a CUDA tensor."""
    def boom(*a, **k):
        raise AssertionError("the plain ell_agg ran on a CUDA tensor")
    a = ell_case(dev, 300, 36, 128, torch.float32, seed=9)
    want = {tr: ell.ell_agg_plain(a["g"] if tr else a["x"],
                                  a["tpos"] if tr else a["nbr"], a["w_s"],
                                  a["w_l"], 36, tr).cpu()
            for tr in (False, True)}
    monkeypatch.setattr(ell, "ell_agg_plain", boom)
    x, w_l = a["x"], a["w_l"]
    none = torch.empty((300, 0), dtype=torch.int32, device=dev)
    got = ell.ell_agg(x, none, torch.empty((300, 0), device=dev), w_l, 0,
                      False)
    assert torch.equal(got, x * w_l[:, None])
    got = ell.ell_agg(x, none, a["w_s"], w_l, 36, True)
    assert torch.equal(got, x * w_l[:, None])
    buf = torch.empty(300 * 128 + 1, device=dev)
    for tr in (False, True):
        xu = buf[1:].view(300, 128)
        xu.copy_(a["g"] if tr else a["x"])
        assert xu.data_ptr() % 16 != 0
        got = ell.ell_agg(xu, a["tpos"] if tr else a["nbr"], a["w_s"], w_l,
                          36, tr)
        np.testing.assert_allclose(got.cpu().numpy(), want[tr].numpy(),
                                   rtol=1e-5, atol=1e-5)


def attn_case(dev, N, C, H, F, dtype, seed):
    """``ell_case``'s index, pads and dropped cells with H heads: padded
    rows x and g [N, H, Fp] (``pad_heads``)."""
    a = ell_case(dev, N, C, H * F, dtype, seed)
    return dict(a, xp=attn.pad_heads(a["x"], H), gp=attn.pad_heads(a["g"], H))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [8, 64, 250, 256])
@pytest.mark.parametrize("H", [1, 2, 3, 8])
def test_ell_sddmm_kernel_matches_plain(dev, H, F, dtype):
    """The weights' gradient within 1e-5 of the sum of the products'
    magnitudes of its plain version (f32 sums in other orders); pads
    exactly 0."""
    a = attn_case(dev, 400, 36, H, F, dtype, seed=H * 100 + F)
    before = attn.ell_sddmm.launches
    gw_s, gw_l = attn.ell_sddmm(a["gp"], a["xp"], a["nbr"], True)
    torch.cuda.synchronize()
    assert attn.ell_sddmm.launches == before + 1
    want_s, want_l = attn.ell_sddmm_plain(a["gp"], a["xp"], a["nbr"], True)
    mag_s, mag_l = attn.ell_sddmm_plain(a["gp"].abs(), a["xp"].abs(),
                                        a["nbr"], True)
    for got, want, mag in ((gw_s, want_s, mag_s), (gw_l, want_l, mag_l)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(((got - want).abs() <= 1e-5 * mag + 1e-30).all())
    assert bool((gw_s[a["nbr"] < 0] == 0).all())
    assert attn.ell_sddmm(a["gp"], a["xp"], a["nbr"], False)[1] is None


def gat_case(dev, H, F, dtype, seed):
    """``attn_case``'s rows, cotangent and index (pads, a row of no cell,
    cells dropped from nbr), tpos of the live cells (``live_tpos``), with
    GAT's score terms el and er [N, H] (normal, scale 2) and a_l, a_r [H,
    F]."""
    a = attn_case(dev, 400, 36, H, F, dtype, seed)
    a["tpos"] = attn.live_tpos(a["tpos"], a["nbr"])
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    el, er = (2 * torch.randn((400, H), generator=gen, device=dev)
              for _ in range(2))
    a_l, a_r = (torch.randn((H, F), generator=gen, device=dev)
                for _ in range(2))
    return dict(a, el=el, er=er, a_l=a_l, a_r=a_r)


def gat_close(got, want, dtype=torch.float32) -> bool:
    """Within 1e-4 of the plain version's largest value (f32 sums of the
    same terms in other orders, expf and logf against torch's), and an
    ulp of the result's type where it rounds to bf16."""
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    want = want.double()
    tol = ulp * want.abs() + 1e-4 * float(want.abs().max())
    return got.shape == want.shape and bool(
        ((got.double() - want).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [8, 64, 250, 256])
@pytest.mark.parametrize("H", [1, 2, 3, 8])
def test_ell_gat_kernels_match_plain(dev, H, F, dtype):
    """GAT's fused modes of the three kernels, each on the plain
    versions' inputs, against their plain versions on the card
    (``gat_close``): the forward's output and lse, the SDDMM's scores'
    gradients (pads 0) and d_el, the transpose's f32 gradient to the rows
    and d_er; three ell_gat launches. Row 1, no cell, reads its own row
    at weight 1."""
    a = gat_case(dev, H, F, dtype, seed=H * 1000 + F)
    xp, gp, nbr, tpos = a["xp"], a["gp"], a["nbr"], a["tpos"]
    el, er = a["el"], a["er"]
    before = attn.ell_gat.launches
    out, lse = attn.ell_gat(xp, nbr, el, er, F)
    want_out, want_lse = attn.ell_gat_plain(xp, nbr, el, er, F)
    assert out.dtype == dtype and gat_close(out, want_out, dtype)
    assert gat_close(lse, want_lse)
    assert torch.equal(out[1], a["x"][1])
    de, de_self, d_el = attn.ell_gat_sddmm(gp, xp, nbr, el, er, want_lse)
    want = attn.ell_gat_sddmm_plain(gp, xp, nbr, el, er, want_lse)
    assert all(gat_close(u, v) for u, v in zip((de, de_self, d_el), want))
    assert bool((de[nbr < 0] == 0).all())
    d_z, d_er = attn.ell_gat_tr(gp, tpos, nbr, el, er, want_lse, *want,
                                a["a_l"], a["a_r"], F)
    want_z, want_er = attn.ell_gat_tr_plain(gp, tpos, nbr, el, er, want_lse,
                                            *want, a["a_l"], a["a_r"], F)
    torch.cuda.synchronize()
    assert d_z.dtype == torch.float32 and gat_close(d_z, want_z)
    assert gat_close(d_er, want_er)
    assert attn.ell_gat.launches == before + 3


def test_ell_attn_plain_never_runs_on_the_card(dev, monkeypatch):
    """No plain version and no [N, C, D] rows (``ell_rows``) on a CUDA
    tensor: the multi-head SDDMM, GAT's fused Function's forward and
    backward, and ``_ell_agg``'s gradient to the weights (the one-head
    SDDMM)."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    for mod, name in ((attn, "ell_attn_plain"), (attn, "ell_sddmm_plain"),
                      (attn, "ell_gat_plain"), (attn, "ell_gat_sddmm_plain"),
                      (attn, "ell_gat_tr_plain"), (attn, "gat_weights"),
                      (attn, "gat_lse"), (ell, "ell_agg_plain"),
                      (ell, "ell_rows")):
        monkeypatch.setattr(mod, name, boom)
    a = attn_case(dev, 300, 36, 3, 250, torch.bfloat16, seed=3)
    gw_s, gw_l = attn.ell_sddmm(a["gp"], a["xp"], a["nbr"], True)
    assert gw_s.shape == (300, 36, 3) and gw_l.shape == (300, 3)
    _, blk = ell_block(dev)
    N = blk.size[0]
    gen = torch.Generator(device=dev).manual_seed(7)
    xs = torch.randn((N, 16), generator=gen, device=dev)
    leaves = [t.requires_grad_(True) for t in (
        torch.randn((750, 16), generator=gen, device=dev) / 4,
        torch.randn((3, 250), generator=gen, device=dev) / 16,
        torch.randn((3, 250), generator=gen, device=dev) / 16)]
    out = blk.gat_attention(xs @ leaves[0].T, xs, *leaves, torch.bfloat16)
    assert out.shape == (N, 750) and out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, leaves, torch.ones_like(out))
    assert [g.shape for g in grads] == [v.shape for v in leaves]
    b = ell_case(dev, 300, 36, 128, torch.bfloat16, seed=4)
    ws = b["w_s"].clone().requires_grad_(True)
    out = block_lib._ell_agg(36, b["x"], ws, b["w_l"], b["nbr"], b["tpos"])
    (gws,) = torch.autograd.grad(out, ws, b["g"])
    torch.cuda.synchronize()
    assert gws.shape == ws.shape


def gat_model(dev, dtype, generator_seed=0, n=3000, heads=3, layers=3):
    graph = random_graph(n, 25, feat_dim=16, n_classes=4, seed=0,
                         packs=("ell",), device=dev)
    gen = torch.Generator().manual_seed(generator_seed)
    net = GNNNet("gat", WholeDataFlow(layers, [(0,)]), (24,) * layers,
                 ShallowEncoder(("feature",)), in_dim=16, dtype=dtype,
                 device=dev, generator=gen, conv_kwargs={"heads": heads})
    return graph, SuperviseModel(net, "label", 4, device=dev, generator=gen)


def attn_counts(before=(0, 0)) -> tuple:
    """The launches of ell_sddmm and ell_gat since ``before``."""
    now = (attn.ell_sddmm.launches, attn.ell_gat.launches)
    return tuple(a - b for a, b in zip(now, before))


def test_gat_step_on_card_matches_cpu(dev):
    """A multi-head GAT step over every node in f32: loss and gradients
    on the card (the kernels) within 1e-4 of the CPU's (the plain
    versions), with 3 ell_gat launches a layer (forward, SDDMM,
    transpose) and none of the weighted ell_sddmm."""
    graph, model = gat_model(dev, None, layers=2)
    roots = torch.arange(3000, dtype=torch.int32, device=dev)
    cpu = torch.device("cpu")
    before = attn_counts()
    runs = []
    for m, g, r in ((model, graph.tensors, roots),
                    (copy.deepcopy(model).to(cpu), graph.tensors.to(cpu),
                     roots.cpu())):
        loss = m(g, r)["loss"]
        loss.backward()
        runs.append((loss.detach().cpu(),
                     {k: p.grad.cpu() for k, p in m.named_parameters()}))
    assert attn_counts(before) == (0, 6)
    (lk, gk), (lc, gc) = runs
    np.testing.assert_allclose(lk.numpy(), lc.numpy(), rtol=1e-4, atol=1e-4)
    for k in gk:
        np.testing.assert_allclose(gk[k].numpy(), gc[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_ell_expand_on_card_matches_cpu(dev):
    _, blk = ell_block(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((blk.size[0], 8), generator=gen, device=dev)
    cot = torch.randn((blk.size[1], 8), generator=gen, device=dev)
    args = (x, blk.n_id, blk.ell_tpos)
    out_k, (gk,) = grads_on(dev, block_lib.ell_expand, args, cot)
    out_c, (gc,) = grads_on("cpu", block_lib.ell_expand, args, cot)
    assert torch.equal(out_k, out_c)
    np.testing.assert_allclose(gk.numpy(), gc.numpy(), rtol=1e-4, atol=1e-4)


def test_scatter_max_ties_on_card_match_cpu(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    u = torch.randint(-3, 4, (5000, 4), generator=gen, device=dev).float()
    idx = torch.randint(0, 900, (5000,), generator=gen, device=dev)
    cot = torch.randn((1000, 4), generator=gen, device=dev)

    def fn(u, idx):
        return mp_ops.scatter_max(u, idx, 1000)
    out_k, (gk,) = grads_on(dev, fn, (u, idx), cot)
    out_c, (gc,) = grads_on("cpu", fn, (u, idx), cot)
    assert torch.equal(out_k, out_c) and (out_k[900:] == 0).all()
    np.testing.assert_allclose(gk.numpy(), gc.numpy(), rtol=1e-6, atol=1e-6)


def test_gcn_step_on_card_matches_cpu(dev):
    # a small gcn step over every node: loss and gradients card vs CPU,
    # 2 gather launches on the card; the edge list (index_add_ in no fixed
    # order) within 1e-4 of the ELL pack
    graph, _ = ell_block(dev)
    gen = torch.Generator().manual_seed(0)
    net = GNNNet("gcn", WholeDataFlow(2, [(0,)]), (16, 8),
                 ShallowEncoder(("feature",)), in_dim=16, generator=gen)
    model = SuperviseModel(net, "label", 4, generator=gen)
    roots = torch.arange(3000, dtype=torch.int32, device=dev)
    cpu = torch.device("cpu")
    before = gr.gather_rows.launches
    runs = []
    for m, g, r in ((model, graph.tensors, roots),
                    (copy.deepcopy(model).to(cpu), graph.tensors.to(cpu),
                     roots.cpu())):
        loss = m(g, r)["loss"]
        loss.backward()
        runs.append((loss.detach().cpu(),
                     {k: p.grad.cpu() for k, p in m.named_parameters()}))
    assert gr.gather_rows.launches == before + 2
    (lk, gk), (lc, gc) = runs
    np.testing.assert_allclose(lk.numpy(), lc.numpy(), rtol=1e-4, atol=1e-4)
    assert len(gk) == 5
    for k in gk:
        np.testing.assert_allclose(gk[k].numpy(), gc[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    edge_list = copy.deepcopy(model)
    edge_list.embedder.flow = WholeDataFlow(2, [(0,)], layout="edge_list")
    with torch.no_grad():
        a = model(graph.tensors, roots)["embedding"]
        b = edge_list(graph.tensors, roots)["embedding"]
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------- transe, unsupervised --

def test_sample_edge_on_card_matches_cpu(dev):
    graph = random_graph(3000, 25, num_edge_types=16, seed=0, packs=(),
                         device=dev)
    g_cpu = graph.tensors.to("cpu")
    gen = torch.Generator(device=dev).manual_seed(4)
    for count in (1, 4096, 4097):
        for edge_type in (-1, 3):
            u = sampling.draw_edge_uniforms(gen, count, dev)
            got = sampling.select_edges(graph.tensors, edge_type, *u)
            want = sampling.select_edges(g_cpu, edge_type,
                                         *(x.cpu() for x in u))
            assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
            assert bool((got[0] >= 0).all())


def test_transe_step_on_card_matches_cpu(dev):
    graph = random_graph(3000, 25, num_edge_types=16, seed=0, packs=(),
                         device=dev)
    model = TransE(3000, 16, 100, 100, num_negs=5, device=dev,
                   generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    src, dst, ty, _ = sampling.sample_edge(graph.tensors, 512, -1, gen)
    batch = torch.stack([src, dst, ty], 1)
    u = sampling.draw_node_uniforms(gen, 512 * 5, dev)
    before = (fd.fan_draw.launches, gr.gather_rows.launches)
    runs = []
    for m, g, b, uu in ((model, graph.tensors, batch, u),
                        (copy.deepcopy(model).to("cpu"),
                         graph.tensors.to("cpu"), batch.cpu(),
                         [x.cpu() for x in u])):
        out = m(g, b, uniforms=uu)
        out["loss"].backward()
        runs.append((out, {k: p.grad.cpu() for k, p in m.named_parameters()}))
    assert (fd.fan_draw.launches, gr.gather_rows.launches) == before
    (ok, gk), (oc, gc) = runs
    for name in ("loss", "logits", "neg_logits", "embedding"):
        np.testing.assert_allclose(ok[name].detach().cpu().numpy(),
                                   oc[name].detach().numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for k in gk:
        np.testing.assert_allclose(gk[k].numpy(), gc[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_unsupervised_step_on_card_matches_cpu(dev):
    # 7 fan_draw launches (the positive hop, then 2 hops in each of the 3
    # tower calls) and 3 gather_rows (one feature gather per tower call)
    graph = random_graph(3000, 25, feat_dim=16, seed=0, device=dev)
    gen = torch.Generator().manual_seed(0)

    def net():
        return GNNNet("sage", SageDataFlow([10, 10], [(0,), (0,)]), (16, 16),
                      ShallowEncoder(("feature",)), in_dim=16, device=dev,
                      generator=gen)
    model = UnsuperviseModel(net(), net(), (0,), num_negs=20, device=dev)
    ugen = torch.Generator(device=dev).manual_seed(2)
    roots = sampling.sample_node(graph.tensors, 64, -1, ugen)
    uniforms = [sampling.draw_neighbor_uniforms(graph.tensors, (0,), ugen, 64,
                                                1, dev),
                sampling.draw_node_uniforms(ugen, 64 * 20, dev)]
    for n in (64, 64, 64 * 20):
        uniforms.append([sampling.draw_fan_uniforms(ugen, n, 10, dev),
                         sampling.draw_fan_uniforms(ugen, n * 11, 10, dev)])

    def to_cpu(u):
        if isinstance(u, torch.Tensor):
            return u.cpu()
        return None if u is None else type(u)(to_cpu(x) for x in u)

    before = (fd.fan_draw.launches, gr.gather_rows.launches)
    runs = []
    for m, g, r, u in ((model, graph.tensors, roots, uniforms),
                       (copy.deepcopy(model).to("cpu"),
                        graph.tensors.to("cpu"), roots.cpu(),
                        to_cpu(uniforms))):
        out = m(g, r, uniforms=u)
        out["loss"].backward()
        runs.append((out, {k: p.grad.cpu() for k, p in m.named_parameters()}))
        if m is model:
            torch.cuda.synchronize()
            assert (fd.fan_draw.launches - before[0],
                    gr.gather_rows.launches - before[1]) == (7, 3)
    (ok, gk), (oc, gc) = runs
    assert torch.equal(ok["pos_mask"].cpu(), oc["pos_mask"])
    for name in ("loss", "logits", "neg_logits", "embedding"):
        np.testing.assert_allclose(ok[name].detach().cpu().numpy(),
                                   oc[name].detach().numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert len(gk) == 12
    for k in gk:
        np.testing.assert_allclose(gk[k].numpy(), gc[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


# ---- the estimator's loop: a captured step replayed (TrainLoop) -----------

LOOP_SPL = 4


def loop_estimators(dev, family):
    """(graph, estimator with steps_per_loop = LOOP_SPL, one with 1) from
    the same weights; sage on a graph with reservoir rows, transe on 16
    edge types."""
    if family == "sage":
        graph = random_graph(3000, 50, feat_dim=16, n_classes=4, seed=0,
                             device=dev)

        def make():
            net = GNNNet("sage", SageDataFlow([5, 3], [(0,), (0,)]),
                         (16, 16), ShallowEncoder(("feature",)), in_dim=16,
                         device=dev,
                         generator=torch.Generator().manual_seed(0))
            return SuperviseModel(net, "label", 4, device=dev,
                                  generator=torch.Generator().manual_seed(0))
        cls = NodeEstimator
    else:
        graph = random_graph(3000, 25, num_edge_types=16, seed=0, packs=(),
                             device=dev)

        def make():
            return TransE(3000, 16, 32, 32, num_negs=5, device=dev,
                          generator=torch.Generator().manual_seed(0))
        cls = EdgeEstimator
    cfg = RunConfig(batch_size=256, total_steps=2 * LOOP_SPL,
                    learning_rate=1e-3, log_steps=0,
                    reservoir_refresh=LOOP_SPL, steps_per_loop=LOOP_SPL,
                    seed=3)
    return (graph, cls(make(), graph, cfg, device=dev),
            cls(make(), graph, dataclasses.replace(cfg, steps_per_loop=1),
                device=dev))


@pytest.mark.parametrize("family", ["sage", "transe"])
def test_replayed_loop_equals_eager_steps(dev, family):
    """Bit for bit, but for transe, whose Embed backward sums repeated ids
    with index_add_ atomics in no fixed order."""
    graph, graphed, eager = loop_estimators(dev, family)
    g = graph.tensors
    pack = None if g.fan_pack is None else g.fan_pack.clone()
    losses, counts = [], []
    for est in (eager, graphed):
        if pack is not None:
            g.fan_pack.copy_(pack)
        before = (fd.fan_draw.launches, gr.gather_rows.launches)
        losses.append(est.train()["loss"])
        torch.cuda.synchronize()
        counts.append((fd.fan_draw.launches - before[0],
                       gr.gather_rows.launches - before[1]))
    if pack is not None:
        assert not torch.equal(g.fan_pack, pack)         # redrawn
    per_step = 2 if family == "sage" else 0
    assert counts == [(per_step * 2 * LOOP_SPL,) * 2] * 2
    pairs = list(zip(graphed.model.parameters(), eager.model.parameters()))
    if family == "sage":
        assert losses[0] == losses[1]
        assert all(torch.equal(a, b) for a, b in pairs)
    else:
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5,
                                   atol=1e-6)
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_replays_advance_the_generator_as_eager_steps(dev):
    graph, graphed, eager = loop_estimators(dev, "sage")
    g = graph.tensors
    draws = []
    for est, spl in ((graphed, LOOP_SPL), (eager, 1)):
        gen = torch.Generator(device=dev).manual_seed(5)
        opt = get_optimizer("adam", 1e-3, est.model.parameters())
        seen = []

        def batch():
            seen.append(est.train_batch(g, gen))
            return seen[-1]
        loop = TrainLoop(est, opt, gen, spl, batch)
        roots = []
        for _ in range(3 * LOOP_SPL // spl):
            loop()
            roots.append(seen[-1].clone())
        draws.append((roots[LOOP_SPL // spl - 1::LOOP_SPL // spl],
                      torch.rand(8, generator=gen, device=dev)))
        if spl > 1:
            assert loop.held == dict(fan_draw=2, gather_rows=2, ell_agg=0,
                                     ell_sddmm=0, ell_gat=0, rel_mean=0,
                                     rel_mean_tr=0, sigmoid_xent=2)
    (roots_g, after_g), (roots_e, after_e) = draws
    assert not torch.equal(roots_g[1], roots_g[2])       # replays draw anew
    assert all(torch.equal(a, b) for a, b in zip(roots_g, roots_e))
    assert torch.equal(after_g, after_e)


def test_launch_counts_through_replays(dev):
    graph, graphed, _ = loop_estimators(dev, "sage")
    gen = torch.Generator(device=dev).manual_seed(6)
    opt = get_optimizer("adam", 1e-3, graphed.model.parameters())
    loop = TrainLoop(graphed, opt, gen, LOOP_SPL,
                     lambda: graphed.train_batch(graph.tensors, gen))
    counts = []
    for _ in range(3):
        before = (fd.fan_draw.launches, gr.gather_rows.launches)
        loop()
        counts.append((fd.fan_draw.launches - before[0],
                       gr.gather_rows.launches - before[1]))
    assert counts == [(2 * LOOP_SPL, 2 * LOOP_SPL)] * 3


def infer_estimator(dev, dedup=False):
    """A sage ``NodeEstimator`` of batch 256 over a graph with reservoir
    rows, for ``infer``'s captured path (``InferGraph``)."""
    graph = random_graph(3000, 50, feat_dim=16, n_classes=4, seed=0,
                         device=dev)
    net = GNNNet("sage", SageDataFlow([5, 3], [(0,), (0,)]), (16, 16),
                 ShallowEncoder(("feature",)), in_dim=16, device=dev,
                 generator=torch.Generator().manual_seed(0),
                 dedup_features=dedup)
    model = SuperviseModel(net, "label", 4, device=dev,
                           generator=torch.Generator().manual_seed(0))
    return NodeEstimator(model, graph, RunConfig(batch_size=256, seed=3),
                         device=dev)


def infer_counts(est) -> tuple:
    return est.infer_batches, est.infer_replays, est.infer_captures


@pytest.mark.parametrize("dedup", [False, True])
def test_replayed_infer_equals_eager(dev, dedup):
    """Request 1's first batch is eager, its second captured; every batch
    after is a replay. The answers equal the eager forward's within 1e-4
    and the draws (the first conv's n_id, as a forward hook copies it)
    bit for bit. ``dedup_features``' forward captures too."""
    est = infer_estimator(dev, dedup)
    ids = np.arange(600)                      # 3 batches, the last padded
    draws, remove = record_draws(est.model)
    for _ in range(3):
        draws.clear()
        got = est.infer(ids)
        graphed, draws[:] = list(draws), []
        want = eager_infer(est, ids)
        assert len(graphed) == len(draws) == 3
        assert all(torch.equal(a, b) for a, b in zip(graphed, draws))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    remove()
    assert infer_counts(est) == (9, 8, 1)


def test_infer_replays_draw_anew(dev):
    """Three batches of the same ids: each replay draws anew, as the
    eager batches do; two requests in a row are reseeded alike."""
    est = infer_estimator(dev)
    ids = np.tile(np.arange(256), 3)
    draws, remove = record_draws(est.model)
    first = est.infer(ids)
    second = est.infer(ids)
    graphed, draws[:] = draws[3:], []
    eager_infer(est, ids)
    remove()
    assert infer_counts(est) == (6, 5, 1)
    assert not torch.equal(graphed[1], graphed[2])
    assert all(torch.equal(a, b) for a, b in zip(graphed, draws))
    np.testing.assert_array_equal(first, second)


def test_a_hook_registered_after_the_infer_capture_fires(dev):
    est = infer_estimator(dev)
    ids = np.arange(256)
    est.infer(ids)
    est.infer(ids)
    seen = []
    handle = est.model.register_forward_hook(
        lambda m, a, out: seen.append(out["embedding"].clone()))
    got = [est.infer(ids) for _ in range(3)]   # warm-up, capture, replay
    handle.remove()
    assert len(seen) == 3
    assert all(np.array_equal(s.cpu().numpy(), e)
               for s, e in zip(seen, got))
    assert infer_counts(est) == (5, 3, 2)


def test_a_hook_that_returns_a_value_keeps_infer_eager(dev):
    est = infer_estimator(dev)
    ids = np.arange(256)
    want = eager_infer(est, ids)
    handle = est.model.embedder.register_forward_hook(
        lambda m, a, out: out * 2)
    for _ in range(3):
        np.testing.assert_array_equal(est.infer(ids), want * 2)
    assert infer_counts(est) == (3, 0, 0)
    handle.remove()
    for _ in range(2):
        np.testing.assert_allclose(est.infer(ids), want, rtol=1e-4,
                                   atol=1e-4)
    assert infer_counts(est) == (5, 1, 1)


def test_a_hook_that_returns_a_value_after_the_infer_capture_raises(dev):
    """No replay's answer is served past a hook that returns a value: the
    request raises, and the next one runs eagerly, honouring it."""
    est = infer_estimator(dev)
    ids = np.arange(256)
    want = eager_infer(est, ids)
    double = []
    handle = est.model.embedder.register_forward_hook(
        lambda m, a, out: out * 2 if double else None)
    est.infer(ids)
    est.infer(ids)                              # warm-up, capture
    double.append(True)
    with pytest.raises(RuntimeError, match="returned a value"):
        est.infer(ids)
    np.testing.assert_array_equal(est.infer(ids), want * 2)
    handle.remove()
    assert infer_counts(est) == (3, 2, 1)


def test_concurrent_infer_calls_on_one_estimator(dev):
    """Six threads share one estimator's captured forward, each request
    answered as an eager forward answers it: the lock keeps one thread's
    replays from overwriting another's static output before its copy."""
    est = infer_estimator(dev)
    id_sets = [(np.arange(600) + 300 * k) % 3000 for k in range(6)]
    wants = [eager_infer(est, ids) for ids in id_sets]
    est.infer(id_sets[0])
    est.infer(id_sets[0])                       # warm-up, capture
    got, errors = {k: [] for k in range(6)}, []

    def serve(k):
        try:
            for _ in range(4):
                got[k].append(est.infer(id_sets[k]))
        except Exception as e:                  # reported below
            errors.append(e)
    threads = [threading.Thread(target=serve, args=(k,)) for k in range(6)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    for k in range(6):
        assert len(got[k]) == 4
        for answer in got[k]:
            np.testing.assert_allclose(answer, wants[k], rtol=1e-4,
                                       atol=1e-4)
    assert infer_counts(est) == (78, 77, 1)


class HostRead(torch.nn.Module):
    """A model whose forward copies a value to the host, which no CUDA
    graph can capture."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, g, batch, generator=None, uniforms=None):
        out = self.inner(g, batch, generator=generator, uniforms=uniforms)
        return dict(out, host_sum=float(out["embedding"].sum()))


def test_a_forward_that_reads_the_host_keeps_infer_eager(dev):
    """The failed capture serves its batch eagerly from the generator
    state before it, and the card then serves a sage request by replay."""
    sage = infer_estimator(dev)
    est = NodeEstimator(HostRead(sage.model), sage.graph, sage.config,
                        device=dev)
    ids = np.arange(600)
    draws, remove = record_draws(sage.model)
    for _ in range(2):
        draws.clear()
        got = est.infer(ids)
        graphed, draws[:] = list(draws), []
        want = eager_infer(est, ids)
        assert len(graphed) == len(draws) == 3
        assert all(torch.equal(a, b) for a, b in zip(graphed, draws))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    remove()
    assert infer_counts(est) == (6, 0, 0)
    assert not est._infer_graph.capturable
    np.testing.assert_allclose(sage.infer(ids), want, rtol=1e-4, atol=1e-4)
    assert infer_counts(sage) == (3, 2, 1)


def test_launch_counts_through_infer_replays(dev):
    est = infer_estimator(dev)
    ids = np.arange(256)
    est.infer(ids)
    est.infer(ids)
    assert est._infer_graph.held == dict(fan_draw=2, gather_rows=2,
                                         ell_agg=0, ell_sddmm=0, ell_gat=0,
                                         rel_mean=0, rel_mean_tr=0,
                                         sigmoid_xent=1)
    before = (fd.fan_draw.launches, gr.gather_rows.launches)
    for _ in range(5):
        est.infer(ids)
    assert (fd.fan_draw.launches - before[0],
            gr.gather_rows.launches - before[1]) == (10, 10)
    assert infer_counts(est) == (7, 6, 1)


def test_gcn_replayed_loop_equals_eager_steps(dev):
    """gcn over every node as the gcn-train cell runs it, at 3 layers
    and bf16 activations, at a small size: a loop of replays equals the
    eager steps bit for bit (the ELL kernel sums in a fixed order), and a
    replay holds 5 ell_agg launches (3 forward, 2 gradients to x: the
    first layer's x is the feature table) beside the 2 feature and label
    gathers."""
    graph = random_graph(3000, 25, feat_dim=16, n_classes=4, seed=0,
                         packs=("ell",), device=dev)
    every = torch.arange(3000, dtype=torch.int32, device=dev)
    runs = []
    for spl in (1, LOOP_SPL):
        gen = torch.Generator().manual_seed(0)
        net = GNNNet("gcn", WholeDataFlow(3, [(0,)]), (16, 16, 16),
                     ShallowEncoder(("feature",)), in_dim=16,
                     dtype=torch.bfloat16, device=dev, generator=gen)
        est = NodeEstimator(SuperviseModel(net, "label", 4, device=dev,
                                           generator=gen),
                            graph, RunConfig(batch_size=3000), device=dev)
        opt = get_optimizer("adam", 1e-3, est.model.parameters())
        loop = TrainLoop(est, opt, torch.Generator(device=dev).manual_seed(5),
                         spl, lambda: every)
        before = ell.ell_agg.launches
        loss = [loop() for _ in range(2 * LOOP_SPL // spl)][-1]
        torch.cuda.synchronize()
        runs.append((est, float(loss), ell.ell_agg.launches - before, loop))
    (eager, loss_e, n_e, _), (graphed, loss_g, n_g, loop) = runs
    assert loop.held == dict(fan_draw=0, gather_rows=2, ell_agg=5,
                             ell_sddmm=0, ell_gat=0, rel_mean=0,
                             rel_mean_tr=0, sigmoid_xent=2)
    assert n_e == n_g == 5 * 2 * LOOP_SPL
    assert loss_e == loss_g
    assert all(torch.equal(a, b) for a, b in zip(
        graphed.model.parameters(), eager.model.parameters()))


def test_gat_replayed_loop_equals_eager_steps(dev):
    """Multi-head GAT (3 layers of 3 heads) over every node at bf16
    activations, as the gat-train cell runs it, at a small size: a loop of
    replays equals the eager steps bit for bit (the kernels sum in a fixed
    order), and a replay holds 9 ell_gat launches (3 forward, 3 SDDMM and
    3 transposes: the first layer's rows are z, which takes a gradient)
    beside the 2 gathers, and no launch of the weighted ell_sddmm."""
    every = torch.arange(3000, dtype=torch.int32, device=dev)
    runs = []
    for spl in (1, LOOP_SPL):
        graph, model = gat_model(dev, torch.bfloat16)
        est = NodeEstimator(model, graph, RunConfig(batch_size=3000),
                            device=dev)
        opt = get_optimizer("adam", 1e-3, est.model.parameters())
        loop = TrainLoop(est, opt, torch.Generator(device=dev).manual_seed(5),
                         spl, lambda: every)
        before = attn_counts()
        loss = [loop() for _ in range(2 * LOOP_SPL // spl)][-1]
        torch.cuda.synchronize()
        runs.append((est, float(loss), attn_counts(before), loop))
    (eager, loss_e, n_e, _), (graphed, loss_g, n_g, loop) = runs
    assert loop.held == dict(fan_draw=0, gather_rows=2, ell_agg=0,
                             ell_sddmm=0, ell_gat=9, rel_mean=0,
                             rel_mean_tr=0, sigmoid_xent=2)
    assert n_e == n_g == (0, 9 * 2 * LOOP_SPL)
    assert loss_e == loss_g
    assert all(torch.equal(a, b) for a, b in zip(
        graphed.model.parameters(), eager.model.parameters()))


def rel_counts(before=(0, 0)) -> tuple:
    """The launches of rel_mean and rel_mean_tr since ``before``."""
    now = (rel_agg.rel_mean.launches, rel_agg.rel_mean_tr.launches)
    return tuple(a - b for a, b in zip(now, before))


@pytest.mark.parametrize("mask", [0b1111111, 0b1011011])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [64, 128])
def test_rel_mean_kernels_match_plain(dev, F, dtype, mask):
    """The typed mean kernel and its transpose against their plain
    versions on the typed test graph (hub segments past HUB both ways,
    empty segments, a relation masked off), message rows as column blocks
    of a wider table: within f32 round-off of the sums' order, every
    gradient row written, the same bits on a second call, and a chunk
    kernel launched before each main kernel."""
    from tests.test_torch_rgcn import relation_views, typed_graph
    (gc, _), (gd, _) = typed_graph(), typed_graph(dev)
    pc, pd = gc.tensors.rel, gd.tensors.rel
    rows_c, roots_c = relation_views(gc, F, dtype)
    rows_d, roots_d = relation_views(gc, F, dtype, device=dev)
    want = rel_agg.rel_mean(rows_c, pc.row_lo, gc.tensors.group_ptr,
                            gc.tensors.adj_dst, roots_c, pc.type_lo, mask,
                            pc.hubs)
    before = rel_counts()
    got = [rel_agg.rel_mean(rows_d, pd.row_lo, gd.tensors.group_ptr,
                            gd.tensors.adj_dst, roots_d, pd.type_lo, mask,
                            pd.hubs) for _ in range(2)]
    assert rel_counts(before) == (4, 0)
    assert torch.equal(got[0], got[1])
    torch.testing.assert_close(got[0].cpu(), want, rtol=1e-5, atol=1e-5)
    cot = torch.randn(gc.meta.n_nodes, F,
                      generator=torch.Generator().manual_seed(7)).to(dtype)
    outs = []
    for g, p, c in ((gc, pc, cot), (gd, pd, cot.to(dev)),
                    (gd, pd, cot.to(dev))):
        out = [torch.full((hi - lo, F), float("nan"), device=c.device)
               for lo, hi in zip(p.row_lo, p.row_hi)]
        rel_agg.rel_mean_tr(c, p.tptr, p.tsrc, p.tw, out, p.row_lo, mask,
                            p.tr_hubs)
        outs.append(out)
    assert rel_counts(before) == (4, 4)
    for a, b, c in zip(*outs):
        assert torch.equal(b, c) and not torch.isnan(b).any()
        torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-5)


def test_rel_mean_plain_never_runs_on_the_card(dev, monkeypatch):
    from tests.test_torch_rgcn import relation_views, typed_graph
    gd, _ = typed_graph(dev)
    p = gd.tensors.rel

    def boom(*a, **k):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(rel_agg, "rel_mean_plain", boom)
    monkeypatch.setattr(rel_agg, "rel_mean_tr_plain", boom)
    rows, roots = relation_views(gd, 64, torch.bfloat16, device=dev)
    out = rel_agg.rel_mean(rows, p.row_lo, gd.tensors.group_ptr,
                           gd.tensors.adj_dst, roots, p.type_lo, 127, p.hubs)
    grads = [torch.empty((hi - lo, 64), device=dev)
             for lo, hi in zip(p.row_lo, p.row_hi)]
    rel_agg.rel_mean_tr(out.to(torch.bfloat16), p.tptr, p.tsrc, p.tw, grads,
                        p.row_lo, 127, p.tr_hubs)


# ---- the supervised head's loss (ops.sigmoid_xent) ------------------------

def xent_case(dev, R, C, layout, label_dtype, seed=0):
    """Logits [R, C] (every seventh row's every third logit exactly 0, the
    tie), 0/1 labels and row weights with padded rows, on the card.
    ``layout``: "flat" (both contiguous), "label_view" (labels the first C
    columns of a wider table), "logit_view" (logits a column block at an
    offset of one element: no quad loads)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(R, C + 1, generator=gen) * 4
    x[::7, ::3] = 0.0
    y = (torch.rand(R, C + 5, generator=gen) < 0.3).float()
    v = (torch.rand(R, generator=gen) < 0.9).float()
    x = x[:, 1:] if layout == "logit_view" else x[:, :C].contiguous()
    y = y[:, :C] if layout == "label_view" else y[:, :C].contiguous()
    return x.to(dev), y.to(label_dtype).to(dev), v.to(dev)


@pytest.mark.parametrize("label_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["flat", "label_view", "logit_view"])
@pytest.mark.parametrize("R,C", [(1027, 349), (4099, 40), (1024, 16),
                                 (333, 1), (5, 3)])
def test_sigmoid_xent_kernels_match_plain(dev, R, C, layout, label_dtype):
    """The loss and the logits' gradient against the plain versions on
    the same inputs (run on the CPU): the loss within f32 round-off of the
    sums' order, the denominator exact, the gradient within a few ulps
    (the card's expf and log1pf); the same bits on a second call; one
    launch counted a call."""
    x, y, v = xent_case(dev, R, C, layout, label_dtype)
    up = torch.tensor(0.37, device=dev)
    before = sx.sigmoid_xent.launches
    got = [sx.sigmoid_xent(x, y, v) for _ in range(2)]
    grads = [sx.sigmoid_xent_grad(x, y, v, got[0][1], up) for _ in range(2)]
    torch.cuda.synchronize()
    assert sx.sigmoid_xent.launches == before + 4
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(grads[0], grads[1])
    want, den = sx.sigmoid_xent_plain(x.cpu(), y.cpu(), v.cpu())
    assert float(got[0][1]) == float(den)
    assert xent_gap(got[0][0], want) <= 1e-6
    d = sx.sigmoid_xent_grad_plain(x.cpu(), y.cpu(), v.cpu(), den, up.cpu())
    assert grads[0].shape == (R, C) and grads[0].is_contiguous()
    assert xent_gap(grads[0], d) <= 1e-6


def test_sigmoid_xent_gradient_at_a_zero_logit(dev):
    """At x == 0 the gradient is -g y (g the row's weight over den, times
    the upstream), not (0.5 - y) g; a row of weight 0 gets 0."""
    x, y, v = xent_case(dev, 1027, 349, "label_view", torch.float32)
    x[:] = 0.0
    loss, den = sx.sigmoid_xent(x, y, v)
    d = sx.sigmoid_xent_grad(x, y, v, den, torch.tensor(1.0, device=dev))
    g = v[:, None] / den
    torch.testing.assert_close(d, -y * g, rtol=2 ** -22, atol=0)
    assert not d[v == 0].any()
    assert abs(float(loss) - math.log(2.0)) < 1e-6


def test_sigmoid_xent_plain_never_runs_on_the_card(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(sx, "sigmoid_xent_plain", boom)
    monkeypatch.setattr(sx, "sigmoid_xent_grad_plain", boom)
    x, y, v = xent_case(dev, 64, 349, "flat", torch.float32)
    x.requires_grad_()
    gnn_lib._SigmoidXent.apply(x, y, v).backward()
    torch.cuda.synchronize()
    assert x.grad is not None


def test_sigmoid_xent_inside_captured_steps_and_replayed_infer(dev):
    """A replayed loop holds the loss's two launches a step (forward and
    backward) and a replayed infer batch its one, counted as eager calls
    are; the loop's replays equal its eager steps bit for bit
    (test_replayed_loop_equals_eager_steps) through these kernels."""
    graph, graphed, _ = loop_estimators(dev, "sage")
    gen = torch.Generator(device=dev).manual_seed(6)
    opt = get_optimizer("adam", 1e-3, graphed.model.parameters())
    loop = TrainLoop(graphed, opt, gen, LOOP_SPL,
                     lambda: graphed.train_batch(graph.tensors, gen))
    counts = []
    for _ in range(3):
        before = sx.sigmoid_xent.launches
        loop()
        counts.append(sx.sigmoid_xent.launches - before)
    assert loop.held["sigmoid_xent"] == 2
    assert counts == [2 * LOOP_SPL] * 3
    est = infer_estimator(dev)
    ids = np.arange(256)
    est.infer(ids)
    est.infer(ids)
    before = sx.sigmoid_xent.launches
    for _ in range(3):
        est.infer(ids)
    assert sx.sigmoid_xent.launches - before == 3
    assert est._infer_graph.held["sigmoid_xent"] == 1


def test_rgcn_step_on_card_matches_cpu(dev):
    """An R-GCN step over the typed whole graph in f32 (the rgcn
    configuration's model at a small size): loss and every gradient on the
    card (the kernels) within 1e-4 of the CPU's (the plain versions), with
    a chunk and a main kernel a layer each way."""
    from tests.test_torch_rgcn import rgcn_model, typed_graph
    roots = torch.arange(500, dtype=torch.int32)
    runs = []
    for where in ("cpu", dev):
        graph, _ = typed_graph(where)
        model = rgcn_model(where)
        before = rel_counts()
        out = model(graph.tensors, roots.to(where))
        out["loss"].backward()
        runs.append((float(out["loss"].detach()), rel_counts(before),
                     {k: v.grad.cpu() for k, v in model.named_parameters()}))
    (loss_c, n_c, grads_c), (loss_d, n_d, grads_d) = runs
    assert n_c == (0, 0) and n_d == (4, 4)
    assert abs(loss_c - loss_d) <= 1e-5 * abs(loss_c)
    for k in grads_c:
        torch.testing.assert_close(grads_d[k], grads_c[k], rtol=1e-4,
                                   atol=1e-6, msg=k)


def test_rgcn_replayed_loop_equals_eager_steps(dev):
    """R-GCN over every node of the typed graph at bf16 activations, as
    the rgcn-train cell runs it, at a small size: a loop of replays equals
    the eager steps bit for bit (the typed mean kernels sum in a fixed
    order, with no atomics), and a replay holds 4 rel_mean and 4
    rel_mean_tr launches (a chunk and a main kernel a layer each way: the
    first layer's rows take a gradient, the tables') beside the 2 gathers
    (the papers' features, the labels)."""
    from tests.test_torch_rgcn import rgcn_model, typed_graph
    every = torch.arange(500, dtype=torch.int32, device=dev)
    runs = []
    for spl in (1, LOOP_SPL):
        graph, _ = typed_graph(dev, dtype=torch.bfloat16)
        est = NodeEstimator(rgcn_model(dev, torch.bfloat16), graph,
                            RunConfig(batch_size=500), device=dev)
        opt = get_optimizer("adam", 1e-2, est.model.parameters())
        loop = TrainLoop(est, opt, torch.Generator(device=dev).manual_seed(5),
                         spl, lambda: every)
        before = rel_counts()
        loss = [loop() for _ in range(2 * LOOP_SPL // spl)][-1]
        torch.cuda.synchronize()
        runs.append((est, float(loss), rel_counts(before), loop))
    (eager, loss_e, n_e, _), (graphed, loss_g, n_g, loop) = runs
    assert loop.held == dict(fan_draw=0, gather_rows=2, ell_agg=0,
                             ell_sddmm=0, ell_gat=0, rel_mean=4,
                             rel_mean_tr=4, sigmoid_xent=2)
    assert n_e == n_g == (4 * 2 * LOOP_SPL, 4 * 2 * LOOP_SPL)
    assert loss_e == loss_g
    assert all(torch.equal(a, b) for a, b in zip(
        graphed.model.parameters(), eager.model.parameters()))


def test_adagrad_is_refused_under_a_loop_on_the_card(dev):
    graph, graphed, _ = loop_estimators(dev, "sage")
    graphed.config.optimizer = "adagrad"
    with pytest.raises(ValueError, match="Adagrad"):
        graphed.train()


def test_train_under_a_loop_leaves_no_device_memory_behind(dev):
    """Each train call captures anew and frees its graph with it. (A new
    side stream for each capture once left that stream's cuBLAS
    workspaces behind at every call.)"""
    graph, graphed, _ = loop_estimators(dev, "sage")

    def allocated():
        torch.cuda.synchronize()
        gc.collect()
        return torch.cuda.memory_allocated()
    graphed.train()
    after = []
    for _ in range(3):
        graphed.train()
        after.append(allocated())
    assert after[0] == after[1] == after[2]


# ---- the other eight convs and the id and sparse-id encoder in a loop -----

CONV_LOOPS = ("tag", "sgcn", "agnn", "appnp", "graph", "arma", "dna",
              "gated", "encoder")


def conv_loop_estimators(dev, conv):
    """(graph, estimator with steps_per_loop = LOOP_SPL, one with 1) of a
    sage-flow model over ``conv``; "encoder" is sage over the id table and
    a ``tags`` sparse feature (4 ids a node at most, -1 padded)."""
    graph = random_graph(3000, 50, feat_dim=16, n_classes=4, seed=0,
                         device=dev)
    if conv == "encoder":
        rng = np.random.default_rng(0)
        ids = rng.integers(0, 500, (3000, 4)).astype(np.int32)
        ids[rng.random((3000, 4)) < 0.4] = -1
        graph.tensors = dataclasses.replace(graph.tensors, sparse_nf={
            "tags": (torch.from_numpy(ids).to(dev),
                     torch.from_numpy((ids >= 0).sum(1).astype(np.int32))
                     .to(dev))})

    def make():
        gen = torch.Generator().manual_seed(0)
        if conv == "encoder":
            enc = ShallowEncoder(("feature",), use_id=True, max_id=2999,
                                 id_dim=8, sparse_names=("tags",),
                                 sparse_buckets=64, sparse_dim=8,
                                 generator=gen)
            name, in_dim = "sage", 32
        else:
            enc, name, in_dim = ShallowEncoder(("feature",)), conv, 16
        net = GNNNet(name, SageDataFlow([5, 3], [(0,), (0,)]), (16, 16),
                     enc, in_dim=in_dim, device=dev, generator=gen)
        return SuperviseModel(net, "label", 4, device=dev, generator=gen)
    # the encoder trains with SGD: its tables' atomic sums differ in the
    # last bits, which Adam's step (over the gradient's RMS) can blow up
    # to the learning rate where a sum lies within rounding of zero
    cfg = RunConfig(batch_size=256, total_steps=2 * LOOP_SPL,
                    optimizer="sgd" if conv == "encoder" else "adam",
                    learning_rate=1e-3, log_steps=0,
                    reservoir_refresh=LOOP_SPL, steps_per_loop=LOOP_SPL,
                    seed=3)
    return (graph, NodeEstimator(make(), graph, cfg, device=dev),
            NodeEstimator(make(), graph,
                          dataclasses.replace(cfg, steps_per_loop=1),
                          device=dev))


@pytest.mark.parametrize("conv", CONV_LOOPS)
def test_conv_replayed_loop_equals_eager_steps(dev, conv):
    """Bit for bit, but for the encoder, whose tables' backward sums
    repeated ids with index_add_ atomics in no fixed order; 2 + 2
    launches a step either way."""
    graph, graphed, eager = conv_loop_estimators(dev, conv)
    g = graph.tensors
    pack = g.fan_pack.clone()
    losses, counts = [], []
    for est in (eager, graphed):
        g.fan_pack.copy_(pack)
        before = (fd.fan_draw.launches, gr.gather_rows.launches)
        losses.append(est.train()["loss"])
        torch.cuda.synchronize()
        counts.append((fd.fan_draw.launches - before[0],
                       gr.gather_rows.launches - before[1]))
    assert counts == [(2 * 2 * LOOP_SPL,) * 2] * 2
    pairs = list(zip(graphed.model.parameters(), eager.model.parameters()))
    if conv == "encoder":
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4,
                                   atol=1e-5)
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    else:
        assert losses[0] == losses[1]
        assert all(torch.equal(a, b) for a, b in pairs)


# ---- the walk family: DeepWalk, Node2Vec, LINE ----------------------------

WALK_FAMILY = ("deepwalk", "node2vec", "line1", "line2")


def walk_setup(dev, name):
    """A 3000-node graph with the general packs and the in-CSR, and one
    of the walk models on it at 16 wide: walks of 5 steps, 4 negatives,
    node2vec with p = 0.5, q = 2."""
    graph = random_graph(3000, 25, seed=0, packs=WALK_PACKS,
                         build_in_edges=True, device=dev)
    gen = torch.Generator().manual_seed(0)
    if name.startswith("line"):
        model = LINE(3000, 16, (0,), order=int(name[-1]), num_negs=4,
                     device=dev, generator=gen)
    else:
        kw = dict(walk_p=0.5, walk_q=2.0) if name == "node2vec" else {}
        cls = Node2Vec if name == "node2vec" else DeepWalk
        model = cls(3000, 16, (0,), walk_len=5, num_negs=4, device=dev,
                    generator=gen, **kw)
    return graph, model


@pytest.mark.parametrize("name", WALK_FAMILY)
def test_walk_step_on_card_matches_cpu(dev, name):
    """On the same uniforms: LINE's positives, negatives, loss and
    gradients; the walks equal but for near ties of the exact node2vec
    step (its keys pass through log), then the skip-gram head's loss and
    gradients within 1e-4 (``chip_smoke.walk_grads``), no kernel
    launched."""
    graph, model = walk_setup(dev, name)
    before = (fd.fan_draw.launches, gr.gather_rows.launches)
    out = walk_grads(name, model, graph, graph.tensors.to("cpu"), dev)
    assert (fd.fan_draw.launches, gr.gather_rows.launches) == before
    assert out["n_params"] == (1 if name == "line1" else 2)
    assert out["pos_valid_share"] > 0.9


@pytest.mark.parametrize("name", WALK_FAMILY)
def test_walk_replayed_loop_equals_eager_steps(dev, name):
    """A loop of LOOP_SPL replays equals as many eager steps under SGD bit
    for bit: the tables' backward sums in a fixed order
    (``Embed(fixed_order=True)``). No kernel is launched."""
    graph, _ = walk_setup(dev, name)
    cfg = RunConfig(batch_size=256, total_steps=2 * LOOP_SPL,
                    optimizer="sgd", learning_rate=0.05, log_steps=0,
                    steps_per_loop=LOOP_SPL, seed=3, metric="mrr")
    ests = [NodeEstimator(walk_setup(dev, name)[1], graph, c, device=dev)
            for c in (cfg, dataclasses.replace(cfg, steps_per_loop=1))]
    losses = []
    before = (fd.fan_draw.launches, gr.gather_rows.launches)
    for est in ests:
        losses.append(est.train()["loss"])
    torch.cuda.synchronize()
    assert (fd.fan_draw.launches, gr.gather_rows.launches) == before
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    assert all(torch.equal(a, b) for a, b in zip(ests[0].model.parameters(),
                                                 ests[1].model.parameters()))
    assert 0 < ests[0].evaluate(np.arange(512))["mrr"] <= 1


# ---- the layerwise flows and the rest of the models -----------------------

@pytest.mark.parametrize("name", REST_FAMILIES)
def test_rest_step_on_card_matches_cpu(dev, name):
    """One step on a 10,000-node graph (the motif graph for gin) from the
    same weights, batch and draws: loss and every gradient within 1e-4."""
    out = rest_vs_cpu(name, dev)
    assert out["draws"] > 0 and np.isfinite(out["loss"])


@pytest.mark.parametrize("name", REST_FAMILIES)
def test_rest_replayed_loop_equals_eager_steps(dev, name):
    graph = motif_graph(60, device=dev) if name.startswith("gin_") else \
        random_graph(3000, 25, feat_dim=128, n_classes=16, seed=0,
                     packs=REST_PACKS, device=dev)
    cfg = RunConfig(batch_size=32 if name.startswith("gin_") else 128,
                    total_steps=2 * LOOP_SPL, learning_rate=1e-3,
                    log_steps=0, reservoir_refresh=0,
                    steps_per_loop=LOOP_SPL, seed=3, metric="mrr")
    ests = [rest_estimator(name, rest_model(name, dev, graph.meta.n_nodes),
                           graph, c, dev)
            for c in (cfg, dataclasses.replace(cfg, steps_per_loop=1))]
    ests[1].model.load_state_dict(ests[0].model.state_dict())
    losses, counts = [], []
    for est in ests:
        before = (fd.fan_draw.launches, gr.gather_rows.launches)
        losses.append(est.train()["loss"])
        torch.cuda.synchronize()
        counts.append((fd.fan_draw.launches - before[0],
                       gr.gather_rows.launches - before[1]))
    fan, gat = REST_LAUNCHES[name]
    assert counts == [(fan * 2 * LOOP_SPL, gat * 2 * LOOP_SPL)] * 2
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    assert all(torch.equal(a, b) for a, b in zip(
        ests[0].model.state_dict().values(),
        ests[1].model.state_dict().values()))



# ------------------------------------------- the fan-less and payload hops --

@pytest.mark.parametrize("packs", [(), ("group", "adj", "sample")])
def test_fallback_hop_on_card_matches_cpu(dev, packs):
    graph = random_graph(2000, 12, num_edge_types=4, seed=3, packs=packs)
    g, g_cpu = graph.tensors, graph.tensors.to("cpu")
    nodes = torch.arange(-1, 600, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    fd.fan_draw.launches = 0
    for ets in ((0,), (1, 2), (0, 1, 2, 3)):
        assert sampling.hop_kind(g, ets) == "sampled"
        u = sampling.draw_neighbor_uniforms(g, ets, gen, len(nodes), 9, dev)
        got = sampling.select_neighbors(g, nodes, ets, u, return_types=True)
        want = sampling.select_neighbors(g_cpu, nodes.cpu(), ets,
                                         [x.cpu() for x in u],
                                         return_types=True)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        assert float(got[1].float().mean()) > 0.9
    assert fd.fan_draw.launches == 0


def test_payload_hop_on_card_matches_cpu(dev):
    graph = random_graph(2000, 12, num_edge_types=4, seed=5,
                         packs=("sample",))
    g, g_cpu = graph.tensors, graph.tensors.to("cpu")
    flow = SageDataFlow([6, 4], [(0, 1, 2, 3), (2, 0)], payload=True)
    roots = torch.arange(-1, 300, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    uniforms, n = [], len(roots)
    for ets, c in zip(flow.metapath, flow.fanouts):
        uniforms.append(flow.draw_hop(g, ets, gen, n, c, dev))
        n *= 1 + c
    fd.fan_draw.launches = 0
    got = flow(g, roots, uniforms=uniforms)
    want = flow(g_cpu, roots.cpu(),
                uniforms=[tuple(x.cpu() for x in u) for u in uniforms])
    assert fd.fan_draw.launches == 0
    for bk, bc in zip(got, want):
        for name in ("n_id", "edge_index", "e_id", "edge_weight", "mask",
                     "e_type"):
            assert torch.equal(getattr(bk, name).cpu(), getattr(bc, name)), \
                name
    assert bool((got[-1].e_id >= 0).any())


def test_bf16_feature_table_through_gather_rows(dev, tmp_path):
    ds = SBMDataset(str(tmp_path), n_nodes=500, feat_dim=24, seed=1)
    graph = ds.load_graph(device=dev, feature_dtype=torch.bfloat16)
    table = graph.tensors.dense_nf["feature"]
    assert table.dtype == torch.bfloat16 and table.is_cuda
    f32 = ds.load_graph(device="cpu").tensors.dense_nf["feature"]
    assert torch.equal(table.cpu(), f32.to(torch.bfloat16))
    ids = torch.tensor([0, -1, 499, 500, 7, 7], dtype=torch.int32,
                       device=dev)
    gr.gather_rows.launches = 0
    got = ShallowEncoder(("feature", "label"))(graph.tensors, ids)
    torch.cuda.synchronize()
    assert gr.gather_rows.launches == 2 and got.dtype == torch.bfloat16
    want = gr.gather_rows_plain(
        torch.cat([table, graph.tensors.dense_nf["label"]], 1).cpu(),
        ids.cpu())
    assert torch.equal(int_view(got.cpu()), int_view(want))


def test_fan_less_sage_step_launches_no_fan_draw(dev):
    graph = random_graph(3000, 25, feat_dim=16, n_classes=4, seed=0,
                         packs=())
    gen = torch.Generator().manual_seed(0)
    net = GNNNet("sage", SageDataFlow([25, 10], [(0,), (0,)]), (16, 16),
                 ShallowEncoder(("feature",)), in_dim=16, generator=gen)
    model = SuperviseModel(net, "label", 4, generator=gen)
    est = NodeEstimator(model, graph, RunConfig(batch_size=64))
    opt = get_optimizer("adam", 1e-3, model.parameters())
    ugen = torch.Generator(device=dev).manual_seed(1)
    fd.fan_draw.launches = gr.gather_rows.launches = 0
    loss = est.step(opt, est.train_batch(graph.tensors, ugen),
                    generator=ugen)
    torch.cuda.synchronize()
    assert (fd.fan_draw.launches, gr.gather_rows.launches) == (0, 2)
    assert bool(torch.isfinite(loss))


# ------------------------------------------------ the query path and KNN --

@pytest.fixture
def query_graph(dev):
    graph = random_graph(3000, 12, feat_dim=16, n_classes=4,
                         num_edge_types=2, seed=7)
    g = graph.tensors
    g_idx = index_ops.build_attr_index(g, [("feature", 0)])
    return {"plain": (g, g.to("cpu")), "indexed": (g_idx, g_idx.to("cpu"))}


def query_ids(dev):
    ids = np.random.default_rng(3).integers(0, 3000, 300).astype(np.int32)
    ids[::17] = -1
    return torch.from_numpy(ids).to(dev)


@pytest.mark.parametrize("name", list(smoke_queries(None)))
def test_query_on_card_matches_cpu(dev, query_graph, name):
    build, where, gathers = smoke_queries(query_ids(dev))[name]
    g, g_cpu = query_graph[where]
    q = build(Query(g))
    with KernelRecorder(eager=True) as rec:
        fd.fan_draw.launches = gr.gather_rows.launches = 0
        card = q.run(generator=torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        assert (fd.fan_draw.launches, gr.gather_rows.launches) == \
            (0, gathers)
    assert rec.check_plain(name)["gather_rows"] == gathers
    cpu = build(Query(g_cpu)).run(uniforms=to_device(q.last_uniforms,
                                                     "cpu"))
    same_query_results(card, cpu, name, close=("m",))


def test_query_layer_on_card_matches_cpu_but_for_near_ties(dev,
                                                           query_graph):
    g, g_cpu = query_graph["plain"]
    with DrawReplay() as rep:
        Query(g).v(query_ids(dev)).sampleLNB([0, 1], 8, 500).run(
            generator=torch.Generator(device=dev).manual_seed(2))
    assert rep.check_layers(g_cpu)["layer_selects"] == 1


def test_index_draws_on_card_match_cpu(dev, query_graph):
    g, g_cpu = query_graph["indexed"]
    gen = torch.Generator(device=dev).manual_seed(3)
    for p in (index_ops.Pred("feature", "gt", 0.3),
              index_ops.Pred("feature", "not_in", (0.0, 1.0)),
              index_ops.Pred("feature", "le", -2.0)):
        u = index_ops.draw_indexed_uniforms(gen, 5000, dev)
        got = index_ops.select_indexed(g, p, u)
        assert torch.equal(got.cpu(), index_ops.select_indexed(
            g_cpu, p, to_device(u, "cpu")))
    w = torch.rand(5_000_000, generator=gen, device=dev)
    assert torch.equal(sampling.row_cdf(w[None]).cpu(),
                       sampling.row_cdf(w[None].cpu()))
    u = index_ops.draw_masked_uniforms(gen, 4096, dev)
    assert torch.equal(index_ops.select_masked(w, u).cpu(),
                       index_ops.select_masked(w.cpu(), u.cpu()))


def test_ivf_on_card_matches_cpu(dev):
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 4, (16, 32))
    emb = (centers[rng.integers(0, 16, 4000)]
           + rng.normal(0, 1, (4000, 32))).astype(np.float32)
    card = knn.IvfKnnIndex(emb, n_clusters=16, nprobe=3, device=dev)
    cpu = knn.IvfKnnIndex(emb, n_clusters=16, nprobe=3, device="cpu")
    assert float((card._cent.cpu() - cpu._cent).abs().max()) <= 1e-4
    assert torch.equal(card._members.cpu(), cpu._members)
    q = emb[:100] + 0.1
    gr.gather_rows.launches = 0
    d, i = card.search(q, k=10)
    assert gr.gather_rows.launches == 1
    dc, ic = cpu.search(q, k=10)
    np.testing.assert_array_equal(i, ic)
    np.testing.assert_allclose(d, dc, rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="k argument to top_k"):
        knn.KnnIndex(emb[:5], device=dev).search(q, k=8)


# ---------------------------------------------------------------------------
# the sharded apply: ranks on the card (tests/test_torch_mesh_ranks.py)
# ---------------------------------------------------------------------------

MESH_OPTS = dict(feat_dim=16, label_dim=4, fanouts=[5, 3], dims=[16, 8],
                 seed=3)


def mesh_on_card(tmp_path, dev, graph: int, backend: str):
    """``graph`` ranks of one graph group on the card over ``backend``,
    each serving 64 roots of a small random graph through
    ``make_sharded_apply`` from its group's U_all; returns each rank's
    outputs and the one-card forward of every rank's roots."""
    from euler_tpu_torch.parallel import sharded
    from tests import test_torch_mesh_ranks
    g = random_graph(2000, 10, feat_dim=16, n_classes=4, seed=7, device=dev)
    arrays, want = test_torch_mesh_ranks.apply_inputs(
        g.tensors, 1, graph, 64, MESH_OPTS, seed=4)
    test_torch_mesh_ranks.write_work(
        str(tmp_path), 1, graph, dict(apply=sharded.build_sharded(g, graph)),
        {f"apply/{k}": v for k, v in arrays.items()},
        [dict(name="apply", verb="apply", graph="apply", opts=MESH_OPTS)],
        120, device="cuda", backend=backend)
    return test_torch_mesh_ranks.launch(str(tmp_path), graph, 240), want


def check_mesh(outs, want):
    emb = torch.cat([w["embedding"] for w in want]).cpu().numpy()
    logit = torch.cat([w["logit"] for w in want]).cpu().numpy()
    for got in outs:
        np.testing.assert_array_equal(got["apply/0"], emb)
        np.testing.assert_array_equal(got["apply/1"], logit)


def test_mesh_two_gloo_ranks_on_card_equal_one_card_forward(dev, tmp_path):
    check_mesh(*mesh_on_card(tmp_path, dev, 2, "gloo"))


def test_mesh_one_nccl_rank_equals_one_card_forward(dev, tmp_path):
    check_mesh(*mesh_on_card(tmp_path, dev, 1, "nccl"))
