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
on both, different summation order).
"""
import copy

import numpy as np
import pytest
import torch

from chip_smoke import int_view, synthetic_fan_pack
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.models import GNNNet, ShallowEncoder, SuperviseModel
from euler_tpu_torch.ops import fan_draw as fd
from euler_tpu_torch.ops import gather_rows as gr
from euler_tpu_torch.ops import sampling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,C", [(1024, 25), (26_624, 10), (1021, 25)])
def test_kernel_matches_plain(dev, B, C):
    gen = torch.Generator(device=dev).manual_seed(B)
    G = 4096
    packs = torch.from_numpy(synthetic_fan_pack(np.random.default_rng(B),
                                                G)).to(dev)
    nodes = torch.randint(0, G, (B,), generator=gen, dtype=torch.int32,
                          device=dev)
    nodes[::17] = -1
    u1, u2 = sampling.draw_fan_uniforms(gen, B, C, dev)
    before = fd.fan_draw.launches
    ids, valid = fd.fan_draw(packs, nodes, 0, 1, u1, u2, -1)
    torch.cuda.synchronize()
    assert fd.fan_draw.launches == before + 1
    ref_ids, ref_valid = fd.fan_draw_plain(packs, nodes, 0, 1, u1, u2, -1)
    assert torch.equal(ids, ref_ids)
    assert torch.equal(valid, ref_valid)


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


@pytest.mark.parametrize("N,D,M,dtype,W,off", [
    (200_000, 128, 292_864, torch.float32, None, 0),
    (200_000, 128, 292_864, torch.bfloat16, None, 0),
    (200_000, 16, 1024, torch.float32, None, 0),
    (5000, 1, 10_007, torch.float32, None, 0),
    (5000, 3, 10_007, torch.float32, None, 0),
    (5000, 127, 10_007, torch.float32, None, 0),
    (5000, 5, 10_007, torch.bfloat16, None, 0),
    (5000, 128, 4099, torch.float32, 256, 128),
    (5000, 128, 4099, torch.bfloat16, 264, 8),
    (5000, 64, 4099, torch.float32, 300, 37)])
def test_gather_kernel_matches_plain(dev, N, D, M, dtype, W, off):
    gen = torch.Generator(device=dev).manual_seed(M + D)
    table = torch.randn((N, D), generator=gen, device=dev, dtype=dtype)
    ids = torch.randint(0, N, (M,), generator=gen, dtype=torch.int32,
                        device=dev)
    ids[::13] = -1
    ids[5::101] = N + 3
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
    assert torch.isnan(got[5, off:off + D]).all()


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
