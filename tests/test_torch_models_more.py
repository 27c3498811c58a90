"""Whole models over the eight other convs of the registry, and
``JKGNNNet``, of the PyTorch port against euler_tpu, in f32 on the CPU.

- Each conv's ``SuperviseModel`` through ``SageDataFlow`` with the
  reference's uniforms replayed: sampled blocks equal, embeddings and
  loss within rtol = atol = 1e-5, every parameter's gradient within
  1e-4 against ``jax.value_and_grad``.
- AGNN and APPNP output their input width: at input width 4 and dims
  (16, 8) ``out_fc`` reads 4 columns, as flax's lazily shaped Dense.
- ``JKGNNNet`` in both modes (``maxpool`` is the reference's sum).
- The examples' whole-graph configurations (``WholeDataFlow(2, ...)``)
  for tag, sgcn, agnn, appnp and arma: the port's ELL pack and edge list
  against the reference's edge list (tests/test_models.py:293-333's
  tolerances: forward rtol 2e-5 / atol 2e-6, gradients rtol 2e-4 / atol
  2e-5).

Each reference case compiles once: init, apply and the gradients under
one ``jax.jit``, the key the flow received returned as an output.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.models import (GNNNet, JKGNNNet, ShallowEncoder,
                                    SuperviseModel, load_flax_params)
from tests.test_torch_graph import native_off, random_pair
from tests.test_torch_models import RecordingFlow, hop_uniforms
from tests.test_torch_train import _as_port
from tests.test_torch_whole import _whole_model_parity

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
FANOUTS, B = [3, 2], 32
CONVS = ["tag", "sgcn", "agnn", "appnp", "graph", "arma", "dna", "gated"]


@functools.lru_cache(maxsize=None)
def graphs(feat_dim):
    return random_pair(2000, 25, feat_dim=feat_dim, n_classes=4, seed=0)


def roots():
    r = np.arange(5, 5 + B, dtype=np.int32)
    r[-2:] = -1                                   # padded batch rows
    return r


@functools.lru_cache(maxsize=None)
def reference(kind, conv, feat_dim, dims, jk_mode=None):
    """(reference's loss, outputs, grads and params, the key its flow
    drew from, the port model with the params loaded). ``kind`` is
    "gnn" or "jk"."""
    gj, _ = graphs(feat_dim)
    metapath = [(0,), (0,)]
    flow = RecordingFlow(jax_flows.SageDataFlow(FANOUTS, metapath))
    feat = jax_encoders.ShallowEncoder(dense_names=("feature",))
    if kind == "jk":
        net = jax_gnn.JKGNNNet(conv=conv, flow=flow, dims=dims,
                               feature=feat, jk_mode=jk_mode)
        pnet = JKGNNNet(conv, SageDataFlow(FANOUTS, metapath), dims,
                        ShallowEncoder(("feature",)), in_dim=feat_dim,
                        jk_mode=jk_mode, device="cpu")
    else:
        net = jax_gnn.GNNNet(conv=conv, flow=flow, dims=dims, feature=feat)
        pnet = GNNNet(conv, SageDataFlow(FANOUTS, metapath), dims,
                      ShallowEncoder(("feature",)), in_dim=feat_dim,
                      device="cpu")
    model = jax_gnn.SuperviseModel(embedder=net, label_name="label",
                                   label_dim=4)

    def run(g, r):
        params = model.init({"params": jax.random.PRNGKey(0),
                             "sample": jax.random.PRNGKey(1)}, g, r)

        def loss(p):
            flow.keys.clear()
            out = model.apply(p, g, r, rngs={"sample": jax.random.PRNGKey(7)})
            return out["loss"], (out, flow.keys[-1])
        (lv, (out, key)), grads = jax.value_and_grad(loss, has_aux=True)(
            params)
        return params, lv, out, key, grads
    params, lv, out, key, grads = jax.jit(run)(gj.tensors,
                                               jnp.asarray(roots()))
    port = load_flax_params(SuperviseModel(pnet, "label", 4, device="cpu"),
                            jax.tree.map(np.asarray, params))
    return float(lv), out, key, grads, port


def check_model(kind, conv, feat_dim=16, dims=(16, 16), jk_mode=None,
                special=None):
    loss_j, out_j, key, grads_j, port = reference(kind, conv, feat_dim,
                                                  dims, jk_mode)
    _, gt = graphs(feat_dim)
    out = port(gt.tensors, torch.from_numpy(roots()),
               uniforms=hop_uniforms(key, B, FANOUTS))
    for name in ("embedding", "logit", "label", "valid"):
        np.testing.assert_allclose(out[name].detach().numpy(),
                                   np.asarray(out_j[name]), err_msg=name,
                                   **TOL)
    np.testing.assert_allclose(out["loss"].item(), loss_j, **TOL)
    out["loss"].backward()
    want = _as_port(port, grads_j)
    if special is not None:
        assert any(n.endswith(special) for n in want), special
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], err_msg=name,
                                   **GRAD_TOL)
    return port


SPECIAL = {"tag": "fc.weight", "sgcn": "fc.weight", "agnn": "beta",
           "appnp": "out_fc.weight", "graph": "self_fc.bias",
           "arma": "vs.0.weight", "dna": "q.bias",
           "gated": "gru.gates.hn.bias"}


@pytest.mark.parametrize("conv", CONVS)
def test_conv_family_forward_loss_and_gradients_match(conv):
    check_model("gnn", conv, special=SPECIAL[conv])


@pytest.mark.parametrize("conv", ["agnn", "appnp"])
def test_propagation_convs_keep_the_input_width_in_a_net(conv):
    # input 4, dims (16, 8): both convs output 4 columns, so out_fc is
    # [4 -> 8], where cls(widths[i], widths[i+1]) would have built 16
    port = check_model("gnn", conv, feat_dim=4, dims=(16, 8))
    assert tuple(port.embedder.out_fc.weight.shape) == (8, 4)


@pytest.mark.parametrize("conv,jk_mode,feat_dim", [
    ("sage", "concat", 16), ("sage", "maxpool", 16),
    ("agnn", "concat", 4)])
def test_jk_net_matches(conv, jk_mode, feat_dim):
    port = check_model("jk", conv, feat_dim=feat_dim, dims=(16, 16),
                       jk_mode=jk_mode)
    width = {"concat": 2, "maxpool": 1}[jk_mode] * (
        4 if conv == "agnn" else 16)
    assert port.embedder.out_fc.weight.shape[1] == width


def test_jk_maxpool_is_a_sum():
    # the reference's "maxpool" sums the layers (gnn.py:144-145): with the
    # same convs, concat through out_fc weights [W, W] equals maxpool
    # through W, W (h1 + h2) = [W, W] [h1; h2]
    _, gt = graphs(16)

    def net(mode):
        return JKGNNNet("sage", SageDataFlow(FANOUTS, [(0,), (0,)]),
                        (16, 16), ShallowEncoder(("feature",)), in_dim=16,
                        jk_mode=mode, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    pool, cat = net("maxpool"), net("concat")
    cat.convs.load_state_dict(pool.convs.state_dict())
    with torch.no_grad():
        cat.out_fc.weight.copy_(pool.out_fc.weight.repeat(1, 2))
        cat.out_fc.bias.copy_(pool.out_fc.bias)
    r = torch.from_numpy(roots())
    with torch.no_grad():
        a = pool(gt.tensors, r, generator=torch.Generator().manual_seed(1))
        b = cat(gt.tensors, r, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="jk_mode"):
        net("max")


@functools.lru_cache(maxsize=None)
def whole_graphs():
    """300 nodes, 4 edge types, 16-wide features and 4 labels."""
    kw = dict(feat_dim=16, n_classes=4, num_edge_types=4, seed=3)
    with native_off():
        return (jax_random_graph(300, 6, packs=("ell",), **kw),
                random_graph(300, 6, packs=("ell",), device="cpu", **kw))


@pytest.mark.parametrize("conv", ["tag", "sgcn", "agnn", "appnp", "arma"])
def test_examples_whole_graph_configurations_match(conv):
    # examples/{tagcn,sgcn,agnn,appnp,arma}: the conv on the whole-graph
    # flow; the port's pack and edge list against the reference's edges
    _whole_model_parity(whole_graphs(), conv, "feature", 16,
                        [(0, 1, 2, 3)], ("pack", "edge_list"))
