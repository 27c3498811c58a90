"""The whole-graph gcn training step of the PyTorch port against
euler_tpu, in f32 on the CPU, and the off-card gcn bench.

gcn at toy width (dims (16, 8), 2 layers, ``WholeDataFlow`` over the ELL
pack of a 300-node, 4-type graph, every node a root) with the flax
parameters loaded: the ``SuperviseModel`` loss and every gradient within
1e-4 of ``jax.value_and_grad``, and 3 Adam steps through
``BaseEstimator.step`` within 1e-4 of optax (loss and parameters). The
reference's init, loss and gradients are compiled once by ``jax.jit`` for
both tests.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from euler_tpu.dataflow import flows as jax_flows
from euler_tpu.models import encoders as jax_encoders
from euler_tpu.models import gnn as jax_gnn
from euler_tpu_torch import bench
from euler_tpu_torch.dataflow import WholeDataFlow
from euler_tpu_torch.estimator import NodeEstimator, RunConfig, get_optimizer
from euler_tpu_torch.models import (GNNNet, ShallowEncoder, SuperviseModel,
                                    load_flax_params)
from tests.test_torch_train import _as_port
from tests.test_torch_whole import typed_pair  # noqa: F401 (a fixture)

KEY = jax.random.PRNGKey(2)         # the flow draws nothing from it
ROOTS = jnp.arange(300, dtype=jnp.int32)
MODEL = jax_gnn.SuperviseModel(
    embedder=jax_gnn.GNNNet(
        conv="gcn", flow=jax_flows.WholeDataFlow(2, [(0, 1, 2, 3)]),
        dims=(16, 8),
        feature=jax_encoders.ShallowEncoder(dense_names=("feature",))),
    label_name="label", label_dim=4)


@jax.jit
def _init(g, seed):
    return MODEL.init({"params": jax.random.PRNGKey(seed),
                       "sample": jax.random.PRNGKey(1)}, g, ROOTS)


@jax.jit
def _loss_and_grads(g, variables):
    return jax.value_and_grad(lambda p: MODEL.apply(
        p, g, ROOTS, rngs={"sample": KEY})["loss"])(variables)


def _gcn_models(gj, seed=0):
    """(variables, port model with their weights): gcn at dims (16, 8)
    over all four edge types of the typed graph."""
    variables = _init(gj.tensors, seed)
    port = SuperviseModel(
        GNNNet("gcn", WholeDataFlow(2, [(0, 1, 2, 3)]), (16, 8),
               ShallowEncoder(("feature",)), in_dim=16, device="cpu"),
        "label", 4, device="cpu")
    load_flax_params(port, jax.tree.map(np.asarray, variables))
    return variables, port


def test_gcn_supervise_model_loss_and_gradients_match(typed_pair):
    gj, gt = typed_pair
    variables, port = _gcn_models(gj)
    loss_j, grads_j = _loss_and_grads(gj.tensors, variables)
    out = port(gt.tensors, torch.arange(300, dtype=torch.int32))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(loss_j), rtol=1e-4,
                               atol=1e-4)
    want = _as_port(port, grads_j)
    names = [n for n, _ in port.named_parameters()]
    assert sorted(want) == sorted(names) and len(names) == 5
    for name, p in port.named_parameters():
        assert np.abs(want[name]).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_gcn_three_adam_steps_match_optax(typed_pair):
    gj, gt = typed_pair
    params, port = _gcn_models(gj, seed=4)
    tx = optax.adam(1e-3)
    state = tx.init(params)
    update = jax.jit(tx.update)
    est = NodeEstimator(port, gt, RunConfig(batch_size=300), device="cpu")
    opt = get_optimizer("adam", 1e-3, port.parameters())
    r = torch.arange(300, dtype=torch.int32)
    for k in range(3):
        loss_j, grads_j = _loss_and_grads(gj.tensors, params)
        upd, state = update(grads_j, state, params)
        params = optax.apply_updates(params, upd)
        loss_t = est.step(opt, r)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4,
                                   atol=1e-4, err_msg=f"loss step {k}")
        want = _as_port(port, params)
        for n, p in port.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n],
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{n} step {k}")


# --------------------------------------------------------------- bench --

def test_bench_gcn_prints_bench_py_lines_on_the_cpu(capsys):
    # the command line ``python -m euler_tpu_torch.bench --model gcn
    # --device cpu``, in this process
    assert bench.main(["--model", "gcn", "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert [r["phase"] for r in lines] == ["warmup", "single_loop",
                                           "pipelined"]
    for r in lines:
        assert r["metric"] == "fullgraph_spmm_edges_per_sec_per_chip"
        assert r["model"] == "gcn" and r["platform"] == "cpu"
        assert r["config"] == "full_n2000_e50000_l2" and r["value"] > 0
        assert r["vs_baseline"] is None
