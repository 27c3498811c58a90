"""Graph store of the PyTorch port against euler_tpu's, array for array.

Both packages build the same host arrays (CSR, per-group alias tables,
fan rows) from the same inputs, so every device array must be equal.
Alias tables are not unique, so each comparison first makes both sides
take the same path: both native, or both numpy. The native CSR build
scatters large edge sets from several threads, which leaves the order of
duplicate (src, type, dst) edges open; large graphs therefore compare
with the numpy CSR sort on both sides.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from euler_tpu.datasets.random_graph import random_graph as jax_random_graph
from euler_tpu.graph import load_graph as jax_load_graph
from euler_tpu.native import loader as jax_native
from euler_tpu.ops import alias as jax_alias
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.native import loader as native
from euler_tpu_torch.ops import alias

FIELDS = ("group_ptr", "adj_dst", "adj_prob", "adj_alias", "group_w_sum",
          "fan_pack", "fan_over_rows")

_NATIVE_BUILDERS = ("build_csr_native", "build_group_alias_native",
                    "build_alias_native")


@contextlib.contextmanager
def native_off(names=_NATIVE_BUILDERS):
    """Force the numpy path of the named host builders in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_native, native):
            for name in names:
                mp.setattr(mod, name, lambda *a, **k: None)
        yield


def random_pair(n_nodes, avg_degree, **kw):
    """(euler_tpu Graph, port Graph on the CPU) from the same arguments,
    with the numpy CSR sort on both sides (see the module docstring)."""
    with native_off(("build_csr_native",)):
        gj = jax_random_graph(n_nodes, avg_degree, packs=("fan",), **kw)
        gt = random_graph(n_nodes, avg_degree, device="cpu", **kw)
    return gj, gt


def assert_tensors_equal(gj, gt):
    tj, tt = gj.tensors, gt.tensors
    for name in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(tj, name)),
            getattr(tt, name).numpy(), err_msg=name)
    assert set(tj.dense_nf) == set(tt.dense_nf)
    for name in tj.dense_nf:
        np.testing.assert_array_equal(np.asarray(tj.dense_nf[name]),
                                      tt.dense_nf[name].numpy(),
                                      err_msg=f"dense_nf[{name}]")
    np.testing.assert_array_equal(gj.ext_ids, gt.ext_ids)


def test_native_core_loads_like_the_reference():
    # both sides must take the same (native or numpy) path
    assert native.available() == (jax_native.get_lib() is not None)


def test_toy_graph_native_path_equal(toy_dir, toy_graph):
    gt = load_graph(toy_dir, device="cpu")
    assert_tensors_equal(toy_graph, gt)
    assert gt.local_id(103) == toy_graph.local_id(103)
    assert gt.meta.to_json() == toy_graph.meta.to_json()


def test_toy_graph_numpy_path_equal(toy_dir):
    with native_off():
        gj = jax_load_graph(toy_dir, packs=("fan",))
        gt = load_graph(toy_dir, device="cpu")
    assert_tensors_equal(gj, gt)


@pytest.mark.parametrize("n_nodes,avg_degree", [(2000, 25), (300, 50)])
def test_random_graph_equal(n_nodes, avg_degree):
    gj, gt = random_pair(n_nodes, avg_degree, feat_dim=16, n_classes=4,
                         seed=0)
    assert_tensors_equal(gj, gt)


def test_reservoir_rows_present_on_dense_graph():
    # the (300, 50) case above covers fan rows of degree > FAN_D
    _, gt = random_pair(300, 50, seed=0)
    over = gt.tensors.fan_over_rows.numpy()
    assert len(over) > 0
    fp = gt.tensors.fan_pack.numpy()[over]
    assert (fp[:, 0] == alias.FAN_D).all()
    ones = np.float32(1.0).view(np.int32)
    assert (fp[:, alias.FAN_PROB_OFF:alias.FAN_PROB_OFF + alias.FAN_D]
            == ones).all()


@pytest.mark.parametrize("n", [0, 5, 5000])
def test_alias_table_equal(n):
    w = np.random.default_rng(n).random(n).astype(np.float32) + 0.05
    pj, aj = jax_alias.build_alias_table(w)
    pt, at = alias.build_alias_table(w)
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_array_equal(aj, at)


def test_group_alias_numpy_path_equal():
    rng = np.random.default_rng(3)
    gp = np.concatenate([[0], np.cumsum(rng.integers(0, 9, 50))])
    w = rng.random(gp[-1]).astype(np.float32) + 0.1
    with native_off():
        pj, aj = jax_alias.build_group_alias(gp, w)
        pt, at = alias.build_group_alias(gp, w)
    np.testing.assert_array_equal(pj, pt)
    np.testing.assert_array_equal(aj, at)


def test_graph_tensors_to_moves_every_tensor():
    _, gt = random_pair(50, 4, feat_dim=3, seed=1)
    moved = gt.tensors.to("meta")
    assert moved.fan_pack.device.type == "meta"
    assert moved.dense_nf["feature"].device.type == "meta"
    assert gt.tensors.fan_pack.device.type == "cpu"


def test_entry_points_need_cuda_or_an_explicit_device(monkeypatch,
                                                      toy_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_graph(10, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_graph(toy_dir)


def test_unported_packs_are_refused():
    # every pack of the reference is ported ("group", "adj" and "sample":
    # tests/test_torch_verbs.py); a name that is none of them is refused
    with pytest.raises(NotImplementedError, match="not ported"):
        random_graph(10, 2, packs=("fan", "adjacency"), device="cpu")
