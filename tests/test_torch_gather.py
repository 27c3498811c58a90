"""The port's row gather (``gather_rows``) and the dense-feature path on it,
against euler_tpu on the CPU.

``gather_rows_plain`` (what the wrapper runs for CPU tensors) must equal
``euler_tpu.ops.feature_ops._take_rows`` bit for bit, NaN rows included:
the reference's ``jnp.take`` fills the row of an id >= N with NaN, and
ids < 0 give zero rows. Results are compared as integer views, so a NaN
must have the same bits on both sides. ``tools/micro/micro_pallas_gather
.py::pallas_gather``, the TPU kernel this gather ports, is TPU-only DMA
code; like its own check (micro_pallas_gather.py:76-78) the plain version
is also held to ``table[idx]`` on in-range ids. The CUDA kernel is held
to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from euler_tpu.models import encoders as jax_encoders
from euler_tpu.ops import feature_ops as jax_feature_ops
from euler_tpu_torch.graph import load_graph
from euler_tpu_torch.models import ShallowEncoder
from euler_tpu_torch.ops import feature_ops
from euler_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain

DTYPES = {"f32": (np.float32, torch.float32, np.int32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16, np.int16)}


def bits(x, int_dtype):
    """Integer view of a torch or jax array, for bit-exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int32 if int_dtype == np.int32 else torch.int16)
        return x.numpy()
    return np.asarray(x).view(int_dtype)


def make_case(seed, N, D, M, np_dtype):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, D)).astype(np_dtype)
    ids = rng.integers(0, N, M).astype(np.int32)
    ids[::7] = -1
    ids[3::11] = N + rng.integers(0, 5, len(ids[3::11]))
    ids[0], ids[1] = N, N - 1                     # the edge of the table
    return table, ids


def to_torch(table, dtype):
    return torch.from_numpy(table.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("N,D,M", [(200, 128, 1000), (50, 16, 64),
                                   (31, 1, 40), (31, 3, 40), (17, 127, 33),
                                   (9, 5, 20)])
def test_plain_matches_reference_take_rows(dt, N, D, M):
    np_dtype, t_dtype, int_dtype = DTYPES[dt]
    table, ids = make_case(N * D + M, N, D, M, np_dtype)
    want = jax_feature_ops._take_rows(jnp.asarray(table), jnp.asarray(ids),
                                      0.0)
    got = gather_rows_plain(to_torch(table, t_dtype), torch.from_numpy(ids))
    assert got.dtype == t_dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(bits(got, int_dtype),
                                  bits(want, int_dtype))
    assert torch.isnan(got[0]).all() and (got[7] == 0).all()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_table_index_on_valid_ids(dt):
    # the Pallas kernel's own check: out == table[idx] for idx in [0, N)
    np_dtype, t_dtype, int_dtype = DTYPES[dt]
    rng = np.random.default_rng(3)
    N, M = 2000, 2929
    table = torch.arange(N * 128, dtype=torch.float32).reshape(
        N, 128).to(t_dtype)
    idx = torch.from_numpy(rng.integers(0, N, M).astype(np.int32))
    got = gather_rows(table, idx)
    np.testing.assert_array_equal(bits(got, int_dtype),
                                  bits(table[idx.long()], int_dtype))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_column_offset_into_a_wider_output(dt):
    np_dtype, t_dtype, int_dtype = DTYPES[dt]
    table, ids = make_case(5, 40, 6, 25, np_dtype)
    t = to_torch(table, t_dtype)
    out = torch.full((25, 13), 7.0, dtype=t_dtype)
    ret = gather_rows(t, torch.from_numpy(ids), out, col_offset=4)
    assert ret is out
    want = gather_rows_plain(t, torch.from_numpy(ids))
    np.testing.assert_array_equal(bits(out[:, 4:10].contiguous(), int_dtype),
                                  bits(want, int_dtype))
    assert (out[:, :4] == 7).all() and (out[:, 10:] == 7).all()


def test_empty_ids():
    none = gather_rows(torch.ones((3, 4)), torch.zeros(0, dtype=torch.int32))
    assert none.shape == (0, 4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    t = torch.ones((5, 4))
    ids = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="requires grad"):
        gather_rows(t.clone().requires_grad_(), ids)
    with pytest.raises(TypeError):
        gather_rows(t.to(torch.float64), ids)
    with pytest.raises(TypeError):
        gather_rows(t, ids.long())
    with pytest.raises(ValueError):
        gather_rows(t, ids, torch.empty((3, 5)), col_offset=2)
    with pytest.raises(ValueError):
        gather_rows(t[:, ::2], ids)
    # no kernel and no plain fallback for a device other than cpu or cuda
    with pytest.raises(ValueError, match="no kernel"):
        gather_rows(t.to("meta"), ids.to("meta"))


def test_cpu_calls_do_not_count_launches():
    before = gather_rows.launches
    gather_rows(torch.ones((5, 4)), torch.zeros(3, dtype=torch.int32))
    assert gather_rows.launches == before


def test_dense_feature_out_of_range_ids_are_nan_like_jnp_take(toy_dir,
                                                               toy_graph):
    # the reference's jnp.take fills rows of ids >= N with NaN (and ids < 0
    # are zeroed); the port once raised in index_select on such ids
    gt = load_graph(toy_dir, device="cpu")
    N = toy_graph.meta.n_nodes
    nodes = np.asarray([[0, -1, N], [N + 5, 3, N - 1]], np.int32)
    names = ["dense2", "price"]
    want = jax_feature_ops.get_dense_feature(toy_graph.tensors,
                                             jnp.asarray(nodes), names)
    got = feature_ops.get_dense_feature(gt.tensors, torch.from_numpy(nodes),
                                        names)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(bits(g, np.int32), bits(w, np.int32))
        assert torch.isnan(g[0, 2]).all() and (g[0, 1] == 0).all()


@pytest.mark.parametrize("bf16_price", [False, True])
def test_shallow_encoder_matches_reference(toy_dir, toy_graph, bf16_price):
    # one fused output for features of one dtype; per-feature gathers and
    # the reference's type promotion for mixed dtypes
    gt = load_graph(toy_dir, device="cpu")
    gj = toy_graph.tensors
    N = toy_graph.meta.n_nodes
    if bf16_price:
        gj = gj.replace(dense_nf=dict(gj.dense_nf, price=gj.dense_nf[
            "price"].astype(jnp.bfloat16)))
        gt.tensors.dense_nf["price"] = gt.tensors.dense_nf["price"].to(
            torch.bfloat16)
    nodes = np.asarray([[0, 1, -1, N], [N + 2, 5, 7, -1]], np.int32)
    enc = jax_encoders.ShallowEncoder(dense_names=("dense2", "price"))
    nj = jnp.asarray(nodes)
    want = enc.apply(enc.init(jax.random.PRNGKey(0), gj, nj), gj, nj)
    got = ShallowEncoder(("dense2", "price"))(gt.tensors,
                                              torch.from_numpy(nodes))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(bits(got, np.int32), bits(want, np.int32))
