"""The mp_ops scatter family of the PyTorch port against euler_tpu's, in
f32 on the CPU.

Inputs come from a seeded numpy generator: integer-valued floats, so that
segments hold ties, and segment ids that leave some segments empty. Every
function's forward must match the reference within rtol = atol = 1e-6
(exactly where nothing is summed), and its gradient (the loss is a
weighted sum of the output) must match ``jax.grad`` within 1e-5:
``scatter_max`` splits a segment's gradient evenly among its ties,
empty segments give 0, fully masked segments give 0 for max and softmax,
and ``gather`` of ids >= N gives NaN rows as ``jnp.take`` does. Each
reference call runs under one ``jax.jit`` (one compile per case, not one
per primitive).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import mp_ops as jax_mp
from euler_tpu_torch.ops import mp_ops

TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
E, S, D = 40, 9, 3             # edges, segments (7 and 8 stay empty), width


def inputs(seed=0, width=D):
    rng = np.random.default_rng(seed)
    shape = (E,) if width is None else (E, width)
    updates = rng.integers(-3, 4, shape).astype(np.float32)
    idx = rng.integers(0, S - 2, E).astype(np.int32)
    mask = (rng.random(E) < 0.7).astype(np.float32)
    mask[idx == 0] = 0.0       # segment 0: every edge masked
    weights = rng.normal(size=(S,) + shape[1:]).astype(np.float32)
    return updates, idx, mask, weights


UNMASKED = {
    "scatter_add": lambda m, u, i: m.scatter_add(u, i, S),
    "scatter_mean": lambda m, u, i: m.scatter_mean(u, i, S),
    "scatter_max": lambda m, u, i: m.scatter_max(u, i, S),
    "scatter_softmax": lambda m, u, i: m.scatter_softmax(u, i, S),
    "scatter_add_op": lambda m, u, i: m.scatter_("add", u, i, S),
    "scatter_mean_op": lambda m, u, i: m.scatter_("mean", u, i, S),
    "scatter_max_op": lambda m, u, i: m.scatter_("max", u, i, S),
}
MASKED = {
    "masked_add": lambda m, u, i, k: m.masked_scatter_("add", u, i, S, k),
    "masked_mean": lambda m, u, i, k: m.masked_scatter_("mean", u, i, S, k),
    "masked_max": lambda m, u, i, k: m.masked_scatter_("max", u, i, S, k),
    "masked_softmax": lambda m, u, i, k: m.masked_scatter_softmax(u, i, S,
                                                                  k),
}


def run_both(fn, updates, idx, mask=None):
    """(jax output, its grad, port output, its grad): grads of
    sum(out * w) with w drawn to out's shape."""
    args_t = [torch.from_numpy(idx)] + ([] if mask is None
                                        else [torch.from_numpy(mask)])
    u = torch.from_numpy(updates).requires_grad_(True)
    out_t = fn(mp_ops, u, *args_t)
    w = np.random.default_rng(9).normal(size=out_t.shape).astype(np.float32)
    args_j = [jnp.asarray(a) for a in [idx] + ([] if mask is None
                                                else [mask])]

    def ref(u, *args):
        return (fn(jax_mp, u, *args),
                jax.grad(lambda u: jnp.sum(fn(jax_mp, u, *args) * w))(u))
    out_j, grad_j = jax.jit(ref)(jnp.asarray(updates), *args_j)
    (out_t * torch.from_numpy(w)).sum().backward()
    return (np.asarray(out_j), np.asarray(grad_j), out_t.detach().numpy(),
            u.grad.numpy())


# scatter_mean divides by an [S, 1] count, so it takes 2-D updates only,
# in both packages
@pytest.mark.parametrize("name,width", [
    (n, w) for n in sorted(UNMASKED) for w in (None, 1, D)
    if w is not None or not n.startswith("scatter_mean")])
def test_unmasked_forward_and_gradient_match(name, width):
    updates, idx, _, _ = inputs(1, width)
    out_j, grad_j, out_t, grad_t = run_both(UNMASKED[name], updates, idx)
    assert out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t, out_j, **TOL)
    np.testing.assert_allclose(grad_t, grad_j, **GRAD_TOL)


@pytest.mark.parametrize("name", sorted(MASKED))
@pytest.mark.parametrize("seed", [2, 3])
def test_masked_forward_and_gradient_match(name, seed):
    updates, idx, mask, _ = inputs(seed)
    out_j, grad_j, out_t, grad_t = run_both(MASKED[name], updates, idx, mask)
    np.testing.assert_allclose(out_t, out_j, **TOL)
    np.testing.assert_allclose(grad_t, grad_j, **GRAD_TOL)
    assert np.isfinite(out_t).all()


def test_scatter_max_values_and_tie_gradient():
    # tests/test_mp_ops.py::test_scatter_max_values_and_tie_grad
    u = torch.tensor([[3.0], [3.0], [1.0], [5.0]], requires_grad=True)
    idx = torch.tensor([0, 0, 0, 1])
    out = mp_ops.scatter_max(u, idx, 3)
    np.testing.assert_allclose(out.detach().numpy(), [[3.0], [5.0], [0.0]])
    out.sum().backward()
    np.testing.assert_allclose(u.grad.numpy(), [[0.5], [0.5], [0.0], [1.0]])


def test_empty_and_fully_masked_segments_give_zero():
    updates, idx, mask, _ = inputs(4)
    u, i, k = (torch.from_numpy(a) for a in (updates, idx, mask))
    empty = [S - 2, S - 1]
    for out in (mp_ops.scatter_max(u, i, S), mp_ops.scatter_mean(u, i, S),
                mp_ops.scatter_add(u, i, S),
                mp_ops.masked_scatter_("max", u, i, S, k),
                mp_ops.masked_scatter_("mean", u, i, S, k)):
        assert (out[empty] == 0).all()
    # segment 0 has edges, all masked
    assert (i == 0).any() and (k[i == 0] == 0).all()
    assert (mp_ops.masked_scatter_("max", u, i, S, k)[0] == 0).all()
    p = mp_ops.masked_scatter_softmax(u, i, S, k)
    assert (p[i == 0] == 0).all() and torch.isfinite(p).all()
    assert (p[k == 0] == 0).all()
    # the unmasked max of a segment of negative values is not reset
    neg = torch.tensor([[-2.0], [-5.0]])
    assert float(mp_ops.scatter_max(neg, torch.tensor([0, 0]), 1)) == -2.0


def test_masked_max_keeps_low_precision():
    updates, idx, mask, _ = inputs(5)
    u = torch.from_numpy(updates).to(torch.bfloat16)
    out = mp_ops.masked_scatter_("max", u, torch.from_numpy(idx), S,
                                 torch.from_numpy(mask))
    want = jax.jit(lambda u, i, k: jax_mp.masked_scatter_("max", u, i, S, k))(
        jnp.asarray(updates, jnp.bfloat16), jnp.asarray(idx),
        jnp.asarray(mask))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_clamps_negative_ids_and_fills_ids_past_the_end(dtype):
    params = np.arange(12).reshape(4, 3).astype(dtype)
    ids = np.array([2, -1, 0, 4, 7, 3, -5], np.int32)
    want = np.asarray(jax.jit(jax_mp.gather)(jnp.asarray(params),
                                             jnp.asarray(ids)))
    got = mp_ops.gather(torch.from_numpy(params), torch.from_numpy(ids))
    assert got.dtype == torch.from_numpy(params).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == np.float32:
        assert np.isnan(got.numpy()[[3, 4]]).all()
        assert not np.isnan(got.numpy()[[0, 1, 2, 5, 6]]).any()


def test_gather_gradient_is_scatter_add():
    params = np.random.default_rng(6).normal(size=(5, 2)).astype(np.float32)
    ids = np.array([2, 0, 2, -1, 5], np.int32)
    w = np.random.default_rng(7).normal(size=(5, 2)).astype(np.float32)
    want = jax.jit(jax.grad(lambda p: jnp.sum(jnp.nan_to_num(
        jax_mp.gather(p, jnp.asarray(ids))) * w)))(jnp.asarray(params))
    p = torch.from_numpy(params).requires_grad_(True)
    (torch.nan_to_num(mp_ops.gather(p, torch.from_numpy(ids)))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), **TOL)


def test_int64_and_int32_indices_agree():
    updates, idx, mask, _ = inputs(8)
    u = torch.from_numpy(updates)
    for fn in list(UNMASKED.values()):
        a = fn(mp_ops, u, torch.from_numpy(idx))
        b = fn(mp_ops, u, torch.from_numpy(idx).long())
        assert torch.equal(a, b)
