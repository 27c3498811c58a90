"""fan_draw of the PyTorch port against the Pallas kernel of euler_tpu.

On the CPU the wrapper runs its plain PyTorch version; it must equal
``pallas_fan.fan_draw(..., interpret=True)`` bit for bit, with the mask
and ``default_id`` of the K=1 branch of ``sample_neighbor_fast`` applied
to the Pallas output. The CUDA kernel itself is compared with the plain
version on the card by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_fan_pack
from euler_tpu.ops import pallas_fan
from euler_tpu_torch.ops import fan_draw as fd
from euler_tpu_torch.ops.alias import (FAN_ALIAS_OFF, FAN_D, FAN_KEPT_OFF,
                                       FAN_PROB_OFF)


def pallas_reference(packs, nodes, et, n_et, u1, u2, default_id):
    """The JAX K=1 path around the Pallas kernel (sampling.py:312-338)."""
    rows = np.maximum(nodes, 0) * n_et + et
    gathered = packs[rows]
    ids = np.asarray(pallas_fan.fan_draw(
        jnp.asarray(gathered), jnp.asarray(u1), jnp.asarray(u2),
        interpret=True))
    deg_c = np.broadcast_to(gathered[:, 0:1], u1.shape)
    wsum = gathered[:, 1].view(np.float32)
    valid = (nodes >= 0)[:, None] & (deg_c > 0) & (wsum > 0)[:, None]
    return np.where(valid, ids, default_id), valid


def run_port(fn, packs, nodes, et, n_et, u1, u2, default_id):
    ids, valid = fn(torch.from_numpy(packs), torch.from_numpy(nodes), et,
                    n_et, torch.from_numpy(u1), torch.from_numpy(u2),
                    default_id)
    return ids.numpy(), valid.numpy()


@pytest.mark.parametrize("B,C,n_et,et", [
    (32, 16, 1, 0), (13, 4, 1, 0), (64, 7, 3, 2),
    (20, 50, 1, 0),      # more draws than a warp has lanes
    (9, 600, 2, 1)])     # two of the Pallas kernel's tc=512 column tiles
def test_plain_matches_pallas_bit_exact(B, C, n_et, et):
    rng = np.random.default_rng(B * 100 + C)
    G = 40 * n_et
    packs = synthetic_fan_pack(rng, G)
    nodes = rng.integers(0, G // n_et, B).astype(np.int32)
    nodes[::5] = -1
    u1 = rng.random((B, C)).astype(np.float32)
    u2 = rng.random((B, C)).astype(np.float32)
    want = pallas_reference(packs, nodes, et, n_et, u1, u2, -7)
    got = run_port(fd.fan_draw, packs, nodes, et, n_et, u1, u2, -7)
    assert got[0].shape == got[1].shape == (B, C)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int32 and got[1].dtype == np.bool_


def test_ragged_block_case_of_the_pallas_tests():
    # tests/test_pallas.py::test_fan_draw_ragged_tail_block, through the port
    rng = np.random.default_rng(1)
    B, C = 13, 4
    packs = np.zeros((B, 128), np.int32)
    packs[:, 0] = 3
    packs[:, 1] = np.float32(1.0).view(np.int32)
    packs[:, FAN_PROB_OFF:FAN_PROB_OFF + FAN_D] = \
        np.float32(1.0).view(np.int32)
    packs[:, FAN_KEPT_OFF:FAN_KEPT_OFF + FAN_D] = 7
    packs[:, FAN_ALIAS_OFF:FAN_ALIAS_OFF + FAN_D] = 7
    u = rng.random((B, C)).astype(np.float32)
    ids, valid = run_port(fd.fan_draw, packs, np.arange(B, dtype=np.int32),
                          0, 1, u, u, -1)
    assert (ids == 7).all() and valid.all()


def test_slot_arithmetic_at_the_edges():
    # u1 just below 1 must stay in the last slot; deg-0 rows are invalid
    packs = np.zeros((3, 128), np.int32)
    packs[:, 0] = [FAN_D, 1, 0]
    packs[:, 1] = np.float32(2.0).view(np.int32)
    packs[:, FAN_PROB_OFF:FAN_PROB_OFF + FAN_D] = \
        np.float32(0.5).view(np.int32)
    packs[:, FAN_KEPT_OFF:FAN_KEPT_OFF + FAN_D] = np.arange(FAN_D)
    packs[:, FAN_ALIAS_OFF:FAN_ALIAS_OFF + FAN_D] = 100 + np.arange(FAN_D)
    u1 = np.array([[np.nextafter(np.float32(1), np.float32(0)), 0.0]] * 3,
                  np.float32)
    u2 = np.array([[0.25, 0.75]] * 3, np.float32)
    nodes = np.arange(3, dtype=np.int32)
    want = pallas_reference(packs, nodes, 0, 1, u1, u2, -1)
    got = run_port(fd.fan_draw, packs, nodes, 0, 1, u1, u2, -1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], [[FAN_D - 1, 100], [0, 100],
                                           [-1, -1]])


def test_wrapper_checks_its_inputs():
    packs = torch.zeros((4, 128), dtype=torch.int32)
    nodes = torch.zeros(2, dtype=torch.int32)
    u = torch.zeros((2, 3))
    with pytest.raises(TypeError, match="u1 must be"):
        fd.fan_draw(packs, nodes, 0, 1, u.double(), u)
    with pytest.raises(ValueError, match="contiguous"):
        fd.fan_draw(packs, nodes, 0, 1, torch.zeros((3, 2)).T, u)
    with pytest.raises(ValueError, match="nodes \\[B\\]"):
        fd.fan_draw(packs, nodes[:1], 0, 1, u, u)
    with pytest.raises(ValueError, match="fan_pack must be"):
        fd.fan_draw(packs[:, :64].contiguous(), nodes, 0, 1, u, u)
    with pytest.raises(ValueError, match="edge type"):
        fd.fan_draw(packs, nodes, 1, 1, u, u)


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = fd.fan_draw.launches
    packs = torch.zeros((4, 128), dtype=torch.int32)
    fd.fan_draw(packs, torch.zeros(2, dtype=torch.int32), 0, 1,
                torch.zeros((2, 3)), torch.zeros((2, 3)))
    assert fd.fan_draw.launches == before


def test_no_kernel_for_other_devices():
    packs = torch.zeros((4, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        fd.fan_draw(packs, torch.zeros(2, dtype=torch.int32, device="meta"),
                    0, 1, torch.zeros((2, 3), device="meta"),
                    torch.zeros((2, 3), device="meta"))
