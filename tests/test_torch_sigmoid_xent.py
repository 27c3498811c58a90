"""The supervised head's loss as one op each way (ops/sigmoid_xent.py and
models.gnn._SigmoidXent) against autograd of the expression it replaced,
``(_sigmoid_xent(logit, label) * valid).sum() / max(valid.sum() * C, 1)``,
on the CPU, where the wrappers run their plain versions: the loss and
the logits' gradient equal bit for bit, at a logit of exactly 0 (the
gradient -y: ``maximum`` splits its tie, ``xla_abs`` takes the slope 1),
at large logits, with padded rows and with every row padded (the
denominator's clamp), through a label view with a wider row stride and
through bf16 labels, at 1, 16, 40 and 349 classes. ``SuperviseModel``'s
loss and gradients equal those of the expression."""
import numpy as np
import pytest
import torch

from euler_tpu_torch import ops
from euler_tpu_torch.dataflow import SageDataFlow
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.models import GNNNet, ShallowEncoder, SuperviseModel
from euler_tpu_torch.models import gnn
from euler_tpu_torch.ops import sigmoid_xent as sx


def inputs(case: str):
    """(logit, label, valid) of one case, drawn with numpy."""
    rng = np.random.default_rng(sum(map(ord, case)))
    C = {"c1": 1, "c16": 16, "c40": 40}.get(case, 349)
    R = 2 if case == "one_row" else 67
    x = rng.normal(0.0, 3.0, (R, C)).astype(np.float32)
    y = (rng.random((R, C + 7)) < 0.3).astype(np.float32)
    v = (rng.random(R) < 0.8).astype(np.float32)
    if case == "zero_logits":
        x[:] = 0.0
    elif case == "large_logits":
        sign = np.where(rng.random((R, C)) < 0.5, -1.0, 1.0)
        x = (sign * rng.choice([30.0, 88.0, 1e3, 1e30], (R, C))).astype(
            np.float32)
    elif case == "soft_labels":
        y = rng.random((R, C + 7)).astype(np.float32)
    elif case == "no_valid_row":
        v[:] = 0.0
    x[0, : C // 2] = 0.0                 # a padded row's logits are exactly 0
    label = torch.from_numpy(y)
    # a view of the first C columns, row stride C + 7, unless a case needs
    # the labels back to back or in bf16
    label = label[:, :C]
    if case == "contiguous_labels":
        label = label.contiguous()
    elif case == "bf16_labels":
        label = label.to(torch.bfloat16)
    return torch.from_numpy(x), label, torch.from_numpy(v)


CASES = ["c1", "c16", "c40", "c349", "one_row", "zero_logits",
         "large_logits", "soft_labels", "no_valid_row", "contiguous_labels",
         "bf16_labels"]


def reference(logit, label, valid, upstream=1.0):
    """The replaced expression's loss and autograd's gradient to the
    logits for an upstream gradient ``upstream``."""
    x = logit.clone().requires_grad_()
    v = valid[:, None]
    loss = (gnn._sigmoid_xent(x, label) * v).sum() / \
        (v.sum() * logit.shape[1]).clamp_min(1.0)
    (grad,) = torch.autograd.grad(loss, x, torch.tensor(upstream))
    return loss.detach(), grad


@pytest.mark.parametrize("quantity", ["loss", "grad"])
@pytest.mark.parametrize("case", CASES)
def test_matches_autograd_of_the_expression(case, quantity):
    logit, label, valid = inputs(case)
    want_loss, want_grad = reference(logit, label, valid)
    x = logit.clone().requires_grad_()
    loss = gnn._SigmoidXent.apply(x, label, valid)
    loss.backward()
    # the plain versions alone, at another upstream gradient
    plain_loss, den = sx.sigmoid_xent_plain(logit, label, valid)
    up = torch.tensor(0.37)
    plain_grad = sx.sigmoid_xent_grad_plain(logit, label, valid, den, up)
    if quantity == "loss":
        assert loss.dtype == torch.float32 and loss.shape == ()
        assert torch.equal(loss.detach(), want_loss)
        assert torch.equal(plain_loss, want_loss)
        assert float(den) == max(float(valid.sum()) * logit.shape[1], 1.0)
    else:
        assert torch.equal(x.grad, want_grad)
        assert torch.equal(plain_grad, reference(logit, label, valid,
                                                 0.37)[1])


def test_gradient_at_a_zero_logit_is_minus_the_label():
    logit, label, valid = inputs("zero_logits")
    x = logit.clone().requires_grad_()
    gnn._SigmoidXent.apply(x, label, valid).backward()
    g = valid[:, None] / (valid.sum() * logit.shape[1])
    # -g y to rounding (the terms -g / 2, -g y and g / 2 are added), and
    # never the textbook sigmoid(x) - y, 0.5 - y there
    torch.testing.assert_close(x.grad, -label * g, rtol=2 ** -22, atol=0)
    assert (x.grad - (0.5 - label) * g).abs().max() > 0.4 * g.max()


def test_every_row_padded_clamps_the_denominator():
    logit, label, valid = inputs("no_valid_row")
    loss, den = sx.sigmoid_xent(logit, label, valid)
    assert float(den) == 1.0 and float(loss) == 0.0
    grad = sx.sigmoid_xent_grad(logit, label, valid, den, torch.tensor(1.0))
    assert not grad.abs().any()


def test_labels_and_weights_get_no_gradient():
    logit, label, valid = inputs("c16")
    x = logit.clone().requires_grad_()
    with pytest.raises(ValueError, match="require grad"):
        gnn._SigmoidXent.apply(x, label.clone().requires_grad_(), valid)
    with pytest.raises(ValueError, match="require grad"):
        gnn._SigmoidXent.apply(x, label, valid.clone().requires_grad_())


@pytest.mark.parametrize("bad", ["label_shape", "valid_shape", "logit_1d"])
def test_misshapen_inputs_raise(bad):
    logit, label, valid = inputs("c16")
    if bad == "label_shape":
        label = label[:, :-1]
    elif bad == "valid_shape":
        valid = valid[:-1]
    else:
        logit = logit[:, 0]
    with pytest.raises(ValueError, match="logits"):
        sx.sigmoid_xent(logit, label, valid)


def test_the_wrapper_is_counted_and_launches_nothing_on_the_cpu():
    assert sx.sigmoid_xent in ops.COUNTED
    before = sx.sigmoid_xent.launches
    logit, label, valid = inputs("c40")
    loss, den = sx.sigmoid_xent(logit, label, valid)
    sx.sigmoid_xent_grad(logit, label, valid, den, torch.tensor(1.0))
    assert sx.sigmoid_xent.launches == before


def test_supervise_model_loss_and_gradients_are_the_expressions():
    """A sampled GraphSAGE head over 2 padded roots of 24: its loss and
    every parameter's gradient equal those of the replaced expression
    over the same logits, bit for bit."""
    g = random_graph(500, 8, feat_dim=16, n_classes=5, seed=3,
                     device="cpu").tensors
    net = GNNNet("sage", SageDataFlow([3, 2], [(0,), (0,)]), (16, 8),
                 ShallowEncoder(("feature",)), in_dim=16, device="cpu",
                 generator=torch.Generator().manual_seed(1))
    model = SuperviseModel(net, "label", 5, device="cpu",
                           generator=torch.Generator().manual_seed(2))
    roots = torch.arange(24, dtype=torch.int32)
    roots[-2:] = -1
    params = list(model.parameters())
    out = model(g, roots, generator=torch.Generator().manual_seed(4))
    got = torch.autograd.grad(out["loss"], params, retain_graph=True)
    valid = out["valid"]
    assert valid.shape == (24, 1) and float(valid.sum()) == 22.0
    want_loss = (gnn._sigmoid_xent(out["logit"], out["label"]) * valid
                 ).sum() / (valid.sum() * 5).clamp_min(1.0)
    want = torch.autograd.grad(want_loss, params)
    assert torch.equal(out["loss"], want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
