"""``correct`` at a size the CPU holds, with the cells' own limits: sound
runs pass; the control (the reference in the program's place with float8
activations) fails; and a run whose timed path is broken underneath (the
harness's look for a chip skipped) comes out not correct, once for each
fault the cell can have. Also the result line's schema."""
import io
import json

import numpy as np
import pytest
import torch

from benchmark import readings
from benchmark.harness import runner


def run(spec, workload, seed=7, seconds=0.2):
    out, err = io.StringIO(), io.StringIO()
    res = runner.run(workload, seed, seconds, False, 0.0, device="cpu",
                     spec=spec, look_for_chip=False, out=out, err=err)
    return res, out.getvalue(), err.getvalue()


CELLS = ["sage-train", "gcn-train", "sage-infer"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_its_line_has_the_schema(small_spec,
                                                          workload):
    res, out, err = run(small_spec, workload)
    assert res["correct"] is True, err
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    units = {m["name"]: m["unit"] for m in small_spec.end_to_end(workload)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == units
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    limits = dict(small_spec.limits(workload), failed=0)
    assert set(line["checks"]) == set(limits)
    for name, c in line["checks"].items():
        assert c["limit"] == limits[name]
    # the compared numbers are also the last lines of standard error
    tail = err.strip().splitlines()[-len(limits):]
    assert [t.split()[1] for t in tail] == list(limits)


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(small_spec, workload):
    row, = readings.read(small_spec, workload, [11], {11}, "cpu", 0.2,
                         log=lambda line: None)
    limits = small_spec.limits(workload)
    assert all(row["program"][k] <= v for k, v in limits.items())
    assert any(row["control"][k] > v for k, v in limits.items()
               if k in row["control"])


def _state_unchanged(monkeypatch):
    from euler_tpu_torch.estimator import estimator

    def step(self, optimizer, batch, generator=None, uniforms=None):
        self.model.train()
        optimizer.zero_grad(set_to_none=True)
        out = self.model(self.graph.tensors, batch, generator=generator,
                         uniforms=uniforms)
        out["loss"].backward()
        return out["loss"].detach()             # no optimizer step
    monkeypatch.setattr(estimator.BaseEstimator, "step", step)


def _half_batch(monkeypatch):
    from euler_tpu_torch.models import gnn
    forward = gnn.SuperviseModel.forward

    def half(self, g, roots, generator=None, uniforms=None):
        out = forward(self, g, roots, generator=generator,
                      uniforms=uniforms)
        h = roots.shape[0] // 2
        out["loss"] = gnn._sigmoid_xent(out["logit"][:h],
                                        out["label"][:h]).mean()
        return out
    monkeypatch.setattr(gnn.SuperviseModel, "forward", half)


def _loss_altered(monkeypatch):
    from euler_tpu_torch.models import gnn
    forward = gnn.SuperviseModel.forward

    def altered(self, g, roots, generator=None, uniforms=None):
        out = forward(self, g, roots, generator=generator,
                      uniforms=uniforms)
        out["loss"] = out["loss"] * 1.01
        return out
    monkeypatch.setattr(gnn.SuperviseModel, "forward", altered)


def _stale_generator(monkeypatch):
    """The train generator set back to one state before every step's
    roots: each step draws the first step's roots and draws again."""
    from euler_tpu_torch.estimator import estimator
    train_batch = estimator.NodeEstimator.train_batch

    def stale(self, g, generator):
        generator.manual_seed(1)
        return train_batch(self, g, generator)
    monkeypatch.setattr(estimator.NodeEstimator, "train_batch", stale)


def _request_fails(monkeypatch):
    """One request of the window raises; the sample may not hold it."""
    from euler_tpu_torch.estimator import estimator
    infer = estimator.BaseEstimator.infer
    calls = []

    def flaky(self, ids, *args, **kw):
        calls.append(1)
        if len(calls) == 22:  # the window's second request
            raise RuntimeError("planted failure")
        return infer(self, ids, *args, **kw)
    monkeypatch.setattr(estimator.BaseEstimator, "infer", flaky)


def _embedding(fn):
    def plant(monkeypatch):
        from euler_tpu_torch.models import gnn
        forward = gnn.GNNNet.forward

        def broken(self, g, roots, generator=None, uniforms=None):
            return fn(forward(self, g, roots, generator=generator,
                              uniforms=uniforms))
        monkeypatch.setattr(gnn.GNNNet, "forward", broken)
    return plant


def _answer_altered(x):
    x = x.clone()
    x[0, 0] += 10.0
    return x


def _half_answers(x):
    x = x.clone()
    x[x.shape[0] // 2:] = 0
    return x


FAULTS = {
    "sage-train": {"state_unchanged": _state_unchanged,
                   "half_batch": _half_batch, "loss_altered": _loss_altered,
                   "stale_generator": _stale_generator},
    "gcn-train": {"state_unchanged": _state_unchanged,
                  "half_batch": _half_batch, "loss_altered": _loss_altered},
    "sage-infer": {"answer_altered": _embedding(_answer_altered),
                   "half_answers": _embedding(_half_answers),
                   "request_fails": _request_fails},
}


@pytest.mark.parametrize("workload,fault", [(w, f) for w in FAULTS
                                            for f in FAULTS[w]])
def test_broken_timed_path_is_not_correct(small_spec, monkeypatch, workload,
                                          fault):
    FAULTS[workload][fault](monkeypatch)
    res, _, err = run(small_spec, workload)
    assert res["correct"] is False, err


def test_infer_draws_are_judged_as_served(small_spec, monkeypatch):
    """A sound change of ``infer`` whose draws differ from call to call
    (one generator that advances, not one seeded afresh a call) is still
    correct: the check reads the draws each sampled request was served
    with."""
    import torch as th
    from euler_tpu_torch.estimator import estimator
    gen = th.Generator().manual_seed(123)

    def batched(self, ids, fn):
        B = self.config.batch_size
        pad = (-len(ids)) % B
        padded = np.concatenate([ids, np.full((pad,), -1, ids.dtype)])
        g = self.graph.tensors
        return [fn(g, th.from_numpy(padded[i:i + B]).to(self.device), gen)
                for i in range(0, len(padded), B)], len(ids)
    monkeypatch.setattr(estimator.BaseEstimator, "_batched_apply", batched)
    res, _, err = run(small_spec, "sage-infer")
    assert res["correct"] is True, err


@pytest.mark.cuda
def test_sage_train_on_the_card(small_spec):
    """The small sage cell through the card's path (a captured step
    replayed), with its result line."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out, err = io.StringIO(), io.StringIO()
    res = runner.run("sage-train", 7, 0.5, False, 0.0, device="cuda",
                     spec=small_spec, out=out, err=err)
    assert res["correct"] is True, err.getvalue()
