"""Training, evaluation and inference loops over a model and a graph.

Counterpart of euler_tpu/estimator/estimator.py (reference:
euler_estimator/python/base_estimator.py:28-188, node_estimator.py:26):
``RunConfig``, ``get_optimizer``, ``BaseEstimator.train``/``evaluate``/
``infer`` with ``steps_per_loop``, checkpoints and the profiler hook,
``NodeEstimator``, ``EdgeEstimator`` (edge_estimator.py:27),
``GaeEstimator``, ``SampleEstimator``, ``GraphEstimator`` and
``make_graph_batch`` (estimator.py:390-514). The
reference's jitted step with optax becomes an eager step with autograd and
a torch.optim optimizer; its ``lax.scan`` of ``steps_per_loop`` steps
becomes ``TrainLoop``: on the card, one train step captured as a CUDA
graph and replayed. sgd, momentum and adam (``capturable=True`` on the
card) capture; Adagrad reads its step count on the host and cannot, so
``steps_per_loop > 1`` with it raises on the card. On the CPU, which has
no graphs, a loop is its steps run one by one. Likewise ``infer`` on the
card captures the forward of one padded batch and replays it for each
batch (``InferGraph``); on the CPU it runs each batch eagerly.

Intended differences from the reference: ``RunConfig.model_dir`` defaults
to None, which writes and restores no checkpoint (the reference's
``/tmp/euler_tpu_model`` would let runs restore one another's); a
checkpoint that does not fit the model raises where the reference starts
afresh in silence; and ``RunConfig.profile`` traces from the first loop
boundary at or past step 10, where the reference's hook waits for step 10
exactly and so never starts when the loop's steps skip it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.nn.modules import module as _nn_module

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph.store import Graph
from euler_tpu_torch.models.kg import rank_all_entities
from euler_tpu_torch.ops import COUNTED, feature_ops, sampling
from euler_tpu_torch.utils import metrics as metrics_lib
from euler_tpu_torch.utils.hooks import LoggingHook, ProfilerHook
from euler_tpu_torch.utils.trace import span


#: a model input: node ids, [B, 3] triples, or a dict of tensors
Batch = Union[torch.Tensor, Dict[str, torch.Tensor]]


def get_optimizer(name: str, lr: float, params) -> torch.optim.Optimizer:
    """reference: tf_euler/python/utils/optimizers.py:23-31, as optax
    builds them. Adagrad takes optax's accumulator start (0.1) and eps
    (1e-7), where torch's defaults are 0 and 1e-10. Adam on CUDA
    parameters is ``capturable`` (its step count stays on the card), so
    that ``TrainLoop`` can capture it; SGD captures as it is."""
    params = list(params)
    on_card = any(p.is_cuda for p in params)
    return {
        "sgd": lambda: torch.optim.SGD(params, lr),
        "momentum": lambda: torch.optim.SGD(params, lr, momentum=0.9),
        "adagrad": lambda: torch.optim.Adagrad(
            params, lr, initial_accumulator_value=0.1, eps=1e-7),
        "adam": lambda: torch.optim.Adam(params, lr, capturable=on_card),
    }[name]()


@functools.lru_cache(maxsize=None)
def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of ``device`` on which every ``TrainLoop`` and
    ``InferGraph`` warms up and captures. cuBLAS keeps a workspace (about
    32 MiB) for each stream it has run on, for the life of the process, so
    a new stream per capture would leave one behind at every ``train``."""
    return torch.cuda.Stream(device)


def _capturable(optimizer: torch.optim.Optimizer) -> bool:
    """Whether a CUDA graph can capture ``optimizer.step()``: SGD's, and
    that of an optimizer built with ``capturable=True``."""
    return (type(optimizer) is torch.optim.SGD
            or bool(optimizer.defaults.get("capturable")))


@dataclasses.dataclass
class RunConfig:
    batch_size: int = 512
    total_steps: int = 1000
    optimizer: str = "adam"
    learning_rate: float = 0.01
    log_steps: int = 100
    seed: int = 0
    metric: str = "f1"
    reservoir_refresh: int = 100  # redraw the fan_pack reservoir rows
    # every N steps (0 = never): groups with degree > FAN_D hold
    # pre-drawn neighbors, exact per draw but repeated until redrawn
    # (ops/sampling.refresh_fan_pack); checked at each loop's start
    model_dir: Optional[str] = None  # checkpoints under model_dir/ckpt;
    # None: none written, none restored
    save_steps: int = 0          # 0 => only at the end
    keep_checkpoints: int = 5    # retain the newest N (0 = all)
    profile: bool = False        # torch.profiler trace of steps 10-20
    profile_dir: str = "prof_dir"
    steps_per_loop: int = 1      # > 1: that many steps as one TrainLoop,
    # on the card one captured step replayed; log/save/profile
    # granularity rounds to loop boundaries


class TrainLoop:
    """``steps`` optimizer steps as one call: the counterpart of the
    reference's ``lax.scan`` over its step (estimator.py:446-459).

    Each step is ``estimator.step(optimizer, batch(), generator)``;
    ``batch()`` returns a tensor or a dict of tensors (a graph batch),
    made inside the step, so that a capture holds each by its address. On a
    CUDA device with ``steps > 1`` the first call runs one such step
    eagerly on the device's ``capture_stream`` (the warm-up: it builds
    the optimizer's state, the kernels' libraries, the cached constants
    and the stream's cuBLAS workspace), captures on that stream the
    next one whole (``batch()``, forward, backward, ``optimizer.step()``)
    in a ``torch.cuda.CUDAGraph`` with ``generator`` registered, so that
    each replay draws anew, and replays it for the loop's other steps;
    later calls replay it ``steps`` times. Elsewhere a call runs its steps
    eagerly. Either way the losses and parameters are those of the eager
    steps from the same generator state, up to the order of atomic sums.

    A replay reads the addresses it captured: the parameters, the
    optimizer's state and the graph's tensors are updated in place, never
    rebound. A call returns a copy of its last step's loss, made before
    the next replay overwrites it. The ``launches`` of the kernel wrappers
    in ``ops.COUNTED`` count what ran: a capture records launches and
    runs none, and each replay adds the launches its graph holds
    (``held``). A capture that fails raises; there is no eager fallback.
    """

    def __init__(self, estimator: "BaseEstimator",
                 optimizer: torch.optim.Optimizer,
                 generator: torch.Generator, steps: int,
                 batch: Callable[[], Batch]):
        self.estimator, self.optimizer = estimator, optimizer
        self.generator, self.steps, self.batch = generator, steps, batch
        self.graphed = steps > 1 and estimator.device.type == "cuda"
        if self.graphed and not _capturable(optimizer):
            raise ValueError(
                f"{type(optimizer).__name__} reads its step count on the "
                f"host, so a CUDA graph cannot capture its step: "
                f"steps_per_loop > 1 on the card needs sgd, momentum or "
                f"adam")
        self.graph = self.loss = None
        self.held: Dict[str, int] = {}

    def _step(self) -> torch.Tensor:
        return self.estimator.step(self.optimizer, self.batch(),
                                   generator=self.generator)

    def _capture(self) -> None:
        dev = self.estimator.device
        side = capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = {k: k.launches for k in COUNTED}
        with torch.cuda.graph(graph, stream=side):
            self.loss = self._step()
        self.held = {k.__name__: k.launches - n for k, n in before.items()}
        for k, n in before.items():
            k.launches = n
        self.graph = graph

    def __call__(self) -> torch.Tensor:
        with span("loop"):
            if not self.graphed:
                for _ in range(self.steps):
                    loss = self._step()
                return loss
            replays = self.steps
            if self.graph is None:
                with span("loop.capture"):
                    self._capture()    # its warm-up is this loop's first
                replays -= 1
            for _ in range(replays):
                with span("loop.replay"):
                    self.graph.replay()
            for k in COUNTED:
                k.launches += self.held[k.__name__] * replays
            return self.loss.clone()


def _fingerprint(model: torch.nn.Module, g, shape: tuple) -> tuple:
    """What a captured forward reads beyond its ids' values: the model and
    each of its modules, the graph's tensors, the padded batch's shape,
    the address of every parameter and buffer, and every forward hook and
    pre-hook in its order. Objects enter by ``id``; ``InferGraph`` holds
    them while it keeps the fingerprint, so no id is reused meanwhile."""
    parts = [id(g), shape]
    stack = [model]         # a walk of its own: modules() takes twice as long
    while stack:
        m = stack.pop()
        parts.append(id(m))
        for t in m._parameters.values():
            if t is not None:
                parts.append(t.data_ptr())
        for t in m._buffers.values():
            if t is not None:
                parts.append(t.data_ptr())
        if m._forward_pre_hooks or m._forward_hooks:
            parts.append((tuple(m._forward_pre_hooks.items()),
                          tuple(m._forward_hooks.items())))
        stack.extend(m._modules.values())
    return tuple(parts)


def _global_hooks() -> bool:
    """Whether a forward hook or pre-hook is registered for every module
    (``torch.nn.modules.module.register_module_forward_hook``)."""
    return any(getattr(_nn_module, name, None) for name in (
        "_global_forward_pre_hooks", "_global_forward_hooks"))


@contextlib.contextmanager
def _hooks_replaced(model: torch.nn.Module, wrap: Callable):
    """Every forward hook and pre-hook of ``model``'s modules replaced by
    ``wrap(hook)`` (torch calls it as it would the hook), and restored on
    exit."""
    saved = []
    for m in model.modules():
        for hooks in (m._forward_pre_hooks, m._forward_hooks):
            if hooks:
                saved.append((hooks, dict(hooks)))
                for k, h in list(hooks.items()):
                    hooks[k] = wrap(h)
    try:
        yield
    finally:
        for hooks, old in saved:
            for k, h in old.items():
                if k in hooks:
                    hooks[k] = h


class InferGraph:
    """``BaseEstimator.infer``'s forward on the card, one padded batch of
    ids captured in a ``torch.cuda.CUDAGraph`` and replayed for every
    later batch, so that a batch launches one graph instead of each of
    its kernels from the host.

    ``start(seed, shape)`` begins a request: it seeds the estimator's one
    infer generator (the graph registers it, so that each replay draws
    anew; reseeded each request, it gives the draws of a fresh generator
    with that seed bit for bit) and checks the fingerprint (``_fingerprint``)
    that the graph was captured under. Where it differs (a model, module,
    parameter, buffer, ``graph.tensors`` or hook rebound, added or
    removed; another batch size), the graph is dropped, and the next batch
    runs eagerly on ``capture_stream`` as the warm-up (the kernels'
    libraries, cuBLAS's workspace, the cached constants); the batch after
    is captured there, then replayed. In-place updates (training,
    checkpoint restores, ``refresh_fan_pack``) keep the graph valid.

    Hooks: the eager warm-up calls the hooks as an eager forward does,
    and a hook that returns a value (a replaced input or output, which a
    replay cannot honour) or a global module hook keeps the path eager
    until the fingerprint changes. At capture each hook is recorded, not
    called, with the module and the (static) args and outputs it is given;
    after each replay the hooks are called in that order with them, which
    then hold this batch's values. Holding them keeps the capture from
    reusing their memory. A hook that returns a value after a replay
    raises, and the path stays eager.

    A forward that cannot be captured (it waits for the card, or copies
    to the host) fails its capture; that batch then runs eagerly from the
    generator state before the capture, on a fresh generator, and the
    estimator stays eager. The launches a capture records are taken back
    from the wrappers in ``ops.COUNTED``, and each replay adds the
    graph's ``held``. The estimator counts ``infer_replays`` and
    ``infer_captures``. The caller holds ``lock`` from ``start`` until it
    has copied the last batch's output, which the next replay overwrites.
    """

    def __init__(self, estimator: "BaseEstimator"):
        self.estimator = estimator
        self.lock = threading.Lock()
        self.generator = torch.Generator(device=estimator.device)
        self.capturable = True
        self.graph = self.key = self.owners = None
        self.ids = self.out = None
        self.calls: List[Tuple[Callable, tuple]] = []
        self.held: Dict[str, int] = {}
        self.warm = False          # the eager warm-up ran under ``key``
        self.hooks_ok = True       # no hook returned a value under ``key``

    def start(self, seed: int, shape: tuple) -> None:
        est = self.estimator
        g = est.graph.tensors
        key = _fingerprint(est.model, g, shape)
        if key != self.key:
            self.graph = self.ids = self.out = None
            self.calls, self.held = [], {}
            self.key, self.warm, self.hooks_ok = key, False, True
            self.owners = (est.model, g, list(est.model.modules()))
        self.generator.manual_seed(seed)

    def __call__(self, g, ids: np.ndarray, fn: Callable,
                 last: bool) -> torch.Tensor:
        """The output of ``fn(g, batch, generator)`` for one padded batch
        of ``ids``: after a replay, its static output where ``last`` (the
        caller copies it out before the next replay), else a clone."""
        if not (self.capturable and self.hooks_ok) or _global_hooks():
            return _eager_batch(self.estimator.device, g, ids, fn,
                                self.generator)
        if self.graph is not None:
            with span("infer.h2d"):
                self.ids.copy_(torch.from_numpy(ids))
            with span("forward"):
                self._replay()
        elif not self.warm:
            return self._warm_up(g, ids, fn)
        else:
            with span("infer.h2d"):
                self.ids = torch.from_numpy(ids).to(self.estimator.device)
            with span("forward"):
                if not self._capture(g, fn):
                    return _eager_batch(self.estimator.device, g, ids, fn,
                                        self.generator)
                self._replay()
        return self.out if last else self.out.clone()

    def _warm_up(self, g, ids: np.ndarray, fn: Callable) -> torch.Tensor:
        dev = self.estimator.device
        returned = []

        def watch(hook):
            def call(*a):
                r = hook(*a)
                if r is not None:
                    returned.append(hook)
                return r
            return call
        side = capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), _hooks_replaced(self.estimator.model,
                                                      watch):
            out = _eager_batch(dev, g, ids, fn, self.generator)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.warm, self.hooks_ok = True, not returned
        return out

    def _capture(self, g, fn: Callable) -> bool:
        """Capture ``fn`` over the static ids; False (and eager from now
        on) where the forward cannot be captured."""
        dev = self.estimator.device
        side = capture_stream(dev)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        state = self.generator.get_state()
        calls: List[Tuple[Callable, tuple]] = []

        def record(hook):
            def call(*a):
                calls.append((hook, a))
            return call
        before = {k: k.launches for k in COUNTED}
        ok = False
        try:
            # the outer stream context restores the caller's stream also
            # where the capture's own exit raises
            with torch.cuda.stream(side), \
                    _hooks_replaced(self.estimator.model, record), \
                    torch.cuda.graph(graph, stream=side):
                out = fn(g, self.ids, self.generator)
            ok = True
        except RuntimeError:
            self.capturable = False
        finally:
            self.held = {k.__name__: k.launches - n
                         for k, n in before.items()}
            for k, n in before.items():
                k.launches = n
            if not ok:
                self.generator = torch.Generator(device=dev)
                self.generator.set_state(state)
        if not ok:
            return False
        self.graph, self.out, self.calls = graph, out, calls
        self.estimator.infer_captures += 1
        return True

    def _replay(self) -> None:
        self.graph.replay()
        for k in COUNTED:
            k.launches += self.held[k.__name__]
        self.estimator.infer_replays += 1
        for hook, a in self.calls:
            if hook(*a) is not None:
                self.graph, self.hooks_ok = None, False
                raise RuntimeError(
                    f"the forward hook {hook!r} returned a value after a "
                    f"replay of infer's captured forward, which cannot "
                    f"honour it; infer stays eager while it is registered")


def _eager_batch(device, g, ids: np.ndarray, fn: Callable,
                 gen: torch.Generator) -> torch.Tensor:
    """One padded batch of ``ids`` to ``device`` and through ``fn``."""
    with span("infer.h2d"):
        batch = torch.from_numpy(ids).to(device)
    with span("forward"):
        return fn(g, batch, gen)


class BaseEstimator:
    """Generic run loops; subclasses provide the batch source.

    The model is an ``nn.Module`` whose ``forward(g, batch, generator=,
    uniforms=)`` returns a dict with at least ``loss``. ``requests``
    counts the calls of ``infer``; each call's spans carry its count as
    their request id (``utils.trace``). ``infer_batches`` counts the
    padded batches ``infer`` served, ``infer_replays`` those of them a
    replay of ``InferGraph``'s captured forward served (on the card), and
    ``infer_captures`` its captures.
    """

    def __init__(self, model: torch.nn.Module, graph: Graph,
                 config: RunConfig, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.graph = graph
        self.config = config
        self.requests = 0
        self.infer_batches = self.infer_replays = self.infer_captures = 0
        self._restore_checked = False
        for what, dev in (("graph", graph.tensors.device),
                          ("model", next(model.parameters()).device)):
            if dev.type != self.device.type:
                raise ValueError(f"the {what} is on {dev}, the estimator "
                                 f"on {self.device}")
        self._infer_graph = (InferGraph(self) if self.device.type == "cuda"
                             else None)

    # ---- batch source (subclass hook) -------------------------------------
    def train_batch(self, g, generator: torch.Generator) -> Batch:
        """Return the per-step model input."""
        raise NotImplementedError

    # ---- training ----------------------------------------------------------
    def step(self, optimizer: torch.optim.Optimizer, batch: Batch,
             generator: Optional[torch.Generator] = None,
             uniforms: Optional[Sequence] = None) -> torch.Tensor:
        """One optimizer step on ``batch`` (a tensor, or a dict of tensors
        for the models that take one); returns the loss as a 0-d tensor
        on the device (reading it waits for the card)."""
        with span("step"):
            self.model.train()
            optimizer.zero_grad(set_to_none=True)
            with span("forward"):
                out = self.model(self.graph.tensors, batch,
                                 generator=generator, uniforms=uniforms)
            with span("backward"):
                out["loss"].backward()
            with span("optimizer"):
                optimizer.step()
            return out["loss"].detach()

    def train(self, total_steps: Optional[int] = None,
              log_fn: Callable = print) -> Dict[str, float]:
        """``total_steps`` optimizer steps from a fresh optimizer state, as
        the reference's loop (estimator.py:410-504): loops of
        ``steps_per_loop`` steps (``TrainLoop``) while a whole loop fits,
        single steps after; the reservoir redraw checked at each loop's
        start; a log line where ``i % log_steps < steps_per_loop`` and a
        checkpoint where ``i % save_steps < steps_per_loop`` (i >=
        save_steps), i the steps done, and one at the end. The reservoir
        redraws stay in ``graph.tensors`` afterwards."""
        cfg = self.config
        total = total_steps or cfg.total_steps
        self._restore()
        g = self.graph.tensors
        opt = get_optimizer(cfg.optimizer, cfg.learning_rate,
                            self.model.parameters())
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed + 1)
        spl = max(1, int(cfg.steps_per_loop))
        loop = TrainLoop(self, opt, gen, spl,
                         lambda: self.train_batch(g, gen))
        profiler = (ProfilerHook(cfg.profile_dir, start=10, steps=10)
                    if cfg.profile else None)
        logger = LoggingHook(cfg.log_steps, log_fn, steps_per_call=spl,
                             total=total)
        loss = last_loss = None
        i = 0
        next_refresh = cfg.reservoir_refresh or float("inf")
        try:
            while i < total:
                if i >= next_refresh:
                    sampling.refresh_fan_pack(g, gen)
                    next_refresh += cfg.reservoir_refresh
                if spl > 1 and i + spl <= total:
                    loss = loop()
                    i += spl
                else:
                    loss = self.step(opt, self.train_batch(g, gen),
                                     generator=gen)
                    i += 1
                if profiler is not None:
                    profiler(i)
                logged = logger(i, loss, cfg.batch_size)
                if logged is not None:
                    last_loss = logged
                if cfg.save_steps and i % cfg.save_steps < spl \
                        and i >= cfg.save_steps:
                    self._save(i)
        finally:
            if profiler is not None:
                profiler.close()
        self._save(total)
        if last_loss is None or last_loss != last_loss:
            last_loss = float(loss)
        return {"loss": last_loss, "steps": total}

    # ---- checkpoints -------------------------------------------------------
    def _ckpt_dir(self) -> str:
        return os.path.join(os.path.abspath(self.config.model_dir), "ckpt")

    def _save(self, step: int) -> None:
        """``model.state_dict()`` to ``model_dir/ckpt/<step>`` and the step
        to ``model_dir/ckpt/latest``; then only the newest
        ``keep_checkpoints`` steps stay, this one always among them
        (reference: estimator.py:375-393). No ``model_dir``: nothing."""
        if self.config.model_dir is None:
            return
        d = self._ckpt_dir()
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f"{step}.tmp")
        torch.save(self.model.state_dict(), tmp)
        os.replace(tmp, os.path.join(d, str(step)))
        with open(os.path.join(d, "latest"), "w") as f:
            f.write(str(step))
        keep = self.config.keep_checkpoints
        if keep > 0:
            older = sorted((int(n) for n in os.listdir(d)
                            if n.isdigit() and int(n) != step), reverse=True)
            for old in older[keep - 1:]:
                os.remove(os.path.join(d, str(old)))

    def _restore(self) -> None:
        """Load the checkpoint that ``model_dir/ckpt/latest`` names into the
        model, in place, at the first train, evaluate or infer of this
        estimator (reference: the ``params`` property, estimator.py:
        351-356). A checkpoint that does not fit the model raises."""
        if self._restore_checked:
            return
        self._restore_checked = True
        if self.config.model_dir is None:
            return
        latest = os.path.join(self._ckpt_dir(), "latest")
        if not os.path.exists(latest):
            return
        with open(latest) as f:
            step = f.read().strip()
        state = torch.load(os.path.join(self._ckpt_dir(), step),
                           map_location=self.device, weights_only=True)
        self.model.load_state_dict(state)

    # ---- evaluation and inference -----------------------------------------
    def _batched_apply(self, ids: np.ndarray, fn: Callable,
                       graphed: Optional[InferGraph] = None
                       ) -> Tuple[List, int]:
        """Pad ids with -1 to batch multiples, run fn per batch with one
        generator seeded from ``seed + 2`` (a fresh one, or ``graphed``'s,
        which then runs the batches); the caller strips the padding with
        the returned count."""
        B = self.config.batch_size
        n = len(ids)
        with span("infer.pad"):
            pad = (-n) % B
            padded = np.concatenate(
                [ids, np.full((pad,) + ids.shape[1:], -1, ids.dtype)])
            if graphed is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self.config.seed + 2)
            else:
                graphed.start(self.config.seed + 2, (B,) + ids.shape[1:])
        g = self.graph.tensors
        outs = []
        for i in range(0, len(padded), B):
            if graphed is None:
                outs.append(_eager_batch(self.device, g, padded[i:i + B], fn,
                                         gen))
            else:
                outs.append(graphed(g, padded[i:i + B], fn,
                                    last=i + B >= len(padded)))
        return outs, n

    def _check_ids(self, ids: np.ndarray) -> None:
        """Raise if ``ids`` is not what the model takes."""

    def evaluate(self, ids: Sequence[int]) -> Dict[str, float]:
        """The config's metric and the mean batch loss over ``ids``
        (reference: estimator.py:273-314): f1 or accuracy of the logits
        against the labels for a supervised model, and for a model without
        ``logit`` (the unsupervised and KG heads) the metric of the
        positives' ``logits`` against their ``neg_logits``."""
        name = self.config.metric
        metric = metrics_lib.get(name)
        ids = np.asarray(ids, np.int32)
        self._check_ids(ids)
        self._restore()

        def run(g, batch, gen):
            return self.model(g, batch, generator=gen)

        self.model.eval()
        with torch.no_grad():
            outs, n = self._batched_apply(ids, run)
            if "logit" in outs[0]:
                logits = torch.cat([o["logit"] for o in outs])[:n]
                labels = torch.cat([o["label"] for o in outs])[:n]
                if name == "f1":
                    val = metric(labels, torch.sigmoid(logits))
                else:
                    val = metric(labels, logits)
            else:
                pos = torch.cat([o["logits"] for o in outs])[:n]
                neg = torch.cat([o["neg_logits"] for o in outs])[:n]
                val = metric(pos, neg)
            loss = float(np.mean([float(o["loss"]) for o in outs]))
        return {name: float(val), "loss": loss}

    def infer(self, ids: Sequence[int], out_dir: Optional[str] = None,
              worker: int = 0) -> np.ndarray:
        """Embeddings for ids (for an ``EdgeEstimator``, [T, 3] triples,
        whose node columns are checked); optionally written as
        embedding_{worker}.npy + ids_{worker}.npy."""
        self.requests += 1
        with span("infer", request=self.requests):
            ids = np.asarray(ids, np.int32)
            self._check_ids(ids)
            nodes = ids[:, :2] if ids.ndim == 2 else ids
            n_nodes = self.graph.meta.n_nodes
            if nodes.size and (nodes.min() < -1 or nodes.max() >= n_nodes):
                raise ValueError(
                    f"ids must lie in [0, {n_nodes}) (or be -1)")
            self._restore()

            def embed(g, batch, gen):
                return self.model(g, batch, generator=gen)["embedding"]

            self.model.eval()
            graphed = self._infer_graph
            with torch.no_grad(), (contextlib.nullcontext() if graphed is None
                                   else graphed.lock):
                outs, n = self._batched_apply(ids, embed, graphed)
                self.infer_batches += len(outs)
                with span("infer.d2h"):
                    emb = torch.cat(outs)[:n].cpu().numpy()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            np.save(os.path.join(out_dir, f"embedding_{worker}.npy"), emb)
            np.save(os.path.join(out_dir, f"ids_{worker}.npy"), ids)
        return emb

    def train_and_evaluate(self, eval_ids) -> Dict[str, float]:
        """``train()``, then ``evaluate(eval_ids)``: the two results in one
        dict, evaluate's loss over train's (reference:
        estimator.py:344-347)."""
        res = self.train()
        res.update(self.evaluate(eval_ids))
        return res


class NodeEstimator(BaseEstimator):
    """Train source = sample_node(batch, node_type)
    (reference: node_estimator.py:31-51)."""

    def __init__(self, model: torch.nn.Module, graph: Graph,
                 config: RunConfig, train_node_type=-1, device=None):
        super().__init__(model, graph, config, device=device)
        self.train_node_type = train_node_type

    def train_batch(self, g, generator: torch.Generator) -> torch.Tensor:
        return sampling.sample_node(g, self.config.batch_size,
                                    self.train_node_type, generator)


class EdgeEstimator(BaseEstimator):
    """Train source = sample_edge(batch, edge_type); the model receives
    (src, dst, etype) stacked int32 [B, 3] (reference:
    edge_estimator.py:32-72)."""

    def __init__(self, model: torch.nn.Module, graph: Graph,
                 config: RunConfig, train_edge_type=-1, device=None):
        super().__init__(model, graph, config, device=device)
        self.train_edge_type = train_edge_type

    def train_batch(self, g, generator: torch.Generator) -> torch.Tensor:
        src, dst, ty, _ = sampling.sample_edge(
            g, self.config.batch_size, self.train_edge_type, generator)
        return torch.stack([src, dst, ty], dim=1)

    def _check_ids(self, ids: np.ndarray) -> None:
        if ids.ndim == 1:
            raise ValueError(
                "EdgeEstimator needs [T,3] (src,dst,etype) test triples, "
                "not node ids (the reference evaluates from triple id "
                "files); use sample_edge to build a triple set or "
                "evaluate_ranking for full-entity MR/Hit@k")

    def evaluate_ranking(self, triples, corrupt: str = "both",
                         filter_known=None, hit_ks=(1, 3, 10)
                         ) -> Dict[str, float]:
        """Full-entity ranking (MeanRank, MRR, Hit@k) of [T, 3] test
        triples in batches of ``config.batch_size``, which bounds the
        [batch, n_entities, dim] scores; needs a TransX-family model."""
        return rank_all_entities(self.model, self.graph.tensors, triples,
                                 batch_size=self.config.batch_size,
                                 corrupt=corrupt, filter_known=filter_known,
                                 hit_ks=hit_ks)


class GaeEstimator(NodeEstimator):
    """Autoencoder runs: node-sampled training, with evaluation and
    inference inputs from id files (reference: estimator.py:390-406,
    gae_estimator.py). For ``GAE``, ``VGAE`` and ``DGI``."""

    @staticmethod
    def ids_from_file(path: str) -> np.ndarray:
        """One integer id per line -> an int64 array."""
        return np.loadtxt(path, dtype=np.int64).reshape(-1)

    def evaluate_id_file(self, path: str) -> Dict[str, float]:
        return self.evaluate(self.ids_from_file(path))

    def infer_id_file(self, path: str, out_dir: Optional[str] = None):
        return self.infer(self.ids_from_file(path), out_dir)


class SampleEstimator(BaseEstimator):
    """Training from precomputed samples (reference: estimator.py:409-441,
    sample_estimator.py). ``samples`` is an [M, K] int array or a text
    file of K comma-separated ints a line; the table is moved to the
    device once. Each step draws ``batch_size`` rows uniformly with
    replacement (``draw_rows``, the registered generator's ``randint``)
    and selects them (``select_rows``); a one-column table feeds the model
    a flat id batch."""

    def __init__(self, model: torch.nn.Module, graph: Graph,
                 config: RunConfig, samples, device=None):
        super().__init__(model, graph, config, device=device)
        if isinstance(samples, str):
            samples = np.loadtxt(samples, delimiter=",", dtype=np.int64,
                                 ndmin=2)
        samples = np.asarray(samples)
        if samples.ndim == 1:
            samples = samples[:, None]
        if not len(samples):
            raise ValueError("empty sample set")
        self.samples = torch.from_numpy(samples.astype(np.int32)).to(
            self.device)

    def draw_rows(self, generator: Optional[torch.Generator]
                  ) -> torch.Tensor:
        """``batch_size`` row indices of the table, int64, uniform."""
        return torch.randint(0, self.samples.shape[0],
                             (self.config.batch_size,), generator=generator,
                             device=self.device)

    def select_rows(self, idx: torch.Tensor) -> torch.Tensor:
        rows = self.samples[idx]
        return rows[:, 0] if rows.shape[1] == 1 else rows

    def train_batch(self, g, generator: torch.Generator) -> torch.Tensor:
        return self.select_rows(self.draw_rows(generator))


def make_graph_batch(g, graph_idx: torch.Tensor, label_name: str,
                     num_classes: int) -> Dict[str, torch.Tensor]:
    """A graph-classification batch from graph indices (reference:
    estimator.py:444-460, graph_estimator.py:45-56): ``node_ids`` (the
    graphs' members, flat, -1 padded), ``mask`` (real members of graphs
    >= 0), ``node_graph_idx`` (each slot's batch row) and ``label``, the
    one-hot of the first member's ``label_name`` feature (truncated to
    an int; 0 rows for graph indices < 0 and classes out of range). No
    size is read on the host."""
    members, mask, node_graph_idx = sampling.get_graph_by_label(g, graph_idx)
    (lab,) = feature_ops.get_dense_feature(g, members[:, 0], [label_name])
    classes = torch.arange(num_classes, device=lab.device)
    label = (lab[:, :1].to(torch.int32) == classes).to(torch.float32)
    ok = graph_idx >= 0
    label = torch.where(ok[:, None], label, 0.0)
    return dict(node_ids=members.reshape(-1),
                mask=mask.reshape(-1) & ok.repeat_interleave(
                    members.shape[1]),
                node_graph_idx=node_graph_idx, label=label)


class GraphEstimator(BaseEstimator):
    """Graph classification (reference: estimator.py:463-514,
    graph_estimator.py:32-77): each step draws ``batch_size`` graph
    indices (``sampling.sample_graph_label``) and feeds ``GraphModel`` the
    dict ``make_graph_batch`` builds; evaluate gives the accuracy and the
    mean batch loss over graph indices, infer their pooled embeddings."""

    def __init__(self, model: torch.nn.Module, graph: Graph,
                 config: RunConfig, label_name: str = "label",
                 num_classes: int = 2, device=None):
        super().__init__(model, graph, config, device=device)
        self.label_name, self.num_classes = label_name, num_classes

    def make_batch(self, g, graph_idx: torch.Tensor) -> Dict[str,
                                                             torch.Tensor]:
        return make_graph_batch(g, graph_idx, self.label_name,
                                self.num_classes)

    def train_batch(self, g, generator: torch.Generator) -> Dict[
            str, torch.Tensor]:
        return self.make_batch(g, sampling.sample_graph_label(
            g, self.config.batch_size, generator))

    def _run(self, graph_ids, fn) -> Tuple[List, int]:
        self._restore()
        self.model.eval()
        with torch.no_grad():
            return self._batched_apply(
                np.asarray(graph_ids, np.int32),
                lambda g, gidx, gen: fn(self.model(
                    g, self.make_batch(g, gidx), generator=gen)))

    def evaluate(self, graph_ids: Sequence[int]) -> Dict[str, float]:
        outs, n = self._run(graph_ids, lambda o: o)
        logits = torch.cat([o["logit"] for o in outs])[:n]
        labels = torch.cat([o["label"] for o in outs])[:n]
        return {"accuracy": float(metrics_lib.accuracy(labels, logits)),
                "loss": float(np.mean([float(o["loss"]) for o in outs]))}

    def infer(self, graph_ids: Sequence[int], out_dir: Optional[str] = None,
              worker: int = 0) -> np.ndarray:
        self.requests += 1
        with span("infer", request=self.requests):
            outs, n = self._run(graph_ids, lambda o: o["embedding"])
            self.infer_batches += len(outs)
            with span("infer.d2h"):
                emb = torch.cat(outs)[:n].cpu().numpy()
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            np.save(os.path.join(out_dir, f"embedding_{worker}.npy"), emb)
            np.save(os.path.join(out_dir, f"ids_{worker}.npy"),
                    np.asarray(graph_ids, np.int32))
        return emb
