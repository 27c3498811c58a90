"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``benchmark/reference``) run on the same
inputs once the window has closed and the program's state is freed.

Training cells: the reference follows the program's first steps (taken
through the window's own ``TrainLoop`` call in set-up) from the same
weights. Each step's loss, the first gradient as Adam holds it, and the
weights' change after the steps, each leaf's norm against the
reference's (``norm_gap``). A sampled flow's draws cannot be followed lane
by lane (alias tables are not unique), so the reference judges them:
every draw is an out-neighbor of its parent (``draw_misses``), their
weights fit the weighted draw (``draw_weight_z``) and no step repeats an
earlier step's roots or draws (``stale_draws``); it then runs the model
over those draws.

Inference cells: a sample of the window's answers, drawn from the seed;
the draws of each sampled request are copied as the window serves it,
and its answer is held to the reference's embedding over those draws.

``check`` is what a configuration's module exposes: the numbers of one
run, from the benchmark's own inputs that the system handed back and the
evidence its drive collected.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.harness.supervised import make_data
from benchmark.reference import gnn as ref_gnn
from benchmark.reference.graph import RefGraph, draw_check, sampled_hops

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's moves by round-off alone under Adam and is left out
TINY_LEAF = 1e-3


def kept_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(g.norm()) for k, g in ref_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= TINY_LEAF * med]


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keep: Sequence[str]) -> float:
    """max over the kept leaves of | |prog| - |ref| | over the larger of
    |ref| of that leaf and of the median kept leaf."""
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = statistics.median(rn.values())
    return max(abs(float(prog[k].double().norm()) - rn[k])
               / max(rn[k], med, 1e-30) for k in keep)


def direction_gap(prog: Dict[str, torch.Tensor],
                  ref: Dict[str, torch.Tensor], keep: Sequence[str]) -> float:
    """max over the kept leaves of 1 - cos(prog, ref): where the norms
    agree, a gradient of other rows (half of the batch) still points
    elsewhere."""
    out = 0.0
    for k in keep:
        a, b = prog[k].double().reshape(-1), ref[k].double().reshape(-1)
        den = float(a.norm() * b.norm())
        out = max(out, 1.0 - float(a @ b) / den if den > 0 else 1.0)
    return out


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``loss`` (a list a step), ``grad1``
    (the first step's gradient by leaf), ``weights0`` and ``weights``
    (after the last step). ``loss_gap`` is the worst step's relative
    loss gap and ``first_loss_gap`` the first step's: a cell's limits
    file names the one it compares."""
    keep = kept_leaves(ref["grad1"])
    dp = {k: prog["weights"][k].cpu() - prog["weights0"][k].cpu()
          for k in keep}
    dr = {k: ref["weights"][k].cpu() - ref["weights0"][k].cpu()
          for k in keep}
    gaps = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]) or not all(
            np.isfinite(prog["loss"])):
        gaps = [float("inf")]
    gp = {k: v.cpu() for k, v in prog["grad1"].items()}
    gr = {k: v.cpu() for k, v in ref["grad1"].items()}
    return {"loss_gap": max(gaps), "first_loss_gap": gaps[0],
            "grad_gap": norm_gap(gp, gr, keep),
            "grad_dir_gap": direction_gap(gp, gr, keep),
            "update_gap": norm_gap(dp, dr, keep)}


def roots_misses(roots: torch.Tensor, n_id: torch.Tensor, n: int) -> int:
    """Roots that are no node, or that the deepest block does not start
    with."""
    b = roots.shape[0]
    return int(((roots < 0) | (roots >= n)).sum()
               + (n_id[:b] != roots.to(n_id.dtype)).sum())


class Reference:
    """The reference's view of one configuration and seed: the graph
    rebuilt from the benchmark's arrays, the seed's data made again and
    the weights the benchmark made."""

    def __init__(self, cfg: dict, arrays, seed: int, device,
                 weights0: Dict[str, torch.Tensor],
                 graph: Optional[RefGraph] = None):
        ref_gnn.no_tf32()
        self.cfg, self.device = cfg, torch.device(device)
        self.n = cfg["graph"]["nodes"]
        self.graph = graph or RefGraph(arrays, self.n, self.device)
        self.data = make_data(cfg, seed, self.device)
        self.weights0 = {k: v.to(self.device, torch.float32)
                         for k, v in weights0.items()}
        self.sampled = cfg["model"]["flow"] == "sampled"
        self.whole = None if self.sampled else ref_gnn.WholeGraph(self.graph)

    def embed(self, w, roots: torch.Tensor, n_id: Optional[torch.Tensor],
              q=ref_gnn.identity) -> torch.Tensor:
        m = self.cfg["model"]
        if self.sampled:
            return ref_gnn.sage_embed(w, self.data["feature"],
                                      n_id.to(self.device), roots.shape[0],
                                      m["fanouts"], q)
        return ref_gnn.gcn_embed(w, self.data["feature"], self.whole,
                                 m["layers"], q)[roots.long()]

    def loss(self, w, roots: torch.Tensor, n_id, q=ref_gnn.identity,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        roots = roots.to(self.device)
        emb = self.embed(w, roots, n_id, q)
        label = ref_gnn.rows(self.data["label"], roots)
        ok = roots >= 0 if valid is None else valid.to(self.device)
        return ref_gnn.sigmoid_xent_loss(emb @ w["head.w"].T, label, ok)

    def follow(self, rec: dict, q=ref_gnn.identity, valid=None) -> dict:
        """The reference's own steps on the program's roots and draws."""
        steps = len(rec["loss"])
        lr = self.cfg["train"]["learning_rate"]
        out = ref_gnn.train_steps(
            self.weights0, lr,
            lambda w, i: self.loss(w, rec["roots"][i], rec["n_id"][i], q,
                                   None if valid is None else valid(
                                       rec["roots"][i])), steps)
        out["weights0"] = self.weights0
        return out

    def draws(self, roots_list, n_id_list) -> Dict[str, float]:
        hops, misses = [], 0
        for roots, n_id in zip(roots_list, n_id_list):
            roots, n_id = roots.to(self.device), n_id.to(self.device)
            misses += roots_misses(roots, n_id, self.n)
            hops += sampled_hops(roots, n_id, self.cfg["model"]["fanouts"])
        out = draw_check(self.graph, hops)
        out["draw_misses"] += misses
        return out


def stale_draws(roots_list, n_id_list) -> int:
    """Steps whose roots or draws equal those of an earlier step (a
    generator that no longer advances, or records that do not follow
    the replays)."""
    out = 0
    for i in range(1, len(roots_list)):
        out += any(torch.equal(roots_list[i], roots_list[j])
                   or torch.equal(n_id_list[i], n_id_list[j])
                   for j in range(i))
    return out


def check_train(ref: Reference, rec: dict) -> Dict[str, float]:
    """The numbers a training cell compares: the program's records of its
    first steps (``Supervised.first_steps``) against the reference's."""
    prog = dict(loss=rec["loss"], grad1=rec["grad1"],
                weights0=rec["weights0"], weights=rec["weights_after"])
    out = train_gaps(prog, ref.follow(rec))
    if ref.sampled:
        out.update(ref.draws(rec["roots"], rec["n_id"]))
        out["stale_draws"] = float(stale_draws(rec["roots"], rec["n_id"]))
    else:
        # the first ``batch`` nodes are the roots of each whole-graph step
        every = torch.arange(ref.cfg["train"]["batch"], dtype=torch.int32)
        out["root_misses"] = float(sum(
            every.shape[0] if r.shape != every.shape
            else int((r != every).sum()) for r in rec["roots"]))
    return out


def request_batches(ref: Reference, sample: dict):
    """(roots, n_id, real) of each batch a request ran in: the batch's ids
    padded with -1 as ``infer`` pads them, its deepest block's source ids
    and how many of its rows are the request's."""
    per_root = 1
    for f in ref.cfg["model"]["fanouts"]:
        per_root *= 1 + f
    ids = torch.from_numpy(np.asarray(sample["ids"], np.int32))
    out, at = [], 0
    for n_id in sample["n_ids"]:
        b = n_id.shape[0] // per_root
        roots = torch.full((b,), -1, dtype=torch.int32)
        part = ids[at:at + b]
        roots[:part.shape[0]] = part
        at += b
        out.append((roots, n_id, part.shape[0]))
    return out


def reference_answer(ref: Reference, sample: dict, q=ref_gnn.identity
                     ) -> torch.Tensor:
    """The reference's embeddings of a request over its draws."""
    embs = []
    for roots, n_id, real in request_batches(ref, sample):
        with torch.no_grad():
            embs.append(ref.embed(ref.weights0, roots.to(ref.device), n_id,
                                  q)[:real])
    return torch.cat(embs)


def check_infer(ref: Reference, samples: List[dict]) -> Dict[str, float]:
    """The numbers an inference cell compares over sampled requests, each
    a dict of ``ids``, the window's ``answer`` and ``n_ids``, the deepest
    block's source ids of each batch the request ran in, copied as it ran:
    ``emb_gap``, the largest |answer - reference| over the largest
    |reference| of a request, and the draws'. A request runs in batches
    of the estimator's batch size, the last padded with -1."""
    gap, roots_all, n_id_all = 0.0, [], []
    for s in samples:
        emb = reference_answer(ref, s)
        ans = torch.from_numpy(np.asarray(s["answer"], np.float32))
        if emb.shape != ans.shape:
            return {"emb_gap": float("inf")}
        g = float((ans.to(ref.device) - emb).abs().max() / emb.abs().max())
        gap = max(gap, g if np.isfinite(g) else float("inf"))
        for roots, n_id, _ in request_batches(ref, s):
            roots_all.append(roots)
            n_id_all.append(n_id)
    out = {"emb_gap": gap}
    out.update(ref.draws(roots_all, n_id_all))
    return out


def check(cfg: dict, seed: int, device, handed: dict, evidence: dict
          ) -> Dict[str, float]:
    """The compared numbers of one run of a supervised GNN cell: the
    reference over the benchmark's inputs (``handed`` by
    ``Supervised.release``) judges the ``evidence`` of the drive: a
    training drive's first ``steps``, or a request drive's sampled
    ``answers``."""
    ref = Reference(cfg, handed["arrays"], seed, device, handed["weights0"])
    if "steps" in evidence:
        return check_train(ref, evidence["steps"])
    answers = evidence["answers"]
    if not answers or any(a["answer"] is None for a in answers):
        return {"emb_gap": float("inf")}
    return check_infer(ref, answers)
