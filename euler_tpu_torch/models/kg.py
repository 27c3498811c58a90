"""Knowledge-graph embedding models: TransE/H/R/D and DistMult, and the
full-entity ranking evaluation.

Counterpart of euler_tpu/models/kg.py (reference: examples/TransX/
transX.py:24-130 and the transE/H/R/D projections, examples/distmult/
distmult.py): one module with a pluggable projection. The batch is
``[B, 3]`` int32 ``(src, dst, relation)``, as ``EdgeEstimator`` stacks
it from ``sample_edge``; the only randomness of a step is the negative
draw, ``B * num_negs`` nodes of ``node_type`` through ``select_nodes``,
from the ``generator`` or the replayed ``uniforms`` the caller passes.
``corrupt`` in {'front', 'tail', 'both'} and the margin over the mean of
the negative scores match transX.py. Tables are ``Embed`` (flax's
``nn.Embed``, with its NaN rows past the table), dense, updated whole by
the optimizer as optax updates them; with ``shard_embeddings`` the
entity table is a ``layers.ShardedEmbedding``, split over the mesh's
graph axis once ``parallel.train.init_sharded_params`` lays the model
out (the relation tables stay replicated; kg.py:46-63).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.graph.store import GraphTensors
from euler_tpu_torch.models.encoders import Embed
from euler_tpu_torch.models.layers import ShardedEmbedding
from euler_tpu_torch.ops import sampling
from euler_tpu_torch.ops.sigmoid_xent import xla_abs


def _l2norm(v: torch.Tensor) -> torch.Tensor:
    """v / max(||v||, 1e-12) over the last axis (kg.py ``_l2norm``)."""
    return F.normalize(v, dim=-1, eps=1e-12)


class TransX(nn.Module):
    """Base: entity and relation tables and the margin ranking energy.

    Tables hold ``n_entities + 1`` and ``n_relations + 1`` rows, drawn
    from ``generator`` (a CPU generator) and then moved to ``device``.
    """

    def __init__(self, n_entities: int, n_relations: int, ent_dim: int,
                 rel_dim: int, num_negs: int = 5, margin: float = 1.0,
                 l1: bool = True, corrupt: str = "both", node_type=-1,
                 shard_embeddings: bool = False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if corrupt not in ("front", "tail", "both"):
            raise ValueError(f"corrupt {corrupt!r} not in front, tail, both")
        dev = resolve_device(device)
        self.n_entities, self.n_relations = n_entities, n_relations
        self.ent_dim, self.rel_dim = ent_dim, rel_dim
        self.num_negs, self.margin, self.l1 = num_negs, margin, l1
        self.corrupt, self.node_type = corrupt, node_type
        self.shard_embeddings = shard_embeddings
        self.entity_encoder = (
            ShardedEmbedding(n_entities + 1, ent_dim, device="cpu",
                             generator=generator)
            if shard_embeddings else Embed(n_entities + 1, ent_dim,
                                           generator))
        self.relation_encoder = Embed(n_relations + 1, rel_dim, generator)
        self._setup_extra(generator)
        self.to(dev)

    def _setup_extra(self, generator) -> None:
        pass

    def project(self, ent_emb, ent_ids, rel_ids):
        """Projection hook: the normed entity for TransE."""
        return _l2norm(ent_emb)

    def score(self, src_e, rel_e, dst_e):
        """-||h + r - t||_{1 or 2} (transX.py:72-80); the L1 norm with
        XLA's gradient of |x| (1 at a zero difference)."""
        diff = src_e + rel_e - dst_e
        if self.l1:
            return -xla_abs(diff).sum(-1)
        return -(diff * diff).sum(-1).clamp_min(1e-12).sqrt()

    def _entity(self, g, ids):
        """The entity rows of ``ids``; ids below 0 read row 0, as the
        reference's ``maximum(ids, 0)``. The sharded table reads ``g``,
        the mesh's view (kg.py ``_ent``)."""
        if self.shard_embeddings:
            return self.entity_encoder(g, ids.clamp_min(0))
        return self.entity_encoder(ids.clamp_min(0))

    def forward(self, g: GraphTensors, batch: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                uniforms: Optional[Sequence[torch.Tensor]] = None):
        """``uniforms``: the (u_type, u1, u2) of the negative draw
        (``sampling.draw_node_uniforms`` of ``B * num_negs``)."""
        src, dst, rel = batch[:, 0], batch[:, 1], batch[:, 2]
        B = src.shape[0]
        if uniforms is None:
            uniforms = sampling.draw_node_uniforms(
                generator, B * self.num_negs, batch.device, g)
        neg = sampling.select_nodes(g, self.node_type, *uniforms).reshape(
            B, self.num_negs)

        rel_e = _l2norm(self.relation_encoder(rel.clamp_min(0)))
        src_e = self.project(self._entity(g, src), src, rel)
        dst_e = self.project(self._entity(g, dst), dst, rel)
        rel_b = rel[:, None].expand(B, self.num_negs)
        neg_e = self.project(self._entity(g, neg), neg, rel_b)

        pos_scores = self.score(src_e, rel_e, dst_e)[:, None]      # [B, 1]
        rel_x = rel_e[:, None, :]
        negs = []
        if self.corrupt in ("front", "both"):
            negs.append(self.score(neg_e, rel_x, dst_e[:, None, :]))
        if self.corrupt in ("tail", "both"):
            negs.append(self.score(src_e[:, None, :], rel_x, neg_e))
        neg_scores = torch.cat(negs, dim=-1)                       # [B, N']

        # margin over the MEAN of the negative scores (transE.py loss_fn)
        neg_mean = neg_scores.mean(-1, keepdim=True)
        loss = (self.margin + neg_mean - pos_scores).clamp_min(0).mean()
        return dict(loss=loss, logits=pos_scores, neg_logits=neg_scores,
                    embedding=src_e.reshape(B, -1))

    def rank_against_all(self, g: GraphTensors, batch: torch.Tensor,
                         direction: str = "tail") -> torch.Tensor:
        """[B, n_entities] scores of each triple against every entity as
        the corrupted head or tail (kg.py ``rank_against_all``). It makes
        a [B, n_entities, dim] intermediate: bound B."""
        src, dst, rel = batch[:, 0], batch[:, 1], batch[:, 2]
        ents = torch.arange(self.n_entities, dtype=torch.int32,
                            device=batch.device)
        rel_e = _l2norm(self.relation_encoder(rel.clamp_min(0)))[:, None, :]
        # candidates projected under each row's relation: [B or 1, E, d]
        cand = self.project(self._entity(g, ents)[None], ents[None],
                            rel[:, None])
        if direction == "tail":
            h = self.project(self._entity(g, src), src, rel)
            return self.score(h[:, None, :], rel_e, cand)
        if direction == "head":
            t = self.project(self._entity(g, dst), dst, rel)
            return self.score(cand, rel_e, t[:, None, :])
        raise ValueError(direction)


class TransE(TransX):
    """reference: transE.py — identity projection, normed embeddings."""


class TransH(TransX):
    """reference: transH.py — project onto the relation's hyperplane."""

    def _setup_extra(self, generator) -> None:
        self.hyper_vector = Embed(self.n_relations + 1, self.ent_dim,
                                  generator)

    def project(self, ent_emb, ent_ids, rel_ids):
        hyper = _l2norm(self.hyper_vector(rel_ids.clamp_min(0)))
        return ent_emb - (ent_emb * hyper).sum(-1, keepdim=True) * hyper


class TransR(TransX):
    """reference: transR.py — a per-relation entity-to-relation matrix."""

    def _setup_extra(self, generator) -> None:
        self.transfer_matrix = Embed(self.n_relations + 1,
                                     self.ent_dim * self.rel_dim, generator)

    def project(self, ent_emb, ent_ids, rel_ids):
        m = self.transfer_matrix(rel_ids.clamp_min(0)).reshape(
            tuple(rel_ids.shape) + (self.ent_dim, self.rel_dim))
        return _l2norm(torch.matmul(ent_emb[..., None, :], m)[..., 0, :])


class TransD(TransX):
    """reference: transD.py — dynamic mapping by transfer vectors."""

    def _setup_extra(self, generator) -> None:
        self.entity_transfer = Embed(self.n_entities + 1, self.ent_dim,
                                     generator)
        self.relation_transfer = Embed(self.n_relations + 1, self.rel_dim,
                                       generator)

    def project(self, ent_emb, ent_ids, rel_ids):
        et = self.entity_transfer(ent_ids.clamp_min(0))
        rt = self.relation_transfer(rel_ids.clamp_min(0))
        return _l2norm(ent_emb + (ent_emb * et).sum(-1, keepdim=True) * rt)


class DistMult(TransX):
    """reference: examples/distmult/distmult.py — the bilinear diagonal
    score <h, diag(r), t>, the same margin loss and, with ``l2_regular``,
    ``regular_param`` times the squared sum of both full tables."""

    def __init__(self, *args, l2_regular: bool = False,
                 regular_param: float = 1e-4, **kw):
        super().__init__(*args, **kw)
        self.l2_regular, self.regular_param = l2_regular, regular_param

    def score(self, src_e, rel_e, dst_e):
        return (src_e * rel_e * dst_e).sum(-1)

    def forward(self, g, batch, generator=None, uniforms=None):
        out = super().forward(g, batch, generator=generator,
                              uniforms=uniforms)
        if self.l2_regular:
            if self.shard_embeddings:
                raise NotImplementedError(
                    "DistMult l2_regular reads the full entity table; "
                    "disable it (or regularize per-batch) with "
                    "shard_embeddings=True")
            reg = (self.entity_encoder.weight.square().sum()
                   + self.relation_encoder.weight.square().sum())
            out["loss"] = out["loss"] + self.regular_param * reg
        return out


def _filter_keys(filter_known, E: int, R: int, a: int, o: int):
    """Sorted unique int64 keys ``(anchor * R + rel) * E + other`` of the
    known triples for one direction (anchor column ``a``, other ``o``).
    Rows whose other lies outside [0, E) can match no candidate and are
    left out, so that no key aliases another anchor's."""
    fk = np.asarray(filter_known, np.int64).reshape(-1, 3)
    fk = fk[(fk[:, o] >= 0) & (fk[:, o] < E)]
    return np.unique((fk[:, a] * R + fk[:, 2]) * E + fk[:, o])


def entity_ranks(model: TransX, g: GraphTensors, triples,
                 batch_size: int = 64, corrupt: str = "both",
                 filter_known=None) -> np.ndarray:
    """The rank of each test triple against the whole entity table: int64
    [T] for one direction, [2T] for 'both' (tail, then head).

    A triple's rank is 1 + the number of candidates scored strictly above
    the true one (kg.py ``rank_all_entities``). ``triples`` is [T, 3]
    (src, dst, relation), run in batches of ``batch_size`` padded with
    zero rows; ``corrupt`` is 'head', 'tail' or 'both'. ``filter_known``
    is [K, 3] of all true triples: a candidate that forms a known triple
    other than the test one does not count ("filtered"). The reference
    finds such a candidate by a bounded binary search over (anchor * R +
    rel, other) pairs; here one ``searchsorted`` over int64 keys
    ``(anchor * R + rel) * E + other`` finds the same set. The
    reference's int32 limit on ``E * R`` is kept.
    """
    triples = np.asarray(triples, np.int32)
    if triples.ndim != 2 or triples.shape[1] != 3:
        raise ValueError(f"triples must be [T,3] (src,dst,rel); "
                         f"got {triples.shape}")
    T, E, R = triples.shape[0], model.n_entities, model.n_relations
    dev = next(model.parameters()).device
    ftabs = None
    if filter_known is not None:
        if E * R >= 2 ** 31:
            raise ValueError(
                f"filtered ranking keys (entity*{R}+rel) overflow "
                f"int32 for n_entities={E}; shard the "
                "eval by relation or use the unfiltered setting")
        ftabs = {name: torch.from_numpy(_filter_keys(filter_known, E, R, a,
                                                     o)).to(dev)
                 for name, a, o in (("tail", 0, 1), ("head", 1, 0))}
    cand = torch.arange(E, dtype=torch.int64, device=dev)

    def ranks(batch, direction):
        scores = model.rank_against_all(g, batch, direction)
        tgt = (batch[:, 1] if direction == "tail" else batch[:, 0]).long()
        # the true score as take_along_axis reads it: a negative index
        # counts from the end, one past the table is NaN (rank 1)
        col = torch.where(tgt < 0, tgt + E, tgt)
        ok = (col >= 0) & (col < E)
        pos = torch.where(ok, scores.gather(1, col.clamp(0, E - 1)[:, None])
                          [:, 0], float("nan"))[:, None]
        better = scores > pos
        keys = ftabs[direction] if ftabs is not None else None
        if keys is not None and keys.numel():
            anchor = batch[:, 0] if direction == "tail" else batch[:, 1]
            row = (anchor.long() * R + batch[:, 2].long())[:, None] * E + cand
            idx = torch.searchsorted(keys, row).clamp_max(keys.numel() - 1)
            known = (keys[idx] == row) & (cand[None] != tgt[:, None])
            better &= ~known
        return 1 + better.sum(1)

    dirs = {"head": ["head"], "tail": ["tail"],
            "both": ["tail", "head"]}[corrupt]
    pad = (-T) % batch_size
    padded = np.concatenate([triples, np.zeros((pad, 3), np.int32)])
    model.eval()
    out = []
    with torch.no_grad():
        for d in dirs:
            rs = [ranks(torch.from_numpy(padded[i:i + batch_size]).to(dev), d)
                  for i in range(0, len(padded), batch_size)]
            out.append(torch.cat(rs)[:T].cpu().numpy())
    return np.concatenate(out)


def rank_all_entities(model: TransX, g: GraphTensors, triples,
                      batch_size: int = 64, corrupt: str = "both",
                      filter_known=None, hit_ks=(1, 3, 10)) -> dict:
    """Full-entity ranking: MeanRank (``mr``), ``mrr`` and ``hit{k}`` of
    ``entity_ranks`` (kg.py ``rank_all_entities``, the protocol of the
    reference's FB15k table; 'both' pools the two directions)."""
    r = entity_ranks(model, g, triples, batch_size, corrupt,
                     filter_known).astype(np.float64)
    out = {"mr": float(r.mean()), "mrr": float((1.0 / r).mean())}
    for k in hit_ks:
        out[f"hit{k}"] = float((r <= k).mean())
    return out
