"""KNN retrieval over inferred embeddings: exact search and an IVF index.

Counterpart of euler_tpu/knn.py (reference: knn/knn.py:36-86, faiss's
Flat and IVFFlat indexes). ``KnnIndex`` is exact: a matmul and a top-k on
the index's device, for l2, ip and cosine; ``k`` past the corpus raises,
as the reference's top-k does. ``IvfKnnIndex`` is IVFFlat over L2: k-means
centroids (Lloyd iterations on the device from numpy-seeded initial
centroids; a cluster's sum in a fixed order, so two builds give one
index), each point's cluster assigned on the host, and a search that
probes each query's ``nprobe`` nearest clusters and ranks their members
exactly, their rows gathered through ``gather_rows``.

CLI:  python -m euler_tpu_torch.knn --embedding_file emb.npy
          [--id_file ids.npy] [--query_file q.csv] [--k 10]
          [--metric l2|ip|cosine] [--index flat|ivfflat] [--nlist 64]
          [--nprobe 8] [--out result.npz] [--device cuda|cpu]
writes result.npz {distance, idx}.
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np
import torch

from euler_tpu_torch._device import resolve_device
from euler_tpu_torch.ops import mp_ops
from euler_tpu_torch.ops.gather_rows import gather_rows


def _top_k(score: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """The ``k`` largest of each row, in descending order; raises where
    ``k`` exceeds the row, as the reference's ``jax.lax.top_k`` does."""
    if k > score.shape[-1]:
        raise ValueError(f"k argument to top_k must be no larger than size "
                         f"along axis; got k={k} with shape="
                         f"{list(score.shape)} and axis=1")
    return torch.topk(score, k)


class KnnIndex:
    """Exact top-k over a corpus of embeddings held on ``device``."""

    def __init__(self, embeddings: np.ndarray,
                 ids: Optional[np.ndarray] = None, metric: str = "l2",
                 device=None):
        if metric not in ("l2", "ip", "cosine"):
            raise ValueError(f"unknown metric {metric!r}")
        self.metric = metric
        self.device = resolve_device(device)
        emb = np.asarray(embeddings, np.float32)
        if metric == "cosine":
            emb = emb / np.maximum(
                np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
        self._emb = torch.from_numpy(np.ascontiguousarray(emb)).to(
            self.device)
        self._sq = (self._emb * self._emb).sum(dim=1)
        self.ids = np.arange(len(emb)) if ids is None else np.asarray(ids)

    def _queries(self, queries) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            queries, np.float32)).to(self.device)

    def search(self, queries: np.ndarray, k: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (distance [Q, k], ids [Q, k]); ``k`` may not exceed the
        corpus (ValueError)."""
        q = self._queries(queries)
        if self.metric == "cosine":
            q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
        dots = q @ self._emb.T                        # [Q, N]
        if self.metric == "l2":
            # ||q||^2 is constant per row: rank by it only at the end
            neg_d, idx = _top_k(-(self._sq[None, :] - 2.0 * dots), k)
            dist = (q * q).sum(dim=1, keepdim=True) - neg_d
        else:
            dist, idx = _top_k(dots, k)
        return dist.cpu().numpy(), self.ids[idx.cpu().numpy()]


def lloyd_step(emb: torch.Tensor, cent: torch.Tensor,
               fixed_order: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd iteration (reference: knn.py:68-85): each point to its
    nearest centroid by L2 (the lower index among ties), each centroid to
    its points' mean; an empty cluster keeps its centroid. Returns (new
    centroids f32 [C, D], assignment int64 [N]). With ``fixed_order`` a
    cluster's sum adds in one order on every run
    (``mp_ops.scatter_add``); else in the order of the card's atomics."""
    esq = (emb * emb).sum(dim=1)
    d = esq[:, None] - 2.0 * (emb @ cent.T) + (cent * cent).sum(dim=1)[None]
    a = torch.argmin(d, dim=1)
    C = cent.shape[0]
    sums = mp_ops.scatter_add(emb, a, C, fixed_order=fixed_order)
    cnt = torch.bincount(a, minlength=C).to(emb.dtype)[:, None]
    return torch.where(cnt > 0, sums / cnt.clamp_min(1.0), cent), a


def kmeans(emb: torch.Tensor, cent: torch.Tensor, iters: int,
           fixed_order: bool = True) -> torch.Tensor:
    """``iters`` Lloyd iterations from ``cent`` on ``emb``'s device."""
    for _ in range(iters):
        cent, _ = lloyd_step(emb, cent, fixed_order)
    return cent


def ivf_search(emb: torch.Tensor, cent: torch.Tensor, members: torch.Tensor,
               q: torch.Tensor, k: int, nprobe: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's ``nprobe`` nearest clusters, then exact L2 over their
    members (reference: knn.py:88-103): the candidates' rows
    (``members`` [C, maxM] padded with -1, ids clamped at 0) go through
    ``gather_rows``, [Q, nprobe * maxM, D]. Returns (distance f32 [Q, k],
    index int [Q, k]), +inf and -1 where fewer candidates exist."""
    C, maxM = members.shape
    cd = -((cent * cent).sum(dim=1)[None, :] - 2.0 * (q @ cent.T))
    _, probe = _top_k(cd, nprobe)                            # [Q, nprobe]
    Q = q.shape[0]
    cand = members[probe].reshape(Q, nprobe * maxM)
    rows = gather_rows(emb, cand.clamp_min(0).reshape(-1).contiguous())
    rows = rows.reshape(Q, nprobe * maxM, emb.shape[1])
    d = (rows * rows).sum(dim=-1) - 2.0 * torch.einsum("qd,qcd->qc", q,
                                                       rows)
    score = torch.where(cand >= 0, -d, float("-inf"))
    neg_d, pos = _top_k(score, k)
    idx = torch.gather(cand, 1, pos)
    qsq = (q * q).sum(dim=1, keepdim=True)
    return qsq - neg_d, torch.where(torch.isfinite(neg_d), idx, -1)


class IvfKnnIndex(KnnIndex):
    """IVFFlat (reference: knn/knn.py's faiss IndexIVFFlat with nlist and
    nprobe; L2 only): ``n_clusters`` k-means centroids from
    ``iters`` Lloyd iterations, started at ``n_clusters`` corpus rows
    that ``numpy.random.default_rng(seed)`` chooses; each point in its
    nearest centroid's cluster (on the host, in numpy); a search ranks
    the members of each query's ``nprobe`` nearest clusters exactly.
    Recall approaches the exact index's as ``nprobe`` nears
    ``n_clusters``."""

    def __init__(self, embeddings, ids=None, n_clusters: int = 64,
                 nprobe: int = 8, iters: int = 10, seed: int = 0,
                 device=None):
        super().__init__(embeddings, ids, metric="l2", device=device)
        emb = np.asarray(embeddings, np.float32)
        n = len(emb)
        C = max(1, min(n_clusters, n))
        rng = np.random.default_rng(seed)
        cent0 = emb[rng.choice(n, C, replace=False)]
        self._cent = kmeans(self._emb, torch.from_numpy(cent0).to(
            self.device), iters)
        cent = self._cent.cpu().numpy()
        d = (np.sum(emb * emb, axis=1)[:, None] - 2.0 * emb @ cent.T
             + np.sum(cent ** 2, axis=1)[None, :])
        assign = np.argmin(d, axis=1)
        order = np.argsort(assign, kind="stable")
        sizes = np.bincount(assign, minlength=C)
        tab = np.full((C, max(1, int(sizes.max(initial=0)))), -1, np.int32)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        tab[assign[order], np.arange(n) - starts[assign[order]]] = order
        self._members = torch.from_numpy(tab).to(self.device)
        self.nprobe = min(nprobe, C)

    def search(self, queries, k: int = 10, nprobe: Optional[int] = None):
        """Returns (distance [Q, k], ids [Q, k]); where the probed clusters
        hold fewer than ``k`` members the tail is +inf and -1, as an
        under-filled faiss result."""
        q = self._queries(queries)
        C, maxM = self._members.shape
        np_ = min(nprobe or self.nprobe, C)
        kk = min(k, np_ * maxM)
        d, i = ivf_search(self._emb, self._cent, self._members, q, kk, np_)
        d, i = d.cpu().numpy(), i.cpu().numpy()
        if kk < k:
            d = np.concatenate(
                [d, np.full((d.shape[0], k - kk), np.inf, d.dtype)], axis=1)
            i = np.concatenate(
                [i, np.full((i.shape[0], k - kk), -1, i.dtype)], axis=1)
        return d, np.where(i >= 0, self.ids[np.maximum(i, 0)], -1)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m euler_tpu_torch.knn",
                                description="KNN search over an embedding "
                                            "file (exact or IVFFlat)")
    p.add_argument("--embedding_file", required=True)
    p.add_argument("--id_file", default=None)
    p.add_argument("--query_file", default=None)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--metric", default="l2", choices=["l2", "ip", "cosine"])
    p.add_argument("--index", default="flat", choices=["flat", "ivfflat"],
                   help="ivfflat = coarse-quantized approximate search "
                        "(the reference CLI's index_type)")
    p.add_argument("--nlist", type=int, default=64)
    p.add_argument("--nprobe", type=int, default=8)
    p.add_argument("--out", default="result.npz")
    p.add_argument("--device", default=None,
                   help="torch device of the index (default: cuda)")
    args = p.parse_args(argv)

    emb = np.load(args.embedding_file)
    ids = np.load(args.id_file) if args.id_file else None
    if args.index == "ivfflat":
        index = IvfKnnIndex(emb, ids, n_clusters=args.nlist,
                            nprobe=args.nprobe, device=args.device)
    else:
        index = KnnIndex(emb, ids, args.metric, device=args.device)
    if args.query_file:
        q = np.loadtxt(args.query_file, dtype=np.float32, delimiter=",")
        q = q.reshape(-1, emb.shape[1])
    else:
        q = emb[:25]
    d, i = index.search(q, args.k)
    np.savez(args.out, distance=d, idx=i)
    print(f"[euler_tpu_torch.knn] wrote {args.out}: {d.shape[0]} queries "
          f"x top-{args.k}")


if __name__ == "__main__":
    main()
