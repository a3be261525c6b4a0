"""IVFPQ index assembly (offline phase) and flat single-host search.

Mirrors the paper's offline phase: IVF coarse clustering -> residuals -> PQ
encoding -> cluster-sorted code storage (CSR layout).  The index itself is
host-side numpy (it is what the shard packer and the planners read); the
heavy arithmetic -- training, assignment, encoding, the CSR sort -- runs on
the caller's torch device in row chunks, so a 100M-row corpus held on the
card as bf16 never needs a host f32 copy.  Every function here runs on
`cuda` unless the caller passes `device="cpu"` (`repro_torch.device`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.kmeans import _pairwise_sq_l2, kmeans, nearest
from repro_torch.core.pq import pq_encode, train_pq
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

# rows per assignment / encoding chunk (bounds the (chunk, C) distance block)
_CHUNK = 1 << 16


@dataclasses.dataclass
class IVFPQIndex:
    """Cluster-sorted IVFPQ index (host numpy arrays).

    Storage invariant (CSR): `codes`/`vec_ids` hold the rows of cluster c
    contiguously at `[offsets[c], offsets[c + 1])`, clusters in ascending id
    order, and within a cluster rows keep their original insertion order.
    `validate()` asserts it.

    Attributes:
      centroids: (C, D) f32 coarse centroids (rotated space under OPQ).
      codebook: (M, 256, d_sub) f32 PQ codebooks (of residuals).
      codes: (N, M) uint8, rows sorted by cluster id.
      vec_ids: (N,) int32 global vector ids, same order as codes.
      offsets: (C + 1,) int64 CSR offsets into codes/vec_ids.
      rotation: optional (D, D) orthonormal OPQ rotation; queries go
        through `rotate()` before meeting centroids or codes.
    """

    centroids: np.ndarray
    codebook: np.ndarray
    codes: np.ndarray
    vec_ids: np.ndarray
    offsets: np.ndarray
    rotation: np.ndarray | None = None

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_vectors(self) -> int:
        return self.codes.shape[0]

    @property
    def m(self) -> int:
        return self.codes.shape[1]

    def cluster_sizes(self) -> np.ndarray:
        return np.diff(self.offsets)

    def rotate(self, vectors: np.ndarray) -> np.ndarray:
        """Map original-space vectors into this index's coding space.

        Identity without an OPQ rotation; otherwise `v @ R`.
        """
        if self.rotation is None:
            return vectors
        return np.asarray(vectors, np.float32) @ self.rotation

    def cluster_codes(self, c: int) -> np.ndarray:
        return self.codes[self.offsets[c] : self.offsets[c + 1]]

    def cluster_ids(self, c: int) -> np.ndarray:
        return self.vec_ids[self.offsets[c] : self.offsets[c + 1]]

    def validate(self) -> "IVFPQIndex":
        """Raise ValueError unless the CSR storage invariant holds; returns self."""
        if self.offsets.shape != (self.n_clusters + 1,):
            raise ValueError(
                f"offsets shape {self.offsets.shape} != (C+1,)="
                f"({self.n_clusters + 1},)"
            )
        if self.offsets[0] != 0 or (np.diff(self.offsets) < 0).any():
            raise ValueError("offsets must start at 0 and be non-decreasing")
        if int(self.offsets[-1]) != self.codes.shape[0]:
            raise ValueError(
                f"offsets[-1]={int(self.offsets[-1])} != "
                f"codes rows {self.codes.shape[0]}"
            )
        if self.vec_ids.shape[0] != self.codes.shape[0]:
            raise ValueError(
                f"vec_ids rows {self.vec_ids.shape[0]} != "
                f"codes rows {self.codes.shape[0]}"
            )
        n = self.vec_ids.size
        if n and 0 <= int(self.vec_ids.min()) and int(self.vec_ids.max()) < 4 * n:
            dup = int(np.bincount(self.vec_ids).max()) > 1  # dense ids: O(N)
        else:
            dup = np.unique(self.vec_ids).size != n
        if dup:
            raise ValueError("duplicate vector ids in index")
        return self


def _as_tensor(xs, device: torch.device) -> torch.Tensor:
    """numpy or tensor rows -> tensor on `device` (dtype kept; chunks widen)."""
    if isinstance(xs, torch.Tensor):
        return xs if xs.device == device else xs.to(device)
    arr = np.asarray(xs, np.float32)
    return torch.as_tensor(arr if arr.flags.writeable else arr.copy(), device=device)


def assign_clusters(centroids, xs, device: torch.device | str | None = None) -> torch.Tensor:
    """(N,) int64 nearest coarse centroid per vector, computed in row chunks
    on `device` (f32 arithmetic whatever the storage type of xs)."""
    device = resolve_device(device)
    cent = _as_tensor(centroids, device).float()
    return nearest(_as_tensor(xs, device), cent, chunk=_CHUNK)[0]


def encode_vectors(codebook, centroids, xs, assign, device=None) -> torch.Tensor:
    """(N, M) uint8 PQ codes of the residuals xs - centroids[assign]."""
    device = resolve_device(device)
    xs = _as_tensor(xs, device)
    cb = _as_tensor(codebook, device).float()
    cent = _as_tensor(centroids, device).float()
    assign = torch.as_tensor(assign, device=device).long()
    codes = torch.empty((xs.shape[0], cb.shape[0]), dtype=torch.uint8, device=device)
    for s in range(0, xs.shape[0], _CHUNK):
        res = xs[s : s + _CHUNK].float() - cent[assign[s : s + _CHUNK]]
        codes[s : s + _CHUNK] = pq_encode(cb, res)
    return codes


def encode_index(
    centroids,
    codebook,
    xs,
    vec_ids: np.ndarray | None = None,
    assign=None,
    rotation: np.ndarray | None = None,
    device: torch.device | str | None = None,
) -> IVFPQIndex:
    """Assemble an IVFPQIndex from *already trained* centroids + codebooks.

    Assignment, residual encoding and the CSR sort run on `device`; the
    result is host numpy.  `assign` may carry a precomputed assignment
    (it must equal `assign_clusters(centroids, xs)`); `rotation` is only
    recorded -- `centroids` and `xs` must already be rotated.
    """
    device = resolve_device(device)
    n_clusters = centroids.shape[0]
    if assign is None:
        assign = assign_clusters(centroids, xs, device)
    assign = torch.as_tensor(assign, device=device).long()
    codes = encode_vectors(codebook, centroids, xs, assign, device)
    n = codes.shape[0]
    if vec_ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=device)
    else:
        ids = torch.as_tensor(np.asarray(vec_ids, np.int32), device=device)
    order = torch.sort(assign, stable=True).indices
    sizes = torch.bincount(assign, minlength=n_clusters).cpu().numpy()
    offsets = np.zeros(n_clusters + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return IVFPQIndex(
        centroids=np.asarray(
            centroids.cpu() if isinstance(centroids, torch.Tensor) else centroids,
            np.float32,
        ),
        codebook=np.asarray(
            codebook.cpu() if isinstance(codebook, torch.Tensor) else codebook,
            np.float32,
        ),
        codes=codes[order].cpu().numpy(),
        vec_ids=ids[order].cpu().numpy(),
        offsets=offsets,
        rotation=rotation,
    ).validate()


def build_index(
    xs,
    n_clusters: int,
    m: int,
    kmeans_iters: int = 25,
    pq_iters: int = 20,
    train_subsample: int | None = None,
    pq_train_subsample: int | None = None,
    opq_iters: int = 0,
    generator: torch.Generator | None = None,
    device: torch.device | str | None = None,
) -> IVFPQIndex:
    """Offline phase: IVF + PQ, trained and encoded on `device`.

    Args:
      xs: (N, D) numpy array or tensor (any float type; bf16 rows on the
        card are widened to f32 chunk by chunk).
      train_subsample: optional row cap for IVF k-means training (the full
        dataset is still assigned and encoded).
      pq_train_subsample: optional row cap for PQ training, drawn from the
        k-means sample's residuals.
      generator: CPU `torch.Generator` for the samples and k-means seeding.
      opq_iters: OPQ is not ported yet; > 0 raises NotImplementedError.
    """
    if opq_iters > 0:
        raise NotImplementedError(
            "OPQ (opq_iters > 0) is not ported to repro_torch yet; see "
            "ROADMAP.md queue A item 11"
        )
    device = resolve_device(device)
    xs_t = _as_tensor(xs, device)
    n = xs_t.shape[0]
    if train_subsample is not None and train_subsample < n:
        sel = torch.randperm(n, generator=generator)[:train_subsample].to(device)
        train = xs_t[sel].float()
    else:
        train = xs_t.float()
    centroids, train_assign = kmeans(
        train, n_clusters, iters=kmeans_iters, generator=generator
    )
    res_train = train - centroids[train_assign]
    if pq_train_subsample is not None and pq_train_subsample < res_train.shape[0]:
        res_train = res_train[:pq_train_subsample]
    codebook = train_pq(res_train, m, iters=pq_iters, generator=generator)
    del train, res_train
    return encode_index(centroids, codebook, xs_t, device=device)


def filter_clusters(
    centroids: torch.Tensor, queries: torch.Tensor, nprobe: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Online stage (a): pick the nprobe closest coarse centroids per query.

    Returns (cluster_ids (Q, nprobe) int64, q_minus_c (Q, nprobe, D) f32).
    Equal distances keep the lower centroid id (stable sort), as the
    reference's `top_k` does.
    """
    d2 = _pairwise_sq_l2(queries.float(), centroids.float())
    cids = torch.sort(d2, dim=1, stable=True).indices[:, :nprobe]
    qmc = queries.float()[:, None, :] - centroids.float()[cids]
    return cids, qmc


def probe_groups(
    index: IVFPQIndex, cids: torch.Tensor
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The flat search's groups, on the host: the (query, probe) pairs
    sorted by probed cluster (stable, so ascending pair index within a
    cluster), one group per distinct probed cluster.  Returns (order (P,)
    pair indices in group order, row_offsets and table_offsets (groups + 1,)
    into the concatenated cluster rows and the sorted pairs, rows (the CSR
    rows of the probed clusters, one cluster after the other))."""
    pair_c = cids.reshape(-1).cpu().numpy()
    order = np.argsort(pair_c, kind="stable")
    clusters, first = np.unique(pair_c[order], return_index=True)
    sizes = index.cluster_sizes()[clusters]
    row_off = np.zeros(len(clusters) + 1, np.int64)
    np.cumsum(sizes, out=row_off[1:])
    rows = np.repeat(index.offsets[clusters] - row_off[:-1], sizes) + np.arange(row_off[-1])
    return order, row_off, np.concatenate([first, [len(order)]]), rows


def search(
    index: IVFPQIndex,
    queries: np.ndarray,
    nprobe: int,
    k: int,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Flat (single-device) IVFPQ search -- the CPU-Faiss-style baseline.

    Returns (dists (Q, k), ids (Q, k)) of approximate nearest neighbours
    (ADC distances), (+inf, -1) in lanes without a row.  The tables of all
    (query, probe) pairs come from one B1 launch (`ops.build_luts`), the
    scans from one B6 launch (`ops.adc_topk_grouped`): one group per
    distinct probed cluster, its rows (the probed clusters' codes uploaded
    once, one after the other) scanned by the tables of the (query, probe)
    pairs that probe it.  A probed cluster smaller than k contributes all
    its rows, (+inf, -1) after them (the reference asks for k and crashes
    there, ROADMAP C1).  Each query's per-probe lists are merged in probe
    order by one stable sort, which equals the reference's iterated stable
    merges.
    """
    device = resolve_device(device)
    q = torch.as_tensor(index.rotate(np.asarray(queries, np.float32)), device=device)
    cids, qmc = filter_clusters(torch.as_tensor(index.centroids, device=device), q, nprobe)
    q_n, n_probe = cids.shape
    codebook = torch.as_tensor(index.codebook, device=device)
    m, _, dsub = codebook.shape
    luts = ops.build_luts(codebook, qmc.reshape(q_n * n_probe, m, dsub))
    luts = luts.reshape(q_n * n_probe, m * 256)

    order, row_off, tab_off, rows = probe_groups(index, cids)
    codes = torch.as_tensor(index.codes[rows], device=device)
    ids = torch.as_tensor(index.vec_ids[rows], device=device).long()
    order_t = torch.as_tensor(order, device=device)
    # each sorted pair's group: its first code row
    row_base = torch.as_tensor(np.repeat(row_off[:-1], np.diff(tab_off)), device=device)
    v, r = ops.adc_topk_grouped(luts[order_t], codes, k, row_off, tab_off)
    out_v = torch.empty_like(v)
    out_i = torch.empty(v.shape, dtype=torch.int64, device=device)
    out_v[order_t] = v
    if ids.numel():
        out_i[order_t] = torch.where(r >= 0, ids[(row_base[:, None] + r).clamp_min(0)], -1)
    else:
        out_i.fill_(-1)

    # per query, its probes' lists in probe order, one stable sort
    v = out_v.reshape(q_n, n_probe * k)
    sel = torch.sort(v, dim=1, stable=True).indices[:, :k]
    out_d = v.gather(1, sel)
    ids_q = out_i.reshape(q_n, n_probe * k).gather(1, sel)
    return out_d.cpu().numpy(), ids_q.cpu().numpy()


def brute_force(
    xs, queries, k: int, device: torch.device | str | None = None, chunk: int = 1 << 20
) -> tuple[np.ndarray, np.ndarray]:
    """Exact k-NN ground truth (expansion distances, stable by index).

    xs may be a numpy array or a tensor of any float type; it is scanned in
    row chunks on `device` with a running stable top-k, which equals one
    stable argsort over all rows.
    """
    device = resolve_device(device)
    xs_t = _as_tensor(xs, device)
    qs = _as_tensor(queries, device).float()
    best_d = torch.full((qs.shape[0], 0), torch.inf, device=device)
    best_i = torch.zeros((qs.shape[0], 0), dtype=torch.int64, device=device)
    for s in range(0, xs_t.shape[0], chunk):
        d2 = _pairwise_sq_l2(qs, xs_t[s : s + chunk].float())
        idx = torch.arange(s, s + d2.shape[1], device=device).expand_as(d2)
        vals = torch.cat([best_d, d2], dim=1)
        ids = torch.cat([best_i, idx], dim=1)
        order = torch.sort(vals, dim=1, stable=True).indices[:, :k]
        best_d, best_i = vals.gather(1, order), ids.gather(1, order)
    return best_d.cpu().numpy(), best_i.cpu().numpy()


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """recall@k: |found ∩ true| / k averaged over queries."""
    hits = 0
    for f, t in zip(found_ids, true_ids):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / true_ids.size
