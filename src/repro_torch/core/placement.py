"""Algorithm 1: PIM-aware data placement (paper §4.1), device == DPU.

Distributes IVF clusters across devices so that per-device *scan workload*
w_i = s_i * f_i (cluster size x access frequency) is balanced.  Hot clusters
are replicated ncpy = ceil(s_i * f_i / W_bar) times; each copy is placed on
the first device (round-robin cursor) whose load stays under W_bar * thld and
whose vector capacity is respected; thld is relaxed in +rate steps when a full
sweep finds no host.  Optionally co-locates near clusters (by centroid
distance) on the same device so their partial top-k merges stay local.

Host-side (numpy): this is the paper's offline phase, executed on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Placement:
    """Result of Algorithm 1.

    Attributes:
      replicas: replicas[c] = list of device ids holding a copy of cluster c.
      dev_load: (ndev,) expected scan workload per device (sum of w_i shares).
      dev_vectors: (ndev,) number of stored vectors per device.
      dev_clusters: dev_clusters[d] = list of cluster ids stored on device d.
      w_bar: the target balanced per-device workload.
    """

    replicas: list[list[int]]
    dev_load: np.ndarray
    dev_vectors: np.ndarray
    dev_clusters: list[list[int]]
    w_bar: float

    def max_imbalance(self) -> float:
        """max device load / mean device load (1.0 == perfectly balanced)."""
        mean = float(self.dev_load.mean())
        return float(self.dev_load.max()) / max(mean, 1e-12)

    def replica_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Dense replica map for the vectorized scheduler.

        Cached after the first call: placement is immutable once built, and
        the table is consumed on every online batch.

        Returns:
          (table (C, R_max) int32 device ids padded with -1, preserving the
           per-cluster replica list order; n_replicas (C,) int32).
        """
        cached = getattr(self, "_replica_table", None)
        if cached is not None:
            return cached
        c = len(self.replicas)
        n_rep = np.fromiter(
            (len(r) for r in self.replicas), np.int32, count=c
        )
        table = np.full((c, max(int(n_rep.max(initial=1)), 1)), -1, np.int32)
        for ci, reps in enumerate(self.replicas):
            table[ci, : len(reps)] = reps
        self._replica_table = (table, n_rep)
        return self._replica_table


def estimate_frequencies(
    probed_history: np.ndarray, n_clusters: int, smoothing: float = 1.0
) -> np.ndarray:
    """The paper's `f_i` predictor from historical query logs.

    Args:
      probed_history: (Q_hist, nprobe) cluster ids probed by past queries.
      smoothing: additive (Laplace) smoothing so unseen clusters keep a
        nonzero workload estimate.

    Returns:
      (n_clusters,) float64 access frequencies (mean probes per query).
    """
    counts = np.bincount(probed_history.ravel(), minlength=n_clusters)
    q = max(probed_history.shape[0], 1)
    return (counts + smoothing) / q


def _placement_pass(
    sizes: np.ndarray,
    work: np.ndarray,
    w_bar: float,
    ndev: int,
    max_dev_vectors: int,
    max_replicas: int,
    thld_rate: float,
    centroids: np.ndarray | None,
    replicas: list[list[int]],
    dev_load: np.ndarray,
    dev_vec: np.ndarray,
    dev_clusters: list[list[int]],
    placed: np.ndarray,
) -> None:
    """The Algorithm-1 placement sweep over every unplaced cluster.

    Mutates the passed-in state in place.  `place_clusters` calls it with
    empty state (the paper's offline placement); the mutation layer's
    `update_placement` calls it with the previous placement minus the
    changed clusters, so only those clusters move (incremental
    re-placement).
    """
    # nearest-neighbour cluster order for co-location
    if centroids is not None:
        cent = np.asarray(centroids, np.float64)
        d2 = (
            (cent * cent).sum(1)[:, None]
            - 2.0 * cent @ cent.T
            + (cent * cent).sum(1)[None, :]
        )
        np.fill_diagonal(d2, np.inf)
        near_order = np.argsort(d2, axis=1)  # (C, C)
    else:
        near_order = None

    def _take(ci: int, d: int, w_i: float) -> None:
        replicas[ci].append(d)
        dev_clusters[d].append(ci)
        dev_load[d] += w_i
        dev_vec[d] += int(sizes[ci])

    def _place_copies(ci: int) -> None:
        """Lines 1-9 of Algorithm 1 for cluster ci."""
        ncpy = max(1, int(np.ceil(work[ci] / max(w_bar, 1e-12))))
        ncpy = min(ncpy, max_replicas)
        w_i = work[ci] / ncpy
        thld = 1.0
        cursor = 0
        remaining = ncpy
        sweeps_left = ndev
        while remaining > 0:
            d = cursor
            ok = (
                dev_load[d] + w_i <= w_bar * thld
                and dev_vec[d] + sizes[ci] <= max_dev_vectors
                and d not in replicas[ci]  # one copy per device
            )
            if ok:
                _take(ci, d, w_i)
                remaining -= 1
                sweeps_left = ndev
            cursor = (cursor + 1) % ndev
            sweeps_left -= 1
            if sweeps_left <= 0:  # full sweep found no host: relax threshold
                if w_bar * thld >= float(dev_load.max()) + w_i:
                    # load can no longer be the binding constraint anywhere,
                    # so the sweep failed on vector capacity / duplicates —
                    # which relaxing thld can never fix (this used to spin
                    # forever when one huge cluster filled every device).
                    if replicas[ci]:
                        # shed the surplus copies; the placed replicas serve
                        # the whole cluster, so book the orphaned share too
                        dev_load[replicas[ci]] += (
                            w_i * remaining / len(replicas[ci])
                        )
                        break
                    # every cluster must land somewhere: best-effort place
                    # the mandatory copy (carrying the full cluster load)
                    # on the emptiest device
                    _take(ci, int(np.argmin(dev_vec)), w_i * remaining)
                    break
                thld += thld_rate
                sweeps_left = ndev
        placed[ci] = True

    order = np.argsort(-work, kind="stable")
    for ci in order:
        ci = int(ci)
        if placed[ci]:
            continue
        _place_copies(ci)
        # co-location: keep pulling the nearest unplaced single-copy clusters
        # onto the last device used, while it stays under W_bar (paper §4.1).
        if near_order is not None and replicas[ci]:
            d = replicas[ci][-1]
            for cj in near_order[ci]:
                cj = int(cj)
                if placed[cj]:
                    continue
                if work[cj] > w_bar:  # multi-copy clusters go through Alg 1
                    continue
                if (
                    dev_load[d] + work[cj] <= w_bar
                    and dev_vec[d] + sizes[cj] <= max_dev_vectors
                ):
                    replicas[cj].append(d)
                    dev_clusters[d].append(cj)
                    dev_load[d] += work[cj]
                    dev_vec[d] += int(sizes[cj])
                    placed[cj] = True
                else:
                    break


def place_clusters(
    sizes: np.ndarray,
    freqs: np.ndarray,
    ndev: int,
    max_dev_vectors: int | None = None,
    centroids: np.ndarray | None = None,
    thld_rate: float = 0.02,
    max_replicas: int | None = None,
) -> Placement:
    """Algorithm 1 over all clusters (ordered by workload, high to low).

    Args:
      sizes: (C,) vectors per cluster (s_i).
      freqs: (C,) access frequency per cluster (f_i).
      ndev: number of devices (the paper's ndpu).
      max_dev_vectors: per-device capacity (the paper's MAX_DPU_SIZE);
        defaults to 2x the balanced share.
      centroids: optional (C, D) coarse centroids enabling the co-location
        refinement (nearby clusters placed on the same device).
      thld_rate: relaxation step for the balance threshold (paper: 0.02).
      max_replicas: optional cap on ncpy (defaults to ndev).

    Returns:
      Placement with every cluster on >= 1 device.
    """
    sizes = np.asarray(sizes, np.float64)
    freqs = np.asarray(freqs, np.float64)
    c = sizes.shape[0]
    work = sizes * freqs
    w_bar = float(work.sum()) / ndev
    if max_dev_vectors is None:
        max_dev_vectors = int(np.ceil(2.0 * sizes.sum() / ndev)) + int(sizes.max())
    if max_replicas is None:
        max_replicas = ndev

    replicas: list[list[int]] = [[] for _ in range(c)]
    dev_load = np.zeros(ndev, np.float64)
    dev_vec = np.zeros(ndev, np.int64)
    dev_clusters: list[list[int]] = [[] for _ in range(ndev)]
    placed = np.zeros(c, bool)

    _placement_pass(
        sizes, work, w_bar, ndev, max_dev_vectors, max_replicas, thld_rate,
        centroids, replicas, dev_load, dev_vec, dev_clusters, placed,
    )
    return Placement(
        replicas=replicas,
        dev_load=dev_load,
        dev_vectors=dev_vec,
        dev_clusters=dev_clusters,
        w_bar=w_bar,
    )


def update_placement(
    base: Placement,
    sizes: np.ndarray,
    freqs: np.ndarray,
    changed: np.ndarray,
    max_dev_vectors: int | None = None,
    centroids: np.ndarray | None = None,
    thld_rate: float = 0.02,
    max_replicas: int | None = None,
) -> Placement:
    """Incremental re-placement after a compaction changed cluster sizes.

    Clusters NOT in `changed` keep their replica devices (and their order
    within each device's cluster list, so the shard packer can leave those
    device regions untouched); changed clusters are pulled out and re-placed
    by the same Algorithm-1 sweep (`_placement_pass`), greedily filling the
    devices around the retained load.  Device loads/vector counts are
    recomputed from the NEW sizes, so unchanged clusters' load contributions
    track their current replica counts exactly (each replica carries
    work/ncpy, the same accounting `place_clusters` uses).

    Args:
      base: the placement being updated.
      sizes: (C,) NEW cluster sizes.
      freqs: (C,) access frequencies (typically unchanged).
      changed: (C,) bool mask (or int id array) of clusters to re-place.

    Returns:
      A fresh Placement (base is not mutated).
    """
    sizes = np.asarray(sizes, np.float64)
    freqs = np.asarray(freqs, np.float64)
    c = sizes.shape[0]
    ndev = base.dev_load.shape[0]
    changed = np.asarray(changed)
    if changed.dtype != bool:
        mask = np.zeros(c, bool)
        mask[changed] = True
        changed = mask
    work = sizes * freqs
    w_bar = float(work.sum()) / ndev
    if max_dev_vectors is None:
        max_dev_vectors = int(np.ceil(2.0 * sizes.sum() / ndev)) + int(
            sizes.max(initial=1)
        )
    if max_replicas is None:
        max_replicas = ndev

    replicas: list[list[int]] = [
        [] if changed[ci] else list(base.replicas[ci]) for ci in range(c)
    ]
    dev_clusters: list[list[int]] = [
        [ci for ci in base.dev_clusters[d] if not changed[ci]]
        for d in range(ndev)
    ]
    dev_load = np.zeros(ndev, np.float64)
    dev_vec = np.zeros(ndev, np.int64)
    for ci in range(c):
        reps = replicas[ci]
        if not reps:
            continue
        share = work[ci] / len(reps)
        for d in reps:
            dev_load[d] += share
            dev_vec[d] += int(sizes[ci])
    placed = ~changed

    _placement_pass(
        sizes, work, w_bar, ndev, max_dev_vectors, max_replicas, thld_rate,
        centroids, replicas, dev_load, dev_vec, dev_clusters, placed,
    )
    return Placement(
        replicas=replicas,
        dev_load=dev_load,
        dev_vectors=dev_vec,
        dev_clusters=dev_clusters,
        w_bar=w_bar,
    )
