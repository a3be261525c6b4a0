"""Algorithm 2: balanced query scheduling over cluster replicas (paper §4.1).

Given a batch of queries and the nprobe clusters each one probes, assign each
(query, cluster) pair to one device holding a replica of that cluster such
that per-device scan load is balanced:

  1. pairs whose cluster has a single replica are bound first (no choice);
  2. remaining clusters are processed in descending size order, each pair
     going to its least-loaded replica device.

Both implementations accept an optional per-device `load_carry` vector (the
serving layer feeds back an EWMA of rows scanned per device), turning the
one-shot static balancer into the paper's dynamic resource manager: devices
that ran hot in recent batches start the greedy with a head start and shed
multi-replica work to colder replicas, within a batch and across batches.

Runs on the host CPU at online time.  The primary implementation
(`schedule_queries`) is numpy-vectorized: single-replica pairs are bound by
one scatter-add, and multi-replica clusters are resolved segment-by-segment
with an event-merge that reproduces the greedy least-loaded choice exactly
(the i-th greedy pick equals the i-th smallest (load + t*size, replica) key
in the merged per-replica event streams).  The original per-pair loop is
kept as `schedule_queries_loop`, the reference oracle for tests; both
implementations produce identical device loads (and identical per-pair
devices for integer sizes, where float accumulation is exact).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.placement import Placement

# conservative margins applied to the ADC distance bounds so that f32
# rounding anywhere on the device path (LUT build, gather-sum) can never
# flip a comparison: lower bounds are deflated, upper bounds inflated.
# The relative term dominates the ~(dsub + M) * 2^-24 accumulated rounding
# of the kernels by orders of magnitude; the absolute term covers values
# near zero.  Bit-identity never depends on tightness, only on direction.
#
# The margins cover co-occ re-encoded shards (§4.3) with no change: the
# flat combo scan adds the SAME M LUT entries per row, just pre-summed in
# combo groups (`build_ext_lut`) -- a reassociation of identical f32
# addends, so its rounding error has the same ~(dsub + M) * 2^-24 scale as
# the plain-order sum the margin already dominates.  Hence one set of
# bounds serves every encoding, and prune-on == prune-off stays
# bit-identical within each (tests/test_cooc_props.py pins soundness
# against the flat scan under randomly re-encoded codebooks).
_BOUND_REL = 1e-4
_BOUND_ABS = 1e-6


def subspace_code_norms(codebook: np.ndarray) -> np.ndarray:
    """(M,) largest codeword L2 norm per PQ subspace (cached per index).

    This is the only codebook statistic the ADC bounds need: with residual
    r split into subvectors r_m, every LUT entry satisfies
    ``(max(0, |r_m| - R_m))^2 <= lut[m, j] <= (|r_m| + R_m)^2`` by the
    triangle inequality, where ``R_m = max_j |cb[m, j]|``.
    """
    cb = np.asarray(codebook, np.float64)
    return np.sqrt((cb**2).sum(axis=-1)).max(axis=1)


def residual_bounds(
    qmc: np.ndarray, code_norms: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Sound per-(query, cluster) ADC distance bounds from residuals alone.

    Args:
      qmc: (Q, nprobe, D) f32 query - centroid residuals (from
        `filter_clusters` -- no extra device work).
      code_norms: (M,) per-subspace max codeword norms
        (`subspace_code_norms`).

    Returns:
      (lb, ub): two (Q, nprobe) f32 arrays with, for every row x of
      cluster c, ``lb[q, i] <= adc_dist(q, x) <= ub[q, i]`` -- including
      the f32-computed distance the kernels produce (margins above).  The
      lower bound is additionally deflated / the upper bound inflated so
      comparisons against them are STRICT with respect to the exact value,
      which is what makes bound-pruned results bit-identical (see
      kernels/adc_topk.py).
    """
    qmc = np.asarray(qmc, np.float64)
    q_n, nprobe, d = qmc.shape
    m = code_norms.shape[0]
    rn = np.sqrt(
        (qmc.reshape(q_n, nprobe, m, d // m) ** 2).sum(axis=-1)
    )  # (Q, nprobe, M) per-subspace residual norms
    lb = (np.maximum(rn - code_norms, 0.0) ** 2).sum(axis=-1)
    ub = ((rn + code_norms) ** 2).sum(axis=-1)
    lb = np.maximum(lb * (1.0 - _BOUND_REL) - _BOUND_ABS, 0.0)
    ub = ub * (1.0 + _BOUND_REL) + _BOUND_ABS
    return lb.astype(np.float32), ub.astype(np.float32)


def warm_start_bounds(
    ub: np.ndarray, probed_sizes: np.ndarray, k: int
) -> np.ndarray:
    """(Q,) strict upper bounds on each query's final k-th ADC distance.

    Sort each query's probed clusters by their distance upper bound and
    accumulate sizes until >= k rows are covered: at least k candidates
    then have distance <= that cluster's ub, so the final k-th does too.
    Queries whose probed clusters hold fewer than k rows get +inf (no
    warm start).  `ub` must come from `residual_bounds` (already strictly
    inflated), so any row above the returned bound is strictly beyond the
    k-th output lane -- the warm start can never evict a reportable row.
    """
    ub = np.asarray(ub, np.float32)
    sizes = np.asarray(probed_sizes, np.int64)
    order = np.argsort(ub, axis=1, kind="stable")
    cum = np.cumsum(np.take_along_axis(sizes, order, axis=1), axis=1)
    covered = cum >= k
    hit = covered.argmax(axis=1)  # first probe index reaching k rows
    b0 = np.take_along_axis(
        np.take_along_axis(ub, order, axis=1), hit[:, None], axis=1
    )[:, 0]
    return np.where(covered.any(axis=1), b0, np.inf).astype(np.float32)


@dataclasses.dataclass
class Schedule:
    """Loop-reference result of Algorithm 2 for one query batch.

    Attributes:
      assigned: assigned[d] = list of (query_idx, cluster_id) pairs on dev d.
      dev_load: (ndev,) scheduled scan load (sum of probed cluster sizes).
      lost: unreachable (query_idx, cluster_id) pairs — clusters whose
        every replica is on a dead device (only under `live=`; [] when
        every device is live).
    """

    assigned: list[list[tuple[int, int]]]
    dev_load: np.ndarray
    lost: list[tuple[int, int]] = dataclasses.field(default_factory=list)

    def max_imbalance(self) -> float:
        mean = float(self.dev_load.mean())
        return float(self.dev_load.max()) / max(mean, 1e-12)

    def num_pairs(self) -> int:
        return sum(len(a) for a in self.assigned)


@dataclasses.dataclass
class ArraySchedule:
    """Vectorized result of Algorithm 2: flat per-pair arrays.

    Pairs appear in canonical order (single-replica pairs in query-major
    order first, then multi-replica pairs in descending-size processing
    order), so a stable sort by `pair_dev` reproduces the reference
    per-device assignment lists.

    Attributes:
      pair_q: (N,) int32 query index of each (query, cluster) pair.
      pair_c: (N,) int32 cluster id of each pair.
      pair_dev: (N,) int32 device chosen by Algorithm 2.
      dev_load: (ndev,) float64 scheduled scan load per device.
      lost_q: (L,) int32 query index of each unreachable pair — a probed
        cluster whose every replica sits on a dead device.  None when the
        schedule ran without a live mask; empty under `live=` when every
        probed cluster kept a surviving replica.
      lost_c: (L,) int32 cluster id of each unreachable pair.
    """

    pair_q: np.ndarray
    pair_c: np.ndarray
    pair_dev: np.ndarray
    dev_load: np.ndarray
    lost_q: np.ndarray | None = None
    lost_c: np.ndarray | None = None

    @property
    def ndev(self) -> int:
        return self.dev_load.shape[0]

    def max_imbalance(self) -> float:
        mean = float(self.dev_load.mean())
        return float(self.dev_load.max()) / max(mean, 1e-12)

    def num_pairs(self) -> int:
        return int(self.pair_q.shape[0])

    def counts_per_dev(self) -> np.ndarray:
        """(ndev,) number of pairs scheduled onto each device."""
        return np.bincount(self.pair_dev, minlength=self.ndev)

    def device_order(self) -> np.ndarray:
        """Stable pair permutation grouping pairs by device."""
        return np.argsort(self.pair_dev, kind="stable")

    def device_positions(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense packing coordinates for every pair.

        Returns:
          (order (N,) pair permutation grouped by device, d_sorted (N,)
           device of each permuted pair, pos (N,) its slot index within
           that device's pair list).
        """
        order = self.device_order()
        d_sorted = self.pair_dev[order]
        counts = self.counts_per_dev()
        offsets = np.zeros(self.ndev, np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        pos = np.arange(order.shape[0], dtype=np.int64) - offsets[d_sorted]
        return order, d_sorted, pos

    @property
    def assigned(self) -> list[list[tuple[int, int]]]:
        """Reference-compatible per-device pair lists (materialized)."""
        out: list[list[tuple[int, int]]] = [[] for _ in range(self.ndev)]
        for i in self.device_order():
            out[int(self.pair_dev[i])].append(
                (int(self.pair_q[i]), int(self.pair_c[i]))
            )
        return out


def _greedy_segment_picks(
    loads: np.ndarray, size: float, k: int
) -> np.ndarray:
    """Replica positions chosen by k greedy least-loaded steps, vectorized.

    Greedy repeatedly assigns one size-`size` item to the replica with the
    smallest current load (first index wins ties).  Because each replica's
    load sequence load + t*size is strictly increasing (size > 0), the k
    greedy picks are exactly the k lexicographically-smallest
    (load + t*size, replica) events of the merged streams.
    """
    r = loads.shape[0]
    vals = loads[:, None] + size * np.arange(k, dtype=np.float64)[None, :]
    rpos = np.broadcast_to(np.arange(r)[:, None], vals.shape)
    sel = np.lexsort((rpos.ravel(), vals.ravel()))[:k]
    return rpos.ravel()[sel]


def _live_replica_table(
    table: np.ndarray, live: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Restrict a replica table to live devices.

    Compacts each cluster's surviving replicas to the leading columns
    (stable, so the placement's replica order is preserved — with all
    devices live the table is returned unchanged) and recounts them.
    Clusters whose count drops to zero are unreachable.
    """
    rep_live = (table >= 0) & live[np.clip(table, 0, None)]
    order = np.argsort(~rep_live, axis=1, kind="stable")
    return (
        np.take_along_axis(table, order, axis=1),
        rep_live.sum(axis=1).astype(np.int64),
    )


def schedule_queries(
    probed: np.ndarray,
    sizes: np.ndarray,
    placement: Placement,
    load_carry: np.ndarray | None = None,
    live: np.ndarray | None = None,
) -> ArraySchedule:
    """Vectorized Algorithm 2, optionally biased by carried device load.

    Args:
      probed: (Q, nprobe) int cluster ids selected by cluster filtering.
      sizes: (C,) cluster sizes s_i.
      placement: Algorithm 1 output (replica map).
      load_carry: optional (ndev,) non-negative load each device already
        carries (e.g. an EWMA of rows scanned by in-flight batches).  Greedy
        loads start from the carry instead of zero, so a hot device sheds
        multi-replica pairs to colder replicas; single-replica pairs stay
        forced but stack on top of the carry, biasing every later greedy
        choice.  `None` or all-zeros reproduces the unbiased schedule
        exactly.  The returned `dev_load` excludes the carry (it is this
        batch's scan load only).
      live: optional (ndev,) bool live-device mask (replica failover).
        Pairs whose cluster has replicas on dead devices re-route to the
        surviving replicas — Algorithm 1's hot-cluster replication doubles
        as fault redundancy; a cluster with exactly one survivor becomes
        forced.  Pairs with NO surviving replica are reported in
        `lost_q`/`lost_c` instead of being scheduled (the serving layer
        turns them into per-query degraded flags).  `None` means all live
        and reproduces today's schedule bit-for-bit with `lost_q` = None.

    Returns:
      ArraySchedule covering every reachable (query, cluster) pair
      exactly once.
    """
    ndev = placement.dev_load.shape[0]
    q_n, nprobe = probed.shape
    sizes = np.asarray(sizes, np.float64)
    table, n_rep = placement.replica_table()

    pair_q = np.repeat(np.arange(q_n, dtype=np.int32), nprobe)
    pair_c = np.ascontiguousarray(probed, np.int32).reshape(-1)
    lost_q = lost_c = None
    if live is not None:
        live = np.asarray(live, bool)
        if live.shape != (ndev,):
            raise ValueError(f"live shape {live.shape} != ({ndev},)")
        table, n_rep = _live_replica_table(table, live)
        lost = n_rep[pair_c] == 0
        lost_q, lost_c = pair_q[lost], pair_c[lost]
        if lost.any():
            keep = ~lost
            pair_q, pair_c = pair_q[keep], pair_c[keep]
    if load_carry is None:
        load = np.zeros(ndev, np.float64)
    else:
        load = np.array(load_carry, np.float64, copy=True)
        if load.shape != (ndev,):
            raise ValueError(
                f"load_carry shape {load.shape} != ({ndev},)"
            )
    carry = load.copy()

    # Lines 4-7: single-replica pairs -> forced device, one scatter-add
    single = n_rep[pair_c] == 1
    dev = np.empty(pair_q.shape[0], np.int32)
    dev[single] = table[pair_c[single], 0]
    np.add.at(load, dev[single], sizes[pair_c[single]])

    # Lines 8-14: multi-replica pairs, descending cluster size.  The sort is
    # stable with key (-size, cluster), so each cluster forms one contiguous
    # segment holding its pairs in query order.
    multi = np.flatnonzero(~single)
    if multi.size:
        mc = pair_c[multi]
        order = np.lexsort((mc, -sizes[mc]))
        multi, mc = multi[order], mc[order]
        seg_starts = np.flatnonzero(np.r_[True, mc[1:] != mc[:-1]])
        seg_ends = np.r_[seg_starts[1:], mc.size]
        for s0, s1 in zip(seg_starts, seg_ends):
            c = int(mc[s0])
            reps = table[c, : n_rep[c]]
            s = float(sizes[c])
            k = int(s1 - s0)
            if s <= 0.0:  # zero-size cluster: load never moves, first min wins
                dev[multi[s0:s1]] = reps[int(np.argmin(load[reps]))]
                continue
            picks = _greedy_segment_picks(load[reps], s, k)
            dev[multi[s0:s1]] = reps[picks]
            load[reps] += np.bincount(picks, minlength=reps.shape[0]) * s

    # canonical pair order: singles (query-major) then multi (processing order)
    perm = np.r_[np.flatnonzero(single), multi].astype(np.int64)
    return ArraySchedule(
        pair_q=pair_q[perm],
        pair_c=pair_c[perm],
        pair_dev=dev[perm],
        dev_load=load - carry,
        lost_q=lost_q,
        lost_c=lost_c,
    )


def schedule_queries_loop(
    probed: np.ndarray,
    sizes: np.ndarray,
    placement: Placement,
    load_carry: np.ndarray | None = None,
    live: np.ndarray | None = None,
) -> Schedule:
    """Reference per-pair loop implementation of Algorithm 2 (test oracle).

    Complexity O(|Q| * nprobe * max_replicas); retained only to validate the
    vectorized path and to quantify its speedup in benchmarks.  `load_carry`
    and `live` have the same meaning as in `schedule_queries` and the two
    stay in lockstep: same carry, same live mask, same schedule (and the
    same `lost` pair set).
    """
    ndev = placement.dev_load.shape[0]
    q_n, nprobe = probed.shape
    sizes = np.asarray(sizes, np.float64)
    if live is not None:
        live = np.asarray(live, bool)
        if live.shape != (ndev,):
            raise ValueError(f"live shape {live.shape} != ({ndev},)")
    assigned: list[list[tuple[int, int]]] = [[] for _ in range(ndev)]
    lost: list[tuple[int, int]] = []
    if load_carry is None:
        load = np.zeros(ndev, np.float64)
    else:
        load = np.array(load_carry, np.float64, copy=True)
        if load.shape != (ndev,):  # same contract as the vectorized path
            raise ValueError(
                f"load_carry shape {load.shape} != ({ndev},)"
            )
    carry = load.copy()

    def live_replicas(c: int) -> list[int]:
        reps = placement.replicas[c]
        if live is None:
            return list(reps)
        return [d for d in reps if live[d]]  # placement order preserved

    multi: list[tuple[int, int]] = []  # (query, cluster) with >1 live replica
    for qi in range(q_n):
        for c in probed[qi]:
            c = int(c)
            reps = live_replicas(c)
            if not reps:  # every replica dead: honest loss, not a crash
                lost.append((qi, c))
            elif len(reps) == 1:  # Lines 4-7: forced assignment
                d = reps[0]
                assigned[d].append((qi, c))
                load[d] += sizes[c]
            else:
                multi.append((qi, c))

    # Lines 8-14: descending cluster size, least-loaded replica wins.  Ties
    # in size break by cluster id so the order matches the vectorized
    # segment processing (the paper leaves tie order unspecified).
    multi.sort(key=lambda qc: (-sizes[qc[1]], qc[1]))
    for qi, c in multi:
        reps = live_replicas(c)
        d = min(reps, key=lambda r: load[r] + sizes[c])
        assigned[d].append((qi, c))
        load[d] += sizes[c]

    return Schedule(assigned=assigned, dev_load=load - carry, lost=lost)


def densify_schedule(
    schedule: ArraySchedule,
    local_slot: np.ndarray,
    pairs_per_dev: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized densify: pack an ArraySchedule into shard_map inputs.

    Args:
      local_slot: (ndev, C) int32 dense lookup, local_slot[d, c] = slot of
        cluster c on device d (-1 when absent; never indexed for scheduled
        pairs since Algorithm 2 only uses replica devices).
      pairs_per_dev: fixed per-device pair capacity (padded tail invalid).

    Returns:
      (q_idx (ndev, P), slot_idx (ndev, P), valid (ndev, P)) int32/bool.
    """
    ndev = schedule.ndev
    counts = schedule.counts_per_dev()
    over = int(counts.max(initial=0))
    if over > pairs_per_dev:
        d_bad = int(counts.argmax())
        raise ValueError(
            f"device {d_bad} got {over} pairs > capacity {pairs_per_dev}"
        )
    order, d_sorted, pos = schedule.device_positions()

    q_idx = np.zeros((ndev, pairs_per_dev), np.int32)
    s_idx = np.zeros((ndev, pairs_per_dev), np.int32)
    valid = np.zeros((ndev, pairs_per_dev), bool)
    q_idx[d_sorted, pos] = schedule.pair_q[order]
    s_idx[d_sorted, pos] = local_slot[d_sorted, schedule.pair_c[order]]
    valid[d_sorted, pos] = True
    return q_idx, s_idx, valid


def count_tiles(
    pair_valid: np.ndarray,
    n_valid: np.ndarray,
    block_n: int,
) -> np.ndarray:
    """(ndev,) number of real code tiles implied by a densified schedule.

    Args:
      pair_valid: (ndev, P) bool from `densify_schedule`.
      n_valid: (ndev, P) int valid rows of each pair's cluster slot.
      block_n: kernel tile height (rows per grid step).
    """
    nv = np.where(pair_valid, n_valid, 0)
    return ((nv + block_n - 1) // block_n).sum(axis=1)


def emit_tiles(
    pair_slot: np.ndarray,
    pair_valid: np.ndarray,
    slot_start: np.ndarray,
    slot_size: np.ndarray,
    block_n: int,
    tiles_per_dev: int,
    pair_key: np.ndarray | None = None,
    live: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized tile emission: expand scheduled pairs to a flat work queue.

    Each valid (query, cluster) pair expands to ceil(slot_size / block_n)
    tiles; the per-device tile lists are padded to `tiles_per_dev` with
    dummy tiles whose pair id is P (== pairs_per_dev) -- the tiles kernel
    appends a zero table row and a zero n_valid entry at index P, so dummy
    tiles always prune away.  Within a pair, tiles appear in ascending row
    order, so the kernel's running merge visits exactly the same tile
    sequence as the padded-window path (bit-identical results).

    Args:
      pair_slot: (ndev, P) int32 local cluster slot of each pair.
      pair_valid: (ndev, P) bool, False on densify padding.
      slot_start: (ndev, S) int32 block-aligned slot row starts.
      slot_size: (ndev, S) int32 valid rows per slot.
      block_n: kernel tile height (rows per grid step).
      tiles_per_dev: fixed per-device tile capacity (padded tail dummy).
      pair_key: optional (ndev, P) sort key -- when given, each device's
        pair runs are emitted in ascending key order (stable, ties by pair
        slot) instead of slot order.  The early-pruning path passes the
        per-pair distance lower bounds here so each query's most promising
        clusters are scanned first and the kernel's running k-th bound
        tightens within the first few tiles (best-first scheduling).
        Whole runs are permuted -- tiles within a pair stay contiguous and
        ascending -- so the per-pair merge sequence (and with it every
        tie-break) is unchanged and results stay bit-identical.
      live: optional (ndev,) bool live-device mask (failover guard): a
        dead device emits only dummy tiles, even if stale pairs are still
        marked valid on it.  The failover scheduler already routes around
        dead devices, so this is defense in depth — the mesh keeps its
        full shape (a dead device just receives all-dummy work), which is
        what keeps compiled shapes, and `compiles == 0`, intact.

    Returns:
      (tile_pair (ndev, T), tile_block (ndev, T), tile_row0 (ndev, T))
      int32 arrays: owning pair id, device code-block index, and the
      window-relative row of the tile's first code row (block_n-aligned).
    """
    ndev, p_cap = pair_slot.shape
    if live is not None:
        live = np.asarray(live, bool)
        if live.shape != (ndev,):
            raise ValueError(f"live shape {live.shape} != ({ndev},)")
        pair_valid = pair_valid & live[:, None]
    nv = np.where(
        pair_valid, np.take_along_axis(slot_size, pair_slot, axis=1), 0
    )
    ntiles = (nv + block_n - 1) // block_n          # (ndev, P)
    totals = ntiles.sum(axis=1)
    over = int(totals.max(initial=0))
    if over > tiles_per_dev:
        d_bad = int(totals.argmax())
        raise ValueError(
            f"device {d_bad} emits {over} tiles > capacity {tiles_per_dev}"
        )

    tile_pair = np.full((ndev, tiles_per_dev), p_cap, np.int32)
    tile_block = np.zeros((ndev, tiles_per_dev), np.int32)
    tile_row0 = np.zeros((ndev, tiles_per_dev), np.int32)
    if pair_key is not None:
        perm = np.argsort(pair_key, axis=1, kind="stable").astype(np.int64)
        ntiles = np.take_along_axis(ntiles, perm, axis=1)
    else:
        perm = None
    counts = ntiles.ravel()
    if counts.sum() == 0:
        return tile_pair, tile_block, tile_row0

    # one np.repeat expands every (device, rank) to its tile run; local tile
    # index = position minus the run start, device slot = position minus the
    # device's first run start
    rep = np.repeat(np.arange(ndev * p_cap, dtype=np.int64), counts)
    run_end = np.cumsum(counts)
    run_start = np.repeat(run_end - counts, counts)
    local_t = (np.arange(rep.shape[0], dtype=np.int64) - run_start).astype(
        np.int32
    )
    rep_dev = (rep // p_cap).astype(np.int64)
    rep_rank = rep % p_cap
    rep_pair = (
        perm[rep_dev, rep_rank] if perm is not None else rep_rank
    ).astype(np.int32)
    dev_start = np.zeros(ndev, np.int64)
    np.cumsum(totals[:-1], out=dev_start[1:])
    pos = np.arange(rep.shape[0], dtype=np.int64) - dev_start[rep_dev]

    start_rows = np.take_along_axis(slot_start, pair_slot, axis=1)
    tile_pair[rep_dev, pos] = rep_pair
    tile_block[rep_dev, pos] = (
        start_rows[rep_dev, rep_pair] // block_n + local_t
    )
    tile_row0[rep_dev, pos] = local_t * block_n
    return tile_pair, tile_block, tile_row0


def schedule_to_arrays(
    schedule: Schedule,
    local_slot: np.ndarray,
    pairs_per_dev: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Loop-reference densify of a (loop) Schedule (test oracle).

    Args:
      local_slot: (ndev, C) int32 dense (device, cluster) -> slot lookup
        (from the retrieval shard layout).
      pairs_per_dev: fixed per-device pair capacity (padded tail invalid).

    Returns:
      (q_idx (ndev, P), slot_idx (ndev, P), valid (ndev, P)) int32/bool.
    """
    ndev = len(schedule.assigned)
    q_idx = np.full((ndev, pairs_per_dev), 0, np.int32)
    s_idx = np.full((ndev, pairs_per_dev), 0, np.int32)
    valid = np.zeros((ndev, pairs_per_dev), bool)
    for d, pairs in enumerate(schedule.assigned):
        if len(pairs) > pairs_per_dev:
            raise ValueError(
                f"device {d} got {len(pairs)} pairs > capacity {pairs_per_dev}"
            )
        for p, (qi, c) in enumerate(pairs):
            q_idx[d, p] = qi
            s_idx[d, p] = local_slot[d, c]
            valid[d, p] = True
    return q_idx, s_idx, valid
