"""The port's mutation layer at index level against the reference, exactly.

The same numpy inputs, drawn from a seed, go through the reference's
`repro.core.delta` / `update_placement` / `update_shards` /
`update_raw_store` and the port's: the delta buffer (insert, delete, grow,
reset), `merge_results`, `compact_index` with its `CompactionDelta`,
`update_placement` and the shard repacks (plain and co-occurrence, ndev 1
and 8) must be `array_equal`; the raw store must hold the same rows under
the same ids.  The delta scan (`delta_topk`: B1 + B5 over the
cluster-sorted view, their plain versions here) equals the reference's
(ids outside exact ties, distances allclose rtol = atol = 1e-5) and its own
plain formula `delta_topk_plain` bit for bit, bounded and unbounded.  The
hypothesis twins of `tests/test_mutation_props.py` hold compaction to a
scratch re-encode and the merged results free of tombstones, with k at or
below the smallest probed cluster (ROADMAP C1).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _one_thread import one_thread  # noqa: E402,F401
from repro.core import delta as rdelta  # noqa: E402
from repro.core import placement as rplace  # noqa: E402
from repro.core.index import build_index as ref_build_index  # noqa: E402
from repro.retrieval import layout as rlayout  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import delta as tdelta  # noqa: E402
from repro_torch.core import placement as tplace  # noqa: E402
from repro_torch.core.index import encode_index, search as port_flat_search  # noqa: E402
from repro_torch.retrieval import layout as tlayout  # noqa: E402

N0, DIM, C, M = 600, 16, 8, 4
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"


@functools.lru_cache(maxsize=1)
def _base():
    """A tiny trained reference index, its port twin, the corpus, centres."""
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 5, (C, DIM)).astype(np.float32)
    xs = centers[rng.integers(0, C, N0)] + rng.normal(0, 1, (N0, DIM)).astype(np.float32)
    ref = ref_build_index(jax.random.PRNGKey(0), xs, C, M, kmeans_iters=4, pq_iters=3)
    port = convert.index_from_arrays(ref.centroids, ref.codebook, ref.codes, ref.vec_ids,
                                     ref.offsets)
    return ref, port, xs, centers


def _draw(seed, n_ins, dim=DIM, centers=None):
    rng = np.random.default_rng(seed)
    centers = _base()[3] if centers is None else centers
    return rng, (centers[rng.integers(0, len(centers), n_ins)]
                 + rng.normal(0, 1, (n_ins, dim))).astype(np.float32)


def _same_delta(r, t):
    for f in ("codes", "assign", "vec_ids", "dead", "vectors"):
        np.testing.assert_array_equal(getattr(r, f), getattr(t, f), err_msg=f)
    assert (r.n, r.capacity, r.tombstones) == (t.n, t.capacity, t.tombstones)
    np.testing.assert_array_equal(r.live_mask(), t.live_mask())
    np.testing.assert_array_equal(r.tombstone_array(), t.tombstone_array())
    assert (r.live_count, r.active, r.occupancy) == (t.live_count, t.active, t.occupancy)


def _mutated(seed, n_ins=40, n_del=20, batches=2, capacity=64):
    """The same insert / delete stream through both buffers."""
    ref, port, _, _ = _base()
    rd, td = rdelta.DeltaIndex.create(M, capacity), tdelta.DeltaIndex.create(M, capacity)
    rng, vecs = _draw(seed, n_ins)
    ids = np.arange(N0, N0 + n_ins, dtype=np.int32)
    for part in np.array_split(np.arange(n_ins), batches):
        rd.insert(ref.centroids, ref.codebook, ids[part], vecs[part])
        td.insert(port.centroids, port.codebook, ids[part], vecs[part], device=CPU)
    victims = rng.choice(N0 + n_ins, n_del, replace=False)
    assert rd.delete(victims) == td.delete(victims)
    return rd, td, ids, vecs, victims


@pytest.mark.parametrize("seed,n_ins,batches", [(0, 40, 2), (1, 100, 3), (2, 5, 1)])
def test_delta_buffer_matches_reference(seed, n_ins, batches):
    """insert (with pow2 growth past 64 rows), delete, reset: equal arrays."""
    rd, td, ids, vecs, _ = _mutated(seed, n_ins=n_ins, batches=batches)
    _same_delta(rd, td)
    assert td.capacity == (128 if n_ins > 64 else 64)
    v0 = td.version
    rd.reset()
    td.reset()
    _same_delta(rd, td)
    assert td.version > v0 and not td.active
    ref, port, _, _ = _base()
    rd.insert(ref.centroids, ref.codebook, ids[:3], vecs[:3])
    td.insert(port.centroids, port.codebook, ids[:3], vecs[:3], device=CPU)
    _same_delta(rd, td)


def test_reinsert_of_tombstoned_id_rejected_at_index_level():
    """A tombstoned id is refused; an insert under an OPQ rotation (queue A
    item 11) encodes the rotated vectors and keeps the raw copy unrotated,
    as the reference's does (a permutation rotation: exact in f32, so the
    two buffers agree bit for bit)."""
    ref, port, xs, _ = _base()
    td = tdelta.DeltaIndex.create(M, 64)
    td.delete(np.asarray([3]))
    with pytest.raises(ValueError, match="tombstoned"):
        td.insert(port.centroids, port.codebook, np.asarray([3]), np.zeros((1, DIM)),
                  device=CPU)
    rot = np.eye(DIM, dtype=np.float32)[::-1].copy()
    rd = rdelta.DeltaIndex.create(M, 64)
    rd.delete(np.asarray([3]))
    for d, idx, kw in ((rd, ref, {}), (td, port, {"device": CPU})):
        d.insert(idx.centroids @ rot, idx.codebook, np.asarray([4, 5]), xs[:2],
                 rotation=rot, **kw)
    _same_delta(rd, td)
    np.testing.assert_array_equal(td.vectors[:2], xs[:2])


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("bounded", [False, True])
def test_delta_topk_matches_reference_and_plain(k, bounded):
    ref, port, _, _ = _base()
    rd, td, _, _, _ = _mutated(3, n_ins=60, n_del=25)
    rng, qs = _draw(9, 6)
    bound = None
    if bounded:  # halfway between two rows' distances: no row sits on it
        u, _ = rdelta.delta_topk(rd, ref.centroids, ref.codebook, qs, 4, 64)
        j = max(0, k // 2 - 1)
        bound = ((u[:, j] + u[:, j + 1]) / 2).astype(np.float32)
        bound[1] = np.inf
    r_d, r_i = rdelta.delta_topk(rd, ref.centroids, ref.codebook, qs, 4, k, bound=bound)
    t_d, t_i = tdelta.delta_topk(td, port.centroids, port.codebook, qs, 4, k, bound=bound,
                                 device=CPU)
    p_d, p_i = tdelta.delta_topk_plain(td, port.centroids, port.codebook, qs, 4, k,
                                       bound=bound, device=CPU)
    assert t_d.shape == (6, k) and t_i.dtype == np.int32
    np.testing.assert_array_equal(t_d, p_d)
    np.testing.assert_array_equal(t_i, p_i)
    np.testing.assert_allclose(t_d, r_d, **TOL)
    fin = np.isfinite(r_d)
    np.testing.assert_array_equal(np.isfinite(t_d), fin)
    np.testing.assert_array_equal(np.where(fin, t_i, -1), np.where(fin, r_i, -1))
    if k > td.live_count:  # k past the live rows: (+inf, -1) padding
        assert (t_i == -1).any()
    with pytest.raises(ValueError, match="capacity"):
        tdelta.delta_topk(td, port.centroids, port.codebook, qs, 4, 128, device=CPU)


def test_delta_view_layout():
    """The view: live rows sorted by cluster, insertion order within one,
    each run block-aligned; rebuilt only when the buffer changes."""
    _, port, _, _ = _base()
    _, td, _, _, _ = _mutated(4, n_ins=50, n_del=30)
    v = td.view(C, torch.device(CPU), block_n=8)
    assert v is td.view(C, torch.device(CPU), block_n=8)
    live = np.flatnonzero(td.live_mask())
    want = live[np.argsort(td.assign[live], kind="stable")]
    buf = v.buf_row.numpy()
    np.testing.assert_array_equal(buf[buf >= 0], want)
    assert (v.starts.numpy() % 8 == 0).all()
    for c in range(C):
        s, n = int(v.starts[c]), int(v.counts[c])
        assert (td.assign[buf[s : s + n]] == c).all()
        np.testing.assert_array_equal(v.codes[0, s : s + n].numpy(), td.codes[buf[s : s + n]])
    td.delete(np.asarray([int(td.vec_ids[want[0]])]))
    assert td.view(C, torch.device(CPU), block_n=8) is not v


def test_delta_exact_rerank_matches_reference():
    """The delta's exact re-rank (`mutation.rerank_rows`: B3 over its
    vectors as a one-device store, candidates as buffer rows, as the
    mutable search runs it) against the reference's `delta_exact_rerank`
    on the same candidates (some -1): the same order, distances
    allclose."""
    from repro.retrieval import mutation as rmut
    from repro_torch.retrieval import mutation as tmut

    _, port, _, _ = _base()
    rd, td, _, _, _ = _mutated(8, n_ins=50, n_del=30)
    _, qs = _draw(11, 5)
    _, rows = tdelta.delta_topk_rows(td, port.centroids, port.codebook, qs, 4, 16, device=CPU)
    rows[:, -1] = -1
    ids = td.ids_of(rows).numpy()
    d, r = tmut.rerank_rows(td, torch.as_tensor(qs), rows)
    want = rmut.delta_exact_rerank(rd, qs, np.zeros(ids.shape, np.float32), ids)
    np.testing.assert_allclose(d.numpy(), want[0], **TOL)
    np.testing.assert_array_equal(td.ids_of(r).numpy(), want[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_results_matches_reference(seed):
    rng = np.random.default_rng(seed)
    q, kf, kd, k = 5, 12, 7, 6
    main_d = np.sort(rng.integers(0, 20, (q, kf)).astype(np.float32), axis=1)
    main_i = rng.permutation(200)[: q * kf].reshape(q, kf).astype(np.int64)
    delta_d = np.sort(rng.integers(0, 20, (q, kd)).astype(np.float32), axis=1)
    delta_i = (1000 + np.arange(q * kd).reshape(q, kd)).astype(np.int32)
    tomb = np.sort(rng.choice(200, 40, replace=False)).astype(np.int64)
    for args in ((delta_d, delta_i, tomb), (None, None, tomb),
                 (delta_d, delta_i, np.zeros(0, np.int64))):
        r = rdelta.merge_results(main_d, main_i, *args, k)
        t = tdelta.merge_results(main_d, main_i, *args, k)
        np.testing.assert_array_equal(r[0], t[0])
        np.testing.assert_array_equal(r[1], t[1])


@pytest.mark.parametrize("seed,n_del", [(0, 20), (5, 0), (6, 90)])
def test_compact_index_matches_reference(seed, n_del):
    ref, port, _, _ = _base()
    rd, td, _, _, _ = _mutated(seed, n_ins=70, n_del=n_del, batches=2, capacity=64)
    r_idx, r_info = rdelta.compact_index(ref, rd)
    t_idx, t_info = tdelta.compact_index(port, td)
    for f in ("codes", "vec_ids", "offsets", "centroids", "codebook"):
        np.testing.assert_array_equal(getattr(r_idx, f), getattr(t_idx, f), err_msg=f)
    for f in ("old_sizes", "new_sizes", "content_changed"):
        np.testing.assert_array_equal(getattr(r_info, f), getattr(t_info, f), err_msg=f)
    assert (r_info.merged, r_info.dropped) == (t_info.merged, t_info.dropped)


def _sizes_freqs(seed, c=40):
    rng = np.random.default_rng(seed)
    sizes = (400 / np.arange(1, c + 1) ** 1.1).astype(np.float64)
    rng.shuffle(sizes)
    return sizes, rng.random(c) ** 3 + 0.01, rng.normal(0, 5, (c, 8)).astype(np.float32)


@pytest.mark.parametrize("ndev", [1, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_placement_matches_reference(ndev, seed):
    sizes, freqs, cent = _sizes_freqs(seed)
    base_r = rplace.place_clusters(sizes, freqs, ndev, centroids=cent)
    base_t = tplace.place_clusters(sizes, freqs, ndev, centroids=cent)
    rng = np.random.default_rng(seed + 10)
    new = sizes * rng.uniform(0.3, 2.5, sizes.shape)
    changed = rng.random(sizes.shape) < 0.3
    for ch in (changed, np.flatnonzero(changed)):  # a mask or an id array
        r = rplace.update_placement(base_r, new, freqs, ch, centroids=cent)
        t = tplace.update_placement(base_t, new, freqs, ch, centroids=cent)
        assert r.replicas == t.replicas and r.dev_clusters == t.dev_clusters
        np.testing.assert_array_equal(r.dev_load, t.dev_load)
        np.testing.assert_array_equal(r.dev_vectors, t.dev_vectors)
        assert r.w_bar == t.w_bar


@pytest.fixture(scope="module")
def shard_case(clustered_data):
    """A trained reference index on the shared corpus, a mutation stream,
    and its compaction (through the reference), for the shard repacks."""
    xs, centers, _, _ = clustered_data
    ref = ref_build_index(jax.random.PRNGKey(0), xs, 32, 8, kmeans_iters=6, pq_iters=4)
    port = convert.index_from_arrays(ref.centroids, ref.codebook, ref.codes, ref.vec_ids,
                                     ref.offsets)
    rng = np.random.default_rng(3)
    n0 = xs.shape[0]
    ins = (centers[rng.integers(0, 32, 400)] + rng.normal(0, 1, (400, 32))).astype(np.float32)
    rd = rdelta.DeltaIndex.create(8, 512)
    rd.insert(ref.centroids, ref.codebook, np.arange(n0, n0 + 400), ins)
    rd.delete(np.concatenate([rng.choice(n0, 300, replace=False), [n0 + 1, n0 + 5]]))
    new_ref, info = rdelta.compact_index(ref, rd)
    new_port = convert.index_from_arrays(new_ref.centroids, new_ref.codebook, new_ref.codes,
                                         new_ref.vec_ids, new_ref.offsets)
    return ref, port, new_ref, new_port, info, rd, xs, ins


def _compare_shards(r, t):
    for f in ("codes", "vec_ids", "slot_start", "slot_size", "slot_cluster", "local_slot",
              "combo_addrs"):
        a, b = getattr(r, f), getattr(t, f)
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (r.window, r.block_n, r.n_combos, r.add_offsets, r.width) == (
        t.window, t.block_n, t.n_combos, t.add_offsets, t.width)


@pytest.mark.parametrize("ndev", [1, 8])
@pytest.mark.parametrize("cooc", [False, True])
@pytest.mark.parametrize("slack", [True, False])
def test_update_shards_matches_reference(shard_case, ndev, cooc, slack):
    """After a compaction and an incremental re-placement (threshold 0.1,
    so some clusters move), the repacked shards equal the reference's."""
    ref, port, new_ref, new_port, info, _, _, _ = shard_case
    freqs = np.random.default_rng(ndev).random(32) + 0.05
    sizes = ref.cluster_sizes().astype(np.float64)
    rp = rplace.place_clusters(sizes, freqs, ndev, centroids=ref.centroids)
    tp = tplace.place_clusters(sizes, freqs, ndev, centroids=ref.centroids)
    kw = dict(block_n=256, use_cooc=cooc, n_combos=32)
    if slack:
        cap, slot, win = tlayout.default_slack(256, True)
        kw.update(cap_slack=cap, slot_slack=slot, window_slack=win)
    r_old = rlayout.build_shards(ref, rp, **kw)
    t_old = tlayout.build_shards(port, tp, device=CPU, **kw)
    _compare_shards(r_old, t_old)
    grew = np.abs(info.new_sizes - info.old_sizes)
    replace = info.content_changed & (grew > 0.1 * np.maximum(info.old_sizes, 1))
    new_sizes = new_ref.cluster_sizes().astype(np.float64)
    rp2 = rplace.update_placement(rp, new_sizes, freqs, replace, centroids=ref.centroids)
    tp2 = tplace.update_placement(tp, new_sizes, freqs, replace, centroids=ref.centroids)
    r_new, r_aff = rlayout.update_shards(new_ref, rp2, r_old, info.content_changed)
    t_new, t_aff = tlayout.update_shards(new_port, tp2, t_old, info.content_changed,
                                         device=CPU)
    np.testing.assert_array_equal(r_aff, t_aff)
    _compare_shards(r_new, t_new)


@pytest.mark.parametrize("ndev", [1, 8])
@pytest.mark.parametrize("grow", [False, True])
def test_update_raw_store_same_rows(shard_case, ndev, grow):
    """The same rows under the same ids as the reference's store, whether
    the slack absorbs the appends or a shard must grow (shapes_changed)."""
    ref, port, new_ref, _, _, rd, xs, ins = shard_case
    freqs = np.ones(32) / 32
    sizes = ref.cluster_sizes().astype(np.float64)
    rp = rplace.place_clusters(sizes, freqs, ndev, centroids=ref.centroids)
    tp = tplace.place_clusters(sizes, freqs, ndev, centroids=ref.centroids)
    slack = 0.0 if grow else 0.5
    r = rlayout.build_raw_store(ref, rp, xs, cap_slack=slack)
    t = tlayout.build_raw_store(port, tp, xs, cap_slack=slack, device=CPU)
    live = rd.live_mask()[: rd.n]
    add_ids = rd.vec_ids[: rd.n][live].astype(np.int64)
    add_vecs = rd.vectors[: rd.n][live]
    tomb = rd.tombstone_array()
    r, r_changed = rlayout.update_raw_store(r, add_ids, add_vecs, tomb)
    home = np.array([x[0] for x in tp.replicas])[rd.assign[: rd.n][live]]
    t, t_changed = tlayout.update_raw_store(t, add_ids, add_vecs, tomb, add_home=home)
    assert t_changed == grow
    mapped_r = np.flatnonzero(r.id_dev >= 0)
    mapped_t = np.flatnonzero(t.id_dev.numpy() >= 0)
    np.testing.assert_array_equal(mapped_r, mapped_t)
    np.testing.assert_array_equal(mapped_t, np.sort(new_ref.vec_ids))
    rows_r = r.vectors[r.id_dev[mapped_r], r.id_row[mapped_r]]
    ids_t = torch.as_tensor(mapped_t)
    rows_t = t.vectors[t.row_base[t.id_dev[ids_t].long()] + t.id_row[ids_t].long()]
    np.testing.assert_array_equal(rows_r, rows_t.numpy())
    assert (t.used <= t.capacity).all()


def test_reserve_raw_store_keeps_rows(shard_case):
    ref, port, _, _, _, _, xs, _ = shard_case
    tp = tplace.place_clusters(ref.cluster_sizes().astype(np.float64), np.ones(32), 4)
    t = tlayout.build_raw_store(port, tp, xs, device=CPU)
    s = tlayout.reserve_raw_store(t, 0.5)
    np.testing.assert_array_equal(s.capacity, np.ceil(t.used * 1.5).astype(np.int64))
    for d in range(4):
        assert torch.equal(t.device_rows(d), s.device_rows(d))
    assert torch.equal(t.id_dev, s.id_dev) and torch.equal(t.id_row, s.id_row)


# ---------------------------------------------------------------------- #
# hypothesis twins of tests/test_mutation_props.py
# ---------------------------------------------------------------------- #

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

SETTINGS = dict(max_examples=10, deadline=None)


@given(seed=st.integers(0, 10_000), n_ins=st.integers(0, 60), n_del=st.integers(0, 40))
@settings(**SETTINGS)
def test_compaction_is_scratch_reencode(seed, n_ins, n_del):
    """The port's compaction equals a from-scratch re-encode of the
    survivors (the port's own `encode_index`) and the reference's
    compaction, with exactly-once coverage of the buffered ids."""
    ref, port, xs, centers = _base()
    rng, new_xs = _draw(seed, n_ins)
    new_ids = np.arange(N0, N0 + n_ins, dtype=np.int32)
    rd, td = rdelta.DeltaIndex.create(M, 64), tdelta.DeltaIndex.create(M, 64)
    if n_ins:
        rd.insert(ref.centroids, ref.codebook, new_ids, new_xs)
        td.insert(port.centroids, port.codebook, new_ids, new_xs, device=CPU)
    assert np.unique(td.vec_ids[: td.n]).size == td.n
    victims = rng.choice(np.arange(N0 + n_ins), min(n_del, N0 + n_ins), replace=False)
    if victims.size:
        rd.delete(victims)
        td.delete(victims)
    np.testing.assert_array_equal(td.live_mask()[: td.n], ~np.isin(new_ids, victims))
    t_idx, t_info = tdelta.compact_index(port, td)
    r_idx, _ = rdelta.compact_index(ref, rd)
    assert not np.isin(t_idx.vec_ids, victims).any()
    keep0, keep1 = ~np.isin(np.arange(N0), victims), ~np.isin(new_ids, victims)
    assert t_info.merged == int(keep1.sum())
    assert t_info.dropped == int((~keep0).sum() + (~keep1).sum())
    want = encode_index(port.centroids, port.codebook,
                        np.concatenate([xs[keep0], new_xs[keep1]]),
                        np.concatenate([np.arange(N0)[keep0], new_ids[keep1]]), device=CPU)
    for f in ("codes", "vec_ids", "offsets"):
        np.testing.assert_array_equal(getattr(t_idx, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(t_idx, f), getattr(r_idx, f))


@given(seed=st.integers(0, 10_000), n_ins=st.integers(1, 40), n_del=st.integers(1, 30),
       k=st.integers(1, 8))
@settings(**SETTINGS)
def test_tombstoned_ids_never_returned(seed, n_ins, n_del, k):
    """Merged (filtered main + delta) results hold no tombstone, only live
    ids, and come back sorted.  k stays at or below the smallest probed
    cluster, where the reference's flat search is defined (ROADMAP C1); the
    port's flat search and delta scan equal the reference's there."""
    from repro.core.index import search as ref_flat_search

    ref, port, _, centers = _base()
    rng, new_xs = _draw(seed, n_ins)
    new_ids = np.arange(N0, N0 + n_ins, dtype=np.int32)
    td, rd = tdelta.DeltaIndex.create(M, 64), rdelta.DeltaIndex.create(M, 64)
    td.insert(port.centroids, port.codebook, new_ids, new_xs, device=CPU)
    rd.insert(ref.centroids, ref.codebook, new_ids, new_xs)
    victims = rng.choice(np.arange(N0 + n_ins), n_del, replace=False)
    td.delete(victims)
    rd.delete(victims)
    _, qs = _draw(seed + 1, 4)
    kk = min(2 * k, int(port.cluster_sizes().min()))
    main_d, main_i = port_flat_search(port, qs, nprobe=4, k=kk, device=CPU)
    r_main_d, r_main_i = ref_flat_search(ref, qs, nprobe=4, k=kk)
    np.testing.assert_allclose(main_d, np.asarray(r_main_d), **TOL)
    dd, di = tdelta.delta_topk(td, port.centroids, port.codebook, qs, 4, k, device=CPU)
    r_dd, _ = rdelta.delta_topk(rd, ref.centroids, ref.codebook, qs, 4, k)
    np.testing.assert_allclose(dd, r_dd, **TOL)
    live_ids = set(new_ids[~np.isin(new_ids, victims)].tolist())
    assert all(i == -1 or i in live_ids for i in di.ravel().tolist())
    d, i = tdelta.merge_results(main_d, main_i.astype(np.int64), dd, di,
                                td.tombstone_array(), k)
    assert d.shape == (4, k) and i.shape == (4, k)
    assert not np.isin(i, victims).any()
    assert (np.diff(d, axis=1) >= 0).all()
