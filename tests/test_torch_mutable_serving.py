"""The port's mutable serving (ROADMAP A7, second half) against the
reference's `ServingEngine`.

Twins of `tests/test_mutation.py::test_mutable_serving_matches_engine`,
`::test_churn_stream[tiles|windows]`,
`::test_starved_overfetch_triggers_compaction` and
`tests/test_feature_matrix.py::test_churn_twin_bit_identical_zero_recompiles`
(the 16 mutable cells).  Each runs the same insert / delete / search stream
through the reference's server (Pallas in interpret mode) and the port's on
the reference's trained index: ids equal outside exactly tied groups on
finite lanes (ROADMAP C3: the port's empty lanes read -1), distances
allclose (rtol = atol = 1e-5), and the mutation counters (`compactions`,
`starved_batches`) equal.  Inside the port every twin is bit-identical:
each cell against its unpruned windows cell, depth 0 against depth 1,
onehot against gather.  The churn twin holds the port's recall checkpoints
to the reference's (ROADMAP C2), not to the reference test's 0.5 floor.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _one_thread import one_thread  # noqa: E402,F401
from repro.core.delta import DeltaIndex as RefDelta  # noqa: E402
from repro.core.index import brute_force, recall_at_k  # noqa: E402
from repro.core.index import encode_index as ref_encode_index  # noqa: E402
from repro.core.placement import place_clusters as ref_place_clusters  # noqa: E402
from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro.retrieval import ServingEngine as RefServing  # noqa: E402
from repro.retrieval.layout import RawStore as RefRawStore  # noqa: E402
from repro.retrieval.layout import build_shards as ref_build_shards  # noqa: E402
from repro_torch.core.delta import DeltaIndex  # noqa: E402
from repro_torch.core.index import encode_index  # noqa: E402
from repro_torch.core.placement import place_clusters  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.retrieval import MemANNSEngine, ServingEngine  # noqa: E402
from repro_torch.retrieval.layout import build_shards  # noqa: E402

NPROBE, K, N0, BLOCK_N = 8, 10, 12000, 256
TOL = dict(rtol=1e-5, atol=1e-5)
BOOLS = (False, True)
CELLS = list(itertools.product(("tiles", "windows"), BOOLS, BOOLS, ("off", "exact")))


@pytest.fixture(scope="module")
def ref_engines(clustered_data):
    """The reference's mutable engines, plain and co-occurrence (the
    feature matrix's build); tests give each copy its own delta and raw
    store."""
    xs, _, _, hist = clustered_data
    return {
        cooc: RefEngine.build(
            jax.random.PRNGKey(0), xs, n_clusters=32, m=8, history_queries=hist,
            use_cooc=cooc, n_combos=32, block_n=BLOCK_N, kmeans_iters=8, pq_iters=6,
            mutable=True, delta_capacity=256, rerank="off", k_overfetch=64, store_raw=True,
        )
        for cooc in BOOLS
    }


@pytest.fixture(scope="module")
def port_engines(ref_engines, clustered_data):
    xs = clustered_data[0]
    return {
        cooc: MemANNSEngine.from_reference(
            r.index, r.placement, xs, block_n=BLOCK_N, use_cooc=cooc, n_combos=32,
            mutable=True, delta_capacity=256, k_overfetch=64, freqs=r.freqs, device="cpu",
        )
        for cooc, r in ref_engines.items()
    }


def ref_fresh(ref_engines, cooc=False, capacity=256, **kw):
    r = ref_engines[cooc]
    raw = RefRawStore(vectors=r.raw.vectors.copy(), used=r.raw.used.copy(),
                      id_dev=r.raw.id_dev.copy(), id_row=r.raw.id_row.copy(), dtype=r.raw.dtype)
    return dataclasses.replace(r, delta=RefDelta.create(r.index.m, capacity), raw=raw,
                               _dev_arrays=None, _raw_arrays=None, **kw)


def fresh(port_engines, cooc=False, capacity=256, **kw):
    """A copy of the port engine with an empty delta and its own raw store
    (compaction updates the store in place)."""
    eng = port_engines[cooc]
    raw = eng.raw
    raw = dataclasses.replace(raw, vectors=raw.vectors.clone(), id_dev=raw.id_dev.clone(),
                              id_row=raw.id_row.clone(), used=raw.used.copy(),
                              capacity=raw.capacity.copy())
    return dataclasses.replace(eng, delta=DeltaIndex.create(eng.index.m, capacity), raw=raw,
                               _dev_arrays=None, **kw)


def _same_ids_outside_ties(d, i_a, i_b):
    """Ids equal on every finite lane, up to permutations within exactly
    tied distances."""
    for row_d, a, b in zip(d, i_a, i_b):
        for v in np.unique(row_d[np.isfinite(row_d)]):
            assert set(a[row_d == v]) == set(b[row_d == v])


def _check_twin(pd, pi, rd, ri):
    # a mutable exact cascade of the reference returns its whole fetch
    # bucket while its delta is inactive; its first k columns are the
    # answer (ROADMAP C6)
    rd, ri = rd[:, : pd.shape[1]], ri[:, : pd.shape[1]]
    np.testing.assert_array_equal(np.isfinite(pd), np.isfinite(rd))
    fin = np.isfinite(rd)
    np.testing.assert_allclose(pd[fin], rd[fin], **TOL)
    _same_ids_outside_ties(pd, pi, ri)
    assert (pi[~fin] == -1).all()


def _scratch(eng, xs_surv, ids_surv, cooc=False):
    """From-scratch rebuild over the survivors with the same trained
    centroids and codebook."""
    idx = encode_index(eng.index.centroids, eng.index.codebook, xs_surv, ids_surv,
                       device="cpu")
    pl = place_clusters(idx.cluster_sizes().astype(np.float64), eng.freqs, eng.ndev,
                        centroids=idx.centroids)
    sh = build_shards(idx, pl, use_cooc=cooc, n_combos=32, block_n=eng.shards.block_n,
                      device="cpu")
    return MemANNSEngine(index=idx, placement=pl, shards=sh, device=eng.device, scan=eng.scan)


# ---------------------------------------------------------------------- #
# twins of tests/test_mutation.py
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("rerank", ["off", "exact"])
def test_mutable_serving_matches_engine(ref_engines, port_engines, clustered_data, rerank):
    """Micro-batched mutable serving == the engine's one-shot search with the
    delta live, == the reference's server; no build after warmup."""
    _, centers, qs, _ = clustered_data
    eng = fresh(port_engines, capacity=2048, rerank=rerank)
    reng = ref_fresh(ref_engines, capacity=2048, rerank=rerank)
    srv = ServingEngine(eng, nprobe=NPROBE, k=K, micro_batch=8, mutable=True)
    rsrv = RefServing(reng, nprobe=NPROBE, k=K, micro_batch=8, mutable=True, autotune="off")
    srv.warmup()
    rsrv.warmup()
    assert srv._k_fetch() == rsrv._k_fetch()
    rng = np.random.default_rng(7)
    new_ids = np.arange(N0, N0 + 100, dtype=np.int32)
    new_xs = centers[rng.integers(0, 32, 100)] + rng.normal(0, 1, (100, 32)).astype(np.float32)
    dels = rng.choice(N0, 40, replace=False)
    for s in (srv, rsrv):
        s.insert(new_ids, new_xs)
        s.delete(dels)
    sd, si = srv.search(qs)
    ed, ei = eng.search(qs, nprobe=NPROBE, k=K)
    np.testing.assert_array_equal(si, ei)
    np.testing.assert_array_equal(sd, ed)
    rd, ri = rsrv.search(qs)
    _check_twin(sd, si, rd, ri)
    assert srv.stats.compiles == 0, srv.stats
    assert srv.stats.inserts == 100 and srv.stats.deletes == 40
    assert srv.stats.tombstones == 40 and srv.stats.delta_occupancy == 100 / 2048
    for f in ("batches", "queries", "rows_scanned", "reranked_queries", "rerank_candidates",
              "starved_batches", "compactions"):
        assert getattr(srv.stats, f) == getattr(rsrv.stats, f), f


@pytest.mark.parametrize("scan", ["tiles", "windows"])
def test_churn_stream(ref_engines, port_engines, clustered_data, scan):
    """The reference's acceptance stream (16 rounds of 72 inserts and 14
    deletes, one auto-compaction or more): the port answers as the
    reference's server does in every round, never returns a tombstoned id,
    builds nothing, and its recall checkpoints equal the reference's; after
    a final compaction it equals a from-scratch rebuild bit for bit."""
    xs, centers, qs, _ = clustered_data
    kw = dict(nprobe=NPROBE, k=K, micro_batch=8, mutable=True, compact_occupancy=0.5,
              tombstone_limit=500)
    eng = fresh(port_engines, capacity=2048, scan=scan)
    srv = ServingEngine(eng, **kw)
    rsrv = RefServing(ref_fresh(ref_engines, capacity=2048, scan=scan), autotune="off", **kw)
    srv.warmup()
    rsrv.warmup()
    rng = np.random.default_rng(11)
    vecs = {i: xs[i] for i in range(N0)}
    deleted: set[int] = set()
    next_id = N0
    recalls, ref_recalls = [], []
    for round_ in range(16):
        ids = np.arange(next_id, next_id + 72, dtype=np.int32)
        next_id += 72
        new = centers[rng.integers(0, 32, 72)] + rng.normal(0, 1, (72, 32)).astype(np.float32)
        live = np.fromiter(vecs.keys(), np.int64, count=len(vecs))
        vecs.update(zip(ids.tolist(), new))
        live = np.fromiter(vecs.keys(), np.int64, count=len(vecs))
        victims = rng.choice(live, 14, replace=False)
        for s in (srv, rsrv):
            s.insert(ids, new)
            s.delete(victims)
        for v in victims.tolist():
            vecs.pop(v)
            deleted.add(v)
        sd, si = srv.search(qs)
        rd, ri = rsrv.search(qs)
        _check_twin(sd, si, rd, ri)
        assert not np.isin(si, np.fromiter(deleted, np.int64)).any()
        if round_ % 5 == 4:
            ids_live = np.fromiter(vecs.keys(), np.int64, count=len(vecs))
            _, t = brute_force(np.stack([vecs[i] for i in ids_live.tolist()]), qs, K)
            recalls.append(recall_at_k(si, ids_live[t]))
            ref_recalls.append(recall_at_k(ri, ids_live[t]))
    st, rst = srv.stats, rsrv.stats
    assert st.inserts >= 1000 and st.deletes >= 200
    assert st.compactions == rst.compactions >= 1
    assert st.starved_batches == rst.starved_batches
    assert st.compiles == 0, st
    assert recalls == ref_recalls
    srv.compact()
    assert not eng.mutation_active
    ids_live = np.fromiter(vecs.keys(), np.int64, count=len(vecs))
    ref = _scratch(eng, np.stack([vecs[i] for i in ids_live.tolist()]), ids_live)
    d_c, i_c = eng.search(qs, NPROBE, K)
    d_r, i_r = ref.search(qs, NPROBE, K)
    np.testing.assert_array_equal(i_c, i_r)
    np.testing.assert_array_equal(d_c, d_r)
    np.testing.assert_array_equal(eng.index.vec_ids, ref.index.vec_ids)


@pytest.mark.parametrize("rerank", ["off", "exact"])
def test_starved_overfetch_triggers_compaction(ref_engines, port_engines, clustered_data,
                                               rerank):
    """Deleting query 0's whole fetch window starves one batch (counted, as
    the reference's server counts it), which compacts after the drain, so
    the next search is full and equals a scratch rebuild."""
    xs, _, qs, _ = clustered_data
    eng = fresh(port_engines, capacity=2048, rerank=rerank)
    kw = dict(nprobe=NPROBE, k=K, micro_batch=8, mutable=True, tombstone_limit=10_000)
    srv = ServingEngine(eng, **kw)
    rsrv = RefServing(ref_fresh(ref_engines, capacity=2048, rerank=rerank), autotune="off", **kw)
    srv.warmup()
    rsrv.warmup()
    # the main path's whole ADC fetch window (k + overfetch, or the cascade
    # bucket) and a few rows more
    window = srv._k_fetch() if rerank == "exact" else 2 * K
    _, wide = dataclasses.replace(eng, rerank="off").search(qs[:1], NPROBE, window + 8)
    victims = wide[0][wide[0] >= 0]
    srv.delete(victims)
    rsrv.delete(victims)
    d1, i1 = srv.search(qs[:8])
    rd1, ri1 = rsrv.search(qs[:8])
    assert (i1[0] == -1).any(), "query 0 should have starved"
    assert not np.isin(i1, victims).any()
    _check_twin(d1, i1, rd1, ri1)
    assert srv.stats.starved_batches == rsrv.stats.starved_batches == 1
    assert srv.stats.compactions == rsrv.stats.compactions == 1
    assert eng.delta.tombstone_count == 0
    d2, i2 = srv.search(qs[:8])
    assert (i2 >= 0).all()
    keep = ~np.isin(np.arange(N0), victims)
    scratch = _scratch(eng, xs[keep], np.arange(N0)[keep])
    if rerank == "off":
        _, i_r = scratch.search(qs[:8], NPROBE, K)
        np.testing.assert_array_equal(i2, i_r)
    rd2, ri2 = rsrv.search(qs[:8])
    _check_twin(d2, i2, rd2, ri2)


@pytest.fixture(scope="module")
def short_engines():
    """A corpus whose cluster 0 holds 4 rows, so a query probing it alone
    gets a short result (fewer than k rows)."""
    rng = np.random.default_rng(2)
    centers = rng.normal(0, 20, (8, 16)).astype(np.float32)
    sizes = [4] + [300] * 7
    xs = np.concatenate([centers[c] + rng.normal(0, 1, (n, 16)) for c, n in enumerate(sizes)])
    xs = xs.astype(np.float32)
    built = RefEngine.build(jax.random.PRNGKey(0), xs, n_clusters=8, m=4, block_n=256,
                            kmeans_iters=4, pq_iters=4)
    # the true centers as the coarse centroids: cluster 0 keeps its 4 rows
    idx = ref_encode_index(centers, built.index.codebook, xs, np.arange(xs.shape[0]))
    plc = ref_place_clusters(idx.cluster_sizes().astype(np.float64), np.ones(8) / 8, 1,
                             centroids=idx.centroids)
    ref = RefEngine(index=idx, placement=plc, shards=ref_build_shards(idx, plc, block_n=256),
                    mesh=built.mesh, freqs=np.ones(8) / 8)
    port = MemANNSEngine.from_reference(idx, plc, block_n=256, mutable=True,
                                        delta_capacity=256, freqs=ref.freqs, device="cpu")
    return ref, port, centers, xs


def test_short_result_with_tombstones_is_not_starvation(short_engines):
    """ROADMAP C3 under mutation: a query whose one probed cluster holds
    fewer than k rows comes back short, with -1 in the port's empty lanes;
    while tombstones exist elsewhere that is not starvation, as in the
    reference, whose empty lanes carry stray ids here.  Deleting one of the
    query's own rows empties a lane and starves it, in both."""
    ref, port, centers, xs = short_engines
    small = int(np.argmin(port.index.cluster_sizes()))
    assert port.index.cluster_sizes()[small] < K
    q = (port.index.centroids[small][None] + 0.01).astype(np.float32)
    # the short query last: its pair follows the others' on the device, so
    # the reference's empty lanes take stray ids of their rows
    qs = np.concatenate([xs[-7:], q])
    kw = dict(nprobe=1, k=K, micro_batch=8, mutable=True, tombstone_limit=10_000)
    srv = ServingEngine(dataclasses.replace(port, delta=DeltaIndex.create(4, 256)), **kw)
    rsrv = RefServing(dataclasses.replace(ref, delta=RefDelta.create(4, 256)), autotune="off",
                      **kw)
    srv.warmup()
    rsrv.warmup()
    own = srv.engine.index.vec_ids[srv.engine.index.offsets[small]:
                                   srv.engine.index.offsets[small + 1]]
    far = np.setdiff1d(np.arange(xs.shape[0] - 300), own)[:3]
    for s in (srv, rsrv):
        s.delete(far)
    d, i = srv.search(qs)
    rd, ri = rsrv.search(qs)
    assert (i[7] == -1).any() and not np.isfinite(d[7]).all() and (ri[7] >= 0).all()
    _check_twin(d, i, rd, ri)
    assert srv.stats.starved_batches == rsrv.stats.starved_batches == 0
    assert srv.stats.compactions == rsrv.stats.compactions == 0
    for s in (srv, rsrv):
        s.delete(own[:1])
    d, i = srv.search(qs)
    rd, ri = rsrv.search(qs)
    _check_twin(d, i, rd, ri)
    assert srv.stats.starved_batches == rsrv.stats.starved_batches == 1
    assert srv.stats.compactions == rsrv.stats.compactions == 1


# ---------------------------------------------------------------------- #
# the feature matrix's churn twins (16 mutable cells)
# ---------------------------------------------------------------------- #


def _churn_stream(centers, seed=11, rounds=4, n_ins=40, n_del=6):
    rng = np.random.default_rng(seed)
    steps, next_id = [], N0
    for _ in range(rounds):
        ids = np.arange(next_id, next_id + n_ins, dtype=np.int64)
        next_id += n_ins
        vecs = (centers[rng.integers(0, len(centers), n_ins)]
                + rng.normal(0, 1.0, (n_ins, centers.shape[1]))).astype(np.float32)
        steps.append((ids, vecs, rng.choice(N0, size=n_del, replace=False).astype(np.int64)))
    return steps


SERVE = dict(nprobe=NPROBE, k=K, micro_batch=8, mutable=True, compact_occupancy=0.5,
             delta_capacity=256)


def _run_stream(srv, steps, qs):
    srv.warmup()
    outs = []
    for ids, vecs, dels in steps:
        srv.insert(ids, vecs)
        srv.delete(dels)
        outs.append(srv.search(qs[:16]))
    srv.compact()
    outs.append(srv.search(qs[:16]))
    return outs


@pytest.fixture(scope="module")
def twin_streams(ref_engines, port_engines, clustered_data):
    """The churn stream on each (cooc, rerank) unpruned windows cell,
    every search and the search after the final compaction, through the
    reference's server and the port's; inside each package every cell
    equals it bit for bit."""
    centers, qs = clustered_data[1], clustered_data[2]
    out = {}
    for cooc, rerank in itertools.product(BOOLS, ("off", "exact")):
        reng = ref_fresh(ref_engines, cooc, scan="windows", prune=False, rerank=rerank)
        rsrv = RefServing(reng, autotune="off", **SERVE)
        twin = ServingEngine(fresh(port_engines, cooc, scan="windows", prune=False,
                                   rerank=rerank), **SERVE)
        out[cooc, rerank] = (_run_stream(rsrv, _churn_stream(centers), qs), rsrv.stats,
                             _run_stream(twin, _churn_stream(centers), qs))
    return out


@pytest.mark.parametrize("scan,cooc,prune,rerank", CELLS)
def test_churn_twin_bit_identical_zero_recompiles(port_engines, twin_streams, clustered_data,
                                                  scan, cooc, prune, rerank):
    centers, qs = clustered_data[1], clustered_data[2]
    srv = ServingEngine(fresh(port_engines, cooc, scan=scan, prune=prune, rerank=rerank),
                        **SERVE)
    outs = _run_stream(srv, _churn_stream(centers), qs)
    routs, rstats, touts = twin_streams[cooc, rerank]
    for (d, i), (td, ti), (rd, ri) in zip(outs, touts, routs):
        np.testing.assert_array_equal(i, ti)
        np.testing.assert_array_equal(d, td)
        _check_twin(d, i, rd, ri)
    assert srv.stats.compactions == rstats.compactions >= 2
    assert srv.stats.compiles == 0, srv.stats


def test_depth0_equals_depth1_under_churn(port_engines, clustered_data):
    """Plan-time delta scans and tombstone snapshots keep pipeline depths
    bit-identical under churn, across an auto-compaction."""
    centers, qs = clustered_data[1], clustered_data[2]
    steps = _churn_stream(centers, seed=3)
    outs = [
        _run_stream(ServingEngine(fresh(port_engines, rerank="exact"), pipeline_depth=depth,
                                  **{**SERVE, "micro_batch": 4}), steps, qs)
        for depth in (0, 1)
    ]
    for (d0, i0), (d1, i1) in zip(*outs):
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(d0, d1)


@pytest.mark.parametrize("scan,rerank", [("tiles", "off"), ("windows", "exact")])
def test_onehot_churn_equals_gather(port_engines, clustered_data, scan, rerank):
    """On raw codes the onehot path serves the gather path's answers bit
    for bit under churn (the delta scan stays on the gather, as the
    reference's)."""
    centers, qs = clustered_data[1], clustered_data[2]
    steps = _churn_stream(centers, seed=5)
    outs = [
        _run_stream(ServingEngine(fresh(port_engines, scan=scan, rerank=rerank, path=path),
                                  **SERVE), steps, qs)
        for path in ("onehot", "gather")
    ]
    for (d0, i0), (d1, i1) in zip(*outs):
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(d0, d1)


def test_overfetch_past_scan_k_max_refused(ref_engines, port_engines, clustered_data):
    """An overfetch whose fetch bucket (8,192 under the exact re-rank) lies
    past the shared-memory scans' SCAN_K_MAX: the server is built and
    serves a churn stream (two rounds and a compaction) as the reference's
    does (once refused, ROADMAP C5)."""
    centers, qs = clustered_data[1], clustered_data[2]
    kw = dict(SERVE, overfetch=ops.SCAN_K_MAX)
    srv = ServingEngine(fresh(port_engines, rerank="exact"), **kw)
    rsrv = RefServing(ref_fresh(ref_engines, rerank="exact"), autotune="off", **kw)
    assert srv._k_fetch() == rsrv._k_fetch() == 2 * ops.SCAN_K_MAX
    steps = _churn_stream(centers, seed=5, rounds=2)
    for (pd, pi), (rd, ri) in zip(_run_stream(srv, steps, qs), _run_stream(rsrv, steps, qs)):
        _check_twin(pd, pi, rd, ri)
    small = ServingEngine(fresh(port_engines, rerank="exact"), nprobe=NPROBE, k=K, mutable=True,
                          overfetch=10)
    assert small._k_fetch() == 128 and small.tombstone_limit == 64
