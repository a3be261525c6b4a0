"""The port's fault-tolerant serving (ROADMAP A12): twins of
`tests/test_faults.py` (its checkpoint-crash tests wait for queue A item
10, checkpoint writing).

Each twin runs the same `FaultPlan` through the port's `ServingEngine` and
the reference's on the reference's trained index (skewed history: hot
clusters replicate).  Deadlines, admission, retries and the watchdog run
at one device, as the reference's tests do here.  Failover needs several
devices; the reference runs one JAX device here, so the port's failover
twins run eight logical devices over the reference's eight-device
placement: the covered queries are bit-identical to the port's healthy run
and equal the reference's healthy serving (ids outside exact ties,
distances allclose), and the coverage accounting equals the reference's
`plan_batch` under the same live mask.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import placement as rplace  # noqa: E402
from repro.retrieval import FaultPlan as RefFaultPlan  # noqa: E402
from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro.retrieval import ServingEngine as RefServing  # noqa: E402
from repro.retrieval.layout import build_shards as ref_build_shards  # noqa: E402
from repro_torch.retrieval import MemANNSEngine, ServingEngine  # noqa: E402
from repro_torch.retrieval.faults import FaultError, FaultPlan  # noqa: E402

NDEV = 8
KW = dict(nprobe=8, k=10, micro_batch=8)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def engines(clustered_data):
    """(reference engine at one device, the port over its index at one
    device, the reference's planner over an eight-device placement, the
    port over that placement)."""
    xs, centers, qs, hist = clustered_data
    rng = np.random.default_rng(3)
    hot = rng.integers(0, 8, 400)
    skewed = centers[hot] + rng.normal(0, 1, (400, 32)).astype(np.float32)
    ref = RefEngine.build(
        jax.random.PRNGKey(0), xs, n_clusters=32, m=8, history_queries=skewed,
        use_cooc=False, n_combos=32, block_n=256, kmeans_iters=8, pq_iters=6,
    )
    port1 = MemANNSEngine.from_reference(ref.index, ref.placement, block_n=256, device="cpu")
    plc8 = rplace.place_clusters(ref.index.cluster_sizes().astype(np.float64), ref.freqs, NDEV,
                                 centroids=ref.index.centroids)
    ref8 = dataclasses.replace(ref, placement=plc8, _dev_arrays=None,
                               shards=ref_build_shards(ref.index, plc8, block_n=256))
    port8 = MemANNSEngine.from_reference(ref.index, plc8, block_n=256, freqs=ref.freqs,
                                         device="cpu")
    return ref, port1, ref8, port8


def _ref_serving(ref, **kw):
    srv = RefServing(ref, autotune="off", **KW, **kw)
    srv.warmup()
    return srv


def _serving(eng, **kw):
    srv = ServingEngine(eng, **KW, **kw)
    srv.warmup()
    return srv


def _same_outside_ties(d, a, b):
    for row_d, x, y in zip(d, a, b):
        for v in np.unique(row_d):
            assert set(x[row_d == v]) == set(y[row_d == v])


def _best_dead_device(engine) -> int:
    """Device whose death strands the fewest clusters (ties: lowest id)."""
    reps = engine.placement.replicas
    costs = [(sum(1 for r in reps if r and set(r) <= {d}), d) for d in range(engine.ndev)]
    return min(costs)[1]


def _want_lost(ref8, qs, dead):
    """The reference's lost (query, cluster) pairs of each 8-query chunk
    planned with `dead` down."""
    live = np.ones(NDEV, bool)
    live[dead] = False
    want = []
    for off in range(0, qs.shape[0], 8):
        plan = ref8.plan_batch(qs[off:off + 8], 8, live=live)
        want += [(int(q) + off, int(c)) for q, c in zip(plan.lost_q, plan.lost_c)]
    return sorted(want)


def test_failover_twin_run(engines, clustered_data):
    """One device dead from the start: no query crashes, covered queries
    are bit-identical to the healthy run at no build, the rest are flagged
    with coverage equal to the reference planner's."""
    ref, _, ref8, port8 = engines
    qs = clustered_data[2]
    d0, i0 = _serving(port8).search(qs)
    rd, ri = _ref_serving(ref).search(qs)
    dead = _best_dead_device(port8)
    fp = FaultPlan(device_death={dead: 0})
    srv = _serving(port8, faults=fp)
    res = srv.search_result(qs)
    assert res.dists.shape == res.ids.shape == (qs.shape[0], 10)
    assert srv.stats.compiles == 0 and srv.stats.failovers == 1
    h = srv.health()
    assert h["state"] == "degraded" and h["dead_devices"] == [dead]
    assert ("failover", {"device": dead}) in fp.events
    for _, ci in res.coverage_lost:
        assert set(port8.placement.replicas[int(ci)]) <= {dead}
    np.testing.assert_array_equal(
        res.degraded, np.isin(np.arange(qs.shape[0]), res.coverage_lost[:, 0]))
    np.testing.assert_array_equal(res.coverage_degraded(), res.degraded)
    assert not res.deadline_degraded.any()
    got = sorted((int(a), int(b)) for a, b in res.coverage_lost)
    assert got == _want_lost(ref8, qs, dead) and got
    assert srv.stats.degraded_queries == int(res.degraded.sum())
    ok = ~res.degraded
    assert ok.any()
    np.testing.assert_array_equal(res.ids[ok], i0[ok])
    np.testing.assert_array_equal(res.dists[ok], d0[ok])
    np.testing.assert_allclose(res.dists[ok], rd[ok], **TOL)
    _same_outside_ties(res.dists[ok], res.ids[ok], ri[ok])


def test_failover_mid_stream(engines, clustered_data):
    _, _, ref8, port8 = engines
    qs = clustered_data[2]
    d0, i0 = _serving(port8).search(qs)
    dead = _best_dead_device(port8)
    srv = _serving(port8, faults=FaultPlan(device_death={dead: 2}))
    res = srv.search_result(qs)
    assert srv.stats.compiles == 0
    np.testing.assert_array_equal(res.ids[:16], i0[:16])
    np.testing.assert_array_equal(res.dists[:16], d0[:16])
    assert not res.degraded[:16].any()
    assert (res.coverage_lost[:, 0] >= 16).all()
    want = [p for p in _want_lost(ref8, qs, dead) if p[0] >= 16]
    assert sorted((int(a), int(b)) for a, b in res.coverage_lost) == want


def test_deadline_degrades_instead_of_running_late(engines, clustered_data):
    """deadline 0 serves every chunk at degrade_nprobe, as the reference's
    server does; a generous deadline changes nothing."""
    ref, port, _, _ = engines
    qs = clustered_data[2]
    d0, i0 = _serving(port).search(qs)
    srv = _serving(port, deadline_ms=0.0)
    rsrv = _ref_serving(ref, deadline_ms=0.0)
    res, rres = srv.search_result(qs), rsrv.search_result(qs)
    assert res.deadline_degraded.all() and res.degraded.all()
    assert srv.stats.compiles == 0
    assert srv.stats.degraded_queries == rsrv.stats.degraded_queries == qs.shape[0]
    assert srv.health()["state"] == rsrv.health()["state"] == "degraded"
    np.testing.assert_allclose(res.dists, rres.dists, **TOL)
    _same_outside_ties(res.dists, res.ids, rres.ids)
    relaxed = _serving(port, deadline_ms=1e9)
    res2 = relaxed.search_result(qs)
    assert not res2.degraded.any()
    np.testing.assert_array_equal(res2.ids, i0)
    np.testing.assert_array_equal(res2.dists, d0)
    assert relaxed.health()["state"] == "ok"


def test_deadline_skips_rerank_on_immutable_cascade(engines, clustered_data):
    """A late batch of an immutable exact cascade serves the ADC top-k at
    degrade_nprobe, without the re-rank: the reference's answer."""
    ref, port, _, _ = engines
    xs, _, qs, _ = clustered_data
    pe = MemANNSEngine.from_reference(ref.index, ref.placement, xs, block_n=256,
                                      rerank="exact", device="cpu")
    re_ = RefEngine.build(jax.random.PRNGKey(0), xs, n_clusters=32, m=8,
                          history_queries=clustered_data[3], block_n=256, kmeans_iters=8,
                          pq_iters=6, rerank="exact", store_raw=True)
    re_ = dataclasses.replace(re_, index=ref.index, placement=ref.placement,
                              shards=ref.shards, _dev_arrays=None, _raw_arrays=None)
    srv, rsrv = _serving(pe, deadline_ms=0.0), _ref_serving(re_, deadline_ms=0.0)
    res, rres = srv.search_result(qs), rsrv.search_result(qs)
    assert res.deadline_degraded.all() and srv.stats.reranked_queries == 0
    assert rsrv.stats.reranked_queries == 0
    np.testing.assert_allclose(res.dists, rres.dists, **TOL)
    _same_outside_ties(res.dists, res.ids, rres.ids)
    d_adc, _ = _serving(port, deadline_ms=0.0).search(qs)
    np.testing.assert_array_equal(res.dists, d_adc)


def test_admission_control_bounds_the_queue(engines, clustered_data):
    ref, port, _, _ = engines
    qs = clustered_data[2]
    srv = _serving(port, queue_limit=16)
    rsrv = _ref_serving(ref, queue_limit=16)
    assert srv.health()["state"] == "ok"
    assert srv.submit(qs) == rsrv.submit(qs) == 16
    assert srv.pending() == 16 and srv.stats.rejected_queries == 8
    assert srv.health()["state"] == "overloaded"
    assert srv.submit(qs[:4]) == rsrv.submit(qs[:4]) == 0
    assert srv.stats.rejected_queries == rsrv.stats.rejected_queries == 12
    assert srv.stats.m_queue_depth.get() == 16.0
    d, i = srv.flush()
    rd, ri = rsrv.flush()
    assert d.shape[0] + srv.stats.rejected_queries == 24 + 4
    assert srv.health()["state"] == "ok" and srv.pending() == 0
    bd, bi = _serving(port).search(qs[:16])
    np.testing.assert_array_equal(i, bi)
    np.testing.assert_allclose(d, rd, **TOL)
    _same_outside_ties(d, i, ri)


def test_transient_fault_retries_then_recovers(engines, clustered_data):
    ref, port, _, _ = engines
    qs = clustered_data[2]
    d0, i0 = _serving(port).search(qs)
    fp, rfp = FaultPlan(transient_dispatch={1: 2}), RefFaultPlan(transient_dispatch={1: 2})
    srv = _serving(port, faults=fp, retry_limit=2, retry_backoff_s=0.001)
    rsrv = _ref_serving(ref, faults=rfp, retry_limit=2, retry_backoff_s=0.001)
    res, rres = srv.search_result(qs), rsrv.search_result(qs)
    assert srv.stats.retries == rsrv.stats.retries == 2
    assert srv.stats.failovers == 0 and not res.degraded.any()
    np.testing.assert_array_equal(res.ids, i0)
    np.testing.assert_array_equal(res.dists, d0)
    assert fp.events == rfp.events
    assert ("transient_dispatch", {"seq": 1, "remaining": 1}) in fp.events
    assert srv.stats.m_retries.get(phase="dispatch") == 2.0


def test_persistent_fault_escalates_to_failover(engines, clustered_data):
    _, _, _, port8 = engines
    qs = clustered_data[2]
    blamed = _best_dead_device(port8)
    fp = FaultPlan(transient_dispatch={0: 10_000}, transient_device=blamed)
    srv = _serving(port8, faults=fp, retry_limit=2, retry_backoff_s=0.0)
    res = srv.search_result(qs)
    assert res.ids.shape == (qs.shape[0], 10)
    assert srv.stats.retries >= 2 and srv.stats.failovers == 1
    assert srv.health()["dead_devices"] == [blamed]
    assert ("failover", {"device": blamed}) in fp.events


def test_unattributable_fault_raises_after_retries(engines, clustered_data):
    """With no device to blame, exhausted retries raise to the caller, after
    as many retries as the reference's server makes."""
    from repro.retrieval import FaultError as RefFaultError

    ref, port, _, _ = engines
    qs = clustered_data[2]
    srv = _serving(port, faults=FaultPlan(transient_dispatch={0: 10_000}), retry_limit=2,
                   retry_backoff_s=0.0)
    rsrv = _ref_serving(ref, faults=RefFaultPlan(transient_dispatch={0: 10_000}),
                        retry_limit=2, retry_backoff_s=0.0)
    with pytest.raises(FaultError, match="transient dispatch"):
        srv.search(qs)
    with pytest.raises(RefFaultError, match="transient dispatch"):
        rsrv.search(qs)
    assert srv.stats.failovers == rsrv.stats.failovers == 0
    assert srv.stats.retries == rsrv.stats.retries == 2


def test_hung_collect_fails_over_instead_of_stalling(engines, clustered_data):
    _, _, ref8, port8 = engines
    qs = clustered_data[2]
    d0, i0 = _serving(port8).search(qs)
    hung = _best_dead_device(port8)
    fp = FaultPlan(hang_collect={1: hung})
    srv = _serving(port8, faults=fp, collect_timeout_s=2.0)
    res = srv.search_result(qs)
    assert res.ids.shape == (qs.shape[0], 10)
    assert srv.stats.retries == 1 and srv.stats.failovers == 1
    assert srv.health()["dead_devices"] == [hung]
    assert srv.stats.compiles == 0
    assert ("hang_collect", {"seq": 1, "device": hung}) in fp.events
    # only batch 1 refires around the dead device: batch 2 was planned and
    # dispatched (depth 1) before batch 1's collect found the hang
    ok = ~res.degraded
    assert not res.degraded[:8].any() and not res.degraded[16:].any()
    np.testing.assert_array_equal(res.ids[ok], i0[ok])
    np.testing.assert_array_equal(res.dists[ok], d0[ok])
    want = [p for p in _want_lost(ref8, qs, hung) if 8 <= p[0] < 16]
    assert sorted((int(a), int(b)) for a, b in res.coverage_lost) == want


def test_slow_collect_within_grace_is_not_a_fault(engines, clustered_data):
    ref, port, _, _ = engines
    qs = clustered_data[2]
    d0, i0 = _serving(port).search(qs)
    srv = _serving(port, faults=FaultPlan(slow_collect={0: 0.05}), collect_timeout_s=10.0)
    rsrv = _ref_serving(ref, faults=RefFaultPlan(slow_collect={0: 0.05}), collect_timeout_s=10.0)
    res, rres = srv.search_result(qs), rsrv.search_result(qs)
    assert srv.stats.retries == rsrv.stats.retries == 0 and srv.stats.failovers == 0
    np.testing.assert_array_equal(res.ids, i0)
    np.testing.assert_array_equal(res.dists, d0)
    _same_outside_ties(res.dists, res.ids, rres.ids)


def test_collect_timeout_raises_when_unattributable(engines, clustered_data):
    _, port, _, _ = engines
    qs = clustered_data[2]
    srv = _serving(port, faults=FaultPlan(slow_collect={0: 60.0}), collect_timeout_s=0.1)
    with pytest.raises(FaultError, match="timed out"):
        srv.search(qs)
