"""The port's ServingEngine (immutable half of ROADMAP A7): twins of
`tests/test_serving.py`, with the engine's `path` swept beside `scan`.

Micro-batched serving equals the engine's direct search, builds nothing in
steady state after `warmup()` (the port's compiles: nvcc builds and
CUDA-graph captures, none on the CPU), and keeps honest stats.  A stream
through the port's ServingEngine equals one through the reference's
(Pallas in interpret mode) on the same trained index: ids equal outside
exactly tied groups, distances allclose(rtol = atol = 1e-5).  The knobs
that came with ROADMAP items 7 and 12 each do what the reference's do;
the autotune sweep (item 13) persists and applies its winner.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro.retrieval import ServingEngine as RefServing  # noqa: E402
from repro_torch.retrieval import MemANNSEngine, ServingEngine, round_capacity  # noqa: E402

SCAN_PATH = [(s, p) for s in ("tiles", "windows") for p in ("gather", "onehot")]


@pytest.fixture(scope="module")
def engines(clustered_data):
    """The reference's serving fixture engine and the port's over its index."""
    xs, centers, qs, hist = clustered_data
    ref = RefEngine.build(
        jax.random.PRNGKey(0), xs, n_clusters=32, m=8,
        history_queries=hist, use_cooc=False, n_combos=32,
        block_n=256, kmeans_iters=8, pq_iters=6,
    )
    port = MemANNSEngine.from_reference(ref.index, ref.placement, block_n=256, device="cpu")
    return ref, port


@pytest.fixture
def engine(engines):
    return engines[1]


def _same_outside_ties(d, a, b):
    for row_d, x, y in zip(d, a, b):
        for v in np.unique(row_d):
            assert set(x[row_d == v]) == set(y[row_d == v])


def test_round_capacity():
    assert round_capacity(0) == 8
    assert round_capacity(1) == 8
    assert round_capacity(8) == 8
    assert round_capacity(9) == 16
    assert round_capacity(100) == 128
    assert round_capacity(3, floor=2) == 4


def test_serving_matches_engine(engine, clustered_data):
    xs, _, qs, _ = clustered_data
    srv = ServingEngine(engine, nprobe=8, k=10, micro_batch=8)
    srv.warmup()
    sd, si = srv.search(qs)
    ed, ei = engine.search(qs, nprobe=8, k=10)
    np.testing.assert_array_equal(si, ei)
    np.testing.assert_array_equal(sd, ed)


def test_ragged_tail_padding(engine, clustered_data):
    """A final partial micro-batch is padded, results sliced: same answers."""
    xs, _, qs, _ = clustered_data
    srv = ServingEngine(engine, nprobe=8, k=5, micro_batch=16)
    srv.warmup()
    sd, si = srv.search(qs[:13])  # 13 < 16 -> padded tail
    ed, ei = engine.search(qs[:13], nprobe=8, k=5)
    np.testing.assert_array_equal(si, ei)
    assert si.shape == (13, 5)


def test_no_recompile_after_warmup(engine, clustered_data):
    xs, _, qs, _ = clustered_data
    srv = ServingEngine(engine, nprobe=8, k=10, micro_batch=8)
    buckets = srv.warmup()
    assert buckets == sorted(buckets)
    rng = np.random.default_rng(0)
    for _ in range(4):  # steady-state traffic, varying content
        batch = qs[rng.integers(0, qs.shape[0], 8)]
        srv.search(batch)
    assert srv.stats.compiles == 0, srv.stats
    assert srv.stats.batches == 4
    assert srv.stats.queries == 32
    assert set(srv.stats.bucket_hits) <= set(buckets)
    assert srv.stats.host_s > 0 and srv.stats.device_s > 0
    assert 0.0 < srv.stats.host_fraction() < 1.0
    assert 0.0 < srv.stats.p50_s() <= srv.stats.p99_s()


@pytest.mark.parametrize("scan,path", SCAN_PATH)
def test_stream_200_queries_no_recompile(engine, clustered_data, scan, path):
    """A 200-query stream with ragged tails builds nothing after warmup, on
    either scan and either path, and its tail equals the plain engine."""
    xs, _, qs, _ = clustered_data
    eng = dataclasses.replace(engine, scan=scan, path=path)
    srv = ServingEngine(eng, nprobe=8, k=10, micro_batch=16)
    srv.warmup()
    rng = np.random.default_rng(7)
    stream = xs[rng.integers(0, xs.shape[0], 200)] + rng.normal(
        0, 0.1, (200, xs.shape[1])
    ).astype(np.float32)
    sd, si = srv.search(stream)  # 12 full micro-batches + ragged tail of 8
    assert si.shape == (200, 10)
    assert srv.stats.compiles == 0, srv.stats
    assert srv.stats.queries == 200
    ed, ei = eng.search(stream[192:], nprobe=8, k=10)
    np.testing.assert_array_equal(si[192:], ei)
    if path == "onehot":  # raw codes: the gather path's answers bit for bit
        gsrv = ServingEngine(dataclasses.replace(eng, path="gather"), nprobe=8, k=10,
                             micro_batch=16)
        gsrv.warmup()
        gd, gi = gsrv.search(stream)
        np.testing.assert_array_equal(sd, gd)
        np.testing.assert_array_equal(si, gi)


@pytest.mark.parametrize("scan,path", SCAN_PATH)
def test_submit_flush_order_across_micro_batches(engine, clustered_data, scan, path):
    """submit()/flush() keeps input order when the pending set spans several
    micro-batches with a ragged tail."""
    xs, _, qs, _ = clustered_data
    eng = dataclasses.replace(engine, scan=scan, path=path)
    srv = ServingEngine(eng, nprobe=8, k=5, micro_batch=8)
    srv.warmup()
    rng = np.random.default_rng(11)
    chunks = [
        xs[rng.integers(0, xs.shape[0], n)].astype(np.float32)
        for n in (3, 8, 1, 6, 4)  # 22 queries -> 2 full batches + tail
    ]
    for ch in chunks:
        srv.submit(ch)
    assert srv.pending() == 22
    fd, fi = srv.flush()
    allq = np.concatenate(chunks)
    ed, ei = eng.search(allq, nprobe=8, k=5)
    np.testing.assert_array_equal(fi, ei)
    np.testing.assert_allclose(fd, ed, rtol=1e-5, atol=1e-5)
    assert srv.stats.compiles == 0, srv.stats


def test_submit_flush(engine, clustered_data):
    xs, _, qs, _ = clustered_data
    srv = ServingEngine(engine, nprobe=8, k=5, micro_batch=8)
    srv.warmup()
    srv.submit(qs[0])          # single 1-D query
    srv.submit(qs[1:6])
    assert srv.pending() == 6
    fd, fi = srv.flush()
    assert srv.pending() == 0
    ed, ei = engine.search(qs[:6], nprobe=8, k=5)
    np.testing.assert_array_equal(fi, ei)
    d0, i0 = srv.flush()
    assert d0.shape == (0, 5) and i0.shape == (0, 5)


@pytest.mark.parametrize("path", ["gather", "onehot"])
def test_stream_matches_reference_serving(engines, clustered_data, path):
    """One 40-query stream (micro-batch 16, load feedback on, depth 1)
    through both packages' ServingEngines on the same index."""
    ref, port = engines
    xs = clustered_data[0]
    rng = np.random.default_rng(5)
    stream = (xs[rng.integers(0, xs.shape[0], 40)]
              + rng.normal(0, 0.1, (40, xs.shape[1]))).astype(np.float32)
    rsrv = RefServing(dataclasses.replace(ref, path=path), nprobe=8, k=10, micro_batch=16,
                      autotune="off")
    psrv = ServingEngine(dataclasses.replace(port, path=path), nprobe=8, k=10,
                         micro_batch=16)
    psrv.warmup()
    rd, ri = rsrv.search(stream)
    pd, pi = psrv.search(stream)
    np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=1e-5)
    _same_outside_ties(pd, pi, ri)
    np.testing.assert_array_equal(psrv.load_carry(), rsrv.load_carry())
    assert psrv.stats.bucket_hits == rsrv.stats.bucket_hits
    # the counts the plans fix; how many tiles the bounds skip is each
    # kernel's own (the scan order differs), so those are only bounded
    for field in ("batches", "queries", "rows_scanned", "tiles_dispatched",
                  "warm_bound_queries", "reranked_queries", "rerank_candidates"):
        assert getattr(psrv.stats, field) == getattr(rsrv.stats, field), field
    st = psrv.stats
    assert 0 < st.tiles_skipped < st.tiles_dispatched and 0 < st.rows_pruned
    assert len(st.prune_fracs) == st.batches
    assert 0.0 < st.prune_percentile(50) < 1.0 and 0.0 < st.prune_fraction() < 1.0


def test_result_health_and_autotune_report(engine, clustered_data, tmp_path):
    """`search_result` carries `search`'s answer, `health` reports every
    device live, and the "cache" autotune finds no entry in an empty cache
    directory and applies the in-repo CPU default (keep the geometry)."""
    qs = clustered_data[2]
    srv = ServingEngine(engine, nprobe=8, k=10, micro_batch=8,
                        autotune_cache_dir=str(tmp_path))
    srv.warmup()
    res = srv.search_result(qs)
    d, i = srv.search(qs)
    np.testing.assert_array_equal(res.ids, i)
    np.testing.assert_array_equal(res.dists, d)
    h = srv.health()
    assert h["state"] == "ok" and h["queue_depth"] == 0
    assert h["live_devices"] == h["n_devices"] == engine.ndev and h["dead_devices"] == []
    rep = srv.autotune_report
    assert rep["mode"] == "cache" and rep["source"] == "defaults" and not rep["retiled"]
    assert rep["applied"] == {"block_n": 256, "rerank_block": 0, "tile_floor": 0}
    off = ServingEngine(engine, nprobe=8, k=10, autotune="off")
    assert off.apply_autotune()["source"] == "off"


@pytest.mark.parametrize("knob,item", [
    (dict(mutable=True), "queue A item 7"),
    (dict(autotune="sweep"), "queue A item 13"),
    (dict(tracer="tracer"), "queue A item 12"),
    (dict(faults="faults"), "queue A item 12"),
    (dict(deadline_ms=0.0), "queue A item 12"),
    (dict(degrade_nprobe=2, deadline_ms=0.0), "queue A item 12"),
    (dict(retry_limit=3, faults="faults"), "queue A item 12"),
    (dict(queue_limit=16), "queue A item 12"),
    (dict(collect_timeout_s=1.0), "queue A item 12"),
])
def test_unported_serving_knobs_raise(engines, clustered_data, knob, item, tmp_path):
    """The knobs that waited for ROADMAP items 7, 12 and 13 are taken and
    do what the reference's do: the autotune sweep times its grid on the
    cache miss, persists the winner, applies it before warmup and serves
    the untuned answers bit for bit.  `item` names the item that brought
    each knob."""
    from repro.core.autotune import KernelGeometry as RefGeometry
    from repro_torch.obs.trace import Tracer
    from repro_torch.retrieval.faults import FaultPlan

    engine = engines[1]
    qs = clustered_data[2]
    knob = dict(knob)
    if knob.get("autotune") == "sweep":
        knob["autotune_cache_dir"] = str(tmp_path)
    if knob.get("tracer") == "tracer":
        knob["tracer"] = Tracer()
    if knob.get("faults") == "faults":
        knob["faults"] = FaultPlan(transient_dispatch={0: knob.get("retry_limit", 2)})
    eng = dataclasses.replace(engine, delta=None, tracer=engine.tracer)
    srv = ServingEngine(eng, nprobe=8, k=10, micro_batch=8, retry_backoff_s=0.0, **knob)
    srv.warmup()
    ed, ei = dataclasses.replace(engine, delta=None).search(qs, nprobe=8, k=10)
    if "queue_limit" in knob:
        assert srv.submit(qs) == 16 and srv.stats.rejected_queries == 8
        assert srv.health()["state"] == "overloaded"
        np.testing.assert_array_equal(srv.flush()[1], ei[:16])
        return
    res = srv.search_result(qs)
    if "deadline_ms" in knob:
        assert res.deadline_degraded.all() and srv.health()["state"] == "degraded"
        low = ServingEngine(eng, nprobe=knob.get("degrade_nprobe", 4), k=10, micro_batch=8)
        np.testing.assert_array_equal(res.ids, low.search(qs)[1])
        return
    np.testing.assert_array_equal(res.ids, ei)
    np.testing.assert_array_equal(res.dists, ed)
    if knob.get("autotune") == "sweep":
        rep = srv.autotune_report
        assert rep["source"] == "sweep" and rep["swept"] > 0 and srv.stats.compiles == 0
        assert rep["applied"]["block_n"] == eng.shards.block_n
        # the reference's engine at the swept tile height and floor
        ref = dataclasses.replace(engines[0])
        ref.apply_geometry(RefGeometry(block_n=eng.shards.block_n, tile_floor=eng.tile_floor))
        rd, ri = ref.search(qs, nprobe=8, k=10)
        np.testing.assert_allclose(res.dists, rd, rtol=1e-5, atol=1e-5)
        _same_outside_ties(res.dists, res.ids, ri)
        assert ServingEngine(eng, nprobe=8, k=10, autotune="cache", autotune_cache_dir=str(
            tmp_path)).apply_autotune()["source"] == "cache"
    elif knob.get("mutable"):
        assert srv.mutable and eng.delta is not None
        srv.insert(np.arange(12000, 12024, dtype=np.int32), qs)
        np.testing.assert_array_equal(srv.search(qs)[1][:, 0], np.arange(12000, 12024))
    elif "tracer" in knob:
        assert len(knob["tracer"].roots()) == srv.stats.batches == 3
        assert eng.tracer is knob["tracer"]
    elif "faults" in knob:
        # as many transient faults of batch 0 as the retry budget takes
        assert srv.stats.retries == knob.get("retry_limit", 2) and srv.stats.failovers == 0
    else:  # the watchdog polls the handle and finds it ready
        assert srv.stats.retries == 0 and srv.collect_timeout_s == 1.0


@pytest.mark.parametrize("knob", [
    dict(compact_occupancy=0.5), dict(tombstone_limit=8), dict(overfetch=4),
    dict(replace_threshold=0.5), dict(delta_capacity=64), dict(autotune_cache_dir="c"),
    dict(metrics=False),
])
def test_unread_reference_knobs_not_taken(engine, clustered_data, knob, tmp_path):
    """The reference's knobs of the mutable path and the metrics registry
    are taken now and do what the reference's do; `autotune_cache_dir`
    (ROADMAP queue A item 13) is where the autotune looks, and a sweep
    writes there."""
    name, value = next(iter(knob.items()))
    if name == "autotune_cache_dir":
        d = str(tmp_path / value)
        srv = ServingEngine(engine, nprobe=8, k=10, micro_batch=8, autotune_cache_dir=d)
        assert srv.apply_autotune()["cache_path"].startswith(d)
        rep = ServingEngine(engine, nprobe=8, k=10, autotune="sweep", autotune_cache_dir=d,
                            ).apply_autotune()
        assert rep["source"] == "sweep" and (tmp_path / value / "autotune-cpu-v1.json").exists()
        engine.apply_geometry(srv.engine.geometry().__class__(block_n=256))
        return
    qs = clustered_data[2]
    eng = dataclasses.replace(engine, delta=None, _dev_arrays=None)
    srv = ServingEngine(eng, nprobe=8, k=10, micro_batch=8, mutable=name != "metrics", **knob)
    srv.warmup()
    if name == "metrics":
        srv.search(qs)
        assert srv.stats.registry.render_prometheus() == "" and srv.stats.p50_s() > 0
    elif name == "compact_occupancy":  # 4096 rows: compacts at 2048 buffered
        srv.insert(np.arange(12000, 14047, dtype=np.int32),
                   np.repeat(qs, 86, axis=0)[:2047])
        assert srv.stats.compactions == 0 and srv.stats.delta_occupancy < 0.5
        srv.insert(np.asarray([20000], np.int32), qs[:1])
        assert srv.stats.compactions == 1 and not eng.mutation_active
    elif name == "tombstone_limit":
        srv.delete(np.arange(7))
        assert srv.stats.compactions == 0 and srv.stats.tombstones == 7
        srv.delete(np.asarray([7]))
        assert srv.stats.compactions == 1 and srv.stats.tombstones == 0
    elif name == "overfetch":
        assert srv._k_fetch() == 10
        srv.delete(np.asarray([0]))
        assert srv._k_fetch() == 14
    elif name == "replace_threshold":
        assert srv.replace_threshold == 0.5
        srv.insert(np.asarray([12000], np.int32), qs[:1])
        assert srv.compact().clusters_replaced == 0  # one row moves no cluster by half
    else:
        assert eng.delta.capacity == 64 and srv.tombstone_limit == 64


def test_engine_with_delta_raises(engines, clustered_data):
    """An engine with a delta serves mutably (the reference's rule); an
    unknown autotune mode still raises."""
    ref = engines[0]
    qs = clustered_data[2]
    meng = MemANNSEngine.from_reference(ref.index, ref.placement, block_n=256, mutable=True,
                                        delta_capacity=64, device="cpu")
    srv = ServingEngine(meng, nprobe=8, k=10, micro_batch=8)
    assert srv.mutable and srv.tombstone_limit == 64
    srv.warmup()
    srv.insert(np.arange(12000, 12024, dtype=np.int32), qs)
    d, i = srv.search(qs)
    np.testing.assert_array_equal(i[:, 0], np.arange(12000, 12024))
    np.testing.assert_array_equal(i, meng.search(qs, nprobe=8, k=10)[1])
    with pytest.raises(ValueError, match="autotune"):
        ServingEngine(engines[1], nprobe=8, k=10, autotune="fast")
