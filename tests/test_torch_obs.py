"""The port's observability (ROADMAP A12): twins of `tests/test_obs.py`.

`repro_torch.obs.metrics` and `repro_torch.obs.trace` are the reference's
pure-Python registry and tracer, copied: each unit twin feeds the same
values to both packages and holds the port to the reference's own
assertions and to the reference's outputs (quantile bounds, Prometheus
text, Chrome events).  The serving twins run the port's `ServingEngine`
over the reference's trained index: observability on and off give
bit-identical results and build nothing after `warmup()`, every query is in
exactly one recorded batch tree, and the registry's catalog equals the
table of docs/OBSERVABILITY.md (tools/check_metrics_torch.py).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _one_thread import one_thread  # noqa: E402,F401
from repro.obs import metrics as rmetrics  # noqa: E402
from repro.obs import trace as rtrace  # noqa: E402
from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro.retrieval import ServingEngine as RefServing  # noqa: E402
from repro_torch.core.delta import DeltaIndex  # noqa: E402
from repro_torch.obs.metrics import GROWTH, NULL_REGISTRY, Histogram, MetricsRegistry  # noqa: E402
from repro_torch.obs.trace import NULL_TRACER, Tracer  # noqa: E402
from repro_torch.retrieval import MemANNSEngine, ServingEngine  # noqa: E402
from repro_torch.retrieval.serving import PHASES, ServingStats  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NPROBE = 8
K = 10


# ---------------------------------------------------------------------------
# metrics unit twins
# ---------------------------------------------------------------------------


def _true_rank_value(values, q):
    s = sorted(values)
    rank = min(len(s) - 1, max(0, math.ceil(q / 100.0 * len(s)) - 1))
    return s[rank]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantile_enclosure(seed):
    rng = np.random.default_rng(seed)
    values = np.exp(rng.normal(-4, 2, 500))
    h, ref = Histogram(), rmetrics.Histogram()
    for v in values:
        h.observe(float(v))
        ref.observe(float(v))
    rel_budget = math.sqrt(GROWTH) - 1.0 + 1e-9
    for q in (50.0, 90.0, 99.0, 99.9):
        lo, hi = h.quantile_bounds(q)
        truth = _true_rank_value(values, q)
        assert lo <= truth <= hi, (q, lo, truth, hi)
        est = h.quantile(q)
        assert lo <= est <= hi
        assert abs(est - truth) / truth <= rel_budget, (q, est, truth)
        assert (lo, hi) == ref.quantile_bounds(q) and est == ref.quantile(q)


def test_histogram_zero_bucket_and_extrema():
    h, ref = Histogram(), rmetrics.Histogram()
    for v in (-1.0, 0.0, 0.5, 2.0):
        h.observe(v)
        ref.observe(v)
    assert h.count == 4 and h.zero == 2
    assert h.min == -1.0 and h.max == 2.0
    lo, hi = h.quantile_bounds(25.0)
    assert lo <= -1.0 <= hi or hi == 0.0
    assert h.quantile(100.0) <= h.max
    assert (lo, hi) == ref.quantile_bounds(25.0) and h.buckets == ref.buckets


def test_histogram_merge_is_lossless():
    rng = np.random.default_rng(3)
    a_vals = rng.exponential(0.01, 300)
    b_vals = rng.exponential(0.5, 200)
    a, b, both = Histogram(), Histogram(), Histogram()
    for v in a_vals:
        a.observe(float(v))
        both.observe(float(v))
    for v in b_vals:
        b.observe(float(v))
        both.observe(float(v))
    a.merge(b)
    assert a.buckets == both.buckets
    assert a.count == both.count and a.zero == both.zero
    assert a.min == both.min and a.max == both.max
    assert a.sum == pytest.approx(both.sum, rel=1e-12)
    for q in (50.0, 99.0, 99.9):
        assert a.quantile_bounds(q) == both.quantile_bounds(q)
    with pytest.raises(ValueError):
        a.merge(Histogram(growth=2.0))


def test_registry_families_and_labels():
    reg = MetricsRegistry()
    c = reg.counter("upanns_test_total", "help", labels=("scan",))
    c.inc(scan="tiles")
    c.inc(2, scan="tiles")
    c.inc(scan="windows")
    assert c.get(scan="tiles") == 3.0 and c.get(scan="windows") == 1.0
    g = reg.gauge("upanns_test_gauge", "help")
    g.set(0.5)
    assert g.get() == 0.5
    assert reg.counter("upanns_test_total", "help", labels=("scan",)) is c
    assert {n for n, _, _ in reg.catalog()} == {"upanns_test_total", "upanns_test_gauge"}
    with pytest.raises(ValueError):
        reg.gauge("upanns_test_total", "help")


def test_registry_merge_aggregates():
    a, b = MetricsRegistry(), MetricsRegistry()
    for reg, n in ((a, 2), (b, 5)):
        reg.counter("upanns_m_total", "help").inc(n)
        h = reg.histogram("upanns_m_seconds", "help")
        for v in range(1, n + 1):
            h.observe(v * 0.01)
    a.merge(b)
    assert a.families()["upanns_m_total"].get() == 7.0
    assert a.families()["upanns_m_seconds"].labels().count == 7


def test_render_prometheus_escapes_and_quantiles():
    """The port's text and snapshot equal the reference's on the same series."""
    texts = []
    for mod in (rmetrics, sys.modules[MetricsRegistry.__module__]):
        reg = mod.MetricsRegistry()
        reg.counter("upanns_esc_total", "help", labels=("path",)).inc(path='a"b\\c\nd')
        reg.histogram("upanns_esc_seconds", "help").observe(0.25)
        texts.append((reg.render_prometheus(), reg.snapshot()))
    (rtext, rsnap), (text, snap) = texts
    assert '\\"' in text and "\\\\" in text and "\\n" in text
    for frag in ('quantile="0.5"', 'quantile="0.99"', 'quantile="0.999"',
                 "upanns_esc_seconds_sum", "upanns_esc_seconds_count",
                 "# TYPE upanns_esc_total counter"):
        assert frag in text, frag
    json.dumps(snap)
    assert text == rtext and snap == rsnap


def test_null_registry_is_inert():
    s = NULL_REGISTRY.counter("upanns_x_total", "help", labels=("a",))
    s.inc(a="y")
    s.labels(a="y").inc()
    assert s.get(a="y") == 0.0
    h = NULL_REGISTRY.histogram("upanns_y_seconds", "help")
    h.observe(1.0)
    assert h.labels().count == 0
    assert NULL_REGISTRY.catalog() == [] and NULL_REGISTRY.render_prometheus() == ""


# ---------------------------------------------------------------------------
# trace unit twins
# ---------------------------------------------------------------------------


def test_span_tree_nesting_and_export():
    tr = Tracer()
    b = tr.begin_batch(queries=4)
    with tr.span("plan", parent=b):
        with tr.span("schedule", root=False):
            pass
    with tr.span("collect", parent=b):
        pass
    tr.end_batch(b)
    (root,) = tr.roots()
    assert root.name == "batch" and root.args["queries"] == 4
    assert [c.name for c in root.children] == ["plan", "collect"]
    (sched,) = root.children[0].children
    assert sched.name == "schedule"
    for node in root.walk():
        assert node.t1 >= node.t0
        for child in node.children:
            assert child.t0 >= node.t0 - 1e-9 and child.t1 <= node.t1 + 1e-9
    exp = tr.export_chrome()
    xs = [e for e in exp["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"batch", "plan", "schedule", "collect"}
    assert all(e["dur"] >= 0 for e in xs)
    # the reference's tracer over the same tree exports the same events
    rtr = rtrace.Tracer()
    rtr._roots.append(root)
    rexp = rtr.export_chrome()
    assert exp["traceEvents"] == rexp["traceEvents"] and exp["otherData"].keys() == rexp[
        "otherData"].keys()


def test_child_only_spans_evaporate_outside_batch():
    tr = Tracer()
    with tr.span("schedule", root=False):
        pass
    assert tr.roots() == []
    with tr.span("compaction"):
        pass
    assert [s.name for s in tr.roots()] == ["compaction"]


def test_sampling_deterministic_twins():
    def record(tr, n=16):
        picked = []
        for i in range(n):
            b = tr.begin_batch(i=i)
            if b:
                picked.append(i)
            tr.end_batch(b)
        return picked

    a, b = Tracer(sample=0.25), Tracer(sample=0.25)
    pa, pb = record(a), record(b)
    assert pa == pb == record(rtrace.Tracer(sample=0.25))
    assert len(pa) == 4
    assert a.batches_seen == 16 and a.batches_recorded == 4
    assert len(record(Tracer(sample=1.0))) == 16


def test_ring_stays_bounded():
    tr = Tracer(ring=4)
    for i in range(10):
        tr.end_batch(tr.begin_batch(i=i))
    roots = tr.roots()
    assert len(roots) == 4 and [r.args["i"] for r in roots] == [6, 7, 8, 9]
    assert tr.dropped == 6
    tr.clear()
    assert tr.roots() == []


def test_null_tracer_is_inert():
    b = NULL_TRACER.begin_batch(queries=1)
    assert not b
    with NULL_TRACER.span("plan", parent=b) as s:
        s.add("x", 0.0, 1.0)
    NULL_TRACER.end_batch(b)
    assert NULL_TRACER.roots() == []
    assert NULL_TRACER.export_chrome()["traceEvents"] == []


def test_profiler_ranges_bracket_spans():
    """`Tracer(profiler=True)` opens a `torch.profiler.record_function`
    range per recorded span (the reference opens a jax TraceAnnotation)."""
    tr = Tracer(profiler=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        b = tr.begin_batch(queries=1)
        with tr.span("plan", parent=b):
            torch.ones(4).sum()
        tr.end_batch(b)
    names = {e.key for e in prof.key_averages()}
    assert "plan" in names


# ---------------------------------------------------------------------------
# serving integration: zero perturbation + trace completeness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(clustered_data):
    xs, centers, qs, hist = clustered_data
    ref = RefEngine.build(
        jax.random.PRNGKey(0), xs, n_clusters=32, m=8, history_queries=hist,
        use_cooc=False, n_combos=32, block_n=256, kmeans_iters=8, pq_iters=6,
    )
    return ref, MemANNSEngine.from_reference(ref.index, ref.placement, block_n=256,
                                             device="cpu")


@pytest.fixture
def engine(engines):
    return engines[1]


def _ragged_stream(qs, total=200, seed=11):
    rng = np.random.default_rng(seed)
    chunks, left = [], total
    while left:
        n = int(min(left, rng.integers(1, 40)))
        chunks.append(qs[rng.integers(0, qs.shape[0], n)])
        left -= n
    return chunks


@pytest.mark.parametrize("scan", ["tiles", "windows"])
def test_zero_perturbation_ragged_stream(engine, clustered_data, scan):
    """Obs fully on vs fully off over the same 200-query ragged stream:
    bit-identical ids and distances, no build after warmup, and the trace
    accounts for every real query exactly once."""
    qs = clustered_data[2]
    eng = dataclasses.replace(engine, scan=scan)
    tracer = Tracer(sample=1.0)
    srv_on = ServingEngine(eng, nprobe=NPROBE, k=K, micro_batch=16, pipeline_depth=1,
                           tracer=tracer)
    srv_off = ServingEngine(eng, nprobe=NPROBE, k=K, micro_batch=16, pipeline_depth=1,
                            metrics=False)
    srv_on.warmup()
    srv_off.warmup()
    for chunk in _ragged_stream(qs):
        eng.tracer = tracer
        d_on, i_on = srv_on.search(chunk)
        eng.tracer = NULL_TRACER
        d_off, i_off = srv_off.search(chunk)
        np.testing.assert_array_equal(i_on, i_off)
        np.testing.assert_array_equal(d_on, d_off)
    assert srv_on.stats.compiles == 0 and srv_off.stats.compiles == 0
    assert srv_on.stats.queries == 200 and srv_off.stats.queries == 200
    assert srv_off.stats.registry.render_prometheus() == ""
    assert srv_off.stats.latency_percentile(50) >= 0.0

    roots = tracer.roots()
    assert tracer.batches_seen == tracer.batches_recorded == len(roots)
    assert sum(r.args["queries"] for r in roots) == 200
    for r in roots:
        names = [c.name for c in r.children]
        assert names.index("plan") < names.index("dispatch") < names.index("collect"), names
        assert r.args["scan"] == scan
        plan = r.children[names.index("plan")]
        want = ["schedule", "densify"] + (["emit_tiles"] if scan == "tiles" else [])
        assert [c.name for c in plan.children] == want
        for node in r.walk():
            assert node.t1 >= node.t0
    st = srv_on.stats
    assert st.m_queries.get() == 200.0
    assert st.m_batches.get(scan=scan) == len(roots)
    assert st.m_latency.labels().count == len(roots)


def test_histogram_backed_percentiles(engine, clustered_data):
    qs = clustered_data[2]
    srv = ServingEngine(engine, nprobe=NPROBE, k=K, micro_batch=8)
    srv.warmup()
    for _ in range(3):
        srv.search(qs)
    st = srv.stats
    h = st.m_latency.labels()
    assert h.count == st.batches > 0
    lo, hi = h.quantile_bounds(50.0)
    assert lo <= st.latency_percentile(50) <= hi
    assert st.p50_s() <= st.p99_s() + 1e-12
    assert st.p999_s() >= st.p99_s() - 1e-12
    deque_p50 = float(np.percentile(np.asarray(st.latencies_s), 50))
    assert st.latency_percentile(50) == pytest.approx(
        deque_p50, rel=2 * (math.sqrt(GROWTH) - 1) + 0.01)


def test_pipelined_wait_attribution(engine, clustered_data):
    qs = clustered_data[2]
    srv = ServingEngine(engine, nprobe=NPROBE, k=K, micro_batch=8, pipeline_depth=1)
    srv.warmup()
    for _ in range(3):
        srv.search(qs)
    st = srv.stats
    assert st.compiles == 0
    for p in ("plan", "dispatch", "dispatch_wait", "collect_wait"):
        assert st.m_phase.labels(phase=p).count > 0, p
    assert st.dispatch_wait_s >= 0.0 and st.collect_wait_s > 0.0
    assert st.phase_seconds("dispatch_wait") == pytest.approx(st.dispatch_wait_s)
    assert sum(st.phase_seconds(p) for p in PHASES) > 0.0


def test_mutable_churn_twin(engines, clustered_data):
    """Obs on vs off under mutable churn (inserts + deletes + compaction):
    identical results, no build, a compaction span tree, and the same
    mutation counters as the reference's server on the same stream."""
    xs, centers, qs, hist = clustered_data
    ref = engines[0]
    base = MemANNSEngine.from_reference(ref.index, ref.placement, block_n=256, mutable=True,
                                        delta_capacity=1024, freqs=ref.freqs, device="cpu")
    rng = np.random.default_rng(5)
    new_vecs = (centers[rng.integers(0, 32, 96)]
                + rng.normal(0, 1, (96, 32)).astype(np.float32)).astype(np.float32)
    new_ids = np.arange(12000, 12096)

    tracer = Tracer(sample=1.0)
    outs = []
    for obs_on in (True, False):
        eng = dataclasses.replace(base, delta=DeltaIndex.create(base.index.m, 1024),
                                  _dev_arrays=None)
        srv = ServingEngine(eng, nprobe=NPROBE, k=K, micro_batch=8, mutable=True,
                            tracer=tracer if obs_on else None, metrics=obs_on)
        srv.warmup()
        step = []
        for r in range(3):
            srv.insert(new_ids[r * 32:(r + 1) * 32], new_vecs[r * 32:(r + 1) * 32])
            srv.delete(np.arange(r * 10, r * 10 + 10))
            step.append(srv.search(qs[:16]))
        srv.compact()
        step.append(srv.search(qs[:16]))
        assert srv.stats.compiles == 0, srv.stats
        outs.append(step)
        if obs_on:
            assert srv.stats.inserts == 96 and srv.stats.deletes == 30
            assert srv.stats.m_inserts.get() == 96.0
            assert srv.stats.m_compactions.get() == 1.0
            assert srv.stats.m_tombstones.get() == 0.0
            snap = srv.stats.snapshot()
    for (d_on, i_on), (d_off, i_off) in zip(*outs):
        np.testing.assert_array_equal(i_on, i_off)
        np.testing.assert_array_equal(d_on, d_off)
    comp = [r for r in tracer.roots() if r.name == "compaction"]
    assert len(comp) == 1
    assert {"compact_index", "update_placement", "update_shards"} <= {
        c.name for c in comp[0].children}
    batches = [r for r in tracer.roots() if r.name == "batch"]
    # three churned searches of two batches each scan the delta; the search
    # after the compaction does not
    assert [{"delta", "merge"} <= {c.name for c in r.children} for r in batches] == (
        [True] * 6 + [False] * 2)
    # the reference's server on the same stream counts the same mutations
    from repro.core.delta import DeltaIndex as RefDelta

    reng = RefEngine.build(
        jax.random.PRNGKey(0), xs, n_clusters=32, m=8, history_queries=hist,
        use_cooc=False, n_combos=32, block_n=256, kmeans_iters=8, pq_iters=6,
        mutable=True, delta_capacity=1024,
    )
    reng = dataclasses.replace(reng, delta=RefDelta.create(reng.index.m, 1024))
    rsrv = RefServing(reng, nprobe=NPROBE, k=K, micro_batch=8, mutable=True, autotune="off")
    rsrv.warmup()
    for r in range(3):
        rsrv.insert(new_ids[r * 32:(r + 1) * 32], new_vecs[r * 32:(r + 1) * 32])
        rsrv.delete(np.arange(r * 10, r * 10 + 10))
        rd, ri = rsrv.search(qs[:16])
        np.testing.assert_array_equal(outs[0][r][1], ri)
    rsrv.compact()
    rsnap = rsrv.stats.snapshot()
    for fam in ("upanns_mutation_inserts_total", "upanns_mutation_deletes_total",
                "upanns_compactions_total", "upanns_tombstones", "upanns_delta_occupancy",
                "upanns_starved_batches_total"):
        assert snap[fam]["samples"] == rsnap[fam]["samples"], fam


def test_serving_registry_renders_scrapable(engine, clustered_data):
    qs = clustered_data[2]
    srv = ServingEngine(engine, nprobe=NPROBE, k=K, micro_batch=8)
    srv.warmup()
    srv.search(qs)
    text = srv.stats.registry.render_prometheus()
    assert "# TYPE upanns_serving_queries_total counter" in text
    assert f"upanns_serving_queries_total {len(qs)}" in text
    assert "upanns_phase_seconds" in text
    snap = srv.stats.snapshot()
    json.dumps(snap)
    assert snap["upanns_serving_compiles_total"]["samples"][0]["value"] == 0.0


def test_catalog_equals_reference_and_docs():
    """The port's `ServingStats` registers the reference's families (name,
    type, labels), which are the 30 of docs/OBSERVABILITY.md."""
    from repro.retrieval.serving import ServingStats as RefStats

    cat = set(ServingStats().registry.catalog())
    assert cat == set(RefStats().registry.catalog()) and len(cat) == 30
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "check_metrics_torch.py")],
                         capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "30 families, ok" in out.stdout
