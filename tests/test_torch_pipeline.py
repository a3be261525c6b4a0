"""Pipelined vs serial serving in the port, and the dispatch / collect split:
twins of `tests/test_pipeline.py`, with the engine's `path` swept beside
`scan`.

A ragged 300-query stream of mixed submit / flush / search calls returns
bit-identical (dists, ids) at pipeline depth 0 and 1, on both scans and
both paths, building nothing after warmup.  The load-feedback EWMA updates
at dispatch time, so both depths see the same schedules.  `plan_batch`
takes the reference's arguments (pair and tile capacities, capacity floor,
load carry, prune, live mask) and its plans equal the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _one_thread import one_thread  # noqa: E402,F401
from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro_torch.retrieval import InFlightSearch, MemANNSEngine, ServingEngine  # noqa: E402

SCAN_PATH = [(s, p) for s in ("tiles", "windows") for p in ("gather", "onehot")]


@pytest.fixture(scope="module")
def engines(clustered_data):
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


def _ragged_stream(xs, total=300, seed=13):
    """Deterministic ragged op stream: (op, chunk) covering `total` queries."""
    rng = np.random.default_rng(seed)
    ops, left = [], total
    while left > 0:
        kind = rng.integers(0, 3)
        n = int(min(left, rng.integers(1, 40)))
        q = (
            xs[rng.integers(0, xs.shape[0], n)]
            + rng.normal(0, 0.1, (n, xs.shape[1]))
        ).astype(np.float32)
        if kind == 0:
            ops.append(("search", q))
        elif kind == 1:
            ops.append(("submit", q))
        else:
            ops.append(("submit", q))
            ops.append(("flush", None))
        left -= n
    ops.append(("flush", None))
    return ops


def _drive(srv, ops):
    """Run an op stream; returns the concatenated (dists, ids) outputs."""
    outs_d, outs_i = [], []
    for op, q in ops:
        if op == "search":
            d, i = srv.search(q)
        elif op == "submit":
            srv.submit(q)
            continue
        else:
            d, i = srv.flush()
        if d.shape[0]:
            outs_d.append(d)
            outs_i.append(i)
    return np.concatenate(outs_d), np.concatenate(outs_i)


@pytest.mark.parametrize("scan,path", SCAN_PATH)
def test_pipeline_depth_bit_identical_300_query_stream(engine, clustered_data, scan, path):
    """Depth 0 vs depth 1 over a 300-query mixed submit/flush/search stream:
    bit-identical results, compiles == 0 after warmup."""
    xs, _, _, _ = clustered_data
    eng = dataclasses.replace(engine, scan=scan, path=path)
    ops = _ragged_stream(xs)
    results = {}
    for depth in (0, 1):
        srv = ServingEngine(eng, nprobe=8, k=10, micro_batch=16, pipeline_depth=depth)
        srv.warmup()
        results[depth] = _drive(srv, ops)
        assert srv.stats.compiles == 0, (depth, srv.stats)
        assert srv.stats.queries == 300
        assert len(srv.stats.latencies_s) == srv.stats.batches
        assert srv.stats.rows_scanned > 0
        if depth == 0:
            assert srv.stats.overlap_s == 0.0
        else:
            assert srv.stats.overlap_s > 0.0
            assert 0.0 < srv.stats.overlap_fraction() <= 1.0
    d0, i0 = results[0]
    d1, i1 = results[1]
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)  # bit-identical, not allclose


def test_pipeline_matches_plain_engine_without_feedback(engine, clustered_data):
    """With load feedback off, pipelined serving equals the one-shot engine
    search."""
    xs, _, qs, _ = clustered_data
    srv = ServingEngine(engine, nprobe=8, k=10, micro_batch=8, pipeline_depth=1,
                        load_feedback=False)
    srv.warmup()
    sd, si = srv.search(qs)
    ed, ei = engine.search(qs, nprobe=8, k=10)
    np.testing.assert_array_equal(si, ei)
    np.testing.assert_array_equal(sd, ed)


def test_load_feedback_biases_following_batches(engine, clustered_data):
    """The EWMA carry is updated at dispatch and fed into later plans."""
    xs, _, _, _ = clustered_data
    srv = ServingEngine(engine, nprobe=8, k=10, micro_batch=16)
    srv.warmup()
    assert (srv.load_carry() == 0).all()
    rng = np.random.default_rng(3)
    stream = xs[rng.integers(0, xs.shape[0], 48)].astype(np.float32)
    srv.search(stream)
    carry = srv.load_carry()
    assert carry.shape == (engine.shards.ndev,)
    assert carry.sum() > 0
    assert carry.max() <= max(srv.stats.rows_scanned, 1)


def test_dispatch_collect_composition(engine, clustered_data):
    """dispatch_plan + collect == execute_plan, and the handle's load
    report matches plan_dev_rows."""
    xs, _, qs, _ = clustered_data
    plan = engine.plan_batch(qs, 8)
    handle = engine.dispatch_plan(plan, 10)
    assert isinstance(handle, InFlightSearch)
    assert handle.plan is plan and handle.is_ready()
    np.testing.assert_array_equal(handle.dev_rows, engine.plan_dev_rows(plan))
    hd, hi = engine.collect(handle)
    ed, ei = engine.execute_plan(plan, 10)
    np.testing.assert_array_equal(hi, ei)
    np.testing.assert_array_equal(hd, ed)
    assert handle.dev_rows.shape == (engine.shards.ndev,)
    assert handle.dev_rows.sum() > 0


def test_plan_dev_rows_windows_counts_valid_rows(engine, clustered_data):
    """Windows-path load report = per-device valid rows of scheduled pairs
    (== the schedule's dev_load for integer cluster sizes)."""
    xs, _, qs, _ = clustered_data
    eng = dataclasses.replace(engine, scan="windows")
    plan = eng.plan_batch(qs, 8)
    rows = eng.plan_dev_rows(plan)
    np.testing.assert_array_equal(rows.astype(np.float64), plan.schedule.dev_load)


def test_key_follows_plan_scan_not_engine_scan(engine, clustered_data):
    """A dispatch follows the plan's scan: a plan made before flipping
    `engine.scan` still runs the tiles step; new plans follow the flipped
    scan.  In the port no shape builds anything, so compiles stay 0 either
    way, and the answers agree."""
    xs, _, qs, _ = clustered_data
    eng = dataclasses.replace(engine, scan="tiles")
    srv = ServingEngine(eng, nprobe=8, k=10, micro_batch=16)
    srv.warmup()
    stale = srv._plan_micro_batch(qs[:16])
    assert stale.scan == "tiles"
    eng.scan = "windows"
    handle = srv._dispatch_micro_batch(stale)
    assert handle.plan.scan == "tiles" and handle.plan.tiles_per_dev > 0
    d, i = srv._collect_micro_batch(handle, 16, 0.0)
    assert srv.stats.compiles == 0, srv.stats
    fresh = srv._plan_micro_batch(qs[:16])
    assert fresh.scan == "windows" and fresh.tile_pair is None
    d2, i2 = srv.search(qs[:16])
    assert srv.stats.compiles == 0
    np.testing.assert_array_equal(i[:16], i2[:16])


PLAN_ARGS = {
    "default": dict(), "pairs": dict(pairs_per_dev=512), "floor": dict(capacity_floor=256),
    "unpruned": dict(prune=False), "live": dict(live=np.ones(1, bool)),
    "carry": dict(load_carry=np.array([1.5e4])),
}
PLAN_CASES = [(s, a) for s in ("tiles", "windows") for a in PLAN_ARGS] + [("tiles", "tiles")]
PLAN_ARGS["tiles"] = dict(tiles_per_dev=4096)


@pytest.mark.parametrize("scan,case", PLAN_CASES)
def test_plan_batch_matches_reference(engines, clustered_data, scan, case):
    """`plan_batch` with the reference's arguments: the same plan arrays."""
    ref, port = engines
    qs = clustered_data[2]
    args = PLAN_ARGS[case]
    r = dataclasses.replace(ref, scan=scan).plan_batch(qs, 8, **args)
    t = dataclasses.replace(port, scan=scan).plan_batch(qs, 8, **args)
    assert (r.pairs_per_dev, r.tiles_per_dev, r.n_queries) == (
        t.pairs_per_dev, t.tiles_per_dev, t.n_queries)
    for f in ("pair_q", "pair_slot", "pair_valid", "tile_pair", "tile_block", "tile_row0",
              "pair_lb", "probed_ub", "probed_sizes", "lost_q", "lost_c"):
        a, b = getattr(r, f), getattr(t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_allclose(t.qmc_pairs.numpy(), np.asarray(r.qmc_pairs), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_array_equal(r.query_bounds(10), t.query_bounds(10))
