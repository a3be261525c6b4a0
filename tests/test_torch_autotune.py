"""Kernel-geometry autotuning in the port: twins of tests/test_autotune.py.

Three contracts (`repro_torch/core/autotune.py`):

  * geometry invariance -- `block_n` (a retile), `rerank_block` (B3's
    candidates a thread block) and `tile_floor` change no bit: every cell
    of scan x prune x rerank returns the same (d, i) at two non-default
    geometries, on plain and on co-occurrence shards (a pair's top-k is the
    k smallest by (distance, row), wherever the tile boundaries fall);
  * cache lifecycle -- a sweep persists to a versioned JSON cache that
    round-trips, ignores stale versions, and turns every later resolve into
    a 0-candidate hit; a candidate inside the timing's spread never moves
    a knob off its current value;
  * serving -- `ServingEngine(autotune=...)` applies the geometry before
    warmup, so tuned serving builds nothing after it.

The engines are the port's over indexes and placements the reference
trained (`from_reference`).  Each retiled cell is held to the reference's
engine retiled to the same tile height and floor (ids equal, distances
allclose at rtol = atol = 1e-5, the parity contract's) and, inside the
port, to its own untuned answer bit for bit.
"""

import dataclasses
import itertools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _one_thread import one_thread  # noqa: E402,F401
from repro.core.autotune import KernelGeometry as RefGeometry  # noqa: E402
from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch.core.autotune import (  # noqa: E402
    CACHE_VERSION,
    KernelGeometry,
    autotune_engine,
    cache_path,
    engine_key,
    load_cache,
    load_defaults,
    save_cache,
)
from repro_torch.retrieval import MemANNSEngine, ServingEngine  # noqa: E402

NPROBE = 8
K = 10
TOL = dict(rtol=1e-5, atol=1e-5)

SCANS = ("tiles", "windows")
BOOLS = (False, True)
RERANKS = ("off", "exact")

# block_n 256 is the build's; the wall retiles down (more boundaries) and
# up (boundaries move), each with a non-default B3 block and a tile floor,
# clamped to the tile-bucket ladder: at 128 it doubles the 24 queries' tile
# queue (1024 -> 2048 on this data), at 512 the ladder's top is the queue's
# own size.  The reference takes the same tile height and floor; its
# `rerank_block` is in its own unit (LANE multiples, its test's values),
# the port's in candidates a block
GEOMETRIES = (
    (KernelGeometry(block_n=128, rerank_block=16, tile_floor=4096),
     RefGeometry(block_n=128, rerank_block=64, tile_floor=4096)),
    (KernelGeometry(block_n=512, rerank_block=32, tile_floor=4096),
     RefGeometry(block_n=512, rerank_block=256, tile_floor=4096)),
)


def _pair(clustered_data, **kw):
    """The reference's engine (its own training) and the port's over its
    index and placement, both at block_n 256 under the exact re-rank."""
    xs, _, _, hist = clustered_data
    cooc = dict(use_cooc=kw.pop("use_cooc", False), n_combos=32)
    ref = RefEngine.build(
        jax.random.PRNGKey(0), xs, n_clusters=32, m=8, history_queries=hist,
        block_n=256, rerank="exact", k_overfetch=64, store_raw=True, **cooc, **kw,
    )
    port = MemANNSEngine.from_reference(
        ref.index, ref.placement, xs, block_n=256, rerank="exact", k_overfetch=64,
        device="cpu", **cooc, **{k: v for k, v in kw.items() if k in (
            "mutable", "delta_capacity")},
    )
    return ref, port


@pytest.fixture(scope="module")
def pairs(clustered_data):
    return {
        "cooc": _pair(clustered_data, use_cooc=True, kmeans_iters=8, pq_iters=6),
        "plain": _pair(clustered_data, kmeans_iters=8, pq_iters=6),
    }


@pytest.fixture(scope="module")
def base(pairs, clustered_data):
    return pairs["cooc"][1], clustered_data[2]


def _cells(eng):
    for scan, prune, rerank in itertools.product(SCANS, BOOLS, RERANKS):
        yield (scan, prune, rerank), dataclasses.replace(eng, scan=scan, prune=prune,
                                                         rerank=rerank)


def _close(got, want, msg):
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"ids {msg}")
    np.testing.assert_allclose(got[0], want[0], **TOL, err_msg=f"dists {msg}")


@pytest.mark.parametrize("shards", ["cooc", "plain"])
def test_geometry_invariance_wall(pairs, clustered_data, shards):
    """Every scan x prune x rerank cell at every geometry answers as the
    reference's engine retiled alike, and bit for bit as the port's own
    untuned cell, on co-occurrence and on plain shards."""
    ref, eng = pairs[shards]
    qs = clustered_data[2]
    assert (eng.shards.n_combos > 0) == (shards == "cooc")
    own = {key: cell.search(qs, nprobe=NPROBE, k=K) for key, cell in _cells(eng)}
    assert eng.shards.block_n == ref.shards.block_n == 256
    try:
        for geo, ref_geo in GEOMETRIES:
            codes_before = eng.shards.codes
            assert eng.apply_geometry(geo) and ref.apply_geometry(ref_geo)
            assert eng.shards.block_n == ref.shards.block_n == geo.block_n
            assert eng.shards.codes is not codes_before and eng._dev_arrays is None
            assert eng.geometry() == geo
            np.testing.assert_array_equal(eng.shards.slot_start, ref.shards.slot_start)
            assert (eng.plan_batch(qs, NPROBE).tiles_per_dev
                    == ref.plan_batch(qs, NPROBE).tiles_per_dev)
            for (key, cell), (_, ref_cell) in zip(_cells(eng), _cells(ref)):
                got = cell.search(qs, nprobe=NPROBE, k=K)
                _close(got, ref_cell.search(qs, nprobe=NPROBE, k=K),
                       f"against the reference at {geo} cell {key}")
                np.testing.assert_array_equal(got[1], own[key][1],
                                              err_msg=f"ids at {geo} cell {key}")
                np.testing.assert_array_equal(got[0], own[key][0],
                                              err_msg=f"dists at {geo} cell {key}")
    finally:
        eng.apply_geometry(KernelGeometry(block_n=256))
        ref.apply_geometry(RefGeometry(block_n=256))


def test_tile_floor_invariance(pairs, clustered_data):
    """A raised tile-capacity floor pads with dummy tiles, never results;
    it is clamped to the tile-bucket ladder, to the reference's capacity.
    At block_n 128, where the floor raises this batch's queue."""
    ref, eng = pairs["cooc"]
    qs = clustered_data[2]
    try:
        eng.apply_geometry(KernelGeometry(block_n=128))
        ref.apply_geometry(RefGeometry(block_n=128))
        d0, i0 = eng.search(qs, nprobe=NPROBE, k=K)
        plan0 = eng.plan_batch(qs, NPROBE)
        eng.apply_geometry(KernelGeometry(block_n=128, tile_floor=4096))
        ref.apply_geometry(RefGeometry(block_n=128, tile_floor=4096))
        d1, i1 = eng.search(qs, nprobe=NPROBE, k=K)
        plan1 = eng.plan_batch(qs, NPROBE)
        want = ref.search(qs, nprobe=NPROBE, k=K)
        ref_tiles = ref.plan_batch(qs, NPROBE).tiles_per_dev
        w = eng.shards.window // eng.shards.block_n
        ladder = plan1.pairs_per_dev * (1 << max(w - 1, 0).bit_length())
    finally:
        eng.apply_geometry(KernelGeometry(block_n=256))
        ref.apply_geometry(RefGeometry(block_n=256))
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)
    _close((d1, i1), want, "against the reference at tile_floor 4096")
    assert plan0.tiles_per_dev < plan1.tiles_per_dev == ref_tiles == ladder


def test_block_n_zero_inherits(base):
    """block_n=0 is the inherit sentinel: no retile, knobs still applied."""
    eng, _ = base
    before = eng.shards
    assert not eng.apply_geometry(KernelGeometry(block_n=0, rerank_block=16))
    assert eng.shards is before
    assert eng.rerank_block == 16
    eng.apply_geometry(KernelGeometry(rerank_block=0))


def test_cache_roundtrip(tmp_path):
    entries = {"cpu|w8x1raw|m8|rows4096|k16|rerank-off": {
        "block_n": 512, "rerank_block": 32, "tile_floor": 0}}
    path = save_cache("cpu", entries, str(tmp_path))
    assert os.path.basename(path) == f"autotune-cpu-v{CACHE_VERSION}.json"
    assert load_cache("cpu", str(tmp_path)) == entries
    save_cache("cpu", {"other|key": {"block_n": 128}}, str(tmp_path))
    merged = load_cache("cpu", str(tmp_path))
    assert set(merged) == set(entries) | {"other|key"}
    geo = KernelGeometry.from_dict(merged[next(iter(entries))])
    assert geo == KernelGeometry(block_n=512, rerank_block=32)
    # the port's cache lives under its own directory, never the reference's
    assert os.path.join(".cache", "repro_torch") in cache_path("cuda")


def test_stale_version_invalidated(tmp_path):
    """A cache document from another version is ignored, not applied."""
    save_cache("cpu", {"k": {"block_n": 512}}, str(tmp_path))
    p = cache_path("cpu", str(tmp_path))
    with open(p) as f:
        doc = json.load(f)
    doc["version"] = CACHE_VERSION - 1
    with open(p, "w") as f:
        json.dump(doc, f)
    assert load_cache("cpu", str(tmp_path)) == {}
    with open(p, "w") as f:
        f.write("{not json")
    assert load_cache("cpu", str(tmp_path)) == {}


def test_defaults_are_inherit_on_cpu():
    """The in-repo CPU default is the no-op sentinel (the plain versions'
    geometry was never measured), and no other backend's row holds a
    geometry the port did not measure (cuda: block_n 0 unless a sweep on
    the card said otherwise)."""
    geo = load_defaults("cpu")
    assert geo is not None and geo.block_n == 0
    cuda = load_defaults("cuda")
    assert cuda is not None and cuda.block_n in (0, 256, 512, 1024)
    assert load_defaults("tpu") is None


def test_sweep_persists_then_cache_hits(base, tmp_path):
    eng, _ = base
    try:
        geo, rep = autotune_engine(eng, K, mode="sweep", cache_dir=str(tmp_path),
                                   block_ns=(128, 256), rerank_blocks=(16,))
        assert rep["source"] == "sweep" and rep["swept"] == 4
        assert set(rep["timings"]["batch_s"]) == {"128", "256"}
        assert eng.shards.block_n == 256  # timed on retiles, then put back
        assert set(rep["timings"]["rerank_s"]) == {"0", "16"}
        assert geo is not None and geo.block_n in (128, 256) and geo.rerank_block in (0, 16)
        key = engine_key(eng, K)
        assert key in load_cache("cpu", str(tmp_path))
        eng.apply_geometry(geo)
        assert engine_key(eng, K) == key  # a retile keeps the key
        for mode in ("sweep", "cache"):
            geo2, rep2 = autotune_engine(eng, K, mode=mode, cache_dir=str(tmp_path))
            assert rep2["source"] == "cache" and rep2["swept"] == 0
            assert geo2 == geo
    finally:
        eng.apply_geometry(KernelGeometry(block_n=256))


def test_sweep_keeps_current_within_margin(base, tmp_path, monkeypatch):
    """A candidate faster than the current value by less than
    `SWEEP_MARGIN` (the synthetic timing's run-to-run spread) moves no
    knob, and the kept geometry is what persists; a clear winner moves it."""
    eng, _ = base
    scan = {128: 0.95, 256: 1.0, 512: 0.92}
    rerank = {0: 1.0, 16: 0.91, 32: 0.95}
    monkeypatch.setattr(autotune, "_time_batch", lambda e, bn, *a: scan[bn])
    monkeypatch.setattr(autotune, "_time_rerank", lambda e, bk, *a: rerank[bk])
    grid = dict(block_ns=(128, 512), rerank_blocks=(16, 32))
    geo, rep = autotune.sweep_engine(eng, K, **grid)
    assert geo == KernelGeometry(block_n=256) and rep["margin"] == autotune.SWEEP_MARGIN
    geo, rep = autotune_engine(eng, K, mode="sweep", cache_dir=str(tmp_path), **grid)
    assert rep["source"] == "sweep" and geo == KernelGeometry(block_n=256)
    assert KernelGeometry.from_dict(load_cache("cpu", str(tmp_path))[rep["key"]]) == geo
    assert not eng.apply_geometry(geo)
    scan[128], rerank[32] = 0.85, 0.85
    geo, _ = autotune.sweep_engine(eng, K, **grid)
    assert geo == KernelGeometry(block_n=128, rerank_block=32)


def test_autotune_off_returns_nothing(base):
    eng, _ = base
    geo, rep = autotune_engine(eng, K, mode="off")
    assert geo is None and rep["source"] == "off" and rep["swept"] == 0


def test_serving_warm_from_cache_zero_compiles(base, tmp_path):
    """A cached non-default geometry retiles at warmup and then serves with
    no build after warmup; the answers are the untuned server's."""
    eng, qs = base
    srv_ref = ServingEngine(eng, nprobe=NPROBE, k=K, micro_batch=8, autotune="off")
    srv_ref.warmup()
    d0, i0 = srv_ref.search(qs)
    save_cache("cpu", {engine_key(eng, K): {"block_n": 128, "rerank_block": 16}},
               str(tmp_path))
    srv = ServingEngine(eng, nprobe=NPROBE, k=K, micro_batch=8, autotune="cache",
                        autotune_cache_dir=str(tmp_path))
    srv.warmup()
    try:
        rep = srv.autotune_report
        assert rep["source"] == "cache" and rep["retiled"]
        assert srv.tuned_geometry() == {"block_n": 128, "rerank_block": 16, "tile_floor": 0}
        d1, i1 = srv.search(qs)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(d0, d1)
        assert srv.stats.compiles == 0
    finally:
        eng.apply_geometry(KernelGeometry(block_n=256))


def test_serving_default_mode_is_noop_on_cpu(base, tmp_path):
    """autotune='cache' with an empty cache resolves the CPU default
    (inherit): no retile, no change."""
    eng, qs = base
    srv = ServingEngine(eng, nprobe=NPROBE, k=K, micro_batch=8,
                        autotune_cache_dir=str(tmp_path))
    srv.warmup()
    rep = srv.autotune_report
    assert rep["source"] == "defaults" and not rep.get("retiled")
    assert eng.shards.block_n == 256
    srv.search(qs)
    assert srv.stats.compiles == 0


def test_serving_rejects_bad_mode(base):
    eng, _ = base
    with pytest.raises(ValueError):
        ServingEngine(eng, nprobe=NPROBE, k=K, autotune="always")
    with pytest.raises(ValueError):
        autotune_engine(eng, K, mode="always")


def test_mutable_retile_keeps_delta_answers(clustered_data):
    """A mutable engine with live inserts and tombstones retiles with the
    slack of its new tile height (the reference's layout) and answers as
    before and as the reference's retiled alike."""
    xs, centers, qs, _ = clustered_data
    ref, eng = _pair(clustered_data, kmeans_iters=4, pq_iters=3, mutable=True,
                     delta_capacity=256)
    ids = np.arange(12000, 12024, dtype=np.int32)
    for e in (ref, eng):
        e.insert(ids, qs)
        e.delete(np.arange(0, 600, 7))
    d0, i0 = eng.search(qs, NPROBE, K)
    assert eng.apply_geometry(KernelGeometry(block_n=128, rerank_block=16))
    assert ref.apply_geometry(RefGeometry(block_n=128, rerank_block=64))
    assert eng.shards.window == ref.shards.window and eng.shards.window % 128 == 0
    np.testing.assert_array_equal(eng.shards.slot_start, ref.shards.slot_start)
    d1, i1 = eng.search(qs, NPROBE, K)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(i1[:, 0], ids)
    _close((d1, i1), ref.search(qs, NPROBE, K), "against the reference at block_n 128")


def test_attach_raw_store_backs_the_cascade(base, clustered_data):
    """`attach_raw_store` gives an engine built without a store the one
    `build(rerank="exact")` packs: the same rows, the same answers."""
    eng, qs = base
    bare = dataclasses.replace(eng, raw=None)
    with pytest.raises(ValueError, match="raw-vector store"):
        bare.search(qs, NPROBE, K)
    raw = bare.attach_raw_store(clustered_data[0])
    assert bare.raw is raw and torch.equal(raw.vectors, eng.raw.vectors)
    for a, b in zip(bare.search(qs, NPROBE, K), eng.search(qs, NPROBE, K)):
        np.testing.assert_array_equal(a, b)
