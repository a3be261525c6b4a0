"""The port's mutable engine (insert, delete, search, compact) against the
reference, and its invariants.

The reference `MemANNSEngine` is built mutable on the shared
`clustered_data` fixture (one CPU device, Pallas in interpret mode); its
trained index and placement are carried into the port with
`MemANNSEngine.from_reference(..., mutable=True)`.  Engine-level twins of
`tests/test_mutation.py` (those that need no `ServingEngine`): inserts are
visible to the next search, deletes filter at once, buffered inserts can be
deleted, tombstoned ids cannot be reinserted, and compaction equals a
from-scratch re-encode + placement + packing of the survivors (and the
reference's compaction).  The 16 mutable cells of
`tests/test_feature_matrix.py` (scan x cooc x prune x rerank, the same
delta contents) are held against the reference's unpruned windows cell of
the same encoding and re-rank (ids equal outside exact ties, distances
allclose rtol = atol = 1e-5) and, inside the port, against the port's own
unpruned windows cell bit for bit.  A reference checkpoint with a delta
(`checkpoint.load_index`) serves the reference's answers.  The
churn twins need `ServingEngine` (ROADMAP queue A item 7).
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import save_index  # noqa: E402
from repro.core.delta import DeltaIndex as RefDelta  # noqa: E402
from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro_torch.checkpoint import load_index  # noqa: E402
from repro_torch.convert import load_index_dir  # noqa: E402
from repro_torch.core.delta import DeltaIndex  # noqa: E402
from repro_torch.core.index import encode_index  # noqa: E402
from repro_torch.core.placement import place_clusters  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.retrieval import mutation  # noqa: E402
from repro_torch.retrieval.engine import MemANNSEngine  # noqa: E402
from repro_torch.retrieval.layout import build_shards  # noqa: E402

NPROBE, K, BLOCK_N, N0 = 8, 10, 256, 12000
TOL = dict(rtol=1e-5, atol=1e-5)
DELTA_CAP = 256
BOOLS = (False, True)
SCANS = ("tiles", "windows")
RERANKS = ("off", "exact")


@pytest.fixture(scope="module")
def ref_engines(clustered_data):
    """The reference's mutable engines, plain and co-occurrence, as the
    feature matrix builds them."""
    xs, _, _, hist = clustered_data
    return {
        cooc: RefEngine.build(
            jax.random.PRNGKey(0), xs, n_clusters=32, m=8, history_queries=hist,
            use_cooc=cooc, n_combos=32, block_n=BLOCK_N, kmeans_iters=8, pq_iters=6,
            mutable=True, delta_capacity=DELTA_CAP, rerank="off", k_overfetch=64,
            store_raw=True,
        )
        for cooc in BOOLS
    }


@pytest.fixture(scope="module")
def port_engines(ref_engines, clustered_data):
    xs = clustered_data[0]
    return {
        cooc: MemANNSEngine.from_reference(
            r.index, r.placement, xs, block_n=BLOCK_N, use_cooc=cooc, n_combos=32,
            mutable=True, delta_capacity=DELTA_CAP, k_overfetch=64, freqs=r.freqs,
            device="cpu",
        )
        for cooc, r in ref_engines.items()
    }


def fresh(port_engines, cooc=False, capacity=2048, **kw):
    """A copy of the port engine with an empty delta (the raw store is
    copied when the test compacts, since compaction appends to it)."""
    eng = port_engines[cooc]
    raw = eng.raw
    if kw.pop("own_raw", False):
        raw = dataclasses.replace(raw, vectors=raw.vectors.clone(), id_dev=raw.id_dev.clone(),
                                  id_row=raw.id_row.clone(), used=raw.used.copy(),
                                  capacity=raw.capacity.copy())
    return dataclasses.replace(eng, delta=DeltaIndex.create(eng.index.m, capacity), raw=raw,
                               _dev_arrays=None, **kw)


def _mutations(centers, seed=7, n_ins=48, n_del=16):
    rng = np.random.default_rng(seed)
    ids = np.arange(N0, N0 + n_ins, dtype=np.int64)
    vecs = (centers[rng.integers(0, len(centers), n_ins)]
            + rng.normal(0, 1.0, (n_ins, centers.shape[1]))).astype(np.float32)
    dels = rng.choice(N0, size=n_del, replace=False).astype(np.int64)
    return ids, vecs, dels


def _same_ids_outside_ties(d, i_a, i_b):
    for row_d, a, b in zip(d, i_a, i_b):
        for v in np.unique(row_d):
            assert set(a[row_d == v]) == set(b[row_d == v])


# ---------------------------------------------------------------------- #
# engine-level twins of tests/test_mutation.py
# ---------------------------------------------------------------------- #


def test_insert_visible_immediately(port_engines, clustered_data):
    qs = clustered_data[2]
    eng = fresh(port_engines)
    new_ids = np.arange(N0, N0 + qs.shape[0], dtype=np.int32)
    assert eng.insert(new_ids, qs) == qs.shape[0]
    assert eng.mutation_active
    _, ids = eng.search(qs, NPROBE, K)
    np.testing.assert_array_equal(ids[:, 0], new_ids)


def test_delete_filters_results(port_engines, clustered_data):
    qs = clustered_data[2]
    eng = fresh(port_engines)
    _, ids0 = eng.search(qs, NPROBE, K)
    victims = np.unique(ids0[:, 0])
    assert eng.delete(victims) == victims.size
    _, ids1 = eng.search(qs, NPROBE, K)
    assert not np.isin(ids1, victims).any()
    assert (ids1 >= 0).all()  # the overfetch keeps full rows


def test_delete_of_buffered_insert(port_engines, clustered_data):
    qs = clustered_data[2]
    eng = fresh(port_engines, own_raw=True, rerank="exact")
    new_ids = np.arange(N0, N0 + qs.shape[0], dtype=np.int32)
    eng.insert(new_ids, qs)
    eng.delete(new_ids[:10])
    _, ids = eng.search(qs, NPROBE, K)
    assert not np.isin(ids, new_ids[:10]).any()
    np.testing.assert_array_equal(ids[10:, 0], new_ids[10:])
    eng.compact()
    _, ids2 = eng.search(qs, NPROBE, K)
    assert not np.isin(ids2, new_ids[:10]).any()
    np.testing.assert_array_equal(ids2[10:, 0], new_ids[10:])


@pytest.mark.parametrize("rerank", RERANKS)
def test_mutable_search_laps(port_engines, clustered_data, rerank):
    """`mutable_search(timings=...)` times each stage and counts each
    stage's kernel launches (none on the CPU: the wrappers count only the
    kernels they launch), and answers as `search` does."""
    qs = clustered_data[2]
    eng = fresh(port_engines, rerank=rerank)
    ids, vecs, dels = _mutations(clustered_data[1])
    eng.insert(ids, vecs)
    eng.delete(dels)
    lap = {}
    got = mutation.mutable_search(eng, qs, NPROBE, K, timings=lap)
    stages = ["main_ms", "delta_scan_ms"] + (["delta_rerank_ms"] if rerank == "exact" else [])
    stages.append("merge_ms")
    assert list(lap.pop("launches")) == stages == list(lap)
    assert all(v >= 0.0 for v in lap.values())
    want = eng.search(qs, NPROBE, K)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_reinsert_of_tombstoned_id_rejected(port_engines, clustered_data):
    qs = clustered_data[2]
    eng = fresh(port_engines)
    eng.delete(np.asarray([3]))
    with pytest.raises(ValueError, match="tombstoned"):
        eng.insert(np.asarray([3]), qs[:1])


def _scratch(eng, xs_surv, ids_surv, cooc=False):
    """From-scratch rebuild over the survivors with the same trained
    centroids and codebook: encode + place + pack, no incremental path."""
    idx = encode_index(eng.index.centroids, eng.index.codebook, xs_surv, ids_surv,
                       device="cpu")
    pl = place_clusters(idx.cluster_sizes().astype(np.float64), eng.freqs, eng.ndev,
                        centroids=idx.centroids)
    sh = build_shards(idx, pl, use_cooc=cooc, n_combos=32, block_n=eng.shards.block_n,
                      device="cpu")
    return MemANNSEngine(index=idx, placement=pl, shards=sh, device=eng.device, scan=eng.scan)


@pytest.mark.parametrize("cooc", BOOLS)
def test_compaction_matches_scratch_rebuild(port_engines, ref_engines, clustered_data, cooc):
    """insert + delete + compact == a from-scratch re-encode (index arrays
    and search results), and == the reference's compaction."""
    xs, centers, qs, _ = clustered_data
    eng = fresh(port_engines, cooc=cooc, own_raw=True)
    ref = dataclasses.replace(ref_engines[cooc], delta=RefDelta.create(8, 2048),
                              raw=None, _dev_arrays=None)
    rng = np.random.default_rng(5)
    new_ids = np.arange(N0, N0 + 300, dtype=np.int32)
    new_xs = (centers[rng.integers(0, 32, 300)]
              + rng.normal(0, 1, (300, 32))).astype(np.float32)
    victims = rng.choice(N0, 80, replace=False)
    for e in (eng, ref):
        e.insert(new_ids, new_xs)
        e.delete(victims)
    rep = eng.compact()
    ref.compact()
    assert rep.merged == 300 and rep.dropped == 80
    assert not eng.mutation_active
    keep = ~np.isin(np.arange(N0), victims)
    scratch = _scratch(eng, np.concatenate([xs[keep], new_xs]),
                       np.concatenate([np.arange(N0)[keep], new_ids]), cooc)
    for f in ("codes", "vec_ids", "offsets"):
        np.testing.assert_array_equal(getattr(eng.index, f), getattr(scratch.index, f))
        np.testing.assert_array_equal(getattr(eng.index, f), getattr(ref.index, f))
    for f in ("vec_ids", "slot_start", "slot_size", "slot_cluster", "combo_addrs"):
        np.testing.assert_array_equal(getattr(eng.shards, f), getattr(ref.shards, f))
    np.testing.assert_array_equal(np.asarray(eng.shards.codes), ref.shards.codes)
    d_c, i_c = eng.search(qs, NPROBE, K)
    d_r, i_r = scratch.search(qs, NPROBE, K)
    np.testing.assert_array_equal(i_c, i_r)
    np.testing.assert_array_equal(d_c, d_r)


def test_csr_invariant_validate(port_engines):
    idx = port_engines[False].index
    idx.validate()
    with pytest.raises(ValueError, match="offsets"):
        dataclasses.replace(idx, offsets=idx.offsets[:-1]).validate()
    with pytest.raises(ValueError, match="duplicate"):
        dataclasses.replace(idx, vec_ids=np.zeros_like(idx.vec_ids)).validate()


def test_compaction_report_fields(port_engines, clustered_data):
    qs = clustered_data[2]
    eng = fresh(port_engines, own_raw=True, rerank="exact")
    rep0 = eng.compact()
    assert rep0.merged == 0 and rep0.devices_rewritten == 0
    assert set(rep0.stage_seconds) == set(mutation.STAGES)
    eng.insert(np.asarray([N0], np.int32), qs[:1])
    rep = eng.compact()
    assert rep.merged == 1 and rep.clusters_changed == 1
    assert rep.devices_rewritten >= 1
    assert not rep.shapes_changed  # the build slack absorbed one row
    assert "compaction" in rep.summary()
    assert set(rep.stage_seconds) == set(mutation.STAGES)
    assert all(v >= 0.0 for v in rep.stage_seconds.values())
    assert rep.stage_seconds["update_raw_store"] > 0.0


def test_compaction_equals_mutable_search_rerank_off(port_engines, clustered_data):
    """The compacted engine, re-rank off, equals its own mutable search
    before compaction (distances bit-equal, ids outside exact ties); with
    the re-rank on, the inserted rows are re-scored from the raw store
    after the compaction (each insert finds itself at distance 0)."""
    xs, centers, qs, _ = clustered_data
    eng = fresh(port_engines, own_raw=True, rerank="exact")
    ids, vecs, dels = _mutations(centers, seed=21, n_ins=120, n_del=40)
    eng.insert(ids, vecs)
    eng.delete(dels)
    pre = dataclasses.replace(eng, rerank="off").search(qs, NPROBE, K)
    rep = eng.compact()
    assert not rep.shapes_changed
    post = dataclasses.replace(eng, rerank="off").search(qs, NPROBE, K)
    np.testing.assert_array_equal(pre[0], post[0])
    _same_ids_outside_ties(pre[0], pre[1], post[1])
    d, i = eng.search(vecs[:16], NPROBE, K)
    np.testing.assert_array_equal(i[:, 0], ids[:16])
    np.testing.assert_array_equal(d[:, 0], np.zeros(16, np.float32))


def test_fetch_depth_limit_c5(port_engines, clustered_data):
    """ROADMAP C5: under the exact re-rank the main path fetches the pow2
    bucket of k' + tombstones; past SCAN_K_MAX (about 4032 tombstones at
    k' = 64) the port raises ValueError naming C5, on the CPU as on the
    card, and never returns a short result; compaction lifts it."""
    qs = clustered_data[2]
    eng = fresh(port_engines, own_raw=True, rerank="exact", k_overfetch=64)
    assert mutation.fetch_depth(eng, K, 4032) == ops.SCAN_K_MAX
    eng.delete(np.arange(4033))
    with pytest.raises(ValueError, match="C5"):
        eng.search(qs, NPROBE, K)
    eng.compact()
    d, i = eng.search(qs, NPROBE, K)
    assert np.isfinite(d).all() and not np.isin(i, np.arange(4033)).any()


def test_inactive_delta_is_the_immutable_path(port_engines, clustered_data):
    """A mutable engine with an empty delta answers bit for bit as the
    immutable engine over the same index, through the same launches."""
    qs = clustered_data[2]
    mut = fresh(port_engines)
    imm = dataclasses.replace(mut, delta=None)
    assert not mut.mutation_active
    for a, b in zip(mut.search(qs, NPROBE, K), imm.search(qs, NPROBE, K)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------- #
# the 16 mutable cells of tests/test_feature_matrix.py
# ---------------------------------------------------------------------- #

MUTABLE_CELLS = list(itertools.product(SCANS, BOOLS, BOOLS, RERANKS))
_ref_cells: dict = {}
_port_refs: dict = {}


def _mutate(eng, centers):
    ids, vecs, dels = _mutations(centers)
    assert eng.insert(ids, vecs) == len(ids)
    assert eng.delete(dels) == len(dels)
    return ids, vecs, dels


@pytest.mark.parametrize("scan,cooc,prune,rerank", MUTABLE_CELLS)
def test_mutable_cell_matches_reference(ref_engines, port_engines, clustered_data, scan,
                                        cooc, prune, rerank):
    xs, centers, qs, _ = clustered_data
    key = (cooc, rerank)
    if key not in _ref_cells:  # 4 reference searches: unpruned windows
        ref = dataclasses.replace(ref_engines[cooc], scan="windows", prune=False,
                                  rerank=rerank, delta=RefDelta.create(8, DELTA_CAP))
        _mutate(ref, centers)
        _ref_cells[key] = ref.search(qs, nprobe=NPROBE, k=K)
        own = fresh(port_engines, cooc=cooc, capacity=DELTA_CAP, scan="windows",
                    prune=False, rerank=rerank)
        _mutate(own, centers)
        _port_refs[key] = own.search(qs, NPROBE, K)
    eng = fresh(port_engines, cooc=cooc, capacity=DELTA_CAP, scan=scan, prune=prune,
                rerank=rerank)
    ids, vecs, dels = _mutate(eng, centers)
    assert eng.mutation_active
    d, i = eng.search(qs, NPROBE, K)
    # inside the port: bit for bit against its own unpruned windows cell
    np.testing.assert_array_equal(d, _port_refs[key][0])
    np.testing.assert_array_equal(i, _port_refs[key][1])
    # against the reference
    r_d, r_i = _ref_cells[key]
    np.testing.assert_allclose(d, r_d, **TOL)
    _same_ids_outside_ties(d, i, r_i)
    assert not np.isin(i, dels).any()
    _, i_new = eng.search(vecs[:8], NPROBE, K)
    assert np.isin(ids[:8], i_new).any()


# ---------------------------------------------------------------------- #
# a reference checkpoint with a delta
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("rerank", RERANKS)
def test_checkpoint_with_delta(ref_engines, clustered_data, tmp_path, rerank):
    """`checkpoint.load_index` reads what the reference's `save_index` writes
    with a delta; the port engine over it answers as the reference's;
    `load_index_dir` refuses it by naming the new reader."""
    xs, centers, qs, _ = clustered_data
    ref = dataclasses.replace(ref_engines[False], rerank=rerank,
                              delta=RefDelta.create(8, DELTA_CAP))
    ids, vecs, dels = _mutations(centers, seed=3)
    ref.insert(ids, vecs)
    ref.delete(dels)
    path = save_index(str(tmp_path / "ckpt"), ref.index, delta=ref.delta,
                      extra={"block_n": BLOCK_N})
    index, delta, extra = load_index(path)
    assert extra == {"block_n": BLOCK_N}
    for f in ("codes", "assign", "vec_ids", "dead", "vectors"):
        np.testing.assert_array_equal(getattr(ref.delta, f), getattr(delta, f))
    assert (delta.n, delta.tombstones) == (ref.delta.n, ref.delta.tombstones)
    with pytest.raises(ValueError, match="checkpoint.load_index"):
        load_index_dir(path)
    eng = MemANNSEngine.from_reference(
        index, ref.placement, xs, block_n=BLOCK_N, delta=delta, rerank=rerank,
        k_overfetch=64, device="cpu")
    assert eng.mutation_active
    d, i = eng.search(qs, NPROBE, K)
    r_d, r_i = ref.search(qs, nprobe=NPROBE, k=K)
    np.testing.assert_allclose(d, r_d, **TOL)
    _same_ids_outside_ties(d, i, r_i)
    # the reference's own delta object carries over as well
    eng2 = MemANNSEngine.from_reference(
        ref.index, ref.placement, xs, block_n=BLOCK_N, delta=ref.delta, rerank=rerank,
        k_overfetch=64, device="cpu")
    for a, b in zip(eng2.search(qs, NPROBE, K), (d, i)):
        np.testing.assert_array_equal(a, b)
    n_ref = ref.delta.n
    eng2.insert(np.asarray([N0 + 500]), qs[:1])  # the port's copy, not the source
    assert ref.delta.n == n_ref and eng2.delta.n == n_ref + 1
    # a checkpoint without a delta reads as before
    plain = save_index(str(tmp_path / "plain"), ref.index)
    assert load_index(plain)[1] is None
