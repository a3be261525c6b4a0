"""The port's query path as a whole against the reference engine.

The reference `MemANNSEngine` is built on the shared `clustered_data`
fixture (one CPU device, Pallas in interpret mode).  Its trained index and
placement are carried into the port with `repro_torch.convert`, so both
packages search the very same index.  Port vs reference: ids equal,
distances allclose(rtol=1e-5, atol=1e-5) (different f32 summation orders),
across prune on/off x rerank off/exact.  Inside the port, bit for bit:
pruned == unpruned, and 8 logical devices == 1 (ids equal outside groups
of exactly tied distances).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _one_thread import one_thread  # noqa: E402,F401
from repro.checkpoint import save_index  # noqa: E402
from repro.core import index as rindex  # noqa: E402
from repro.core import pq as rpq  # noqa: E402
from repro.core.index import search as ref_flat_search  # noqa: E402
from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro_torch.convert import load_index_dir  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import pq as tpq  # noqa: E402
from repro_torch.core.index import search as port_flat_search  # noqa: E402
from repro_torch.core.placement import place_clusters  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.retrieval.engine import MemANNSEngine  # noqa: E402

NPROBE, K, BLOCK_N = 8, 10, 256
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def engines(clustered_data):
    xs, _, _, hist = clustered_data
    ref = RefEngine.build(
        jax.random.PRNGKey(0), xs, n_clusters=32, m=8, history_queries=hist,
        block_n=BLOCK_N, kmeans_iters=8, pq_iters=6, rerank="exact",
    )
    port1 = MemANNSEngine.from_reference(
        ref.index, ref.placement, xs, block_n=BLOCK_N, rerank="exact", device="cpu"
    )
    plc8 = place_clusters(
        ref.index.cluster_sizes().astype(np.float64), ref.freqs, 8,
        centroids=ref.index.centroids,
    )
    port8 = MemANNSEngine.from_reference(
        ref.index, plc8, xs, block_n=BLOCK_N, rerank="exact", device="cpu"
    )
    return ref, port1, port8


def _search(eng, qs, prune, rerank):
    eng.prune, eng.rerank = prune, rerank
    return eng.search(qs, nprobe=NPROBE, k=K)


def test_probed_lists_agree(engines, clustered_data):
    ref, port1, _ = engines
    qs = clustered_data[2]
    _, r_probed, r_qmc = ref.schedule_batch(qs, NPROBE)
    _, t_probed, t_qmc = port1.schedule_batch(qs, NPROBE)
    # a centroid near-tie would reorder the probes: fail here, loudly
    np.testing.assert_array_equal(np.asarray(r_probed), t_probed)
    np.testing.assert_allclose(np.asarray(r_qmc), t_qmc.numpy(), **TOL)


def test_plan_matches_reference(engines, clustered_data):
    ref, port1, _ = engines
    qs = clustered_data[2]
    rp = ref.plan_batch(qs, NPROBE)
    tp = port1.plan_batch(qs, NPROBE)
    for f in ("pair_q", "pair_slot", "pair_valid", "tile_pair", "tile_block",
              "tile_row0", "probed_sizes"):
        np.testing.assert_array_equal(getattr(rp, f), getattr(tp, f))
    np.testing.assert_allclose(rp.qmc_pairs, tp.qmc_pairs.numpy(), **TOL)
    np.testing.assert_allclose(rp.pair_lb, tp.pair_lb, **TOL)
    np.testing.assert_allclose(rp.query_bounds(K), tp.query_bounds(K), **TOL)
    np.testing.assert_array_equal(ref.plan_dev_rows(rp), port1.plan_dev_rows(tp))
    assert ref.scanned_rows(rp) == port1.scanned_rows(tp)
    assert [ref.k_prime(k) for k in (1, 10, 33)] == [port1.k_prime(k) for k in (1, 10, 33)]


@pytest.mark.parametrize("rerank", ["off", "exact"])
@pytest.mark.parametrize("prune", [True, False])
def test_search_matches_reference(engines, clustered_data, prune, rerank):
    ref, port1, _ = engines
    qs = clustered_data[2]
    rd, ri = _search(ref, qs, prune, rerank)
    td, ti = _search(port1, qs, prune, rerank)
    assert np.isfinite(td).all()
    np.testing.assert_array_equal(ri, ti)
    np.testing.assert_allclose(rd, td, **TOL)


def _same_outside_ties(d, a, b):
    """Ids agree wherever the distance is not shared by another lane."""
    for row_d, row_a, row_b in zip(d, a, b):
        for v in np.unique(row_d):
            lanes = row_d == v
            assert set(row_a[lanes]) == set(row_b[lanes])


@pytest.mark.parametrize("rerank", ["off", "exact"])
def test_port_pruned_equals_unpruned_and_ndev(engines, clustered_data, rerank):
    _, port1, port8 = engines
    qs = clustered_data[2]
    out = {}
    for name, eng in (("1", port1), ("8", port8)):
        pd, pi = _search(eng, qs, True, rerank)
        ud, ui = _search(eng, qs, False, rerank)
        np.testing.assert_array_equal(pd, ud)
        np.testing.assert_array_equal(pi, ui)
        out[name] = (pd, pi)
    np.testing.assert_array_equal(out["1"][0], out["8"][0])
    _same_outside_ties(out["1"][0], out["1"][1], out["8"][1])


@pytest.mark.parametrize("per_round", [1, 3])
def test_merge_rounds_change_no_bit(engines, clustered_data, monkeypatch, per_round):
    """The per-device merge split into rounds (one device a round, or three
    of the eight) returns the one-round merge's results bit for bit."""
    from repro_torch.retrieval import search as tsearch

    _, _, port8 = engines
    qs = clustered_data[2]
    plan = port8.plan_batch(qs, NPROBE)
    want = port8.execute_plan(plan, 64)
    monkeypatch.setattr(tsearch, "MERGE_ENTRIES", per_round * plan.pair_q.shape[1] * 64)
    got = port8.execute_plan(plan, 64)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("prune", [True, False])
def test_short_results_pad_with_minus_one(engines, clustered_data, prune):
    """k above the probed rows: +inf lanes carry id -1 (the reference leaves
    ids of unrelated rows there, ROADMAP C3); finite lanes match it."""
    ref, port1, _ = engines
    qs = clustered_data[2][:4]
    k = int(ref.index.cluster_sizes().max()) + 40
    ref.prune = port1.prune = prune
    ref.rerank = port1.rerank = "off"
    rd, ri = ref.search(qs, nprobe=1, k=k)
    td, ti = port1.search(qs, nprobe=1, k=k)
    fin = np.isfinite(rd)
    assert (~fin).any()
    np.testing.assert_array_equal(fin, np.isfinite(td))
    np.testing.assert_array_equal(ri[fin], ti[fin])
    np.testing.assert_allclose(rd[fin], td[fin], **TOL)
    assert (ti[~fin] == -1).all()


def test_dispatch_collect_and_prune_stats(engines, clustered_data):
    _, _, port8 = engines
    qs = clustered_data[2]
    port8.prune = True
    plan = port8.plan_batch(qs, NPROBE)
    handle = port8.dispatch_plan(plan, K)
    assert handle.is_ready()
    d, i = port8.collect(handle)
    assert d.shape == (qs.shape[0], K) and (np.diff(d, axis=1) >= 0).all()
    stats = handle.prune_stats.numpy()
    real = (plan.tile_pair != plan.pairs_per_dev).sum(axis=1)
    assert stats.shape == (8, 2) and (stats[:, 0] >= 0).all() and (stats[:, 0] <= real).all()
    np.testing.assert_array_equal(port8.execute_plan(plan, K)[1], i)


def test_flat_search(engines, clustered_data):
    ref, port1, _ = engines
    qs = clustered_data[2][:6]
    smallest = int(ref.index.cluster_sizes().min())
    rd, ri = ref_flat_search(ref.index, qs, NPROBE, K)
    td, ti = port_flat_search(port1.index, qs, NPROBE, K, device="cpu")
    np.testing.assert_array_equal(ri, ti)
    np.testing.assert_allclose(rd, td, **TOL)
    # k above the smallest probed cluster (the reference's C1 crash)
    k_big = smallest + 5
    bd, bi = port_flat_search(port1.index, qs, 3, k_big, device="cpu")
    assert bd.shape == (6, k_big) and (np.diff(bd, axis=1) >= 0).all()
    for row_d, row_i in zip(bd, bi):
        live = row_i[np.isfinite(row_d)]
        assert len(set(live.tolist())) == len(live) and (live >= 0).all()


def _plain_flat_search(index, qs, nprobe, k):
    """The flat search as a loop over (query, probe) on the port's plain
    kernel versions: B1's tables, B8's column-order sums, a stable top-min(k,
    rows) per probe, then the reference's iterated stable merges."""
    from repro_torch.kernels.adc_scan import adc_scan_plain
    from repro_torch.kernels.lut_build import build_luts_plain

    q = torch.as_tensor(qs)
    cids, qmc = tindex.filter_clusters(torch.as_tensor(index.centroids), q, nprobe)
    cb = torch.as_tensor(index.codebook)
    m, _, dsub = cb.shape
    out_d = np.full((len(qs), k), np.inf, np.float32)
    out_i = np.full((len(qs), k), -1, np.int64)
    for qi in range(len(qs)):
        best_d, best_i = out_d[qi], out_i[qi]
        for pi, c in enumerate(cids[qi].tolist()):
            seg = index.cluster_codes(c)
            if len(seg) == 0:
                continue
            lut = build_luts_plain(cb, qmc[qi, pi].reshape(1, m, dsub))[0]
            d = adc_scan_plain(lut.reshape(-1), torch.as_tensor(seg)).numpy()
            li = np.argsort(d, kind="stable")[: min(k, len(seg))]
            md = np.concatenate([best_d, d[li]])
            mi = np.concatenate([best_i, index.cluster_ids(c)[li]])
            sel = np.argsort(md, kind="stable")[:k]
            best_d, best_i = md[sel], mi[sel]
        out_d[qi], out_i[qi] = best_d, best_i
    return out_d, out_i


def test_flat_search_small_clusters_equal_plain_loop(engines, clustered_data):
    """C1: with k above the smallest probed clusters, the grouped search on
    B1 + B6 equals the per-(query, probe) loop over the plain versions, bit
    for bit, ids included (-1 in lanes past a query's probed rows)."""
    _, port1, _ = engines
    qs = clustered_data[2][:5]
    sizes = port1.index.cluster_sizes()
    for nprobe, k in ((3, int(sizes.min()) + 5), (1, int(sizes.max()) + 3)):
        got = port_flat_search(port1.index, qs, nprobe, k, device="cpu")
        want = _plain_flat_search(port1.index, qs, nprobe, k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert (got[1][:, -3:] == -1).all() and np.isinf(got[0][:, -3:]).all()


def test_load_index_dir(engines, clustered_data, tmp_path):
    ref, port1, _ = engines
    path = save_index(str(tmp_path / "ckpt"), ref.index, extra={"block_n": BLOCK_N})
    index, extra = load_index_dir(path)
    assert extra == {"block_n": BLOCK_N}
    for f in ("centroids", "codebook", "codes", "vec_ids", "offsets"):
        np.testing.assert_array_equal(getattr(ref.index, f), getattr(index, f))
    eng = MemANNSEngine.from_reference(index, ref.placement, block_n=BLOCK_N, device="cpu")
    qs = clustered_data[2]
    got = _search(eng, qs, True, "off")
    want = _search(port1, qs, True, "off")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _quant_mse(index, xs):
    """Mean squared quantisation error of an index's codes over its rows
    (in the coding space: rotated under OPQ, where R preserves norms)."""
    cl = np.repeat(np.arange(index.n_clusters), index.cluster_sizes())
    dec = tpq.pq_decode(torch.as_tensor(index.codebook), torch.as_tensor(index.codes)).numpy()
    res = index.rotate(xs[index.vec_ids]) - index.centroids[cl]
    return float(((res - dec) ** 2).sum(1).mean())


@pytest.mark.parametrize(
    "knob",
    [dict(path="onehot"), dict(use_cooc=True, mutable=True),
     dict(scan="windows", mutable=True), dict(mutable=True), dict(opq_iters=2)],
)
def test_unported_knobs_raise(clustered_data, knob):
    """Every knob that once raised is ported now: `path="onehot"` builds an
    engine that keeps its path and whose search equals the gather engine's
    bit for bit (raw codes: table order is column order); the three
    `mutable=True` cases (plain tiles, plain windows and co-occurrence
    shards, queue A item 9) build a mutable engine whose inserts the next
    search finds; `opq_iters=2` (queue A item 11) records an orthonormal
    rotation over the same IVF as the plain build and quantises the
    corpus with no larger error."""
    xs, _, qs, _ = clustered_data
    if knob.get("opq_iters"):
        kw = dict(device="cpu", kmeans_iters=3, pq_iters=3, block_n=BLOCK_N)
        eng = MemANNSEngine.build(xs, 32, 8, **kw, **knob)
        plain = MemANNSEngine.build(xs, 32, 8, **kw)
        r = eng.index.rotation
        assert r is not None and r.shape == (32, 32)
        np.testing.assert_allclose(r @ r.T, np.eye(32), atol=1e-5)
        np.testing.assert_array_equal(eng.index.cluster_sizes(), plain.index.cluster_sizes())
        assert _quant_mse(eng.index, xs) <= _quant_mse(plain.index, xs)
        assert np.isfinite(eng.search(qs, NPROBE, K)[0]).all()
        return
    if knob.get("path") == "onehot":
        kw = dict(device="cpu", kmeans_iters=3, pq_iters=3, block_n=BLOCK_N)
        eng = MemANNSEngine.build(xs, 32, 8, **kw, **knob)
        gat = MemANNSEngine.build(xs, 32, 8, **kw)
        assert eng.path == "onehot" and eng.kernel_path == "onehot"
        got, want = eng.search(qs, NPROBE, K), gat.search(qs, NPROBE, K)
        assert np.isfinite(got[0]).all()
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        return
    eng = MemANNSEngine.build(xs, 32, 8, device="cpu", kmeans_iters=3, pq_iters=3,
                              n_combos=32, block_n=BLOCK_N, delta_capacity=64, **knob)
    assert eng.delta is not None and eng.delta.capacity == 64 and not eng.mutation_active
    assert eng.shards.codes.shape[2] == 8  # co-occurrence shards reserve the full width
    ids = np.arange(xs.shape[0], xs.shape[0] + 4)
    eng.insert(ids, qs[:4])
    _, got = eng.search(qs[:4], NPROBE, K)
    np.testing.assert_array_equal(got[:, 0], ids)


def test_index_assembly_matches_reference(engines, clustered_data):
    """Assignment, PQ encode/decode, CSR assembly and brute force over the
    reference's trained centroids and codebook: equal arrays."""
    ref = engines[0]
    xs, qs = clustered_data[0], clustered_data[2]
    idx = ref.index
    assign = tindex.assign_clusters(idx.centroids, xs, device="cpu").numpy()
    np.testing.assert_array_equal(assign, rindex.assign_clusters(idx.centroids, xs))
    got = tindex.encode_index(idx.centroids, idx.codebook, xs, device="cpu")
    want = rindex.encode_index(idx.centroids, idx.codebook, xs)
    for f in ("codes", "vec_ids", "offsets", "centroids", "codebook"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    res = xs - idx.centroids[assign]
    codes = tpq.pq_encode(torch.as_tensor(idx.codebook), torch.as_tensor(res)).numpy()
    np.testing.assert_array_equal(
        codes, np.asarray(rpq.pq_encode(jax.numpy.asarray(idx.codebook), jax.numpy.asarray(res)))
    )
    np.testing.assert_array_equal(
        tpq.pq_decode(torch.as_tensor(idx.codebook), torch.as_tensor(codes)).numpy(),
        np.asarray(rpq.pq_decode(jax.numpy.asarray(idx.codebook), jax.numpy.asarray(codes))),
    )
    bd, bi = tindex.brute_force(xs, qs, K, device="cpu", chunk=5000)
    rd, ri = rindex.brute_force(xs, qs, K)
    np.testing.assert_array_equal(bi, ri)
    # both use the ||q||^2 - 2 q.x + ||x||^2 expansion: its rounding scales
    # with the squared norms (~2e3 here) times f32 eps, not with the distance
    scale = float((xs**2).sum(1).max() + (qs**2).sum(1).max())
    np.testing.assert_allclose(bd, rd, rtol=0, atol=scale * 2**-20)
    assert tindex.recall_at_k(bi, ri) == rindex.recall_at_k(bi, ri) == 1.0
    rot, cb = tpq.train_opq(torch.as_tensor(res), 8, pq_iters=2, opq_iters=1,
                            generator=torch.Generator().manual_seed(0))
    assert rot.dtype == np.float32 and cb.shape == (8, 256, 4)
    np.testing.assert_allclose(rot @ rot.T, np.eye(32), atol=1e-5)


def test_port_build_quality(engines, clustered_data):
    """The port's own k-means + PQ (another generator than jax.random):
    judged by quality against the reference build, not by bits."""
    ref = engines[0]
    xs = clustered_data[0]
    own = tindex.build_index(xs, 32, 8, kmeans_iters=8, pq_iters=6,
                             generator=torch.Generator().manual_seed(0), device="cpu")

    def inertia(index):
        a = tindex.assign_clusters(index.centroids, xs, device="cpu").numpy()
        return float(((xs - index.centroids[a]) ** 2).sum(1).mean())

    assert own.n_vectors == xs.shape[0] and own.codebook.shape == (8, 256, 4)
    assert inertia(own) <= 1.25 * inertia(ref.index)
    from repro_torch.core.kmeans import kmeans

    sample = torch.as_tensor(xs[:2000])
    for init in ("random", "kmeans++"):
        cent, assign = kmeans(sample, 32, iters=5, init=init,
                              generator=torch.Generator().manual_seed(1))
        assert cent.shape == (32, xs.shape[1]) and int(assign.max()) < 32
        assert float(((sample - cent[assign]) ** 2).sum(1).mean()) < 2.0 * inertia(ref.index)


def test_exact_rerank_past_scan_k_max(engines, clustered_data):
    """k = 1100 under the exact re-rank overfetches k' = 4k = 4400 ADC
    candidates, past the shared-memory scans' SCAN_K_MAX (once refused,
    ROADMAP C5): the port answers as the reference does, pruned or not."""
    ref, port1, _ = engines
    qs = clustered_data[2][:4]
    k = 1100
    assert port1.k_prime(k) > ops.SCAN_K_MAX
    ref.prune, ref.rerank = True, "exact"
    rd, ri = ref.search(qs, nprobe=32, k=k)
    for prune in (True, False):
        port1.prune, port1.rerank = prune, "exact"
        td, ti = port1.search(qs, nprobe=32, k=k)
        assert np.isfinite(td).all()
        np.testing.assert_allclose(td, rd, **TOL)
        _same_outside_ties(np.asarray(rd), ti, np.asarray(ri))
