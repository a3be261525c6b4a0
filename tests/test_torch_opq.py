"""OPQ in the port (ROADMAP A11): the rotation's training, a rotated index
through the engine, inserts into it, and the cascade under rotation.

The reference trains OPQ from `jax.random`, so the port's own training is
judged by quality: its Procrustes step equals numpy's `u @ vt`, its
rotation is orthonormal, its quantisation error is no larger than plain
PQ's and within `REF_MSE_FACTOR` of the reference's `train_opq` on the same
correlated residuals.  A rotated index trained by the reference is held
to the reference: carried over with `from_reference`, searched in every
scan x rerank cell and mutated, ids equal and distances allclose
(rtol = atol = 1e-5, the parity contract's).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _one_thread import one_thread  # noqa: E402,F401
from repro.checkpoint import load_index as ref_load_index  # noqa: E402
from repro.checkpoint import save_index as ref_save_index  # noqa: E402
from repro.core import pq as rpq  # noqa: E402
from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro_torch.checkpoint import load_index, load_raw_store, save_index  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import pq as tpq  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.retrieval import MemANNSEngine  # noqa: E402

NPROBE, K, N0 = 8, 10, 12000
TOL = dict(rtol=1e-5, atol=1e-5)
# the port's OPQ MSE may exceed the reference's by this factor on the same
# data (two generators: k-means seeding and PQ init differ)
REF_MSE_FACTOR = 1.1


def _correlated(n=4000, d=32, seed=0):
    """Residuals with a skewed, rotated covariance: the case OPQ is for."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    scale = np.geomspace(4.0, 0.1, d)
    return ((rng.normal(size=(n, d)) * scale) @ q.T).astype(np.float32)


def _mse(codebook, x):
    cb = torch.as_tensor(np.array(codebook))
    xt = torch.as_tensor(x)
    return float(((xt - tpq.pq_decode(cb, tpq.pq_encode(cb, xt))) ** 2).sum(1).mean())


def test_procrustes_matches_numpy():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(500, 16)).astype(np.float32)
    y = (x @ np.linalg.qr(rng.normal(size=(16, 16)))[0]).astype(np.float32)
    y += 0.01 * rng.normal(size=y.shape).astype(np.float32)
    got = tpq.procrustes(torch.as_tensor(x), torch.as_tensor(y))
    u, _, vt = np.linalg.svd(x.T @ y)
    assert got.dtype == np.float32 and got.shape == (16, 16)
    np.testing.assert_allclose(got, u @ vt, atol=1e-5)
    np.testing.assert_allclose(got @ got.T, np.eye(16), atol=1e-5)


def test_train_opq_quality_against_pq_and_reference():
    x = _correlated()
    gen = torch.Generator().manual_seed(0)
    rot, cb = tpq.train_opq(torch.as_tensor(x), 8, pq_iters=6, opq_iters=4, generator=gen)
    np.testing.assert_allclose(rot @ rot.T, np.eye(32), atol=1e-5)
    opq = _mse(cb, x @ rot)
    plain = _mse(tpq.train_pq(torch.as_tensor(x), 8, iters=6,
                              generator=torch.Generator().manual_seed(0)), x)
    r_rot, r_cb = rpq.train_opq(jax.random.PRNGKey(0), x, 8, pq_iters=6, opq_iters=4)
    ref = _mse(r_cb, x @ r_rot)
    assert opq <= plain
    assert opq <= REF_MSE_FACTOR * ref, (opq, ref)


@pytest.fixture(scope="module")
def opq_engines(clustered_data):
    """The reference's OPQ engine (its own training) and the port's over
    its index and placement."""
    xs, _, _, hist = clustered_data
    ref = RefEngine.build(
        jax.random.PRNGKey(0), xs, n_clusters=32, m=8, history_queries=hist,
        block_n=256, kmeans_iters=6, pq_iters=4, opq_iters=2, rerank="exact",
        k_overfetch=64, store_raw=True,
    )
    port = MemANNSEngine.from_reference(ref.index, ref.placement, xs, block_n=256,
                                        rerank="exact", k_overfetch=64, device="cpu")
    return ref, port


def _close(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[0], b[0], **TOL)


@pytest.mark.parametrize("scan", ["tiles", "windows"])
@pytest.mark.parametrize("rerank", ["off", "exact"])
def test_reference_opq_index_matches_reference(opq_engines, clustered_data, scan, rerank):
    ref, port = opq_engines
    qs = clustered_data[2]
    assert port.index.rotation is not None
    np.testing.assert_array_equal(port.index.rotation, ref.index.rotation)
    want = dataclasses.replace(ref, scan=scan, rerank=rerank).search(qs, NPROBE, K)
    got = dataclasses.replace(port, scan=scan, rerank=rerank).search(qs, NPROBE, K)
    _close(got, want)


@pytest.mark.parametrize("rerank", ["off", "exact"])
def test_opq_mutation_matches_reference(opq_engines, clustered_data, rerank):
    """Inserts (rotated before encoding, kept unrotated), deletes and the
    mutable search on the reference's rotated index, against its own."""
    from repro.retrieval.mutation import ensure_delta

    ref0, port0 = opq_engines
    xs, centers, qs, _ = clustered_data
    ref = dataclasses.replace(ref0, rerank=rerank, delta=None, _dev_arrays=None,
                              _raw_arrays=None)
    ensure_delta(ref, 256)
    port = MemANNSEngine.from_reference(ref0.index, ref0.placement, xs, block_n=256,
                                        rerank=rerank, k_overfetch=64, mutable=True,
                                        delta_capacity=256, device="cpu")
    rng = np.random.default_rng(3)
    ids = np.arange(N0, N0 + 40, dtype=np.int32)
    vecs = (centers[rng.integers(0, len(centers), 40)]
            + rng.normal(0, 1, (40, xs.shape[1]))).astype(np.float32)
    dels = np.concatenate([rng.choice(N0, 12, replace=False), ids[:4]])
    for eng in (ref, port):
        eng.insert(ids, vecs)
        eng.delete(dels)
    np.testing.assert_array_equal(port.delta.codes, np.asarray(ref.delta.codes))
    np.testing.assert_array_equal(port.delta.vectors[:40], vecs)
    for q in (qs, vecs[4:20]):
        _close(port.search(q, NPROBE, K), ref.search(q, NPROBE, K))
    _, own = port.search(vecs[4:20], NPROBE, K)
    np.testing.assert_array_equal(own[:, 0], ids[4:20])


def _host_cascade(eng, xs, qs, nprobe, k):
    """The port engine's own ADC candidates re-scored by the plain re-rank
    over the original-space corpus; stable top-k (the twin of
    tests/test_rerank.py's `host_cascade`)."""
    kp = eng.k_prime(k)
    adc_d, adc_i = eng.collect(eng.dispatch_plan(eng.plan_batch(qs, nprobe), kp))
    cand = torch.as_tensor(np.where(np.isfinite(adc_d), adc_i, -1).astype(np.int32))
    ids = np.arange(xs.shape[0], dtype=np.int32)
    exact = ops.rerank_dists(
        torch.as_tensor(qs), cand, torch.as_tensor(xs), torch.zeros(len(ids), dtype=torch.int32),
        torch.as_tensor(ids), torch.zeros(1, dtype=torch.int64)).numpy()
    sel = np.argsort(exact, axis=-1, kind="stable")[:, :k]
    out_d = np.take_along_axis(exact, sel, axis=-1)
    out_i = np.take_along_axis(cand.numpy(), sel, axis=-1)
    return out_d, np.where(np.isfinite(out_d), out_i, -1)


def test_opq_rotation_composes_with_cascade(clustered_data):
    """Twin of tests/test_rerank.py's: the port's own OPQ build; candidates
    come from the rotated ADC scan, the re-rank runs in the original
    space, bit-equal to the host cascade, recall@10 >= 0.9."""
    xs, _, qs, _ = clustered_data
    eng = MemANNSEngine.build(xs, n_clusters=32, m=8, block_n=256, kmeans_iters=6,
                              pq_iters=4, opq_iters=2, rerank="exact", k_overfetch=128,
                              device="cpu")
    rot = eng.index.rotation
    assert rot is not None
    np.testing.assert_allclose(rot @ rot.T, np.eye(rot.shape[0]), atol=1e-4)
    ref_d, ref_i = _host_cascade(eng, xs, qs, NPROBE, K)
    got_d, got_i = eng.search(qs, nprobe=NPROBE, k=K)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_d, ref_d)
    _, gt = tindex.brute_force(xs, qs, K, device="cpu")
    assert tindex.recall_at_k(got_i, gt) >= 0.9


def test_checkpoint_roundtrip_rotation_vectors_raw(tmp_path, clustered_data):
    """Twin of tests/test_rerank.py's: a mutable OPQ engine's index, delta
    (inserts kept unrotated) and raw store round-trip; the reference's
    `load_index` reads the port's rotation too."""
    xs, centers, _, _ = clustered_data
    eng = MemANNSEngine.build(xs, n_clusters=32, m=8, block_n=256, kmeans_iters=4,
                              pq_iters=3, opq_iters=1, rerank="exact", k_overfetch=64,
                              mutable=True, delta_capacity=512, device="cpu")
    ids = np.arange(N0, N0 + 16, dtype=np.int32)
    eng.insert(ids, centers[:16].astype(np.float32))
    path = save_index(str(tmp_path / "ckpt"), eng.index, delta=eng.delta, raw=eng.raw)
    idx2, delta2, _ = load_index(path)
    raw2 = load_raw_store(path, "cpu", cap_slack=eng.raw.cap_slack)
    np.testing.assert_array_equal(idx2.rotation, eng.index.rotation)
    np.testing.assert_array_equal(delta2.vectors[: delta2.n], eng.delta.vectors[: eng.delta.n])
    assert raw2 is not None and raw2.dtype == eng.raw.dtype
    np.testing.assert_array_equal(raw2.vectors.numpy(), eng.raw.vectors.numpy())
    np.testing.assert_array_equal(ref_load_index(path)[0].rotation, eng.index.rotation)
    # and the reference's checkpoint of the same index reads back here
    ref_path = ref_save_index(str(tmp_path / "ref"), eng.index)
    np.testing.assert_array_equal(load_index(ref_path)[0].rotation, eng.index.rotation)


def test_opq_compaction_equals_scratch_reencode(clustered_data):
    """After inserts and deletes into the port's own OPQ engine, the
    compacted index equals a from-scratch encode of the survivors and the
    inserts: one rotation function (`rotate_rows`, fixed-shape products)
    for the build, the insert and the re-encode."""
    xs, centers, _, _ = clustered_data
    eng = MemANNSEngine.build(xs, n_clusters=32, m=8, block_n=256, kmeans_iters=4,
                              pq_iters=3, opq_iters=1, mutable=True, delta_capacity=512,
                              device="cpu")
    old = eng.index
    rng = np.random.default_rng(4)
    ids = np.arange(N0, N0 + 100, dtype=np.int32)
    vecs = (centers[rng.integers(0, len(centers), 100)]
            + rng.normal(0, 1, (100, xs.shape[1]))).astype(np.float32)
    eng.insert(ids[:37], vecs[:37])
    eng.insert(ids[37:], vecs[37:])
    dels = rng.choice(N0, 50, replace=False)
    eng.delete(dels)
    ins_assign = eng.delta.assign[:100].copy()
    eng.compact()
    new = eng.index
    # survivors keep their build assignment (original space); inserts
    # were assigned in the rotated space at insert time
    old_cl = np.repeat(np.arange(32), old.cluster_sizes())
    keep = ~np.isin(old.vec_ids, dels)
    all_ids = np.concatenate([old.vec_ids[keep], ids])
    all_x = np.concatenate([xs[old.vec_ids[keep]], vecs])
    all_a = np.concatenate([old_cl[keep], ins_assign])
    want = tindex.encode_index(new.centroids, new.codebook, all_x, vec_ids=all_ids,
                               assign=all_a, rotation=new.rotation, device="cpu")
    for f in ("codes", "vec_ids", "offsets"):
        np.testing.assert_array_equal(getattr(new, f), getattr(want, f))
