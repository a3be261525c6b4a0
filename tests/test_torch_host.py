"""The port's host-side planning and packing against the reference, exactly.

Algorithm 1 (placement), Algorithm 2 (scheduling with the live-device mask
and the load carry), densify, the tile queue, the pruning bounds and the
shard / raw-store packing are pure numpy in the reference and carried as
code into the port: every output must be `np.array_equal` at ndev 1 and 8.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import placement as rplace  # noqa: E402
from repro.core import scheduling as rsched  # noqa: E402
from repro.core.index import IVFPQIndex as RefIndex  # noqa: E402
from repro.data import vectors as rvec  # noqa: E402
from repro.retrieval import layout as rlayout  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import placement as tplace  # noqa: E402
from repro_torch.core import scheduling as tsched  # noqa: E402
from repro_torch.data import vectors as tvec  # noqa: E402
from repro_torch.retrieval import layout as tlayout  # noqa: E402

C, M, D, BLOCK_N = 40, 8, 32, 64


@pytest.fixture(scope="module")
def index_pair():
    """The same synthetic CSR index as a reference and a port object."""
    rng = np.random.default_rng(5)
    sizes = (400 / np.arange(1, C + 1) ** 1.1).astype(np.int64)
    rng.shuffle(sizes)
    sizes[[3, 17]] = 0  # empty clusters
    offsets = np.zeros(C + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    n = int(offsets[-1])
    arrays = dict(
        centroids=rng.normal(0, 5, (C, D)).astype(np.float32),
        codebook=rng.normal(size=(M, 256, D // M)).astype(np.float32),
        codes=rng.integers(0, 256, (n, M)).astype(np.uint8),
        vec_ids=rng.permutation(n).astype(np.int32),
        offsets=offsets,
    )
    xs = rng.normal(size=(n, D)).astype(np.float32)
    return RefIndex(**arrays), convert.index_from_arrays(**arrays), xs


def _freqs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.random(C) ** 3 + 0.01


def _placements(index_pair, ndev, centroids=True):
    ref, port, _ = index_pair
    cent = ref.centroids if centroids else None
    sizes = ref.cluster_sizes().astype(np.float64)
    return (
        rplace.place_clusters(sizes, _freqs(), ndev, centroids=cent),
        tplace.place_clusters(sizes, _freqs(), ndev, centroids=cent),
    )


@pytest.mark.parametrize("ndev", [1, 8])
@pytest.mark.parametrize("centroids", [True, False])
def test_place_clusters_equal(index_pair, ndev, centroids):
    r, t = _placements(index_pair, ndev, centroids)
    assert r.replicas == t.replicas and r.dev_clusters == t.dev_clusters
    np.testing.assert_array_equal(r.dev_load, t.dev_load)
    np.testing.assert_array_equal(r.dev_vectors, t.dev_vectors)
    assert r.w_bar == t.w_bar
    np.testing.assert_array_equal(r.replica_table()[0], t.replica_table()[0])
    np.testing.assert_array_equal(
        rplace.estimate_frequencies(np.arange(12).reshape(4, 3) % C, C),
        tplace.estimate_frequencies(np.arange(12).reshape(4, 3) % C, C),
    )


def _eq_schedule(a, b):
    for f in ("pair_q", "pair_c", "pair_dev", "dev_load"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("lost_q", "lost_c"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ndev", [1, 8])
def test_schedule_densify_tiles_equal(index_pair, ndev):
    ref, port, _ = index_pair
    rp, tp = _placements(index_pair, ndev)
    rng = np.random.default_rng(ndev)
    probed = np.stack([rng.choice(C, 6, replace=False) for _ in range(30)]).astype(np.int32)
    sizes = ref.cluster_sizes()
    carry = rng.random(ndev) * 300
    live = np.ones(ndev, bool)
    if ndev > 1:
        live[2] = False
    cases = [dict(), dict(load_carry=carry), dict(live=live), dict(load_carry=carry, live=live)]
    r_sh = rlayout.build_shards(ref, rp, block_n=BLOCK_N)
    t_sh = tlayout.build_shards(port, tp, block_n=BLOCK_N)
    for kw in cases:
        rs = rsched.schedule_queries(probed, sizes, rp, **kw)
        ts = tsched.schedule_queries(probed, sizes, tp, **kw)
        _eq_schedule(rs, ts)
        cap = int(ts.counts_per_dev().max()) + 3
        rd = rsched.densify_schedule(rs, r_sh.local_slot, cap)
        td = tsched.densify_schedule(ts, t_sh.local_slot, cap)
        for a, b in zip(rd, td):
            np.testing.assert_array_equal(a, b)
        q_idx, s_idx, valid = td
        nv = np.take_along_axis(t_sh.slot_size, s_idx, axis=1)
        np.testing.assert_array_equal(
            rsched.count_tiles(valid, nv, BLOCK_N), tsched.count_tiles(valid, nv, BLOCK_N)
        )
        key = rng.random(valid.shape).astype(np.float32)
        t_cap = int(tsched.count_tiles(valid, nv, BLOCK_N).max()) + 5
        for ekw in (dict(), dict(pair_key=key), dict(pair_key=key, live=kw.get("live"))):
            a = rsched.emit_tiles(s_idx, valid, r_sh.slot_start, r_sh.slot_size,
                                  BLOCK_N, t_cap, **ekw)
            b = tsched.emit_tiles(s_idx, valid, t_sh.slot_start, t_sh.slot_size,
                                  BLOCK_N, t_cap, **ekw)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_bounds_equal(index_pair):
    ref, _, _ = index_pair
    rng = np.random.default_rng(3)
    qmc = rng.normal(0, 3, (7, 5, D)).astype(np.float32)
    norms_r = rsched.subspace_code_norms(ref.codebook)
    norms_t = tsched.subspace_code_norms(ref.codebook)
    np.testing.assert_array_equal(norms_r, norms_t)
    for a, b in zip(rsched.residual_bounds(qmc, norms_r), tsched.residual_bounds(qmc, norms_t)):
        np.testing.assert_array_equal(a, b)
    _, ub = tsched.residual_bounds(qmc, norms_t)
    sizes = rng.integers(0, 30, (7, 5))
    for k in (1, 10, 200):
        np.testing.assert_array_equal(
            rsched.warm_start_bounds(ub, sizes, k), tsched.warm_start_bounds(ub, sizes, k)
        )


@pytest.mark.parametrize("ndev", [1, 8])
def test_build_shards_equal(index_pair, ndev):
    ref, port, _ = index_pair
    rp, tp = _placements(index_pair, ndev)
    r = rlayout.build_shards(ref, rp, block_n=BLOCK_N, cap_slack=0.5, slot_slack=2,
                             window_slack=1)
    t = tlayout.build_shards(port, tp, block_n=BLOCK_N, cap_slack=0.5, slot_slack=2,
                             window_slack=1)
    assert r.add_offsets  # the port stores raw uint8 codes only
    for f in ("codes", "vec_ids", "slot_start", "slot_size", "slot_cluster", "local_slot"):
        np.testing.assert_array_equal(getattr(r, f), getattr(t, f))
    assert (r.window, r.block_n) == (t.window, t.block_n)
    assert rlayout.default_slack(256, True) == tlayout.default_slack(256, True)
    # co-occurrence + mutable slack (ported): equal to the reference's too
    kw = dict(block_n=BLOCK_N, use_cooc=True, n_combos=16, cap_slack=0.5, slot_slack=2,
              window_slack=1)
    r = rlayout.build_shards(ref, rp, **kw)
    t = tlayout.build_shards(port, tp, device="cpu", **kw)
    for f in ("vec_ids", "slot_start", "slot_size", "slot_cluster", "local_slot",
              "combo_addrs"):
        np.testing.assert_array_equal(getattr(r, f), getattr(t, f))
    np.testing.assert_array_equal(r.codes, np.asarray(t.codes))
    assert (r.window, r.width) == (t.window, t.width)


@pytest.mark.parametrize("ndev", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_raw_store_equal(index_pair, ndev, dtype):
    ref, port, xs = index_pair
    rp, tp = _placements(index_pair, ndev)
    rng = np.random.default_rng(ndev)
    perm = rng.permutation(xs.shape[0])
    xs_ids = perm.astype(np.int64)       # row i of xs_p holds id perm[i]
    xs_p = np.empty_like(xs)
    xs_p[:] = xs[perm]
    r = rlayout.build_raw_store(ref, rp, xs_p, xs_ids=xs_ids, dtype=dtype)
    t = tlayout.build_raw_store(port, tp, torch.as_tensor(xs_p), xs_ids=xs_ids, dtype=dtype)
    np.testing.assert_array_equal(r.used, t.used)
    np.testing.assert_array_equal(r.id_dev, t.id_dev.numpy())
    np.testing.assert_array_equal(r.id_row, t.id_row.numpy())
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for d in range(ndev):
        want = torch.as_tensor(r.vectors[d, : r.used[d]]).to(tdt)
        assert torch.equal(t.device_rows(d), want)
    with pytest.raises(ValueError):
        tlayout.build_raw_store(port, tp, torch.as_tensor(xs_p), xs_ids=xs_ids + 1)


def test_vector_generators_equal():
    for kw in (dict(), dict(size_zipf=0.0), dict(pattern_pool=7)):
        for a, b in zip(rvec.make_clustered_vectors(500, 16, 12, seed=3, **kw),
                        tvec.make_clustered_vectors(500, 16, 12, seed=3, **kw)):
            np.testing.assert_array_equal(a, b)
    centers = rvec.make_clustered_vectors(10, 16, 12, seed=3)[1]
    rd = rvec.SkewedVectorDataset(centers, popularity_zipf=1.1, seed=2)
    td = tvec.SkewedVectorDataset(centers, popularity_zipf=1.1, seed=2)
    np.testing.assert_array_equal(rd.popularity, td.popularity)
    np.testing.assert_array_equal(rd.queries(30, seed=4), td.queries(30, seed=4))
    # the chunked on-device generator draws the same centres and skew
    c, p = tvec.clustered_centers(16, 12, seed=3)
    np.testing.assert_array_equal(c, centers)
    xs, c2 = tvec.generate_clustered(5000, 16, 12, seed=3, device="cpu", chunk=1024)
    np.testing.assert_array_equal(c2, centers)
    assert xs.shape == (5000, 16) and xs.dtype == torch.float32
    near = torch.cdist(xs, torch.as_tensor(centers)).argmin(1)
    share = torch.bincount(near, minlength=12).double() / 5000
    assert float((share - torch.as_tensor(p)).abs().max()) < 0.03
    xb, _ = tvec.generate_clustered(100, 16, 12, seed=3, device="cpu",
                                  dtype=torch.bfloat16)
    assert xb.dtype == torch.bfloat16
