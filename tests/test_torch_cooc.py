"""§4.3 co-occurrence encoding in the port against the reference, exactly.

The reference's `core/cooc.py` is numpy; the port computes the same
functions batched in torch (`mine_clusters`, `reencode_rows`).  Mined
combos (order and ties included), re-encoded addresses, the flat forms,
the extended tables and the co-occurrence shards must `array_equal` the
reference's.  Kernels B4 (per-pair combo sets) and B9 (one shared set) run
their plain versions here and are held against the Pallas kernels in
interpret mode (allclose rtol = atol = 1e-5; they add the same terms).
The engine on co-occurrence shards equals the reference engine in the 8
co-occurrence cells of scan x prune x rerank at ndev 1 and 8 (ids equal,
distances allclose rtol = atol = 1e-5).
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _one_thread import one_thread  # noqa: E402,F401
jnp = jax.numpy

from repro.core import cooc as rcooc  # noqa: E402
from repro.core import placement as rplace  # noqa: E402
from repro.core.index import IVFPQIndex as RefIndex  # noqa: E402
from repro.kernels import lut_build as rlut_k  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro.retrieval import layout as rlayout  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cooc as tcooc  # noqa: E402
from repro_torch.core import placement as tplace  # noqa: E402
from repro_torch.core.placement import place_clusters  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.retrieval import layout as tlayout  # noqa: E402
from repro_torch.retrieval.engine import MemANNSEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
NPROBE, K, BLOCK_N, N_COMBOS = 8, 10, 256, 32


def _codes(kind: str, seed: int, n: int, m: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "skewed":       # geometric codes: many frequent combos
        return np.minimum(rng.geometric(0.3, (n, m)) - 1, 255).astype(np.uint8)
    if kind == "binary":       # every row matches combos; heavy duplicates
        return rng.integers(0, 2, (n, m)).astype(np.uint8)
    if kind == "constant":     # one signature for every candidate pair
        return np.zeros((n, m), np.uint8)
    return rng.integers(0, 256, (n, m)).astype(np.uint8)  # few supported pairs


def _same_combos(r, t):
    for f in ("cols", "codes", "support"):
        a, b = getattr(r, f), getattr(t, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)


CASES = [
    ("skewed", 0, 1500, 8, 32, 200_000),
    ("skewed", 1, 3000, 16, 64, 1000),     # subsampled rows
    ("binary", 2, 500, 6, 16, 200_000),
    ("constant", 3, 300, 8, 16, 200_000),
    ("uniform", 4, 400, 8, 16, 200_000),
]


@pytest.mark.parametrize("combo_len", [2, 3])
@pytest.mark.parametrize("kind,seed,n,m,n_combos,max_rows", CASES)
def test_mine_combos_and_reencode_equal(kind, seed, n, m, n_combos, max_rows, combo_len):
    codes = _codes(kind, seed, n, m)
    kw = dict(n_combos=n_combos, combo_len=combo_len, max_rows=max_rows, seed=seed)
    r = rcooc.mine_combos(codes, **kw)
    t = tcooc.mine_combos(codes, device="cpu", **kw)
    _same_combos(r, t)
    if r.n_combos == 0:
        return
    for width in (None, m):
        er = rcooc.reencode(codes, r, width=width)
        et = tcooc.reencode(codes, t, width=width, device="cpu")
        np.testing.assert_array_equal(er.addrs, et.addrs)
        assert er.addrs.dtype == et.addrs.dtype == np.uint16
        np.testing.assert_array_equal(er.lengths, et.lengths)
        assert (er.table_size, er.sentinel, er.width) == (et.table_size, et.sentinel, et.width)
        assert er.length_reduction() == et.length_reduction()
    w = int(er.lengths.max())
    np.testing.assert_array_equal(
        rcooc.reencode(codes, r, width=w).addrs,
        tcooc.reencode(codes, t, width=w, device="cpu").addrs,
    )


def test_mine_clusters_groups_equal_per_cluster():
    """Batched mining over CSR row sets, cut into groups by a tiny key
    budget, equals the reference mined cluster by cluster (seed = id)."""
    codes = _codes("skewed", 7, 5000, 8)
    offsets = np.array([0, 0, 700, 2000, 2001, 3500, 5000])
    c, j, s, f = tcooc.mine_clusters(
        torch.as_tensor(codes), offsets, np.arange(6), n_combos=16, combo_len=3,
        max_rows=1000, keys_budget=3000,
    )
    for ci in range(6):
        r = rcooc.mine_combos(codes[offsets[ci] : offsets[ci + 1]], n_combos=16,
                              combo_len=3, max_rows=1000, seed=ci)
        k = int(f[ci])
        assert k == r.n_combos
        np.testing.assert_array_equal(c[ci, :k].numpy(), r.cols)
        np.testing.assert_array_equal(j[ci, :k].numpy(), r.codes)
        np.testing.assert_array_equal(s[ci, :k].numpy(), r.support)
        assert (c[ci, k:] == 0).all() and (j[ci, k:] == 0).all()


def test_flat_forms_and_frequency_equal():
    codes = _codes("skewed", 3, 700, 8)
    got = tcooc.plain_to_flat(codes)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, rcooc.plain_to_flat(codes))
    assert tcooc.max_combo_frequency(codes, device="cpu") == rcooc.max_combo_frequency(codes)
    big = _codes("binary", 4, 1200, 6)
    assert (tcooc.max_combo_frequency(big, max_rows=500, device="cpu")
            == rcooc.max_combo_frequency(big, max_rows=500))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_ext_lut_equal(seed):
    """One LUT extended with a mined combo set: bit for bit (both add each
    combo's entries in index order), through kernel B9's plain version."""
    rng = np.random.default_rng(seed)
    codes = _codes("skewed", seed, 800, 8)
    combos = rcooc.mine_combos(codes, n_combos=24)
    lut = rng.normal(0, 1, (8, 256)).astype(np.float32)
    want = np.asarray(rcooc.build_ext_lut(
        jnp.asarray(lut), jnp.asarray(combos.cols), jnp.asarray(combos.codes)))
    got = tcooc.build_ext_lut(torch.as_tensor(lut), combos.cols, combos.codes)
    assert got.shape == (8 * 256 + combos.n_combos + 1,)
    np.testing.assert_array_equal(got.numpy(), want)
    batch = rng.normal(0, 1, (5, 8, 256)).astype(np.float32)
    got_b = tcooc.build_ext_lut(torch.as_tensor(batch), combos.cols, combos.codes)
    for q in range(5):
        np.testing.assert_array_equal(
            got_b[q].numpy(),
            np.asarray(rcooc.build_ext_lut(jnp.asarray(batch[q]), jnp.asarray(combos.cols),
                                           jnp.asarray(combos.codes))))


@pytest.mark.parametrize("seed", [0, 1])
def test_ext_lut_kernels_plain_match_pallas(seed):
    """B4 and B9 plain versions vs the Pallas kernels (interpret mode)."""
    rng = np.random.default_rng(seed)
    r, m, n_combos, combo_len, n_sets = 37, 8, 19, 3, 5
    luts = rng.normal(0, 1, (r, m, 256)).astype(np.float32)
    caddr = rng.integers(0, m * 256, (n_sets, n_combos, combo_len)).astype(np.int32)
    set_idx = rng.integers(0, n_sets, r).astype(np.int32)
    t_pad = m * 256 + n_combos + 1
    ops.reset_launches()
    got = ops.build_ext_luts_pairs(torch.as_tensor(luts), torch.as_tensor(caddr),
                                   torch.as_tensor(set_idx))
    want = rlut_k.ext_lut_pairs_kernel(jnp.asarray(luts), jnp.asarray(caddr[set_idx]),
                                       t_pad=t_pad, interpret=True)
    assert got.shape == (r, t_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    padded = ops.build_ext_luts_pairs(torch.as_tensor(luts), torch.as_tensor(caddr),
                                      torch.as_tensor(set_idx), t_pad=t_pad + 7)
    np.testing.assert_array_equal(padded[:, :t_pad].numpy(), got.numpy())
    assert (padded[:, t_pad:] == 0).all()

    cols, cods = caddr[0] // 256, caddr[0] % 256
    got9 = ops.build_ext_luts(torch.as_tensor(luts), torch.as_tensor(cols),
                              torch.as_tensor(cods))
    want9 = jops.build_ext_luts(jnp.asarray(luts), jnp.asarray(cols), jnp.asarray(cods))
    np.testing.assert_allclose(got9.numpy(), np.asarray(want9), **TOL)
    # on the CPU the wrappers run the plain versions: no kernel launched
    assert ops.launches["build_ext_luts_pairs"] == ops.launches["build_ext_luts"] == 0


def _synthetic_index(seed, sizes, m=8, d=16, kind="skewed"):
    rng = np.random.default_rng(seed)
    offsets = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    n = int(offsets[-1])
    arrays = dict(
        centroids=rng.normal(0, 5, (len(sizes), d)).astype(np.float32),
        codebook=rng.normal(size=(m, 256, d // m)).astype(np.float32),
        codes=_codes(kind, seed, n, m),
        vec_ids=rng.permutation(n).astype(np.int32),
        offsets=offsets,
    )
    return RefIndex(**arrays), convert.index_from_arrays(**arrays)


SHARD_KW = [
    dict(),
    dict(min_length_reduction=0.12),        # some clusters fall back to plain
    dict(compact_dtype=False),              # int32 direct addresses
    dict(combo_len=2, n_combos=8, mine_rows=100),
]


@pytest.mark.parametrize("kw", range(len(SHARD_KW)))
@pytest.mark.parametrize("ndev", [1, 8])
@pytest.mark.parametrize("empty", [False, True])
def test_build_shards_cooc_equal(ndev, empty, kw):
    kw = SHARD_KW[kw]
    rng = np.random.default_rng(ndev)
    sizes = (400 / np.arange(1, 41) ** 1.1).astype(np.int64) + 3
    rng.shuffle(sizes)
    if empty:
        sizes[[3, 17]] = 0
    ref, port = _synthetic_index(ndev, sizes)
    freqs = rng.random(len(sizes)) ** 3 + 0.01
    rp = rplace.place_clusters(sizes.astype(np.float64), freqs, ndev, centroids=ref.centroids)
    tp = tplace.place_clusters(sizes.astype(np.float64), freqs, ndev, centroids=ref.centroids)
    r = rlayout.build_shards(ref, rp, use_cooc=True, block_n=64, **kw)
    stats = {}
    t = tlayout.build_shards(port, tp, use_cooc=True, block_n=64, device="cpu",
                             stats=stats, **kw)
    for f in ("codes", "vec_ids", "slot_start", "slot_size", "slot_cluster",
              "combo_addrs", "local_slot"):
        a, b = getattr(r, f), np.asarray(getattr(t, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
    for f in ("width", "window", "sentinel", "table_size", "n_combos", "add_offsets",
              "block_n", "min_length_reduction", "mine_rows"):
        assert getattr(r, f) == getattr(t, f), f
    assert stats["width"] == t.width and 0.0 <= stats["mean_length_reduction"] < 1.0
    assert r.bytes_per_device() == t.bytes_per_device()


def test_build_shards_cooc_narrow_width():
    """Low-entropy codes and pair combos: every row matches a combo, so the
    stored width is below M and the packed rows are trimmed; plain shards with int32
    direct addresses and the uint16 limit also agree."""
    sizes = np.array([300, 250, 400, 120, 500])
    ref, port = _synthetic_index(9, sizes, m=4, kind="binary")
    rp = rplace.place_clusters(sizes.astype(np.float64), np.ones(5), 2)
    tp = tplace.place_clusters(sizes.astype(np.float64), np.ones(5), 2)
    kw = dict(use_cooc=True, n_combos=64, combo_len=2, block_n=64)
    r = rlayout.build_shards(ref, rp, **kw)
    t = tlayout.build_shards(port, tp, device="cpu", **kw)
    assert r.width < 4
    np.testing.assert_array_equal(r.codes, np.asarray(t.codes))
    np.testing.assert_array_equal(r.combo_addrs, t.combo_addrs)
    r = rlayout.build_shards(ref, rp, compact_dtype=False, block_n=64)
    t = tlayout.build_shards(port, tp, compact_dtype=False, block_n=64)
    assert t.codes.dtype == np.int32 and not t.add_offsets
    np.testing.assert_array_equal(r.codes, t.codes)
    np.testing.assert_array_equal(r.combo_addrs, t.combo_addrs)
    wide = convert.index_from_arrays(  # M = 256: the table outgrows uint16
        np.zeros((1, 256), np.float32), np.zeros((256, 256, 1), np.float32),
        np.zeros((4, 256), np.uint8), np.arange(4, dtype=np.int32), np.array([0, 4]))
    with pytest.raises(ValueError, match="uint16"):
        tlayout.build_shards(wide, tplace.place_clusters(np.array([4.0]), np.ones(1), 1),
                             use_cooc=True, n_combos=256, device="cpu")
    # co-occurrence shards with mutable slack (queue A item 9, ported):
    # the full plain width reserved, equal to the reference's
    kw = dict(use_cooc=True, n_combos=64, combo_len=2, block_n=64, cap_slack=0.5,
              slot_slack=4, window_slack=2)
    r = rlayout.build_shards(ref, rp, **kw)
    t = tlayout.build_shards(port, tp, device="cpu", **kw)
    assert r.width == t.width == ref.m
    np.testing.assert_array_equal(r.codes, np.asarray(t.codes))
    np.testing.assert_array_equal(r.combo_addrs, t.combo_addrs)


@pytest.fixture(scope="module")
def cooc_engines(clustered_data):
    xs, _, _, hist = clustered_data
    ref = RefEngine.build(
        jax.random.PRNGKey(0), xs, n_clusters=32, m=8, history_queries=hist,
        use_cooc=True, n_combos=N_COMBOS, block_n=BLOCK_N, kmeans_iters=8, pq_iters=6,
        rerank="exact", k_overfetch=64,
    )
    ports = {}
    for ndev in (1, 8):
        plc = ref.placement if ndev == 1 else place_clusters(
            ref.index.cluster_sizes().astype(np.float64), ref.freqs, 8,
            centroids=ref.index.centroids)
        ports[ndev] = MemANNSEngine.from_reference(
            ref.index, plc, xs, block_n=BLOCK_N, rerank="exact", k_overfetch=64,
            use_cooc=True, n_combos=N_COMBOS, path="flat", device="cpu",
        )
    return ref, ports


def test_engine_cooc_shards_equal(cooc_engines):
    ref, ports = cooc_engines
    sh = ports[1].shards
    np.testing.assert_array_equal(ref.shards.codes, np.asarray(sh.codes))
    np.testing.assert_array_equal(ref.shards.combo_addrs, sh.combo_addrs)
    assert not sh.add_offsets and sh.n_combos == N_COMBOS and sh.codes.dtype == torch.uint16


CELLS = list(itertools.product(("tiles", "windows"), (True, False), ("off", "exact")))


@pytest.mark.parametrize("ndev", [1, 8])
@pytest.mark.parametrize("scan,prune,rerank", CELLS)
def test_cooc_cells_match_reference(cooc_engines, clustered_data, scan, prune, rerank, ndev):
    ref, ports = cooc_engines
    qs = clustered_data[2]
    r = dataclasses.replace(ref, scan=scan, prune=prune, rerank=rerank)
    rd, ri = r.search(qs, NPROBE, K)
    eng = ports[ndev]
    eng.scan, eng.prune, eng.rerank = scan, prune, rerank
    td, ti = eng.search(qs, NPROBE, K)
    assert np.isfinite(td).all()
    np.testing.assert_array_equal(ri, ti)
    np.testing.assert_allclose(rd, td, **TOL)
