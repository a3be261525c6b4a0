"""The onehot path of the ADC kernels (B2, B5, B6, B7, B8) and of the engine.

The reference's `path="onehot"` contracts a (rows, T) multi-hot matrix
with the flat table (`src/repro/kernels/adc_scan.py` `_onehot_dists`): a
row's distance is its W table entries summed over the table's addresses.
The port adds them from 0.0 in ascending address order, each occurrence
once, each sum rounded on its own.  Against the reference (Pallas in
interpret mode, `path="onehot"`): distances allclose(rtol = atol = 1e-5),
ids equal outside exactly tied groups.  Inside the port, bit for bit: on
raw uint8 codes onehot == gather (the address m * 256 + code grows with
m); on direct addresses onehot == the gather over each row's addresses
sorted, including uint16 addresses of 32,768 and up (which read negative
through the int16 view the plain versions gather with); tiles == windows
and pruned == unpruned; the engine's 16 immutable cells equal the
reference engine's on onehot, and four mutable cells equal their gather
twins on raw codes.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from _one_thread import one_thread  # noqa: E402,F401
jnp = jax.numpy

from repro.kernels import ops as jops  # noqa: E402
from repro.retrieval import MemANNSEngine as RefEngine  # noqa: E402
from repro_torch.kernels import adc_topk as k_topk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.retrieval.engine import MemANNSEngine  # noqa: E402
from test_torch_ref_parity import TOL, merge_per_query, tile_case  # noqa: E402
from test_torch_windows import direct_case  # noqa: E402

NPROBE, K, BLOCK_N, N_COMBOS = 8, 10, 256, 32
# table width of the cases with uint16 addresses of 32,768 and up
WIDE = 40_000


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def assert_topk(got, want):
    """Distances allclose; ids equal outside groups of exactly equal distance."""
    (tv, ti), (rv, ri) = [(np.asarray(v), np.asarray(i)) for v, i in (got, want)]
    np.testing.assert_allclose(tv, rv, **TOL)
    for row_d, a, b in zip(rv, ti, ri):
        for v in np.unique(row_d):
            sel = row_d == v
            assert sorted(a[sel].tolist()) == sorted(b[sel].tolist())


def direct_rows(rng, n, w, width, dtype):
    """(n, w) direct addresses shaped like §4.3 rows: column j holds
    j * 256 + code, a combo address (>= w * 256) replaces one column in the
    middle of most rows, and the last column is the zero sentinel; with
    `width` = WIDE the addresses spread over the whole table instead."""
    if width == WIDE:
        return rng.integers(0, WIDE, (n, w)).astype(np.int64).astype(dtype)
    a = rng.integers(0, 256, (n, w)) + np.arange(w) * 256
    combo = rng.random(n) < 0.7
    col = rng.integers(0, w - 1, n)
    a[combo, col[combo]] = w * 256 + rng.integers(0, width - w * 256 - 1, combo.sum())
    a[:, -1] = width - 1
    return a.astype(dtype)


def _table(rng, q, width):
    t = rng.random((q, width), dtype=np.float32) * 4
    t[:, -1] = 0.0
    return t


def sorted_rows(a):
    """The rows' addresses in ascending order (uint16 compared unsigned)."""
    return np.sort(a, axis=-1)


DIRECT = [("int32", 8 * 256 + 40), ("uint16", 8 * 256 + 40), ("uint16", WIDE)]
DIRECT_IDS = ["int32", "uint16", "uint16_wide"]


# -- B8: the plain scan ------------------------------------------------------


@pytest.mark.parametrize("dtype,width", DIRECT, ids=DIRECT_IDS)
def test_scan_flat_onehot(dtype, width):
    rng = np.random.default_rng([1, width])
    table = _table(rng, 1, width)[0]
    addrs = direct_rows(rng, 600, 8, width, dtype)
    got = ops.adc_scan_flat(_t(table), _t(addrs), block_n=256, path="onehot")
    want = jops.adc_scan_flat(_j(table), _j(addrs.astype(np.int32)), block_n=256,
                              path="onehot")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # bit for bit: the gather over each row's sorted addresses, and not
    # the column-order gather (the branch has its own rounding)
    srt = ops.adc_scan_flat(_t(table), _t(sorted_rows(addrs)), block_n=256)
    assert torch.equal(got, srt)
    assert not torch.equal(got, ops.adc_scan_flat(_t(table), _t(addrs), block_n=256))
    if width == WIDE:
        assert (addrs >= 32_768).any()


def test_scan_raw_onehot_is_gather():
    rng = np.random.default_rng(2)
    lut = rng.random((16, 256), dtype=np.float32)
    codes = rng.integers(0, 256, (700, 16)).astype(np.uint8)
    got = ops.adc_scan(_t(lut), _t(codes), path="onehot")
    assert torch.equal(got, ops.adc_scan(_t(lut), _t(codes)))
    want = jops.adc_scan(_j(lut), _j(codes), block_n=256, path="onehot")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- B6: many tables over one code array, and grouped ----------------------


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("dtype,width", DIRECT, ids=DIRECT_IDS)
def test_topk_flat_onehot(dtype, width, k):
    rng = np.random.default_rng([3, width, k])
    tables = _table(rng, 2, width)
    addrs = direct_rows(rng, 520, 8, width, dtype)
    got = ops.adc_topk_flat(_t(tables), _t(addrs), k, block_n=256, path="onehot")
    want = jops.adc_topk_flat(_j(tables), _j(addrs.astype(np.int32)), k, block_n=256,
                              path="onehot")
    assert_topk(got, want)
    srt = ops.adc_topk_flat(_t(tables), _t(sorted_rows(addrs)), k, block_n=256)
    # rows are numbered in place: the sort moves addresses within a row
    assert torch.equal(got[0], srt[0]) and torch.equal(got[1], srt[1])


@pytest.mark.parametrize("q", [1, 5])
def test_topk_raw_onehot(q):
    rng = np.random.default_rng([4, q])
    luts = rng.normal(0, 1, (q, 8, 256)).astype(np.float32)
    codes = rng.integers(0, 256, (900, 8)).astype(np.uint8)
    got = ops.adc_topk(_t(luts), _t(codes), 10, block_n=256, path="onehot")
    gather = ops.adc_topk(_t(luts), _t(codes), 10, block_n=256)
    assert torch.equal(got[0], gather[0]) and torch.equal(got[1], gather[1])
    assert_topk(got, jops.adc_topk(_j(luts), _j(codes), 10, block_n=256, path="onehot"))


@pytest.mark.parametrize("direct", [False, True], ids=["raw", "uint16"])
def test_topk_grouped_onehot(direct):
    """Grouped B6 on onehot: each group's answer is the reference's
    `adc_topk` / `adc_topk_flat` on onehot over that group's rows."""
    rng = np.random.default_rng([5, direct])
    width = 8 * 256 + 40
    sizes, n_tab = [300, 0, 520, 260], [2, 1, 3, 1]
    r_off = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    t_off = np.concatenate([[0], np.cumsum(n_tab)]).tolist()
    if direct:
        codes = direct_rows(rng, r_off[-1], 8, width, "uint16")
        tables = _table(rng, t_off[-1], width)
    else:
        codes = rng.integers(0, 256, (r_off[-1], 8)).astype(np.uint8)
        tables = rng.normal(0, 1, (t_off[-1], 8 * 256)).astype(np.float32)
    got = ops.adc_topk_grouped(_t(tables), _t(codes), K, r_off, t_off, block_n=256,
                               path="onehot")
    if not direct:
        g = ops.adc_topk_grouped(_t(tables), _t(codes), K, r_off, t_off, block_n=256)
        assert torch.equal(got[0], g[0]) and torch.equal(got[1], g[1])
    for gi in range(len(sizes)):
        r0, r1, t0, t1 = r_off[gi], r_off[gi + 1], t_off[gi], t_off[gi + 1]
        if r1 == r0:
            assert bool(torch.isinf(got[0][t0:t1]).all())
            continue
        fn = jops.adc_topk_flat if direct else jops.adc_topk
        c = codes[r0:r1].astype(np.int32) if direct else codes[r0:r1]
        want = fn(_j(tables[t0:t1]), _j(c), K, block_n=256, path="onehot")
        assert_topk((got[0][t0:t1], got[1][t0:t1]), want)


# -- B7: per-pair materialised windows ---------------------------------------


@pytest.mark.parametrize("dtype,width", DIRECT, ids=DIRECT_IDS)
def test_topk_pairs_onehot(dtype, width):
    rng = np.random.default_rng([6, width])
    p, win = 3, 512
    tables = _table(rng, p, width)
    addrs = direct_rows(rng, p * win, 8, width, dtype).reshape(p, win, 8)
    nv = np.array([500, 17, 256], np.int32)
    got = ops.adc_topk_pairs(_t(tables), _t(addrs), _t(nv), K, block_n=256, path="onehot")
    want = jops.adc_topk_pairs(_j(tables), _j(addrs.astype(np.int32)), _j(nv), K,
                               block_n=256, path="onehot")
    assert_topk(got, want)
    srt = ops.adc_topk_pairs(_t(tables), _t(sorted_rows(addrs)), _t(nv), K, block_n=256)
    assert torch.equal(got[0], srt[0]) and torch.equal(got[1], srt[1])


# -- B2 / B5: the pruned scans -----------------------------------------------


def scan_case(seed, dtype):
    """`tile_case` with raw codes, or direct addresses with a combo address
    mid-row in most rows (the [LUT | extras | 0] tables of `direct_case`)."""
    c = tile_case(seed, spread=1.0 if seed % 2 else 0.0)
    if dtype == "uint8":
        return c
    c = direct_case(c, dtype)
    rng = np.random.default_rng([7, seed])
    a = c["codes"].astype(np.int64)
    n, w = a.shape
    m = w - 2
    mid = rng.random(n) < 0.7
    col = rng.integers(0, m, n)
    a[mid, col[mid]] = m * 256 + rng.integers(0, 11, mid.sum())
    return dict(c, codes=a.astype(dtype))


def port_scan(c, scan, bounds, path, codes=None):
    p = c["luts"].shape[0]
    tables = c.get("tables", c["luts"].reshape(p, -1))
    kw = {}
    if bounds:
        kw = dict(pair_q=_t(c["pair_q"]), pair_lb=_t(c["pair_lb"]), bound=_t(c["bound"]))
    codes = c["codes"] if codes is None else codes
    common = dict(lut_row=_t(np.arange(p, dtype=np.int32)), block_n=c["block_n"], path=path,
                  **kw)
    if scan == "tiles":
        v, i, _ = ops.adc_topk_tiles(
            _t(tables), _t(codes), _t(c["tile_pair"]), _t(c["tile_block"]),
            _t(c["tile_row0"]), _t(c["sizes"]), c["k"], **common)
    else:
        v, i, _ = ops.adc_topk_windows(_t(tables), _t(codes), _t(c["starts"]),
                                       _t(c["sizes"]), c["k"], **common)
    return v.numpy(), i.numpy()


def ref_scan(c, scan, bounds):
    bn, p = c["block_n"], c["luts"].shape[0]
    tables = c.get("tables")
    add_offsets = tables is None
    if add_offsets:
        tables = np.concatenate([c["luts"].reshape(p, -1), np.zeros((p, 1), np.float32)], 1)
    kw = dict(block_n=bn, path="onehot", add_offsets=add_offsets)
    if bounds:
        kw.update(pair_q=_j(c["pair_q"]), pair_lb=_j(c["pair_lb"]), bound=_j(c["bound"]),
                  n_queries=c["q"])
    codes = c["codes"] if add_offsets else c["codes"].astype(np.int32)
    if scan == "tiles":
        v, i = jops.adc_topk_tiles(_j(tables), _j(codes), _j(c["tile_pair"]),
                                   _j(c["tile_block"]), _j(c["tile_row0"]), _j(c["sizes"]),
                                   c["k"], **kw)
    else:
        window = max(-(-int(c["sizes"].max()) // bn) * bn, bn)
        v, i = jops.adc_topk_windows(_j(tables), _j(codes), _j(c["starts"]), _j(c["sizes"]),
                                     c["k"], window=window, **kw)
    v, i = np.array(v), np.array(i)
    empty = c["sizes"] <= 0  # undefined rows in the reference's contract
    v[empty], i[empty] = np.inf, -1
    return v, i


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32"])
@pytest.mark.parametrize("scan", ["tiles", "windows"])
def test_scan_onehot_matches_reference(scan, dtype):
    """B2 / B5 on onehot against the reference's onehot, per pair unpruned
    and per query pruned; bit-equal to the port's gather on raw codes and
    on the rows' sorted addresses."""
    c = scan_case(1, dtype)
    for bounds in (False, True):
        pv, pi = port_scan(c, scan, bounds, "onehot")
        rv, ri = ref_scan(c, scan, bounds)
        if not bounds:
            np.testing.assert_allclose(pv, rv, **TOL)
            np.testing.assert_array_equal(pi, ri)
        got = merge_per_query(pv, pi, c["pair_q"], c["q"], c["k"])
        want = merge_per_query(rv, ri, c["pair_q"], c["q"], c["k"])
        np.testing.assert_allclose(got[0], want[0], **TOL)
        np.testing.assert_array_equal(got[1], want[1])
        srt = None if dtype == "uint8" else sorted_rows(c["codes"])
        gv, gi = port_scan(c, scan, bounds, "gather", codes=srt)
        np.testing.assert_array_equal(pv, gv)
        np.testing.assert_array_equal(pi, gi)


@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
def test_scan_onehot_tiles_windows_pruning_bitwise(dtype):
    """Inside the port on onehot, per query: windows == tiles and pruned ==
    unpruned, bit for bit."""
    c = scan_case(2, dtype)
    out = [merge_per_query(*port_scan(c, scan, bounds, "onehot"), c["pair_q"], c["q"], c["k"])
           for scan in ("tiles", "windows") for bounds in (False, True)]
    for d, i in out[1:]:
        np.testing.assert_array_equal(d, out[0][0])
        np.testing.assert_array_equal(i, out[0][1])


def test_table_addresses_sort_unsigned():
    """The plain onehot sorts the masked int64 addresses, so uint16
    addresses of 32,768 and up sort after the small ones."""
    rows = torch.tensor([[40_000, 5, 65_535, 32_768]], dtype=torch.int32).to(torch.uint16)
    addr = k_topk.table_addresses(k_topk.gatherable(rows), 1, "onehot")
    assert addr.tolist() == [[5, 32_768, 40_000, 65_535]]
    assert k_topk.table_addresses(k_topk.gatherable(rows), 1).tolist() == [
        [40_000, 5, 65_535, 32_768]]
    assert [k_topk.sort_network_size(w) for w in (8, 16)] == [19, 63]


# -- the engine ----------------------------------------------------------------


@pytest.fixture(scope="module")
def onehot_engines(clustered_data):
    """The reference's engines (plain and co-occurrence) and the port's
    over the same indexes, on the onehot path."""
    xs, _, _, hist = clustered_data
    kw = dict(n_clusters=32, m=8, history_queries=hist, block_n=BLOCK_N, kmeans_iters=8,
              pq_iters=6, rerank="exact", k_overfetch=64)
    refs = {False: RefEngine.build(jax.random.PRNGKey(0), xs, **kw)}
    refs[True] = RefEngine.build(jax.random.PRNGKey(0), xs, use_cooc=True, n_combos=N_COMBOS,
                                 **kw)
    ports = {
        cooc: MemANNSEngine.from_reference(
            r.index, r.placement, xs, block_n=BLOCK_N, rerank="exact", k_overfetch=64,
            use_cooc=cooc, n_combos=N_COMBOS, path="onehot", device="cpu")
        for cooc, r in refs.items()
    }
    return refs, ports


CELLS = list(itertools.product(("tiles", "windows"), (False, True), (True, False),
                               ("off", "exact")))


@pytest.mark.parametrize("scan,cooc,prune,rerank", CELLS)
def test_onehot_cell_matches_reference(onehot_engines, clustered_data, scan, cooc, prune,
                                       rerank):
    refs, ports = onehot_engines
    qs = clustered_data[2]
    r = dataclasses.replace(refs[cooc], path="onehot", scan=scan, prune=prune, rerank=rerank)
    rd, ri = r.search(qs, NPROBE, K)
    eng = ports[cooc]
    eng.scan, eng.prune, eng.rerank = scan, prune, rerank
    td, ti = eng.search(qs, NPROBE, K)
    assert np.isfinite(td).all()
    np.testing.assert_allclose(td, rd, **TOL)
    for row_d, a, b in zip(td, ti, ri):
        for v in np.unique(row_d):
            assert set(a[row_d == v]) == set(b[row_d == v])


@pytest.mark.parametrize("cooc", [False, True], ids=["raw", "cooc"])
def test_onehot_engine_invariants(onehot_engines, clustered_data, cooc):
    """On onehot: tiles == windows and pruned == unpruned bit for bit; on
    raw codes also == the gather engine; on co-occurrence shards within
    the reference's tolerance of it."""
    _, ports = onehot_engines
    qs = clustered_data[2]
    eng = ports[cooc]
    outs = []
    for scan, prune in itertools.product(("tiles", "windows"), (True, False)):
        eng.scan, eng.prune, eng.rerank = scan, prune, "off"
        outs.append(eng.search(qs, NPROBE, K))
    for d, i in outs[1:]:
        np.testing.assert_array_equal(d, outs[0][0])
        np.testing.assert_array_equal(i, outs[0][1])
    eng.scan, eng.prune = "tiles", True
    gat = dataclasses.replace(eng, path="gather").search(qs, NPROBE, K)
    if cooc:
        np.testing.assert_allclose(outs[0][0], gat[0], **TOL)
    else:
        np.testing.assert_array_equal(outs[0][0], gat[0])
        np.testing.assert_array_equal(outs[0][1], gat[1])


@pytest.mark.parametrize("scan,rerank", list(itertools.product(("tiles", "windows"),
                                                               ("off", "exact"))))
def test_mutable_onehot_cell_equals_gather(onehot_engines, clustered_data, scan, rerank):
    """A mutable engine on onehot (raw codes; the delta scan stays on the
    gather, as the reference's jnp delta scan takes no path) equals its
    gather twin bit for bit, with inserts and tombstones buffered."""
    xs, centers, qs, _ = clustered_data
    ref = onehot_engines[0][False]
    rng = np.random.default_rng(9)
    ids = np.arange(xs.shape[0], xs.shape[0] + 40)
    vecs = (centers[rng.integers(0, len(centers), 40)]
            + rng.normal(0, 1, (40, xs.shape[1]))).astype(np.float32)
    dels = rng.choice(xs.shape[0], 12, replace=False)
    out = {}
    for path in ("gather", "onehot"):
        eng = MemANNSEngine.from_reference(
            ref.index, ref.placement, xs, block_n=BLOCK_N, rerank=rerank, k_overfetch=64,
            scan=scan, mutable=True, delta_capacity=256, path=path, device="cpu")
        eng.insert(ids, vecs)
        eng.delete(dels)
        assert eng.mutation_active
        out[path] = eng.search(np.concatenate([qs, vecs[:4]]), NPROBE, K)
    np.testing.assert_array_equal(out["onehot"][0], out["gather"][0])
    np.testing.assert_array_equal(out["onehot"][1], out["gather"][1])
    assert not np.isin(out["onehot"][1], dels).any()
    assert (out["onehot"][1][-4:, 0] == ids[:4]).all()
