"""The windows scan (kernel B5) and direct-address codes (kernel B2) in the
port against the reference, and the scans against each other.

On the CPU `ops.adc_topk_windows` and `ops.adc_topk_tiles` run their plain
versions; they are held against the Pallas kernels in interpret mode on the
same inputs (allclose rtol = atol = 1e-5, rows equal), for raw uint8 codes
and for uint16 / int32 direct addresses with sentinel padding.  Within the
port, bit for bit: windows == tiles and pruned == unpruned, per query.  The
engine in the 8 plain-code cells of scan x prune x rerank equals the
reference engine at ndev 1 and 8, and the windows plan carries no tile
queue while its row and tile counts equal the reference's.
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
from repro_torch.core.placement import place_clusters  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.retrieval.engine import MemANNSEngine  # noqa: E402
from test_torch_ref_parity import TOL, jax_tiles, merge_per_query, tile_case  # noqa: E402

NPROBE, K, BLOCK_N = 8, 10, 256
N_EXTRA = 11  # combo entries of the direct-address tables


def _t(a):
    return torch.as_tensor(np.array(a))


def direct_case(c, dtype):
    """tile_case `c` with direct addresses: col * 256 + code plus two
    sentinel columns, scanned against [LUT | N_EXTRA entries | 0] tables;
    the distances are the raw codes' (the sentinel reads 0.0)."""
    p, m, _ = c["luts"].shape
    rng = np.random.default_rng(p)
    sentinel = m * 256 + N_EXTRA
    addr = c["codes"].astype(np.int32) + np.arange(m, dtype=np.int32) * 256
    pad = np.full((addr.shape[0], 2), sentinel, np.int32)
    extra = rng.random((p, N_EXTRA), dtype=np.float32)
    tables = np.concatenate(
        [c["luts"].reshape(p, -1), extra, np.zeros((p, 1), np.float32)], axis=1)
    return dict(c, codes=np.concatenate([addr, pad], 1).astype(dtype), tables=tables)


def _bounds(c, on):
    if not on:
        return {}, {}
    port = dict(pair_q=_t(c["pair_q"]), pair_lb=_t(c["pair_lb"]), bound=_t(c["bound"]))
    ref = dict(pair_q=jnp.asarray(c["pair_q"]), pair_lb=jnp.asarray(c["pair_lb"]),
               bound=jnp.asarray(c["bound"]), n_queries=c["q"])
    return port, ref


def _tables(c):
    return c.get("tables", c["luts"].reshape(c["luts"].shape[0], -1))


def port_windows(c, bounds):
    kw, _ = _bounds(c, bounds)
    p = c["luts"].shape[0]
    v, i, s = ops.adc_topk_windows(
        _t(_tables(c)), _t(c["codes"]), _t(c["starts"]), _t(c["sizes"]), c["k"],
        lut_row=_t(np.arange(p, dtype=np.int32)), block_n=c["block_n"], **kw,
    )
    return v.numpy(), i.numpy(), s.numpy()


def port_tiles(c, bounds):
    kw, _ = _bounds(c, bounds)
    p = c["luts"].shape[0]
    v, i, s = ops.adc_topk_tiles(
        _t(_tables(c)), _t(c["codes"]), _t(c["tile_pair"]), _t(c["tile_block"]),
        _t(c["tile_row0"]), _t(c["sizes"]), c["k"],
        lut_row=_t(np.arange(p, dtype=np.int32)), block_n=c["block_n"], **kw,
    )
    return v.numpy(), i.numpy(), s.numpy()


def jax_windows(c, bounds):
    _, kw = _bounds(c, bounds)
    bn = c["block_n"]
    tables = c.get("tables")
    add_offsets = tables is None
    if add_offsets:
        p = c["luts"].shape[0]
        tables = np.concatenate([c["luts"].reshape(p, -1), np.zeros((p, 1), np.float32)], 1)
    window = max(-(-int(c["sizes"].max()) // bn) * bn, bn)
    v, i, s = jops.adc_topk_windows(
        jnp.asarray(tables), jnp.asarray(c["codes"]), jnp.asarray(c["starts"]),
        jnp.asarray(c["sizes"]), c["k"], window=window, block_n=bn,
        add_offsets=add_offsets, with_stats=True, **kw,
    )
    return np.array(v), np.array(i), np.array(s)


def jax_direct_tiles(c, bounds):
    _, kw = _bounds(c, bounds)
    v, i = jops.adc_topk_tiles(
        jnp.asarray(c["tables"]), jnp.asarray(c["codes"]), jnp.asarray(c["tile_pair"]),
        jnp.asarray(c["tile_block"]), jnp.asarray(c["tile_row0"]),
        jnp.asarray(c["sizes"]), c["k"], block_n=c["block_n"], add_offsets=False, **kw,
    )
    v, i = np.array(v), np.array(i)
    empty = c["sizes"] <= 0  # undefined rows in the reference's contract
    v[empty], i[empty] = np.inf, -1
    return v, i


def _case(seed, dtype):
    c = tile_case(seed, spread=1.0 if seed % 2 else 0.0)
    return c if dtype == "uint8" else direct_case(c, dtype)


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_windows_matches_reference(seed, dtype):
    c = _case(seed, dtype)
    pv, pi, ps = port_windows(c, bounds=False)
    jv, ji, js = jax_windows(c, bounds=False)
    np.testing.assert_allclose(pv, jv, **TOL)
    np.testing.assert_array_equal(pi, ji)
    assert (ps == 0).all() and (js == 0).all()
    bv, bi, bs = port_windows(c, bounds=True)
    jv, ji, _ = jax_windows(c, bounds=True)
    got = merge_per_query(bv, bi, c["pair_q"], c["q"], c["k"])
    want = merge_per_query(jv, ji, c["pair_q"], c["q"], c["k"])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])
    n_tiles = (c["sizes"] + c["block_n"] - 1) // c["block_n"]
    assert ((bs[:, 0] >= 0) & (bs[:, 0] <= n_tiles)).all()
    assert ((bs[:, 1] >= 0) & (bs[:, 1] <= c["sizes"])).all()


@pytest.mark.parametrize("dtype", ["uint16", "int32"])
@pytest.mark.parametrize("seed", [0, 1])
def test_direct_tiles_matches_reference(seed, dtype):
    """B2 over direct addresses (add_offsets off) vs the Pallas kernel, and
    bit-equal to B2 over the same rows' raw uint8 codes."""
    raw = _case(seed, "uint8")
    c = direct_case(raw, dtype)
    for bounds in (False, True):
        pv, pi, _ = port_tiles(c, bounds)
        jv, ji = jax_direct_tiles(c, bounds)
        if not bounds:
            np.testing.assert_allclose(pv, jv, **TOL)
            np.testing.assert_array_equal(pi, ji)
        got = merge_per_query(pv, pi, c["pair_q"], c["q"], c["k"])
        want = merge_per_query(jv, ji, c["pair_q"], c["q"], c["k"])
        np.testing.assert_allclose(got[0], want[0], **TOL)
        np.testing.assert_array_equal(got[1], want[1])
        rv, ri, _ = port_tiles(raw, bounds)
        np.testing.assert_array_equal(
            merge_per_query(rv, ri, c["pair_q"], c["q"], c["k"])[0], got[0])
    # and the raw-code path still matches the reference's add_offsets scan
    jv, ji = jax_tiles(raw, bounds=False)
    rv, ri, _ = port_tiles(raw, False)
    np.testing.assert_allclose(rv, jv, **TOL)
    np.testing.assert_array_equal(ri, ji)


@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windows_equals_tiles_bitwise(seed, dtype):
    """Inside the port, per query: windows == tiles and pruned == unpruned,
    bit for bit (distances and (pair, row) ids)."""
    c = _case(seed, dtype)
    out = []
    for scan in (port_windows, port_tiles):
        for bounds in (False, True):
            v, i, _ = scan(c, bounds)
            out.append(merge_per_query(v, i, c["pair_q"], c["q"], c["k"]))
    for d, i in out[1:]:
        np.testing.assert_array_equal(d, out[0][0])
        np.testing.assert_array_equal(i, out[0][1])


@pytest.fixture(scope="module")
def plain_engines(clustered_data):
    xs, _, _, hist = clustered_data
    ref = RefEngine.build(
        jax.random.PRNGKey(0), xs, n_clusters=32, m=8, history_queries=hist,
        block_n=BLOCK_N, kmeans_iters=8, pq_iters=6, rerank="exact", k_overfetch=64,
    )
    ports = {}
    for ndev in (1, 8):
        plc = ref.placement if ndev == 1 else place_clusters(
            ref.index.cluster_sizes().astype(np.float64), ref.freqs, 8,
            centroids=ref.index.centroids)
        ports[ndev] = MemANNSEngine.from_reference(
            ref.index, plc, xs, block_n=BLOCK_N, rerank="exact", k_overfetch=64,
            scan="windows", device="cpu",
        )
    return ref, ports


CELLS = list(itertools.product(("tiles", "windows"), (True, False), ("off", "exact")))


@pytest.mark.parametrize("ndev", [1, 8])
@pytest.mark.parametrize("scan,prune,rerank", CELLS)
def test_plain_cells_match_reference(plain_engines, clustered_data, scan, prune, rerank,
                                     ndev):
    ref, ports = plain_engines
    qs = clustered_data[2]
    rd, ri = dataclasses.replace(ref, scan=scan, prune=prune, rerank=rerank).search(
        qs, NPROBE, K)
    eng = ports[ndev]
    eng.scan, eng.prune, eng.rerank = scan, prune, rerank
    td, ti = eng.search(qs, NPROBE, K)
    assert np.isfinite(td).all()
    np.testing.assert_array_equal(ri, ti)
    np.testing.assert_allclose(rd, td, **TOL)


def test_windows_plan_matches_reference(plain_engines, clustered_data):
    ref, ports = plain_engines
    qs = clustered_data[2]
    r = dataclasses.replace(ref, scan="windows", prune=True)
    eng = ports[1]
    eng.scan, eng.prune = "windows", True
    rp, tp = r.plan_batch(qs, NPROBE), eng.plan_batch(qs, NPROBE)
    assert tp.scan == "windows" and tp.tile_pair is None and tp.tiles_per_dev == 0
    for f in ("pair_q", "pair_slot", "pair_valid", "probed_sizes"):
        np.testing.assert_array_equal(getattr(rp, f), getattr(tp, f))
    np.testing.assert_array_equal(r.plan_dev_rows(rp), eng.plan_dev_rows(tp))
    assert r.plan_tile_count(rp) == eng.plan_tile_count(tp)
    assert r.scanned_rows(rp) == eng.scanned_rows(tp)
    eng.scan = "tiles"
    rt = dataclasses.replace(ref, scan="tiles", prune=True).plan_batch(qs, NPROBE)
    assert ref.plan_tile_count(rt) == eng.plan_tile_count(eng.plan_batch(qs, NPROBE))


@pytest.mark.parametrize("rerank", ["off", "exact"])
def test_port_scans_and_pruning_bitwise(plain_engines, clustered_data, rerank):
    """Within the port at ndev 1 and 8: windows == tiles and pruned ==
    unpruned, bit for bit (distances and ids)."""
    _, ports = plain_engines
    qs = clustered_data[2]
    for eng in ports.values():
        eng.rerank = rerank
        outs = []
        for scan, prune in itertools.product(("tiles", "windows"), (True, False)):
            eng.scan, eng.prune = scan, prune
            outs.append(eng.search(qs, NPROBE, K))
        for d, i in outs[1:]:
            np.testing.assert_array_equal(d, outs[0][0])
            np.testing.assert_array_equal(i, outs[0][1])


def test_cooc_scans_and_pruning_bitwise(plain_engines, clustered_data):
    """The same on co-occurrence shards over the same index."""
    ref, _ = plain_engines
    xs, qs = clustered_data[0], clustered_data[2]
    eng = MemANNSEngine.from_reference(
        ref.index, ref.placement, xs, block_n=BLOCK_N, use_cooc=True, n_combos=32,
        path="flat", device="cpu")
    outs = []
    for scan, prune in itertools.product(("tiles", "windows"), (True, False)):
        eng.scan, eng.prune = scan, prune
        outs.append(eng.search(qs, NPROBE, K))
    for d, i in outs[1:]:
        np.testing.assert_array_equal(d, outs[0][0])
        np.testing.assert_array_equal(i, outs[0][1])
