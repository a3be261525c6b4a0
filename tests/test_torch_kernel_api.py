"""The port's kernel-level ADC API (kernels B6, B7, B8) against the reference.

`repro_torch.kernels.ops.adc_scan` / `adc_scan_flat` (B8), `adc_topk` /
`adc_topk_flat` (B6) and `adc_topk_pairs` (B7) take the same numpy inputs
as `repro.kernels.ops`, whose Pallas kernels run in interpret mode on the
CPU as `tests/test_kernels.py` runs them; on the CPU each port wrapper runs
its kernel's plain version.  Tolerance: distances allclose(rtol = atol =
1e-5), since the two packages add the same f32 terms in different orders;
ids equal, except that rows of exactly equal distance may trade places.
The cases are the twins of `test_kernels.py`'s ADC sweeps, plus a finite
per-query bound that drops whole `block_n` tiles (pinning the tile
geometry) and the refusals (`path="onehot"`, k beyond the limit).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import adc_topk as k_topk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(*key):
    return np.random.default_rng([7, *key])


def _luts(rng, q, m):
    return rng.normal(0, 1, (q, m, 256)).astype(np.float32)


def _codes(rng, n, m):
    return rng.integers(0, 256, (n, m)).astype(np.uint8)


def _t(a):
    return torch.as_tensor(np.array(a))


def assert_topk(got, want):
    """Distances allclose; ids equal outside groups of exactly equal distance."""
    (tv, ti), (rv, ri) = [(np.asarray(v), np.asarray(i)) for v, i in (got, want)]
    np.testing.assert_allclose(tv, rv, **TOL)
    assert tv.shape == rv.shape and ti.dtype == np.int32
    for row_d, a, b in zip(rv, ti, ri):
        for v in np.unique(row_d):
            sel = row_d == v
            assert sorted(a[sel].tolist()) == sorted(b[sel].tolist())


@pytest.mark.parametrize("m,n,block_n", [
    (8, 100, 256), (16, 2500, 128), (20, 1024, 512), (16, 3000, 1024),
])
def test_adc_scan(m, n, block_n):
    rng = _rng(m, n)
    lut, codes = _luts(rng, 1, m)[0], _codes(rng, n, m)
    got = ops.adc_scan(_t(lut), _t(codes), block_n=block_n)
    want = jops.adc_scan(jnp.asarray(lut), jnp.asarray(codes), block_n=block_n)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("w", [4, 12, 16])
def test_adc_scan_flat(w):
    rng = _rng(w)
    a = 16 * 256 + 33
    ext = rng.normal(0, 1, (a,)).astype(np.float32)
    addrs = rng.integers(0, a, (1500, w)).astype(np.int32)
    want = np.asarray(jops.adc_scan_flat(jnp.asarray(ext), jnp.asarray(addrs), block_n=256))
    for dtype in (torch.int32, torch.uint16):
        got = ops.adc_scan_flat(_t(ext), _t(addrs).to(dtype), block_n=256)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("k", [1, 10, 50])
def test_adc_topk(q, k):
    rng = _rng(q, k)
    luts, codes = _luts(rng, q, 16), _codes(rng, 2200, 16)
    got = ops.adc_topk(_t(luts), _t(codes), k, block_n=512)
    want = jops.adc_topk(jnp.asarray(luts), jnp.asarray(codes), k, block_n=512)
    assert got[0].shape == (q, k)
    assert_topk(got, want)


def test_adc_topk_flat():
    rng = _rng(3)
    q, k, m, n_combos = 3, 10, 8, 17
    a = m * 256 + n_combos + 1
    ext = rng.normal(0, 1, (q, a)).astype(np.float32)
    addrs = rng.integers(0, a - 1, (900, 6)).astype(np.int32)
    want = jops.adc_topk_flat(jnp.asarray(ext), jnp.asarray(addrs), k, block_n=256)
    for dtype in (torch.int32, torch.uint16):
        assert_topk(ops.adc_topk_flat(_t(ext), _t(addrs).to(dtype), k, block_n=256), want)


def test_adc_topk_pairs():
    rng = _rng(5)
    p, win, w, k, m = 5, 1024, 8, 7, 8
    tables = rng.normal(0, 1, (p, m * 256 + 9)).astype(np.float32)
    addrs = rng.integers(0, m * 256, (p, win, w)).astype(np.int32)
    n_valid = rng.integers(1, win, (p,)).astype(np.int32)
    n_valid[0] = 3  # fewer valid rows than k: (+inf, -1) lanes
    want = jops.adc_topk_pairs(jnp.asarray(tables), jnp.asarray(addrs),
                               jnp.asarray(n_valid), k, block_n=256)
    for dtype in (torch.int32, torch.uint16):
        got = ops.adc_topk_pairs(_t(tables), _t(addrs).to(dtype), _t(n_valid), k,
                                 block_n=256)
        assert_topk(got, want)
        assert np.isinf(got[0][0, 3:].numpy()).all() and (got[1][0, 3:] == -1).all()


@pytest.mark.parametrize("order", ["descending", "ascending"])
def test_early_pruning_orderings(order):
    """Rows sorted by distance, worst first (every tile improves the list)
    or best first (every later tile is skipped): the same top-k."""
    rng = _rng(11)
    m, k = 8, 10
    lut, codes = _luts(rng, 1, m), _codes(rng, 2048, m)
    d = ops.adc_scan(_t(lut[0]), _t(codes)).numpy()
    codes = codes[np.argsort(-d if order == "descending" else d, kind="stable")]
    got = ops.adc_topk(_t(lut), _t(codes), k, block_n=256)
    want = jops.adc_topk(jnp.asarray(lut), jnp.asarray(codes), k, block_n=256)
    assert_topk(got, want)


@pytest.mark.parametrize("block_n", [128, 512])
def test_adc_topk_finite_bound_drops_tiles(block_n):
    """A finite per-query bound drops every tile whose own minimum is above
    it; the rows kept are those of the other tiles, whatever their
    distance.  The bound sits midway between two tile minima, so both
    packages drop the same tiles, and the tiles are the caller's block_n."""
    rng = _rng(13, block_n)
    q, m, k, n = 2, 8, 20, 3000
    luts, codes = _luts(rng, q, m), _codes(rng, n, m)
    bound = np.empty(q, np.float32)
    n_tiles = -(-n // block_n)
    for qi in range(q):
        d = ops.adc_scan(_t(luts[qi]), _t(codes)).numpy()
        tmin = np.sort([d[t * block_n:(t + 1) * block_n].min() for t in range(n_tiles)])
        bound[qi] = (tmin[n_tiles // 2] + tmin[n_tiles // 2 + 1]) / 2
    got = ops.adc_topk(_t(luts), _t(codes), k, block_n=block_n, bound=_t(bound))
    want = jops.adc_topk(jnp.asarray(luts), jnp.asarray(codes), k, block_n=block_n,
                         bound=jnp.asarray(bound))
    assert_topk(got, want)
    free = ops.adc_topk(_t(luts), _t(codes), k, block_n=block_n)
    assert not np.array_equal(got[1].numpy(), free[1].numpy())  # tiles were dropped
    kept_tile = got[1].numpy() // block_n
    for qi in range(q):
        d = ops.adc_scan(_t(luts[qi]), _t(codes)).numpy()
        for t in np.unique(kept_tile[qi]):
            assert d[t * block_n:(t + 1) * block_n].min() <= bound[qi]


def _merge_lists(vals, rows, k):
    """The kernel's merge of run lists: the k smallest entries of the
    concatenated lists by (distance, row)."""
    v, i = torch.cat(vals), torch.cat(rows)
    by_row = torch.sort(i.long(), stable=True).indices
    sel = by_row[torch.sort(v[by_row], stable=True).indices][:k]
    return v[sel], i[sel]


def test_adc_topk_plain_splits_and_chunks_agree(monkeypatch):
    """The plain B6 merges rows chunk by chunk; its result does not depend
    on the chunk, as the kernel's does not depend on its runs: merging the
    plain lists of every run of the launch plan (B6's units of G tables,
    B7's windows, for several grids) gives the whole plain result, bit for
    bit, bound included."""
    rng = _rng(17)
    luts, codes = _t(_luts(rng, 3, 8)), _t(_codes(rng, 1900, 8))
    bound = torch.tensor([np.inf, 30.0, 20.0], dtype=torch.float32)
    want = ops.adc_topk(luts, codes, 37, block_n=128, bound=bound)
    monkeypatch.setattr(k_topk, "_PLAIN_ROWS", 3 * 128)
    got = ops.adc_topk(luts, codes, 37, block_n=128, bound=bound)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    tables, bn, k, n = luts.reshape(3, -1), 128, 37, codes.shape[0]
    for g, n_blocks in ((1, 5), (4, 7), (1, 1000)):
        n_units = -(-3 // g)
        plan = k_topk.run_plan([-(-n // bn)] * n_units, n_blocks)
        lists = {q: ([], []) for q in range(3)}
        for u, t0, t1 in zip(plan["unit"], plan["t0"], plan["t1"]):
            r0, r1 = int(t0) * bn, min(int(t1) * bn, n)
            q0, q1 = int(u) * g, min(int(u) * g + g, 3)
            v, i = k_topk.adc_topk_plain(tables[q0:q1], codes[r0:r1], bound[q0:q1], k, bn)
            for q in range(q0, q1):
                lists[q][0].append(v[q - q0])
                lists[q][1].append(torch.where(i[q - q0] >= 0, i[q - q0] + r0, -1))
        for q in range(3):
            mv, mi = _merge_lists(*lists[q], k)
            assert torch.equal(mv, want[0][q]) and torch.equal(mi, want[1][q])
    # B7: one unit per window, its valid tiles only
    p, win, w, bn, k = 5, 1024, 8, 128, 9
    ptab = _t(rng.normal(0, 1, (p, w * 256 + 9)).astype(np.float32))
    addrs = _t(rng.integers(0, w * 256, (p, win, w)).astype(np.int32))
    n_valid = _t(np.array([0, 7, 1024, 300, 129], np.int32))
    whole = k_topk.adc_topk_pairs_plain(ptab, addrs, n_valid, k)
    for n_blocks in (1, 4, 13, 64):
        plan = k_topk.run_plan((-(-n_valid // bn)).tolist(), n_blocks)
        lists = {q: ([], []) for q in range(p)}
        for u, t0, t1 in zip(plan["unit"], plan["t0"], plan["t1"]):
            u, r0 = int(u), int(t0) * bn
            r1 = min(int(t1) * bn, int(n_valid[u]))
            v, i = k_topk.adc_topk_pairs_plain(
                ptab[u : u + 1], addrs[u : u + 1, r0:r1].contiguous(),
                torch.tensor([r1 - r0], dtype=torch.int32), k)
            lists[u][0].append(v[0])
            lists[u][1].append(torch.where(i[0] >= 0, i[0] + r0, -1))
        for q in range(p):
            if not lists[q][0]:  # no tiles: the wrapper's (+inf, -1)
                assert bool(torch.isinf(whole[0][q]).all()) and bool((whole[1][q] == -1).all())
                continue
            mv, mi = _merge_lists(*lists[q], k)
            assert torch.equal(mv, whole[0][q]) and torch.equal(mi, whole[1][q])
    # the smoke's Q = 16 over 100M rows: four units of four tables, one wave
    # of 396 blocks (132 SMs x 3), runs of 986-987 tiles
    plan = k_topk.run_plan([97_657] * 4, 396)
    per_block = np.bincount(plan["block"], weights=plan["t1"] - plan["t0"])
    assert plan["nb"] == 396 and per_block.min() == 986 and per_block.max() == 987


def test_adc_topk_grouped():
    """Grouped B6 equals `adc_topk` per group (and the reference's kernel in
    interpret mode on that group), empty groups and groups smaller than k
    included; rows are numbered from each group's first."""
    rng = _rng(19)
    m, k, bn = 8, 12, 128
    sizes = [300, 0, 5, 700, 129]
    n_tab = [3, 2, 1, 6, 0]
    luts = _luts(rng, sum(n_tab), m)
    codes = _codes(rng, sum(sizes), m)
    r_off = np.concatenate([[0], np.cumsum(sizes)])
    t_off = np.concatenate([[0], np.cumsum(n_tab)])
    got = ops.adc_topk_grouped(_t(luts), _t(codes), k, r_off, t_off, block_n=bn)
    assert got[0].shape == (sum(n_tab), k)
    for gi in range(len(sizes)):
        t0, t1, r0, r1 = t_off[gi], t_off[gi + 1], r_off[gi], r_off[gi + 1]
        if t1 == t0:
            continue
        if r1 == r0:
            assert bool(torch.isinf(got[0][t0:t1]).all()) and bool((got[1][t0:t1] == -1).all())
            continue
        one = ops.adc_topk(_t(luts[t0:t1]), _t(codes[r0:r1]), k, block_n=bn)
        assert torch.equal(got[0][t0:t1], one[0]) and torch.equal(got[1][t0:t1], one[1])
        if r1 - r0 >= k:  # the reference's top_k needs k rows (ROADMAP C1)
            want = jops.adc_topk(jnp.asarray(luts[t0:t1]), jnp.asarray(codes[r0:r1]), k,
                                 block_n=bn)
            assert_topk((got[0][t0:t1], got[1][t0:t1]), want)
    with pytest.raises(ValueError, match="offsets"):
        ops.adc_topk_grouped(_t(luts), _t(codes), k, [0, 10, 5], [0, 1, 2], block_n=bn)


def test_refusals():
    lut = torch.zeros(8, 256)
    codes = torch.zeros(10, 8, dtype=torch.uint8)
    addrs = torch.zeros(10, 8, dtype=torch.int32)
    win = torch.zeros(2, 256, 8, dtype=torch.int32)
    nv = torch.ones(2, dtype=torch.int32)
    calls = [
        lambda **kw: ops.adc_scan(lut, codes, **kw),
        lambda **kw: ops.adc_scan_flat(lut.reshape(-1), addrs, **kw),
        lambda **kw: ops.adc_topk(lut[None], codes, 3, **kw),
        lambda **kw: ops.adc_topk_flat(lut.reshape(1, -1), addrs, 3, **kw),
        lambda **kw: ops.adc_topk_pairs(lut.reshape(1, -1).expand(2, -1).contiguous(), win,
                                        nv, 3, block_n=256, **kw),
    ]
    # path="onehot" is ported: each call returns the reference's result
    # (raw uint8 codes: the gather's; direct addresses: allclose), and an
    # unknown path is refused
    ref_calls = [
        lambda **kw: jops.adc_scan(jnp.asarray(lut), jnp.asarray(codes), block_n=256, **kw),
        lambda **kw: jops.adc_scan_flat(jnp.asarray(lut.reshape(-1)), jnp.asarray(addrs),
                                        block_n=256, **kw),
        lambda **kw: jops.adc_topk(jnp.asarray(lut[None]), jnp.asarray(codes), 3, block_n=256,
                                   **kw),
        lambda **kw: jops.adc_topk_flat(jnp.asarray(lut.reshape(1, -1)), jnp.asarray(addrs), 3,
                                        block_n=256, **kw),
        lambda **kw: jops.adc_topk_pairs(
            jnp.asarray(lut.reshape(1, -1).expand(2, -1)), jnp.asarray(win), jnp.asarray(nv), 3,
            block_n=256, **kw),
    ]
    for call, ref_call in zip(calls, ref_calls):
        got, want = call(path="onehot"), ref_call(path="onehot")
        if isinstance(got, tuple):
            assert_topk(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        with pytest.raises(ValueError, match="path must be"):
            call(path="mxu")
    # k past the shared-memory block's range (ADC_TOPK_K_MAX) is served, as
    # the reference serves it (the in-place block on the card)
    rng = np.random.default_rng(7)
    big_lut = rng.random((1, 8, 256), dtype=np.float32)
    big_codes = rng.integers(0, 256, (4500, 8)).astype(np.uint8)
    k = ops.ADC_TOPK_K_MAX + 1
    assert_topk(ops.adc_topk(_t(big_lut), _t(big_codes), k),
                jops.adc_topk(jnp.asarray(big_lut), jnp.asarray(big_codes), k))
    with pytest.raises(TypeError, match="uint8"):
        ops.adc_scan_flat(lut.reshape(-1), codes)
    with pytest.raises(ValueError, match="multiple of block_n"):
        ops.adc_topk_pairs(lut.reshape(1, -1).expand(2, -1).contiguous(), win, nv, 3,
                           block_n=100)
    # k above the rows: (+inf, -1) lanes; k up to the limit works
    v, i = ops.adc_topk(lut[None], codes, 256)
    assert (i[0, :10] >= 0).all() and (i[0, 10:] == -1).all() and torch.isinf(v[0, 10:]).all()
