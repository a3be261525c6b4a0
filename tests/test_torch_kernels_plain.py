"""The port's kernel wrappers (repro_torch.kernels.ops) on CPU tensors.

On the CPU each wrapper runs its kernel's plain PyTorch version, which
repeats the CUDA kernel's arithmetic step for step.  Held against the
reference's `repro.kernels.ops` (Pallas in interpret mode) at the same
inputs: tables and distances allclose(rtol=1e-5, atol=1e-5) (the two sum
f32 terms in different orders), rows and ids equal.  Inside the port:
the re-rank is bit-invariant across `block_k`, pruned == unpruned after
the per-query merge bit for bit, and the prune counters are sane.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_ref_parity import TOL, jax_tiles, merge_per_query, tile_case  # noqa: E402


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("dsub", [4, 8, 48])
def test_build_luts_matches_reference(dsub):
    rng = np.random.default_rng(dsub)
    m, n = 8, 37
    cb = rng.normal(size=(m, 256, dsub)).astype(np.float32)
    qmc = rng.normal(size=(n, m, dsub)).astype(np.float32)
    got = ops.build_luts(_t(cb), _t(qmc)).numpy()
    want = np.asarray(jops.build_luts(jnp.asarray(cb), jnp.asarray(qmc)))
    assert got.shape == (n, m, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dsub", [4, 8])
def test_build_luts_rows_selects_residuals(dsub):
    """With `rows`, row i is the table of residual rows[i], as the reference
    builds it from those residuals alone."""
    rng = np.random.default_rng(10 + dsub)
    m, n = 8, 23
    cb = rng.normal(size=(m, 256, dsub)).astype(np.float32)
    qmc = rng.normal(size=(n, m, dsub)).astype(np.float32)
    rows = np.array([5, 0, 22, 5, 13], np.int32)
    got = ops.build_luts(_t(cb), _t(qmc), _t(rows)).numpy()
    assert got.shape == (rows.size, m, 256)
    np.testing.assert_array_equal(got, ops.build_luts(_t(cb), _t(qmc)).numpy()[rows])
    want = np.asarray(jops.build_luts(jnp.asarray(cb), jnp.asarray(qmc[rows])))
    np.testing.assert_allclose(got, want, **TOL)


def _port_tiles(c, bounds: bool, luts=None, lut_row=None):
    """The port's scan of tile_case `c`; pair j reads table j by default."""
    kw = {}
    if bounds:
        kw = dict(pair_q=_t(c["pair_q"]), pair_lb=_t(c["pair_lb"]), bound=_t(c["bound"]))
    if lut_row is None:
        luts, lut_row = c["luts"], np.arange(c["luts"].shape[0], dtype=np.int32)
    v, i, s = ops.adc_topk_tiles(
        _t(luts), _t(c["codes"]), _t(c["tile_pair"]), _t(c["tile_block"]),
        _t(c["tile_row0"]), _t(c["sizes"]), c["k"], lut_row=_t(lut_row),
        block_n=c["block_n"], **kw,
    )
    return v.numpy(), i.numpy(), s.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adc_topk_tiles_matches_reference(seed):
    c = tile_case(seed)
    pv, pi, ps = _port_tiles(c, bounds=False)
    jv, ji = jax_tiles(c, bounds=False)
    np.testing.assert_allclose(pv, jv, **TOL)
    np.testing.assert_array_equal(pi, ji)
    assert (ps == 0).all()

    bv, bi, bs = _port_tiles(c, bounds=True)
    jv, ji = jax_tiles(c, bounds=True)
    got = merge_per_query(bv, bi, c["pair_q"], c["q"], c["k"])
    want = merge_per_query(jv, ji, c["pair_q"], c["q"], c["k"])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(got[1], want[1])
    # inside the port the pruned scan is the unpruned one, bit for bit
    unpruned = merge_per_query(pv, pi, c["pair_q"], c["q"], c["k"])
    np.testing.assert_array_equal(got[0], unpruned[0])
    np.testing.assert_array_equal(got[1], unpruned[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_adc_topk_tiles_lut_row(seed):
    """Compact tables addressed through `lut_row` give each pair's result
    bit for bit; a pair without a table (-1) is not scanned."""
    c = tile_case(seed)
    p = c["luts"].shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(p)
    lut_row = np.argsort(perm).astype(np.int32)  # pair j reads row lut_row[j]
    dropped = int(np.flatnonzero(c["sizes"] > 0)[0])
    lut_row[dropped] = -1
    compact = c["luts"][perm]
    for bounds in (False, True):
        full = _port_tiles(c, bounds=bounds)
        v, i, s = _port_tiles(c, bounds=bounds, luts=compact, lut_row=lut_row)
        assert np.isinf(v[dropped]).all() and (i[dropped] == -1).all()
        assert (s[dropped] == 0).all()
        if not bounds:  # without coupling, every other pair is untouched
            keep = np.arange(p) != dropped
            np.testing.assert_array_equal(v[keep], full[0][keep])
            np.testing.assert_array_equal(i[keep], full[1][keep])


@pytest.mark.parametrize("seed", [0, 3])
def test_prune_stats_sanity(seed):
    c = tile_case(seed, q=3, nprobe=8, block_n=32, spread=2.0)
    n_tiles = (c["sizes"] + c["block_n"] - 1) // c["block_n"]
    _, _, stats = _port_tiles(c, bounds=True)
    assert (stats[:, 0] >= 0).all() and (stats[:, 0] <= n_tiles).all()
    assert (stats[:, 1] >= 0).all() and (stats[:, 1] <= c["sizes"]).all()
    assert stats[:, 0].sum() > 0  # the bounds do skip work on this case
    # +-inf bounds with real query coupling: no tile is skipped
    c["pair_lb"] = np.full_like(c["pair_lb"], -np.inf)
    c["bound"] = np.full_like(c["bound"], np.inf)
    _, _, stats = _port_tiles(c, bounds=True)
    assert (stats == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rerank_dists_matches_reference(dtype):
    rng = np.random.default_rng(7)
    q, kc, d = 5, 11, 48
    queries = rng.normal(size=(q, d)).astype(np.float32)
    vecs = rng.normal(size=(q, kc, d)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jops.rerank_dists(jnp.asarray(queries), jnp.asarray(vecs).astype(jd)))

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    store = _t(vecs.reshape(q * kc, d)).to(tdt)
    cand = torch.arange(q * kc, dtype=torch.int32).reshape(q, kc)
    id_dev = torch.zeros(q * kc + 3, dtype=torch.int32)
    id_dev[-1] = -1  # an unmapped id
    id_row = torch.arange(q * kc + 3, dtype=torch.int32)
    row_base = torch.zeros(1, dtype=torch.int64)
    got = ops.rerank_dists(_t(queries), cand, store, id_dev, id_row, row_base).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    # a candidate's sum never reads its neighbours: bit-invariant in block_k
    for bk in (1, 3, 8, 64):
        again = ops.rerank_dists(_t(queries), cand, store, id_dev, id_row, row_base, block_k=bk)
        np.testing.assert_array_equal(again.numpy(), got)

    # -1, out-of-map and unmapped candidates read +inf
    bad = cand.clone()
    bad[0, 0], bad[1, 2], bad[2, 3] = -1, 10_000, q * kc + 2
    out = ops.rerank_dists(_t(queries), bad, store, id_dev, id_row, row_base).numpy()
    assert np.isinf(out[0, 0]) and np.isinf(out[1, 2]) and np.isinf(out[2, 3])
    keep = np.isfinite(out)
    np.testing.assert_array_equal(out[keep], got[keep])


def test_wrappers_refuse_bad_inputs():
    cb = torch.zeros(4, 256, 2)
    with pytest.raises(TypeError):
        ops.build_luts(cb, torch.zeros(3, 4, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.build_luts(cb, torch.zeros(3, 5, 2))
    with pytest.raises(ValueError):
        ops.build_luts(cb, torch.zeros(3, 2, 4).transpose(1, 2))
    q = torch.zeros(2, 8)
    with pytest.raises(TypeError):
        ops.rerank_dists(q, torch.zeros(2, 3, dtype=torch.int64), torch.zeros(4, 8),
                         torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int64))
    luts = torch.zeros(2, 4, 256)
    codes = torch.zeros(1, 100, 4, dtype=torch.uint8)
    tiles = torch.zeros(1, 2, dtype=torch.int32)
    rows = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="block_n"):
        ops.adc_topk_tiles(luts, codes, tiles, tiles, tiles, torch.zeros(1, 2), 4,
                           lut_row=rows, block_n=64)
    with pytest.raises(ValueError, match="lut_row"):
        ops.adc_topk_tiles(luts, codes, tiles, tiles, tiles, torch.zeros(1, 2), 4,
                           lut_row=torch.zeros(2, 2, dtype=torch.int32), block_n=50)
    with pytest.raises(ValueError, match="luts"):  # tables must be (R, M, 256)
        ops.adc_topk_tiles(torch.zeros(1, 2, 4, 256), codes, tiles, tiles, tiles,
                           torch.zeros(1, 2), 4, lut_row=rows, block_n=50)
    with pytest.raises(TypeError):
        ops.build_luts(cb, torch.zeros(3, 4, 2), torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_runs_match_tile_queue(seed):
    """Run ranges [t0, t1) and launch order from random contiguous queues."""
    from repro_torch.kernels.adc_topk import pair_runs

    rng = np.random.default_rng(seed)
    for _ in range(50):
        ndev, p, t = int(rng.integers(1, 4)), int(rng.integers(1, 9)), int(rng.integers(1, 30))
        tp = np.full((ndev, t), p, np.int32)  # dummy tiles carry pair id P
        for d in range(ndev):
            pos = 0
            for pair in rng.permutation(p):
                n = min(int(rng.integers(0, 4)), t - pos)
                tp[d, pos : pos + n] = pair
                pos += n
        t0, t1, order = pair_runs(torch.as_tensor(tp), p)
        for d in range(ndev):
            for pair in range(p):
                idx = np.flatnonzero(tp[d] == pair)
                g = d * p + pair
                if idx.size:
                    assert (int(t0[g]), int(t1[g])) == (d * t + idx[0], d * t + idx[-1] + 1)
                else:
                    assert int(t0[g]) >= int(t1[g])
        assert sorted(order.tolist()) == list(range(ndev * p))
