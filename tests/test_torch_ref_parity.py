"""The port's plain oracles (repro_torch.kernels.ref) against the reference's.

Same numpy inputs through `repro.kernels.ref` (jnp) and its PyTorch
counterpart.  Tolerance: allclose(rtol=1e-5, atol=1e-5) on f32 values,
because the two packages add the same f32 terms in different orders;
indices must be equal.  The plain tiles scan `adc_topk_tiles_ref` is held
against the reference tile kernel (`ops.adc_topk_tiles`, Pallas in
interpret mode on the CPU): per pair with no bounds, and after the
per-query merge with the pruning bounds on.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.scheduling import (  # noqa: E402
    emit_tiles,
    residual_bounds,
    subspace_code_norms,
    warm_start_bounds,
)
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("m,n", [(8, 300), (16, 97)])
def test_adc_scan_refs(m, n):
    rng = np.random.default_rng(m + n)
    lut = rng.random((m, 256), dtype=np.float32)
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    np.testing.assert_allclose(
        _np(tref.adc_scan_ref(_t(lut), _t(codes))),
        _np(jref.adc_scan_ref(jnp.asarray(lut), jnp.asarray(codes))), **TOL,
    )
    ext = rng.random(m * 256 + 5, dtype=np.float32)
    addrs = rng.integers(0, ext.shape[0], (n, m + 2)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tref.adc_scan_flat_ref(_t(ext), _t(addrs))),
        _np(jref.adc_scan_flat_ref(jnp.asarray(ext), jnp.asarray(addrs))), **TOL,
    )


@pytest.mark.parametrize("n_valid", [None, 150])
def test_adc_topk_refs(n_valid):
    rng = np.random.default_rng(1)
    q, m, n, k = 3, 8, 200, 12
    luts = rng.random((q, m, 256), dtype=np.float32)
    codes = rng.integers(0, 256, (n, m)).astype(np.uint8)
    tv, ti = tref.adc_topk_ref(_t(luts), _t(codes), k, n_valid)
    jv, ji = jref.adc_topk_ref(jnp.asarray(luts), jnp.asarray(codes), k, n_valid)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)
    np.testing.assert_array_equal(_np(ti), _np(ji))

    ext = rng.random((q, m * 256 + 3), dtype=np.float32)
    addrs = rng.integers(0, ext.shape[1], (n, m)).astype(np.int32)
    tv, ti = tref.adc_topk_flat_ref(_t(ext), _t(addrs), k, n_valid)
    jv, ji = jref.adc_topk_flat_ref(jnp.asarray(ext), jnp.asarray(addrs), k, n_valid)
    np.testing.assert_allclose(_np(tv), _np(jv), **TOL)
    np.testing.assert_array_equal(_np(ti), _np(ji))


@pytest.mark.parametrize("dsub", [4, 8])
def test_lut_and_rerank_refs(dsub):
    rng = np.random.default_rng(dsub)
    m, q, kc = 4, 5, 9
    cb = rng.normal(size=(m, 256, dsub)).astype(np.float32)
    qmc = rng.normal(size=(q, m, dsub)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tref.lut_build_ref(_t(cb), _t(qmc))),
        _np(jref.lut_build_ref(jnp.asarray(cb), jnp.asarray(qmc))), **TOL,
    )
    d = m * dsub
    queries = rng.normal(size=(q, d)).astype(np.float32)
    cand = rng.normal(size=(q, kc, d)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tref.rerank_dists_ref(_t(queries), _t(cand))),
        _np(jref.rerank_dists_ref(jnp.asarray(queries), jnp.asarray(cand))), **TOL,
    )
    luts = rng.random((q, m, 256), dtype=np.float32)
    cols = rng.integers(0, m, (6, 3)).astype(np.int32)
    cods = rng.integers(0, 256, (6, 3)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tref.ext_lut_build_ref(_t(luts), _t(cols), _t(cods))),
        _np(jref.ext_lut_build_ref(jnp.asarray(luts), jnp.asarray(cols), jnp.asarray(cods))),
        **TOL,
    )


def tile_case(seed, q=4, nprobe=5, m=8, dsub=4, block_n=64, k=10, spread=0.0):
    """A one-device pair layout with real bounds: (dict of numpy inputs).

    `spread` > 0 scales the j-th probed residual of every query by
    1 + spread * j, so far clusters have lower bounds past the near ones'.
    """
    rng = np.random.default_rng(seed)
    p = q * nprobe
    cb = rng.normal(size=(m, 256, dsub)).astype(np.float32)
    qmc = rng.normal(0, 2, size=(q, nprobe, m * dsub)).astype(np.float32)
    qmc *= (1.0 + spread * np.arange(nprobe, dtype=np.float32))[None, :, None]
    sizes = rng.integers(0, 3 * block_n, p).astype(np.int32)
    sizes[rng.integers(0, p)] = 0            # one empty cluster
    sizes[rng.integers(0, p)] = 3            # one smaller than k
    aligned = (sizes + block_n - 1) // block_n * block_n
    starts = np.zeros(p, np.int32)
    starts[1:] = np.cumsum(aligned)[:-1]
    cap = max(int(aligned.sum()), block_n)
    codes = rng.integers(0, 256, (cap, m)).astype(np.uint8)
    luts = np.asarray(jref.lut_build_ref(jnp.asarray(cb), jnp.asarray(qmc.reshape(p, m, dsub))))
    lb, ub = residual_bounds(qmc, subspace_code_norms(cb))
    b0 = warm_start_bounds(ub, sizes.reshape(q, nprobe), k)
    n_tiles = int(((sizes + block_n - 1) // block_n).sum())
    tp, tb, tr = emit_tiles(
        np.arange(p, dtype=np.int32)[None], np.ones((1, p), bool), starts[None],
        sizes[None], block_n, n_tiles + 3, pair_key=lb.reshape(1, p),
    )
    return dict(
        luts=luts, codes=codes, starts=starts, sizes=sizes, tile_pair=tp[0],
        tile_block=tb[0], tile_row0=tr[0], pair_q=np.repeat(np.arange(q), nprobe).astype(np.int32),
        pair_lb=lb.reshape(-1), bound=b0, q=q, k=k, block_n=block_n,
    )


def jax_tiles(c, bounds: bool):
    p = c["luts"].shape[0]
    tables = np.concatenate([c["luts"].reshape(p, -1), np.zeros((p, 1), np.float32)], axis=1)
    kw = {}
    if bounds:
        kw = dict(pair_q=jnp.asarray(c["pair_q"]), pair_lb=jnp.asarray(c["pair_lb"]),
                  bound=jnp.asarray(c["bound"]), n_queries=c["q"])
    v, i = jops.adc_topk_tiles(
        jnp.asarray(tables), jnp.asarray(c["codes"]), jnp.asarray(c["tile_pair"]),
        jnp.asarray(c["tile_block"]), jnp.asarray(c["tile_row0"]),
        jnp.asarray(c["sizes"]), c["k"], block_n=c["block_n"], add_offsets=True, **kw,
    )
    v, i = np.array(v), np.array(i)
    empty = c["sizes"] <= 0  # undefined rows in the reference's contract
    v[empty], i[empty] = np.inf, -1
    return v, i


def merge_per_query(vals, rows, pair_q, q, k):
    """Per query: pairs' lists in pair order, stable by value, first k.

    Returns (dists (Q, k), (pair, row) ids (Q, k, 2)); +inf lanes id (-1, -1).
    """
    out_d = np.full((q, k), np.inf, np.float32)
    out_i = np.full((q, k, 2), -1, np.int64)
    for qi in range(q):
        ps = np.flatnonzero(pair_q == qi)
        d = vals[ps].reshape(-1)
        ids = np.stack([np.repeat(ps, vals.shape[1]), rows[ps].reshape(-1)], 1)
        sel = np.argsort(d, kind="stable")[:k]
        out_d[qi, : len(sel)] = d[sel]
        out_i[qi, : len(sel)] = np.where(np.isfinite(d[sel])[:, None], ids[sel], -1)
    return out_d, out_i


@pytest.mark.parametrize("seed", [0, 1])
def test_tiles_ref_matches_reference_kernel(seed):
    c = tile_case(seed)
    tv, ti = tref.adc_topk_tiles_ref(
        _t(c["luts"]), _t(c["codes"]), _t(c["starts"]), _t(c["sizes"]), c["k"]
    )
    tv, ti = _np(tv), _np(ti)
    # bounds off: every pair's own top-k
    jv, ji = jax_tiles(c, bounds=False)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_array_equal(ti, ji)
    # bounds on: the reference prunes; the merged per-query result holds
    jv, ji = jax_tiles(c, bounds=True)
    rd, ri = merge_per_query(tv, ti, c["pair_q"], c["q"], c["k"])
    pd, pi = merge_per_query(jv, ji, c["pair_q"], c["q"], c["k"])
    np.testing.assert_allclose(rd, pd, **TOL)
    np.testing.assert_array_equal(ri, pi)


def test_core_search_and_lut():
    from repro.core import lut as rlut
    from repro.core import search as rsearch
    from repro_torch.core import lut as tlut
    from repro_torch.core import search as tsearch

    rng = np.random.default_rng(11)
    d = rng.random((4, 50), dtype=np.float32)
    d[:, 7] = d[:, 3]  # exact ties keep the lower index
    tv, ti = tsearch.topk_smallest(_t(d), 9)
    jv, ji = rsearch.topk_smallest(jnp.asarray(d), 9)
    np.testing.assert_array_equal(_np(tv), _np(jv))
    np.testing.assert_array_equal(_np(ti), _np(ji))
    valid = rng.random((4, 50)) < 0.7
    tv, ti = tsearch.masked_topk_smallest(_t(d), _t(valid), 9)
    jv, ji = rsearch.masked_topk_smallest(jnp.asarray(d), jnp.asarray(valid), 9)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    ids_a, ids_b = rng.integers(0, 99, (4, 6)), rng.integers(0, 99, (4, 6))
    a, b = np.sort(d[:, :6]), np.sort(d[:, 6:12])
    tv, ti = tsearch.merge_topk(_t(a), _t(ids_a), _t(b), _t(ids_b), 6)
    jv, ji = rsearch.merge_topk(jnp.asarray(a), jnp.asarray(ids_a), jnp.asarray(b),
                                jnp.asarray(ids_b), 6)
    np.testing.assert_array_equal(_np(tv), _np(jv))
    np.testing.assert_array_equal(_np(ti), _np(ji))

    cb = rng.normal(size=(8, 256, 4)).astype(np.float32)
    r = rng.normal(size=(5, 32)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tlut.build_luts(_t(cb), _t(r))), _np(rlut.build_luts(jnp.asarray(cb), jnp.asarray(r))),
        **TOL,
    )
    np.testing.assert_allclose(
        _np(tlut.build_lut(_t(cb), _t(r[0]))),
        _np(rlut.build_lut(jnp.asarray(cb), jnp.asarray(r[0]))),
        **TOL,
    )
    codes = rng.integers(0, 256, (40, 8)).astype(np.uint8)
    lut = rng.random((8, 256), dtype=np.float32)
    np.testing.assert_allclose(
        _np(tsearch.adc_scan(_t(lut), _t(codes))),
        _np(rsearch.adc_scan(jnp.asarray(lut), jnp.asarray(codes))), **TOL,
    )
