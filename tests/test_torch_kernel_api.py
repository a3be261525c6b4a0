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


def test_adc_topk_plain_splits_and_chunks_agree(monkeypatch):
    """The plain B6 merges rows chunk by chunk; its result does not depend
    on the chunk, as the kernel's does not depend on its split count."""
    rng = _rng(17)
    luts, codes = _t(_luts(rng, 3, 8)), _t(_codes(rng, 1900, 8))
    bound = torch.tensor([np.inf, 30.0, 20.0], dtype=torch.float32)
    want = ops.adc_topk(luts, codes, 37, block_n=128, bound=bound)
    monkeypatch.setattr(k_topk, "_PLAIN_ROWS", 3 * 128)
    got = ops.adc_topk(luts, codes, 37, block_n=128, bound=bound)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert k_topk.topk_splits(1900, 3, 128) == (15, 1)
    assert k_topk.topk_splits(100_000_000, 1, 1024) == (2035, 48)
    assert k_topk.topk_splits(100_000_000, 16, 1024) == (128, 763)


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
    for call in calls:
        with pytest.raises(NotImplementedError, match="queue D item 2"):
            call(path="onehot")
    with pytest.raises(ValueError, match="ADC_TOPK_K_MAX"):
        ops.adc_topk(lut[None], codes, ops.ADC_TOPK_K_MAX + 1)
    with pytest.raises(TypeError, match="uint8"):
        ops.adc_scan_flat(lut.reshape(-1), codes)
    with pytest.raises(ValueError, match="multiple of block_n"):
        ops.adc_topk_pairs(lut.reshape(1, -1).expand(2, -1).contiguous(), win, nv, 3,
                           block_n=100)
    # k above the rows: (+inf, -1) lanes; k up to the limit works
    v, i = ops.adc_topk(lut[None], codes, 256)
    assert (i[0, :10] >= 0).all() and (i[0, 10:] == -1).all() and torch.isinf(v[0, 10:]).all()
