"""Hypothesis properties of §4.3 co-occurrence encoding, held in the port
and against the reference on the same random inputs (the twin of
`tests/test_cooc_props.py`, without the incremental repack, which belongs
to the mutable path).

For any codes: the port's mined combos and re-encoded addresses equal the
reference's; re-encoding keeps ADC distances (flat scan over the extended
table == plain scan, allclose, as in the reference); every matched combo
shortens a row by combo_len - 1; decoding a row covers every PQ column
exactly once; and the §4.4 bounds stay sound against the flat scan.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import cooc as rcooc  # noqa: E402
from repro_torch.core import cooc as tcooc  # noqa: E402
from repro_torch.core.lut import build_lut  # noqa: E402
from repro_torch.core.scheduling import residual_bounds, subspace_code_norms  # noqa: E402
from repro_torch.core.search import adc_scan  # noqa: E402
from repro_torch.kernels.ref import adc_scan_flat_ref  # noqa: E402

SETTINGS = dict(max_examples=20, deadline=None)
NCODES = tcooc.NCODES


def _mine_both(codes, n_combos, combo_len=3):
    r = rcooc.mine_combos(codes, n_combos=n_combos, combo_len=combo_len,
                          max_rows=len(codes))
    t = tcooc.mine_combos(codes, n_combos=n_combos, combo_len=combo_len,
                          max_rows=len(codes), device="cpu")
    for f in ("cols", "codes", "support"):
        np.testing.assert_array_equal(getattr(r, f), getattr(t, f))
    return t


@given(
    n=st.integers(10, 400),
    m=st.sampled_from([4, 8, 16]),
    n_combos=st.integers(1, 32),
    seed=st.integers(0, 10_000),
)
@settings(**SETTINGS)
def test_property_distance_invariance(n, m, n_combos, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 7, (n, m)).astype(np.uint8)
    combos = _mine_both(codes, n_combos)
    enc = tcooc.reencode(codes, combos, device="cpu")
    np.testing.assert_array_equal(enc.addrs, rcooc.reencode(codes, combos).addrs)
    lut = torch.as_tensor(rng.normal(0, 1, (m, 256)).astype(np.float32))
    ext = tcooc.build_ext_lut(lut, combos.cols, combos.codes)
    d_plain = adc_scan(lut, torch.as_tensor(codes)).numpy()
    d_flat = adc_scan_flat_ref(ext, torch.as_tensor(enc.addrs.astype(np.int32))).numpy()
    np.testing.assert_allclose(d_plain, d_flat, rtol=1e-4, atol=1e-4)


@given(seed=st.integers(0, 10_000), combo_len=st.sampled_from([2, 3]))
@settings(**SETTINGS)
def test_property_reencode_lengths(seed, combo_len):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, (200, 8)).astype(np.uint8)
    combos = _mine_both(codes, 16, combo_len)
    enc = tcooc.reencode(codes, combos, device="cpu")
    renc = rcooc.reencode(codes, combos)
    np.testing.assert_array_equal(enc.lengths, renc.lengths)
    assert ((8 - enc.lengths) % (combos.combo_len - 1) == 0).all()
    assert int(enc.addrs.max(initial=0)) < enc.table_size


@given(
    n=st.integers(30, 200),
    m=st.sampled_from([4, 8]),
    n_combos=st.integers(1, 16),
    seed=st.integers(0, 10_000),
)
@settings(**SETTINGS)
def test_property_combo_coverage_exactly_once(n, m, n_combos, seed):
    """Overlapping anchors included: every address is the row's own
    (col, code) entry or a combo the row carries, each column once."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 6, (n, m)).astype(np.uint8)
    combos = _mine_both(codes, n_combos)
    enc = tcooc.reencode(codes, combos, device="cpu")
    np.testing.assert_array_equal(enc.addrs, rcooc.reencode(codes, combos).addrs)
    flat_lut = m * NCODES
    for i in range(n):
        covered = np.zeros(m, np.int64)
        for a in enc.addrs[i, : enc.lengths[i]].astype(np.int64):
            if a < flat_lut:
                col, code = divmod(int(a), NCODES)
                assert codes[i, col] == code
                covered[col] += 1
            else:
                s = int(a) - flat_lut
                assert s < combos.n_combos
                assert (codes[i, combos.cols[s]] == combos.codes[s]).all()
                covered[combos.cols[s]] += 1
        assert (covered == 1).all()
        assert (enc.addrs[i, enc.lengths[i] :] == enc.sentinel).all()


@given(
    m=st.sampled_from([4, 8]),
    n_combos=st.integers(1, 16),
    seed=st.integers(0, 10_000),
)
@settings(**SETTINGS)
def test_property_bounds_sound_under_cooc(m, n_combos, seed):
    rng = np.random.default_rng(seed)
    dsub, n = 4, 150
    codebook = rng.normal(0, 1, (m, NCODES, dsub)).astype(np.float32)
    codes = rng.integers(0, 9, (n, m)).astype(np.uint8)
    combos = _mine_both(codes, n_combos)
    enc = tcooc.reencode(codes, combos, device="cpu")
    resid = rng.normal(0, 2, (m * dsub,)).astype(np.float32)
    lut = build_lut(torch.as_tensor(codebook), torch.as_tensor(resid))
    ext = tcooc.build_ext_lut(lut, combos.cols, combos.codes)
    d_flat = adc_scan_flat_ref(ext, torch.as_tensor(enc.addrs.astype(np.int32))).numpy()
    lb, ub = residual_bounds(resid[None, None, :], subspace_code_norms(codebook))
    lb, ub = float(lb[0, 0]), float(ub[0, 0])
    assert (d_flat >= lb).all(), "cooc distance fell below the lower bound"
    assert (d_flat <= ub).all(), "cooc distance exceeded the upper bound"
    d_plain = adc_scan(lut, torch.as_tensor(codes)).numpy()
    assert lb <= float(d_plain.min(initial=np.inf))
