"""The in-place block (csrc/adc_topk_wide.cu) on the CPU: its plan, its
interleaved tables and its units, against the plain versions and the
reference.

B6 / B7 / B2 / B5 read a table too wide for shared memory (a uint16 address
space of 65,536 entries) where it lies.  `adc_topk.topk_plan` picks B6's
tables a unit (G = 1, 2 or 4) by its cost model at the in-place lookup
costs; at G > 1 the launcher interleaves each unit's tables as [A][G]
(`adc_topk.interleave_plain` is that kernel's twin); B2 / B5's pairs are
units whose tiles `run_plan` cuts over the grid.  Held here: the model's
choice, the interleave against a numpy transpose, unit-by-unit scoring
from the interleaved tables against `adc_topk_plain` /
`adc_topk_grouped_plain` and the reference (distances rtol = atol = 1e-5,
ids equal outside exact ties, the parity tests' tolerance), and the split
of the smoke row's 30 pairs over the grid.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from _one_thread import one_thread  # noqa: E402,F401
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import adc_topk as k_topk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_kernel_api import assert_topk  # noqa: E402

BUDGET = 232_448  # bytes of shared memory one H100 block may use
A = 65_536        # a uint16 address space


def _model_g(nq, rows, k, w=16, groups=k_topk.INPLACE_GROUPS):
    """The G of least modelled time, written out: per unit of G tables its
    rows times the larger of the code bytes over HBM and W * G lookups at
    the in-place clocks."""
    def cost(g):
        per_row = max(w * 2 / k_topk._HBM_BYTES_PER_S,
                      w * g * k_topk._INPLACE_CLOCKS[g] / 32 / k_topk._SM_LOOKUPS_PER_S)
        return sum(-(-q // g) * r for q, r in zip(nq, rows)) * per_row
    return min(groups, key=lambda g: (cost(g), -g))


@pytest.mark.parametrize("k", [10, 64, 4096])
@pytest.mark.parametrize("q", [1, 2, 3, 4, 5, 8])
def test_inplace_plan_picks_the_model_g(q, k):
    """B6 on a 65,536-entry uint16 table: the in-place block at the G its
    cost model picks (four tables a unit for the smoke's Q = 4), with its
    lists beside no table within one block's shared memory; B7 (groups of
    one) stays at G = 1."""
    plan = k_topk.topk_plan([q], [2_000_000], k, 1, 16, A)
    assert plan["gtab"] and not plan["select"]
    assert plan["g"] == _model_g([q], [2_000_000], k)
    assert plan["smem"] == k_topk.topk_smem(plan["g"], k, 0)
    assert plan["smem"] + 4096 <= BUDGET
    if q == 4:
        assert plan["g"] == 4
    b7 = k_topk.topk_plan([1] * q, [65_536] * q, k, 1, 16, A, groups=(1,))
    assert b7["g"] == 1 and b7["gtab"] and b7["smem"] == k_topk.topk_smem(1, k, 0)


def test_inplace_plan_grouped_units():
    """Grouped B6 (the flat search's call) over wide tables: the model's G
    over groups of 1 to 6 tables, and the units of that G cover every
    table of a group with rows once, the last of a group ragged."""
    nq, rows = [4, 3, 1, 6, 2], [9000, 6000, 6000, 9000, 0]
    plan = k_topk.topk_plan(nq, rows, 10, 1, 16, A)
    assert plan["gtab"] and plan["g"] == _model_g(nq, rows, 10)
    r_off = np.concatenate([[0], np.cumsum(rows)]).tolist()
    t_off = np.concatenate([[0], np.cumsum(nq)]).tolist()
    for g in k_topk.INPLACE_GROUPS:
        units = k_topk.topk_units(r_off, t_off, g).numpy()
        assert (units[:, 3] <= g).all() and (units[:, 3] >= 1).all()
        covered = np.concatenate([np.arange(q0, q0 + n) for _, _, q0, n in units])
        assert sorted(covered) == list(range(t_off[-2]))  # the last group has no rows


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("q", [1, 3, 4, 6])
def test_interleave_plain_is_a_transpose(q, g):
    """The interleave's plain twin: unit u's tables as [A][G], equal to a
    numpy transpose of ceil(Q / G) blocks of G tables, 0.0 past the last
    table (a ragged last unit); grouped units take their own rows."""
    rng = np.random.default_rng(q * 10 + g)
    a_used = 300
    tables = rng.random((q, a_used + 7), dtype=np.float32)
    got = k_topk.interleave_plain(torch.from_numpy(tables), None, g, a_used).numpy()
    n_units = -(-q // g)
    pad = np.zeros((n_units * g, a_used), np.float32)
    pad[:q] = tables[:, :a_used]
    want = pad.reshape(n_units, g, a_used).transpose(0, 2, 1)
    np.testing.assert_array_equal(got, want)
    units = torch.tensor([[0, 5, q - 1, 1], [5, 9, 0, min(q, g)]], dtype=torch.int32)
    got = k_topk.interleave_plain(torch.from_numpy(tables), units, g, a_used).numpy()
    np.testing.assert_array_equal(got[0, :, 0], tables[q - 1, :a_used])
    assert not got[0, :, 1:].any()
    np.testing.assert_array_equal(got[1, :, : min(q, g)], tables[: min(q, g), :a_used].T)


def _from_units(tables, codes, bound, k, block_n, units, g, path):
    """B6 unit by unit as the in-place block reads it: each unit's table j
    taken from the interleaved [A][G] block (G = 1: the table itself),
    scored over the unit's rows, into output row q0 + j."""
    q_n = tables.shape[0]
    a_used = tables.shape[1]
    ilv = k_topk.interleave_plain(tables, units, g, a_used)
    out_v = torch.full((q_n, k), torch.inf)
    out_i = torch.full((q_n, k), -1, dtype=torch.int32)
    for u, (r0, n, q0, nq) in enumerate(units.tolist()):
        for j in range(nq):
            tab = ilv[u, :, j][None].contiguous()
            v, i = k_topk.adc_topk_plain(tab, codes[r0:r0 + n], bound[q0 + j:q0 + j + 1], k,
                                         block_n, path)
            out_v[q0 + j], out_i[q0 + j] = v[0], i[0]
    return out_v, out_i


@pytest.mark.parametrize("path", ["gather", "onehot"])
def test_plain_b6_by_units_same_at_g1_and_g4(path):
    """The plain B6 versions answer the same whether the tables are read
    one a unit (G = 1) or from four interleaved (G = 4, a ragged last unit
    of one table), over one code array and over groups; and the port's
    CPU wrapper gives the reference's answer on those 65,536-entry
    tables."""
    rng = np.random.default_rng(5)
    q, n = 5, 700
    tables = rng.random((q, A), dtype=np.float32)
    tables[:, -1] = 0.0
    addrs = rng.integers(0, A, (n, 8)).astype(np.uint16)
    tt, ta = torch.from_numpy(tables), torch.from_numpy(addrs)
    inf = torch.full((q,), torch.inf)
    whole = k_topk.adc_topk_plain(tt, ta, inf, 10, 128, path)
    for g in (1, 4):
        units = torch.tensor([[0, n, q0, min(g, q - q0)] for q0 in range(0, q, g)],
                             dtype=torch.int32)
        got = _from_units(tt, ta, inf, 10, 128, units, g, path)
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    r_off, t_off = [0, 300, 700], [0, 4, 5]
    grouped = k_topk.adc_topk_grouped_plain(tt, ta, inf, 10, 128, r_off, t_off, path)
    for g in (1, 4):
        got = _from_units(tt, ta, inf, 10, 128, k_topk.topk_units(r_off, t_off, g), g, path)
        assert torch.equal(got[0], grouped[0]) and torch.equal(got[1], grouped[1])
    port = ops.adc_topk_flat(tt, ta, 10, block_n=128, path=path)
    assert torch.equal(port[0], whole[0]) and torch.equal(port[1], whole[1])
    want = jops.adc_topk_flat(jnp.asarray(tables), jnp.asarray(addrs), 10, block_n=128,
                              path=path)
    assert_topk(port, want)


def test_smoke_row_pairs_split_over_the_grid():
    """B2 / B5 in place at the smoke's row (30 windows of 65,536 rows, the
    first empty, 7 rows and full, block_n 1024) on the grid the in-place
    kernel takes on an H100 (132 SMs, 4 resident blocks): the units' tiles
    (`scan_unit_starts`, the kernel's `ustart`) cut over the grid split
    pairs over several blocks, and every pair's runs cover its tiles
    once."""
    rng = np.random.default_rng(27)
    p, win, bn = 30, 65_536, 1024
    n_valid = rng.integers(0, win + 1, p).astype(np.int32)
    n_valid[:3] = [0, 7, win]
    nv = torch.from_numpy(n_valid)
    own = torch.arange(p, dtype=torch.int32)
    starts = own * win
    t0w, t1w, _, _ = k_topk.window_runs(starts, nv, own, bn)
    tile_pair = torch.repeat_interleave(own, (t1w - t0w).long())
    t0, t1, order = k_topk.pair_runs(tile_pair[None], p)
    filled = torch.nonzero(nv > 0).flatten().int()
    tiles_t = k_topk.scan_unit_tiles(order, own, nv, bn, t0, t1)
    tiles_w = k_topk.scan_unit_tiles(filled, own, nv, bn)
    assert sorted(tiles_t[tiles_t > 0]) == sorted(tiles_w)
    ustart = k_topk.scan_unit_starts(filled, own, nv, bn)
    np.testing.assert_array_equal(np.diff(ustart.numpy()), tiles_w)
    runs = k_topk.run_plan(tiles_w, 132 * 4)
    assert runs["nb"] == 132 * 4 and runs["T"] == int(tiles_w.sum())
    split = runs["first"] < runs["last"]
    assert split.sum() > 0 and int(tiles_w.max()) > runs["T"] / runs["nb"]
    for u, t in enumerate(tiles_w):
        mine = runs["unit"] == u
        assert (runs["t1"][mine] - runs["t0"][mine]).sum() == t
        assert (np.unique(runs["slot"][mine]).size == mine.sum())
