"""Hypothesis twin of `tests/test_scheduling_props.py` for the port.

The three properties of the reference's file -- tile emission, the
load-biased cover and the failover cover -- run through
`repro_torch.core.scheduling` (and `repro_torch.core.placement`), and on
every drawn input the port's arrays must also `array_equal` the
reference's: tiles, placements, schedules (pairs, devices, loads) and the
lost pairs.  Skipped cleanly where hypothesis is missing.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")
pytest.importorskip("jax")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import placement as rplacement  # noqa: E402
from repro.core import scheduling as rsched  # noqa: E402
from repro_torch.core.placement import place_clusters  # noqa: E402
from repro_torch.core.scheduling import (  # noqa: E402
    count_tiles,
    emit_tiles,
    schedule_queries,
    schedule_queries_loop,
)

SETTINGS = dict(max_examples=25, deadline=None)


def _align(x, b):
    return -(-x // b) * b


def _random_layout(rng, ndev, n_slots, block_n, max_size):
    """Block-aligned per-device slot layout with zero-size slots allowed."""
    slot_size = rng.integers(0, max_size + 1, (ndev, n_slots)).astype(np.int32)
    slot_start = np.zeros((ndev, n_slots), np.int32)
    for d in range(ndev):
        cursor = 0
        for s in range(n_slots):
            slot_start[d, s] = cursor
            cursor += _align(max(int(slot_size[d, s]), 1), block_n)
    return slot_start, slot_size


def _schedules_equal(a, b):
    for name in ("pair_q", "pair_c", "pair_dev", "dev_load", "lost_q", "lost_c"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)


def _placements(rng, c, ndev):
    """The port's and the reference's Algorithm 1 on one drawn cluster set;
    their replica maps and loads must be equal."""
    sizes = (rng.zipf(1.4, c) * 20).clip(1, 20000).astype(np.int64)
    freqs = rng.zipf(1.3, c).astype(np.float64)
    cent = rng.normal(0, 1, (c, 8))
    pl = place_clusters(sizes, freqs, ndev, centroids=cent)
    rpl = rplacement.place_clusters(sizes, freqs, ndev, centroids=cent)
    assert pl.replicas == rpl.replicas
    np.testing.assert_array_equal(pl.dev_load, rpl.dev_load)
    return sizes, pl, rpl


@given(
    ndev=st.integers(1, 4),
    n_slots=st.integers(1, 6),
    p_cap=st.integers(1, 12),
    block_n=st.sampled_from([4, 8, 16]),
    seed=st.integers(0, 10_000),
)
@settings(**SETTINGS)
def test_tile_emission_properties(ndev, n_slots, p_cap, block_n, seed):
    rng = np.random.default_rng(seed)
    slot_start, slot_size = _random_layout(rng, ndev, n_slots, block_n, max_size=5 * block_n)
    pair_slot = rng.integers(0, n_slots, (ndev, p_cap)).astype(np.int32)
    pair_valid = rng.random((ndev, p_cap)) < 0.7
    pair_key = rng.random((ndev, p_cap)).astype(np.float32)

    nv = np.where(pair_valid, np.take_along_axis(slot_size, pair_slot, axis=1), 0)
    totals = count_tiles(pair_valid, nv, block_n)
    np.testing.assert_array_equal(totals, rsched.count_tiles(pair_valid, nv, block_n))
    t_cap = max(int(totals.max(initial=0)) + int(rng.integers(0, 4)), 1)
    tiles = emit_tiles(pair_slot, pair_valid, slot_start, slot_size, block_n, t_cap)
    want = rsched.emit_tiles(pair_slot, pair_valid, slot_start, slot_size, block_n, t_cap)
    for got, ref in zip(tiles, want):
        np.testing.assert_array_equal(got, ref)
    # and in best-first order
    for got, ref in zip(
        emit_tiles(pair_slot, pair_valid, slot_start, slot_size, block_n, t_cap,
                   pair_key=pair_key),
        rsched.emit_tiles(pair_slot, pair_valid, slot_start, slot_size, block_n, t_cap,
                          pair_key=pair_key),
    ):
        np.testing.assert_array_equal(got, ref)

    tile_pair, tile_block, tile_row0 = tiles
    assert tile_pair.shape == tile_block.shape == tile_row0.shape == (ndev, t_cap)
    assert (tile_row0 % block_n == 0).all()
    for d in range(ndev):
        real = tile_pair[d] != p_cap
        assert int(real.sum()) == int(totals[d])
        assert (tile_pair[d][~real] == p_cap).all()
        assert (tile_block[d][~real] == 0).all()
        assert (tile_row0[d][~real] == 0).all()
        for p in range(p_cap):
            mine = real & (tile_pair[d] == p)
            n_t = -(-int(nv[d, p]) // block_n)
            assert int(mine.sum()) == n_t
            if n_t == 0:
                continue
            np.testing.assert_array_equal(np.sort(tile_row0[d][mine]),
                                          np.arange(n_t) * block_n)
            base = slot_start[d, pair_slot[d, p]] // block_n
            np.testing.assert_array_equal(np.sort(tile_block[d][mine]),
                                          base + np.arange(n_t))
        seq = tile_pair[d][real]
        if seq.size:  # pair-major contiguity
            assert int((np.diff(seq) != 0).sum()) + 1 == len(np.unique(seq))


@given(
    seed=st.integers(0, 10_000),
    q=st.integers(1, 24),
    nprobe=st.integers(1, 8),
    ndev=st.integers(1, 8),
    carry_scale=st.sampled_from([0.0, 1.0, 1e3, 1e7]),
)
@settings(**SETTINGS)
def test_load_biased_schedule_covers_every_pair_once(seed, q, nprobe, ndev, carry_scale):
    rng = np.random.default_rng(seed)
    c = max(nprobe, 16)
    sizes, pl, rpl = _placements(rng, c, ndev)
    probed = np.stack([rng.choice(c, nprobe, replace=False) for _ in range(q)])
    carry = rng.random(ndev) * carry_scale
    sch = schedule_queries(probed, sizes, pl, load_carry=carry)
    _schedules_equal(sch, rsched.schedule_queries(probed, sizes, rpl, load_carry=carry))

    got = sorted(zip(sch.pair_q.tolist(), sch.pair_c.tolist()))
    assert got == sorted((qi, int(ci)) for qi in range(q) for ci in probed[qi])
    for ci, d in zip(sch.pair_c, sch.pair_dev):
        assert int(d) in pl.replicas[int(ci)]
    blind = schedule_queries(probed, sizes, pl)
    np.testing.assert_allclose(sch.dev_load.sum(), blind.dev_load.sum(), rtol=1e-12)


@given(
    seed=st.integers(0, 10_000),
    q=st.integers(1, 24),
    nprobe=st.integers(1, 8),
    ndev=st.integers(2, 8),
    n_dead=st.integers(0, 6),
    carry_scale=st.sampled_from([0.0, 1.0, 1e5]),
)
@settings(**SETTINGS)
def test_failover_schedule_covers_surviving_replicas_exactly_once(
    seed, q, nprobe, ndev, n_dead, carry_scale
):
    rng = np.random.default_rng(seed)
    c = max(nprobe, 16)
    sizes, pl, rpl = _placements(rng, c, ndev)
    probed = np.stack([rng.choice(c, nprobe, replace=False) for _ in range(q)])
    carry = rng.random(ndev) * carry_scale
    live = np.ones(ndev, bool)
    live[rng.choice(ndev, size=min(n_dead, ndev - 1), replace=False)] = False

    sch = schedule_queries(probed, sizes, pl, load_carry=carry, live=live)
    _schedules_equal(
        sch, rsched.schedule_queries(probed, sizes, rpl, load_carry=carry, live=live))

    kept = sorted(zip(sch.pair_q.tolist(), sch.pair_c.tolist()))
    lost = sorted(zip(sch.lost_q.tolist(), sch.lost_c.tolist()))
    every = sorted((qi, int(ci)) for qi in range(q) for ci in probed[qi])
    assert sorted(kept + lost) == every
    unreachable = {ci for ci in range(c) if not any(live[d] for d in pl.replicas[ci])}
    assert all(ci in unreachable for _, ci in lost)
    assert all(ci not in unreachable for _, ci in kept)
    for ci, d in zip(sch.pair_c, sch.pair_dev):
        assert live[int(d)] and int(d) in pl.replicas[int(ci)]

    oracle = schedule_queries_loop(probed, sizes, pl, live=live)
    assert sorted((int(a), int(b)) for a, b in oracle.lost) == lost
    roracle = rsched.schedule_queries_loop(probed, sizes, rpl, live=live)
    assert oracle.assigned == roracle.assigned and oracle.lost == roracle.lost

    blind = schedule_queries(probed, sizes, pl, load_carry=carry)
    alive = schedule_queries(probed, sizes, pl, load_carry=carry, live=np.ones(ndev, bool))
    for name in ("pair_q", "pair_c", "pair_dev"):
        np.testing.assert_array_equal(getattr(blind, name), getattr(alive, name))
    assert alive.lost_q.size == 0 and alive.lost_c.size == 0


@given(
    groups=st.lists(st.tuples(st.integers(0, 5000), st.integers(0, 9)), min_size=1,
                    max_size=24),
    g=st.sampled_from([1, 4]),
    sms=st.integers(1, 140),
    resident=st.integers(1, 8),
    block_n=st.sampled_from([1, 64, 1024]),
)
@settings(**SETTINGS)
def test_topk_launch_plan_covers_every_tile_once(groups, g, sms, resident, block_n):
    """B6 / B7's launch plan (`adc_topk.topk_units` + `run_plan`, the twin
    of the kernel's mapping): for any grid and G, every table row of a group
    with rows lies in one unit, every tile of every unit in exactly one
    run, a unit's runs ascend in rows and in blocks first .. last as the
    kernel computes them, every block takes T / nb tiles (rounded) and the
    scratch slots block + unit never repeat."""
    from repro_torch.kernels.adc_topk import run_plan, topk_units

    rows = [r for r, _ in groups]
    r_off = np.concatenate([[0], np.cumsum(rows)]).tolist()
    t_off = np.concatenate([[0], np.cumsum([q for _, q in groups])]).tolist()
    units = topk_units(r_off, t_off, g).numpy()
    covered = np.concatenate([np.arange(q0, q0 + nq) for _, _, q0, nq in units] or [[]])
    want = np.concatenate([np.arange(t_off[i], t_off[i + 1]) for i in range(len(groups))
                           if rows[i]] or [[]])
    np.testing.assert_array_equal(np.sort(covered), want)
    assert ((units[:, 3] >= 1) & (units[:, 3] <= g)).all() if len(units) else True

    tiles = [-(-int(n) // block_n) for n in units[:, 1]]
    plan = run_plan(tiles, sms * resident)
    t_all = sum(tiles)
    nb = min(sms * resident, t_all)
    assert plan["T"] == t_all and plan["nb"] == nb
    for u, n_t in enumerate(tiles):
        sel = plan["unit"] == u
        t0, t1, blk = plan["t0"][sel], plan["t1"][sel], plan["block"][sel]
        if n_t == 0:
            assert not sel.any()
            continue
        assert t0[0] == 0 and t1[-1] == n_t and (t1 > t0).all()
        np.testing.assert_array_equal(t1[:-1], t0[1:])
        np.testing.assert_array_equal(blk, np.arange(plan["first"][sel][0],
                                                     plan["last"][sel][0] + 1))
    if nb:
        per_block = np.bincount(plan["block"], weights=plan["t1"] - plan["t0"], minlength=nb)
        assert per_block.min() >= t_all // nb and per_block.max() <= -(-t_all // nb)
    assert len(np.unique(plan["slot"])) == len(plan["slot"])
    assert (plan["slot"] < nb + len(units)).all()


def _select_pass_loop(ustart, n_blocks):
    """The select kernels' block loop (csrc/adc_topk_select.cu
    `select_pass`) in plain Python: each block finds the unit of its first
    tile by binary search over the units' first tiles and walks the units
    its tiles cover.  Returns its runs (block, unit, t0, t1, first, last)."""
    n_units, t_all = len(ustart) - 1, int(ustart[-1])
    nb = min(n_blocks, t_all)
    runs = []
    for b in range(nb):
        tb, te = b * t_all // nb, (b + 1) * t_all // nb
        lo, hi = 0, n_units
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if ustart[mid] <= tb:
                lo = mid
            else:
                hi = mid
        for u in range(lo, n_units):
            start, count = int(ustart[u]), int(ustart[u + 1] - ustart[u])
            if start >= te:
                break
            if count == 0:
                continue
            runs.append((b, u, max(tb, start) - start, min(te, start + count) - start,
                         ((start + 1) * nb - 1) // t_all, ((start + count) * nb - 1) // t_all))
    return runs


@given(
    n_pairs=st.integers(1, 60),
    sms=st.integers(1, 140),
    resident=st.integers(1, 8),
    block_n=st.sampled_from([64, 256, 1024]),
    windows=st.booleans(),
    seed=st.integers(0, 2**16),
)
@settings(**SETTINGS)
def test_scan_select_run_mapping_matches_a_loop(n_pairs, sms, resident, block_n, windows, seed):
    """B2 / B5's units under a select plan (`adc_topk.scan_unit_tiles`, the
    twin of csrc `unit_tiles`: pair order[u]'s run of the tile queue, or its
    window's valid blocks, none without a table) cut by `run_plan` equal the
    kernel's block loop run for run; every tile of every unit lies in one
    run, and the units cut over several blocks have distinct first blocks
    (the histogram slot each counts in, below nb)."""
    import torch

    from repro_torch.kernels.adc_topk import pair_runs, run_plan, scan_unit_tiles

    rng = np.random.default_rng(seed)
    n_valid = rng.integers(0, 40 * block_n, n_pairs).astype(np.int32)
    n_valid[rng.random(n_pairs) < 0.2] = 0
    lut_row = np.where(rng.random(n_pairs) < 0.15, -1, np.arange(n_pairs)).astype(np.int32)
    if windows:
        filled = np.flatnonzero((lut_row >= 0) & (n_valid > 0))
        order = filled[rng.permutation(filled.size)]
        tiles = scan_unit_tiles(order, lut_row, n_valid, block_n)
        want = [-(-int(n_valid[p]) // block_n) for p in order]
    else:
        # the tile queue of `emit_tiles` on one device: each pair's tiles
        # contiguous, the pairs in a random order, dummy tiles (id P) between
        nt = -(-n_valid // block_n)
        seq = np.concatenate([np.full(int(nt[p]), p) for p in rng.permutation(n_pairs)]
                             + [np.full(3, n_pairs)]).astype(np.int32)
        t0, t1, order = pair_runs(torch.as_tensor(seq)[None], n_pairs)
        tiles = scan_unit_tiles(order, lut_row, n_valid, block_n, t0, t1)
        order = order.numpy()
        want = [int(nt[p]) if lut_row[p] >= 0 else 0 for p in order]
    np.testing.assert_array_equal(tiles, want)
    ustart = np.concatenate([[0], np.cumsum(tiles)])
    plan = run_plan(tiles, sms * resident)
    got = list(zip(*(plan[f].tolist() for f in ("block", "unit", "t0", "t1", "first", "last"))))
    assert got == _select_pass_loop(ustart, sms * resident)
    for u, n_t in enumerate(tiles):
        sel = plan["unit"] == u
        assert int((plan["t1"][sel] - plan["t0"][sel]).sum()) == n_t
    split = plan["first"] < plan["last"]
    firsts = np.unique(plan["first"][split])
    assert len(firsts) == len(np.unique(plan["unit"][split]))
    assert (firsts < max(plan["nb"], 1)).all()
