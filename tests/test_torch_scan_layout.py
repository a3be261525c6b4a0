"""The B2 / B5 / B6 / B7 / B8 / B10 domain and the blocks' planners, on
the CPU.

A shared-memory B2 / B5 block holds its pair's table, the top-k list and
its merge buffer (4k floats) and a pass of candidates (`adc_topk.scan_smem`);
every code format at the compiled widths and at a runtime width fits 227 KB
up to k = 4096.  Past that range (k > `SCAN_K_MAX`, or a table too wide to
sit beside the lists) the planners (`adc_topk.scan_plan`, `topk_plan`,
`adc_scan.table_in_place`, `lut_build.ext_table_in_place`,
`flash_attn.kernel_variant`) pick the in-place block or the general kernel,
and every such input gives the reference's answer: each case that the port
once refused (ROADMAP C5) is held here to the reference's Pallas kernel
(interpret mode) on the same numpy inputs, at the parity tests' tolerance
(distances rtol = atol = 1e-5, ids equal outside exact ties; B10 rtol 1e-4,
atol 1e-5 in f32).  The raw-code scans at each compiled width equal the
reference's Pallas kernels too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from _one_thread import one_thread  # noqa: E402,F401
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import adc_scan as k_scan  # noqa: E402
from repro_torch.kernels import adc_topk as k_topk  # noqa: E402
from repro_torch.kernels import flash_attn as k_flash  # noqa: E402
from repro_torch.kernels import lut_build as k_lut  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_flash_attn import TOL as FLASH_TOL  # noqa: E402
from test_torch_flash_attn import _both, _qkv  # noqa: E402
from test_torch_kernel_api import assert_topk  # noqa: E402
from test_torch_ref_parity import TOL, jax_tiles, tile_case  # noqa: E402
from test_torch_windows import (  # noqa: E402
    jax_direct_tiles,
    jax_windows,
    port_tiles,
    port_windows,
)

BUDGET = 232_448  # bytes of shared memory one H100 block may use
FORMATS = ("uint8", "uint16", "int32")
SHARED = dict(gtab=False, select=False)


def _variant(plan):
    """Whether the table is read in place, and whether the select kernels
    (which keep no list) run past the shared-memory block's k."""
    return dict(gtab=plan["gtab"], select=plan["select"])


@pytest.mark.parametrize("k", [1, 64, 1024, 4096])
@pytest.mark.parametrize("w", [8, 16, 32, 12])
@pytest.mark.parametrize("fmt", FORMATS)
def test_every_format_fits_the_budget(fmt, w, k):
    # raw tables are W * 256 wide; direct-address tables add 256 combo sums
    # and the sentinel (the reference's defaults)
    width = w * 256 + (0 if fmt == "uint8" else 257)
    smem = k_topk.scan_smem(k, width)
    assert smem == (width + 4 * k + 2 * 1024) * 4
    assert smem + 64 <= BUDGET
    assert k_topk.scan_plan(k, width) == dict(SHARED, smem=smem)


GTAB = dict(gtab=True, select=False)
SELECT = dict(gtab=False, select=True)
BOTH = dict(gtab=True, select=True)
ALIGNED, ODD = 0, 1  # B10's views: 16-byte aligned, or one element past


@pytest.mark.parametrize("kernel,k,width,want", [
    # B2 / B5: the old boundary, the widest tables the shared-memory block
    # holds, on the shared side; one entry more reads the table in place
    ("scan", 4096, 39_664, SHARED), ("scan", 64, 55_792, SHARED), ("scan", 1, 4096, SHARED),
    ("scan", 4096, 39_665, GTAB), ("scan", 64, 55_793, GTAB), ("scan", 64, 65_536, GTAB),
    # past SCAN_K_MAX the select kernels, as B6 / B7's below: a table that
    # fits beside their histogram stays staged
    ("scan", 4097, 4096, SELECT), ("scan", 8192, 4353, SELECT), ("scan", 65_536, 55_040, SELECT),
    ("scan", 8192, 55_041, BOTH), ("scan", 8192, 65_536, BOTH),
    # B6 / B7 at one table a block (its 4 KB of static shared memory moves
    # each boundary 1,008 entries lower)
    ("topk", 4096, 38_656, SHARED), ("topk", 64, 54_784, SHARED),
    ("topk", 4096, 38_657, GTAB), ("topk", 64, 54_785, GTAB), ("topk", 10, 65_536, GTAB),
    ("topk", 4097, 4096, SELECT), ("topk", 8192, 55_040, SELECT),
    ("topk", 8192, 55_041, BOTH), ("topk", 8192, 65_536, BOTH),
    # B10: the fast kernel's head dims; any other staged by cp.async when
    # every row is 16-byte aligned, else copied element by element
    ("flash", 48, ALIGNED, "staged"), ("flash", 80, ALIGNED, "staged"),
    ("flash", 256, ALIGNED, "staged"), ("flash", 48, ODD, "general"),
    ("flash", 80, ODD, "general"), ("flash", 256, ODD, "general"),
    ("flash", 128, ALIGNED, "fast"), ("flash", 128, ODD, "general"),
    ("flash", 20, ALIGNED, "general"), ("flash", 1040, ALIGNED, "general"),
])
def test_planners_choice(kernel, k, width, want):
    """Which (k, table width) takes the shared-memory block, which the
    in-place block (its table read where it lies) and which the select
    kernels (past SCAN_K_MAX,
    their table staged or read in place): B2 / B5 (`scan_plan`), B6 / B7
    (`topk_plan` on uint16 addresses, one table a block); whether B8 and
    B4 / B9 read their table in place;
    and which B10 kernel a (head dim, alignment) takes (`kernel_variant`,
    k the head dim, width the view's element offset; bf16 q, f32 k / v)."""
    if kernel == "flash":
        _flash_choice(k, width, want)
        return
    if kernel == "scan":
        plan = k_topk.scan_plan(k, width)
        static = 4096 if plan["select"] else 64  # the select kernels' static reserve
        assert plan["select"] == (k > k_topk.SCAN_K_MAX) and "spill" not in plan
    else:
        plan, static = k_topk.topk_plan([1], [10**6], k, 1, 16, width, groups=(1,)), 4096
        assert plan["g"] == 1 and "spill" not in plan
        assert plan["select"] == (k > k_topk.SCAN_K_MAX)
    assert _variant(plan) == want
    assert plan["smem"] + static <= BUDGET
    assert k_scan.table_in_place(width, 1, 16) == (width > 58_112)
    assert not k_scan.table_in_place(width, 0, 16)  # raw M = 16 codes address 4096
    assert k_lut.ext_table_in_place(width) == (width > 58_112)


def _flash_choice(hd, offset, want):
    def view(dtype, shape):
        buf = torch.zeros(int(np.prod(shape)) + 8, dtype=dtype)
        return buf[offset:offset + int(np.prod(shape))].view(shape)

    q = view(torch.bfloat16, (1, 4, 2, hd))
    k, v = view(torch.float32, (1, 4, 1, hd)), view(torch.float32, (1, 4, 1, hd))
    assert all(t.data_ptr() % 16 == 0 for t in (q, k, v)) == (offset == ALIGNED)
    assert k_flash.kernel_variant(hd, q, k, v) == want
    if want != "fast":
        shape = k_flash.general_shape(hd, want)
        assert shape["wpr"] * shape["cw"] >= min(hd, 1024) and shape["cw"] <= 128
        assert shape["rows"] * shape["wpr"] == 128 and shape["cw"] % 16 == 0


@pytest.mark.parametrize("k", [4097, 8192, 65_536])
@pytest.mark.parametrize("rows", [2_000_000, 100_000_000])
def test_select_scratch_sizing(k, rows):
    """B2 / B5 / B6 / B7 past SCAN_K_MAX (the select kernels): the scratch
    is each unit's state, first tile, a tie count a run and its share of
    the bucket pool, and a 2,048-bin histogram a block (B2 / B5 also the
    queries' starting bounds), whatever k and the rows (rows are scored
    again in every pass); the candidates are the output's own k entries a
    unit, and at B2 / B5's largest batch (1,000 queries x 64 probes) the
    scratch stays below the (P, k) outputs; the sort block's keys fit
    shared memory at any k.  The sizes mirror csrc/adc_topk_select.cu."""
    import re

    src = (k_topk._build.CSRC / "adc_topk_select.cu").read_text()
    consts = dict(re.findall(
        r"constexpr int (SEL_BINS|SEL_STATE|SEL_BUCKET|SEL_POOL_PER_UNIT|SORT_CHUNK) = (\d+);",
        src))
    assert int(consts["SEL_BINS"]) == k_topk._SELECT_BINS == 2 * k_topk._SCAN_PASS
    assert int(consts["SEL_STATE"]) == k_topk._SELECT_STATE
    assert int(consts["SEL_BUCKET"]) == k_topk._SELECT_BUCKET
    assert int(consts["SEL_POOL_PER_UNIT"]) == k_topk._SELECT_POOL_PER_UNIT
    assert int(consts["SORT_CHUNK"]) == k_topk._SORT_CHUNK
    plan = k_topk.topk_plan([1], [rows], k, 0, 16, 4096)
    assert plan["select"] and not plan["gtab"]
    assert plan["smem"] == (4096 + k_topk._SELECT_BINS) * 4
    assert k_topk.scan_plan(k, 4096) == dict(gtab=False, select=True, smem=plan["smem"])
    n_blocks = 132 * 8
    for units, n_q in ((1, 0), (30, 0), (1024, 16), (64_000, 1000)):
        entries = k_topk.select_scratch(units, n_blocks, n_q)
        head = units * 12 + n_blocks * 2048 + 2 + n_blocks + units
        head += head % 2 + 2 * (units + 1) + n_q + n_q % 2
        assert entries == head + 2 * (units * 256 + 8192)
        # 2,108 bytes a unit, 8,196 a block, 4 a query: no row or k term
        assert entries * 4 <= units * 2108 + n_blocks * 8196 + n_q * 4 + 8 * 8192 + 32
        if units == 64_000:
            assert entries * 4 < units * k * 8  # beside the (P, k) f32 + int32 outputs
    sort = k_topk.select_sort_smem(k)
    assert sort == min(max(1 << (k - 1).bit_length(), 8192), 16_384) * 8 <= BUDGET
    # the bucket pass sorts a whole bucket in one block
    assert k_topk._SELECT_BUCKET * 8 <= BUDGET


def test_scan_budget_refusals():
    """A uint16 direct-address table too wide for the shared-memory block
    (55,793 entries at k = 64, the widest plus one): served through both
    scans, equal to the reference's kernels on the same inputs."""
    assert k_topk.scan_smem(4096, 39_664) + 64 == BUDGET
    assert k_topk.scan_smem(64, 55_792) + 64 == BUDGET
    c = _wide_case(55_793, "uint16", k=64)
    jv, ji = jax_direct_tiles(c, False)
    for port in (port_tiles, port_windows):
        v, i, _ = port(c, False)
        np.testing.assert_allclose(v, jv, **TOL)
        np.testing.assert_array_equal(i, ji)
    wv, wi, _ = jax_windows(c, False)
    np.testing.assert_allclose(wv, jv, **TOL)
    np.testing.assert_array_equal(wi, ji)


def _wide_case(width, dtype, k, seed=5):
    """tile_case's layout over direct addresses into tables `width` wide
    (random entries, the sentinel's 0.0 last), each row 8 random addresses."""
    c = tile_case(seed, q=2, nprobe=3, k=k)
    p = c["luts"].shape[0]
    rng = np.random.default_rng(seed)
    tables = rng.random((p, width), dtype=np.float32)
    tables[:, -1] = 0.0
    codes = rng.integers(0, width, (c["codes"].shape[0], 8)).astype(dtype)
    return dict(c, codes=codes, tables=tables)


@pytest.mark.parametrize("k", [0, 4097])
@pytest.mark.parametrize("scan", ["tiles", "windows"])
def test_scan_k_limit_refused(scan, k):
    """k = 4097, past the shared-memory block's SCAN_K_MAX, is served and
    equals the reference's kernel; k = 0 raises, as the reference's does."""
    c = tile_case(0)
    c["k"] = k
    port = port_tiles if scan == "tiles" else port_windows
    if k == 0:
        with pytest.raises(ValueError, match="k=0"):
            port(c, False)
        with pytest.raises(Exception):
            jax_tiles(c, False) if scan == "tiles" else jax_windows(c, False)
        return
    v, i, _ = port(c, False)
    jv, ji = jax_tiles(c, False) if scan == "tiles" else jax_windows(c, False)[:2]
    if scan == "windows":
        empty = c["sizes"] <= 0
        jv[empty], ji[empty] = np.inf, -1
    np.testing.assert_allclose(v, jv, **TOL)
    np.testing.assert_array_equal(i, ji)


@pytest.mark.parametrize("call", ["adc_topk", "adc_topk_flat", "adc_topk_pairs"])
def test_topk_k_limit_refused(call):
    """k = 4097 (ADC_TOPK_K_MAX + 1) through B6 / B7: the reference's answer."""
    rng = np.random.default_rng(3)
    lut = rng.normal(0, 1, (1, 8 * 256)).astype(np.float32)
    codes = rng.integers(0, 256, (4608, 8)).astype(np.uint8)
    addrs = (codes.astype(np.int32) + np.arange(8, dtype=np.int32) * 256)
    k = ops.ADC_TOPK_K_MAX + 1
    assert ops.ADC_TOPK_K_MAX == 4096 == ops.SCAN_K_MAX
    if call == "adc_topk":
        got = ops.adc_topk(torch.from_numpy(lut), torch.from_numpy(codes), k)
        want = jops.adc_topk(jnp.asarray(lut.reshape(1, 8, 256)), jnp.asarray(codes), k)
    elif call == "adc_topk_flat":
        got = ops.adc_topk_flat(torch.from_numpy(lut), torch.from_numpy(addrs), k)
        want = jops.adc_topk_flat(jnp.asarray(lut), jnp.asarray(addrs), k)
    else:
        nv = np.array([4500], np.int32)
        got = ops.adc_topk_pairs(torch.from_numpy(lut), torch.from_numpy(addrs[None]),
                                 torch.from_numpy(nv), k, block_n=512)
        want = jops.adc_topk_pairs(jnp.asarray(lut), jnp.asarray(addrs[None]), jnp.asarray(nv),
                                   k, block_n=512)
    assert got[0].shape == (1, k)
    assert_topk(got, want)


def test_topk_group_size():
    """Four raw M = 16 tables fit beside their lists up to k = 1024; at k =
    4096 the block drops to one.  Two tables cost less one by one."""
    g = k_topk.topk_group_size
    for k in (1, 10, 1024):
        assert g([16], [10**8], k, 0, 16, 4096) == 4
        assert k_topk.topk_smem(4, k, 4096) + 4096 <= BUDGET
    assert g([16], [10**8], 4096, 0, 16, 4096) == 1
    assert g([1], [10**8], 10, 0, 16, 4096) == 1
    assert g([2], [10**8], 10, 0, 16, 4096) == 1
    assert g([8], [10**8], 10, 0, 16, 4096) == 4
    # grouped: many small groups of one or two tables pick G = 1
    assert g([1, 2] * 50, [5000] * 100, 10, 0, 16, 4096) == 1


@pytest.mark.parametrize("call", ["adc_topk_flat", "adc_topk_grouped", "adc_topk_pairs"])
def test_topk_table_too_wide_refused(call):
    """uint16 direct addresses into a 65,536-entry table (256 KB, more than
    one block's shared memory): the in-place block reads it where it lies
    on the card, the reference's answer here."""
    a = 65_536
    rng = np.random.default_rng(11)
    tables = rng.random((2, a), dtype=np.float32)
    addrs = rng.integers(0, a, (128, 4)).astype(np.uint16)
    tt, ta = torch.from_numpy(tables), torch.from_numpy(addrs)
    if call == "adc_topk_flat":
        got = ops.adc_topk_flat(tt, ta, 10)
        want = jops.adc_topk_flat(jnp.asarray(tables), jnp.asarray(addrs), 10)
    elif call == "adc_topk_grouped":
        got = ops.adc_topk_grouped(tt, ta, 10, [0, 64, 128], [0, 1, 2])
        want = [np.concatenate(x) for x in zip(*(
            jops.adc_topk_flat(jnp.asarray(tables[g:g + 1]), jnp.asarray(addrs[64 * g:64 * g + 64]),
                               10) for g in range(2)))]
    else:
        nv = np.array([64, 3], np.int32)
        got = ops.adc_topk_pairs(tt, ta.reshape(2, 64, 4), torch.from_numpy(nv), 10, block_n=64)
        want = jops.adc_topk_pairs(jnp.asarray(tables), jnp.asarray(addrs.reshape(2, 64, 4)),
                                   jnp.asarray(nv), 10, block_n=64)
    assert_topk(got, want)
    # the widest direct table one block holds at k = 10 stays in shared memory
    widest = (BUDGET - 4096) // 4 - 2 * 10 - 2 * 10 - 2 * 1024
    assert not k_topk.wide(k_topk.topk_plan([1], [128], 10, 1, 4, widest))
    assert _variant(k_topk.topk_plan([1], [128], 10, 1, 4, widest + 1)) == GTAB


@pytest.mark.parametrize("hd", [8, 48, 256])
def test_flash_head_dim_refused_on_cpu(hd):
    """Head dims without a fast kernel (8, 48, 256 > 128): the general
    kernel (staged: aligned rows) on the card, the Pallas kernel's answer
    here."""
    q, k, v = _qkv(hd, 1, 64, 128, 4, 2, hd)
    got, want = _both(q, k, v, scale=hd**-0.5, q_offset=64, bq=64, bk=64)
    np.testing.assert_allclose(got, want, **FLASH_TOL)
    assert k_flash.kernel_variant(hd, *map(torch.from_numpy, (q, k, v))) == "staged"
    for fast in k_flash.HEAD_DIMS:
        assert k_flash.kernel_variant(fast, torch.zeros(4)) == "fast"


def test_flash_unaligned_views_served():
    """q, k, v that start off a 16-byte boundary (views at an odd element
    offset) take the general kernel on the card; here their answer is the
    reference's on the same values."""
    b, sq, sk, h, kvh, hd = 1, 64, 64, 2, 1, 32
    q, k, v = _qkv(3, b, sq, sk, h, kvh, hd)
    views = []
    for x in (q, k, v):
        buf = torch.zeros(x.size + 1)
        buf[1:] = torch.from_numpy(x).reshape(-1)
        views.append(buf[1:].view(x.shape))
    assert all(t.data_ptr() % 16 for t in views)
    assert k_flash.kernel_variant(hd, *views) == "general"
    got = ops.flash_attention_fwd(*views, scale=hd**-0.5, bq=64, bk=64)
    _, want = _both(q, k, v, scale=hd**-0.5, bq=64, bk=64)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)


@pytest.mark.parametrize("m", [8, 16, 32])
def test_raw_scans_match_reference_at_compiled_widths(m):
    c = tile_case(m, m=m, dsub=2)
    jv, ji = jax_tiles(c, bounds=False)
    for port in (port_tiles, port_windows):
        v, i, _ = port(c, False)
        np.testing.assert_allclose(v, jv, **TOL)
        np.testing.assert_array_equal(i, ji)
    wv, wi, _ = jax_windows(c, False)
    np.testing.assert_allclose(wv, jv, **TOL)
