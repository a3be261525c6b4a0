"""The port's refused domain (ROADMAP C5) and the B2 / B5 block budget,
on the CPU.

A B2 / B5 block holds its pair's table, the top-k list and its merge buffer
(4k floats) and a pass of candidates in shared memory
(`adc_topk.scan_smem`); every code format at the compiled widths and at a
runtime width fits 227 KB up to k = 4096, and a table too wide is refused.
B6 / B7 blocks hold G tables beside G lists (`adc_topk.topk_group_size`):
k up to 4096 is taken, with G = 1 where four tables no longer fit.  The
refusals (k beyond 4096 for B2 / B5 / B6 / B7, a table too wide for the
shared memory, B10 head dims outside the kernel's instantiations) raise on
the CPU as they do on the card.  The raw-code scans at each compiled width equal the reference's
Pallas kernels (interpret mode) on the same numpy inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro_torch.kernels import adc_topk as k_topk  # noqa: E402
from repro_torch.kernels import flash_attn as k_flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_ref_parity import TOL, jax_tiles, tile_case  # noqa: E402
from test_torch_windows import jax_windows, port_tiles, port_windows  # noqa: E402

BUDGET = 232_448  # bytes of shared memory one H100 block may use
FORMATS = ("uint8", "uint16", "int32")


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


def test_scan_budget_refusals():
    # the widest table that fits at k = 4096 and at k = 64, and one more
    assert k_topk.scan_smem(4096, 39_664) + 64 == BUDGET
    assert k_topk.scan_smem(64, 55_792) + 64 == BUDGET
    for k, width in ((4096, 39_665), (64, 55_793)):
        with pytest.raises(ValueError, match="shared memory"):
            k_topk.scan_smem(k, width)
    # through the wrapper: a uint16 direct-address table too wide to hold
    luts = torch.zeros(1, 55_793)
    codes = torch.zeros(1, 64, 8, dtype=torch.int32)
    one = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        ops.adc_topk_windows(luts, codes, one, one, 64, block_n=64, lut_row=one)


@pytest.mark.parametrize("k", [0, 4097])
@pytest.mark.parametrize("scan", ["tiles", "windows"])
def test_scan_k_limit_refused(scan, k):
    c = tile_case(0)
    c["k"] = k
    with pytest.raises(ValueError, match="SCAN_K_MAX"):
        (port_tiles if scan == "tiles" else port_windows)(c, False)


@pytest.mark.parametrize("call", ["adc_topk", "adc_topk_flat", "adc_topk_pairs"])
def test_topk_k_limit_refused(call):
    rng = np.random.default_rng(3)
    lut = torch.as_tensor(rng.normal(0, 1, (1, 8 * 256)).astype(np.float32))
    codes = torch.as_tensor(rng.integers(0, 256, (64, 8)).astype(np.uint8))
    addrs = (codes.int() + torch.arange(8, dtype=torch.int32) * 256).contiguous()

    def run(k):
        if call == "adc_topk":
            return ops.adc_topk(lut, codes, k)
        if call == "adc_topk_flat":
            return ops.adc_topk_flat(lut, addrs, k)
        return ops.adc_topk_pairs(lut, addrs[None], torch.tensor([64]), k, block_n=64)

    assert ops.ADC_TOPK_K_MAX == 4096 == ops.SCAN_K_MAX
    with pytest.raises(ValueError, match="ADC_TOPK_K_MAX"):
        run(ops.ADC_TOPK_K_MAX + 1)
    # the limit itself is taken: 64 rows, then (+inf, -1)
    v, i = run(ops.ADC_TOPK_K_MAX)
    assert v.shape == (1, ops.ADC_TOPK_K_MAX)
    assert bool((i[0, :64] >= 0).all()) and bool((i[0, 64:] == -1).all())


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
    """uint16 direct addresses into a 65,536-entry table (256 KB) cannot sit
    in one block's shared memory: refused on the CPU with the message the
    card's path raises (the same planning function), before any launch."""
    a = 65_536
    tables = torch.zeros(2, a)
    addrs = torch.zeros(128, 4, dtype=torch.int32).to(torch.uint16)
    with pytest.raises(ValueError, match=f"a table of {a} floats and k=10 need .* B of shared "
                                         f"memory, over {BUDGET}"):
        if call == "adc_topk_flat":
            ops.adc_topk_flat(tables, addrs, 10)
        elif call == "adc_topk_grouped":
            ops.adc_topk_grouped(tables, addrs, 10, [0, 64, 128], [0, 1, 2])
        else:
            ops.adc_topk_pairs(tables, addrs.reshape(2, 64, 4), torch.tensor([64, 3]), 10,
                               block_n=64)
    # the widest direct table one block holds at k = 10 is taken
    widest = (BUDGET - 4096) // 4 - 2 * 10 - 2 * 10 - 2 * 1024
    assert k_topk.topk_group_size([1], [128], 10, 1, 4, widest) == 1
    with pytest.raises(ValueError, match="shared memory"):
        k_topk.topk_group_size([1], [128], 10, 1, 4, widest + 1)


@pytest.mark.parametrize("hd", [8, 48, 256])
def test_flash_head_dim_refused_on_cpu(hd):
    q = torch.zeros(1, 64, 2, hd)
    kv = torch.zeros(1, 64, 1, hd)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_fwd(q, kv, kv, scale=hd**-0.5)
    with pytest.raises(ValueError, match="head dim"):
        k_flash.check_head_dim(hd)
    for ok in k_flash.HEAD_DIMS:
        k_flash.check_head_dim(ok)


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
