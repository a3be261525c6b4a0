"""The port's refused domain (ROADMAP C5) and the B2 / B5 block budget,
on the CPU.

A B2 / B5 block holds its pair's table, the top-k list and its merge buffer
(4k floats) and a pass of candidates in shared memory
(`adc_topk.scan_smem`); every code format at the compiled widths and at a
runtime width fits 227 KB up to k = 4096, and a table too wide is refused.
The refusals (k beyond 4096 for B2 / B5, beyond 1024 for B6 / B7, B10 head
dims outside the kernel's instantiations) raise on the CPU as they do on the
card.  The raw-code scans at each compiled width equal the reference's
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
    k = ops.ADC_TOPK_K_MAX + 1
    with pytest.raises(ValueError, match="ADC_TOPK_K_MAX"):
        if call == "adc_topk":
            ops.adc_topk(lut, codes, k)
        elif call == "adc_topk_flat":
            ops.adc_topk_flat(lut, addrs, k)
        else:
            ops.adc_topk_pairs(lut, addrs[None], torch.tensor([64]), k, block_n=64)
    # the limit itself is taken
    v, _ = ops.adc_topk(lut, codes, ops.ADC_TOPK_K_MAX)
    assert v.shape == (1, ops.ADC_TOPK_K_MAX)


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
