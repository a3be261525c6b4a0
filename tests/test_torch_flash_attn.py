"""The port's kernel B10 (flash-attention forward) against the reference.

`repro_torch.kernels.ops.flash_attention_fwd` on CPU tensors runs the
kernel's plain version; the reference's `flash_attention_fwd` runs its
Pallas kernel in interpret mode, as `tests/test_flash_attn.py` runs it.
Same numpy inputs, same shapes (that file's four cases and its block
sweep) and its tolerance: rtol 1e-4, atol 1e-5 in f32.  With a bf16 q
against an f32 cache (the serving path's types) both outputs are bf16
roundings of f32 results that differ by f32 reassociation, so they agree
to one bf16 ulp: rtol 2^-7, atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.flash_attn import flash_attention_fwd as ref_flash  # noqa: E402
from repro_torch.kernels import flash_attn as k_flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-5)


def _qkv(seed, b, sq, sk, h, kvh, hd):
    rng = np.random.default_rng([23, seed])
    return (rng.normal(0, 1, (b, sq, h, hd)).astype(np.float32),
            rng.normal(0, 1, (b, sk, kvh, hd)).astype(np.float32),
            rng.normal(0, 1, (b, sk, kvh, hd)).astype(np.float32))


def _both(q, k, v, q_dtype=np.float32, **kw):
    """(port via ops on the CPU, reference in interpret mode) as f32 numpy."""
    jq = jnp.asarray(q).astype(jnp.bfloat16 if q_dtype == "bf16" else jnp.float32)
    want = ref_flash(jq, jnp.asarray(k), jnp.asarray(v), interpret=True, **kw)
    tq = torch.from_numpy(q)
    tq = tq.bfloat16() if q_dtype == "bf16" else tq
    got = ops.flash_attention_fwd(tq, torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize(
    "b,sq,sk,h,kvh,hd,off",
    [
        (2, 128, 128, 4, 2, 16, 0),    # GQA prefill
        (1, 64, 256, 8, 8, 32, 0),     # MHA, cache longer than q
        (2, 128, 256, 4, 2, 16, 64),   # chunked prefill with offset
        (1, 64, 64, 4, 1, 16, 0),      # MQA
        (1, 64, 128, 4, 4, 112, 32),   # zamba2's head dim
    ],
)
def test_flash_plain_matches_reference(b, sq, sk, h, kvh, hd, off):
    q, k, v = _qkv(sq + off, b, sq, sk, h, kvh, hd)
    ops.reset_launches()
    got, want = _both(q, k, v, scale=hd**-0.5, q_offset=off, kv_valid=off + sq, bq=64, bk=64)
    np.testing.assert_allclose(got, want, **TOL)
    assert ops.launches["flash_attention_fwd"] == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("bq,bk", [(32, 64), (64, 32), (128, 128), (256, 64)])
def test_flash_block_shape_sweep(bq, bk):
    q, k, v = _qkv(1, 1, 256, 256, 2, 2, 16)
    got, want = _both(q, k, v, scale=16**-0.5, bq=bq, bk=bk)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("off", [0, 96])
def test_flash_bf16_q_f32_cache(off):
    """The serving path's types: bf16 q, f32 k / v, a cache longer than the
    valid keys (zeros past kv_valid, as `init_decode_cache` leaves them)."""
    b, sq, sk, h, kvh, hd = 2, 128, 384, 8, 2, 32
    q, k, v = _qkv(7 + off, b, sq, sk, h, kvh, hd)
    k[:, off + sq:] = 0.0
    v[:, off + sq:] = 0.0
    got, want = _both(q, k, v, q_dtype="bf16", scale=hd**-0.5, q_offset=off,
                      kv_valid=off + sq, bq=128, bk=128)
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_flash_rows_without_live_keys_are_zero():
    """kv_valid = 0: no key is live, every row outputs 0 (the reference's
    0 / max(l, 1e-30)), with no NaN."""
    q, k, v = _qkv(3, 1, 64, 64, 4, 2, 16)
    got, want = _both(q, k, v, scale=0.25, kv_valid=0, bq=64, bk=64)
    assert not got.any() and not want.any()


def test_flash_wrapper_refusals():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 64, 64, 4, 2, 16))
    with pytest.raises(ValueError, match="do not divide"):
        ops.flash_attention_fwd(q, k, v, scale=0.25, bq=48)
    with pytest.raises(ValueError, match="kv_valid"):
        ops.flash_attention_fwd(q, k, v, scale=0.25, kv_valid=65)
    with pytest.raises(ValueError):
        ops.flash_attention_fwd(q, k[:, :, :1].repeat(1, 1, 3, 1), v, scale=0.25)
    with pytest.raises(TypeError):
        ops.flash_attention_fwd(q, k, v.bfloat16(), scale=0.25)


def test_plain_blocks_do_not_change_the_function():
    """The kernel tiles on its own (64 x 64); the plain version's blocks are
    the reference's.  Different blocks give the same function to f32
    reassociation, which is what lets the kernel ignore them."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 256, 320, 4, 1, 32))
    a = k_flash.flash_attention_fwd_plain(q, k, v, 32**-0.5, 64, 300, 256, 64)
    bb = k_flash.flash_attention_fwd_plain(q, k, v, 32**-0.5, 64, 300, 64, 320)
    torch.testing.assert_close(a, bb, **TOL)


# -- the kernel's split-TF32 products, emulated on the CPU -----------------
# `csrc/flash_attn.cu` multiplies on the tensor cores in TF32 (11 significant
# bits).  An f32 operand x splits as hi = rna_tf32(x) (nearest, ties away
# from zero), lo = x - hi, and the tensor core reads lo truncated to TF32; a
# bf16 operand is exact in TF32.
# Q.K^T sums q_hi.k_hi + q_hi.k_lo + q_lo.k_hi over the split operands (a
# bf16 q has no lo), P.V sums p_hi.v_hi + p_hi.v_lo + p_lo.v_hi, and the
# scale multiplies the f32 score after the product.  The emulation below
# runs those products inside the plain version's online softmax and block
# order.  In f32 it is held against the plain version at the kernel's
# tolerances.  In f64 (the same rounded operands, exact sums) it is held
# against an f64 run without rounding, which isolates what the operand
# rounding costs from the f32 sums' own error; a single unsplit TF32 pass
# is measured the same way.
F32_TOL = dict(rtol=1e-4, atol=1e-5)  # FLASH_F32_TOL (chip_smoke.py)
PEAK_LOGIT = 30.0


def _tf32(x, rna=True):
    """x rounded to TF32 in f32 storage: nearest with ties away from zero
    (rna, the kernel's `tf32_rna`, as `cvt.rna.tf32.f32`) or truncated (how
    the tensor core reads an f32 register); bit operations on the f32
    encoding."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000 if rna else bits) & -0x2000).view(torch.float32)


def _split(x):
    """The kernel's `split_tf32` as the tensor core reads it: hi =
    rna_tf32(x), lo = x - hi (exact in f32) truncated to TF32."""
    hi = _tf32(x)
    return hi, _tf32(x - hi, rna=False)


def _tc_product(eq, a, b, split_a, split_b, mode, dt):
    """einsum(eq, a, b) of f32 operands as the kernel's TF32 passes form it
    (mode "split"), as one unsplit pass ("single") or unrounded ("exact"),
    summed in dtype `dt`."""
    if mode == "exact":
        return torch.einsum(eq, a.to(dt), b.to(dt))
    if mode == "single":
        return torch.einsum(eq, _tf32(a).to(dt), _tf32(b).to(dt))
    a_hi, a_lo = _split(a) if split_a else (a, None)
    b_hi, b_lo = _split(b) if split_b else (b, None)
    out = torch.einsum(eq, a_hi.to(dt), b_lo.to(dt)) if split_b else 0.0
    if split_a:
        out = out + torch.einsum(eq, a_lo.to(dt), b_hi.to(dt))
    return out + torch.einsum(eq, a_hi.to(dt), b_hi.to(dt))


def _kernel_emulation(monkeypatch, q, k, v, scale, off, kv_valid, mode="split", f64=False):
    """The plain version with the kernel's products: `online_softmax_step`
    swapped for the same step over `_tc_product`, the scale after Q.K^T
    (the plain version then runs with scale 1, so its q is q exactly).  The
    running max, sum and accumulator stay f32 between blocks; with `f64`
    each block's products and softmax run in float64."""
    split_q, split_kv = q.dtype == torch.float32, k.dtype == torch.float32
    dt = torch.float64 if f64 else torch.float32

    def step(qg, kc, vc, mask, m, l, acc, s_eq, pv_eq):
        s = scale * _tc_product(s_eq, qg, kc.float(), split_q, split_kv, mode, dt)
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m.to(dt), s.amax(-1)).float()
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0).to(dt)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m.to(dt) - m_safe), 0.0)
        l = l.to(dt) * corr + p.sum(-1)
        pv = _tc_product(pv_eq, p.float(), vc.float(), True, split_kv, mode, dt)
        return m_new, l.float(), (acc.to(dt) * corr[..., None] + pv).float()

    with monkeypatch.context() as mp:
        mp.setattr(k_flash, "online_softmax_step", step)
        return k_flash.flash_attention_fwd_plain(q, k, v, 1.0, off, kv_valid, 32, 32)


def _tc_case(seed, groups, q_dtype, peaked):
    """(q, k, v, scale, q_offset, kv_valid): GQA `groups`, hd 64, a cache
    longer than the valid keys; peaked: q scaled so that its largest live
    logit is PEAK_LOGIT."""
    b, sq, sk, kvh, hd, off, kv_valid = 2, 96, 128, 2, 64, 16, 104
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed, b, sq, sk, kvh * groups, kvh, hd))
    scale = hd**-0.5
    if peaked:
        qg = q.reshape(b, sq, kvh, groups, hd)
        lg = torch.einsum("bqkgd,bckd->bqkgc", qg, k) * scale
        live = ((torch.arange(sk)[None, :] <= off + torch.arange(sq)[:, None])
                & (torch.arange(sk) < kv_valid)[None, :])
        top = lg.masked_fill(~live[None, :, None, None, :], -torch.inf).max()
        q = q * (PEAK_LOGIT / top)
    return q.to(q_dtype), k, v, scale, off, kv_valid


def _tol_ratio(got, want, tol):
    """max |got - want| / (atol + rtol |want|): <= 1 is inside the tolerance."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())).max())


def _rounding_ratios(monkeypatch, q, k, v, scale, off, kv_valid):
    """{mode: tolerance ratio against the unrounded f64 run} for the split
    scheme and a single pass, both summed in f64 (a bf16 q is widened: it is
    exact in TF32, so its split has no low half)."""
    qf = q.float()
    exact = _kernel_emulation(monkeypatch, qf, k, v, scale, off, kv_valid, "exact", True)
    return {mode: _tol_ratio(_kernel_emulation(monkeypatch, qf, k, v, scale, off, kv_valid,
                                               mode, True), exact, F32_TOL)
            for mode in ("split", "single")}


@pytest.mark.parametrize("peaked", [False, True], ids=["normal", "peaked"])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32], ids=["bf16_q", "f32_q"])
@pytest.mark.parametrize("groups", [1, 4])
def test_split_tf32_products_inside_tolerance(monkeypatch, groups, q_dtype, peaked):
    """The kernel's split scheme inside one bf16 ulp for a bf16 q and inside
    rtol 1e-4 / atol 1e-5 for an f32 q: of the plain version with normal
    scores; of the unrounded f64 result with the largest logit at 30, where
    the f32 plain version's own rounding takes most of the f32 tolerance
    (on the card, at the prefill's shape, more than all of it:
    `chip_smoke.py`).  Its operand rounding alone (sums in f64) uses at most
    half of the f32 tolerance."""
    q, k, v, scale, off, kv_valid = _tc_case(groups, groups, q_dtype, peaked)
    if peaked:
        want = _kernel_emulation(monkeypatch, q, k, v, scale, off, kv_valid, "exact", True)
    else:
        want = k_flash.flash_attention_fwd_plain(q, k, v, scale, off, kv_valid, 32, 32)
    got = _kernel_emulation(monkeypatch, q, k, v, scale, off, kv_valid)
    assert got.dtype == q_dtype
    tol = BF16_TOL if q_dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)
    ratios = _rounding_ratios(monkeypatch, q, k, v, scale, off, kv_valid)
    assert ratios["split"] <= 0.5, ratios


@pytest.mark.parametrize("peaked", [False, True], ids=["normal", "peaked"])
def test_single_tf32_pass_misses_f32_tolerance(monkeypatch, peaked):
    """Why the kernel splits: one unsplit TF32 pass of both products (every
    operand rounded to 11 bits) lands outside the f32 tolerance of the
    unrounded result, the split well inside it (both printed, beside the f32
    plain version's own distance from the f64 result)."""
    q, k, v, scale, off, kv_valid = _tc_case(4, 4, torch.float32, peaked)
    ratios = _rounding_ratios(monkeypatch, q, k, v, scale, off, kv_valid)
    exact = _kernel_emulation(monkeypatch, q, k, v, scale, off, kv_valid, "exact", True)
    plain = _tol_ratio(k_flash.flash_attention_fwd_plain(q, k, v, scale, off, kv_valid, 32, 32),
                       exact, F32_TOL)
    print(f"f32 q, {'peaked' if peaked else 'normal'} scores, share of the f32 tolerance "
          f"against f64: single TF32 pass {ratios['single']:.2f}, split "
          f"{ratios['split']:.4f}, the f32 plain version {plain:.3f}")
    assert ratios["single"] > 1.0 > 2 * ratios["split"]


def test_tf32_rounding_and_split():
    """`_tf32` rounds to 11 significant bits, to nearest with ties away from
    zero or toward zero; the split's hi is the nearest, its residual x - hi
    is exact in f32 and at most 2^-11 |x|, and hi + lo is x to 2^-21 |x|."""
    ulp = 2.0**-10
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2**-23,
                      1.0 + 1.5 * ulp, 3.0e38, -7.1e-3])
    got = _tf32(x)
    assert torch.equal(got[:4], torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp]))
    assert (got - x).abs().le(x.abs() * 2.0**-11).all()
    trunc = _tf32(x, rna=False)
    assert torch.equal(trunc[:4], torch.tensor([1.0, -1.0, 1.0, 1.0 + ulp]))
    hi, lo = _split(x)
    assert torch.equal(hi, got) and (x - hi).abs().le(x.abs() * 2.0**-11).all()
    assert ((hi + lo) - x).abs().le(x.abs() * 2.0**-21).all()


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
def test_tf32_passes(q_dtype, kv_dtype):
    """The passes the kernel runs (and the smoke's tensor-core bound counts):
    an f32 operand costs a split, a bf16 one is exact."""
    qk, pv = k_flash.tf32_passes(q_dtype, kv_dtype)
    assert qk == 1 + (q_dtype == torch.float32) + (kv_dtype == torch.float32)
    assert pv == 2 + (kv_dtype == torch.float32)
