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
