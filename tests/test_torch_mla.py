"""The port's Multi-head Latent Attention (`repro_torch.models.mla`) against
the reference's (`repro.models.mla`).

One MLA block at deepseek-v2's reduced shape (4 heads, kv_lora_rank 32,
q_lora_rank 48, nope 16, rope 8, v 16) with numpy weights (norm scales
near 1), the same numpy activations through both on the CPU: without a
cache, a prefill into a cache, and single-token decodes with `opt_decode`
on and off, on caches of whole chunks (where the reference's single-pass
decode is right), at rtol = atol = 1e-4 (f32 sums in other orders).

ROADMAP C10: the reference's `_mla_flash_decode` reads each chunk with
`dynamic_slice_in_dim`, which clamps a ragged last chunk's start, while
its mask uses the unclamped positions, so it scores earlier keys in the
last chunk's place.  On a ragged cache the port's single-pass decode
equals its chunk scan (and the reference's chunk scan); the reference's
does not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _one_thread import one_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro.models import mla as rmla  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
B = 2


def _cfgs(**over):
    return (ref_reduced(ref_get_config("deepseek-v2-236b"), **over),
            reduced_config(get_config("deepseek-v2-236b"), **over))


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, h, r, qr = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    shapes = {"w_dq": (d, qr), "w_uq": (qr, h * (dn + dr)), "w_dkv": (d, r + dr),
              "w_ukv": (r, h * (dn + dv)), "w_o": (h * dv, d)}
    p = {n: rng.normal(0, s[0] ** -0.5, s) for n, s in shapes.items()}
    p.update(q_norm=rng.normal(1, 0.1, qr), kv_norm=rng.normal(1, 0.1, r))
    p = {n: a.astype(np.float32) for n, a in p.items()}
    return {n: jnp.asarray(a) for n, a in p.items()}, {n: torch.from_numpy(a) for n, a in p.items()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pos(start, s):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (B, s)).copy()


@pytest.mark.parametrize("chunk", [64, 5])
def test_mla_attention_without_cache(chunk):
    """Causal self-attention over 24 positions in one chunk, or in chunks
    of 5 (the last one ragged: the reference pads it, the port slices it)."""
    rcfg, tcfg = _cfgs(attn_chunk=chunk)
    jp, tp = _params(tcfg)
    x = np.random.default_rng(1).normal(0, 1, (B, 24, tcfg.d_model)).astype(np.float32)
    want, (wc, wk) = rmla.mla_attention(jnp.asarray(x), jp, jnp.asarray(_pos(0, 24)), rcfg)
    got, (gc, gk) = tmla.mla_attention(torch.from_numpy(x), tp, torch.from_numpy(_pos(0, 24)),
                                       tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(gc), _np(wc), **F32_TOL)
    np.testing.assert_allclose(_np(gk), _np(wk), **F32_TOL)


def _prefill_then_decode(s_max, chunk, opt_decode, n_prompt=20, steps=3):
    """A prompt into an (S_max) cache, then `steps` single-token decodes, in
    both packages: [(port out, reference out)] per call and the caches."""
    rcfg, tcfg = _cfgs(attn_chunk=chunk, opt_decode=opt_decode)
    jp, tp = _params(tcfg, seed=chunk)
    rng = np.random.default_rng(s_max)
    x = rng.normal(0, 1, (B, n_prompt + steps, tcfg.d_model)).astype(np.float32)
    jc = (jnp.zeros((B, s_max, tcfg.kv_lora_rank)), jnp.zeros((B, s_max, tcfg.qk_rope_dim)))
    tc = (torch.zeros(B, s_max, tcfg.kv_lora_rank), torch.zeros(B, s_max, tcfg.qk_rope_dim))
    outs = []
    for start, s in [(0, n_prompt)] + [(n_prompt + i, 1) for i in range(steps)]:
        xs, pos = x[:, start : start + s], _pos(start, s)
        want, jc = rmla.mla_attention(jnp.asarray(xs), jp, jnp.asarray(pos), rcfg, jc,
                                      jnp.int32(start) if s == 1 else start)
        got, cache = tmla.mla_attention(torch.from_numpy(xs), tp, torch.from_numpy(pos), tcfg, tc,
                                        start)
        assert cache[0] is tc[0] and cache[1] is tc[1]  # updated in place
        outs.append((got, want))
    return outs, tc, jc


@pytest.mark.parametrize("opt_decode", [False, True])
@pytest.mark.parametrize("chunk", [8, 32])
def test_prefill_and_decode_match_reference(chunk, opt_decode):
    """Whole chunks: a 32-position cache in chunks of 8 or 32."""
    outs, tc, jc = _prefill_then_decode(32, chunk, opt_decode)
    for got, want in outs:
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    for g, w in zip(tc, jc):
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)


def test_opt_decode_ragged_cache_c10():
    """A 40-position cache in chunks of 16 (the last chunk ragged), a
    36-position prompt, then a decode at position 36 (in the ragged chunk):
    the port's single-pass decode equals its chunk scan and the reference's
    chunk scan; the reference's single-pass decode does not (C10)."""
    on, _, _ = _prefill_then_decode(40, 16, True, n_prompt=36, steps=1)
    off, _, _ = _prefill_then_decode(40, 16, False, n_prompt=36, steps=1)
    (got_on, faulty), (got_off, want) = on[-1], off[-1]
    np.testing.assert_allclose(_np(got_on), _np(got_off), **F32_TOL)
    np.testing.assert_allclose(_np(got_on), _np(want), **F32_TOL)
    assert np.abs(_np(faulty) - _np(want)).max() > 1e-2


def test_mla_flash_decode_ragged_last_chunk():
    """The twin of `test_torch_models.py::test_flash_decode_ragged_last_chunk`
    for MLA's decode scan (40 keys, chunk 16): the port's `_mla_flash_decode`
    equals the reference's chunk scan of the same query over the
    concatenated (latent | rope) keys, valid - 1 being its position; the
    reference's own `_mla_flash_decode` clamps the last chunk (32 -> 24)."""
    rng = np.random.default_rng(12)
    b, sk, h, r, dr = 2, 40, 4, 32, 8
    q_lat = rng.normal(0, 1, (b, h, r)).astype(np.float32)
    q_rope = rng.normal(0, 1, (b, h, dr)).astype(np.float32)
    cc = rng.normal(0, 1, (b, sk, r)).astype(np.float32)
    ck = rng.normal(0, 1, (b, sk, dr)).astype(np.float32)
    valid = np.array([38, 35], np.int32)
    t = torch.from_numpy
    got = tmla._mla_flash_decode(t(q_lat), t(q_rope), t(cc), t(ck), t(valid), 16, 0.2)
    q_cat = np.concatenate([q_lat, q_rope], -1)[:, None]
    k_cat = np.concatenate([cc, ck], -1)[:, :, None]
    want = rlayers._flash_chunk_scan(q_cat, k_cat, k_cat[..., :r], (valid - 1)[:, None], valid,
                                     16, 0.2)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    port_scan = tlayers._flash_chunk_scan(t(q_cat), t(k_cat), t(k_cat[..., :r]),
                                          t(valid - 1)[:, None], t(valid), 16, 0.2)
    np.testing.assert_allclose(_np(got), _np(port_scan), **F32_TOL)
    faulty = rmla._mla_flash_decode(q_lat, q_rope, cc, ck, valid, 16, 0.2)
    assert np.abs(np.asarray(faulty) - np.asarray(want)).max() > 1e-2


def test_mla_latent_cache_bf16():
    """A bf16 block against an f32 cache (the serving path's types): the
    port's output within two bf16 ulps of the output's scale of the
    reference's (both round the projections to bf16, an ulp either way)."""
    rcfg, tcfg = _cfgs(dtype="bfloat16")
    jp, tp = _params(tcfg, seed=3)
    jp = {n: a.astype(jnp.bfloat16) for n, a in jp.items()}
    tp = {n: a.bfloat16() for n, a in tp.items()}
    x = np.random.default_rng(4).normal(0, 1, (B, 16, tcfg.d_model)).astype(np.float32)
    jc = (jnp.zeros((B, 32, tcfg.kv_lora_rank)), jnp.zeros((B, 32, tcfg.qk_rope_dim)))
    tc = (torch.zeros(B, 32, tcfg.kv_lora_rank), torch.zeros(B, 32, tcfg.qk_rope_dim))
    want, jc = rmla.mla_attention(jnp.asarray(x).astype(jnp.bfloat16), jp,
                                  jnp.asarray(_pos(0, 16)), rcfg, jc, 0)
    got, tc = tmla.mla_attention(torch.from_numpy(x).bfloat16(), tp,
                                 torch.from_numpy(_pos(0, 16)), tcfg, tc, 0)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2**-7,
                               atol=2 * 2**-8 * np.abs(w).max())
    for g, ww in zip(tc, jc):
        np.testing.assert_allclose(g.numpy(), np.asarray(ww), rtol=2**-7, atol=2**-7)
