"""The port's dense LM (layers, prefill, decode) against the reference.

Weights are drawn with numpy in the tree of the reference's `init_params`
(checked against its `eval_shape`); `convert.lm_params_from_reference`
carries them into the port's `DecoderLM`.  Same
numpy tokens and activations go through both packages on the CPU, where
the reference's flash kernel B10 runs in Pallas interpret mode and the
port's runs its plain version.  Configs: qwen3-8b reduced with GQA
(n_kv_heads 2; `reduced_config` alone gives 4 = n_heads) and MQA (1),
yi-6b and phi3-mini-3.8b reduced (MHA at that size).

Tolerances: f32, rtol = atol = 1e-4 (f32 sums in other orders), greedy
tokens equal.  bf16 weights: both packages round every projection, norm,
attention output and MLP output to bf16, where one bf16 ulp (2^-8 to 2^-7
relative) falls either way on f32 sums taken in other orders, and the
flips compound through 4 layers.  So logits and caches are held to
||port - ref|| <= 5e-2 ||ref|| and max |port - ref| <= 0.1 max |ref|
(measured worst 2.6e-2 and 0.043 of the max, qwen3 GQA with the flash
kernel; a wrong rotation or head mapping gives O(1)), and the per-layer
functions to one or two bf16 ulps.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _one_thread import one_thread  # noqa: E402,F401
from repro import models as rmodels  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, reduced_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, PROMPT = 2, 48, 32

CASES = {  # id: (arch, overrides)
    "qwen3-gqa": ("qwen3-8b", dict(n_kv_heads=2)),
    "qwen3-mqa": ("qwen3-8b", dict(n_kv_heads=1)),
    "yi": ("yi-6b", {}),
    "phi3-mini": ("phi3-mini-3.8b", {}),
}


def _cfgs(case, dtype):
    arch, over = CASES[case]
    over = dict(over, dtype=dtype)
    return ref_reduced(ref_get_config(arch), **over), reduced_config(get_config(arch), **over)


@functools.lru_cache(maxsize=None)
def _ref_params(rcfg):
    """The reference's dense parameter tree (`init_params`' structure,
    shapes, dtypes and scales, layers stacked on a leading L axis), drawn
    with numpy: the reference's own init only adds a jax.random compile."""
    rng = np.random.default_rng(0)
    d, h, kvh, hd, f, v, n = (rcfg.d_model, rcfg.n_heads, rcfg.n_kv_heads, rcfg.hd,
                              rcfg.d_ff, rcfg.vocab_size, rcfg.n_layers)
    dt = jnp.dtype(rcfg.dtype)

    def normal(shape, std):
        return jnp.asarray(rng.normal(0, std, shape).astype(np.float32)).astype(dt)

    def norm(shape):  # RMS scales near 1, so a swapped scale shows
        return jnp.asarray(rng.normal(1, 0.1, shape).astype(np.float32)).astype(dt)

    attn = {"wq": normal((n, d, h * hd), d**-0.5), "wk": normal((n, d, kvh * hd), d**-0.5),
            "wv": normal((n, d, kvh * hd), d**-0.5), "wo": normal((n, h * hd, d), d**-0.5)}
    if rcfg.qk_norm:
        attn.update(q_norm=norm((n, hd)), k_norm=norm((n, hd)))
    tree = {
        "embed": normal((v, d), 0.02), "final_norm": norm((d,)),
        "lm_head": normal((d, v), d**-0.5),
        "layers": {"attn": attn, "ln1": norm((n, d)), "ln2": norm((n, d)), "mlp": {
            "w_gate": normal((n, d, f), d**-0.5), "w_up": normal((n, d, f), d**-0.5),
            "w_down": normal((n, f, d), f**-0.5)}},
    }
    want = jax.eval_shape(functools.partial(rmodels.init_params, cfg=rcfg), jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert all(a.shape == b.shape and a.dtype == b.dtype
               for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)))
    return tree


def _port_model(rcfg, tcfg):
    state = lm_params_from_reference(
        jax.tree.map(np.asarray, _ref_params(rcfg)), tcfg, device="cpu")
    model = tmodels.DecoderLM(tcfg, device="meta")
    model.load_state_dict(state, assign=True)
    return model


# one compile per config for all decode steps (a traced cache_len, as in the
# reference's `serve.py`)
_ref_decode = jax.jit(rmodels.decode_step, static_argnums=1)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _tokens(cfg, seed=1, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def assert_close(got, want, dtype):
    """F32_TOL in f32; in bf16 the norm and max bounds of the docstring."""
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= 5e-2 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 0.1 * np.abs(want).max()


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_functions_match_reference(dtype):
    rng = np.random.default_rng(3)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ulp = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2**-7, atol=2**-7)

    def both(a):
        return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)

    x = rng.normal(0, 1, (B, 16, 4, 32)).astype(np.float32)
    scale = rng.normal(1, 0.1, (32,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, 21, dtype=np.int32), (B, 16))
    (jx, tx), (js, ts) = both(x), both(scale)
    np.testing.assert_allclose(_np(tlayers.rms_norm(tx, ts)), _np(rlayers.rms_norm(jx, js)), **ulp)
    np.testing.assert_allclose(
        _np(tlayers.apply_rope(tx, torch.from_numpy(pos.copy()), 1e4)),
        _np(rlayers.apply_rope(jx, jnp.asarray(pos), 1e4)), **ulp)
    np.testing.assert_allclose(_np(tlayers.rope_freqs(32, 1e4)),
                               _np(rlayers.rope_freqs(32, 1e4)), rtol=1e-6)

    h = rng.normal(0, 1, (B, 16, 64)).astype(np.float32)
    ws = [rng.normal(0, 0.125, s).astype(np.float32) for s in ((64, 96), (64, 96), (96, 64))]
    jh, th = both(h)
    jw, tw = zip(*map(both, ws))
    tol = F32_TOL if dtype == "float32" else dict(rtol=2**-6, atol=2**-6)
    np.testing.assert_allclose(_np(tlayers.swiglu(th, *tw)), _np(rlayers.swiglu(jh, *jw)), **tol)


@pytest.mark.parametrize("chunk", [16, 64])
def test_attention_scans_match_reference(chunk):
    rng = np.random.default_rng(chunk)
    b, sq, sk, h, kvh, hd = 2, 24, 40, 4, 2, 16
    q = rng.normal(0, 1, (b, sq, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, sk, kvh, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, sk, kvh, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10, 10 + sq, dtype=np.int32), (b, sq)).copy()
    valid = np.array([34, 30], np.int32)
    t = torch.from_numpy
    got = tlayers._flash_chunk_scan(t(q), t(k), t(v), t(pos), t(valid), chunk, 0.25)
    want = rlayers._flash_chunk_scan(q, k, v, pos, valid, chunk, 0.25)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    got = tlayers._flash_chunk_scan(t(q), t(k[:, :sq]), t(v[:, :sq]), t(pos - 10), None, chunk, 0.25)
    want = rlayers._flash_chunk_scan(q, k[:, :sq], v[:, :sq], pos - 10, None, chunk, 0.25)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    # the decode scan over a cache of whole chunks (see the next test)
    kd, vd, vl = k[:, :32], v[:, :32], np.array([30, 21], np.int32)
    got = tlayers._flash_decode(t(q[:, :1]), t(kd), t(vd), t(vl), chunk, 0.25)
    want = rlayers._flash_decode(q[:, :1], kd, vd, vl, chunk, 0.25)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_flash_decode_ragged_last_chunk():
    """A cache that is not a whole number of chunks (40 keys, chunk 16).
    The reference's `_flash_decode` reads its last chunk with
    `dynamic_slice_in_dim`, which clamps the start (32 -> 24), so it scores
    keys 24..39 under the positions 32..47 (ROADMAP.md queue C item 4).
    The port slices [32, 40) and equals the reference's chunk scan of the
    same query at position valid - 1."""
    rng = np.random.default_rng(12)
    b, sk, h, kvh, hd = 2, 40, 4, 2, 16
    q = rng.normal(0, 1, (b, 1, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, sk, kvh, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, sk, kvh, hd)).astype(np.float32)
    valid = np.array([38, 35], np.int32)
    t = torch.from_numpy
    got = tlayers._flash_decode(t(q), t(k), t(v), t(valid), 16, 0.25)
    want = rlayers._flash_chunk_scan(q, k, v, (valid - 1)[:, None], valid, 16, 0.25)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    faulty = rlayers._flash_decode(q, k, v, valid, 16, 0.25)
    assert np.abs(_np(faulty) - _np(want)).max() > 1e-2


@pytest.mark.parametrize("flash", [False, True])
def test_gqa_attention_cached_matches_reference(flash):
    """One attention block against a half-filled f32 cache, the new tokens
    written in place (port) / by dynamic_update_slice (reference)."""
    rcfg, tcfg = _cfgs("qwen3-gqa", "float32")
    rcfg = dataclasses.replace(rcfg, use_flash_kernel=flash)
    tcfg = dataclasses.replace(tcfg, use_flash_kernel=flash)
    rng = np.random.default_rng(9)
    model = _port_model(rcfg, tcfg)
    ref_attn = jax.tree.map(lambda a: a[0], _ref_params(rcfg)["layers"]["attn"])
    x = rng.normal(0, 1, (B, 16, tcfg.d_model)).astype(np.float32)
    ck = rng.normal(0, 1, (B, 64, tcfg.n_kv_heads, tcfg.hd)).astype(np.float32)
    cv = rng.normal(0, 1, ck.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, 32, dtype=np.int32), (B, 16)).copy()
    want, (wk, wv) = rlayers.gqa_attention(x, ref_attn, pos, rcfg, (ck, cv), 16)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ops.reset_launches()
    got, (gk, gv) = tlayers.gqa_attention(
        torch.from_numpy(x), model.layers[0].attn, torch.from_numpy(pos), tcfg, (tk, tv), 16)
    assert gk is tk and gv is tv  # the cache is updated in place
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(gk), _np(wk), **F32_TOL)
    np.testing.assert_allclose(_np(gv), _np(wv), **F32_TOL)
    assert ops.launches["flash_attention_fwd"] == 0


# --------------------------------------------------------------------------- #
# prefill, decode, the forward twin
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case, dtype):
    """prefill with the flash kernel on and off, then 2 decode steps fed the
    reference's greedy tokens: logits and caches against the reference, and
    in f32 the port's greedy tokens equal the reference's."""
    rcfg0, tcfg0 = _cfgs(case, dtype)
    model = _port_model(rcfg0, tcfg0)
    params = _ref_params(rcfg0)
    tok = _tokens(tcfg0)[:, :PROMPT]
    for flash in (False, True):
        rcfg = dataclasses.replace(rcfg0, use_flash_kernel=flash)
        tcfg = dataclasses.replace(tcfg0, use_flash_kernel=flash)
        want, wcache = rmodels.prefill(params, rcfg, jnp.asarray(tok), max_len=S,
                                       cache_dtype=jnp.float32)
        got, gcache = tmodels.prefill(model, tcfg, torch.from_numpy(tok), max_len=S,
                                      cache_dtype=torch.float32)
        assert got.shape == (B, 1, tcfg.vocab_size) and gcache["k"].dtype == torch.float32
        assert_close(got, want, dtype)
        assert_close(gcache["k"], wcache["k"], dtype)
        assert_close(gcache["v"], wcache["v"], dtype)
    # decode from the flash-on caches
    for i in range(2):
        wt = jnp.argmax(want[:, -1], -1)[:, None]
        if dtype == "float32":
            np.testing.assert_array_equal(got[:, -1].argmax(-1).numpy(), np.asarray(wt[:, 0]))
        want, wcache = _ref_decode(params, rcfg, wt, wcache, jnp.int32(PROMPT + i))
        got, gcache = tmodels.decode_step(model, tcfg, torch.from_numpy(np.array(wt)),
                                          gcache, PROMPT + i)
        assert_close(got, want, dtype)
    assert_close(gcache["k"], wcache["k"], dtype)
    assert_close(gcache["v"], wcache["v"], dtype)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("case", ["qwen3-gqa", "yi"])
def test_prefill_decode_matches_forward(case, flash):
    """The twin of `test_models.py::test_prefill_decode_matches_forward`
    inside the port: prefill 32 tokens + one decode step == the full
    forward's positions 31 and 32 (its tolerance, 2e-3)."""
    _, tcfg = _cfgs(case, "float32")
    tcfg = dataclasses.replace(tcfg, use_flash_kernel=flash, opt_decode=flash)
    model = tmodels.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(_tokens(tcfg, seed=4, s=64))
    lg, cache = tmodels.prefill(model, tcfg, tok[:, :32], max_len=64, cache_dtype=torch.float32)
    l2, cache = tmodels.decode_step(model, tcfg, tok[:, 32:33], cache, 32)
    full, aux = tmodels.forward_train(model, tcfg, tok[:, :33])
    assert float(aux) == 0.0
    torch.testing.assert_close(lg[:, 0], full[:, 31], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(l2[:, 0], full[:, 32], rtol=2e-3, atol=2e-3)


def test_unsupported_head_dim_raises_not_falls_back(monkeypatch):
    """A head dim without a fast B10 instance (48): the flash prefill goes
    through B10's wrapper (the general kernel on the card), never the
    chunked scan, and equals the reference's flash prefill (logits and
    caches at F32_TOL)."""
    rcfg, tcfg = _cfgs("qwen3-gqa", "float32")
    rcfg = dataclasses.replace(rcfg, head_dim=48, use_flash_kernel=True)
    tcfg = dataclasses.replace(tcfg, head_dim=48, use_flash_kernel=True)
    model = _port_model(rcfg, tcfg)
    tok = _tokens(tcfg)[:, :PROMPT]
    calls = []
    flash = ops.flash_attention_fwd
    monkeypatch.setattr(ops, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(a[0].shape) or flash(*a, **kw))
    got, gcache = tmodels.prefill(model, tcfg, torch.from_numpy(tok), max_len=S,
                                  cache_dtype=torch.float32)
    want, wcache = rmodels.prefill(_ref_params(rcfg), rcfg, jnp.asarray(tok), max_len=S,
                                   cache_dtype=jnp.float32)
    assert len(calls) == tcfg.n_layers and all(c[-1] == 48 for c in calls)
    assert_close(got, want, "float32")
    assert_close(gcache["k"], wcache["k"], "float32")
    assert_close(gcache["v"], wcache["v"], "float32")


def test_forward_matches_reference():
    rcfg, tcfg = _cfgs("qwen3-gqa", "float32")
    model = _port_model(rcfg, tcfg)
    tok = _tokens(tcfg, seed=6)
    want, _ = rmodels.forward_train(_ref_params(rcfg), rcfg, jnp.asarray(tok))
    got, _ = tmodels.forward_train(model, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


# --------------------------------------------------------------------------- #
# configs, parameter counts
# --------------------------------------------------------------------------- #


def test_configs_equal_reference():
    from repro.configs import memanns as rmem
    from repro_torch.configs import memanns as tmem

    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_get_config(arch))
        assert dataclasses.asdict(reduced_config(get_config(arch))) == dataclasses.asdict(
            ref_reduced(ref_get_config(arch)))
    for name in ("SIFT1B", "SPACEV1B"):
        assert dataclasses.asdict(getattr(tmem, name)) == dataclasses.asdict(getattr(rmem, name))
        assert dataclasses.asdict(tmem.reduced_retrieval(getattr(tmem, name), dim=64)) == \
            dataclasses.asdict(rmem.reduced_retrieval(getattr(rmem, name), dim=64))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_params_accounting(arch):
    """Full width, nothing allocated: the module on the meta device has
    exactly the reference's parameter count (its `eval_shape` of
    `init_params`), within 5 % of `ModelConfig.n_params()` as there, for
    every family of the registry."""
    cfg = get_config(arch)
    model = tmodels.DecoderLM(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(functools.partial(rmodels.init_params, cfg=ref_get_config(arch)),
                            jax.random.PRNGKey(0))
    assert total == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert abs(total - cfg.n_params()) / total < 0.05
    assert model.lm_head.dtype == torch.bfloat16 and model.layers[0].ln1.is_meta
