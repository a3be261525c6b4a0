"""The port's Mamba2 SSD (`repro_torch.models.ssm`) against the reference's
(`repro.models.ssm`) and against the plain recurrence.

Same numpy inputs through both on the CPU, in f32 at rtol = atol = 1e-4
(f32 sums in other orders): `_segsum`; `ssd_chunked` with and without an
initial state, and against the step-by-step recurrence it computes in
chunks (float64 numpy); `mamba2_block` prefill at lengths that are a chunk
multiple, not one (the dt = 0 padding) and shorter than a chunk, with its
conv window and SSM state; the one-step decode from a random state; and
prefill + decode == a prefill of one more position.  Shapes: mamba2's
reduced config (d 64, d_inner 128, 8 heads of 16, state 16, conv 4, chunk
32); `a_log` and `dt_bias` drawn away from 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _one_thread import one_thread  # noqa: E402,F401
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
B = 2
RCFG = ref_reduced(ref_get_config("mamba2-130m"))
TCFG = reduced_config(get_config("mamba2-130m"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, di, h, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv
    p = {"in_proj": rng.normal(0, d**-0.5, (d, 2 * di + 2 * h * n + h)),
         "conv_w": rng.normal(0, k**-0.5, (k, di + 2 * h * n)),
         "dt_bias": rng.normal(0, 0.5, h), "a_log": rng.normal(0, 0.5, h),
         "out_norm": rng.normal(1, 0.1, di), "out_proj": rng.normal(0, di**-0.5, (di, d))}
    p = {n_: a.astype(np.float32) for n_, a in p.items()}
    return {n_: jnp.asarray(a) for n_, a in p.items()}, {n_: torch.from_numpy(a) for n_, a in p.items()}


def _ssd_inputs(s, h=4, p=8, n=6, seed=0):
    rng = np.random.default_rng(seed)
    xh = rng.normal(0, 1, (B, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (B, s, h)))).astype(np.float32)  # softplus'd
    a_log = rng.normal(0, 0.5, h).astype(np.float32)
    bm = rng.normal(0, 1, (B, s, h, n)).astype(np.float32)
    cm = rng.normal(0, 1, (B, s, h, n)).astype(np.float32)
    return xh, dt, a_log, bm, cm


def test_segsum_matches_reference():
    x = np.random.default_rng(0).normal(0, 1, (3, 5, 16)).astype(np.float32)
    got, want = _np(tssm._segsum(torch.from_numpy(x))), np.asarray(rssm._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], **F32_TOL)


def _recurrence(xh, dt, a_log, bm, cm, s0=None):
    """The SSD's step-by-step recurrence in float64: s' = exp(dt a) s +
    dt x b^T, y = s' c."""
    xh, dt, bm, cm = (a.astype(np.float64) for a in (xh, dt, bm, cm))
    a = -np.exp(a_log.astype(np.float64))
    b, s, h, p = xh.shape
    st = np.zeros((b, h, p, bm.shape[-1])) if s0 is None else s0.astype(np.float64)
    ys = []
    for i in range(s):
        st = np.exp(dt[:, i] * a)[:, :, None, None] * st + np.einsum(
            "bhp,bhn->bhpn", xh[:, i] * dt[:, i, :, None], bm[:, i])
        ys.append(np.einsum("bhpn,bhn->bhp", st, cm[:, i]))
    return np.stack(ys, 1), st


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 24), (40, 8)])
def test_ssd_chunked_matches_reference(s, chunk, with_state):
    xh, dt, a_log, bm, cm = _ssd_inputs(s, seed=s + chunk)
    s0 = (np.random.default_rng(5).normal(0, 1, (B, 4, 8, 6)).astype(np.float32)
          if with_state else None)
    t = torch.from_numpy
    got_y, got_s = tssm.ssd_chunked(t(xh), t(dt), t(a_log), t(bm), t(cm), chunk,
                                    None if s0 is None else t(s0))
    want_y, want_s = rssm.ssd_chunked(xh, dt, a_log, bm, cm, chunk,
                                      None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), **F32_TOL)
    np.testing.assert_allclose(_np(got_s), np.asarray(want_s), **F32_TOL)
    exact_y, exact_s = _recurrence(xh, dt, a_log, bm, cm, s0)
    np.testing.assert_allclose(_np(got_y), exact_y, **F32_TOL)
    np.testing.assert_allclose(_np(got_s), exact_s, **F32_TOL)


def test_ssd_chunked_refuses_ragged_length():
    xh, dt, a_log, bm, cm = (torch.from_numpy(a) for a in _ssd_inputs(20))
    with pytest.raises(ValueError, match="chunk"):
        tssm.ssd_chunked(xh, dt, a_log, bm, cm, 8)


@pytest.mark.parametrize("s", [32, 40, 7, 1])
def test_mamba2_block_prefill_matches_reference(s):
    """32: one chunk; 40: padded to 64 with dt = 0; 7: one short chunk;
    1: the chunked scan over one position (the block's own prefill path)."""
    jp, tp = _params(TCFG, seed=s)
    x = np.random.default_rng(s).normal(0, 1, (B, s, TCFG.d_model)).astype(np.float32)
    want, wst = rssm.mamba2_block(jnp.asarray(x), jp, RCFG)
    got, gst = tssm.mamba2_block(torch.from_numpy(x), tp, TCFG)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    for name in ("conv", "ssm"):
        assert gst[name].shape == wst[name].shape
        np.testing.assert_allclose(_np(gst[name]), np.asarray(wst[name]), **F32_TOL)


def test_mamba2_block_decode_matches_reference():
    """The exact one-step recurrence from a random conv window and state."""
    jp, tp = _params(TCFG, seed=9)
    rng = np.random.default_rng(9)
    cd = TCFG.d_inner + 2 * TCFG.ssm_heads * TCFG.ssm_state
    x = rng.normal(0, 1, (B, 1, TCFG.d_model)).astype(np.float32)
    st = {"conv": rng.normal(0, 1, (B, TCFG.ssm_conv - 1, cd)).astype(np.float32),
          "ssm": rng.normal(0, 1, (B, TCFG.ssm_heads, TCFG.ssm_head_dim,
                                   TCFG.ssm_state)).astype(np.float32)}
    want, wst = rssm.mamba2_block(jnp.asarray(x), jp, RCFG,
                                  {k: jnp.asarray(v) for k, v in st.items()})
    got, gst = tssm.mamba2_block(torch.from_numpy(x), tp, TCFG,
                                 {k: torch.from_numpy(v) for k, v in st.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32_TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(_np(gst[name]), np.asarray(wst[name]), **F32_TOL)


def test_mamba2_prefill_then_decode_equals_longer_prefill():
    """Prefill 40 positions, decode the 41st from the returned state ==
    the 41-position prefill's last output and state (the port alone)."""
    _, tp = _params(TCFG, seed=2)
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (B, 41, TCFG.d_model))
                         .astype(np.float32))
    _, st = tssm.mamba2_block(x[:, :40], tp, TCFG)
    step, st1 = tssm.mamba2_block(x[:, 40:], tp, TCFG, st)
    full, st_full = tssm.mamba2_block(x, tp, TCFG)
    torch.testing.assert_close(step[:, 0], full[:, -1], **F32_TOL)
    torch.testing.assert_close(st1["ssm"], st_full["ssm"], **F32_TOL)
    torch.testing.assert_close(st1["conv"], st_full["conv"], **F32_TOL)
