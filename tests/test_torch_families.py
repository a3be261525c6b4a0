"""Every model family of the registry in the port against the reference.

The six configs beyond the dense family -- phi3.5-moe (MoE), deepseek-v2
(MLA + MoE with shared experts and a leading dense layer), zamba2 (Mamba2
groups + one shared attention block: two groups of two and a leftover
layer at the reduced size), mamba2 (SSD), llava-next (a prefix of vision
embeddings) and musicgen (audio token ids) -- each at its reduced size
(`reduced_config`), in f32.  Weights are drawn with numpy in the tree of
the reference's `init_params` (its `eval_shape`), norms near 1 and the
Mamba2 `a_log` / `dt_bias` away from 0 so that a swapped or dropped one
shows; `convert.lm_params_from_reference` carries them into the port.
The same numpy tokens (and embeddings) go through `forward_train`,
`prefill` with the flash kernel on (B10's plain version here, the Pallas
kernel in interpret mode there) and two `decode_step`s fed the
reference's greedy tokens.  Prompts of 40 positions into 64-position
caches: not a multiple of the SSD chunk (32), so the prefill pads.

Tolerances: rtol = atol = 1e-4 (f32 sums in other orders) on logits, aux
losses and caches; the port's own prefill + decode against its forward at
the reference's 2e-3 (`tests/test_models.py`), with the capacity factor
4.0 that test uses so that no token drops.
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
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402

F32_TOL = dict(rtol=1e-4, atol=1e-4)
B, PROMPT, MAX_LEN, STEPS = 2, 40, 64, 2
FAMILIES = ["phi3.5-moe-42b", "deepseek-v2-236b", "zamba2-7b", "mamba2-130m",
            "llava-next-34b", "musicgen-medium"]


def cfgs(arch, **over):
    """(reference config, port config): the reduced config, flash on."""
    over = dict(dict(use_flash_kernel=True), **over)
    return (ref_reduced(ref_get_config(arch), **over),
            reduced_config(get_config(arch), **over))


@functools.lru_cache(maxsize=None)
def ref_params(rcfg, seed=0):
    """The reference's parameter tree for `rcfg` (shapes and dtypes from its
    `init_params`' `eval_shape`), drawn with numpy: weights normal with std
    1/sqrt(fan-in) (the second-to-last axis), the embedding 0.02, norm scales
    normal(1, 0.1), `a_log` and `dt_bias` normal(0, 0.5)."""
    shapes = jax.eval_shape(functools.partial(rmodels.init_params, cfg=rcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name in ("a_log", "dt_bias"):
            a = rng.normal(0, 0.5, s.shape)
        elif name.endswith("norm") or name in ("ln1", "ln2"):
            a = rng.normal(1, 0.1, s.shape)
        else:
            a = rng.normal(0, 0.02 if name == "embed" else s.shape[-2] ** -0.5, s.shape)
        return jnp.asarray(a.astype(np.float32)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(rcfg, tcfg):
    state = lm_params_from_reference(jax.tree.map(np.asarray, ref_params(rcfg)), tcfg,
                                     device="cpu")
    model = tmodels.DecoderLM(tcfg, device="meta")
    model.load_state_dict(state, assign=True)
    return model


def inputs(cfg, n, seed=1):
    """(tokens (B, n - prefix) int32, embeddings (B, prefix, d) f32 or None):
    n positions, the vision stub's prefix first."""
    rng = np.random.default_rng(seed)
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    tok = rng.integers(0, cfg.vocab_size, (B, n - n_front)).astype(np.int32)
    emb = rng.normal(0, 1, (B, n_front, cfg.d_model)).astype(np.float32) if n_front else None
    return tok, emb


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@functools.lru_cache(maxsize=None)
def ref_run(arch):
    """The reference's outputs, once per module: forward logits and aux over
    PROMPT + 1 positions; the prefill's logits and cache; STEPS decode
    steps' logits, tokens fed and the final cache."""
    rcfg, _ = cfgs(arch)
    params = ref_params(rcfg)
    tok, emb = inputs(rcfg, PROMPT + 1)
    full, aux = rmodels.forward_train(params, rcfg, _j(tok), _j(emb))
    n_tok = tok.shape[1] - 1
    lg, cache = rmodels.prefill(params, rcfg, _j(tok[:, :n_tok]), max_len=MAX_LEN,
                                embeddings=_j(emb), cache_dtype=jnp.float32)
    prefill_out = (_np(lg), jax.tree.map(_np, cache))
    steps, fed = [], []
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None].astype(np.int32)
        lg, cache = rmodels.decode_step(params, rcfg, jnp.asarray(nxt), cache,
                                        jnp.int32(PROMPT + i))
        steps.append(_np(lg))
        fed.append(nxt)
    return dict(full=_np(full), aux=float(aux), prefill=prefill_out, steps=steps, fed=fed,
                cache=jax.tree.map(_np, cache))


@functools.lru_cache(maxsize=None)
def port_model_for(arch):
    return port_model(*cfgs(arch))


def assert_cache_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(_np(got[name]), want[name], **F32_TOL, err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch):
    """forward_train's logits (the vision prefix included) and summed MoE
    aux loss."""
    _, tcfg = cfgs(arch)
    want = ref_run(arch)
    tok, emb = inputs(tcfg, PROMPT + 1)
    got, aux = tmodels.forward_train(port_model_for(arch), tcfg, _t(tok), _t(emb))
    assert got.shape == (B, PROMPT + 1, tcfg.vocab_size)
    np.testing.assert_allclose(_np(got), want["full"], **F32_TOL)
    np.testing.assert_allclose(float(aux), want["aux"], **F32_TOL)
    assert (float(aux) > 0) == bool(tcfg.n_experts)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_reference(arch):
    """prefill's last-position logits and every cache tensor."""
    _, tcfg = cfgs(arch)
    want_lg, want_cache = ref_run(arch)["prefill"]
    tok, emb = inputs(tcfg, PROMPT + 1)
    got, cache = tmodels.prefill(port_model_for(arch), tcfg, _t(tok[:, :-1]), max_len=MAX_LEN,
                                 embeddings=_t(emb), cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), want_lg, **F32_TOL)
    assert_cache_close(cache, want_cache)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_reference(arch):
    """STEPS decode steps from the port's own prefill, fed the reference's
    greedy tokens (which the port's own greedy choice equals): logits each
    step and the final cache."""
    _, tcfg = cfgs(arch)
    want = ref_run(arch)
    tok, emb = inputs(tcfg, PROMPT + 1)
    model = port_model_for(arch)
    lg, cache = tmodels.prefill(model, tcfg, _t(tok[:, :-1]), max_len=MAX_LEN,
                                embeddings=_t(emb), cache_dtype=torch.float32)
    for i, (nxt, want_lg) in enumerate(zip(want["fed"], want["steps"])):
        np.testing.assert_array_equal(lg[:, -1].argmax(-1).numpy(), nxt[:, 0])
        lg, cache = tmodels.decode_step(model, tcfg, _t(nxt), cache, PROMPT + i)
        np.testing.assert_allclose(_np(lg), want_lg, **F32_TOL)
    assert_cache_close(cache, want["cache"])


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_matches_forward(arch, flash):
    """The twin of `test_models.py::test_prefill_decode_matches_forward`
    inside the port, at every family: prefill PROMPT positions + one decode
    step == the full forward's last two positions (its tolerance, 2e-3;
    capacity factor 4.0, so no token drops in either)."""
    _, tcfg = cfgs(arch, capacity_factor=4.0, use_flash_kernel=flash)
    model = tmodels.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tok, emb = (_t(a) for a in inputs(tcfg, PROMPT + 1, seed=4))
    lg, cache = tmodels.prefill(model, tcfg, tok[:, :-1], max_len=MAX_LEN, embeddings=emb,
                                cache_dtype=torch.float32)
    l2, _ = tmodels.decode_step(model, tcfg, tok[:, -1:], cache, PROMPT)
    full, _ = tmodels.forward_train(model, tcfg, tok, emb)
    torch.testing.assert_close(lg[:, 0], full[:, -2], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(l2[:, 0], full[:, -1], rtol=2e-3, atol=2e-3)


def test_one_token_ssm_prefill_takes_the_recurrence():
    """A one-token prefill of an SSM config runs each Mamba2 layer's decode
    recurrence from the empty state (the reference's choice): equal to the
    reference's, and to a chunked prefill of the same token."""
    rcfg, tcfg = cfgs("mamba2-130m")
    tok, _ = inputs(tcfg, 1)
    want, wcache = rmodels.prefill(ref_params(rcfg), rcfg, jnp.asarray(tok), max_len=8,
                                   cache_dtype=jnp.float32)
    got, cache = tmodels.prefill(port_model_for("mamba2-130m"), tcfg, _t(tok), max_len=8,
                                 cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert_cache_close(cache, jax.tree.map(_np, wcache))


@pytest.mark.parametrize("arch,stack", [("deepseek-v2-236b", "dense_layers"),
                                        ("phi3.5-moe-42b", "layers"), ("zamba2-7b", "layers")])
def test_convert_refuses_wrong_layer_count(arch, stack):
    rcfg, tcfg = cfgs(arch)
    tree = jax.tree.map(np.asarray, ref_params(rcfg))
    tree[stack] = jax.tree.map(lambda a: a[:-1], tree[stack])
    with pytest.raises(ValueError, match=stack):
        lm_params_from_reference(tree, tcfg, device="cpu")
    whole = jax.tree.map(np.asarray, ref_params(rcfg))
    with pytest.raises(ValueError, match="layers"):
        lm_params_from_reference(whole, dataclasses.replace(tcfg, n_layers=tcfg.n_layers + 1),
                                 device="cpu")
