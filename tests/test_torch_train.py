"""The port's training path against the reference's, on the CPU.

Gradients: the seven families (dense GQA with qk-norm, phi3.5-moe,
deepseek-v2, zamba2, mamba2, llava-next with its embedding prefix,
musicgen) at `reduced_config` sizes in f32, 160 positions over
`attn_chunk` 64 -- the last chunk ragged, later chunks fully masked for
early queries -- through the port's `loss_fn` + `backward` and
`jax.value_and_grad(repro.training.trainer.loss_fn)` on the same weights
(drawn with numpy in the reference's tree, carried over by `convert`).
Loss, CE and aux within rtol 1e-5; each gradient leaf within a relative
norm of 1e-4 (f32 sums in other orders).  Remat on == off bit for bit in
the port.

Steps: three train steps of the port against the reference's
`make_train_step` on a 1x1 mesh (`donate=False`): metrics within rtol
1e-5, parameters and moments per leaf within 1e-2 of the leaf's update
norm (AdamW divides by sqrt(v), so the f32 noise of a near-zero gradient
element moves its update; 1e-2 leaves room for that and catches a wrong
update).  The `Trainer` and the launcher are in `test_torch_trainer.py`.
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
from repro.optim import AdamWConfig as RefAdamW  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt  # noqa: E402
from repro.training import loss_fn as ref_loss_fn  # noqa: E402
from repro.training import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import lm_params_from_reference, lm_params_to_reference  # noqa: E402
from repro_torch.data import SyntheticTokenDataset  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.training import loss_fn, make_train_step, trainable  # noqa: E402

B, SEQ = 2, 160  # 160 positions over attn_chunk 64: a ragged last chunk
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
FAMILIES = ["qwen3-8b", "phi3.5-moe-42b", "deepseek-v2-236b", "zamba2-7b", "mamba2-130m",
            "llava-next-34b", "musicgen-medium"]


def cfgs(arch, **over):
    """(reference config, port config) at the reduced size."""
    return ref_reduced(ref_get_config(arch), **over), reduced_config(get_config(arch), **over)


@functools.lru_cache(maxsize=None)
def ref_params(rcfg, seed=0):
    """The reference's parameter tree for `rcfg` (shapes and dtypes from its
    `init_params`' `eval_shape`), drawn with numpy: weights normal with std
    1/sqrt(fan-in), the embedding 0.02, norm scales normal(1, 0.1), `a_log`
    and `dt_bias` normal(0, 0.5)."""
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


def port_model(rcfg, tcfg, seed=0):
    state = lm_params_from_reference(jax.tree.map(np.asarray, ref_params(rcfg, seed)), tcfg,
                                     device="cpu")
    model = tmodels.DecoderLM(tcfg, device="meta")
    model.load_state_dict(state, assign=True)
    return trainable(model)


def inputs(cfg, n=SEQ, seed=1):
    """(tokens (B, n - prefix) int32, embeddings (B, prefix, d) f32 or None)."""
    rng = np.random.default_rng(seed)
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    tok = rng.integers(0, cfg.vocab_size, (B, n - n_front)).astype(np.int32)
    emb = rng.normal(0, 1, (B, n_front, cfg.d_model)).astype(np.float32) if n_front else None
    return tok, emb


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(jnp.asarray(v).astype(jnp.float32))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_grads(model) -> dict:
    return leaves(lm_params_to_reference({n: p.grad for n, p in model.named_parameters()}))


def port_loss_and_grads(arch, remat=False):
    rcfg, tcfg = cfgs(arch)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    model = port_model(rcfg, tcfg)
    tok, emb = inputs(tcfg)
    loss, (ce, aux) = loss_fn(model, tcfg, _t(tok), _t(emb))
    loss.backward()
    return tuple(float(t.detach()) for t in (loss, ce, aux)), model


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    rcfg, tcfg = cfgs(arch)
    tok, emb = inputs(tcfg)
    (loss, (ce, aux)), grads = jax.value_and_grad(
        lambda p: ref_loss_fn(p, rcfg, _j(tok), _j(emb)), has_aux=True)(ref_params(rcfg))
    got, model = port_loss_and_grads(arch)
    np.testing.assert_allclose(got, [float(loss), float(ce), float(aux)], rtol=LOSS_RTOL,
                               atol=1e-7)
    assert (got[2] > 0) == bool(tcfg.n_experts)
    want, mine = leaves(grads), port_grads(model)
    assert set(mine) == set(want)
    for k in want:
        assert mine[k].shape == want[k].shape, k
        assert np.isfinite(mine[k]).all(), k
        assert rel(mine[k], want[k]) <= GRAD_REL, (k, rel(mine[k], want[k]))


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-236b", "zamba2-7b"])
def test_remat_changes_nothing(arch):
    """Each layer recomputed in the backward (`torch.utils.checkpoint`)
    gives the same loss and gradients, bit for bit, as the plain backward."""
    plain, m_plain = port_loss_and_grads(arch, remat=False)
    remat, m_remat = port_loss_and_grads(arch, remat=True)
    assert plain == remat
    for (n, a), (_, b) in zip(m_plain.named_parameters(), m_remat.named_parameters()):
        assert torch.equal(a.grad, b.grad), n


def _mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("arch", ["qwen3-8b", "phi3.5-moe-42b"])
def test_train_steps_match_reference(arch):
    """Three steps (warmup 1: step 0 moves only the moments) against the
    reference's jitted step on a 1x1 mesh: metrics rtol 1e-5; after the
    third, every parameter and moment leaf within 1e-2 of its distance
    from the start (the update's norm)."""
    rcfg, tcfg = cfgs(arch)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=6)
    ref_step = ref_make_train_step(rcfg, _mesh(), RefAdamW(**ocfg), donate=False)
    step = make_train_step(tcfg, AdamWConfig(**ocfg))
    p_ref = ref_params(rcfg)
    o_ref = ref_init_opt(p_ref)
    model = port_model(rcfg, tcfg)
    opt = init_opt_state(model)
    ds = SyntheticTokenDataset(tcfg.vocab_size, 48, B, seed=3)
    for s in range(3):
        tok = ds.batch(s)
        p_ref, o_ref, m_ref = ref_step(p_ref, o_ref, jnp.asarray(tok))
        model, opt, m = step(model, opt, _t(tok))
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(m_ref[k]), rtol=1e-5, atol=1e-8,
                                       err_msg=f"step {s} {k}")
    assert int(opt["step"]) == int(o_ref["step"]) == 3
    init = leaves(ref_params(rcfg))
    for name, want, got in (
            ("params", leaves(p_ref), leaves(lm_params_to_reference(model))),
            ("mu", leaves(o_ref["mu"]), leaves(lm_params_to_reference(opt["mu"]))),
            ("nu", leaves(o_ref["nu"]), leaves(lm_params_to_reference(opt["nu"])))):
        assert set(got) == set(want)
        for k in want:
            moved = np.linalg.norm(want[k] - (init[k] if name == "params" else 0.0))
            assert moved > 0, (name, k)
            assert np.linalg.norm(got[k] - want[k]) <= 1e-2 * moved, (name, k)
