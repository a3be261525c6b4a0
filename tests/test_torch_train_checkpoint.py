"""LM training checkpoints: the port's `save` / `restore` / `latest_step`
in the reference's on-disk format.

A reduced deepseek-v2 (a dense layer, MoE layers with shared experts, MLA)
and zamba2 (Mamba2 layers and the shared block) in bf16, after one AdamW
step: the port's `save` and the reference's `save` of the same weights and
optimizer state write the same files (names, shapes, dtypes, values:
`params/layers__attn__wq.npy` stacked (L, ...), `opt/mu__...`,
`opt/step.npy`, bf16 widened to f32), and each package restores the
other's checkpoint exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _one_thread import one_thread  # noqa: E402,F401
from repro.checkpoint import restore as ref_restore  # noqa: E402
from repro.checkpoint import save as ref_save  # noqa: E402
from repro.optim import init_opt_state as ref_init_opt  # noqa: E402
from repro_torch.checkpoint import latest_step, restore, save  # noqa: E402
from repro_torch.convert import lm_params_to_reference  # noqa: E402
from repro_torch.data import SyntheticTokenDataset  # noqa: E402
from repro_torch.models import DecoderLM  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from test_torch_train import cfgs, port_model, ref_params  # noqa: E402

ARCHS = ["deepseek-v2-236b", "zamba2-7b"]


def test_checkpoint_roundtrip(tmp_path):
    """The twin of `test_trainer.py::test_checkpoint_roundtrip`."""
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "nest.b": torch.ones(4, dtype=torch.bfloat16)}
    opt = init_opt_state(params)
    save(str(tmp_path), 5, params, opt, extra={"note": "x"})
    assert latest_step(str(tmp_path)) == 5
    like = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, o2, meta = restore(str(tmp_path), 5, like, init_opt_state(like))
    assert meta["step"] == 5 and meta["note"] == "x"
    assert torch.equal(p2["a"], params["a"])
    assert p2["nest.b"].dtype == torch.bfloat16 and torch.equal(p2["nest.b"], params["nest.b"])
    assert sorted(os.listdir(tmp_path / "step_5" / "params")) == ["a.npy", "nest__b.npy"]


def test_latest_step_skips_tmp(tmp_path):
    assert latest_step(str(tmp_path / "missing")) is None
    assert latest_step(str(tmp_path)) is None
    (tmp_path / "step_3").mkdir()
    (tmp_path / "step_12.tmp").mkdir()  # a save that never committed
    (tmp_path / "other").mkdir()
    assert latest_step(str(tmp_path)) == 3


def trained(arch):
    """(reference config, port config, port model, its AdamW state) after one
    step at lr 1e-2 (warmup 1: the moments move, the weights do not) and a
    second (both move): bf16 weights, f32 moments."""
    rcfg, tcfg = cfgs(arch, dtype="bfloat16")
    model = port_model(rcfg, tcfg)
    opt = init_opt_state(model)
    step = make_train_step(tcfg, AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4))
    ds = SyntheticTokenDataset(tcfg.vocab_size, 32, 2)
    for s in range(2):
        model, opt, _ = step(model, opt, torch.from_numpy(ds.batch(s)))
    return rcfg, tcfg, model, opt


def ref_trees(rcfg, model, opt):
    """The port's state as the reference's trees, in the reference's dtypes."""
    like = ref_params(rcfg)
    cast = lambda tree, ref: jax.tree.map(lambda a, r: jnp.asarray(a).astype(r.dtype), tree, ref)  # noqa: E731
    params = cast(lm_params_to_reference(model), like)
    ropt = {"mu": cast(lm_params_to_reference(opt["mu"]), ref_init_opt(like)["mu"]),
            "nu": cast(lm_params_to_reference(opt["nu"]), ref_init_opt(like)["nu"]),
            "step": jnp.asarray(int(opt["step"]), jnp.int32)}
    return params, ropt


def files(path):
    out = {}
    for sub in ("params", "opt"):
        for f in sorted(os.listdir(path / sub)):
            out[f"{sub}/{f}"] = np.load(path / sub / f)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_port_save_equals_reference_save(arch, tmp_path):
    rcfg, tcfg, model, opt = trained(arch)
    rp, ro = ref_trees(rcfg, model, opt)
    save(str(tmp_path / "port"), 2, model, opt, extra={"arch": arch})
    ref_save(str(tmp_path / "ref"), 2, rp, ro, extra={"arch": arch})
    got, want = files(tmp_path / "port" / "step_2"), files(tmp_path / "ref" / "step_2")
    assert list(got) == list(want)
    assert "params/layers__attn__w_dkv.npy" in got or "params/layers__ssm__in_proj.npy" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for d in ("port", "ref"):
        assert (tmp_path / d / "step_2" / "meta.json").read_text() == (
            '{"step": 2, "arch": "%s"}' % arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_each_package_restores_the_other(arch, tmp_path):
    rcfg, tcfg, model, opt = trained(arch)
    rp, ro = ref_trees(rcfg, model, opt)
    # the reference's checkpoint into a fresh port model and state
    ref_save(str(tmp_path / "ref"), 7, rp, ro)
    fresh = DecoderLM(tcfg, device="cpu")
    fopt = init_opt_state(fresh)
    fresh, fopt, meta = restore(str(tmp_path / "ref"), 7, fresh, fopt)
    assert meta == {"step": 7} and int(fopt["step"]) == 2 and fopt["step"].dtype == torch.int32
    for (n, a), (_, b) in zip(fresh.named_parameters(), model.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    for part in ("mu", "nu"):
        for n in opt[part]:
            assert torch.equal(fopt[part][n], opt[part][n]), (part, n)
    # the port's checkpoint into the reference's trees
    save(str(tmp_path / "port"), 9, model, opt)
    like = ref_params(rcfg)
    p2, o2, meta = ref_restore(str(tmp_path / "port"), 9, like, ref_init_opt(like))
    assert meta == {"step": 9} and int(o2["step"]) == 2
    for tree_got, tree_want in ((p2, rp), (o2["mu"], ro["mu"]), (o2["nu"], ro["nu"])):
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree_got)[0],
                                     jax.tree_util.tree_flatten_with_path(tree_want)[0]):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                          err_msg=jax.tree_util.keystr(path))


def test_restore_refuses_a_wrong_shape(tmp_path):
    """A checkpoint of another depth does not load into this model."""
    _, tcfg = cfgs("yi-6b", n_layers=2)
    _, tcfg3 = cfgs("yi-6b", n_layers=3)
    save(str(tmp_path), 1, DecoderLM(tcfg, device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), 1, DecoderLM(tcfg3, device="cpu"))
