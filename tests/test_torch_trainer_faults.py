"""A train step that fails inside the in-place AdamW update (ROADMAP C12).

The twins of `test_torch_trainer.py::test_trainer_recovers_from_failing_step`
with the failure injected inside `adamw_update` after half the leaves are
updated, where the reference's jitted step would have changed nothing:
without a checkpoint the trainer raises and never retries on the
half-updated state; with one it restores it, and the final weights and
every step's loss equal an uninterrupted run's bit for bit (the CPU's
sums repeat; reduced yi-6b, 2 layers, f32, batch 2 x 32, seed 0).
"""

import pytest

torch = pytest.importorskip("torch")

from _one_thread import one_thread  # noqa: E402,F401
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.data import SyntheticTokenDataset  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_update  # noqa: E402
from repro_torch.training import OptimizerStepError, Trainer  # noqa: E402
from repro_torch.training import trainer as trainer_mod  # noqa: E402


def _kw(**over):
    cfg = reduced_config(get_config("yi-6b"), n_layers=2)
    return dict(cfg=cfg, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
                dataset=SyntheticTokenDataset(cfg.vocab_size, 32, 2), device="cpu", **over)


def _half_update_then_fail(fail_at: set, calls: list):
    """An `adamw_update` that, at the optimizer steps in `fail_at` (the state's
    step counter before the update), updates the first half of the leaves
    (the counter included) and raises, once per step."""

    def update(named, grads, state, cfg, lr):
        step = int(state["step"])
        calls.append(step)
        if step in fail_at:
            fail_at.discard(step)
            half = dict(list(named.items())[: len(named) // 2])
            adamw_update(half, grads, state, cfg, lr)
            raise RuntimeError("injected failure inside the optimizer")
        return adamw_update(named, grads, state, cfg, lr)

    return update


def test_optimizer_failure_without_checkpoint_raises(monkeypatch):
    """No checkpoint: the failure is raised at once (no retry on the
    half-updated state) even with retries left."""
    calls = []
    monkeypatch.setattr(trainer_mod, "adamw_update", _half_update_then_fail({1}, calls))
    with pytest.raises(OptimizerStepError) as info:
        Trainer(**_kw(max_retries=3)).run(0, 4)
    assert isinstance(info.value.__cause__, RuntimeError)
    assert calls == [0, 1]  # step 1 ran its update once and was not retried


def test_optimizer_failure_with_checkpoint_restores(tmp_path, monkeypatch):
    """A checkpoint at step 2, a failure inside step 3's update: the trainer
    restores step 2 and replays, and the weights and losses equal an
    uninterrupted run's."""
    _, _, whole, _ = Trainer(**_kw()).run(0, 6)
    want = dict(Trainer(**_kw()).run(0, 6)[0].named_parameters())

    calls = []
    monkeypatch.setattr(trainer_mod, "adamw_update", _half_update_then_fail({3}, calls))
    params, opt, hist, _ = Trainer(**_kw(ckpt_dir=str(tmp_path), ckpt_every=2,
                                         max_retries=3)).run(0, 6)
    assert calls == [0, 1, 2, 3, 2, 3, 4, 5]  # step 3 failed, 2 and 3 replayed
    assert [h["step"] for h in hist] == [0, 1, 2, 2, 3, 4, 5]
    last = {h["step"]: h["loss"] for h in hist}
    assert [last[s] for s in range(6)] == [h["loss"] for h in whole]
    assert int(opt["step"]) == 6
    for name, p in params.named_parameters():
        assert torch.equal(p, want[name]), name
