"""The port's `Trainer` and training launcher against the reference's, on
the CPU.

The twins of `tests/test_trainer.py`'s restart and failing-step tests; a
resumed run's losses equal to an uninterrupted run's (bit for bit: the
CPU's sums repeat); the port's history against the reference's `Trainer`
from the same weights (numpy-drawn in the reference's tree, carried over
by `convert`) over 4 steps, losses within rtol 1e-4 (f32 sums in other
orders over four steps); `launch.train` printing the reference
launcher's JSON keys, and refusing the CPU fallback and meshes one GPU
does not have.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _one_thread import one_thread  # noqa: E402,F401
from repro.data import SyntheticTokenDataset as RefDataset  # noqa: E402
from repro.optim import AdamWConfig as RefAdamW  # noqa: E402
from repro.training import Trainer as RefTrainer  # noqa: E402
from repro_torch.data import SyntheticTokenDataset  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.training import Trainer  # noqa: E402
from test_torch_train import _mesh, cfgs, port_model, ref_params  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _yi(n_layers=2):
    return cfgs("yi-6b", n_layers=n_layers)


def test_trainer_restart_resumes(tmp_path):
    """The twin of `test_trainer.py::test_trainer_restart_resumes`."""
    _, cfg = _yi()
    ds = SyntheticTokenDataset(cfg.vocab_size, 32, 2)
    kw = dict(cfg=cfg, opt_cfg=AdamWConfig(lr=1e-3, total_steps=10), dataset=ds,
              ckpt_dir=str(tmp_path), ckpt_every=4, device="cpu")
    Trainer(**kw).run(0, 6)
    _, _, hist, _ = Trainer(**kw).run(0, 9)
    assert hist[0]["step"] == 6  # resumed, not restarted


def test_trainer_recovers_from_failing_step(tmp_path):
    """The twin of `test_trainer.py::test_trainer_recovers_from_failing_step`:
    a step that raises is retried and the run completes from the last
    checkpoint."""
    _, cfg = _yi()

    class FlakyDS(SyntheticTokenDataset):
        fails = [0]

        def batch(self, step):
            if step == 5 and self.fails[0] < 2:
                self.fails[0] += 1
                raise RuntimeError("injected node failure")
            return super().batch(step)

    ds = FlakyDS(cfg.vocab_size, 32, 2)
    tr = Trainer(cfg=cfg, opt_cfg=AdamWConfig(lr=1e-3, total_steps=10), dataset=ds,
                 ckpt_dir=str(tmp_path), ckpt_every=2, max_retries=3, device="cpu")
    _, _, hist, _ = tr.run(0, 8)
    assert hist[-1]["step"] == 7
    assert FlakyDS.fails[0] == 2


def test_resumed_losses_equal_uninterrupted(tmp_path):
    """A run stopped at step 4 and resumed from its checkpoint gives the
    uninterrupted run's losses for steps 4-5 (the CPU's sums repeat)."""
    _, cfg = _yi()
    ds = SyntheticTokenDataset(cfg.vocab_size, 32, 2)
    kw = dict(cfg=cfg, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
              dataset=ds, device="cpu")
    _, _, whole, _ = Trainer(**kw).run(0, 6)
    Trainer(**kw, ckpt_dir=str(tmp_path), ckpt_every=4).run(0, 4)
    _, _, resumed, _ = Trainer(**kw, ckpt_dir=str(tmp_path), ckpt_every=4).run(0, 6)
    assert [h["step"] for h in resumed] == [4, 5]
    assert [h["loss"] for h in resumed] == [h["loss"] for h in whole[4:]]


def test_trainer_history_matches_reference():
    """The port's `Trainer` and the reference's from the same weights and
    data over 4 steps: the same steps, losses within rtol 1e-4."""
    rcfg, tcfg = _yi()
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=8)
    _, _, want, _ = RefTrainer(cfg=rcfg, mesh=_mesh(), opt_cfg=RefAdamW(**ocfg),
                               dataset=RefDataset(rcfg.vocab_size, 32, 2)).run(
        jax.random.PRNGKey(0), 4, params=ref_params(rcfg))
    _, _, got, _ = Trainer(cfg=tcfg, opt_cfg=AdamWConfig(**ocfg),
                           dataset=SyntheticTokenDataset(tcfg.vocab_size, 32, 2),
                           device="cpu").run(0, 4, params=port_model(rcfg, tcfg))
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in got], [h["loss"] for h in want], rtol=1e-4)
    assert got[-1]["loss"] < got[0]["loss"]


def _launch(module, *args, device_flag=True):
    cmd = [sys.executable, "-m", module, "--arch", "yi-6b", "--reduced", "--steps", "3", *args]
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env)


def test_launcher_prints_the_reference_keys():
    """`python -m repro_torch.launch.train --arch yi-6b --reduced --steps 3
    --device cpu` prints the reference launcher's JSON keys, with finite
    losses."""
    port = _launch("repro_torch.launch.train", "--device", "cpu")
    assert port.returncode == 0, port.stderr
    ref = _launch("repro.launch.train")
    assert ref.returncode == 0, ref.stderr
    got, want = json.loads(port.stdout), json.loads(ref.stdout)
    assert list(got) == list(want)
    assert got["arch"] == want["arch"] and got["steps"] == 3
    assert np.isfinite([got["first_loss"], got["last_loss"]]).all()


def test_launcher_refuses_cpu_fallback_and_meshes():
    """Without a GPU and without --device it raises, never trains on the
    CPU; a mesh one GPU does not have raises too."""
    from repro_torch.launch.train import main

    if not torch.cuda.is_available():
        out = _launch("repro_torch.launch.train")
        assert out.returncode != 0 and "device='cpu'" in out.stderr
    for flags in (["--production-mesh"], ["--multi-pod"], ["--data", "2"], ["--model", "4"]):
        with pytest.raises(ValueError):
            main(["--arch", "yi-6b", "--reduced", "--device", "cpu", *flags])
