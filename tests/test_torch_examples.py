"""The four example twins (`examples/*_torch.py`) run on the CPU at a
reduced size, their own asserts included.

Each twin's `main` takes `--device cpu` and a reduced corpus, model or
step count; the twins' asserts (windows == tiles bit for bit, the live
insert found and the delete gone, the loss falling) run inside `main`.
Here each run is also held to the reference's shapes of what it prints
(recall and imbalance finite, ten neighbours a query), and HOME points at
a temporary directory so no autotune cache outside it is read or written.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _one_thread import one_thread  # noqa: E402,F401

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _main(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _tensors_on(tree, device_type: str) -> int:
    """Count the tensors of `tree` and check each is on `device_type`."""
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == device_type
        return 1
    if isinstance(tree, (tuple, list)):
        return sum(_tensors_on(x, device_type) for x in tree)
    if isinstance(tree, dict):
        return sum(_tensors_on(x, device_type) for x in tree.values())
    return 0


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))


def test_quickstart_twin():
    out = _main("quickstart_torch")(["--device", "cpu", "--n", "4000", "--queries", "8"])
    assert out["ids"].shape == (8, 10) and 0.0 <= out["recall"] <= 1.0
    assert np.isfinite(out["imbalance"])
    assert out["device"].type == "cpu"


def test_multi_device_search_twin():
    out = _main("multi_device_search_torch")(["--device", "cpu", "--n", "4000",
                                              "--queries", "16"])
    assert len(out["pairs_per_device"]) == 8 and out["ids"].shape == (16, 10)
    assert 0 < out["rows_ratio"] <= 1.0 and np.isfinite(out["imbalance"])
    assert out["device"].type == "cpu"


def test_serve_rag_twin():
    out = _main("serve_rag_torch")(["--device", "cpu", "--n", "4000", "--steps", "6"])
    assert out["generated"].shape == (4, 6) and out["compiles"] == 0
    assert out["doc_ids"].shape == (4, 5) and out["insert_rank"] >= 0
    assert _tensors_on(out["tensors"], "cpu") > 0


def test_train_lm_twin(tmp_path):
    out = _main("train_lm_torch")([
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"), "--steps", "20",
        "--layers", "2", "--d-model", "64", "--vocab", "256", "--seq", "64", "--batch", "8",
        "--warmup", "2", "--ckpt-every", "10"])
    assert out["last_loss"] < out["first_loss"]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir() if p.name.startswith("step"))
    assert _tensors_on(out["tensors"], "cpu") > 0
