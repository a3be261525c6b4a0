"""The port's serving launcher (`repro_torch.launch.serve`) on the CPU.

`serve()` drives prefill, the greedy decode loop and, with `--retrieval`,
the port's engine, on a reduced config with `device="cpu"`; the flags of
the reference's `ServingEngine` path are refused until they are ported;
with no device and no GPU it raises instead of running on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

KEYS = {"arch", "batch", "prefill_s", "decode_tok_per_s", "generated"}


def _cfg(**kw):
    return reduced_config(get_config("qwen3-8b"), n_kv_heads=2, **kw)


@pytest.mark.parametrize("flash", [False, True])
def test_serve_cpu(flash):
    cfg = _cfg(use_flash_kernel=flash)
    ops.reset_launches()
    rep = tserve.serve(cfg, batch=3, prompt_len=32, steps=6, device="cpu")
    assert KEYS <= set(rep) and rep["arch"] == "qwen3-8b" and rep["batch"] == 3
    gen = np.asarray(rep["generated"])
    assert gen.shape == (3, 6) and (gen >= 0).all() and (gen < cfg.vocab_size).all()
    assert rep["prefill_s"] > 0 and rep["decode_tok_per_s"] > 0
    # CPU tensors run the plain versions: no kernel launch is counted
    assert rep["kernel_launches"] == {"prefill": {}, "decode": {}}
    assert not any(ops.launches.values())


def test_serve_flash_on_off_same_tokens():
    """f32 weights from one seed: the flash route (B10's plain version) and
    the chunked scan generate the same greedy tokens."""
    on = tserve.serve(_cfg(use_flash_kernel=True), batch=2, prompt_len=64, steps=8,
                      device="cpu", seed=3)
    off = tserve.serve(_cfg(), batch=2, prompt_len=64, steps=8, device="cpu", seed=3)
    assert on["generated"] == off["generated"]


@pytest.mark.parametrize("rerank", ["off", "exact"])
def test_serve_cpu_with_retrieval(rerank):
    opts = tserve.RetrievalOptions(vectors=2000, rerank=rerank)
    rep = tserve.serve(_cfg(), batch=2, prompt_len=16, steps=2, retrieval=opts, device="cpu")
    ids = np.asarray(rep["retrieved_ids"])
    assert ids.shape == (2, 4) and (ids >= 0).all() and (ids < 2000).all()
    st = rep["retrieval_stats"]
    assert st["cooc"] is True and st["nprobe"] == 8 and st["k"] == 10
    assert ("rerank" in st) == (rerank == "exact")


def test_main_cpu_prints_report(capsys):
    rep = tserve.main(["--arch", "yi-6b", "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "16", "--steps", "3", "--flash", "--opt-decode"])
    out = json.loads(capsys.readouterr().out)
    assert out["generated"] == rep["generated"] and out["arch"] == "yi-6b"


@pytest.mark.parametrize("flag", [
    ["--queue-limit", "4"], ["--churn-insert-rate", "8"], ["--autotune", "off"],
    ["--deadline-ms", "5"], ["--metrics-port", "0"], ["--trace-out", "t.json"],
])
def test_unported_flags_refused(flag):
    """The reference's `ServingEngine` flags that wait for queue A items 7,
    12 and 13 (`--pipeline-depth` is ported, `test_retrieval_serves_through_
    serving_engine`)."""
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu", *flag])


@pytest.mark.parametrize("depth", [0, 1])
def test_retrieval_serves_through_serving_engine(depth, capsys):
    """`--retrieval` serves through a warmed ServingEngine, half the
    request batch a micro-batch, at `--pipeline-depth`; its answers equal
    the engine's own search on the same queries."""
    cfg = _cfg()
    opts = tserve.RetrievalOptions(vectors=2000, pipeline_depth=depth)
    rep = tserve.serve(cfg, batch=4, prompt_len=8, steps=2, retrieval=opts, device="cpu")
    st = rep["retrieval_stats"]
    assert st["pipeline_depth"] == depth and st["micro_batch"] == 2 and st["batches"] == 2
    assert st["compiles"] == 0 and st["health"]["state"] == "ok"
    assert st["autotune"]["source"] == "miss"
    eng, rcfg, qv = tserve.retrieval_engine(cfg, opts, 4, torch.device("cpu"), 0)
    _, ids = eng.search(qv, rcfg.nprobe, rcfg.k)
    np.testing.assert_array_equal(np.asarray(rep["retrieved_ids"]), ids[:, :4])
    out = tserve.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--steps", "2", "--retrieval",
                       "--retrieval-vectors", "2000", "--pipeline-depth", str(depth)])
    assert out["retrieval_stats"]["pipeline_depth"] == depth
    capsys.readouterr()


def test_k_overfetch_needs_rerank():
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                     "--k-overfetch", "64"])


def test_serve_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda is a valid default here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(_cfg(), batch=1, prompt_len=8, steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", "qwen3-8b", "--reduced"])


def test_serve_refuses_other_families():
    cfg = reduced_config(get_config("mamba2-130m"))
    with pytest.raises(NotImplementedError, match="queue A item 14"):
        tserve.serve(cfg, batch=1, prompt_len=8, steps=2, device="cpu")
    cfg = dataclasses.replace(_cfg(), family="moe", n_experts=4)
    with pytest.raises(NotImplementedError, match="queue A item 14"):
        tserve.serve(cfg, batch=1, prompt_len=8, steps=2, device="cpu")
