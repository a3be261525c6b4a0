"""The port's serving launcher (`repro_torch.launch.serve`) on the CPU.

`serve()` drives prefill, the greedy decode loop and, with `--retrieval`,
the port's engine through its `ServingEngine`, on a reduced config of
every family with `device="cpu"`; the reference's serving flags (churn, deadlines,
admission, the watchdog, metrics and traces) each do what they do there,
and only `--autotune sweep` is refused; with no device and no GPU it
raises instead of running on the CPU.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _one_thread import one_thread  # noqa: E402,F401
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


BASE = ["--arch", "qwen3-8b", "--reduced", "--device", "cpu", "--batch", "4",
        "--prompt-len", "8", "--steps", "2", "--retrieval", "--retrieval-vectors", "2000"]


@pytest.mark.parametrize("flag", [
    ["--queue-limit", "4"], ["--churn-insert-rate", "8"], ["--autotune", "sweep"],
    ["--deadline-ms", "0"], ["--metrics-port", "0"], ["--trace-out", "t.json"],
])
def test_unported_flags_refused(flag, tmp_path, capsys, monkeypatch):
    """The reference's `ServingEngine` flags are taken and do what they do
    there, `--autotune sweep` (queue A item 13) too: it sweeps on the cache
    miss, persists the winner under ~/.cache/repro_torch (HOME is a temp
    dir here) and reports the reference's `autotune` keys.  Without
    `--retrieval` the metrics and trace flags are refused, as there."""
    if flag[0] == "--autotune":
        monkeypatch.setenv("HOME", str(tmp_path))
        at = tserve.main(BASE + flag)["retrieval_stats"]["autotune"]
        capsys.readouterr()
        assert set(at) == {"mode", "source", "swept", "retiled", "geometry"}
        assert at["mode"] == "sweep" and at["source"] == "sweep" and at["swept"] > 0
        assert (tmp_path / ".cache" / "repro_torch" / "autotune-cpu-v1.json").exists()
        return
    if flag[0] == "--trace-out":
        flag = [flag[0], str(tmp_path / flag[1])]
    if flag[0] in ("--metrics-port", "--trace-out"):
        with pytest.raises(SystemExit):
            tserve.main(BASE[:-3] + flag)
    rep = tserve.main(BASE + flag)
    capsys.readouterr()
    st = rep["retrieval_stats"]
    assert st["compiles"] == 0 and np.asarray(rep["retrieved_ids"]).shape == (4, 4)
    if flag[0] == "--queue-limit":  # search() bypasses the ingress queue
        assert st["health"]["queue_limit"] == 4 and st["faults"]["rejected_queries"] == 0
    elif flag[0] == "--churn-insert-rate":
        mut = st["mutation"]
        assert mut["inserts"] == 32 and mut["deletes"] == 0 and mut["compactions"] == 0
        assert st["batches"] == 10 and st["phase_seconds"]["delta"] > 0
    elif flag[0] == "--deadline-ms":
        assert st["faults"]["degraded_queries"] == 4 and st["health"]["state"] == "degraded"
    elif flag[0] == "--metrics-port":
        assert rep["metrics_endpoint"].startswith("http://127.0.0.1:")
    else:
        trace = json.loads((tmp_path / "t.json").read_text())
        assert rep["trace_out"]["spans"] == 2
        names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
        assert {"batch", "plan", "schedule", "dispatch", "collect"} <= names


def test_churn_serve_matches_engine(capsys):
    """`--churn-insert-rate` / `--churn-delete-rate` serve a mutable engine
    through four churn rounds; the timed search equals the engine's own
    search on the churned corpus, and an auto-compaction lands at
    `--compact-occupancy`."""
    opts = tserve.RetrievalOptions(vectors=2000, churn_insert_rate=48, churn_delete_rate=8,
                                   compact_occupancy=0.02)
    cfg = _cfg()
    rep = tserve.serve(cfg, batch=4, prompt_len=8, steps=2, retrieval=opts, device="cpu")
    mut = rep["retrieval_stats"]["mutation"]
    assert mut["inserts"] == 192 and mut["deletes"] == 32 and mut["compactions"] == 2
    assert rep["retrieval_stats"]["compiles"] == 0
    launches = rep["retrieval_stats"]["kernel_launches"]
    assert launches == {}  # CPU tensors: the plain versions run, no launch


def test_metrics_endpoint_serves_while_lingering():
    """`--metrics-port` exposes the serving registry on 127.0.0.1 while the
    launcher lingers: `/metrics` passes the port's exposition check and
    counts the served queries, `/healthz` returns the health dict."""
    import importlib.util
    import socket
    import threading
    import time
    import urllib.request
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "check_metrics_torch",
        Path(__file__).resolve().parent.parent / "tools" / "check_metrics_torch.py")
    check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    opts = tserve.RetrievalOptions(vectors=2000, metrics_port=port, metrics_linger=5.0)
    box = {}
    th = threading.Thread(target=lambda: box.update(tserve.serve(
        _cfg(), batch=4, prompt_len=8, steps=2, retrieval=opts, device="cpu")))
    th.start()
    text, health = "", None
    t_end = time.time() + 120
    while th.is_alive() and time.time() < t_end:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                text = r.read().decode()
            if "upanns_serving_queries_total 4" in text:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    health = json.loads(r.read().decode())
                break
        except OSError:
            pass
        time.sleep(0.2)
    th.join(timeout=120)
    assert not th.is_alive()
    assert "upanns_serving_queries_total 4" in text
    assert check.check_exposition(text) == []
    assert health["state"] == "ok" and health["n_devices"] == 1
    assert box["metrics_endpoint"] == f"http://127.0.0.1:{port}/metrics"


@pytest.mark.parametrize("depth", [0, 1])
def test_retrieval_serves_through_serving_engine(depth, capsys, tmp_path, monkeypatch):
    """`--retrieval` serves through a warmed ServingEngine, half the
    request batch a micro-batch, at `--pipeline-depth`; its answers equal
    the engine's own search on the same queries.  HOME is empty, so the
    "cache" autotune finds no user cache and applies the CPU default."""
    monkeypatch.setenv("HOME", str(tmp_path))
    cfg = _cfg()
    opts = tserve.RetrievalOptions(vectors=2000, pipeline_depth=depth)
    rep = tserve.serve(cfg, batch=4, prompt_len=8, steps=2, retrieval=opts, device="cpu")
    st = rep["retrieval_stats"]
    assert st["pipeline_depth"] == depth and st["micro_batch"] == 2 and st["batches"] == 2
    assert st["compiles"] == 0 and st["health"]["state"] == "ok"
    assert st["autotune"]["source"] == "defaults" and not st["autotune"]["retiled"]
    eng, rcfg, qv, _ = tserve.retrieval_engine(cfg, opts, 4, torch.device("cpu"), 0)
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


FAMILIES = ["phi3.5-moe-42b", "deepseek-v2-236b", "zamba2-7b", "mamba2-130m",
            "llava-next-34b", "musicgen-medium"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_every_family(arch):
    """Each family's reduced config serves on the CPU (flash on, so the
    GQA blocks take B10's plain version): the first generated token is the
    prefill's greedy pick on the same prompt, drawn as `serve` draws it --
    weights, then tokens, then for the vision stub its f32 embeddings
    (prompt_len - n_frontend_tokens tokens after n_frontend_tokens
    embedding positions)."""
    from repro_torch.models import init_params, prefill

    cfg = reduced_config(get_config(arch), use_flash_kernel=True)
    ops.reset_launches()
    rep = tserve.serve(cfg, batch=2, prompt_len=24, steps=3, device="cpu", seed=5)
    gen = np.asarray(rep["generated"])
    assert gen.shape == (2, 3) and (gen >= 0).all() and (gen < cfg.vocab_size).all()
    assert rep["kernel_launches"] == {"prefill": {}, "decode": {}}
    g = torch.Generator().manual_seed(5)
    model = init_params(cfg, g, "cpu")
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    tok = torch.randint(0, cfg.vocab_size, (2, 24 - n_front), generator=g)
    emb = torch.randn(2, n_front, cfg.d_model, generator=g) if n_front else None
    logits, _ = prefill(model, cfg, tok, max_len=27, embeddings=emb, cache_dtype=torch.float32)
    np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(), gen[:, 0])
