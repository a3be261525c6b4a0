"""The dry run on the meta device (`repro_torch.launch.dryrun`,
`dryrun_matrix`) against the reference's and against real CPU steps.

Retrieval: `retrieval_shapes` and the hardware-free terms of
`retrieval_roofline_analytic` (`bytes_codes_per_chip`,
`rows_valid_per_chip`, `window_read_factor`, the FLOPs as the reference's
`compute_s` x its peak) equal to the reference's on SIFT1B and SPACEV1B,
co-occurrence on and off, int32 codes, a `width`, 256 and 512 devices.
The reference's values come from a subprocess: importing
`repro.launch.dryrun` sets `XLA_FLAGS` to 512 host devices, which must not
reach this test process's jax.

LM: for a reduced config of each family (dense, MoE, MLA, Mamba2, the
hybrid, the vision stub, the audio stub) and each step kind, the meta
trace's FLOPs equal `FlopCounterMode`'s count of the same step run on the
CPU (exactly: the counts are integers of the same shapes), its
`argument_bytes` equal the bytes of the real CPU objects, and
`model_flops` equals the reference's formula on the reference's config.
One full-width cell of each kind (train_4k, prefill_32k with B10,
decode_32k, long_500k, on mamba2-130m / musicgen-medium) runs whole;
`cell_runnable` skips the reference's cells; `build_worklist` with the
pod meshes equals the reference's list.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from _one_thread import one_thread  # noqa: E402,F401
from repro.configs import cell_runnable as ref_cell_runnable  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced_config as ref_reduced  # noqa: E402
from repro.launch import dryrun_matrix as ref_matrix  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS,
    SHAPES,
    cell_runnable,
    get_config,
    reduced_config,
)
from repro_torch.configs.memanns import SIFT1B, SPACEV1B  # noqa: E402
from repro_torch.kernels import flash_attn  # noqa: E402
from repro_torch.launch import dryrun, dryrun_matrix  # noqa: E402
from repro_torch.models import decode_step, init_decode_cache, init_params, prefill  # noqa: E402
from repro_torch.models.sharding import MESHES, fit_spec, param_specs, per_chip_bytes  # noqa: E402
from repro_torch.optim import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.training import make_train_step, trainable  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"
CASES = [(ds, cooc, compact, width, ndev)
         for ds in ("sift1b", "spacev1b") for cooc in (False, True)
         for compact in (True, False) for width in (None, 24) for ndev in (256, 512)]

REF_RETRIEVAL = """
import json
from repro.launch import dryrun as d
from repro.configs.memanns import SIFT1B, SPACEV1B
out = []
for ds, cooc, compact, width, ndev in CASES:
    rc = {"sift1b": SIFT1B, "spacev1b": SPACEV1B}[ds]
    s = d.retrieval_shapes(rc, ndev, cooc, width=width, compact_dtype=compact)
    runs = [d.retrieval_roofline_analytic(rc, s, cooc, entry_bytes=s["entry_bytes"]),
            d.retrieval_roofline_analytic(rc, s, cooc, entry_bytes=2, avg_width=12.5,
                                          window_read_factor=1.0)]
    out.append({"shapes": s, "analytic": [r["analytic"] for r in runs],
                "flops": [r["analytic"]["compute_s"] * d.PEAK_FLOPS for r in runs]})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_retrieval():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", f"CASES = {CASES!r}\n" + REF_RETRIEVAL],
                         capture_output=True, text=True, timeout=300, env=env, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_retrieval_closed_form_equals_reference(ref_retrieval):
    for (ds, cooc, compact, width, ndev), want in zip(CASES, ref_retrieval):
        rc = {"sift1b": SIFT1B, "spacev1b": SPACEV1B}[ds]
        s = dryrun.retrieval_shapes(rc, ndev, cooc, width=width, compact_dtype=compact)
        assert s == want["shapes"], (ds, cooc, compact, width, ndev)
        runs = [dryrun.retrieval_roofline_analytic(rc, s, cooc, entry_bytes=s["entry_bytes"]),
                dryrun.retrieval_roofline_analytic(rc, s, cooc, entry_bytes=2, avg_width=12.5,
                                                   window_read_factor=1.0)]
        for got, ref_a, ref_flops in zip(runs, want["analytic"], want["flops"]):
            a = got["analytic"]
            for key in ("bytes_codes_per_chip", "rows_valid_per_chip", "window_read_factor",
                        "entry_bytes", "avg_width"):
                assert a[key] == ref_a[key], key
            assert a["flops_per_chip"] == pytest.approx(ref_flops, rel=1e-12)


def test_retrieval_card_cell_sums_the_logical_devices():
    cell = dryrun.run_retrieval("sift1b", "card", use_cooc=True, device_kind=H100)
    assert cell["status"] == "ok" and cell["peaks_source"] == "table:H100"
    s = dryrun.retrieval_shapes(SIFT1B, 8, True)
    a = dryrun.retrieval_roofline_analytic(SIFT1B, s, True, entry_bytes=2,
                                           peaks=(989e12, 3.35e12))["analytic"]
    assert cell["compute_s"] == pytest.approx(8 * a["compute_s"], rel=1e-12)
    assert cell["memory_s"] == pytest.approx(8 * a["memory_s"], rel=1e-12)
    assert cell["collective_s"] == 0.0
    ops_bytes = sum(int(np.prod(shape)) * dt.itemsize
                    for _, shape, dt in dryrun.retrieval_operands(s))
    assert len(dryrun.retrieval_operands(s)) == 13
    assert cell["memory"]["argument_bytes"] == ops_bytes
    assert cell["fits"] == (ops_bytes <= dryrun.CARD_BYTES)


FAMILIES = ["qwen3-8b", "phi3.5-moe-42b", "deepseek-v2-236b", "mamba2-130m", "zamba2-7b",
            "llava-next-34b", "musicgen-medium"]
SHAPE = {"train": (64, 2, "train"), "prefill": (64, 2, "prefill"), "decode": (64, 2, "decode")}


def _cpu_step(cfg, seq, batch, kind):
    """The same step as `dryrun.lm_step`'s on the CPU with real tensors:
    (the step, its argument tensors)."""
    rng = np.random.default_rng(0)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    if kind == "decode":
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, 1)), dtype=torch.int32)
        cache = init_decode_cache(cfg, batch, seq, device="cpu")
        args = [*model.parameters(), tok, *cache.values()]
        return (lambda: decode_step(model, cfg, tok, cache, seq - 1)), args
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq - n_front)),
                          dtype=torch.int32)
    emb = (torch.as_tensor(rng.normal(0, 0.02, (batch, n_front, cfg.d_model))).bfloat16()
           if n_front else None)
    extra = [emb] if n_front else []
    if kind == "train":
        trainable(model)
        opt = init_opt_state(model)
        step = make_train_step(cfg, AdamWConfig())
        args = [*model.parameters(), *opt["mu"].values(), *opt["nu"].values(), opt["step"],
                tok, *extra]
        return (lambda: step(model, opt, tok, emb)), args
    args = [*model.parameters(), tok, *extra]
    return (lambda: prefill(model, cfg, tok, max_len=seq, embeddings=emb)), args


@pytest.mark.parametrize("kind", list(SHAPE))
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_trace_equals_cpu_step(arch, kind):
    cfg = reduced_config(get_config(arch), remat=kind == "train", dtype="bfloat16")
    seq, batch, _ = SHAPE[kind]
    cell = dryrun.lm_cell(cfg, SHAPE[kind], "card", device_kind=H100)
    fn, args = _cpu_step(cfg, seq, batch, kind)
    with FlopCounterMode(display=False) as fc:
        fn()
    assert cell["flops"] == fc.get_total_flops() > 0
    assert cell["memory"]["argument_bytes"] == sum(t.numel() * t.element_size() for t in args)
    rcfg = ref_reduced(ref_get_config(arch), remat=kind == "train", dtype="bfloat16")
    tokens = batch * seq if kind != "decode" else batch
    assert cell["model_flops"] == (6 if kind == "train" else 2) * rcfg.n_active_params() * tokens
    assert cell["useful_ratio"] == cell["model_flops"] / cell["flops"]
    assert cell["memory"]["temp_bytes"] > 0
    assert cell["peaks_source"] == "table:H100" and cell["collective_s"] == 0.0
    assert cell["fits"] and cell["predicted_peak_bytes"] == (
        cell["memory"]["argument_bytes"] + cell["memory"]["temp_bytes"])


def test_pod_mesh_reports_per_chip_arguments():
    cfg = reduced_config(get_config("qwen3-8b"), d_model=256, n_heads=16, n_kv_heads=16)
    cell = dryrun.lm_cell(cfg, (64, 32, "train"), "pod", device_kind=H100)
    _, args = dryrun.lm_step(cfg, 64, 32, "train")
    model, opt = args["params"], args["opt_state"]
    mesh = MESHES["pod"]
    specs = param_specs(model, mesh)
    # each parameter in its dtype and its two f32 moments, the int32 step,
    # the tokens split over 'data'
    want = sum(per_chip_bytes(tuple(p.shape), p.dtype, specs[n], mesh)
               + 2 * per_chip_bytes(tuple(p.shape), torch.float32, specs[n], mesh)
               for n, p in model.named_parameters())
    want += 4 + per_chip_bytes((32, 64), torch.int32, fit_spec(("data", None), (32, 64), mesh),
                               mesh)
    assert cell["memory"]["argument_bytes"] == want
    assert cell["memory"]["argument_bytes"] < cell["memory"]["global_argument_bytes"]
    assert cell["collectives"] is None and cell["collective_s"] is None and "notes" in cell
    assert cell["n_chips"] == 256 and cell["flops_per_chip"] == cell["flops"] / 256
    assert cell["model_flops_per_chip"] == cell["model_flops"] / 256
    assert set(opt) == {"mu", "nu", "step"}


@pytest.mark.parametrize("arch,shape,flash", [
    ("mamba2-130m", "train_4k", False), ("musicgen-medium", "prefill_32k", True),
    ("mamba2-130m", "decode_32k", False), ("mamba2-130m", "long_500k", False),
])
def test_full_width_cells(arch, shape, flash):
    overrides = {"use_flash_kernel": True} if flash else None
    cell = dryrun.run_cell(arch, shape, "card", overrides=overrides, device_kind=H100)
    assert cell["status"] == "ok", cell["status"]
    cfg = get_config(arch)
    seq, batch, kind = SHAPES[shape]
    assert cell["model_flops"] == dryrun.model_flops(cfg, seq, batch, kind)
    assert 0 < cell["useful_ratio"] and cell["flops"] > 0 and cell["bytes"] > 0
    assert cell["peak_flops"] == 989e12 and cell["hbm_bw"] == 3.35e12
    assert cell["dominant"] in ("compute_s", "memory_s")
    if flash:
        work = cell["kernels"]["flash_attention_fwd"]
        assert work["calls"] == cfg.n_layers
        assert work["flops"] == cfg.n_layers * flash_attn.flash_flops(
            batch, seq, cfg.n_heads, cfg.hd, 0, seq)
        assert work["bytes"] == cfg.n_layers * flash_attn.flash_hbm_bytes_per_layer(
            batch, seq, seq, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    if kind == "decode":  # mamba2-130m's weights and state fit the card whole
        assert cell["fits"] and cell["arguments_fit"]


def test_cell_runnable_equals_reference():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert cell_runnable(get_config(arch), shape) == ref_cell_runnable(
                ref_get_config(arch), shape)
    cell = dryrun.run_cell("yi-6b", "long_500k", "card", device_kind=H100)
    assert cell["status"].startswith("skip") and "flops" not in cell


def test_worklist_equals_reference():
    assert dryrun_matrix.build_worklist(("pod", "multipod")) == ref_matrix.build_worklist(True)
    assert dryrun_matrix.build_worklist(("pod",)) == ref_matrix.build_worklist(False)
    card = dryrun_matrix.build_worklist()
    assert len(card) == len(ARCH_IDS) * len(SHAPES) + 4
    assert all(("--flash" in j) == ("prefill_32k" in j) for j in card)
    assert sorted(map(tuple, dryrun_matrix.longest_first(card))) == sorted(map(tuple, card))
    assert dryrun_matrix.job_name(card[0]) == "arch_phi3.5-moe-42b_shape_train_4k_mesh_card"


def test_matrix_runner_writes_each_cell(tmp_path):
    work = [["--retrieval", "sift1b", "--mesh", "card"],
            ["--retrieval", "spacev1b", "--mesh", "pod", "--cooc"]]
    res = dryrun_matrix.run(work, str(tmp_path), jobs=2, timeout=300, device_kind=H100,
                            log=lambda *_: None)
    assert res == {"ok": 2, "fail": 0, "failed": []}
    for job in work:
        cell = json.loads((tmp_path / dryrun_matrix.cell_file(job)).read_text())
        assert cell["status"] == "ok" and cell["peaks_source"] == "table:H100"


def test_cli_retrieval_flags(tmp_path, capsys):
    """The reference's retrieval flags reach the closed form: int32 codes,
    a width, the window read factor, the average width and the tag."""
    argv = ["--retrieval", "sift1b", "--int32", "--width", "8", "--wrf", "1.0",
            "--avg-width", "12.5", "--tag=-x", "--out", str(tmp_path), "--device-kind", H100]
    assert dryrun.main(argv) == 0
    cell = json.loads((tmp_path / "memanns-sift1b-x__card.json").read_text())
    assert cell["status"] == "ok" and cell["layout"]["width"] == 8
    a = cell["analytic"]
    assert (a["entry_bytes"], a["window_read_factor"], a["avg_width"]) == (4, 1.0, 12.5)
    same = dryrun.run_retrieval("sift1b", "card", False, window_read_factor=1.0, avg_width=12.5,
                                compact_dtype=False, width=8, device_kind=H100)
    assert a == same["analytic"] and cell["bound_s"] == same["bound_s"]
    assert json.loads(capsys.readouterr().out)["arch"] == "memanns-sift1b-x"


def test_cli_lm_flags(tmp_path):
    """`--no-remat`, `--opt-decode`, `--attn-chunk` and `--tag` become the
    cell's config overrides and name; without remat the train step does no
    recompute, so it counts fewer FLOPs."""
    base = ["--arch", "mamba2-130m", "--shape", "train_4k", "--device-kind", H100]
    assert dryrun.main(base + ["--out", str(tmp_path / "a")]) == 0
    assert dryrun.main(base + ["--no-remat", "--opt-decode", "--attn-chunk", "256",
                               "--tag=-t", "--out", str(tmp_path / "b")]) == 0
    a = json.loads((tmp_path / "a" / "mamba2-130m__train_4k__card.json").read_text())
    b = json.loads((tmp_path / "b" / "mamba2-130m__train_4k__card.json").read_text())
    assert a["status"] == b["status"] == "ok" and b["arch"] == "mamba2-130m-t"
    assert b["overrides"] == {"opt_decode": "True", "attn_chunk": "256", "remat": "False"}
    assert b["flops"] < a["flops"] and b["model_flops"] == a["model_flops"]


@pytest.mark.parametrize("flag", [["--path", "onehot"], ["--grad-compress"]])
def test_cli_refuses_flags_without_effect(flag):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--retrieval", "sift1b", "--device-kind", H100] + flag)
    assert e.value.code == 2
