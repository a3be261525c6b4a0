"""The launch environment, the roofline report and B10's work model against
the reference's.

`repro_torch.launch.roofline_report` against `repro.launch.roofline_report`
(which imports no jax at module level) on the same synthetic cells:
`peaks_for`, `fraction`, `advice`, `markdown_table` and `pick_hillclimb`
equal (exact: the same arithmetic on the same floats); the CLI on a
directory of cells.  `launch.env`: `setup_env` never clobbers, and
`describe_env` on the CPU.  `kernels.flash_attn.flash_hbm_bytes_per_layer`
equal to the reference's at its arguments, and B10's meta-device branch:
an empty output of the kernel's shape, its closed-form FLOPs equal to the
brute-force count of live causal pairs.
"""

import itertools
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _one_thread import one_thread  # noqa: E402,F401
from repro.kernels import flash_attn as ref_flash  # noqa: E402
from repro.launch import roofline_report as ref  # noqa: E402
from repro_torch.kernels import flash_attn as port_flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import env  # noqa: E402
from repro_torch.launch import roofline_report as port  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _cells():
    """LM and retrieval cells of every status, on the pod meshes, with each
    dominant term and useful ratios on both sides of 0.2."""
    cells = []
    for i, (dom, ur) in enumerate(itertools.product(
            ("compute_s", "memory_s", "collective_s"), (0.05, 0.5, None))):
        c = {"arch": f"arch{i}", "shape": "train_4k", "mesh": "pod16x16", "status": "ok",
             "compute_s": 0.1 * (i + 1), "memory_s": 0.2, "collective_s": 1e-4 * i,
             "dominant": dom, "bound_s": 0.3 + 0.01 * i,
             "model_flops_per_chip": 1.5e13 * (i + 1)}
        if ur is not None:
            c["useful_ratio"] = ur
        cells.append(c)
    cells.append({"arch": "memanns-sift1b", "shape": "q1000_nprobe64", "mesh": "dpu256",
                  "status": "ok", "compute_s": 1e-6, "memory_s": 2e-4, "collective_s": 3e-6,
                  "dominant": "memory_s", "bound_s": 2e-4, "useful_code_bytes_per_chip": 4e7})
    cells.append({"arch": "memanns-sift1b-cooc", "shape": "q", "mesh": "dpu512",
                  "status": "ok", "dominant": "memory_s", "bound_s": 0.0})
    cells.append({"arch": "yi-6b", "shape": "long_500k", "mesh": "pod2x16x16",
                  "status": "skip: pure full-attention arch at 524k context"})
    cells.append({"arch": "x", "shape": "prefill_32k", "mesh": "pod16x16",
                  "status": "FAIL: RuntimeError: " + "e" * 100})
    cells.append({"arch": "y", "shape": "decode_32k", "mesh": "pod2x16x16", "status": "ok",
                  "compute_s": 0.0, "memory_s": 1.0, "collective_s": 2.0,
                  "dominant": "collective_s", "bound_s": 2.0,
                  "model_flops_per_chip": 0.0, "useful_ratio": 0.0})
    return cells


@pytest.mark.parametrize("kind,flops,bw", [
    (None, None, None), ("NVIDIA H100 80GB HBM3", None, None), ("TPU v5 lite", None, None),
    ("TPU v5p", None, None), ("NVIDIA A100-SXM4-80GB", None, None), ("cpu", None, None),
    ("NVIDIA H100 80GB HBM3", 5e14, None), (None, None, 1e12), ("TPU v6e", 1e15, 2e12),
])
def test_peaks_for_equals_reference(kind, flops, bw):
    assert port.peaks_for(kind, flops, bw) == ref.peaks_for(kind, flops, bw)
    assert port.PEAKS == ref.PEAKS and port.DEFAULT_PEAKS == ref.DEFAULT_PEAKS


def test_h100_resolves_to_its_table_row():
    flops, bw, source = port.peaks_for("NVIDIA H100 80GB HBM3")
    assert (flops, bw, source) == (989e12, 3.35e12, "table:H100")


@pytest.mark.parametrize("peaks", [ref.DEFAULT_PEAKS, ref.PEAKS["H100"]])
def test_report_functions_equal_reference(peaks):
    cells = _cells()
    for c in cells:
        assert port.fraction(c, peaks) == ref.fraction(c, peaks)
        assert port.advice(c) == ref.advice(c)
    assert port.markdown_table(cells, peaks) == ref.markdown_table(cells, peaks)
    assert port.pick_hillclimb(cells, peaks) == ref.pick_hillclimb(cells, peaks)
    for x in (None, 0.0, 1e-5, 0.5, 3.0, 2e6, 7, "s"):
        assert port.fmt(x) == ref.fmt(x)


def test_hillclimb_on_card_cells():
    """The card mesh's cells rank under the card's names."""
    cells = [dict(c, mesh="card") for c in _cells()]
    got = port.pick_hillclimb(cells, ref.PEAKS["H100"], mesh_prefix="card", paper_mesh="card")
    assert got["worst_fraction"] is not None
    assert got["paper_representative"] == ("memanns-sift1b", "q1000_nprobe64", "card")
    assert port._meshes_of(cells) == {"mesh_prefix": "card", "paper_mesh": "card"}


def test_cli_reads_a_cells_directory(tmp_path):
    for i, c in enumerate(_cells()):
        (tmp_path / f"c{i:02d}.json").write_text(json.dumps(c))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline_report", "--in", str(tmp_path),
         "--device-kind", "NVIDIA H100 80GB HBM3", "--out", str(tmp_path / "t.md")],
        capture_output=True, text=True, timeout=120, check=True,
        env={"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin:/bin")},
    ).stdout
    assert '"peaks_source": "table:H100"' in out
    table = ref.markdown_table(_cells(), ref.PEAKS["H100"])
    assert (tmp_path / "t.md").read_text() == table


def test_setup_env_never_clobbers(monkeypatch):
    monkeypatch.setenv("CUDA_MODULE_LOADING", "EAGER")
    monkeypatch.delenv("CUDA_DEVICE_ORDER", raising=False)
    applied = env.setup_env()
    assert applied == {"CUDA_DEVICE_ORDER": "PCI_BUS_ID"}
    assert os.environ["CUDA_MODULE_LOADING"] == "EAGER"
    assert os.environ["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
    assert env.setup_env() == {}  # a second call applies nothing
    monkeypatch.delenv("CUDA_MODULE_LOADING")
    assert env.setup_env() == {"CUDA_MODULE_LOADING": "LAZY"}


def test_describe_env_on_the_cpu():
    d = env.describe_env("cpu")
    assert d["backend"] == "cpu" and d["device_kind"] == "cpu" and d["n_devices"] == 1
    assert d["power_limit"] is None and d["nvidia_smi"] is None
    assert d["torch"] == torch.__version__ and d["cuda"] == torch.version.cuda
    assert set(d["env"]) == set(env.ENV_DEFAULTS)
    if not torch.cuda.is_available():
        assert env.describe_env()["backend"] == "cpu"
    assert port.peaks_for(d["device_kind"])[2] == "default"


@pytest.mark.parametrize("b,sq,sk,h,kvh,hd,bq,dtype_bytes", [
    (4, 2048, 2560, 32, 8, 128, 512, 2), (1, 32768, 32768, 64, 8, 128, 512, 2),
    (2, 512, 512, 4, 4, 16, 512, 4), (3, 100, 100, 6, 2, 64, 512, 2),
    (1, 1024, 4096, 8, 1, 112, 256, 4),
])
def test_flash_hbm_bytes_equal_reference(b, sq, sk, h, kvh, hd, bq, dtype_bytes):
    args = (b, sq, sk, h, kvh, hd, bq, dtype_bytes)
    assert port_flash.flash_hbm_bytes_per_layer(*args) == ref_flash.flash_hbm_bytes_per_layer(*args)


@pytest.mark.parametrize("sq,q_offset,kv_valid", [
    (512, 0, 512), (512, 0, 1024), (1024, 512, 1536), (8, 0, 4), (16, 20, 30), (4, 9, 3),
])
def test_flash_meta_branch_counts_the_kernels_work(sq, q_offset, kv_valid):
    b, h, kvh, hd = 2, 4, 2, 16
    sk = max(kv_valid, q_offset + sq)
    sk = -(-sk // min(512, sk)) * min(512, sk)
    q = torch.empty((b, sq, h, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((b, sk, kvh, hd), dtype=torch.float32, device="meta")
    ops.reset_meta_work()
    ops.reset_launches()
    out = ops.flash_attention_fwd(q, k, k, scale=0.25, q_offset=q_offset, kv_valid=kv_valid,
                                  bq=min(512, sq), bk=min(512, sk))
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    pairs = sum(min(q_offset + i + 1, kv_valid) for i in range(sq))
    w = ops.meta_work["flash_attention_fwd"]
    assert w["calls"] == 1 and w["flops"] == 4 * b * h * hd * pairs
    assert w["bytes"] == port_flash.flash_hbm_bytes_per_layer(
        b, sq, sk, h, kvh, hd, min(512, sq), 2, 4)
    assert ops.launches["flash_attention_fwd"] == 0
