"""The port stands alone: no JAX, no reference package, no silent CPU.

A fresh interpreter imports every module of `repro_torch` (the LM's
configs, models and launcher too) and must end with no `jax*` and no
`repro` / `repro.*` entry in `sys.modules`.  Without a GPU, entry points
called without `device=` raise instead of falling back to the CPU.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
new = ["repro_torch.core.cooc", "repro_torch.retrieval.layout", "repro_torch.kernels.ops",
       "repro_torch.kernels.adc_scan", "repro_torch.kernels.adc_topk",
       "repro_torch.kernels.flash_attn", "repro_torch.models.config",
       "repro_torch.models.layers", "repro_torch.models.model", "repro_torch.configs",
       "repro_torch.configs.qwen3_8b", "repro_torch.configs.memanns",
       "repro_torch.launch.serve", "repro_torch.core.delta", "repro_torch.retrieval.mutation",
       "repro_torch.retrieval.serving", "repro_torch.retrieval.faults", "repro_torch.obs.metrics",
       "repro_torch.obs.trace", "repro_torch.obs.http", "repro_torch.core.autotune",
       "repro_torch.checkpoint", "repro_torch.checkpoint.store"]
assert all(n in names for n in new), names
print(len(names), ",".join(bad))
"""


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, check=True,
    ).stdout.strip()
    n_modules, bad = out.split(" ", 1) if " " in out else (out, "")
    assert int(n_modules) >= 47
    assert bad == "", f"repro_torch pulled in: {bad}"


def test_entry_points_refuse_cpu_fallback(clustered_data):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda is a valid default here")
    from repro_torch.core.placement import place_clusters
    from repro_torch.convert import index_from_arrays
    from repro_torch.device import resolve_device
    from repro_torch.retrieval.engine import MemANNSEngine

    xs = clustered_data[0]
    sizes = np.array([6000, 6000], np.int64)
    index = index_from_arrays(
        np.zeros((2, 32), np.float32), np.zeros((8, 256, 4), np.float32),
        np.zeros((12000, 8), np.uint8), np.arange(12000, dtype=np.int32),
        np.array([0, 6000, 12000]),
    )
    placement = place_clusters(sizes, np.ones(2), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MemANNSEngine.from_reference(index, placement)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MemANNSEngine.build(xs, 4, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    # and with device="cpu" it works
    MemANNSEngine.from_reference(index, placement, device="cpu")


def test_lm_entry_points_refuse_cpu_fallback():
    """The LM's entry points default to cuda as the engine does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda is a valid default here")
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch.serve import serve
    from repro_torch.models import DecoderLM, init_decode_cache, init_params

    cfg = reduced_config(get_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(cfg, batch=1, prompt_len=8, steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_decode_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_reference({}, cfg)
    assert init_params(cfg, torch.Generator(), "cpu").embed.device.type == "cpu"
    assert DecoderLM(cfg, "cpu").embed.device.type == "cpu"
    assert DecoderLM(cfg, "meta").embed.is_meta
    assert init_decode_cache(cfg, 1, 8, device="cpu")["k"].device.type == "cpu"


def _tiny_index():
    from repro_torch.convert import index_from_arrays

    return index_from_arrays(
        np.zeros((2, 32), np.float32), np.zeros((8, 256, 4), np.float32),
        np.zeros((10, 8), np.uint8), np.arange(10, dtype=np.int32), np.array([0, 4, 10]),
    )


def _update_cooc(idx):
    """`update_shards` on co-occurrence shards (built on the CPU as asked),
    with no device given: it must resolve to cuda."""
    from repro_torch.core.placement import place_clusters
    from repro_torch.retrieval import layout

    plc = place_clusters(np.array([4, 6]), np.ones(2), 2)
    old = layout.build_shards(idx, plc, use_cooc=True, n_combos=8, cap_slack=0.5,
                              device="cpu")
    return layout.update_shards(idx, plc, old, np.array([True, False]))


def _call(name):
    from repro_torch.core import cooc, delta
    from repro_torch.core import index as tindex
    from repro_torch.core.placement import place_clusters
    from repro_torch.data import vectors
    from repro_torch.retrieval import layout

    idx = _tiny_index()
    xs = np.zeros((10, 32), np.float32)
    codes = np.zeros((10, 8), np.uint8)
    calls = {
        "mine_combos": lambda: cooc.mine_combos(codes),
        "reencode": lambda: cooc.reencode(codes, cooc._empty(3)),
        "max_combo_frequency": lambda: cooc.max_combo_frequency(codes),
        "build_shards_cooc": lambda: layout.build_shards(
            idx, place_clusters(np.array([4, 6]), np.ones(2), 2), use_cooc=True),
        "build_index": lambda: tindex.build_index(xs, 2, 8),
        "encode_index": lambda: tindex.encode_index(idx.centroids, idx.codebook, xs),
        "assign_clusters": lambda: tindex.assign_clusters(idx.centroids, xs),
        "encode_vectors": lambda: tindex.encode_vectors(
            idx.codebook, idx.centroids, xs, np.zeros(10, np.int64)),
        "search": lambda: tindex.search(idx, xs[:2], 1, 3),
        "brute_force": lambda: tindex.brute_force(xs, xs[:2], 3),
        "generate_clustered": lambda: vectors.generate_clustered(10, 32, 2),
        "build_raw_store": lambda: layout.build_raw_store(
            idx, place_clusters(np.array([4, 6]), np.ones(2), 2), xs),
        "delta_insert": lambda: delta.DeltaIndex.create(8, 64).insert(
            idx.centroids, idx.codebook, np.arange(10, 12), xs[:2]),
        "delta_topk": lambda: delta.delta_topk(
            delta.DeltaIndex.create(8, 64), idx.centroids, idx.codebook, xs[:2], 1, 3),
        "delta_topk_plain": lambda: delta.delta_topk_plain(
            delta.DeltaIndex.create(8, 64), idx.centroids, idx.codebook, xs[:2], 1, 3),
        "update_shards_cooc": lambda: _update_cooc(idx),
    }
    return calls[name]()


@pytest.mark.parametrize("name", [
    "build_index", "encode_index", "assign_clusters", "encode_vectors", "search",
    "brute_force", "generate_clustered", "build_raw_store", "mine_combos", "reencode",
    "max_combo_frequency", "build_shards_cooc", "delta_insert", "delta_topk",
    "delta_topk_plain", "update_shards_cooc",
])
def test_index_and_data_entry_points_refuse_cpu_fallback(name):
    """The index, data, co-occurrence, shard and mutation functions (the
    delta buffer's insert and scans, the co-occurrence repack) default to
    cuda as the engine does: on a host without a GPU they raise, never
    compute on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: cuda is a valid default here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _call(name)
