"""The dry run on the meta device: FLOPs, bytes and memory of a cell, no data.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --retrieval sift1b --cooc

The port of `repro.launch.dryrun`.  The reference lowers each (arch x
shape) cell of `configs.SHAPES` for a 256- or 512-chip TPU mesh and reads
XLA's cost and memory analysis.  Here the cell's real step runs on
`torch.device("meta")`, where every tensor has a shape and a dtype and no
storage:

  * build: `DecoderLM(cfg, "meta")` (the counterpart of `jax.eval_shape`
    of `init_params`), `init_opt_state`, the tokens (and the vision stub's
    bf16 embeddings), and for a decode cell `init_decode_cache` at the
    cell's length; `init_params` still refuses meta, as every entry point
    runs on cuda or the CPU only;
  * trace: the train step (`training.make_train_step`, remat as the config
    says: every layer is recomputed in the backward as on the card),
    `prefill`, or one `decode_step` at position `seq - 1` (a Python int
    offset, as `decode_step` takes) runs under two modes:
    `torch.utils.flop_counter.FlopCounterMode` counts the GEMM-class FLOPs,
    and `TraceCounter`, a `TorchDispatchMode`, sums each aten op's input
    and output bytes (views and `empty` move none: the unfused traffic,
    the counterpart of XLA's "bytes accessed") and follows the live bytes
    of the storages the step allocates (weakref finalizers on each
    storage), whose peak is `temp_bytes`;
  * kernel B10 on meta (`ops.flash_attention_fwd`'s meta branch, taken by
    prefill cells with `--flash`) adds its own work: the FLOPs of its bound
    and its byte model (`kernels.flash_attn.flash_hbm_bytes_per_layer`),
    not the plain version's materialised scores.

Every layer runs, so no extrapolation in the style of the reference's
`corrected_cell_costs` is needed (XLA counted a scanned layer once; here
nothing is scanned).  A cell reports the reference's keys with the card's
numbers: `flops`, `bytes`, `memory` (`argument_bytes`: the step's
arguments; `output_bytes`: the new storages it returns; `temp_bytes`),
the `roofline` terms at `peaks_for` of the device (the H100's data-sheet
peaks on the card: `peaks_source` "table:H100"), `model_flops` (6 N_active
tokens to train, 2 N_active tokens to serve), `useful_ratio`, and `fits`:
arguments plus temporaries within the card's 80 GB (`share` of it).

Meshes: `--mesh card` (default) is one H100, `collective_s` 0.  `--mesh
pod` / `multipod` are the reference's 256 / 512-chip meshes: argument
bytes per chip from the ported partition rules (`models.sharding`), FLOPs,
bytes and temporaries as the global count over the chips, and
`collectives: null` (there is no compiled SPMD module to read them from;
the cell's `notes` say so).

Retrieval cells are the reference's closed form, ported exactly
(`retrieval_shapes`, `retrieval_roofline_analytic`); on the card
`CARD_NDEV` = 8 logical devices (the engine's default) share it, so the per-device
terms are summed over them and the merge costs no collective.  Memory is
the bytes of the 13 operands the reference's `lower_retrieval_cell`
declares, from those shapes; nothing is traced.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, cell_runnable, get_config
from repro_torch.configs.memanns import SIFT1B, SPACEV1B, RetrievalConfig
from repro_torch.kernels import ops
from repro_torch.launch.roofline_report import peaks_for
from repro_torch.models import decode_step, init_decode_cache, prefill
from repro_torch.models.model import DecoderLM
from repro_torch.models.sharding import (
    MESHES,
    batch_spec,
    cache_spec,
    fit_spec,
    n_chips,
    param_specs,
    per_chip_bytes,
)
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.training.trainer import make_train_step, trainable

# the card's memory as sold (H100 80GB HBM3), against which `fits` is judged
CARD_BYTES = 80 * 10**9
# the reference's per-link interconnect rate, for the retrieval closed
# form's collective term on the pod meshes (the card has none)
ICI_BW = 50e9
# logical devices sharing the card in a retrieval cell (the engine's default)
CARD_NDEV = 8
META = torch.device("meta")
# ops that allocate or alias and move no bytes
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.detach.default,
    torch.ops.aten.lift_fresh.default, torch.ops.aten._unsafe_view.default,
    torch.ops.aten.alias.default,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts (an aten op's
    arguments and outputs, a step's arguments)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class TraceCounter(TorchDispatchMode):
    """Bytes each aten op reads and writes, and the live bytes of the
    storages allocated while the mode is on (the storages of `known`
    tensors, the step's arguments, are never counted as allocated)."""

    def __init__(self, known=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._known = {_key(t) for t in known}
        self._live: set[int] = set()

    def _free(self, key: int, n: int) -> None:
        self._live.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not (func.is_view or func in _NO_TRAFFIC):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known or key in self._live:
                continue
            self._live.add(key)
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, st.nbytes())
        return out

    def new_bytes(self, tree) -> int:
        """Bytes of the distinct storages in `tree` that are not `known`."""
        seen = {}
        for t in _tensors(tree):
            key = _key(t)
            if key not in self._known:
                seen[key] = t.untyped_storage().nbytes()
        return sum(seen.values())


def trace(fn, arguments) -> dict:
    """Run `fn()` under the FLOP counter and a `TraceCounter` whose known
    storages are those of `arguments`: FLOPs (B10's meta work included),
    bytes, output and temporary bytes, and each kernel's meta work."""
    ops.reset_meta_work()
    counter = TraceCounter(_tensors(arguments))
    with FlopCounterMode(display=False) as fc, counter:
        out = fn()
        output_bytes = counter.new_bytes(out)
        del out
    kernels = {k: dict(v) for k, v in ops.meta_work.items() if v["calls"]}
    return {
        "flops": fc.get_total_flops() + sum(w["flops"] for w in kernels.values()),
        "bytes": counter.bytes + sum(w["bytes"] for w in kernels.values()),
        "output_bytes": output_bytes,
        "temp_bytes": counter.peak,
        "kernels": kernels,
    }


def argument_bytes(tensors) -> int:
    """Bytes of the distinct storages of a step's arguments."""
    return sum({_key(t): t.untyped_storage().nbytes() for t in _tensors(tensors)}.values())


def model_flops(cfg, seq: int, batch: int, kind: str) -> int:
    """The reference's MODEL_FLOPS (`dryrun.py` `run_cell`): 6 N_active D to
    train, 2 N_active D to serve, D the cell's tokens (a decode step's:
    the batch)."""
    tokens = batch * seq if kind in ("train", "prefill") else batch
    return (6 if kind == "train" else 2) * cfg.n_active_params() * tokens


def _chip_bytes(pairs, mesh: dict) -> int:
    """Per-chip bytes of (tensor, spec) pairs on `mesh`, each fitted."""
    return sum(per_chip_bytes(tuple(t.shape), t.dtype, fit_spec(spec, tuple(t.shape), mesh), mesh)
               for t, spec in pairs)


def lm_step(cfg, seq: int, batch: int, kind: str):
    """(the cell's step as a no-argument function, its arguments by name)
    on the meta device: `train` the train step on (params, opt_state,
    tokens[, embeddings]), `prefill` the prompt into a cache of `seq`,
    `decode` one token at position seq - 1 of a `seq` cache."""
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    model = DecoderLM(cfg, META)
    args: dict = {"params": model}
    if kind == "decode":
        args["tokens"] = torch.empty((batch, 1), dtype=torch.int32, device=META)
        args["cache"] = init_decode_cache(cfg, batch, seq, device=META)
        return (lambda: decode_step(model, cfg, args["tokens"], args["cache"], seq - 1)), args
    args["tokens"] = torch.empty((batch, seq - n_front), dtype=torch.int32, device=META)
    emb = None
    if n_front:
        emb = args["embeddings"] = torch.empty((batch, n_front, cfg.d_model),
                                               dtype=torch.bfloat16, device=META)
    if kind == "train":
        trainable(model)
        opt = args["opt_state"] = init_opt_state(model)
        step = make_train_step(cfg, AdamWConfig())
        return (lambda: step(model, opt, args["tokens"], emb)), args
    return (lambda: prefill(model, cfg, args["tokens"], max_len=seq, embeddings=emb)), args


def _leaves(args: dict) -> list[torch.Tensor]:
    """The argument tensors: a model's parameters, then every other leaf."""
    out = []
    for a in args.values():
        out += list(a.parameters()) if isinstance(a, DecoderLM) else _tensors(a)
    return out


def lm_per_chip_argument_bytes(cfg, args: dict, mesh: dict, batch: int) -> int:
    """The step's arguments on one chip of `mesh` under the ported rules:
    parameters and AdamW moments by `param_specs`, tokens by `batch_spec`,
    embeddings batch-sharded, cache entries by `cache_spec`."""
    model = args["params"]
    specs = param_specs(model, mesh)
    named = dict(model.named_parameters())
    pairs = [(p, specs[n]) for n, p in named.items()]
    if "opt_state" in args:
        opt = args["opt_state"]
        pairs += [(opt[part][n], specs[n]) for part in ("mu", "nu") for n in named]
        pairs.append((opt["step"], ()))
    pairs.append((args["tokens"], batch_spec(mesh)))
    if "embeddings" in args:
        pairs.append((args["embeddings"], (batch_spec(mesh)[0], None, None)))
    for key, t in args.get("cache", {}).items():
        pairs.append((t, cache_spec(cfg, key, mesh, batch)))
    return _chip_bytes(pairs, mesh)


def roofline(flops: float, n_bytes: float, coll_bytes: float | None, peaks) -> dict:
    """Three-term roofline at (peak FLOP/s, HBM bytes/s); a None collective
    term (not measurable here) drops out of the bound."""
    peak_flops, hbm_bw = peaks
    terms = {"compute_s": flops / peak_flops, "memory_s": n_bytes / hbm_bw,
             "collective_s": None if coll_bytes is None else coll_bytes / ICI_BW}
    known = {k: v for k, v in terms.items() if v is not None}
    dom = max(known, key=known.get)
    bound = max(known.values())
    total = max(bound, 1e-30)
    return {**terms, "dominant": dom, "bound_s": bound,
            "roofline_fraction": {k: v / total for k, v in known.items()}}


def _peaks(device_kind: str | None):
    if device_kind is None:
        from repro_torch.launch.env import describe_env

        device_kind = describe_env()["device_kind"]
    flops, bw, source = peaks_for(device_kind)
    return device_kind, (flops, bw), source


def mesh_label(mesh_name: str) -> str:
    return {"card": "card", "pod": "pod16x16", "multipod": "pod2x16x16"}[mesh_name]


def lm_cell(cfg, shape, mesh_name: str = "card", device_kind: str | None = None) -> dict:
    """Trace one LM cell: `shape` is a `SHAPES` name or a (seq, batch, kind)
    tuple.  Returns the cell's report (no status, name or timing)."""
    seq, batch, kind = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = MESHES[mesh_name]
    chips = max(1, n_chips(mesh))
    kind_name, peaks, source = _peaks(device_kind)
    fn, args = lm_step(cfg, seq, batch, kind)
    leaves = _leaves(args)
    t = trace(fn, leaves)
    arg_bytes = argument_bytes(leaves)
    rep = {
        "n_chips": chips, "device_kind": kind_name, "peak_flops": peaks[0],
        "hbm_bw": peaks[1], "peaks_source": source,
        "flops": t["flops"], "bytes": t["bytes"],
        "flops_per_chip": t["flops"] / chips, "bytes_per_chip": t["bytes"] / chips,
        "kernels": t["kernels"],
        "memory": {"argument_bytes": arg_bytes, "output_bytes": t["output_bytes"],
                   "temp_bytes": t["temp_bytes"]},
        "collectives": None if chips > 1 else {"total": 0},
    }
    if chips > 1:
        rep["memory"] = {
            "argument_bytes": lm_per_chip_argument_bytes(cfg, args, mesh, batch),
            "output_bytes": t["output_bytes"] // chips, "temp_bytes": t["temp_bytes"] // chips,
            "global_argument_bytes": arg_bytes}
        rep["notes"] = ("argument bytes per chip from the partition rules; flops, bytes, "
                        "output and temp bytes are the global count over n_chips; no "
                        "compiled SPMD module, so collectives are not counted")
    rep.update(roofline(rep["flops_per_chip"], rep["bytes_per_chip"],
                        None if chips > 1 else 0.0, peaks))
    rep["model_flops"] = model_flops(cfg, seq, batch, kind)
    rep["model_flops_per_chip"] = rep["model_flops"] / chips
    rep["useful_ratio"] = rep["model_flops_per_chip"] / rep["flops_per_chip"] if t["flops"] else 0.0
    need = rep["memory"]["argument_bytes"] + rep["memory"]["temp_bytes"]
    rep["predicted_peak_bytes"] = need
    rep["share"] = need / CARD_BYTES
    rep["fits"] = need <= CARD_BYTES
    rep["arguments_fit"] = rep["memory"]["argument_bytes"] <= CARD_BYTES
    return rep


def _write(cell: dict, out_dir: str | None, fname: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, fname.replace("/", "_")), "w") as f:
            json.dump(cell, f, indent=1)


def run_cell(arch, shape_name, mesh_name="card", out_dir=None, overrides: dict | None = None,
             tag: str = "", device_kind: str | None = None) -> dict:
    """One (arch x shape) cell on `mesh_name`, written to `out_dir` as
    `<arch>__<shape>__<mesh>.json` (the reference's file names)."""
    t0 = time.time()
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    ok, why = cell_runnable(cfg, shape_name)
    mesh = mesh_label(mesh_name)
    cell = {
        "arch": arch + tag, "shape": shape_name, "mesh": mesh,
        "model_params": cfg.n_params(), "active_params": cfg.n_active_params(),
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
    }
    fname = f"{arch}__{shape_name}__{mesh}.json"
    if not ok:
        cell["status"] = why
        _write(cell, out_dir, fname)
        return cell
    try:
        cell.update(lm_cell(cfg, shape_name, mesh_name, device_kind))
        cell["status"] = "ok"
    except Exception as e:  # noqa: BLE001 -- a cell that fails is reported, not raised
        cell["status"] = f"FAIL: {type(e).__name__}: {e}"[:500]
    cell["trace_s"] = round(time.time() - t0, 1)
    _write(cell, out_dir, fname)
    return cell


# --------------------------------------------------------------------------- #
# Retrieval (the paper's own workload): the reference's closed form
# --------------------------------------------------------------------------- #


def retrieval_shapes(rcfg: RetrievalConfig, ndev: int, use_cooc: bool = False,
                     width: int | None = None, compact_dtype: bool = True) -> dict:
    """Full-scale shapes of the sharded index (the reference's, exactly)."""
    bn = rcfg.block_n
    align = lambda x: (x + bn - 1) // bn * bn  # noqa: E731
    avg = rcfg.n_vectors // rcfg.n_clusters
    window = align(4 * avg)                      # skewed max cluster ~ 4x avg
    cap = align(int(1.2 * rcfg.n_vectors / ndev))
    slots = int(math.ceil(1.5 * rcfg.n_clusters / ndev)) + 2
    pairs = 1 << math.ceil(
        math.log2(max(8, 1.3 * rcfg.batch_queries * rcfg.nprobe / ndev))
    )
    w = width or rcfg.m
    n_combos = rcfg.n_combos if use_cooc else 0
    if not compact_dtype:
        dtype, entry_bytes, add_offsets = "int32", 4, False
    elif use_cooc:
        dtype, entry_bytes, add_offsets = "uint16", 2, False
    else:
        dtype, entry_bytes, add_offsets = "uint8", 1, True
    return {
        "ndev": ndev, "cap": cap, "window": window, "slots": slots,
        "pairs": int(pairs), "width": w, "n_combos": n_combos,
        "dim": rcfg.dim, "m": rcfg.m, "dsub": rcfg.dim // rcfg.m,
        "q": rcfg.batch_queries, "k": rcfg.k, "block_n": bn,
        "code_dtype": dtype, "entry_bytes": entry_bytes,
        "add_offsets": add_offsets,
    }


def retrieval_operands(s: dict) -> list[tuple[str, tuple, torch.dtype]]:
    """The 13 operands the reference's `lower_retrieval_cell` declares for
    the tiles scan, as (name, shape, dtype), with its default tile budget:
    the worst-case bucket, every pair scanning a full window."""
    nd, p, sl = s["ndev"], s["pairs"], s["slots"]
    tiles = p * max(s["window"] // s["block_n"], 1)
    i32 = torch.int32
    return [
        ("codes", (nd, s["cap"], s["width"]), getattr(torch, s["code_dtype"])),
        ("vec_ids", (nd, s["cap"]), i32),
        ("slot_start", (nd, sl), i32),
        ("slot_size", (nd, sl), i32),
        ("combos", (nd, sl, s["n_combos"], 3), i32),
        ("codebook", (s["m"], 256, s["dsub"]), torch.float32),
        ("qmc", (nd, p, s["dim"]), torch.float32),
        ("pair_q", (nd, p), i32),
        ("pair_slot", (nd, p), i32),
        ("pair_valid", (nd, p), torch.bool),
        ("tile_pair", (nd, tiles), i32),
        ("tile_block", (nd, tiles), i32),
        ("tile_row0", (nd, tiles), i32),
    ]


def retrieval_roofline_analytic(
    rcfg: RetrievalConfig,
    s: dict,
    use_cooc: bool,
    entry_bytes: int = 4,
    avg_width: float | None = None,
    window_read_factor: float | None = None,
    peaks: tuple[float, float] | None = None,
    ici_bw: float = ICI_BW,
) -> dict:
    """Analytic per-chip roofline for the sharded scan (the reference's
    closed form; `peaks` (FLOP/s, bytes/s) defaults to the H100's).

      memory     = pairs/chip x window x W x entry_bytes   (padded-window DMA)
      compute    = valid rows x W adds (gather path) per chip
      collective = per-chip all-gather operands of the (Q, k) merge
    """
    peak_flops, hbm_bw = peaks or peaks_for("H100")[:2]
    ndev = s["ndev"]
    pairs_total = rcfg.batch_queries * rcfg.nprobe
    avg_cluster = rcfg.n_vectors / rcfg.n_clusters
    w = avg_width if avg_width is not None else s["width"]
    wrf = window_read_factor if window_read_factor is not None else (
        s["window"] / avg_cluster
    )
    rows_valid = pairs_total * avg_cluster / ndev
    rows_read = rows_valid * wrf
    bytes_codes = rows_read * w * entry_bytes
    bytes_luts = s["pairs"] * (s["m"] * 256 + s["n_combos"] + 1) * 4
    t_mem = (bytes_codes + bytes_luts) / hbm_bw
    flops = rows_valid * w * 2 + s["pairs"] * s["m"] * 256 * 3 * s["dsub"]
    t_comp = flops / peak_flops
    coll = rcfg.batch_queries * rcfg.k * 8  # vals f32 + ids i32 operands
    t_coll = coll / ici_bw
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    qps_bound = rcfg.batch_queries / max(terms.values())
    return {
        "analytic": {
            **terms,
            "dominant": dom,
            "bytes_codes_per_chip": bytes_codes,
            "rows_valid_per_chip": rows_valid,
            "window_read_factor": wrf,
            "entry_bytes": entry_bytes,
            "avg_width": w,
            "qps_bound": qps_bound,
            "flops_per_chip": flops,
            "bytes_per_chip": bytes_codes + bytes_luts,
        }
    }


def run_retrieval(dataset, mesh_name="card", use_cooc=False, out_dir=None,
                  entry_bytes=None, avg_width=None, window_read_factor=None, tag="",
                  compact_dtype=True, width=None, device_kind=None) -> dict:
    """One retrieval cell.  On the card `CARD_NDEV` logical devices share it: the
    closed form's per-device compute and memory terms are summed over them
    and the merge is a reshape (no collective)."""
    t0 = time.time()
    rcfg = {"sift1b": SIFT1B, "spacev1b": SPACEV1B}[dataset]
    card = mesh_name == "card"
    mesh = "card" if card else ("dpu512" if mesh_name == "multipod" else "dpu256")
    cell = {"arch": f"memanns-{dataset}" + ("-cooc" if use_cooc else "") + tag,
            "shape": f"q{rcfg.batch_queries}_nprobe{rcfg.nprobe}", "mesh": mesh}
    try:
        kind_name, peaks, source = _peaks(device_kind)
        nd = CARD_NDEV if card else (512 if mesh_name == "multipod" else 256)
        s = retrieval_shapes(rcfg, nd, use_cooc, width=width, compact_dtype=compact_dtype)
        rep = retrieval_roofline_analytic(
            rcfg, s, use_cooc, entry_bytes=entry_bytes if entry_bytes else s["entry_bytes"],
            avg_width=avg_width, window_read_factor=window_read_factor, peaks=peaks)
        ana = rep["analytic"]
        operands = retrieval_operands(s)
        # per chip: every operand but the replicated codebook is split over
        # its leading device axis; the card holds them all
        arg_bytes = sum(math.prod(shape) * dt.itemsize // (1 if card or n == "codebook" else nd)
                        for n, shape, dt in operands)
        per = nd if card else 1  # devices whose work lands on one chip
        terms = {"compute_s": ana["compute_s"] * per, "memory_s": ana["memory_s"] * per,
                 "collective_s": 0.0 if card else ana["collective_s"]}
        rep.update(terms)
        rep["dominant"] = max(terms, key=terms.get)
        rep["bound_s"] = max(terms.values())
        rep.update(n_chips=1 if card else nd, logical_devices=nd, device_kind=kind_name,
                   peak_flops=peaks[0], hbm_bw=peaks[1], peaks_source=source,
                   flops=ana["flops_per_chip"] * nd, bytes=ana["bytes_per_chip"] * nd)
        probed_rows = rcfg.batch_queries * rcfg.nprobe * (rcfg.n_vectors / rcfg.n_clusters)
        rep["probed_rows"] = probed_rows
        rep["useful_code_bytes_per_chip"] = probed_rows * rcfg.m * 1 / rep["n_chips"]
        rep["memory"] = {"argument_bytes": arg_bytes,
                         "operands": {n: list(shape) for n, shape, _ in operands}}
        rep["predicted_peak_bytes"] = rep["memory"]["argument_bytes"]
        rep["share"] = rep["predicted_peak_bytes"] / CARD_BYTES
        rep["fits"] = rep["arguments_fit"] = rep["predicted_peak_bytes"] <= CARD_BYTES
        cell.update(rep)
        cell["layout"] = s
        cell["status"] = "ok"
    except Exception as e:  # noqa: BLE001
        cell["status"] = f"FAIL: {type(e).__name__}: {e}"[:500]
    cell["trace_s"] = round(time.time() - t0, 1)
    _write(cell, out_dir, f"{cell['arch']}__{mesh}.json")
    return cell


def main(argv=None) -> int:
    """The reference's flags.  Two of them have nothing to act on here and
    raise: `--path onehot` (the closed form is the same for either scan
    order, and no scan is lowered) and `--grad-compress` (no collective is
    traced, so the int8 pod all-reduce would change no figure)."""
    from repro_torch.launch.env import setup_env

    setup_env()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["card", "pod", "multipod"], default="card")
    ap.add_argument("--retrieval", choices=["sift1b", "spacev1b"])
    ap.add_argument("--cooc", action="store_true")
    ap.add_argument("--path", default="gather")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default="", help="suffix to the cell's arch name")
    ap.add_argument("--int32", action="store_true",
                    help="baseline int32 code storage (paper-faithful port)")
    ap.add_argument("--wrf", type=float, default=None,
                    help="window read factor override (tiles mode: ~1.0)")
    ap.add_argument("--avg-width", type=float, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--opt-decode", action="store_true")
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--flash", action="store_true",
                    help="kernel B10 in the prefill (counted by its own model on meta)")
    ap.add_argument("--device-kind", default=None,
                    help="device name whose peaks the roofline uses (default: "
                         "describe_env()'s, the card's on a GPU machine)")
    args = ap.parse_args(argv)
    if args.path != "gather":
        ap.error("--path: the closed form does not depend on the scan order; only gather")
    if args.grad_compress:
        ap.error("--grad-compress: no collective is traced, so it would change nothing")
    if args.retrieval:
        cell = run_retrieval(
            args.retrieval, args.mesh, args.cooc, args.out,
            window_read_factor=args.wrf, avg_width=args.avg_width, tag=args.tag,
            compact_dtype=not args.int32, width=args.width, device_kind=args.device_kind,
        )
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --retrieval) are required")
        overrides = {}
        if args.opt_decode:
            overrides["opt_decode"] = True
        if args.attn_chunk:
            overrides["attn_chunk"] = args.attn_chunk
        if args.no_remat:
            overrides["remat"] = False
        if args.flash:
            overrides["use_flash_kernel"] = True
        cell = run_cell(args.arch, args.shape, args.mesh, args.out,
                        overrides=overrides or None, tag=args.tag,
                        device_kind=args.device_kind)
    slim = {k: v for k, v in cell.items() if k not in ("layout",)}
    print(json.dumps(slim, indent=1, default=str))
    return 1 if str(cell.get("status", "")).startswith("FAIL") else 0


if __name__ == "__main__":
    sys.exit(main())
