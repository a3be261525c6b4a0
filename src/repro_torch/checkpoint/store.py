"""save / restore / latest_step (LM training state) and save_index /
load_index / save_engine / load_engine / load_raw_store (retrieval).

`save` writes a `DecoderLM`'s parameters (+ the AdamW state, + metadata)
in the reference's format: `step_N.tmp` renamed to `step_N`, holding
`params/<tree path joined by "__">.npy` over the reference's stacked tree
(e.g. `layers__attn__wq.npy` of shape (L, d, h * hd)), `opt/mu__...`,
`opt/nu__...`, `opt/step.npy`, bf16 widened to f32, and `meta.json`
({"step": N, **extra}).  `restore` reads such a directory, the reference's
too, back into the port's per-layer tensors in place.

An `IVFPQIndex` (and its OPQ rotation), a live `DeltaIndex` (buffered
inserts, the dead-row mask, the kept raw vectors, tombstones), a
`RawStore` and layout metadata round-trip through one directory, written
as `path.tmp` and renamed into place with the previous checkpoint kept at
`path.old` until the new one is in, so a crash at any point leaves a
complete checkpoint that `load_index` finds.  The format is the
reference's (`repro.checkpoint.store`), read and written here without
importing it, so each package loads the other's checkpoints.

The raw stores differ.  The reference's is `(ndev, rcap, D)` f32 on the
host with one power-of-two `rcap`; the port's is `(rows, D)` f32 or bf16 on
the card, each device's shard at `row_base[d]` with its own `capacity`.
`save_index` writes the reference's layout, rcap = pow2(max used), device
by device through a memory map (a bf16 store up-cast to f32, which is
exact, with `raw_dtype: "bfloat16"`), and `load_raw_store` packs it back
into the port's layout, the cast back to bf16 giving the same bits.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.convert import delta_from_arrays, index_from_arrays
from repro_torch.device import resolve_device

_INDEX_FIELDS = ("centroids", "codebook", "codes", "vec_ids", "offsets")
_DELTA_FIELDS = ("codes", "assign", "vec_ids", "dead")
_RAW_FIELDS = ("vectors", "used", "id_dev", "id_row")
# rows a device-to-host (or back) copy of the raw store moves at a time
_RAW_CHUNK = 1 << 20


def _pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(int(n), 1) - 1).bit_length())


def _save_raw(dirname: str, raw) -> None:
    """A port `RawStore` in the reference's layout (module docstring)."""
    used = np.asarray(raw.used, np.int64)
    rcap = _pow2(int(used.max(initial=1)))
    vec = np.lib.format.open_memmap(os.path.join(dirname, "vectors.npy"), mode="w+",
                                    dtype=np.float32, shape=(raw.ndev, rcap, raw.dim))
    for d in range(raw.ndev):
        rows = raw.device_rows(d)
        for s in range(0, rows.shape[0], _RAW_CHUNK):
            chunk = rows[s : s + _RAW_CHUNK].float().cpu().numpy()
            vec[d, s : s + chunk.shape[0]] = chunk
    vec.flush()
    del vec
    np.save(os.path.join(dirname, "used.npy"), used)
    np.save(os.path.join(dirname, "id_dev.npy"), raw.id_dev.cpu().numpy().astype(np.int32))
    np.save(os.path.join(dirname, "id_row.npy"), raw.id_row.cpu().numpy().astype(np.int32))


def save_index(path: str, index, delta=None, raw=None, extra: dict | None = None,
               faults=None) -> str:
    """Atomically checkpoint an index (+ optional delta, raw store, metadata).

    Args:
      path: target directory (written as `path.tmp`, then renamed).
      index: an `IVFPQIndex` (this package's or any object with its arrays);
        an OPQ rotation is saved beside the codes.
      delta: optional `DeltaIndex`: its buffered inserts, dead-row mask,
        kept vectors and tombstones, so a restart resumes mid-churn.
      raw: optional `retrieval.layout.RawStore` (read back by
        `load_raw_store`).
      extra: JSON-serialisable metadata returned again by `load_index`.
      faults: optional `retrieval.faults.FaultPlan`; its `checkpoint_hook`
        fires at "before_commit", "after_rename_old" and
        "after_rename_new", so tests can crash the save at each point.
    """
    def crash_point(point: str) -> None:
        if faults is not None:
            faults.checkpoint_hook(point)

    path = path.rstrip("/")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "index"))
    for f in _INDEX_FIELDS:
        np.save(os.path.join(tmp, "index", f + ".npy"), np.asarray(getattr(index, f)))
    if getattr(index, "rotation", None) is not None:
        np.save(os.path.join(tmp, "index", "rotation.npy"), np.asarray(index.rotation))
    meta = {"has_delta": delta is not None, "has_raw": raw is not None,
            "extra": extra or {}}
    if delta is not None:
        os.makedirs(os.path.join(tmp, "delta"))
        for f in _DELTA_FIELDS:
            np.save(os.path.join(tmp, "delta", f + ".npy"), getattr(delta, f))
        if getattr(delta, "vectors", None) is not None:
            np.save(os.path.join(tmp, "delta", "vectors.npy"), delta.vectors)
        np.save(os.path.join(tmp, "delta", "tombstones.npy"), delta.tombstone_array())
        meta["delta_n"] = int(delta.n)
    if raw is not None:
        os.makedirs(os.path.join(tmp, "raw"))
        _save_raw(os.path.join(tmp, "raw"), raw)
        meta["raw_dtype"] = raw.dtype
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    # the previous checkpoint is renamed aside, not deleted, until the new
    # one is in place: a crash at any point leaves `path` or `path.old`.  A
    # `path.old` with no `path` (an earlier save died between the renames)
    # is the only complete checkpoint, so it stays until the new one is in
    # (the reference deletes it first, ROADMAP C8)
    crash_point("before_commit")
    old = path + ".old"
    if os.path.exists(path):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(path, old)
        crash_point("after_rename_old")
    os.rename(tmp, path)
    crash_point("after_rename_new")
    if os.path.exists(old):
        shutil.rmtree(old)
    return path


def _resolve(path: str) -> str:
    """`path`, or `path.old` when a crash between the renames left only it."""
    path = path.rstrip("/")
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        return path + ".old"
    return path


def load_index(path: str):
    """Restore a `save_index` checkpoint (either package's).

    Returns (IVFPQIndex, DeltaIndex or None, extra dict).  The index is
    validated, so a damaged checkpoint raises a ValueError naming the path
    and the fault instead of serving wrong rows.  A missing `path` whose
    `path.old` exists (a crash between the two renames) restores the
    previous complete checkpoint.
    """
    path = _resolve(path)
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        arrays = {f: np.load(os.path.join(path, "index", f + ".npy"), allow_pickle=False)
                  for f in _INDEX_FIELDS}
        rot = os.path.join(path, "index", "rotation.npy")
        if os.path.exists(rot):
            arrays["rotation"] = np.load(rot, allow_pickle=False)
        delta = None
        if meta.get("has_delta"):
            d = os.path.join(path, "delta")
            dargs = {f: np.load(os.path.join(d, f + ".npy"), allow_pickle=False)
                     for f in _DELTA_FIELDS}
            vec = os.path.join(d, "vectors.npy")
            delta = delta_from_arrays(
                n=int(meta["delta_n"]),
                tombstones=np.load(os.path.join(d, "tombstones.npy"), allow_pickle=False),
                vectors=np.load(vec, allow_pickle=False) if os.path.exists(vec) else None,
                **dargs,
            )
    except (OSError, ValueError, KeyError, EOFError) as e:
        raise ValueError(
            f"corrupt or unreadable checkpoint at {path!r}: {type(e).__name__}: {e} -- the "
            "directory is not a complete save_index checkpoint (delete it to fall back to a "
            f"rebuild, or restore {path + '.old'!r} if present)"
        ) from e
    return index_from_arrays(**arrays), delta, meta.get("extra", {})


def load_raw_store(path: str, device: torch.device | str | None = None,
                   cap_slack: float = 0.0):
    """The raw-vector store saved by `save_index(raw=...)`, or None.

    Returns this package's `RawStore` on `device` (default cuda), each
    device's shard reserving ceil(used * (1 + cap_slack)) rows, in the dtype
    the writer recorded (`raw_dtype`).  Same `.old` fallback as
    `load_index`.
    """
    from repro_torch.retrieval.layout import _TORCH_DTYPES, RawStore, _row_base, _slack_rows

    path = _resolve(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if not meta.get("has_raw"):
        return None
    dev = resolve_device(device)
    d = os.path.join(path, "raw")
    vec = np.load(os.path.join(d, "vectors.npy"), mmap_mode="r", allow_pickle=False)
    used = np.load(os.path.join(d, "used.npy"), allow_pickle=False).astype(np.int64)
    dtype = meta.get("raw_dtype", "float32")
    capacity = _slack_rows(used, cap_slack)
    base = _row_base(capacity)
    vectors = torch.zeros((int(capacity.sum()), vec.shape[2]), dtype=_TORCH_DTYPES[dtype],
                          device=dev)
    for dv in range(used.shape[0]):
        for s in range(0, int(used[dv]), _RAW_CHUNK):
            e = min(s + _RAW_CHUNK, int(used[dv]))
            vectors[base[dv] + s : base[dv] + e] = torch.from_numpy(
                np.array(vec[dv, s:e])).to(dev, vectors.dtype)
    del vec

    def ids(name):
        a = np.load(os.path.join(d, name + ".npy"), allow_pickle=False).astype(np.int32)
        return torch.as_tensor(a, device=dev)

    return RawStore(vectors=vectors, row_base=torch.as_tensor(base, device=dev), used=used,
                    id_dev=ids("id_dev"), id_row=ids("id_row"), dtype=dtype,
                    capacity=capacity, cap_slack=cap_slack)


def save_engine(path: str, engine, extra: dict | None = None, faults=None) -> str:
    """Checkpoint a whole `MemANNSEngine` through one `save_index`: the
    index, the live delta, the raw store, and the configuration that
    rebuilds the shards (the reference's keys: block_n, the co-occurrence
    knobs, path, scan, prune, rerank, k_overfetch, rerank_block,
    tile_floor, mutable, the cluster frequencies).  The shards are not
    saved: `load_engine` re-derives them.  `rerank_block` is stored as
    the saving package's value; each package reads it in its own kernel's
    unit, and no value changes a result."""
    s = engine.shards
    cooc = s.n_combos > 0
    cfg = {
        "block_n": int(s.block_n),
        "use_cooc": bool(cooc),
        "n_combos": int(s.n_combos),
        "combo_len": int(s.combo_addrs.shape[3]) if cooc else 3,
        "min_length_reduction": float(s.min_length_reduction),
        "mine_rows": int(s.mine_rows),
        "path": engine.path,
        "scan": engine.scan,
        "prune": bool(engine.prune),
        "rerank": engine.rerank,
        "k_overfetch": int(engine.k_overfetch),
        "rerank_block": int(engine.rerank_block),
        "tile_floor": int(engine.tile_floor),
        "mutable": engine.delta is not None,
        # json's float repr round-trips, so the re-derived placement is
        # the saved engine's
        "freqs": None if engine.freqs is None else [float(f) for f in engine.freqs],
    }
    return save_index(path, engine.index, delta=engine.delta, raw=engine.raw,
                      extra={"engine": cfg, **(extra or {})}, faults=faults)


def load_engine(path: str, ndev: int = 8, device: torch.device | str | None = None):
    """Restore a `save_engine` checkpoint (either package's) into a ready
    `MemANNSEngine` on `device` (default cuda) over `ndev` logical devices.

    The placement is re-derived by Algorithm 1 from the restored sizes and
    frequencies, and the shards repacked with the saved configuration
    (co-occurrence mining is seeded by cluster id, so the codes come back
    the same); a mutable engine gets the build's growth slack on its shards
    and raw store.  Search results are placement-invariant, so the restored
    engine answers as the saved one did, on any `ndev`.
    """
    from repro_torch.core.placement import place_clusters
    from repro_torch.retrieval.engine import MemANNSEngine
    from repro_torch.retrieval.layout import build_shards, default_slack

    index, delta, extra = load_index(path)
    if "engine" not in extra:
        raise ValueError(f"load_engine: checkpoint at {path!r} has no engine config "
                         "(saved with save_index, not save_engine?)")
    cfg = extra["engine"]
    dev = resolve_device(device)
    if cfg.get("freqs") is not None:
        freqs = np.asarray(cfg["freqs"], np.float64)
    else:
        freqs = np.ones(index.n_clusters) / index.n_clusters
    placement = place_clusters(index.cluster_sizes().astype(np.float64), freqs, ndev,
                               centroids=index.centroids)
    mutable = bool(cfg.get("mutable")) and delta is not None
    cap_slack, slot_slack, window_slack = default_slack(cfg["block_n"], mutable)
    shards = build_shards(
        index, placement, use_cooc=cfg["use_cooc"],
        n_combos=cfg["n_combos"] if cfg["use_cooc"] else 256,
        combo_len=cfg.get("combo_len", 3), block_n=cfg["block_n"],
        min_length_reduction=cfg.get("min_length_reduction", 0.0),
        mine_rows=cfg.get("mine_rows", 50_000), cap_slack=cap_slack, slot_slack=slot_slack,
        window_slack=window_slack, device=dev,
    )
    return MemANNSEngine(
        index=index, placement=placement, shards=shards, device=dev,
        path=cfg.get("path", "gather"), scan=cfg.get("scan", "tiles"),
        prune=cfg.get("prune", True), rerank=cfg.get("rerank", "off"),
        k_overfetch=cfg.get("k_overfetch", 0), rerank_block=cfg.get("rerank_block", 0),
        tile_floor=cfg.get("tile_floor", 0), freqs=freqs, delta=delta,
        raw=load_raw_store(path, dev, cap_slack=0.5 if mutable else 0.0),
    )


# ---------------------------------------------------------------------- #
# LM training state (DecoderLM parameters + AdamW state)
# ---------------------------------------------------------------------- #


def _write_leaves(dirname: str, leaves: dict) -> None:
    """Each leaf (a tensor, or a stacked leaf's list of per-layer tensors)
    as `<path joined by "__">.npy`; a stacked leaf is written layer by
    layer into a memory map, so no stacked copy is made on the host."""
    from repro_torch.convert import host_array

    for key, v in leaves.items():
        path = os.path.join(dirname, key.replace("/", "__") + ".npy")
        if isinstance(v, torch.Tensor):
            np.save(path, host_array(v))
            continue
        first = host_array(v[0])
        arr = np.lib.format.open_memmap(path, mode="w+", dtype=first.dtype,
                                        shape=(len(v), *first.shape))
        for i, t in enumerate(v):
            arr[i] = first if i == 0 else host_array(t)
        arr.flush()
        del arr


def _opt_leaves(opt_state: dict) -> dict:
    from repro_torch.convert import reference_leaves

    leaves = {}
    for part in ("mu", "nu"):
        for key, v in reference_leaves(opt_state[part]).items():
            leaves[f"{part}/{key}"] = v
    leaves["step"] = opt_state["step"]
    return leaves


def save(ckpt_dir: str, step: int, params, opt_state: dict | None = None,
         extra: dict | None = None) -> str:
    """Atomic checkpoint of a `DecoderLM` (or a name -> tensor dict) and the
    AdamW state (`optim.init_opt_state`'s layout), in the reference's format
    (module docstring).  Returns the checkpoint's directory."""
    from repro_torch.convert import reference_leaves

    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "params"))
    _write_leaves(os.path.join(tmp, "params"), reference_leaves(params))
    if opt_state is not None:
        os.makedirs(os.path.join(tmp, "opt"))
        _write_leaves(os.path.join(tmp, "opt"), _opt_leaves(opt_state))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The largest N of a committed `step_N` directory (`.tmp` skipped)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


@torch.no_grad()
def _read_leaves(dirname: str, leaves: dict) -> None:
    """Copy each leaf's `.npy` into its tensor(s) in place, cast to the
    tensor's dtype (an f32-widened bf16 value rounds back to its bits)."""
    for key, v in leaves.items():
        path = os.path.join(dirname, key.replace("/", "__") + ".npy")
        arr = np.load(path, mmap_mode="r")
        targets = [v] if isinstance(v, torch.Tensor) else v
        want = tuple(v.shape) if isinstance(v, torch.Tensor) else (len(v), *v[0].shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{path}: shape {arr.shape}, expected {want}")
        for i, t in enumerate(targets):
            src = np.array(arr if isinstance(v, torch.Tensor) else arr[i])
            t.copy_(torch.from_numpy(src))


def restore(ckpt_dir: str, step: int, params_like, opt_like: dict | None = None):
    """Read `step_N` (this package's or the reference's) into `params_like`
    (a `DecoderLM` or name -> tensor dict) and `opt_like` in place.
    Returns (params, opt state, meta)."""
    from repro_torch.convert import reference_leaves

    base = os.path.join(ckpt_dir, f"step_{step}")
    _read_leaves(os.path.join(base, "params"), reference_leaves(params_like))
    if opt_like is not None:
        leaves = _opt_leaves(opt_like)
        step_t = leaves.pop("step")
        _read_leaves(os.path.join(base, "opt"), leaves)
        arr = np.load(os.path.join(base, "opt", "step.npy"))
        opt_like["step"] = torch.as_tensor(arr.astype(np.int32), device=step_t.device)
    with open(os.path.join(base, "meta.json")) as f:
        meta = json.load(f)
    return params_like, opt_like, meta
