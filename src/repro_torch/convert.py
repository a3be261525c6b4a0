"""Carry a trained reference index, placement or LM weights into this package.

The reference's k-means and PQ training and its weight init draw from
`jax.random`, so the two packages can only be held to the same answers
over the same state.  These functions build the port's objects from plain
numpy arrays, or read a reference `save_index` directory (`index/*.npy`,
`delta/*.npy` + `meta.json`) without importing the reference.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.delta import DeltaIndex
from repro_torch.core.index import IVFPQIndex
from repro_torch.core.placement import Placement
from repro_torch.device import resolve_device

_INDEX_FIELDS = ("centroids", "codebook", "codes", "vec_ids", "offsets")
_DELTA_FIELDS = ("codes", "assign", "vec_ids", "dead")


def _own(a, dtype) -> np.ndarray:
    """A contiguous, writable array of `dtype` (copied only when needed)."""
    arr = np.ascontiguousarray(a, dtype)
    return arr if arr.flags.writeable else arr.copy()


def index_from_arrays(
    centroids,
    codebook,
    codes,
    vec_ids,
    offsets,
    rotation=None,
) -> IVFPQIndex:
    """An `IVFPQIndex` from the arrays of a trained index (validated)."""
    return IVFPQIndex(
        centroids=_own(centroids, np.float32),
        codebook=_own(codebook, np.float32),
        codes=_own(codes, np.uint8),
        vec_ids=_own(vec_ids, np.int32),
        offsets=_own(offsets, np.int64),
        rotation=None if rotation is None else _own(rotation, np.float32),
    ).validate()


def placement_from_arrays(
    replicas, dev_load, dev_vectors, dev_clusters, w_bar: float
) -> Placement:
    """A `Placement` from the lists and arrays of an Algorithm-1 result."""
    return Placement(
        replicas=[[int(d) for d in r] for r in replicas],
        dev_load=np.asarray(dev_load, np.float64).copy(),
        dev_vectors=np.asarray(dev_vectors, np.int64).copy(),
        dev_clusters=[[int(c) for c in cl] for cl in dev_clusters],
        w_bar=float(w_bar),
    )


def delta_from_arrays(codes, assign, vec_ids, dead, n: int, tombstones,
                      vectors=None) -> DeltaIndex:
    """A `DeltaIndex` from the arrays of a delta buffer (e.g. the
    reference's `DeltaIndex`): codes (cap, M), assign, vec_ids, dead (cap,),
    the occupied row count, the tombstoned ids and the kept vectors.  The
    arrays are copied: the new buffer's inserts must not write into the
    source's."""
    def copy(a, dtype):
        return np.array(a, dtype, copy=True, order="C")

    return DeltaIndex(
        codes=copy(codes, np.uint8),
        assign=copy(assign, np.int32),
        vec_ids=copy(vec_ids, np.int32),
        dead=copy(dead, bool),
        n=int(n),
        tombstones={int(t) for t in np.asarray(list(tombstones), np.int64).tolist()},
        vectors=None if vectors is None else copy(vectors, np.float32),
    )


def load_index_dir(path: str) -> tuple[IVFPQIndex, dict]:
    """Read a reference `save_index` checkpoint directory, read-only.

    Returns (index, extra) where `extra` is the layout metadata the writer
    stored.  A checkpoint with a delta buffer (buffered inserts or
    tombstones) raises: dropping the delta would lose mutations, so such a
    checkpoint is read with `load_index_delta_dir`.
    """
    index, delta, extra = load_index_delta_dir(path)
    if delta is not None:
        raise ValueError(
            f"{path!r} holds a delta buffer (buffered inserts or tombstones); read "
            "it with repro_torch.convert.load_index_delta_dir, which keeps it"
        )
    return index, extra


def load_index_delta_dir(path: str) -> tuple[IVFPQIndex, DeltaIndex | None, dict]:
    """Read a reference `save_index` checkpoint directory with its delta.

    Returns (index, delta or None, extra), as the reference's `load_index`
    does: the index arrays (and an OPQ rotation), the delta buffer (its
    codes, assignments, ids, dead mask, kept vectors and tombstones) when
    the writer stored one, and the layout metadata.  A missing `path` falls
    back to `path.old` (a crash between the writer's renames); a damaged
    checkpoint raises ValueError naming it.
    """
    path = path.rstrip("/")
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        path = path + ".old"
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        arrays = {
            f: np.load(os.path.join(path, "index", f + ".npy"), allow_pickle=False)
            for f in _INDEX_FIELDS
        }
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
    except (OSError, ValueError, KeyError) as e:
        raise ValueError(
            f"unreadable save_index checkpoint at {path!r}: {type(e).__name__}: {e}"
        ) from e
    return index_from_arrays(**arrays), delta, meta.get("extra", {})


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A tensor of the array's dtype on `device`.  bf16 arrives from JAX as
    `ml_dtypes.bfloat16`, which `torch.from_numpy` refuses: it crosses as
    its int16 bit pattern."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def lm_params_from_reference(params: dict, cfg, device=None) -> dict[str, torch.Tensor]:
    """A `DecoderLM` state dict from the reference's dense parameter tree.

    `params` is `repro.models.init_params`'s tree as numpy arrays:
    `embed`, `final_norm`, `lm_head`, and `layers` whose leaves carry a
    leading L axis (`attn`: wq, wk, wv, wo, q_norm, k_norm; `mlp`: w_gate,
    w_up, w_down; `ln1`, `ln2`).  The stacked arrays are split into the
    per-layer tensors `layers.{i}.attn.wq`, ...; layouts are unchanged.
    The tensors go to `device`, cuda unless the caller asks for the CPU.
    Load it with `DecoderLM(cfg, device="meta").load_state_dict(state,
    assign=True)` or into an allocated model.
    """
    from repro_torch.models.model import check_dense

    check_dense(cfg)
    dev = resolve_device(device)
    state = {n: _tensor(params[n], dev) for n in ("embed", "final_norm", "lm_head")}
    layers = params["layers"]
    if len(layers["ln1"]) != cfg.n_layers:
        raise ValueError(f"{len(layers['ln1'])} stacked layers, config has {cfg.n_layers}")
    for i in range(cfg.n_layers):
        for group in ("attn", "mlp"):
            for name, arr in layers[group].items():
                state[f"layers.{i}.{group}.{name}"] = _tensor(arr[i], dev)
        for name in ("ln1", "ln2"):
            state[f"layers.{i}.{name}"] = _tensor(layers[name][i], dev)
    return state
