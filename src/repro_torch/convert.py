"""Carry a trained reference index, placement or LM weights into this package.

The reference's k-means and PQ training and its weight init draw from
`jax.random`, so the two packages can only be held to the same answers
over the same state.  These functions build the port's objects from plain
numpy arrays, or read a `save_index` directory (`index/*.npy`,
`delta/*.npy` + `meta.json`, through `checkpoint.load_index`) without
importing the reference; `lm_params_to_reference` carries LM weights (or
optimizer moments) back into the reference's stacked tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.delta import DeltaIndex
from repro_torch.core.index import IVFPQIndex
from repro_torch.core.placement import Placement
from repro_torch.device import resolve_device


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
    """Read a `save_index` checkpoint directory (the reference's or this
    package's) without a delta buffer, read-only.

    Returns (index, extra) where `extra` is the layout metadata the writer
    stored.  A checkpoint with a delta buffer (buffered inserts or
    tombstones) raises: dropping the delta would lose mutations, so such a
    checkpoint is read with `repro_torch.checkpoint.load_index`.
    """
    from repro_torch.checkpoint import load_index

    index, delta, extra = load_index(path)
    if delta is not None:
        raise ValueError(
            f"{path!r} holds a delta buffer (buffered inserts or tombstones); read "
            "it with repro_torch.checkpoint.load_index, which keeps it"
        )
    return index, extra


def _tensor(a, device: torch.device) -> torch.Tensor:
    """A tensor of the array's dtype on `device`.  bf16 arrives from JAX as
    `ml_dtypes.bfloat16`, which `torch.from_numpy` refuses: it crosses as
    its int16 bit pattern."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def lm_params_from_reference(params: dict, cfg, device=None) -> dict[str, torch.Tensor]:
    """A `DecoderLM` state dict from the reference's parameter tree, any family.

    `params` is `repro.models.init_params`'s tree as numpy arrays:
    `embed`, `final_norm`, `lm_head`; `layers` and (deepseek) `dense_layers`
    whose leaves carry a leading L axis (`attn`, `mlp` or `moe` -- whose
    expert weights carry E after L --, `ssm`, `ln1`, `ln2`); and (Zamba2)
    the unstacked `shared_attn` block.  Stacked arrays are split into the
    per-layer tensors `layers.{i}.attn.wq`, `layers.{i}.moe.w_gate`,
    `dense_layers.{i}.mlp.w_up`, `layers.{i}.ssm.in_proj`, ...; layouts are
    unchanged.  A tree whose layer counts disagree with the config raises
    ValueError.  The tensors go to `device`, cuda unless the caller asks for
    the CPU.  Load it with `DecoderLM(cfg, device="meta").load_state_dict(
    state, assign=True)` or into an allocated model.
    """
    from repro_torch.models.model import n_dense_layers

    dev = resolve_device(device)
    state = {n: _tensor(params[n], dev) for n in ("embed", "final_norm", "lm_head")}
    n_dense = n_dense_layers(cfg)
    want = {"dense_layers": n_dense, "layers": cfg.n_layers - n_dense}
    for stack, n in want.items():
        leaves = list(_leaves(params.get(stack, {})))
        got = {len(a) for _, a in leaves} or {0}
        if got != {n}:
            raise ValueError(f"{stack}: {sorted(got)} stacked layers, config {cfg.name} has {n}")
        for i in range(n):
            for path, arr in leaves:
                state[f"{stack}.{i}.{path}"] = _tensor(arr[i], dev)
    if cfg.family == "hybrid":
        for path, arr in _leaves(params["shared_attn"]):
            state[f"shared_attn.{path}"] = _tensor(arr, dev)
    return state


def _leaves(tree: dict, prefix: str = ""):
    """(dotted path, array) of every leaf of a nested dict."""
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _leaves(sub, f"{prefix}{name}.")
        else:
            yield prefix + name, sub


def _reference_key(name: str) -> tuple[str, int | None]:
    """A `DecoderLM` parameter name -> (the reference's tree path joined by
    "/", the layer index along its stacked L axis or None): e.g.
    "layers.3.attn.wq" -> ("layers/attn/wq", 3), "shared_attn.ln1" ->
    ("shared_attn/ln1", None), "embed" -> ("embed", None)."""
    parts = name.split(".")
    if parts[0] in ("layers", "dense_layers"):
        return "/".join([parts[0], *parts[2:]]), int(parts[1])
    return "/".join(parts), None


def reference_leaves(params) -> dict:
    """Group per-layer tensors (a `DecoderLM`'s parameters, or a parameter
    name -> tensor dict such as an optimizer moment dict) under the
    reference's tree paths: path -> tensor, or for a stacked leaf the list
    of its layers' tensors in layer order."""
    tensors = params if isinstance(params, dict) else dict(params.named_parameters())
    out: dict = {}
    for name, t in tensors.items():
        key, i = _reference_key(name)
        if i is None:
            out[key] = t
        else:
            out.setdefault(key, {})[i] = t
    return {k: v if isinstance(v, torch.Tensor) else [v[i] for i in sorted(v)]
            for k, v in out.items()}


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host, bf16 widened to f32 (exact)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def lm_params_to_reference(params) -> dict:
    """The reference's parameter tree from a `DecoderLM` (or a name ->
    tensor dict with its names, such as an optimizer moment dict): the
    inverse of `lm_params_from_reference`.  Per-layer tensors are stacked
    along a leading L axis under `layers` / `dense_layers`; leaves are numpy
    arrays, bf16 widened to f32 (cast back with the reference's dtypes)."""
    tree: dict = {}
    for key, v in reference_leaves(params).items():
        arr = np.stack([host_array(t) for t in v]) if isinstance(v, list) else host_array(v)
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree
