"""Parameter / batch / cache partition rules, as pure functions of names and shapes.

The port of `repro.models.sharding`, without devices: a mesh is a
description `{axis: size}` in the reference's axis order, and a spec is a
tuple in the reference's `PartitionSpec` order (an entry is None, an axis
name, or a tuple of two or more axis names).  The production meshes are the
reference's (`repro.launch.mesh.make_production_mesh`): `MESHES["pod"]`
(data 16 x model 16 = 256 chips) and `MESHES["multipod"]` (pod 2 x data 16
x model 16 = 512 chips); `MESHES["card"]` is one GPU, where every spec is
the identity (all None) and the one-GPU `Trainer` does without them.  The
consumer is the dry run (`launch.dryrun`), which reports per-chip bytes
from these specs.

Mesh axes:
  'pod'   -- pure data parallelism across pods (multi-pod mesh only)
  'data'  -- FSDP axis: batch AND parameter shards (ZeRO-style)
  'model' -- tensor/expert parallelism

Rules are matched on the parameter's path in the reference's tree
(`convert.reference_leaves` gives it for a `DecoderLM`); every leaf gets a
spec whose rank matches (the reference's stacked-layer leading dim gets
None, and the port's per-layer tensors drop it).
"""

from __future__ import annotations

import math

import torch

from repro_torch.convert import reference_leaves

MESHES: dict[str, dict[str, int]] = {
    "card": {},
    "pod": {"data": 16, "model": 16},
    "multipod": {"pod": 2, "data": 16, "model": 16},
}


def mesh_axes(mesh: dict) -> tuple:
    """(dp_axes, fsdp_axis, tp_axis) present in this mesh."""
    dp = tuple(a for a in ("pod", "data") if a in mesh)
    fsdp = "data" if "data" in mesh else None
    tp = "model" if "model" in mesh else None
    return dp, fsdp, tp


def n_chips(mesh: dict) -> int:
    return math.prod(mesh.values())


def _axes(names: tuple):
    """A spec entry over `names`: None, the one axis, or the tuple (the
    canonical form `PartitionSpec` gives a one-axis tuple)."""
    if not names:
        return None
    return names[0] if len(names) == 1 else names


_RULES: list[tuple[tuple[str, ...], tuple[str | None, ...]]] = [
    # (path suffix patterns, dims from the right: spec for each trailing dim)
    # embed/lm_head: vocab over TP only (the reference measured 16.8 GB of
    # all-reduce a step on yi-6b with d_model over 'data' as well)
    (("embed",), ("tp", None)),
    (("lm_head",), (None, "tp")),
    (("attn", "wq"), ("fsdp", "tp")),
    (("attn", "wk"), ("fsdp", "tp")),
    (("attn", "wv"), ("fsdp", "tp")),
    (("attn", "wo"), ("tp", "fsdp")),
    (("attn", "w_dq"), ("fsdp", None)),
    (("attn", "w_uq"), (None, "tp")),
    (("attn", "w_dkv"), ("fsdp", None)),
    (("attn", "w_ukv"), (None, "tp")),
    (("attn", "w_o"), ("tp", "fsdp")),
    (("mlp", "w_gate"), ("fsdp", "tp")),
    (("mlp", "w_up"), ("fsdp", "tp")),
    (("mlp", "w_down"), ("tp", "fsdp")),
    (("moe", "router"), ("fsdp", None)),
    (("moe", "w_gate"), ("tp", "fsdp", None)),
    (("moe", "w_up"), ("tp", "fsdp", None)),
    (("moe", "w_down"), ("tp", None, "fsdp")),
    (("moe", "shared_gate"), ("fsdp", "tp")),
    (("moe", "shared_up"), ("fsdp", "tp")),
    (("moe", "shared_down"), ("tp", "fsdp")),
    (("ssm", "in_proj"), ("fsdp", "tp")),
    (("ssm", "out_proj"), ("tp", "fsdp")),
    (("ssm", "conv_w"), (None, "tp")),
    (("ssm", "a_log"), ("tp",)),
    (("ssm", "dt_bias"), ("tp",)),
    (("ssm", "out_norm"), ("tp",)),
]


def fit_spec(spec: tuple, shape: tuple, mesh: dict) -> tuple:
    """Drop mesh axes that do not evenly divide the array dims (e.g. odd
    vocab sizes): even tiling only, replication is always legal.  The
    result has one entry per dim of `shape`."""
    out = []
    for i in range(len(shape)):
        axes = spec[i] if i < len(spec) else None
        if axes is None:
            out.append(None)
            continue
        ax = axes if isinstance(axes, tuple) else (axes,)
        while ax:
            size = math.prod(mesh[a] for a in ax)
            if shape[i] > 0 and shape[i] % size == 0:
                break
            ax = ax[:-1]
        if not ax:
            out.append(None)
        else:
            out.append(ax if len(ax) > 1 else ax[0])
    return tuple(out)


def param_spec_for(path_names: tuple[str, ...], ndim: int, mesh: dict) -> tuple:
    """The spec of the leaf at `path_names` (the reference's tree path) with
    `ndim` dims; () for a replicated one (norms, biases, scalars)."""
    dp, fsdp, tp = mesh_axes(mesh)
    ax = {"fsdp": fsdp, "tp": tp, None: None}
    for suffix, dims in _RULES:
        if path_names[-len(suffix):] == suffix:
            return tuple([None] * (ndim - len(dims)) + [ax[d] for d in dims])
    return ()


def param_specs(model, mesh: dict) -> dict[str, tuple]:
    """Every parameter of a `DecoderLM` (or a name -> tensor dict in its
    names) -> its fitted spec, one entry per dim: the reference's rule for
    the leaf's tree path, fitted to the reference's shape, with the
    stacked layer axis (always None) dropped from a per-layer tensor."""
    tensors = model if isinstance(model, dict) else dict(model.named_parameters())
    by_id = {id(t): name for name, t in tensors.items()}
    out: dict[str, tuple] = {}
    for key, leaf in reference_leaves(tensors).items():
        names = tuple(key.split("/"))
        if isinstance(leaf, list):
            shape = (len(leaf), *leaf[0].shape)
            spec = fit_spec(param_spec_for(names, len(shape), mesh), shape, mesh)
            for t in leaf:
                out[by_id[id(t)]] = spec[1:]
        else:
            out[by_id[id(leaf)]] = fit_spec(
                param_spec_for(names, leaf.dim(), mesh), tuple(leaf.shape), mesh)
    return out


def batch_spec(mesh: dict, seq_sharded: bool = False) -> tuple:
    """Spec for (B, S) token batches: batch over all DP axes."""
    dp, fsdp, tp = mesh_axes(mesh)
    return (_axes(dp), tp if seq_sharded else None)


def cache_spec(cfg, key: str, mesh: dict, batch: int) -> tuple:
    """Decode-cache specs.  KV-like buffers (L, B, S, H-ish, ...) shard batch
    over DP when divisible, else sequence over 'data'; head-ish dims over TP.
    SSM states (L, B, H, P, N) shard heads over TP."""
    dp, fsdp, tp = mesh_axes(mesh)
    dp_size = math.prod(mesh[a] for a in dp) if dp else 1
    batch_ok = dp and batch % dp_size == 0 and batch >= dp_size
    bdim = _axes(dp) if batch_ok else None
    sdim = None if batch_ok else fsdp
    if key in ("k", "v", "attn_k", "attn_v"):
        return (None, bdim, sdim, tp, None)
    if key in ("c_kv", "k_rope"):
        return (None, bdim, sdim, None)
    if key == "conv":
        return (None, bdim, None, tp)
    if key == "ssm":
        return (None, bdim, tp, None, None)
    return ()


def per_chip_bytes(shape, dtype: torch.dtype, spec: tuple, mesh: dict) -> int:
    """Bytes one chip holds of an array of `shape` and `dtype` laid out by
    the fitted `spec`: each sharded dim divided by its axes' sizes."""
    n = 1
    for i, d in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        if axes is not None:
            d //= math.prod(mesh[a] for a in (axes if isinstance(axes, tuple) else (axes,)))
        n *= d
    return n * dtype.itemsize
