"""Plain PyTorch oracles for every kernel contract of the reference.

Each function states the contract of one Pallas kernel of the JAX package
(`repro/kernels/ref.py` holds the jnp originals); tests feed both the same
numpy inputs and compare with a tolerance, because the two reduce f32 sums
in different orders.  Selection is always `torch.sort(..., stable=True)`
followed by a slice: `torch.topk` promises no order among equal values,
while the reference's `jax.lax.top_k` keeps the lower index.
"""

from __future__ import annotations

import torch

NCODES = 256


def _smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest along the last axis, ties by the lower index."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def adc_scan_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(M, 256) x (N, M) -> (N,) ADC distances."""
    m = lut.shape[0]
    cols = torch.arange(m, device=lut.device)
    return lut[cols[None, :], codes.long()].sum(-1)


def adc_scan_flat_ref(ext_lut: torch.Tensor, addrs: torch.Tensor) -> torch.Tensor:
    """(A,) x (N, W) direct-address scan -> (N,)."""
    return ext_lut[addrs.long()].sum(-1)


def _mask_valid(d: torch.Tensor, n_valid: int | torch.Tensor | None) -> torch.Tensor:
    if n_valid is None:
        return d
    valid = torch.arange(d.shape[-1], device=d.device) < torch.as_tensor(
        n_valid, device=d.device
    )
    return torch.where(valid[None, :], d, torch.inf)


def adc_topk_ref(
    lut: torch.Tensor,
    codes: torch.Tensor,
    k: int,
    n_valid: int | torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + k smallest.  luts (Q, M, 256), codes (N, M) ->
    (Q, k) values, (Q, k) int32 indices (ascending by distance)."""
    d = torch.stack([adc_scan_ref(t, codes) for t in lut])  # (Q, N)
    return _smallest(_mask_valid(d, n_valid), k)


def adc_topk_flat_ref(
    ext_lut: torch.Tensor,
    addrs: torch.Tensor,
    k: int,
    n_valid: int | torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Direct-address fused scan + top-k.  ext_lut (Q, A), addrs (N, W)."""
    d = torch.stack([adc_scan_flat_ref(e, addrs) for e in ext_lut])
    return _smallest(_mask_valid(d, n_valid), k)


def rerank_dists_ref(queries: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (Q, K, D) -> (Q, K) exact f32 squared-L2 distances."""
    diff = cand.float() - queries.float()[:, None, :]
    return (diff * diff).sum(-1)


def lut_build_ref(codebook: torch.Tensor, qmc: torch.Tensor) -> torch.Tensor:
    """(M, 256, dsub) x (Q, M, dsub) -> (Q, M, 256) squared-L2 LUTs."""
    diff = qmc[:, :, None, :] - codebook[None, :, :, :]
    return (diff * diff).sum(-1)


def ext_lut_build_ref(
    lut: torch.Tensor, combo_cols: torch.Tensor, combo_codes: torch.Tensor
) -> torch.Tensor:
    """(Q, M, 256) + combos (m, L) -> (Q, M*256 + m + 1) flat tables."""
    q = lut.shape[0]
    sums = lut[:, combo_cols.long(), combo_codes.long()].sum(-1)  # (Q, m)
    zero = torch.zeros((q, 1), dtype=lut.dtype, device=lut.device)
    return torch.cat([lut.reshape(q, -1), sums, zero], dim=-1)


def adc_topk_tiles_ref(
    luts: torch.Tensor,
    codes: torch.Tensor,
    starts: torch.Tensor,
    n_valid: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain tiles scan: per pair, ADC over its valid rows, k smallest.

    luts (P, M, 256) f32; codes (cap, M) uint8 raw codes; starts (P,) first
    code row of each pair's cluster slot; n_valid (P,) its valid rows.
    Returns ((P, k) f32 distances, (P, k) int32 window rows), ordered by
    (distance, row) -- a stable sort over rows in ascending order.  Lanes
    past a pair's valid rows are (+inf, -1).  This is what the tile kernel
    returns per pair when no bound is given (every pair its own query).
    """
    p = luts.shape[0]
    out_v = torch.full((p, k), torch.inf, dtype=torch.float32, device=luts.device)
    out_i = torch.full((p, k), -1, dtype=torch.int32, device=luts.device)
    for i in range(p):
        nv = int(n_valid[i])
        if nv <= 0:
            continue
        s = int(starts[i])
        d = adc_scan_ref(luts[i], codes[s : s + nv])
        v, r = _smallest(d, min(k, nv))
        out_v[i, : v.shape[0]] = v
        out_i[i, : r.shape[0]] = r
    return out_v, out_i
