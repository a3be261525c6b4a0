"""Common decoder layers: RMSNorm, RoPE, SwiGLU, chunked-flash GQA attention.

The port of `repro.models.layers`, dtype for dtype: `rms_norm` and
`apply_rope` compute in f32 and cast back, RoPE rotates the two halves of
the head (not interleaved pairs), `swiglu` stays in the weights' dtype.
Attention is an online-softmax loop over KV chunks of `cfg.attn_chunk`, so
a long prefill never materialises an (S, S) score matrix; a multi-token
forward against a KV cache goes to kernel B10
(`kernels.ops.flash_attention_fwd`) under the reference's gate.  The
projections are plain `torch.matmul`, as the reference leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import online_softmax_step


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _flash_chunk_scan(
    q: torch.Tensor,                       # (B, Sq, H, hd)
    k: torch.Tensor,                       # (B, Sk, KV, hd)
    v: torch.Tensor,                       # (B, Sk, KV, vd)
    q_pos: torch.Tensor,                   # (B, Sq) absolute positions of queries
    kv_valid_len: torch.Tensor | None,     # (B,) or None: causal vs cache length
    chunk: int,
    scale: float,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks; causal by absolute position.

    The reference pads the last chunk with zero keys, which the causal
    mask (or the cache length) always hides; here the last chunk is a
    shorter slice, which gives the same sums.  Returns f32.
    """
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    groups = h // kvh
    chunk = min(chunk, sk)
    dev = q.device
    qg = (q.float() * scale).reshape(b, sq, kvh, groups, hd)
    m = torch.full((b, sq, kvh, groups), -torch.inf, device=dev)
    l = torch.zeros((b, sq, kvh, groups), device=dev)
    acc = torch.zeros((b, sq, kvh, groups, vd), device=dev)
    for start in range(0, sk, chunk):
        kc, vc = k[:, start : start + chunk], v[:, start : start + chunk]
        kpos = start + torch.arange(kc.shape[1], device=dev)
        mask = kpos[None, None, :] <= q_pos[:, :, None]          # (B, Sq, chunk)
        if kv_valid_len is not None:
            mask = mask & (kpos[None, None, :] < kv_valid_len[:, None, None])
        m, l, acc = online_softmax_step(
            qg, kc, vc, mask[:, :, None, None, :], m, l, acc,
            "bqkgd,bckd->bqkgc", "bqkgc,bckd->bqkgd",
        )
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, sq, h, vd)


def _flash_decode(
    q: torch.Tensor,            # (B, 1, H, hd)
    ck: torch.Tensor,           # (B, S_max, KV, hd) -- the cache, read in place
    cv: torch.Tensor,           # (B, S_max, KV, vd)
    valid_len: torch.Tensor,    # (B,)
    chunk: int,
    scale: float,
) -> torch.Tensor:
    """Single-token decode attention over chunks that are views of the cache
    (the reference's `opt_decode` path).  Returns f32."""
    b, _, h, hd = q.shape
    s_max, kvh = ck.shape[1], ck.shape[2]
    vd = cv.shape[-1]
    groups = h // kvh
    chunk = min(chunk, s_max)
    dev = q.device
    qg = q.float().reshape(b, kvh, groups, hd) * scale
    m = torch.full((b, kvh, groups), -torch.inf, device=dev)
    l = torch.zeros((b, kvh, groups), device=dev)
    acc = torch.zeros((b, kvh, groups, vd), device=dev)
    for start in range(0, s_max, chunk):
        kc, vc = ck[:, start : start + chunk], cv[:, start : start + chunk]
        kpos = start + torch.arange(kc.shape[1], device=dev)
        mask = kpos[None, :] < valid_len[:, None]                # (B, chunk)
        m, l, acc = online_softmax_step(
            qg, kc, vc, mask[:, None, None, :], m, l, acc,
            "bkgd,bckd->bkgc", "bkgc,bckd->bkgd",
        )
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, 1, h, vd)


def gqa_attention(
    x: torch.Tensor,                        # (B, S, D)
    params,                                 # wq, wk, wv, wo (+ q_norm, k_norm)
    positions: torch.Tensor,                # (B, S)
    cfg,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_len: int | torch.Tensor | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """GQA attention with RoPE, optional qk-norm, optional KV cache.

    Without a cache: self-attention over x; returns this block's (k, v).
    With one: kv_cache is a pair of (B, S_max, KV, hd) buffers holding
    `cache_len` valid positions; this step's k / v are written at
    [cache_len, cache_len + S) **in place**, by slice assignment where the
    reference's `dynamic_update_slice` returns new buffers, and the same
    buffers are returned.  Attention runs over the valid prefix.
    """
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kvh, hd)
    v = (x @ params["wv"]).reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    scale = 1.0 / hd**0.5
    if kv_cache is None:
        out = _flash_chunk_scan(q, k, v, positions, None, cfg.attn_chunk, scale)
        new_cache = (k, v)
    else:
        ck, cv = kv_cache
        start = int(cache_len)
        ck[:, start : start + s] = k.to(ck.dtype)
        cv[:, start : start + s] = v.to(cv.dtype)
        valid = torch.full((b,), start + s, dtype=torch.int32, device=x.device)
        # the reference's gate for kernel B10: a multi-token forward whose
        # cache offset is static.  In eager PyTorch a Python int offset is
        # the counterpart of JAX's static one: it is known on the host
        # (prefill passes 0); a tensor offset, as a traced decode step
        # would carry, keeps the chunked scan
        if s == 1 and cfg.opt_decode:
            out = _flash_decode(q, ck, cv, valid, cfg.attn_chunk, scale)
        elif (
            cfg.use_flash_kernel
            and s > 1
            and isinstance(cache_len, int)
            and s % min(512, s) == 0
            and ck.shape[1] % min(512, ck.shape[1]) == 0
        ):
            out = ops.flash_attention_fwd(
                q, ck, cv, scale=scale, q_offset=cache_len, kv_valid=cache_len + s,
                bq=min(512, s), bk=min(512, ck.shape[1]),
            )
        else:
            out = _flash_chunk_scan(q, ck, cv, positions, valid, cfg.attn_chunk, scale)
        new_cache = (ck, cv)
    # the reference's einsum promotes bf16 weights to an f32 attention output
    wo = params["wo"]
    o = out.reshape(b, s, h * hd) @ wo.to(out.dtype)
    return o.to(x.dtype), new_cache
