"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port of `repro.models.mla`.  K and V come from a shared low-rank latent
c_kv (kv_lora_rank dims) plus a decoupled RoPE key shared across heads;
queries from their own low-rank latent.  The cache holds only (c_kv,
k_rope), updated in place as the GQA cache is (`layers.gqa_attention`),
and attention runs in the absorbed form: the no-pe query is mapped into
the latent space, scores are q_lat . c_kv + q_rope . k_rope, and the value
IS the latent, mapped out per head after the softmax.  MLA reaches no
Pallas kernel in the reference, so no kernel here either: prefill and
the chunked decode go through `layers._flash_chunk_scan` (value dim R,
score dim R + dr), `opt_decode` through `_mla_flash_decode`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import online_softmax_update
from repro_torch.models.layers import _flash_chunk_scan, apply_rope, rms_norm


def _project_q(x, params, cfg):
    """x (B, S, D) -> q_nope (B, S, H, dn), q_rope (B, S, H, dr)."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(x @ params["w_dq"], params["q_norm"])         # (B, S, q_lora)
    q = (cq @ params["w_uq"]).reshape(b, s, h, dn + dr)
    return q[..., :dn], q[..., dn:]


def _project_kv_latent(x, params, cfg, positions):
    """x -> (c_kv (B, S, R), k_rope (B, S, 1, dr) roped)."""
    r = cfg.kv_lora_rank
    ckv_kr = x @ params["w_dkv"]                                # (B, S, R + dr)
    c_kv = rms_norm(ckv_kr[..., :r], params["kv_norm"])
    k_rope = apply_rope(ckv_kr[..., r:][:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope


def _mla_flash_decode(
    q_lat: torch.Tensor,      # (B, H, R) absorbed no-pe queries
    q_rope: torch.Tensor,     # (B, H, dr)
    cc: torch.Tensor,         # (B, S_max, R) latent cache, read in place
    ck: torch.Tensor,         # (B, S_max, dr) rope-key cache
    valid_len: torch.Tensor,  # (B,)
    chunk: int,
    scale: float,
) -> torch.Tensor:
    """Single-token decode over chunks that are views of the two caches,
    without concatenating them: scores are the sum of two contractions and
    the value is the latent chunk.  Each chunk is [start, start + chunk)
    cut at S_max; the reference clamps a ragged last chunk's start and so
    scores earlier keys under the masked positions (ROADMAP C10).  Returns
    (B, 1, H, R) f32."""
    b, h, r = q_lat.shape
    s_max = cc.shape[1]
    chunk = min(chunk, s_max)
    dev = q_lat.device
    ql = q_lat.float() * scale
    qr = q_rope.float() * scale
    m = torch.full((b, h), -torch.inf, device=dev)
    l = torch.zeros((b, h), device=dev)
    acc = torch.zeros((b, h, r), device=dev)
    for start in range(0, s_max, chunk):
        cci, cki = cc[:, start : start + chunk].float(), ck[:, start : start + chunk]
        s = torch.einsum("bhr,bcr->bhc", ql, cci) + torch.einsum("bhe,bce->bhc", qr, cki.float())
        kpos = start + torch.arange(cci.shape[1], device=dev)
        mask = (kpos[None, :] < valid_len[:, None])[:, None, :]  # (B, 1, chunk)
        m, l, acc = online_softmax_update(s, mask, cci, m, l, acc, "bhc,bcr->bhr")
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out[:, None]


def mla_attention(
    x: torch.Tensor,
    params,
    positions: torch.Tensor,
    cfg,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_len: int | torch.Tensor | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """MLA forward.  Without a cache: causal self-attention over x; returns
    this block's (c_kv (B, S, R), k_rope (B, S, dr)).  With one: cache =
    (c_kv (B, S_max, R), k_rope (B, S_max, dr)) holding `cache_len` valid
    positions; this step's latents are written at [cache_len, cache_len +
    S) in place and the same buffers are returned."""
    b, s, d = x.shape
    h = cfg.n_heads
    dn, dr, dv, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank

    q_nope, q_rope = _project_q(x, params, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _project_kv_latent(x, params, cfg, positions)

    w_ukv = params["w_ukv"].reshape(r, h, dn + dv)
    w_uk, w_uv = w_ukv[..., :dn], w_ukv[..., dn:]               # (R, H, dn), (R, H, dv)
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, w_uk)         # (B, S, H, R)
    q_cat = torch.cat([q_lat, q_rope], dim=-1)                  # (B, S, H, R + dr)

    scale = 1.0 / (dn + dr) ** 0.5
    if cache is None:
        k_cat = torch.cat([c_kv[:, :, None, :], k_rope], dim=-1)  # (B, S, 1, R + dr)
        o_lat = _flash_chunk_scan(q_cat, k_cat, k_cat[..., :r], positions, None,
                                  cfg.attn_chunk, scale)          # (B, S, H, R)
        cache = (c_kv, k_rope[:, :, 0, :])
    else:
        cc, ck = cache
        start = int(cache_len)
        cc[:, start : start + s] = c_kv.to(cc.dtype)
        ck[:, start : start + s] = k_rope[:, :, 0, :].to(ck.dtype)
        kv_len = torch.full((b,), start + s, dtype=torch.int32, device=x.device)
        if s == 1 and cfg.opt_decode:
            o_lat = _mla_flash_decode(q_lat[:, 0], q_rope[:, 0], cc, ck, kv_len,
                                      cfg.attn_chunk, scale)
        else:
            k_cat = torch.cat([cc[:, :, None, :], ck[:, :, None, :]], dim=-1)
            o_lat = _flash_chunk_scan(q_cat, k_cat, k_cat[..., :r], positions, kv_len,
                                      cfg.attn_chunk, scale)
    # the reference's einsums promote the bf16 weights to the f32 latent output
    o = torch.einsum("bshr,rhe->bshe", o_lat, w_uv.to(o_lat.dtype))  # (B, S, H, dv)
    out = o.reshape(b, s, h * dv) @ params["w_o"].to(o.dtype)
    return out.to(x.dtype), cache
