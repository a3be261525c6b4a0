"""Kernel B10 (causal GQA flash-attention forward): plain version and launcher.

The CUDA source is `csrc/flash_attn.cu`; `ops.flash_attention_fwd` is the
wrapper.  Layout as the reference's `repro.kernels.flash_attn`: q
(B, Sq, H, hd), k and v (B, Sk, KV, hd), query head h reading KV head
h // (H / KV); the output is (B, Sq, H, hd) in q's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# head dims the fast kernel is instantiated for (every GQA config in the
# registry: 128 for qwen3 / yi / mistral / phi3.5-moe / llava, 112 for
# zamba2's shared block, 96 for phi3-mini, 64 for musicgen, 16 reduced);
# every other head dim, and tensors not 16-byte aligned, take the general
# kernel (`kernel_variant`)
HEAD_DIMS = (16, 32, 64, 96, 112, 128)
# the widest head dim the general kernel stages by `cp.async` (eight warps
# of 128 columns a row tile); past it, element copies in slices
STAGED_HD_MAX = 1024
# csrc/flash_attn.cu's `variant` argument
VARIANTS = {"fast": 0, "staged": 1, "general": 2}


def tf32_passes(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> tuple[int, int]:
    """TF32 tensor-core passes the kernel runs for (Q.K^T, P.V): an f32
    operand is split into hi + lo and a bf16 one is exact in TF32, so Q.K^T
    takes 1 + (q is f32) + (k is f32) passes and P.V 2 + (v is f32)."""
    f32q, f32kv = q_dtype == torch.float32, kv_dtype == torch.float32
    return 1 + f32q + f32kv, 2 + f32kv


def kernel_variant(hd: int, *tensors: torch.Tensor) -> str:
    """The CUDA kernel a call runs: "fast" (the `cp.async` ring, head dims
    of `HEAD_DIMS`, every tensor 16-byte aligned); else the general kernel
    (`general_shape`), "staged" (its rows by `cp.async` in the same ring:
    every tensor 16-byte aligned, every row of hd elements a multiple of 16
    bytes, hd <= `STAGED_HD_MAX`) or "general" (element copies: any head
    dim and offset)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    if hd in HEAD_DIMS and aligned:
        return "fast"
    rows = all(hd * t.element_size() % 16 == 0 for t in tensors)
    return "staged" if aligned and rows and hd <= STAGED_HD_MAX else "general"


def general_shape(hd: int, variant: str) -> dict:
    """The general kernel's instance for head dim hd (csrc/flash_attn.cuh
    `general_shape`): `wpr` warps a row tile of `cw` head-dim columns each
    (hd padded to wpr * cw), `rows` (position, head) rows and `keys` keys a
    tile.  "staged": one warp up to 128 (hd rounded up to 48, 64, 80 or
    128), two up to 256, four up to 512, eight up to 1024 (128 columns
    each); "general": one, two or eight warps of 128 columns (slices of
    1024 past 1024)."""
    if hd > 128:
        wpr = 2 if hd <= 256 else (4 if hd <= 512 and variant == "staged" else 8)
        cw = 128
    else:
        wpr = 1
        cw = 128 if variant == "general" else next(c for c in (48, 64, 80, 128) if hd <= c)
    return dict(wpr=wpr, cw=cw, rows=16 * 8 // wpr, keys=64 // wpr)


def online_softmax_step(qg, kc, vc, mask, m, l, acc, s_eq, pv_eq):
    """One KV block of the online softmax, in f32: scores by `s_eq`, then
    `online_softmax_update`.  Shared by this plain version and the models'
    chunked scans."""
    return online_softmax_update(torch.einsum(s_eq, qg, kc.float()), mask, vc, m, l, acc, pv_eq)


def online_softmax_update(s, mask, vc, m, l, acc, pv_eq):
    """The online softmax's update from one block's f32 scores `s`: masked
    to -inf, the running max with the -inf guard on fully masked rows, the
    rescaled sum and accumulator (values by `pv_eq`).  MLA's decode scan
    passes the sum of its two score products."""
    s = torch.where(mask, s, -torch.inf)
    m_new = torch.maximum(m, s.amax(-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum(pv_eq, p, vc.float())
    return m_new, l, acc


def flash_attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    q_offset: int = 0,
    kv_valid: int | None = None,
    bq: int = 512,
    bk: int = 512,
) -> torch.Tensor:
    """The Pallas kernel's online softmax over (bq, bk) blocks, in f32.

    Query block qi meets key block ki only when the reference's `any_live`
    holds (ki * bk <= q_offset + qi * bq + bq - 1 and ki * bk < kv_valid);
    inside a block the mask is k_pos <= q_pos and k_pos < kv_valid.  Each
    query block carries its running max, sum and accumulator across the
    key blocks in order, with the -inf guard on the max.
    """
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    bq, bk = min(bq, sq), min(bk, sk)
    kv_valid = sk if kv_valid is None else kv_valid
    dev = q.device
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    for q0 in range(0, sq, bq):
        qb = (q[:, q0 : q0 + bq].float() * scale).reshape(b, -1, kvh, g, hd)
        n = qb.shape[1]
        q_pos = q_offset + q0 + torch.arange(n, device=dev)
        m = torch.full((b, n, kvh, g), -torch.inf, device=dev)
        l = torch.zeros((b, n, kvh, g), device=dev)
        acc = torch.zeros((b, n, kvh, g, hd), device=dev)
        for k0 in range(0, sk, bk):
            if not (k0 <= q_offset + q0 + bq - 1 and k0 < kv_valid):
                continue
            kb, vb = k[:, k0 : k0 + bk], v[:, k0 : k0 + bk]
            k_pos = k0 + torch.arange(kb.shape[1], device=dev)
            mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos < kv_valid)[None, :]
            m, l, acc = online_softmax_step(
                qb, kb, vb, mask[None, :, None, None, :], m, l, acc,
                "bqkgd,bckd->bqkgc", "bqkgc,bckd->bqkgd",
            )
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0 : q0 + bq] = o.reshape(b, n, h, hd).to(q.dtype)
    return out


def causal_pairs(sq: int, q_offset: int, kv_valid: int) -> int:
    """(query, key) pairs a head's causal rows see: query i at position
    q_offset + i meets keys j <= q_offset + i with j < kv_valid, so the sum
    over i < sq of min(q_offset + i + 1, kv_valid), in closed form."""
    n_lin = max(0, min(sq, kv_valid - q_offset))
    return n_lin * q_offset + n_lin * (n_lin + 1) // 2 + (sq - n_lin) * kv_valid


def flash_flops(b: int, sq: int, h: int, hd: int, q_offset: int, kv_valid: int) -> int:
    """FLOPs of one B10 call's two products (Q.K^T and P.V) over the live
    causal pairs, an FMA as two: the work its FP32 bound counts."""
    return 4 * b * h * hd * causal_pairs(sq, q_offset, kv_valid)


def flash_hbm_bytes_per_layer(
    b: int, sq: int, sk: int, h: int, kvh: int, hd: int,
    bq: int = 512, dtype_bytes: int = 2, kv_dtype_bytes: int | None = None,
) -> int:
    """Analytic HBM traffic of one kernel invocation (the port of the
    reference's `flash_hbm_bytes_per_layer`, equal at its arguments): Q+O
    once; K+V streamed once per q-block.  `kv_dtype_bytes` (default
    `dtype_bytes`) sizes K and V where their dtype differs from q's."""
    kv_bytes = dtype_bytes if kv_dtype_bytes is None else kv_dtype_bytes
    nq = max(sq // bq, 1)
    q_o = 2 * b * sq * h * hd * dtype_bytes
    kv = 2 * b * sk * kvh * hd * kv_bytes * nq
    return q_o + kv


def kernel_attributes(hd: int, q_dtype: torch.dtype, kv_dtype: torch.dtype,
                      variant: str = "fast") -> dict:
    """The kernel instance's registers, spilled (local) bytes per thread and
    dynamic shared memory bytes, from the CUDA runtime (builds the library);
    `variant` as `kernel_variant` gives it."""
    out = (ctypes.c_int * 3)()
    err = _build.library().flash_attn_attributes(
        hd, int(q_dtype == torch.bfloat16), int(kv_dtype == torch.bfloat16),
        VARIANTS[variant], out)
    _build.check(err, "flash_attn_attributes")
    return dict(registers=out[0], spill_bytes=out[1], smem_bytes=out[2])


def launch(q, k, v, out, scale: float, q_offset: int, kv_valid: int) -> None:
    """Enqueue `csrc/flash_attn.cu` on the current stream (checked inputs;
    the kernel `kernel_variant` picks)."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    variant = VARIANTS[kernel_variant(hd, q, k, v, out)]
    err = _build.library().flash_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, h, kvh,
        hd, q_offset, kv_valid, int(q.dtype == torch.bfloat16),
        int(k.dtype == torch.bfloat16), float(scale), variant,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attn")
