"""ModelConfig: a single config dataclass spanning all assigned families.

The port's own copy of the reference's `repro.models.config`, every field
and both counting methods as they are (`rope_theta` included), so that a
configuration means the same model in both packages
(`repro_torch.models.model` runs every family).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None           # default d_model // n_heads
    qk_norm: bool = False                 # qwen3-style per-head RMS on q/k
    rope_theta: float = 10_000.0

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                     # per-expert hidden dim
    capacity_factor: float = 1.25
    moe_every: int = 1                    # MoE layer every N layers (else dense)
    first_k_dense: int = 0                # deepseek: first k layers use dense MLP

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0                   # hybrid: shared attn block period
    shared_attn: bool = True              # zamba2: one attn param set reused

    # --- modality stubs ------------------------------------------------------
    frontend: str | None = None           # 'vision' | 'audio' | None
    n_frontend_tokens: int = 0            # prefix tokens fed as raw embeddings

    # --- execution -----------------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True              # False: unroll (exact cost analysis)
    opt_decode: bool = False              # §Perf: single-pass cache decode
    use_flash_kernel: bool = False        # §Perf: Pallas flash fwd (serving)
    attn_chunk: int = 1024                # flash-attention KV chunk
    sub_quadratic: bool = False           # eligible for long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.hd
        emb = v * d * 2  # embed + untied lm_head
        if self.family == "ssm":
            per = (
                self.d_model * 2 * self.d_inner        # in_proj (x, z)
                + self.d_model * 2 * self.ssm_heads * self.ssm_state  # B, C proj
                + self.d_model * self.ssm_heads        # dt proj
                + self.d_inner * self.ssm_conv
                + self.d_inner * self.d_model          # out proj
            )
            return emb + l * per
        if self.use_mla:
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        else:
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        dense_mlp = 3 * d * f
        per = attn + dense_mlp
        total = emb + l * per
        if self.n_experts:
            moe_mlp = 3 * d * self.moe_d_ff * self.n_experts + d * self.n_experts
            shared = 3 * d * self.moe_d_ff * self.n_shared_experts
            n_moe = l // self.moe_every
            total = emb + l * attn + (l - n_moe) * dense_mlp + n_moe * (moe_mlp + shared)
        if self.family == "hybrid" and self.attn_every:
            # mamba blocks + one shared attention block
            mamba_per = (
                d * 2 * self.d_inner
                + d * 2 * self.ssm_heads * self.ssm_state
                + d * self.ssm_heads
                + self.d_inner * self.ssm_conv
                + self.d_inner * d
            )
            attn_shared = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d + 3 * d * f
            total = emb + l * mamba_per + attn_shared
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.n_experts:
            return self.n_params()
        d, f, v, l = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.hd
        emb = v * d * 2
        if self.use_mla:
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        else:
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        active_mlp = 3 * d * self.moe_d_ff * (self.moe_top_k + self.n_shared_experts)
        n_moe = l // self.moe_every
        dense_mlp = 3 * d * f
        return int(emb + l * attn + (l - n_moe) * dense_mlp + n_moe * (active_mlp + d * self.n_experts))
