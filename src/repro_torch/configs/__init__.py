"""Config registry: the 10 assigned architectures + the paper's own ANNS
workloads, and the per-arch input-shape cells.

  get_config("qwen3-8b")          -> ModelConfig (full published size)
  reduced_config(cfg)             -> tiny same-family config for CPU smokes
  SHAPES                          -> the 4 assigned input-shape cells
  iter_cells()                    -> all runnable (arch, shape) pairs

The port's own copy of the reference's registry (`repro.configs`), pure
data kept field for field, so that a name resolves to the same
configuration in both packages.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "phi3.5-moe-42b",
    "deepseek-v2-236b",
    "phi3-mini-3.8b",
    "mistral-large-123b",
    "yi-6b",
    "qwen3-8b",
    "llava-next-34b",
    "zamba2-7b",
    "mamba2-130m",
    "musicgen-medium",
]

_MODULES = {
    "phi3.5-moe-42b": "phi3_5_moe_42b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "mistral-large-123b": "mistral_large_123b",
    "yi-6b": "yi_6b",
    "qwen3-8b": "qwen3_8b",
    "llava-next-34b": "llava_next_34b",
    "zamba2-7b": "zamba2_7b",
    "mamba2-130m": "mamba2_130m",
    "musicgen-medium": "musicgen_medium",
}

# (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def cell_runnable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention (task spec): only SSM/hybrid
    run it; the 8 pure-full-attention archs skip (documented)."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, "skip: pure full-attention arch at 524k context"
    return True, ""


def iter_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = cell_runnable(cfg, shape)
            yield arch, shape, ok, why


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving tiny config for CPU smoke tests."""
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        dtype="float32",
        attn_chunk=64,
        remat=False,
    )
    if cfg.n_experts:
        changes.update(
            n_experts=min(cfg.n_experts, 8),
            moe_d_ff=64,
            n_shared_experts=min(cfg.n_shared_experts, 1),
            moe_top_k=min(cfg.moe_top_k, 2),
            first_k_dense=min(cfg.first_k_dense, 1),
        )
    if cfg.use_mla:
        changes.update(
            kv_lora_rank=32, q_lora_rank=48,
            qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, head_dim=None,
        )
    if cfg.family in ("ssm", "hybrid"):
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if cfg.family == "hybrid":
            changes.update(n_layers=5, attn_every=2)
    if cfg.frontend == "vision":
        changes.update(n_frontend_tokens=8)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
