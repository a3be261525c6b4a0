"""llava-next-34b [hf:llava-hf/llava-v1.6; unverified] anyres tiling
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Vision frontend is a STUB: input_specs() supplies precomputed patch
embeddings (anyres: base 576 + one 576-patch tile = 1152 prefix tokens)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision",
    n_frontend_tokens=1152,
)
