"""zamba2-7b [arXiv:2411.15242; unverified] Mamba2 + shared attn blocks
81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Hybrid: scanned Mamba2 groups with ONE shared attention+MLP block applied
every 6 layers (Zamba2 weight sharing)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    sub_quadratic=True,
)
