"""mamba2-130m [arXiv:2405.21060; unverified] SSD (state-space duality)
24L d_model=768 (attention-free) vocab=50280, ssm_state=128."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    sub_quadratic=True,
)
