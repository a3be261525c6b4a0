"""deepseek-v2-236b [arXiv:2405.04434; hf]
60L d_model=5120 128H, MLA kv_lora=512, expert d_ff=1536, vocab=102400,
MoE: 2 shared + 160 routed top-6, first layer dense (d_ff=12288)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,              # dense first layer
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    first_k_dense=1,
)
