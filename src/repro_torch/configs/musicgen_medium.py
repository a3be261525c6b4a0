"""musicgen-medium [arXiv:2306.05284; hf] decoder-only over EnCodec tokens
48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.
The EnCodec frontend is a STUB: inputs are already-quantized audio token ids."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio",
)
