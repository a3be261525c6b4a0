"""Decoder-LM models: the dense GQA family of the reference's model zoo.

  config.py   -- ModelConfig: the reference's one dataclass for every family
  layers.py   -- RMSNorm, RoPE, SwiGLU, chunked-flash GQA attention (kernel
                 B10 on a multi-token cached forward), in-place KV cache
  model.py    -- DecoderLM (nn.Module): init / inference forward / prefill /
                 decode for dense configs; other families raise
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    DecoderLM,
    decode_step,
    forward_train,
    init_decode_cache,
    init_params,
    prefill,
)
