"""Decoder-LM models: every family of the reference's model zoo.

  config.py   -- ModelConfig: the reference's one dataclass for every family
  layers.py   -- RMSNorm, RoPE, SwiGLU, chunked-flash GQA attention (kernel
                 B10 on a multi-token cached forward), in-place KV cache
  moe.py      -- top-k routing, capacity dispatch, shared experts, aux loss
  mla.py      -- multi-head latent attention (absorbed form, latent cache)
  ssm.py      -- Mamba2: chunked SSD scan, conv state, one-step decode
  model.py    -- DecoderLM (nn.Module): init / differentiable forward (remat)
                 / prefill / decode for dense, MoE, MLA, SSM, hybrid and
                 stub-frontend configs
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
