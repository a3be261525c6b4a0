"""Dense decoder LM: init / inference forward / prefill / decode.

The port of `repro.models.model` for the dense GQA family (qwen3, yi,
phi3-mini, mistral-large).  The reference stacks layer parameters along a
leading L axis and scans them; here `DecoderLM` is an `nn.Module` with one
`DenseLayer` per layer, each holding its parameters in the reference's
layouts (`wq` is (d, h * hd) and applies as `x @ wq`, `w_down` is (f, d)),
so `convert.lm_params_from_reference` splits the stacked arrays into
per-layer tensors.  Weights are inference-only (no gradients, no remat,
no optimizer).

The KV cache is a dict of (L, B, S_max, KV, hd) tensors, updated in place
by slice assignment (`layers.gqa_attention`) where the reference's
`dynamic_update_slice` returns new arrays; `prefill` and `decode_step`
return the same dict they were given or made.

MoE, MLA, SSM, hybrid and frontend (vision / audio) configs raise
NotImplementedError naming ROADMAP.md queue A item 14.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gqa_attention, rms_norm, swiglu

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def check_dense(cfg: ModelConfig) -> None:
    """Refuse the families the port does not run yet."""
    what = None
    if cfg.family != "dense":
        what = f"family {cfg.family!r}"
    elif cfg.use_mla:
        what = "MLA attention"
    elif cfg.n_experts:
        what = "MoE layers"
    elif cfg.frontend is not None:
        what = f"the {cfg.frontend} frontend"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported to repro_torch yet; the port runs the "
            "dense GQA family (see ROADMAP.md queue A item 14)"
        )


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class DenseLayer(nn.Module):
    """One decoder layer: `attn` (wq, wk, wv, wo, + q_norm, k_norm), `mlp`
    (w_gate, w_up, w_down), `ln1`, `ln2` -- `_layer_params` of the
    reference, non-MoE branch."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        d, h, kvh, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
        attn = {
            "wq": (d, h * hd), "wk": (d, kvh * hd), "wv": (d, kvh * hd), "wo": (h * hd, d),
        }
        if cfg.qk_norm:
            attn.update(q_norm=(hd,), k_norm=(hd,))
        self.attn = nn.ParameterDict(
            {n: _param(s, device, dtype) for n, s in attn.items()})
        self.mlp = nn.ParameterDict({
            n: _param(s, device, dtype)
            for n, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))
        })
        self.ln1 = _param((d,), device, dtype)
        self.ln2 = _param((d,), device, dtype)

    def forward(self, x, positions, cfg, cache=None, cache_len=None):
        h = rms_norm(x, self.ln1)
        a, new_cache = gqa_attention(h, self.attn, positions, cfg, cache, cache_len)
        x = x + a
        h = rms_norm(x, self.ln2)
        m = swiglu(h, self.mlp["w_gate"], self.mlp["w_up"], self.mlp["w_down"])
        return x + m, new_cache


class DecoderLM(nn.Module):
    """`embed` (V, d), `layers`, `final_norm` (d,), untied `lm_head` (d, V).

    Parameters are allocated uninitialised on `device` (None means cuda, as
    for every entry point; `device="meta"` allocates nothing);
    `init_params` fills them from a generator and
    `load_state_dict(convert.lm_params_from_reference(...))` from the
    reference's tree.
    """

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        check_dense(cfg)
        if device is None or torch.device(device).type != "meta":
            device = resolve_device(device)
        dtype = torch_dtype(dtype or cfg.dtype)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = _param((v, d), device, dtype)
        self.final_norm = _param((d,), device, dtype)
        self.lm_head = _param((d, v), device, dtype)
        self.layers = nn.ModuleList(
            DenseLayer(cfg, device, dtype) for _ in range(cfg.n_layers))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=None) -> DecoderLM:
    """Random weights with the reference's distributions (`init_params`,
    `_dense_attn_params`, `_mlp_params`): normal, drawn in the weights'
    dtype, times 0.02 for the embedding, 1/sqrt(fan-in) for the projections;
    norm scales 1.  `generator` lives on `device`; the numbers differ from
    `jax.random`'s for the same seed."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, dev, dtype)
    d, f = cfg.d_model, cfg.d_ff

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=dev, dtype=p.dtype) * std)

    normal_(model.embed, 0.02)
    normal_(model.lm_head, 1.0 / math.sqrt(d))
    model.final_norm.fill_(1.0)
    for layer in model.layers:
        for name in ("wq", "wk", "wv", "wo"):
            normal_(layer.attn[name], 1.0 / math.sqrt(d))
        for name in ("q_norm", "k_norm"):
            if name in layer.attn:
                layer.attn[name].fill_(1.0)
        normal_(layer.mlp["w_gate"], 1.0 / math.sqrt(d))
        normal_(layer.mlp["w_up"], 1.0 / math.sqrt(d))
        normal_(layer.mlp["w_down"], 1.0 / math.sqrt(f))
        layer.ln1.fill_(1.0)
        layer.ln2.fill_(1.0)
    return model


def _positions(b: int, s: int, start, device) -> torch.Tensor:
    return (start + torch.arange(s, dtype=torch.int32, device=device)).expand(b, s)


@torch.no_grad()
def forward_train(params: DecoderLM, cfg: ModelConfig,
                  tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward, for inference: (logits (B, S, V), aux 0).

    The reference's training forward without remat, sharding or a loss."""
    check_dense(cfg)
    x = params.embed[tokens]
    b, s, _ = x.shape
    positions = _positions(b, s, 0, x.device)
    for layer in params.layers:
        x, _ = layer(x, positions, cfg)
    x = rms_norm(x, params.final_norm)
    return x @ params.lm_head, torch.zeros((), device=x.device)


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> dict:
    """The (empty) dense KV cache: {"k", "v"} of (L, B, max_len, KV, hd),
    on cuda unless `device` says otherwise."""
    check_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {n: torch.zeros(shape, dtype=torch_dtype(dtype), device=device) for n in ("k", "v")}


def _forward_cached(params: DecoderLM, cfg, x, positions, cache, cache_len):
    """Shared by prefill (S >= 1) and decode (S == 1): runs the stack
    against the cache, which each layer updates in place."""
    for i, layer in enumerate(params.layers):
        x, _ = layer(x, positions, cfg, (cache["k"][i], cache["v"][i]), cache_len)
    return x, cache


@torch.no_grad()
def prefill(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None,
            cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """Process the prompt, build the decode cache, return last-position
    logits (B, 1, V).  The cache offset is the Python int 0, so a multi-token
    prompt meets kernel B10 when `cfg.use_flash_kernel` is set."""
    check_dense(cfg)
    x = params.embed[tokens]
    b, s, _ = x.shape
    max_len = max_len or s
    positions = _positions(b, s, 0, x.device)
    cache = init_decode_cache(cfg, b, max_len, cache_dtype, x.device)
    x, cache = _forward_cached(params, cfg, x, positions, cache, 0)
    x = rms_norm(x[:, -1:], params.final_norm)
    return x @ params.lm_head, cache


@torch.no_grad()
def decode_step(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                cache_len: int | torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One autoregressive step against the cache: tokens (B, 1) at position
    `cache_len`; returns (logits (B, 1, V), the cache, updated in place)."""
    check_dense(cfg)
    x = params.embed[tokens]
    b, s, _ = x.shape
    positions = _positions(b, s, cache_len, x.device)
    x, cache = _forward_cached(params, cfg, x, positions, cache, cache_len)
    x = rms_norm(x, params.final_norm)
    return x @ params.lm_head, cache
