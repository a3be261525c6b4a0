"""Decoder LMs of every family: init / inference forward / prefill / decode.

The port of `repro.models.model` for the whole registry: dense GQA (qwen3,
yi, phi3-mini, mistral-large), MoE (phi3.5-moe) and MLA + MoE with shared
experts and leading dense layers (deepseek-v2), Mamba2 SSD (mamba2), the
Zamba2 hybrid (groups of Mamba2 layers, one shared attention + MLP block
after each group), and the vision / audio stubs (llava-next takes a prefix
of precomputed embeddings, musicgen token ids).  The reference stacks layer
parameters along a leading L axis and scans them; here `DecoderLM` is an
`nn.Module` with one module per layer -- `AttnLayer` (GQA or MLA
attention, then a SwiGLU MLP or an MoE block) or `MambaLayer` -- each
holding its parameters in the reference's layouts (`wq` is (d, h * hd) and
applies as `x @ wq`, an expert's `w_down` is (E, f, d)), so
`convert.lm_params_from_reference` splits the stacked arrays into
per-layer tensors.  Parameters are created with `requires_grad=False` for
serving; the trainer (`training.trainer`) turns gradients on.
`forward_train` follows the caller's grad mode and returns the logits and
the summed MoE aux loss; under `cfg.remat` and with gradients on, each
layer module runs under `torch.utils.checkpoint` (recomputed in the
backward), as the reference checkpoints each layer body -- not the
hybrid's shared block, which the reference does not checkpoint either.

The decode cache is a dict of tensors with a leading layer (or group)
axis, updated in place: the GQA cache by slice assignment
(`layers.gqa_attention`), the MLA latents likewise (`mla.mla_attention`),
the Mamba2 conv window and SSM state by copy; `prefill` and `decode_step`
return the same dict they were given or made.  The model copies the
reference's choices as they are: `moe_every` is not read (every layer
after `first_k_dense` is MoE), and a one-token SSM prefill takes the decode
recurrence.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gqa_attention, rms_norm, swiglu
from repro_torch.models.mla import mla_attention
from repro_torch.models.moe import moe_block
from repro_torch.models.ssm import mamba2_block

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


def _params(shapes: dict, device, dtype) -> nn.ParameterDict:
    """A table (below) -> its uninitialised parameters; "f32" marks one the
    reference keeps in f32 whatever the model's dtype."""
    return nn.ParameterDict({
        n: _param(shape, device, torch.float32 if "f32" in spec else dtype)
        for n, (shape, *spec) in shapes.items()})


# Each table maps a parameter to (shape, init[, "f32"]): init is the std of
# a normal draw or "1" / "0" for a constant fill, and "f32" keeps the
# reference's f32 dtype (`_dense_attn_params`, `_mla_params`, `_mlp_params`,
# `_moe_params`, `_mamba_params`).


def _gqa_table(cfg: ModelConfig) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    std = 1.0 / math.sqrt(d)
    t = {"wq": ((d, h * hd), std), "wk": ((d, kvh * hd), std),
         "wv": ((d, kvh * hd), std), "wo": ((h * hd, d), std)}
    if cfg.qk_norm:
        t.update(q_norm=((hd,), "1"), k_norm=((hd,), "1"))
    return t


def _mla_table(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": ((d, qr), 1 / math.sqrt(d)),
        "w_uq": ((qr, h * (dn + dr)), 1 / math.sqrt(qr)),
        "w_dkv": ((d, r + dr), 1 / math.sqrt(d)),
        "w_ukv": ((r, h * (dn + dv)), 1 / math.sqrt(r)),
        "w_o": ((h * dv, d), 1 / math.sqrt(h * dv)),
        "q_norm": ((qr,), "1"), "kv_norm": ((r,), "1"),
    }


def _mlp_table(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": ((d, f), 1 / math.sqrt(d)), "w_up": ((d, f), 1 / math.sqrt(d)),
            "w_down": ((f, d), 1 / math.sqrt(f))}


def _moe_table(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    t = {"router": ((d, e), 1 / math.sqrt(d), "f32"),
         "w_gate": ((e, d, f), 1 / math.sqrt(d)), "w_up": ((e, d, f), 1 / math.sqrt(d)),
         "w_down": ((e, f, d), 1 / math.sqrt(f))}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        t.update(shared_gate=((d, fs), 1 / math.sqrt(d)), shared_up=((d, fs), 1 / math.sqrt(d)),
                 shared_down=((fs, d), 1 / math.sqrt(fs)))
    return t


def _mamba_table(cfg: ModelConfig) -> dict:
    d, di, h, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv
    return {
        "in_proj": ((d, 2 * di + 2 * h * n + h), 1 / math.sqrt(d)),  # z | x | B | C | dt
        "conv_w": ((k, di + 2 * h * n), 1 / math.sqrt(k)),
        "dt_bias": ((h,), "0", "f32"), "a_log": ((h,), "0", "f32"),
        "out_norm": ((di,), "1"), "out_proj": ((di, d), 1 / math.sqrt(di)),
    }


class AttnLayer(nn.Module):
    """One attention layer: `attn` (GQA: wq, wk, wv, wo, + q_norm, k_norm;
    MLA: w_dq, w_uq, w_dkv, w_ukv, w_o, q_norm, kv_norm), then `mlp`
    (w_gate, w_up, w_down) or, with `moe`, `moe` (router, stacked experts,
    shared experts), `ln1`, `ln2` -- the reference's `_layer_params` (also
    Zamba2's shared block, `_attn_mlp_block_params`)."""

    def __init__(self, cfg: ModelConfig, moe: bool, device=None, dtype=None):
        super().__init__()
        self.tables = {"attn": _mla_table(cfg) if cfg.use_mla else _gqa_table(cfg),
                       "moe" if moe else "mlp": _moe_table(cfg) if moe else _mlp_table(cfg)}
        for name, table in self.tables.items():
            setattr(self, name, _params(table, device, dtype))
        self.ln1 = _param((cfg.d_model,), device, dtype)
        self.ln2 = _param((cfg.d_model,), device, dtype)

    def forward(self, x, positions, cfg, cache=None, cache_len=None):
        """(x + attention + MLP or MoE, the cache (or this block's k / v or
        latents), the MoE aux loss (0 without MoE))."""
        attention = mla_attention if cfg.use_mla else gqa_attention
        a, new_cache = attention(rms_norm(x, self.ln1), self.attn, positions, cfg, cache,
                                 cache_len)
        x = x + a
        h = rms_norm(x, self.ln2)
        if "moe" in self.tables:
            m, aux = moe_block(h, self.moe, cfg.n_experts, cfg.moe_top_k, cfg.capacity_factor,
                               cfg.n_shared_experts)
        else:
            m = swiglu(h, self.mlp["w_gate"], self.mlp["w_up"], self.mlp["w_down"])
            aux = torch.zeros((), device=x.device)
        return x + m, new_cache, aux


class MambaLayer(nn.Module):
    """One Mamba2 layer: `ssm` (in_proj, conv_w, dt_bias, a_log, out_norm,
    out_proj) after the pre-norm `ln1`."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        self.tables = {"ssm": _mamba_table(cfg)}
        self.ssm = _params(self.tables["ssm"], device, dtype)
        self.ln1 = _param((cfg.d_model,), device, dtype)

    def forward(self, x, cfg, state=None):
        out, new_state = mamba2_block(rms_norm(x, self.ln1), self.ssm, cfg, state)
        return x + out, new_state


def n_dense_layers(cfg: ModelConfig) -> int:
    """Leading dense layers of an MoE stack (deepseek's `first_k_dense`)."""
    return cfg.first_k_dense if cfg.n_experts else 0


class DecoderLM(nn.Module):
    """`embed` (V, d), `dense_layers`, `layers`, for the hybrid
    `shared_attn`, `final_norm` (d,), untied `lm_head` (d, V).

    `layers` are Mamba2 layers for the ssm and hybrid families, else
    attention layers (MoE when the config has experts), after
    `dense_layers` (`first_k_dense` of an MoE config, else none).
    Parameters are allocated uninitialised on `device` (None means cuda, as
    for every entry point; `device="meta"` allocates nothing);
    `init_params` fills them from a generator and
    `load_state_dict(convert.lm_params_from_reference(...))` from the
    reference's tree.
    """

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        if device is None or torch.device(device).type != "meta":
            device = resolve_device(device)
        dtype = torch_dtype(dtype or cfg.dtype)
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = _param((v, d), device, dtype)
        self.final_norm = _param((d,), device, dtype)
        self.lm_head = _param((d, v), device, dtype)
        self.shared_attn = None
        if cfg.family in ("ssm", "hybrid"):
            self.dense_layers = nn.ModuleList()
            self.layers = nn.ModuleList(
                MambaLayer(cfg, device, dtype) for _ in range(cfg.n_layers))
            if cfg.family == "hybrid":
                self.shared_attn = AttnLayer(cfg, False, device, dtype)
        else:
            n_dense = n_dense_layers(cfg)
            self.dense_layers = nn.ModuleList(
                AttnLayer(cfg, False, device, dtype) for _ in range(n_dense))
            self.layers = nn.ModuleList(
                AttnLayer(cfg, bool(cfg.n_experts), device, dtype)
                for _ in range(cfg.n_layers - n_dense))

    def blocks(self):
        """Every layer module, in the order `convert` names them."""
        return [*self.dense_layers, *self.layers] + (
            [self.shared_attn] if self.shared_attn is not None else [])


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=None) -> DecoderLM:
    """Random weights with the reference's distributions (`init_params` and
    its `_*_params`): normal, drawn in the weights' dtype, times 0.02 for the
    embedding and 1/sqrt(fan-in) for the projections; norm scales 1, the
    Mamba2 `dt_bias` and `a_log` 0 (f32), the router f32.  `generator`
    lives on `device`; the numbers differ from `jax.random`'s for the same
    seed."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, dev, dtype)

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=dev, dtype=p.dtype) * std)

    normal_(model.embed, 0.02)
    normal_(model.lm_head, 1.0 / math.sqrt(cfg.d_model))
    model.final_norm.fill_(1.0)
    for layer in model.blocks():
        for group, table in layer.tables.items():
            for name, (_, init, *_f32) in table.items():
                p = getattr(layer, group)[name]
                if isinstance(init, str):
                    p.fill_(float(init))
                else:
                    normal_(p, init)
        for ln in ("ln1", "ln2"):
            if hasattr(layer, ln):
                getattr(layer, ln).fill_(1.0)
    return model


def _positions(b: int, s: int, start, device) -> torch.Tensor:
    return (start + torch.arange(s, dtype=torch.int32, device=device)).expand(b, s)


def _embed_inputs(params: DecoderLM, tokens, embeddings=None) -> torch.Tensor:
    """Token embeddings, after the vision stub's prefix of precomputed
    embeddings (cast to the model's dtype) when given."""
    x = params.embed[tokens]
    if embeddings is not None:
        x = torch.cat([embeddings.to(x.dtype), x], dim=1)
    return x


def _groups(cfg: ModelConfig) -> tuple[int, int, int]:
    """The hybrid's (layers per group, groups, leftover layers after the
    last group): one shared attention block follows each group."""
    per = cfg.attn_every
    n_groups = cfg.n_layers // per
    return per, n_groups, cfg.n_layers - n_groups * per


def forward_train(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
                  embeddings: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal forward: (logits (B, S, V), the summed MoE aux
    loss f32, 0 without MoE).  `embeddings` (B, n, d): the vision stub's
    prefix.  Differentiable under the caller's grad mode, with each layer
    recomputed in the backward under `cfg.remat` (module docstring); the
    reference's training forward without sharding."""
    x = _embed_inputs(params, tokens, embeddings)
    b, s, _ = x.shape
    positions = _positions(b, s, 0, x.device)
    aux_total = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(layer, *args):
        if remat:
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    if cfg.family in ("ssm", "hybrid"):
        per = _groups(cfg)[0] if cfg.family == "hybrid" else 0
        for i, layer in enumerate(params.layers):
            x, _ = run(layer, x, cfg)
            if per and (i + 1) % per == 0:
                x, _, _ = params.shared_attn(x, positions, cfg)
    else:
        for layer in [*params.dense_layers, *params.layers]:
            x, _, aux = run(layer, x, positions, cfg)
            aux_total = aux_total + aux
    x = rms_norm(x, params.final_norm)
    return x @ params.lm_head, aux_total


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> dict:
    """The (empty) decode cache of a family, on cuda unless `device` says
    otherwise: GQA {"k", "v"} (L, B, max_len, KV, hd); MLA {"c_kv" (L, B,
    max_len, R), "k_rope" (L, B, max_len, dr)}; Mamba2 {"conv" (L, B, K-1,
    conv dim), "ssm" (L, B, H, P, N) f32}, the hybrid also {"attn_k",
    "attn_v"} (groups, B, max_len, KV, hd).  `device="meta"` allocates
    nothing (the dry run), as for `DecoderLM`."""
    if device is None or torch.device(device).type != "meta":
        device = resolve_device(device)
    dtype = torch_dtype(dtype)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.family in ("ssm", "hybrid"):
        cache = {
            "conv": zeros(cfg.n_layers, batch, cfg.ssm_conv - 1,
                          cfg.d_inner + 2 * cfg.ssm_heads * cfg.ssm_state),
            "ssm": zeros(cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                         dt=torch.float32),
        }
        if cfg.family == "hybrid":
            kv = (_groups(cfg)[1], batch, max_len, cfg.n_kv_heads, cfg.hd)
            cache.update(attn_k=zeros(*kv), attn_v=zeros(*kv))
        return cache
    if cfg.use_mla:
        return {"c_kv": zeros(cfg.n_layers, batch, max_len, cfg.kv_lora_rank),
                "k_rope": zeros(cfg.n_layers, batch, max_len, cfg.qk_rope_dim)}
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": zeros(*shape), "v": zeros(*shape)}


def _forward_cached(params: DecoderLM, cfg, x, positions, cache, cache_len):
    """Shared by prefill (S >= 1) and decode (S == 1): runs the stack
    against the cache, which each layer updates in place.  A Mamba2 layer
    takes the one-step recurrence whenever S == 1 (a one-token prefill
    too, from the empty state, as in the reference)."""
    if cfg.family in ("ssm", "hybrid"):
        decode = x.shape[1] == 1
        per = _groups(cfg)[0] if cfg.family == "hybrid" else 0
        for i, layer in enumerate(params.layers):
            st = {"conv": cache["conv"][i], "ssm": cache["ssm"][i]} if decode else None
            x, new = layer(x, cfg, st)
            cache["conv"][i].copy_(new["conv"])
            cache["ssm"][i].copy_(new["ssm"])
            if per and (i + 1) % per == 0:
                g = (i + 1) // per - 1
                x, _, _ = params.shared_attn(x, positions, cfg,
                                             (cache["attn_k"][g], cache["attn_v"][g]), cache_len)
        return x, cache
    c0, c1 = (cache["c_kv"], cache["k_rope"]) if cfg.use_mla else (cache["k"], cache["v"])
    for i, layer in enumerate([*params.dense_layers, *params.layers]):
        x, _, _ = layer(x, positions, cfg, (c0[i], c1[i]), cache_len)
    return x, cache


@torch.no_grad()
def prefill(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int | None = None, embeddings: torch.Tensor | None = None,
            cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, dict]:
    """Process the prompt (after the vision stub's `embeddings`, when
    given), build the decode cache, return last-position logits (B, 1, V).
    The cache offset is the Python int 0, so a multi-token prompt meets
    kernel B10 in each GQA block when `cfg.use_flash_kernel` is set and
    the shapes pass its gate."""
    x = _embed_inputs(params, tokens, embeddings)
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
    x = params.embed[tokens]
    b, s, _ = x.shape
    positions = _positions(b, s, cache_len, x.device)
    x, cache = _forward_cached(params, cfg, x, positions, cache, cache_len)
    x = rms_norm(x, params.final_norm)
    return x @ params.lm_head, cache
