"""AdamW with decoupled weight decay and global-norm clipping.

The port of `repro.optim.adamw`.  The state is a dict of plain tensors in
the reference's layout: `mu` and `nu` map each parameter name to its f32
moment, `step` is an int32 scalar tensor.  `torch.optim.AdamW` is not
used: it keeps bf16 moments for bf16 parameters and adds eps after the
bias-corrected square root's split, while the reference keeps f32 moments,
computes `mhat / (sqrt(vhat) + eps) + wd * p` in f32 and rounds a bf16
parameter back every step.

The update runs in place: each parameter, moment and the step counter is
overwritten (the state dict given is the one returned), and a
leaf larger than `SLICE_ELEMENTS` is updated in slices along its leading
axis, so that the f32 temporaries of an 8B model's embedding stay near
1 GB.  The operations are elementwise, so the numbers are those of one
pass over the whole leaf.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

# elements of one slice of a leaf's update (f32 temporaries: ~4 of these)
SLICE_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _named(params) -> dict[str, torch.Tensor]:
    """A parameter dict from a module (`named_parameters`) or a mapping."""
    if isinstance(params, Mapping):
        return dict(params)
    return dict(params.named_parameters())


def init_opt_state(params) -> dict:
    """{"mu", "nu": zero f32 moments by parameter name, "step": int32 0}, on
    the parameters' device.  `params` is a module or a name -> tensor dict."""
    named = _named(params)
    dev = next(iter(named.values())).device if named else torch.device("cpu")

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named.items()}

    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _slices(t: torch.Tensor):
    """Row ranges along the leading axis holding ~SLICE_ELEMENTS each (the
    whole tensor for a scalar or a small leaf)."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMENTS:
        yield ...
        return
    rows = max(1, SLICE_ELEMENTS // max(1, t[0].numel()))
    for s in range(0, t.shape[0], rows):
        yield slice(s, s + rows)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32 (a 0-d tensor)."""
    total = None
    for x in tensors:
        for sl in _slices(x):
            part = torch.sum(torch.square(x[sl].float()))
            total = part if total is None else total + part
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr):
    """One AdamW step, in place: the parameters, the moments and the
    state's `step` are updated.  Returns (params, state, metrics).

    `params` is a module or a name -> tensor dict; `grads` maps the same
    names to gradients (a missing or None gradient counts as zeros, as the
    reference's gradient of an unused leaf is).  The global norm is taken
    over every gradient first, then each leaf is clipped, its moments and
    itself updated alone.  `metrics`: `grad_norm`, `lr` (f32 0-d tensors).
    """
    named = _named(params)
    dev = state["step"].device
    step = state["step"] = state["step"] + 1
    present = [g for g in (grads.get(n) for n in named) if g is not None]
    gnorm = global_norm(present).to(dev)
    scale = torch.minimum(_scalar(1.0, dev),
                          cfg.clip_norm / torch.maximum(gnorm, _scalar(1e-9, dev)))
    stepf = step.float()
    bc1 = 1 - _scalar(cfg.b1, dev) ** stepf
    bc2 = 1 - _scalar(cfg.b2, dev) ** stepf
    lr_t = _scalar(lr, dev)
    for name, p in named.items():
        g, mu, nu = grads.get(name), state["mu"][name], state["nu"][name]
        for sl in _slices(p):
            # the reference's expressions op for op (each op rounds as
            # there), in place on the moments and on two temporaries
            gs = (torch.zeros_like(mu[sl]) if g is None else g[sl].float()) * scale
            m, v = mu[sl], nu[sl]
            t = (1 - cfg.b1) * gs
            m.mul_(cfg.b1).add_(t)                            # b1 m + (1 - b1) g
            torch.mul(gs, 1 - cfg.b2, out=t).mul_(gs)         # (1 - b2) g g
            v.mul_(cfg.b2).add_(t)                            # b2 v + ...
            torch.div(v, bc2, out=t).sqrt_().add_(cfg.eps)
            delta = torch.div(m, bc1, out=gs).div_(t)         # mhat / (sqrt(vhat) + eps)
            pf = p[sl].float()
            delta.add_(torch.mul(pf, cfg.weight_decay, out=t)).mul_(lr_t)
            p[sl] = torch.sub(pf, delta, out=delta)           # p - lr delta, rounded to p
    metrics = {"grad_norm": gnorm, "lr": lr_t}
    return params, state, metrics
