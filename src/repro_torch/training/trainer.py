"""Training: loss, the train step, the fault-tolerant loop.

The port of `repro.training.trainer` for one GPU.  The reference's step is
jitted and sharded over a mesh (FSDP over "data", TP / EP over "model",
an int8 all-reduce over "pod"); on one card every sharding is the
identity, so the step here is eager PyTorch: the forward (`forward_train`,
each layer recomputed in the backward under `cfg.remat`), `backward`, the
learning rate from the optimizer's step, and AdamW in place.

Fault tolerance is the reference's: the data is a pure function of
(seed, step), checkpoints commit atomically, and `Trainer.run` retries a
failed step, restores the latest checkpoint after each failure, and
resumes from it.  The reference's jitted step returns new arrays, so a
failed step changes nothing; here AdamW updates the state in place, so a
failure once the update has begun (`OptimizerStepError`) is never retried
on that state: the latest checkpoint is restored, or, without one, the
error is raised.  A failure in the data, the forward or the backward
changes nothing and is retried as it is.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import torch
from torch.profiler import record_function

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.device import resolve_device
from repro_torch.models import DecoderLM, forward_train, init_params
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule, init_opt_state

log = logging.getLogger("repro_torch.trainer")


class OptimizerStepError(RuntimeError):
    """A train step failed inside the in-place AdamW update: the step
    counter, the parameters and their moments may be partly updated."""


def loss_fn(params: DecoderLM, cfg, tokens: torch.Tensor,
            embeddings: torch.Tensor | None = None, aux_weight: float = 0.01):
    """Next-token cross entropy (+ aux_weight * the MoE aux loss).

    Returns (loss, (ce, aux)).  The CE is taken from f32 logits; a vision
    prefix's positions predict nothing (the logits are aligned on the token
    tail).  The gold logit is read by `gather`: for finite logits it equals
    the reference's one-hot contraction without a second (B, S, V) tensor."""
    logits, aux = forward_train(params, cfg, tokens, embeddings)
    n_front = logits.shape[1] - tokens.shape[1]
    logits = logits[:, n_front:]
    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, tgt[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    return ce + aux_weight * aux, (ce, aux)


def make_train_step(cfg, opt_cfg: AdamWConfig, grad_compress: bool = False):
    """The train step `(params, opt_state, tokens[, embeddings]) -> (params,
    opt_state, metrics)`: `make_train_step`'s meaning without the mesh.
    Gradients land in the parameters' `.grad` (the parameters' dtype, as
    the reference's), AdamW updates the parameters and moments in place,
    and the gradients are dropped after.  The forward, backward and update
    run inside `record_function` ranges ("train.forward", "train.backward",
    "train.optimizer"), which a profiler reads.  `grad_compress` is accepted and
    does nothing: one GPU has no pod axis to all-reduce over.  `metrics`:
    `loss`, `ce`, `aux`, `grad_norm`, `lr` (0-d tensors).  A failure in the
    update is raised as `OptimizerStepError` (its cause chained)."""
    del grad_compress

    def step_fn(params: DecoderLM, opt_state: dict, tokens: torch.Tensor,
                embeddings: torch.Tensor | None = None):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        with record_function("train.forward"):
            loss, (ce, aux) = loss_fn(params, cfg, tokens, embeddings)
        with record_function("train.backward"):
            loss.backward()
        grads = {n: p.grad for n, p in named.items()}
        with record_function("train.optimizer"):
            try:
                lr = cosine_schedule(opt_state["step"], opt_cfg)
                _, opt_state, metrics = adamw_update(named, grads, opt_state, opt_cfg, lr)
            except Exception as e:
                raise OptimizerStepError(f"AdamW update failed: {e}") from e
        del grads
        for p in named.values():
            p.grad = None
        metrics.update(loss=loss.detach(), ce=ce.detach(), aux=aux.detach())
        return params, opt_state, metrics

    return step_fn


def trainable(model: DecoderLM) -> DecoderLM:
    """Turn gradients on for every parameter (they are off for serving)."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


@dataclasses.dataclass
class Trainer:
    """Fault-tolerant training loop on one device (cuda unless `device`
    says otherwise)."""

    cfg: object
    opt_cfg: AdamWConfig
    dataset: object
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    max_retries: int = 3
    grad_compress: bool = False
    device: torch.device | str | None = None

    def run(self, generator: torch.Generator | int, n_steps: int,
            params: DecoderLM | None = None):
        """Train to `n_steps` (resuming from the latest checkpoint under
        `ckpt_dir`).  `generator` (or an int seed) draws the initial weights
        when `params` is None.  Returns (params, opt_state, history, wall):
        history holds one dict of floats per completed step, the replayed
        steps after a restore included, as in the reference."""
        dev = resolve_device(self.device)
        if params is None:
            if isinstance(generator, int):
                generator = torch.Generator(device=dev).manual_seed(generator)
            params = init_params(self.cfg, generator, dev)
        trainable(params)
        opt_state = init_opt_state(params)
        step_fn = make_train_step(self.cfg, self.opt_cfg, self.grad_compress)

        start = 0
        if self.ckpt_dir and (ls := latest_step(self.ckpt_dir)) is not None:
            params, opt_state, meta = restore(self.ckpt_dir, ls, params, opt_state)
            start = meta["step"]
            log.info("restored checkpoint at step %d", start)

        history = []
        step = start
        retries = 0
        t0 = time.time()
        while step < n_steps:
            try:
                tokens = torch.as_tensor(self.dataset.batch(step), device=dev)
                args = [params, opt_state, tokens]
                if self.cfg.frontend == "vision":
                    emb = self.dataset.frontend_embeddings(
                        step, self.cfg.n_frontend_tokens, self.cfg.d_model)
                    args.append(torch.as_tensor(emb, device=dev))
                params, opt_state, metrics = step_fn(*args)
                metrics = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, **metrics})
                retries = 0
                step += 1
                if self.ckpt_dir and step % self.ckpt_every == 0:
                    save(self.ckpt_dir, step, params, opt_state)
            except Exception as e:  # noqa: BLE001 -- node-failure surface
                retries += 1
                log.exception("step %d failed (retry %d)", step, retries)
                if retries > self.max_retries:
                    raise
                if self.ckpt_dir and (ls := latest_step(self.ckpt_dir)) is not None:
                    params, opt_state, meta = restore(self.ckpt_dir, ls, params, opt_state)
                    step = meta["step"]
                elif isinstance(e, OptimizerStepError):
                    raise  # the state is partly updated and no checkpoint can replace it
        if self.ckpt_dir:
            save(self.ckpt_dir, step, params, opt_state)
        wall = time.time() - t0
        return params, opt_state, history, wall
