"""Serving launcher: batched prefill + greedy decode, optional retrieval.

    python -m repro_torch.launch.serve --arch qwen3-8b --flash --batch 4 \\
        --prompt-len 2048 --steps 512                      # one CUDA GPU
    python -m repro_torch.launch.serve --arch qwen3-8b --reduced --device cpu \\
        --retrieval --rerank exact

The port of `repro.launch.serve` for dense configs.  Weights are random
from a seed, as there.  The prompt goes through `prefill` (kernel B10 on
every layer when the config's `use_flash_kernel` is set, `--flash`), then
greedy `decode_step`s against an f32 KV cache.  `--retrieval` builds the
port's `MemANNSEngine` on a synthetic corpus of the model's width (the
reference's arguments: the SIFT1B config reduced, co-occurrence on unless
`--cooc off`) and serves one query per request through a warmed
`ServingEngine` with `micro_batch = max(1, batch // 2)` and
`--pipeline-depth` (default 1), as the reference does (kernels B1, B4
with co-occurrence, B2, and B3 with `--rerank exact`).

The reference's other `ServingEngine` flags (churn, autotune, deadlines,
admission, watchdog, metrics and traces) wait for their ROADMAP items
(queue A items 7, 12, 13); argparse refuses them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import ModelConfig, decode_step, init_params, prefill
from repro_torch.models.model import DecoderLM, check_dense


@dataclasses.dataclass(frozen=True)
class RetrievalOptions:
    """`--retrieval` and the flags that shape it."""

    vectors: int = 20_000
    rerank: str = "off"
    k_overfetch: int = 0
    cooc: str = "auto"
    pipeline_depth: int = 1


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launch_diff(before: dict) -> dict:
    return {k: v - before[k] for k, v in ops.launches.items() if v - before[k]}


def retrieval_engine(cfg: ModelConfig, opts: RetrievalOptions, batch: int, dev, seed: int):
    """(engine, retrieval config, (batch, d_model) f32 queries) of
    `--retrieval`: the port's `MemANNSEngine` on a synthetic corpus of the
    model's width (the reference's arguments: the SIFT1B config reduced)
    and one query per request, a hidden-state proxy near a corpus centre."""
    from repro_torch.configs.memanns import SIFT1B, reduced_retrieval
    from repro_torch.data.vectors import make_clustered_vectors
    from repro_torch.retrieval.engine import MemANNSEngine

    rcfg = reduced_retrieval(SIFT1B, n_vectors=opts.vectors, dim=cfg.d_model)
    xs, centers, _ = make_clustered_vectors(
        rcfg.n_vectors, cfg.d_model, rcfg.n_clusters, seed=seed, pattern_pool=64)
    eng = MemANNSEngine.build(
        xs, rcfg.n_clusters, rcfg.m, ndev=1, use_cooc=opts.cooc != "off",
        n_combos=rcfg.n_combos, block_n=rcfg.block_n, rerank=opts.rerank,
        k_overfetch=opts.k_overfetch, seed=seed + 1, device=dev,
    )
    rng = np.random.default_rng(seed + 2)
    qvecs = rng.normal(size=(batch, cfg.d_model)) + centers[rng.integers(0, len(centers), batch)]
    return eng, rcfg, qvecs.astype(np.float32)


def _retrieve(cfg: ModelConfig, opts: RetrievalOptions, batch: int, dev, seed: int) -> dict:
    from repro_torch.retrieval.serving import ServingEngine

    eng, rcfg, qvecs = retrieval_engine(cfg, opts, batch, dev, seed)
    # half the request batch a micro-batch, so one search spans two and the
    # pipeline engages (the reference's choice)
    srv = ServingEngine(eng, nprobe=rcfg.nprobe, k=rcfg.k, micro_batch=max(1, batch // 2),
                        pipeline_depth=opts.pipeline_depth)
    srv.warmup()
    before = dict(ops.launches)
    t0 = time.perf_counter()
    _, ids = srv.search(qvecs)
    _sync(dev)
    retrieval_s = time.perf_counter() - t0
    st = srv.stats
    stats = {"cooc": eng.shards.n_combos > 0, "device": str(dev),
             "nprobe": rcfg.nprobe, "k": rcfg.k, "pipeline_depth": opts.pipeline_depth,
             "micro_batch": srv.micro_batch, "batches": st.batches, "compiles": st.compiles,
             "host_fraction": st.host_fraction(), "overlap_fraction": st.overlap_fraction(),
             "p50_ms": 1e3 * st.p50_s(), "p99_ms": 1e3 * st.p99_s(),
             "rows_scanned": st.rows_scanned, "load_carry": srv.load_carry().tolist(),
             "autotune": srv.autotune_report, "health": srv.health(),
             "kernel_launches": _launch_diff(before)}
    if opts.rerank != "off":
        stats["rerank"] = {"mode": opts.rerank, "k_prime": eng.k_prime(rcfg.k)}
    return {"retrieval_s": retrieval_s, "retrieved_ids": ids[:, :4].tolist(),
            "retrieval_stats": stats}


def serve(
    cfg: ModelConfig,
    *,
    batch: int,
    prompt_len: int,
    steps: int,
    retrieval: RetrievalOptions | None = None,
    device: torch.device | str | None = None,
    params: DecoderLM | None = None,
    seed: int = 0,
) -> dict:
    """Prefill `batch` random prompts of `prompt_len` tokens, decode `steps`
    greedy tokens (the first from the prefill's logits), then retrieve.

    `params`: the weights to serve (default: random from `seed` on
    `device`, default cuda).  Returns the reference's report keys (`arch`,
    `batch`, `prefill_s`, `decode_tok_per_s`, `generated`: the first 8
    tokens of each request), unrounded, plus `decode_s`, `steps`,
    `prompt_len` and the kernel launches of the prefill and of the decode
    loop (`kernel_launches`), and with `retrieval` the retrieval's keys.
    """
    check_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = init_params(cfg, gen, dev)
    max_len = prompt_len + steps
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev)

    before = dict(ops.launches)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, tokens, max_len=max_len, cache_dtype=torch.float32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    launches = {"prefill": _launch_diff(before)}

    before = dict(ops.launches)
    tok = logits[:, -1].argmax(-1)[:, None]
    outs = [tok]
    t0 = time.perf_counter()
    for i in range(steps - 1):
        logits, cache = decode_step(params, cfg, tok, cache, prompt_len + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        outs.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    launches["decode"] = _launch_diff(before)

    report = {
        "arch": cfg.name,
        "batch": batch,
        "prefill_s": prefill_s,
        "decode_tok_per_s": batch * (steps - 1) / max(decode_s, 1e-9),
        "generated": torch.cat(outs, dim=1)[:, :8].tolist(),
        "decode_s": decode_s,
        "steps": steps,
        "prompt_len": prompt_len,
        "kernel_launches": launches,
    }
    if retrieval is not None:
        report.update(_retrieve(cfg, retrieval, batch, dev, seed))
    return report


def main(argv=None) -> dict:
    from repro_torch.configs import get_config, reduced_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=32, help="decode steps")
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--retrieval-vectors", type=int, default=20000)
    ap.add_argument(
        "--rerank", choices=["off", "exact"], default="off",
        help="exact re-rank cascade: ADC overfetches k' candidates, a "
             "full-precision pass re-scores them before the final top-k",
    )
    ap.add_argument(
        "--k-overfetch", type=int, default=0,
        help="ADC candidates per query fed to the re-rank stage "
             "(0 = 4*k, pow2-bucketed)",
    )
    ap.add_argument(
        "--cooc", choices=["auto", "on", "off"], default="auto",
        help="co-occurrence re-encoded shards (§4.3); auto = on",
    )
    ap.add_argument(
        "--pipeline-depth", type=int, default=1,
        help="in-flight retrieval micro-batches: 1 overlaps host planning of "
             "micro-batch i+1 with device execution of i; 0 = serial",
    )
    ap.add_argument("--flash", action="store_true",
                    help="use_flash_kernel: prefill attention on kernel B10")
    ap.add_argument("--opt-decode", action="store_true",
                    help="opt_decode: single-pass cache decode attention")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.k_overfetch and args.rerank == "off":
        ap.error("--k-overfetch requires --rerank exact")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, use_flash_kernel=args.flash or cfg.use_flash_kernel,
                              opt_decode=args.opt_decode or cfg.opt_decode)
    retrieval = None
    if args.retrieval:
        retrieval = RetrievalOptions(vectors=args.retrieval_vectors, rerank=args.rerank,
                                     k_overfetch=args.k_overfetch, cooc=args.cooc,
                                     pipeline_depth=args.pipeline_depth)
    report = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, steps=args.steps,
                   retrieval=retrieval, device=args.device)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
