"""Serving launcher: batched prefill + greedy decode, optional retrieval.

    python -m repro_torch.launch.serve --arch qwen3-8b --flash --batch 4 \\
        --prompt-len 2048 --steps 512                      # one CUDA GPU
    python -m repro_torch.launch.serve --arch qwen3-8b --reduced --device cpu \\
        --retrieval --rerank exact
    python -m repro_torch.launch.serve --arch qwen3-8b --reduced --device cpu \\
        --retrieval --churn-insert-rate 64 --churn-delete-rate 16 \\
        --metrics-port 0 --trace-out trace.json

The port of `repro.launch.serve`, for every config of the registry
(`--arch`: dense, MoE, MLA, Mamba2, the Zamba2 hybrid, the vision and
audio stubs).  Weights are random from a seed, as there; a vision config's
prompt is `n_frontend_tokens` f32 embeddings from the seed (the stub's
patch embeddings) and `prompt_len - n_frontend_tokens` tokens.  The prompt
goes through `prefill` (kernel B10 in every GQA block when the config's
`use_flash_kernel` is set, `--flash`, and the shapes pass the reference's
gate), then greedy `decode_step`s against an f32 cache.  `--retrieval` builds the
port's `MemANNSEngine` on a synthetic corpus of the model's width (the
reference's arguments: the SIFT1B config reduced, co-occurrence on unless
`--cooc off`) and serves one query per request through a warmed
`ServingEngine` with `micro_batch = max(1, batch // 2)` and
`--pipeline-depth` (default 1), as the reference does (kernels B1, B4
with co-occurrence, B2, and B3 with `--rerank exact`).

The reference's `ServingEngine` flags are taken: `--churn-insert-rate` /
`--churn-delete-rate` (four churn rounds of inserts, deletes and a search
before the timed search, on a mutable engine; the delta scan runs on B1 +
B5), `--compact-occupancy`, `--deadline-ms`, `--queue-limit`,
`--collect-timeout`, `--metrics-port` / `--metrics-linger` (`/metrics`,
`/metrics.json`, `/traces`, `/healthz` on 127.0.0.1), `--trace-out` /
`--trace-sample` (Chrome trace JSON of the span ring) and `--autotune`
off | cache | sweep (the kernel geometry resolved at warmup,
`core.autotune`; the stats' `autotune` block has the reference's keys).
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
from repro_torch.launch.env import setup_env
from repro_torch.models import ModelConfig, decode_step, init_params, prefill
from repro_torch.models.model import DecoderLM


@dataclasses.dataclass(frozen=True)
class RetrievalOptions:
    """`--retrieval` and the flags that shape it."""

    vectors: int = 20_000
    rerank: str = "off"
    k_overfetch: int = 0
    cooc: str = "auto"
    pipeline_depth: int = 1
    churn_insert_rate: int = 0
    churn_delete_rate: int = 0
    compact_occupancy: float = 0.75
    autotune: str = "cache"
    deadline_ms: float | None = None
    queue_limit: int | None = None
    collect_timeout: float | None = None
    metrics_port: int | None = None
    metrics_linger: float = 0.0
    trace_out: str | None = None
    trace_sample: float = 1.0

    @property
    def churn(self) -> bool:
        return self.churn_insert_rate > 0 or self.churn_delete_rate > 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launch_diff(before: dict) -> dict:
    return {k: v - before[k] for k, v in ops.launches.items() if v - before[k]}


def retrieval_engine(cfg: ModelConfig, opts: RetrievalOptions, batch: int, dev, seed: int):
    """(engine, retrieval config, (batch, d_model) f32 queries, corpus
    centres) of `--retrieval`: the port's `MemANNSEngine` on a synthetic
    corpus of the model's width (the reference's arguments: the SIFT1B
    config reduced; mutable under churn) and one query per request, a
    hidden-state proxy near a corpus centre."""
    from repro_torch.configs.memanns import SIFT1B, reduced_retrieval
    from repro_torch.data.vectors import make_clustered_vectors
    from repro_torch.retrieval.engine import MemANNSEngine

    rcfg = reduced_retrieval(SIFT1B, n_vectors=opts.vectors, dim=cfg.d_model)
    xs, centers, _ = make_clustered_vectors(
        rcfg.n_vectors, cfg.d_model, rcfg.n_clusters, seed=seed, pattern_pool=64)
    eng = MemANNSEngine.build(
        xs, rcfg.n_clusters, rcfg.m, ndev=1, use_cooc=opts.cooc != "off",
        n_combos=rcfg.n_combos, block_n=rcfg.block_n, rerank=opts.rerank,
        k_overfetch=opts.k_overfetch, mutable=opts.churn, seed=seed + 1, device=dev,
    )
    rng = np.random.default_rng(seed + 2)
    qvecs = rng.normal(size=(batch, cfg.d_model)) + centers[rng.integers(0, len(centers), batch)]
    return eng, rcfg, qvecs.astype(np.float32), centers


def _churn_rounds(srv, opts: RetrievalOptions, n_vectors: int, centers: np.ndarray,
                  qvecs: np.ndarray, seed: int) -> None:
    """Four rounds of `--churn-insert-rate` inserts (near the corpus
    centres), `--churn-delete-rate` deletes of original ids and a search,
    as the reference's launcher mutates the corpus between request batches."""
    rng = np.random.default_rng(seed + 5)
    next_id = n_vectors
    for _ in range(4):
        if opts.churn_insert_rate:
            ids = np.arange(next_id, next_id + opts.churn_insert_rate, dtype=np.int32)
            next_id += opts.churn_insert_rate
            vecs = (centers[rng.integers(0, len(centers), ids.size)]
                    + rng.normal(0, 1, (ids.size, centers.shape[1]))).astype(np.float32)
            srv.insert(ids, vecs)
        if opts.churn_delete_rate:
            srv.delete(rng.choice(n_vectors, opts.churn_delete_rate, replace=False))
        srv.search(qvecs)


def _autotune_stats(mode: str, srv) -> dict:
    """The reference's `autotune` stats block: the mode, where the geometry
    came from, candidates swept, whether the shards were retiled, and the
    geometry serving now."""
    at = srv.autotune_report or {}
    return {"mode": mode, "source": at.get("source", "off"), "swept": at.get("swept", 0),
            "retiled": bool(at.get("retiled", False)), "geometry": srv.tuned_geometry()}


def _retrieve(cfg: ModelConfig, opts: RetrievalOptions, batch: int, dev, seed: int) -> dict:
    from repro_torch.obs.http import ObsServer
    from repro_torch.obs.trace import Tracer
    from repro_torch.retrieval.serving import PHASES, ServingEngine

    eng, rcfg, qvecs, centers = retrieval_engine(cfg, opts, batch, dev, seed)
    obs_on = opts.metrics_port is not None or opts.trace_out is not None
    tracer = Tracer(sample=opts.trace_sample) if obs_on else None
    # half the request batch a micro-batch, so one search spans two and the
    # pipeline engages (the reference's choice)
    srv = ServingEngine(
        eng, nprobe=rcfg.nprobe, k=rcfg.k, micro_batch=max(1, batch // 2),
        pipeline_depth=opts.pipeline_depth, mutable=opts.churn,
        compact_occupancy=opts.compact_occupancy, autotune=opts.autotune, tracer=tracer,
        deadline_ms=opts.deadline_ms, queue_limit=opts.queue_limit,
        collect_timeout_s=opts.collect_timeout,
    )
    out: dict = {}
    obs_server = None
    if opts.metrics_port is not None:
        obs_server = ObsServer(srv.stats.registry, tracer, port=opts.metrics_port,
                               health=srv.health)
        out["metrics_endpoint"] = f"http://127.0.0.1:{obs_server.start()}/metrics"
        print(json.dumps({"metrics_endpoint": out["metrics_endpoint"]}), flush=True)
    try:
        srv.warmup()
        if opts.churn:
            _churn_rounds(srv, opts, rcfg.n_vectors, centers, qvecs, seed)
        before = dict(ops.launches)
        t0 = time.perf_counter()
        _, ids = srv.search(qvecs)
        _sync(dev)
        retrieval_s = time.perf_counter() - t0
        st = srv.stats
        stats = {
            "cooc": eng.shards.n_combos > 0, "device": str(dev), "nprobe": rcfg.nprobe,
            "k": rcfg.k, "pipeline_depth": opts.pipeline_depth, "micro_batch": srv.micro_batch,
            "batches": st.batches, "compiles": st.compiles,
            "host_fraction": st.host_fraction(), "overlap_fraction": st.overlap_fraction(),
            "p50_ms": 1e3 * st.p50_s(), "p99_ms": 1e3 * st.p99_s(),
            "p999_ms": 1e3 * st.p999_s(),
            "phase_seconds": {p: st.phase_seconds(p) for p in PHASES},
            "rows_scanned": st.rows_scanned, "load_carry": srv.load_carry().tolist(),
            "prune": {"tiles_dispatched": st.tiles_dispatched,
                      "tiles_skipped": st.tiles_skipped, "rows_pruned": st.rows_pruned,
                      "skip_fraction": st.prune_fraction(),
                      "warm_bound_queries": st.warm_bound_queries},
            "autotune": _autotune_stats(opts.autotune, srv), "health": srv.health(),
            "faults": {"failovers": st.failovers, "degraded_queries": st.degraded_queries,
                       "rejected_queries": st.rejected_queries, "retries": st.retries},
            "kernel_launches": _launch_diff(before),
        }
        if opts.rerank != "off":
            stats["rerank"] = {"mode": opts.rerank, "k_prime": eng.k_prime(rcfg.k),
                               "reranked_queries": st.reranked_queries,
                               "rerank_candidates": st.rerank_candidates}
        if opts.churn:
            stats["mutation"] = {
                "inserts": st.inserts, "deletes": st.deletes, "compactions": st.compactions,
                "starved_batches": st.starved_batches, "delta_occupancy": st.delta_occupancy,
                "tombstones": st.tombstones, "compaction_mean_ms": 1e3 * st.compaction_mean_s(),
            }
        if opts.trace_out is not None:
            tracer.write_chrome(opts.trace_out)
            out["trace_out"] = {"path": opts.trace_out, "spans": len(tracer.roots())}
        if obs_server is not None and opts.metrics_linger > 0:
            time.sleep(opts.metrics_linger)
    finally:
        if obs_server is not None:
            obs_server.stop()
    return {**out, "retrieval_s": retrieval_s, "retrieved_ids": ids[:, :4].tolist(),
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
    """Prefill `batch` random prompts of `prompt_len` positions (a vision
    config's first `n_frontend_tokens` are embeddings), decode `steps`
    greedy tokens (the first from the prefill's logits), then retrieve.

    `params`: the weights to serve (default: random from `seed` on
    `device`, default cuda).  Returns the reference's report keys (`arch`,
    `batch`, `prefill_s`, `decode_tok_per_s`, `generated`: the first 8
    tokens of each request), unrounded, plus `decode_s`, `steps`,
    `prompt_len` and the kernel launches of the prefill and of the decode
    loop (`kernel_launches`), and with `retrieval` the retrieval's keys.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = init_params(cfg, gen, dev)
    max_len = prompt_len + steps
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    if n_front > prompt_len:
        raise ValueError(f"prompt_len {prompt_len} is shorter than the {n_front} embedding "
                         "positions")
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len - n_front), generator=gen,
                           device=dev)
    emb = (torch.randn(batch, n_front, cfg.d_model, generator=gen, device=dev)
           if n_front else None)

    before = dict(ops.launches)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, tokens, max_len=max_len, embeddings=emb,
                            cache_dtype=torch.float32)
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
    setup_env()  # before the first CUDA call
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
    ap.add_argument("--churn-insert-rate", type=int, default=0,
                    help="corpus inserts per churn round (0 = immutable serving)")
    ap.add_argument("--churn-delete-rate", type=int, default=0,
                    help="corpus deletes per churn round")
    ap.add_argument("--compact-occupancy", type=float, default=0.75,
                    help="delta-buffer fill fraction that triggers auto-compaction")
    ap.add_argument(
        "--autotune", choices=["off", "cache", "sweep"], default="cache",
        help="kernel-geometry autotune at warmup: 'cache' applies a cached or default "
             "geometry, 'sweep' measures on a cache miss and persists the winner, "
             "'off' serves the build-time geometry",
    )
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-search budget: micro-batches planned after it are "
                         "served at a smaller nprobe and flagged degraded")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound the ingress queue: submissions past it are rejected")
    ap.add_argument("--collect-timeout", type=float, default=None,
                    help="seconds before a result that never arrives is raised as a "
                         "fault instead of stalling the serving loop")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics, /metrics.json, /traces, /healthz on "
                         "127.0.0.1 at this port (0 = any free port); needs --retrieval")
    ap.add_argument("--metrics-linger", type=float, default=0.0,
                    help="keep the endpoint up this many seconds after serving")
    ap.add_argument("--trace-out", default=None,
                    help="write the span ring as Chrome trace JSON here; needs --retrieval")
    ap.add_argument("--trace-sample", type=float, default=1.0,
                    help="fraction of micro-batches traced (deterministic)")
    ap.add_argument("--flash", action="store_true",
                    help="use_flash_kernel: prefill attention on kernel B10")
    ap.add_argument("--opt-decode", action="store_true",
                    help="opt_decode: single-pass cache decode attention")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.k_overfetch and args.rerank == "off":
        ap.error("--k-overfetch requires --rerank exact")
    if (args.metrics_port is not None or args.trace_out is not None) and not args.retrieval:
        ap.error("--metrics-port/--trace-out require --retrieval")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, use_flash_kernel=args.flash or cfg.use_flash_kernel,
                              opt_decode=args.opt_decode or cfg.opt_decode)
    retrieval = None
    if args.retrieval:
        retrieval = RetrievalOptions(
            vectors=args.retrieval_vectors, rerank=args.rerank, k_overfetch=args.k_overfetch,
            cooc=args.cooc, pipeline_depth=args.pipeline_depth,
            churn_insert_rate=args.churn_insert_rate, churn_delete_rate=args.churn_delete_rate,
            compact_occupancy=args.compact_occupancy, autotune=args.autotune,
            deadline_ms=args.deadline_ms, queue_limit=args.queue_limit,
            collect_timeout=args.collect_timeout, metrics_port=args.metrics_port,
            metrics_linger=args.metrics_linger, trace_out=args.trace_out,
            trace_sample=args.trace_sample,
        )
    report = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, steps=args.steps,
                   retrieval=retrieval, device=args.device)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
