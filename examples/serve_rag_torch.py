"""Retrieval-augmented serving on the PyTorch/CUDA port: a reduced LM
decodes with batched requests while every request's pooled hidden state
queries the sharded MemANNS index through the ServingEngine (the paper's
"serving large models" application) -- the twin of `examples/serve_rag.py`.

The ServingEngine warms one device step per pair-capacity bucket, so
steady-state retrieval batches never build anything.  The index is served
*mutable*: at the end a fresh document embedding is inserted live and
retrieved by the very next query -- no rebuild.

    PYTHONPATH=src python examples/serve_rag_torch.py [--device cpu]

On the card the search runs kernels B1 and B2 (tiles), and after the
insert the delta scan B1 + B5; the LM runs its chunked attention (the
reference's reduced config leaves the flash kernel off).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.vectors import SkewedVectorDataset, make_clustered_vectors
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.retrieval import MemANNSEngine, ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=20_000, help="corpus documents")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--autotune", default="cache", help="off | cache | sweep")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch, prompt, steps, k, nprobe = 4, 32, args.steps, 5, 16

    # --- the LM (reduced yi-6b family) ------------------------------------
    cfg = reduced_config(get_config("yi-6b"))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    # --- the retrieval corpus: document embeddings in the LM's hidden space
    xs, centers, _ = make_clustered_vectors(args.n, cfg.d_model, 64, pattern_pool=32)
    stream = SkewedVectorDataset(centers)
    # scan="tiles" (default) serves from the flat tile work queue; warmup
    # below warms every reachable pair bucket.  mutable=True allocates the
    # delta buffer + shard growth slack for live inserts / deletes (plain,
    # non-co-occurrence shards)
    engine = MemANNSEngine.build(
        xs, n_clusters=64, m=8, history_queries=stream.queries(200, seed=1),
        use_cooc=False, block_n=256, scan="tiles", mutable=True, seed=1, device=dev,
    )
    # pipeline_depth=1 (default): the host plans micro-batch i+1 while the
    # card runs micro-batch i; micro_batch is half the request batch so one
    # search() call spans two micro-batches and the pipeline engages
    serving = ServingEngine(
        engine, nprobe=nprobe, k=k, micro_batch=max(1, batch // 2),
        pipeline_depth=1, mutable=True, autotune=args.autotune,
    )
    buckets = serving.warmup()
    print(f"serving warmed: micro_batch={serving.micro_batch}, "
          f"scan={engine.scan}, pair buckets={buckets}")

    # --- serve a batch ------------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g, device=dev)
    t0 = time.time()
    logits, cache = prefill(params, cfg, tokens, max_len=prompt + steps,
                            cache_dtype=torch.float32)

    # pooled query vector per request (mean hidden state proxy: embed of prompt)
    qvec = params.embed[tokens].float().mean(dim=1).cpu().numpy()
    dists, doc_ids = serving.search(qvec)
    print("retrieved context docs per request:", doc_ids[:, :3].tolist())

    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    for i in range(steps - 1):
        logits, cache = decode_step(params, cfg, tok, cache, prompt + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    gen = torch.cat(out, dim=1)
    gen_host = gen.cpu().numpy()
    wall = time.time() - t0
    st = serving.stats
    tok_per_s = batch * steps / wall
    print(f"generated {tuple(gen_host.shape)} tokens in {wall:.2f}s "
          f"({tok_per_s:.1f} tok/s incl. retrieval)")
    print(f"retrieval: {st.batches} batches, {st.queries} queries, "
          f"recompiles={st.compiles}, host={1e3 * st.host_s:.1f}ms "
          f"({100 * st.host_fraction():.0f}%), device={1e3 * st.device_s:.1f}ms, "
          f"overlap={100 * st.overlap_fraction():.0f}%, "
          f"p50={1e3 * st.p50_s():.1f}ms, p99={1e3 * st.p99_s():.1f}ms")
    print(f"early pruning: {st.tiles_skipped}/{st.tiles_dispatched} tile bodies "
          f"skipped ({100 * st.prune_fraction():.0f}%), "
          f"{st.rows_pruned} rows never computed, "
          f"warm-start bounds on {st.warm_bound_queries}/{st.queries} queries "
          f"(results bit-identical to the unpruned scan)")
    print("sample:", gen_host[0, :10].tolist())

    # --- live corpus mutation: insert a document, retrieve it immediately ---
    # a "new document" lands in the corpus mid-serving; its embedding goes
    # into the delta buffer (PQ-encoded, assigned to its nearest centroid)
    # and the very next query can retrieve it -- no index rebuild
    new_doc_id = xs.shape[0]
    new_doc = (qvec[0] + np.random.default_rng(3).normal(0, 0.05, qvec.shape[1])
               ).astype(np.float32)
    serving.insert(np.asarray([new_doc_id]), new_doc[None])
    _, ids_after = serving.search(qvec[:1])
    assert new_doc_id in ids_after[0], ids_after
    rank = ids_after[0].tolist().index(new_doc_id)
    print(f"live insert: doc {new_doc_id} retrievable immediately "
          f"(rank {rank}), recompiles still {serving.stats.compiles}, "
          f"delta occupancy {serving.stats.delta_occupancy:.4f}")
    # retiring it tombstones the id; the next search filters it out
    serving.delete(np.asarray([new_doc_id]))
    _, ids_gone = serving.search(qvec[:1])
    assert new_doc_id not in ids_gone[0]
    print(f"live delete: doc {new_doc_id} gone from results, "
          f"tombstones={serving.stats.tombstones}; compaction folds the delta "
          f"back into the main index in the background "
          f"(compactions so far: {serving.stats.compactions})")
    return {"tok_per_s": tok_per_s, "generated": gen_host, "doc_ids": doc_ids,
            "insert_rank": rank, "compiles": serving.stats.compiles,
            "tensors": {"logits": logits, "generated": gen, "cache": cache,
                        "params": dict(params.named_parameters())}}


if __name__ == "__main__":
    main()
