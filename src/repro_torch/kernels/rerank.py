"""Kernel B3 (exact re-rank, gather fused): plain version and launcher.

The CUDA source is `csrc/rerank.cu`; `ops.rerank_dists` is the wrapper.
A candidate is a global vector id; its raw row lives in its home device's
shard of a `RawStore`: row `row_base[id_dev[c]] + id_row[c]` of `vectors`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

LANES = 32  # one warp per candidate


def candidate_rows(
    cand: torch.Tensor,
    id_dev: torch.Tensor,
    id_row: torch.Tensor,
    row_base: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows (Q, K) int64 into `vectors`, valid (Q, K) bool) of candidates.

    A candidate is valid when it is >= 0, inside the id map and mapped
    (id_dev >= 0); invalid lanes get row 0.
    """
    ids_cap = id_dev.shape[0]
    valid = (cand >= 0) & (cand < ids_cap)
    c = cand.clamp(0, ids_cap - 1).long()
    dev = torch.where(valid, id_dev[c].long(), -1)
    valid = valid & (dev >= 0)
    rows = row_base[dev.clamp_min(0)] + id_row[c].long()
    return torch.where(valid, rows, 0), valid


def rerank_dists_plain(
    queries: torch.Tensor,
    cand: torch.Tensor,
    vectors: torch.Tensor,
    id_dev: torch.Tensor,
    id_row: torch.Tensor,
    row_base: torch.Tensor,
    block_k: int = 0,
) -> torch.Tensor:
    """(Q, D) queries x (Q, K) candidate ids -> (Q, K) f32 sq-L2 (+inf invalid).

    The kernel's reduction order step for step: lane l of a warp sums its
    contiguous ceil(D/32) coordinates in order, then the lanes fold with
    offsets 16, 8, 4, 2, 1; every product and sum is rounded on its own.
    So the result is bit-equal to the kernel, and `block_k` (candidates
    per step) changes nothing.
    """
    q_n, k = cand.shape
    d = queries.shape[1]
    per = -(-d // LANES)
    rows, valid = candidate_rows(cand, id_dev, id_row, row_base)
    out = torch.empty((q_n, k), dtype=torch.float32, device=queries.device)
    bk = block_k or k
    for k0 in range(0, k, bk):
        x = vectors[rows[:, k0 : k0 + bk]].float()       # (Q, kb, D)
        diff = x - queries.float()[:, None, :]
        sq = torch.nn.functional.pad(diff * diff, (0, LANES * per - d))
        sq = sq.reshape(q_n, -1, LANES, per)
        acc = torch.zeros(sq.shape[:-1], dtype=torch.float32, device=sq.device)
        for e in range(per):
            acc = acc + sq[..., e]
        n = LANES
        while n > 1:
            n //= 2
            acc = acc[..., :n] + acc[..., n : 2 * n]
        out[:, k0 : k0 + bk] = acc[..., 0]
    return torch.where(valid, out, torch.inf)


def launch(queries, cand, vectors, id_dev, id_row, row_base, out, block_k: int) -> None:
    """Enqueue `csrc/rerank.cu` on the current stream (checked inputs)."""
    q_n, k = cand.shape
    err = _build.library().rerank_launch(
        queries.data_ptr(), cand.data_ptr(), id_dev.data_ptr(),
        id_row.data_ptr(), row_base.data_ptr(), vectors.data_ptr(),
        out.data_ptr(), q_n, k, queries.shape[1], id_dev.shape[0],
        int(vectors.dtype == torch.bfloat16), block_k,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    _build.check(err, "rerank")
