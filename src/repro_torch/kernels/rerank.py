"""Kernel B3 (exact re-rank, gather fused): plain version, launch plan, launcher.

The CUDA source is `csrc/rerank.cu`; `ops.rerank_dists` is the wrapper.
A candidate is a global vector id; its raw row lives in its home device's
shard of a `RawStore`: row `row_base[id_dev[c]] + id_row[c]` of `vectors`.
`launch_plan` is the kernel's launch plan, which `launch` passes to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

LANES = 32  # one warp per candidate
CAND_MAX = 64  # candidates a block (a whole query's k' on the main path): 16 a warp
# coordinates of a lane's share of a row held at once (the query's in
# registers): rows up to 32 * 32 coordinates arrive whole, longer ones in chunks
LANE_CHUNK_MAX = 32
QREG_SMALL = 8  # the kernel variant with 8 query registers, for ceil(D/32) <= 8
STAGES_MAX = 8  # chunks in flight
SMEM_BUDGET = 48 * 1024  # dynamic shared memory a block asks for (no attribute needed)
# a candidate's 32 lane partials, folded after the ring is consumed (36 floats
# apart: an odd number of 16-byte quads)
PART_BYTES = 36 * 4
# the plan's numbers in the order `csrc/rerank.cu` reads them from the int
# array `rerank_launch` takes
PLAN_FIELDS = ("per", "pc", "n_chunks", "seg", "segq", "contig", "g", "cpb", "nkb", "stages",
               "rv", "qreg", "smem")


@functools.lru_cache(maxsize=256)
def launch_plan(
    q_n: int, k: int, d: int, elem: int, n_sm: int, block_k: int = 0, align: int = 16
) -> dict:
    """How `csrc/rerank.cu` cuts a (q_n, k) re-rank of d-wide rows of
    `elem`-byte values (4 f32, 2 bf16) over a card of `n_sm` SMs, whose
    store starts at an address that is a multiple of `align` bytes.

    Lane l of a candidate's warp owns coordinates [l * per, (l + 1) * per)
    (per = ceil(d / 32)), taken `pc` at a time: chunk c holds lane-local
    coordinates [c * pc, min(per, (c + 1) * pc)) of every lane.  In shared
    memory a chunk of one candidate is 32 lane segments `seg` bytes apart;
    `seg` is the chunk's bytes, plus `rv` when the lanes' `rv`-byte reads
    would fall on the same banks.  When the row arrives whole and unpadded
    (`contig`) it is one copy of d * elem bytes.  Copies move `g` bytes
    each (16, 8, 4 or 2, as addresses and sizes allow).  The query's chunk
    sits at the start of each ring slot: 32 lane segments of `segq` f32
    words (odd, so the lanes' reads fall on distinct banks), 4-byte copies.
    After the last chunk the ring holds the candidates' lane partials
    (`PART_BYTES` each), so `smem` covers both.

    A block takes `cpb` candidates of one query (fewer at the end of a
    row): block b covers query b // nkb, candidates [(b % nkb) * cpb, ...).
    `cpb` is sized so that the grid has at least two blocks an SM where
    q_n * k allows, at most CAND_MAX and at most `block_k` (when > 0).
    `stages` chunks are in flight; the block's dynamic shared memory is
    `smem` bytes.  (Cached: callers must not change the dict.)
    """
    if min(q_n, k, d, elem) <= 0:
        raise ValueError(f"rerank plan: q_n={q_n}, k={k}, d={d}, elem={elem}")
    per = -(-d // LANES)
    pc = min(per, LANE_CHUNK_MAX)
    n_chunks = -(-per // pc)
    pcb = pc * elem
    rv = _build.pow2_dividing(pcb, per * elem)
    seg = pcb if (pcb // rv) % 2 else pcb + rv
    contig = n_chunks == 1 and seg == pcb
    if contig:
        g = _build.pow2_dividing(align, d * elem)
    else:
        g = _build.pow2_dividing(align, d * elem, per * elem, pcb, seg)
    segq = pc | 1
    q_bytes = LANES * segq * 4
    cand_bytes = LANES * seg
    min_stages = 1 if n_chunks == 1 else 2
    cpb = min(CAND_MAX, max(1, q_n * k // (2 * n_sm)), k,
              max(1, (SMEM_BUDGET // min_stages - q_bytes) // cand_bytes))
    if block_k > 0:
        cpb = min(cpb, block_k)
    stage_bytes = q_bytes + cpb * cand_bytes
    stages = 1 if n_chunks == 1 else min(n_chunks, STAGES_MAX, SMEM_BUDGET // stage_bytes)
    nkb = -(-k // cpb)
    return dict(
        per=per, pc=pc, n_chunks=n_chunks, rv=rv, seg=seg, segq=segq, contig=contig, g=g,
        qreg=QREG_SMALL if per <= QREG_SMALL else LANE_CHUNK_MAX, cpb=cpb, nkb=nkb,
        blocks=q_n * nkb, stages=stages, stage_bytes=stage_bytes,
        smem=max(stages * stage_bytes, cpb * PART_BYTES),
    )


@functools.lru_cache(maxsize=256)
def _plan_array(q_n: int, k: int, d: int, elem: int, block_k: int, device, addr_low: int):
    """`launch_plan` for `device`'s SMs and a store whose address ends in
    `addr_low` (its low four bits), as the int array `rerank_launch` reads:
    one cached lookup a launch, so that a launch costs the host no more
    than a plain argument list (the kernel is shorter than its launch)."""
    plan = launch_plan(q_n, k, d, elem, _build.sm_count(device), block_k,
                       _build.pow2_dividing(addr_low))
    return (ctypes.c_int * len(PLAN_FIELDS))(*(int(plan[f]) for f in PLAN_FIELDS))


def plan_block(plan: dict, b: int, k: int) -> tuple[int, int, int]:
    """(query, first candidate, candidates) of block b, as the kernel reads them."""
    qi, kb = divmod(b, plan["nkb"])
    k0 = kb * plan["cpb"]
    return qi, k0, min(plan["cpb"], k - k0)


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
    """Enqueue `csrc/rerank.cu` on the current stream (checked inputs), cut
    by `launch_plan`."""
    q_n, k = cand.shape
    d = queries.shape[1]
    if q_n == 0 or k == 0:
        return
    dev = queries.device
    vp = vectors.data_ptr()
    err = _build.library().rerank_launch(
        queries.data_ptr(), cand.data_ptr(), id_dev.data_ptr(),
        id_row.data_ptr(), row_base.data_ptr(), vp,
        out.data_ptr(), q_n, k, d, id_dev.shape[0], row_base.shape[0],
        int(vectors.dtype == torch.bfloat16),
        _plan_array(q_n, k, d, vectors.element_size(), block_k, dev, vp & 15),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "rerank")
