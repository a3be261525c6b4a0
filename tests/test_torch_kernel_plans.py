"""Launch plans of B3 (`rerank.launch_plan`) and of B1's wide kernel
(`lut_build.wide_plan`), the Python twins of how `csrc/rerank.cu` and
`csrc/lut_build.cu` cut their work.

Hypothesis properties: every output entry is covered by exactly one block,
every coordinate by exactly one chunk or slice, copies and reads stay
aligned, shared memory stays within a block's 227 KB, and the grid fills
the card at the LM retrieval's shapes.  Then the kernels' addressing is
replayed on the CPU (numpy, byte for byte through the planned shared-memory
layout, with each product and sum rounded to f32 as the kernels do) and
held bit-equal to the plain versions: a wrong offset, stride or chunk
shows here before it reaches the card.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import lut_build, rerank  # noqa: E402

H100_SMS = 132
SMEM_LIMIT = 232_448  # 227 KB, what one block may have on an H100


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


# -- B3 -------------------------------------------------------------------


@settings(max_examples=300, deadline=None)
@given(q_n=st.integers(1, 3000), k=st.integers(1, 600), d=st.integers(1, 9000),
       elem=st.sampled_from([2, 4]), n_sm=st.sampled_from([1, 8, 132]),
       block_k=st.integers(0, 700), align=st.sampled_from([2, 4, 8, 16, 256]))
def test_rerank_plan_properties(q_n, k, d, elem, n_sm, block_k, align):
    align = max(align, elem)
    p = rerank.launch_plan(q_n, k, d, elem, n_sm, block_k, align)
    cpb, nkb = p["cpb"], p["nkb"]
    # each (query, candidate) in exactly one block: a query's nkb blocks
    # cover [0, k) in slices of cpb, the last one shorter
    assert 1 <= cpb <= min(rerank.CAND_MAX, k) and (block_k == 0 or cpb <= block_k)
    assert (nkb - 1) * cpb < k <= nkb * cpb and p["blocks"] == q_n * nkb
    for b in (0, nkb - 1, p["blocks"] - 1):
        qi, k0, nc = rerank.plan_block(p, b, k)
        assert qi == b // nkb and k0 == (b % nkb) * cpb and 1 <= nc <= cpb
    # the grid fills the card where the candidates allow
    assert p["blocks"] >= min(2 * n_sm, math.ceil(q_n * k / rerank.CAND_MAX))
    # each lane's coordinates in exactly one chunk, the query's in registers
    per, pc = p["per"], p["pc"]
    assert per == math.ceil(d / 32) and pc <= p["qreg"] and pc <= rerank.LANE_CHUNK_MAX
    assert (p["n_chunks"] - 1) * pc < per <= p["n_chunks"] * pc
    assert 1 <= p["stages"] <= min(p["n_chunks"], rerank.STAGES_MAX)
    assert p["stages"] >= min(2, p["n_chunks"])  # a chunk in flight while one is summed
    # reads: rv bytes at offsets that are multiples of rv, lanes on distinct banks
    rv, seg, g = p["rv"], p["seg"], p["g"]
    assert _pow2(rv) and rv <= 16 and (pc * elem) % rv == 0 and (per * elem) % rv == 0
    assert seg % rv == 0 and (seg // rv) % 2 == 1 and seg >= pc * elem
    # copies: g bytes, aligned at both ends
    assert g in (2, 4, 8, 16) and align % g == 0 and (d * elem) % g == 0 and g >= elem
    if p["contig"]:
        assert p["n_chunks"] == 1 and seg == per * elem
    else:
        assert (per * elem) % g == 0 and (pc * elem) % g == 0 and seg % g == 0
    # the query's chunk: odd lane strides, at the start of each 16-byte aligned slot
    assert p["segq"] % 2 == 1 and p["segq"] >= pc
    assert p["stage_bytes"] == 32 * p["segq"] * 4 + cpb * 32 * seg and p["stage_bytes"] % 16 == 0
    assert p["smem"] == max(p["stages"] * p["stage_bytes"], cpb * rerank.PART_BYTES)
    assert p["smem"] <= rerank.SMEM_BUDGET <= SMEM_LIMIT


@pytest.mark.parametrize("d, elem", [(128, 2), (4096, 2), (4096, 4)])
def test_rerank_plan_at_path_shapes(d, elem):
    """The main path (1000 queries x k' 64, D 128 bf16): a query's 64
    candidates a block, whole 256-byte rows in 16-byte copies; the LM retrieval (4
    queries x 64, D 4096): one candidate a block, 256 blocks, every chunk
    of the row in flight at once."""
    q_n = 1000 if d == 128 else 4
    p = rerank.launch_plan(q_n, 64, d, elem, H100_SMS)
    assert p["g"] == 16 and p["blocks"] >= H100_SMS
    if d == 128:
        assert p["cpb"] == 64 and p["contig"] and p["blocks"] == 1000
    else:
        assert p["cpb"] == 1 and p["blocks"] == 256 and p["stages"] == p["n_chunks"] == 4


def _widen(raw: np.ndarray, elem: int) -> np.ndarray:
    if elem == 4:
        return raw.view(np.float32)
    return (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _emulate_rerank(queries, cand, store, elem, id_dev, id_row, row_base, plan):
    """csrc/rerank.cu replayed block by block: the same ids, copies (unit by
    unit, into the planned shared-memory bytes) and lane reads, each lane's
    terms added in f32 in order, then the butterfly.  `store` is the raw
    bytes of the (rows, D) store."""
    q_n, k = cand.shape
    d = queries.shape[1]
    p = plan
    row_bytes = d * elem
    q_bytes = 32 * p["segq"] * 4
    cand_bytes = 32 * p["seg"]
    stage_bytes = p["stage_bytes"]
    out = np.zeros((q_n, k), np.float32)
    for b in range(p["blocks"]):
        qi, k0, nc = rerank.plan_block(p, b, k)
        s_row = []
        for t in range(nc):
            c = int(cand[qi, k0 + t])
            dev = int(id_dev[c]) if 0 <= c < len(id_dev) else -1
            s_row.append(-1 if dev < 0 else int(row_base[dev]) + int(id_row[c]))
        buf = np.full(p["stages"] * stage_bytes, 0xFF, np.uint8)  # stale: NaN

        def issue(c, sb):
            for u in range(32 * p["pc"]):  # the query's chunk, 4 bytes a copy
                ll, e = divmod(u, p["pc"])
                dd = ll * p["per"] + c * p["pc"] + e
                if c * p["pc"] + e < p["per"] and dd < d:
                    at = sb * stage_bytes + (ll * p["segq"] + e) * 4
                    buf[at: at + 4] = queries[qi, dd: dd + 1].view(np.uint8)
            units = []  # (candidate, byte in its shared-memory segment, byte in its row)
            if p["contig"]:
                upr = row_bytes // p["g"]
                units = [(u // upr, u % upr * p["g"], u % upr * p["g"]) for u in range(nc * upr)]
            else:
                ups = p["pc"] * elem // p["g"]
                for u in range(nc * 32 * ups):
                    j, w = divmod(u, 32 * ups)
                    ll, o = divmod(w, ups)
                    o *= p["g"]
                    e0 = ll * p["per"] + c * p["pc"]
                    if o < min(p["pc"], p["per"] - c * p["pc"], d - e0) * elem:
                        units.append((j, ll * p["seg"] + o, e0 * elem + o))
            for j, so, ro in units:
                if s_row[j] < 0:
                    continue
                dst = sb * stage_bytes + q_bytes + j * cand_bytes + so
                src = s_row[j] * row_bytes + ro
                assert src % p["g"] == 0 and dst % p["g"] == 0
                buf[dst: dst + p["g"]] = store[src: src + p["g"]]

        acc = np.zeros((nc, 32), np.float32)
        for s in range(p["stages"]):
            issue(s, s)
        for c in range(p["n_chunks"]):
            lenc = min(p["pc"], p["per"] - c * p["pc"])
            for lane in range(32):
                d0 = lane * p["per"] + c * p["pc"]
                at = (c % p["stages"]) * stage_bytes + lane * p["segq"] * 4
                qv = buf[at: at + lenc * 4].copy().view(np.float32)
                for j in range(nc):
                    if s_row[j] < 0:
                        continue
                    at = ((c % p["stages"]) * stage_bytes + q_bytes + j * cand_bytes
                          + lane * p["seg"])
                    assert at % p["rv"] == 0
                    x = _widen(buf[at: at + lenc * elem].copy(), elem)
                    a = acc[j, lane]
                    for e in range(lenc):
                        if d0 + e < d:
                            diff = np.float32(x[e] - qv[e])
                            a = np.float32(a + np.float32(diff * diff))
                    acc[j, lane] = a
            if c + p["stages"] < p["n_chunks"]:
                issue(c + p["stages"], c % p["stages"])
        for j in range(nc):
            a = acc[j]
            for off in (16, 8, 4, 2, 1):
                a = (a + a[np.arange(32) ^ off]).astype(np.float32)
            out[qi, k0 + j] = np.inf if s_row[j] < 0 else a[0]
    return out


@pytest.mark.parametrize("d, dtype, n_sm, block_k", [
    (128, "bfloat16", 132, 0),   # the main path's layout: whole rows, 16-byte copies
    (100, "bfloat16", 4, 0),     # 200-byte rows: 8-byte copies, idle lanes
    (100, "float32", 2, 3),      # block_k caps the candidates a block
    (1100, "bfloat16", 1, 0),    # two chunks of odd width: 2-byte copies and reads
    (1280, "float32", 1, 0),     # two chunks, padded 144-byte lane segments
    (4096, "bfloat16", 132, 0),  # the LM retrieval: four chunks in flight
])
def test_rerank_kernel_addressing_bit_equal(d, dtype, n_sm, block_k):
    rng = np.random.default_rng(d)
    q_n, k, rows, ndev = 3, 7, 40, 3
    elem = 2 if dtype == "bfloat16" else 4
    queries = rng.normal(size=(q_n, d)).astype(np.float32)
    vecs = rng.normal(size=(rows, d)).astype(np.float32)
    tdt = torch.bfloat16 if elem == 2 else torch.float32
    raw = torch.as_tensor(vecs).to(tdt).view(torch.int16 if elem == 2 else torch.int32).numpy()
    ids_cap = rows + 4
    id_dev = np.full(ids_cap, -1, np.int32)
    id_row = np.zeros(ids_cap, np.int32)
    id_dev[:rows] = np.arange(rows) % ndev
    id_row[:rows] = np.arange(rows) // ndev
    per_dev = np.bincount(id_dev[:rows], minlength=ndev)
    row_base = np.concatenate([[0], np.cumsum(per_dev)[:-1]]).astype(np.int64)
    store_rows = np.zeros((rows, d), raw.dtype)  # device shards back to back
    store_rows[row_base[id_dev[:rows]] + id_row[:rows]] = raw
    cand = rng.integers(-2, ids_cap + 3, (q_n, k)).astype(np.int32)
    cand[0, 0], cand[1, 1] = -1, rows + 1  # absent, and unmapped
    align = 16 if d * elem % 16 == 0 else 8
    plan = rerank.launch_plan(q_n, k, d, elem, n_sm, block_k, align)
    got = _emulate_rerank(queries, cand, store_rows.view(np.uint8).reshape(-1), elem,
                          id_dev, id_row, row_base, plan)
    want = rerank.rerank_dists_plain(
        torch.as_tensor(queries), torch.as_tensor(cand),
        torch.as_tensor(vecs[np.argsort(row_base[id_dev[:rows]] + id_row[:rows])]).to(tdt),
        torch.as_tensor(id_dev), torch.as_tensor(id_row), torch.as_tensor(row_base))
    np.testing.assert_array_equal(got.view(np.uint32), want.numpy().view(np.uint32))
    assert np.isinf(got[0, 0]) and np.isinf(got[1, 1])


# -- B1, wide kernel --------------------------------------------------------


@settings(max_examples=300, deadline=None)
@given(n_pairs=st.integers(1, 70_000), m=st.integers(1, 64), dsub=st.integers(1, 5000),
       n_sm=st.sampled_from([1, 8, 132]), align=st.sampled_from([4, 8, 16, 256]))
def test_lut_wide_plan_properties(n_pairs, m, dsub, n_sm, align):
    p = lut_build.wide_plan(n_pairs, m, dsub, n_sm, align)
    pg, cw = p["pg"], p["cw"]
    assert _pow2(pg) and pg <= lut_build.WIDE_PG_MAX and _pow2(cw) and cw <= 256
    assert pg * cw <= lut_build.WIDE_ENTRIES_MAX
    # each (pair, sub-space, codeword) in exactly one block
    assert p["ncw"] * cw == 256 and (p["npg"] - 1) * pg < n_pairs <= p["npg"] * pg
    assert p["blocks"] == m * p["ncw"] * p["npg"]
    for b in (0, p["blocks"] - 1):
        mi, j0, p0, np_ = lut_build.wide_block(p, b, m, n_pairs)
        assert 0 <= mi < m and j0 % cw == 0 and p0 % pg == 0 and 1 <= np_ <= pg
    # the card is filled whenever some cut can fill it
    if m * 256 * n_pairs >= n_sm:
        assert p["blocks"] >= n_sm
    # every coordinate in exactly one slice; slices in flight; LDS.128 rows
    ds = p["ds"]
    assert ds % 4 == 0 and (p["n_slices"] - 1) * ds < dsub <= p["n_slices"] * ds
    assert 1 <= p["stages"] <= min(p["n_slices"], lut_build.WIDE_STAGES_MAX)
    assert p["stride"] >= ds and p["stride"] % 4 == 0 and (p["stride"] // 4) % 2 == 1
    assert p["g"] in (4, 8, 16) and align % p["g"] == 0 and (dsub * 4) % p["g"] == 0
    assert p["threads"] % 32 == 0 and pg * cw <= p["threads"] <= 256
    assert p["smem"] == p["stages"] * (pg + cw) * p["stride"] * 4
    assert p["smem"] <= lut_build.WIDE_SMEM_BUDGET <= SMEM_LIMIT


@pytest.mark.parametrize("n_pairs, m, dsub", [(32, 8, 512), (4, 8, 512), (32, 8, 1024)])
def test_lut_wide_plan_fills_card_at_lm_shapes(n_pairs, m, dsub):
    """The LM retrieval (4 queries x nprobe 8 = 32 pairs, M = 8, dsub 512):
    16 pairs x 16 codewords a block (a thread each), 256 blocks, its four
    128-wide slices all in flight at once."""
    p = lut_build.wide_plan(n_pairs, m, dsub, H100_SMS)
    assert p["blocks"] >= H100_SMS and p["g"] == 16
    assert 2 * (p["smem"] + 1024) <= SMEM_LIMIT + 1024  # two blocks an SM
    if (n_pairs, dsub) == (32, 512):
        assert (p["pg"], p["cw"], p["blocks"], p["stages"], p["n_slices"]) == (16, 16, 256, 4, 4)


def test_lut_wide_plan_covers_entries_once():
    for n_pairs, m, dsub, n_sm in [(3, 2, 7, 4), (37, 3, 100, 132), (1000, 2, 48, 132)]:
        p = lut_build.wide_plan(n_pairs, m, dsub, n_sm)
        seen = np.zeros((n_pairs, m, 256), np.int32)
        for b in range(p["blocks"]):
            mi, j0, p0, np_ = lut_build.wide_block(p, b, m, n_pairs)
            seen[p0: p0 + np_, mi, j0: j0 + p["cw"]] += 1
        assert (seen == 1).all()


def _emulate_lut_wide(codebook, qmc, rows, plan):
    """csrc/lut_build.cu's wide kernel replayed block by block: slices copied
    into the planned rows of shared memory (stale values elsewhere), each
    thread's entry (pair tp, codeword tc) summed over d in order in f32."""
    m, _, dsub = codebook.shape
    n_pairs = len(rows)
    p = plan
    pg, cw, stride, ds = p["pg"], p["cw"], p["stride"], p["ds"]
    out = np.full((n_pairs, m, 256), np.nan, np.float32)
    tid = np.arange(pg * cw)
    tc, tp = tid % cw, tid // cw
    for b in range(p["blocks"]):
        mi, j0, p0, np_ = lut_build.wide_block(p, b, m, n_pairs)
        sm = np.full((p["stages"], pg + cw, stride), np.nan, np.float32)  # stale

        def issue(s, sb):
            d0 = s * ds
            w = min(ds, dsub - d0)
            assert w * 4 % p["g"] == 0
            for r in range(pg + cw):
                if r < pg:
                    if r >= np_:
                        continue
                    src = qmc[rows[p0 + r], mi, d0: d0 + w]
                else:
                    src = codebook[mi, j0 + r - pg, d0: d0 + w]
                sm[sb, r, :w] = src

        for s in range(p["stages"]):
            issue(s, s)
        acc = np.zeros(len(tid), np.float32)
        for c in range(p["n_slices"]):
            base = sm[c % p["stages"]]
            w = min(ds, dsub - c * ds)
            for d in range(w):
                diff = (base[tp, d] - base[pg + tc, d]).astype(np.float32)
                acc = (acc + (diff * diff).astype(np.float32)).astype(np.float32)
            if c + p["stages"] < p["n_slices"]:
                issue(c + p["stages"], c % p["stages"])
        keep = tp < np_
        out[p0 + tp[keep], mi, j0 + tc[keep]] = acc[keep]
    return out


@pytest.mark.parametrize("n_pairs, m, dsub, n_sm", [
    (3, 2, 7, 4),       # odd width: 4-byte copies, a ragged last quad
    (5, 2, 48, 132),    # one slice
    (2, 1, 300, 8),     # three slices of 128, the last 44 wide, all in flight
    (33, 1, 520, 132),  # five slices, a ring of stages, a second pair group
])
def test_lut_wide_kernel_addressing_bit_equal(n_pairs, m, dsub, n_sm):
    rng = np.random.default_rng(dsub)
    cb = rng.normal(size=(m, 256, dsub)).astype(np.float32)
    qmc = rng.normal(size=(n_pairs + 2, m, dsub)).astype(np.float32)
    rows = rng.integers(0, n_pairs + 2, n_pairs).astype(np.int32)
    rows[-1] = rows[0]  # a repeated residual
    plan = lut_build.wide_plan(n_pairs, m, dsub, n_sm)
    got = _emulate_lut_wide(cb, qmc, rows, plan)
    want = lut_build.build_luts_plain(torch.as_tensor(cb), torch.as_tensor(qmc[rows])).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
