"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: these tests need an NVIDIA GPU with nvcc and skip elsewhere
(a CUDA kernel has no CPU mode).  On the card run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel's plain version repeats its arithmetic in the same order, so
tables (B1, B4, B9), ADC distances (B2 and B5, raw uint8 codes of width 8,
16 and 32 at k 1, 64 and 4096, and uint16 / int32 direct addresses) and
re-rank distances (B3) must be bit-equal; the pruned scans must equal the
unpruned ones after the per-query merge, and a whole engine on the card (plain or co-occurrence
shards, either scan) must return the engine-on-CPU answers, a mutable
one too (inserts, deletes, compaction), and the delta scan (B1 + B5 over
the cluster-sorted view) must equal `delta_topk_plain` bit for bit.  The
kernel-level API -- B8 (`adc_scan`), B6 (`adc_topk`, with and without a
finite bound, at 1 to 16 tables and k up to 4096; `adc_topk_grouped`) and B7
(`adc_topk_pairs`) -- is bit-equal to its plain versions in one launch per
call, and the flat search on B1 + B6 (one launch each) equals the flat
search on the CPU.
The onehot path (every row's entries added in ascending address order)
of B2, B5, B6, B7 and B8 is bit-equal to its plain onehot version at
compiled and runtime widths, equal to the gather on raw codes and on
sorted addresses, and a onehot engine and a ServingEngine over it (depths
0 and 1) on the card equal the engine on the CPU.
B10 (`flash_attention_fwd`) is held to its plain version at the reference's
f32 tolerance (rtol 1e-4, atol 1e-5) and, with a bf16 q, to one bf16 ulp,
over every head dim, GQA 1 / 4 / 8, each (q, kv) dtype pair, offsets, dead
keys past kv_valid and peaked scores; a reduced LM's prefill through B10
equals the chunked scan and the CPU.
Mutable serving (a churn stream with compactions, depths 0 and 1) and the
failover twin (a dead device, a hung collect) on the card equal their CPU
runs bit for bit.  An OPQ-rotated engine on the card (with inserts)
equals the CPU engine; a retile, a non-default `rerank_block` and a swept
geometry change no bit on plain and co-occurrence shards; an engine saved
from the card loads on the CPU and answers as on the card.
This file imports no JAX (the card's machine has none).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.scheduling import (  # noqa: E402
    emit_tiles,
    residual_bounds,
    subspace_code_norms,
    warm_start_bounds,
)
from repro_torch.kernels import adc_scan, adc_topk, flash_attn, lut_build, ops, rerank  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n_pairs", [1, 3, 32, 1000])
@pytest.mark.parametrize("dsub", [4, 8, 7, 48, 100, 512, 1024])
def test_lut_kernel_bit_equal(cuda, dsub, n_pairs):
    """dsub 4 and 8 take `lut_build_kernel<dsub>`; the others the wide
    kernel (`lut_build.wide_plan`: 4-byte copies at dsub 7, one slice at 48
    and 100, slices of 128 in flight at 512 and 1024), one launch each."""
    g = torch.Generator(device=cuda).manual_seed(dsub * 7 + n_pairs)
    cb = torch.randn(16, 256, dsub, device=cuda, generator=g)
    qmc = torch.randn(n_pairs, 16, dsub, device=cuda, generator=g)
    ops.reset_launches()
    got = ops.build_luts(cb, qmc)
    torch.cuda.synchronize()
    assert ops.launches["build_luts"] == 1
    assert torch.equal(got, lut_build.build_luts_plain(cb, qmc))


@pytest.mark.parametrize("n_pairs", [1, 3, 32, 1000])
@pytest.mark.parametrize("dsub", [8, 7, 48, 100, 512, 1024])
def test_lut_kernel_rows_bit_equal(cuda, dsub, n_pairs):
    """A `rows` list with repeats picks the residuals, as the query path's
    filled pairs do; at M = 8 and 32 pairs of dsub 512 this is the LM
    retrieval's call."""
    g = torch.Generator(device=cuda).manual_seed(dsub * 11 + n_pairs)
    m = 8 if dsub >= 512 else 16
    cb = torch.randn(m, 256, dsub, device=cuda, generator=g)
    qmc = torch.randn(n_pairs + 5, m, dsub, device=cuda, generator=g)
    rows = torch.randint(0, n_pairs + 5, (n_pairs,), device=cuda, generator=g).int()
    rows[-1] = rows[0]
    ops.reset_launches()
    got = ops.build_luts(cb, qmc, rows)
    torch.cuda.synchronize()
    assert ops.launches["build_luts"] == 1
    assert got.shape == (n_pairs, m, 256)
    assert torch.equal(got, lut_build.build_luts_plain(cb, qmc[rows.long()]))


def _tile_case(dev, seed, q=6, nprobe=8, m=16, dsub=8, block_n=128, k=32, spread=1.0):
    rng = np.random.default_rng(seed)
    p = q * nprobe
    cb = rng.normal(size=(m, 256, dsub)).astype(np.float32)
    qmc = rng.normal(0, 2, size=(q, nprobe, m * dsub)).astype(np.float32)
    qmc *= (1.0 + spread * np.arange(nprobe, dtype=np.float32))[None, :, None]
    sizes = rng.integers(0, 5 * block_n, p).astype(np.int32)
    # an empty pair, a pair of 5 rows, and one whose rows are a multiple of
    # neither 32 nor block_n
    sizes[0], sizes[1], sizes[3] = 0, 5, 2 * block_n + 33
    aligned = (sizes + block_n - 1) // block_n * block_n
    starts = np.zeros(p, np.int32)
    starts[1:] = np.cumsum(aligned)[:-1]
    cap = max(int(aligned.sum()), block_n)
    codes = rng.integers(0, 256, (cap, m)).astype(np.uint8)
    lb, ub = residual_bounds(qmc, subspace_code_norms(cb))
    b0 = warm_start_bounds(ub, sizes.reshape(q, nprobe), k)
    n_tiles = int(((sizes + block_n - 1) // block_n).sum())
    tp, tb, tr = emit_tiles(
        np.arange(p, dtype=np.int32)[None], np.ones((1, p), bool), starts[None],
        sizes[None], block_n, n_tiles + 7, pair_key=lb.reshape(1, p),
    )
    luts = lut_build.build_luts_plain(
        torch.as_tensor(cb, device=dev), torch.as_tensor(qmc.reshape(p, m, dsub), device=dev)
    )
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    return dict(
        luts=luts, codes=t(codes), tile_pair=t(tp[0]), tile_block=t(tb[0]),
        tile_row0=t(tr[0]), n_valid=t(sizes), starts=t(starts),
        pair_q=t(np.repeat(np.arange(q), nprobe)),
        pair_lb=t(lb.reshape(-1)), bound=t(b0), q=q, k=k, block_n=block_n,
    )


def _run_tiles(c, bounds, plain, lut_row=None):
    p = c["n_valid"].shape[0]
    dev = c["luts"].device
    pq = torch.arange(p, dtype=torch.int32, device=dev)
    lut_row = pq if lut_row is None else lut_row
    if not plain:
        kw = {}
        if bounds:
            kw = dict(pair_q=c["pair_q"], pair_lb=c["pair_lb"], bound=c["bound"])
        return ops.adc_topk_tiles(
            c["luts"], c["codes"], c["tile_pair"], c["tile_block"], c["tile_row0"],
            c["n_valid"], c["k"], lut_row=lut_row, block_n=c["block_n"], **kw,
        )
    t0, t1, _ = adc_topk.pair_runs(c["tile_pair"][None], p)
    return adc_topk.adc_topk_tiles_plain(
        c["luts"], lut_row, c["codes"][None],
        c["tile_block"].int(), c["tile_row0"].int(),
        c["n_valid"].int(), pq, torch.full((p,), -torch.inf, device=dev),
        torch.full((p,), torch.inf, device=dev), t0, t1, c["k"], c["block_n"],
    )


def _merge(v, i, pair_q, q, k):
    v, i, pair_q = v.cpu().numpy(), i.cpu().numpy(), pair_q.cpu().numpy()
    out = []
    for qi in range(q):
        ps = np.flatnonzero(pair_q == qi)
        d = v[ps].reshape(-1)
        ids = np.repeat(ps, v.shape[1]) * 1_000_000 + i[ps].reshape(-1)
        sel = np.argsort(d, kind="stable")[:k]
        out.append((d[sel], np.where(np.isfinite(d[sel]), ids[sel], -1)))
    return out


@pytest.mark.parametrize("k", [1, 64, 4096])
@pytest.mark.parametrize("w", [8, 16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiles_kernel_matches_plain(cuda, seed, w, k):
    c = _tile_case(cuda, seed, m=w, dsub=4, k=k)
    ops.reset_launches()
    kv, ki, ks = _run_tiles(c, bounds=False, plain=False)
    assert ops.launches["adc_topk_tiles"] == 1
    pv, pi, _ = _run_tiles(c, bounds=False, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert int(ks.sum()) == 0
    bv, bi, bs = _run_tiles(c, bounds=True, plain=False)
    n_tiles = (c["n_valid"] + c["block_n"] - 1) // c["block_n"]
    assert bool((bs[:, 0] <= n_tiles).all()) and bool((bs[:, 1] <= c["n_valid"]).all())
    for (d1, i1), (d2, i2) in zip(_merge(bv, bi, c["pair_q"], c["q"], c["k"]),
                                  _merge(kv, ki, c["pair_q"], c["q"], c["k"])):
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(i1, i2)


def test_tiles_kernel_lut_row_matches_plain(cuda):
    c = _tile_case(cuda, 4)
    p = c["n_valid"].shape[0]
    perm = torch.randperm(p, generator=torch.Generator().manual_seed(4)).to(cuda)
    lut_row = torch.argsort(perm).int()
    lut_row[2] = -1  # a pair without a table is not scanned
    c["luts"] = c["luts"][perm].contiguous()  # pair j's table is row lut_row[j]
    kv, ki, _ = _run_tiles(c, bounds=False, plain=False, lut_row=lut_row)
    pv, pi, _ = _run_tiles(c, bounds=False, plain=True, lut_row=lut_row)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert bool(torch.isinf(kv[2]).all()) and bool((ki[2] == -1).all())


@pytest.mark.parametrize("q", [4, 1000])
@pytest.mark.parametrize("kc", [1, 64, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 100, 4096])
def test_rerank_kernel_bit_equal(cuda, d, dtype, kc, q):
    """Whole rows in 16-byte copies (D 128), 200- / 400-byte rows (D 100),
    chunked 8 / 16 KB rows (D 4096); 8 devices' shards of the store, ids
    that are -1, beyond the id map or unmapped; one launch a call, and
    `block_k` changes no bit."""
    g = torch.Generator(device=cuda).manual_seed(d + kc + q)
    rows, ndev, ids_cap = 5000, 8, 5200
    queries = torch.randn(q, d, device=cuda, generator=g)
    vectors = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    id_dev = torch.full((ids_cap,), -1, dtype=torch.int32, device=cuda)
    id_row = torch.zeros(ids_cap, dtype=torch.int32, device=cuda)
    mapped = torch.randperm(ids_cap, device=cuda, generator=g)[:rows]  # the rest unmapped
    slot = torch.arange(rows, device=cuda)
    id_dev[mapped] = (slot % ndev).int()
    id_row[mapped] = (slot // ndev).int()
    row_base = (torch.arange(ndev, device=cuda) * ((rows + ndev - 1) // ndev)).long()
    cand = torch.randint(-1, ids_cap + 10, (q, kc), device=cuda, generator=g).int()
    want = rerank.rerank_dists_plain(queries, cand, vectors, id_dev, id_row, row_base, 32)
    assert bool(torch.isinf(want).any()) or kc == 1
    for bk in (0, 7):
        ops.reset_launches()
        got = ops.rerank_dists(queries, cand, vectors, id_dev, id_row, row_base, block_k=bk)
        torch.cuda.synchronize()
        assert ops.launches["rerank_dists"] == 1
        assert torch.equal(got, want)


def test_engine_on_card_matches_cpu(cuda, clustered_data):
    from repro_torch.retrieval.engine import MemANNSEngine

    xs, _, qs, hist = clustered_data
    eng = MemANNSEngine.build(
        xs, 32, 8, ndev=8, history_queries=hist, block_n=256, kmeans_iters=8,
        pq_iters=6, rerank="exact", device="cpu",
    )
    gpu = MemANNSEngine.from_reference(
        eng.index, eng.placement, xs, block_n=256, rerank="exact", device=cuda
    )
    assert np.array_equal(eng.schedule_batch(qs, 8)[1], gpu.schedule_batch(qs, 8)[1])
    for prune in (True, False):
        eng.prune = gpu.prune = prune
        d1, i1 = eng.search(qs, 8, 10)
        d2, i2 = gpu.search(qs, 8, 10)
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(i1, i2)


def test_ext_lut_kernels_bit_equal(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    r, m, n_combos, combo_len, n_sets = 1000, 16, 256, 3, 37
    luts = torch.randn(r, m, 256, device=cuda, generator=g).abs()
    caddr = torch.randint(0, m * 256, (n_sets, n_combos, combo_len), device=cuda,
                          generator=g).int()
    set_idx = torch.randint(0, n_sets, (r,), device=cuda, generator=g).int()
    ops.reset_launches()
    got = ops.build_ext_luts_pairs(luts, caddr, set_idx)
    got9 = ops.build_ext_luts(luts, caddr[0] // 256, caddr[0] % 256)
    torch.cuda.synchronize()
    assert ops.launches["build_ext_luts_pairs"] == ops.launches["build_ext_luts"] == 1
    flat = luts.reshape(r, -1)
    t_pad = m * 256 + n_combos + 1
    assert torch.equal(got, lut_build.ext_lut_pairs_plain(flat, caddr, set_idx, t_pad))
    assert torch.equal(got9, lut_build.ext_lut_plain(flat, caddr[0], t_pad))
    assert bool((got[:, -1] == 0).all())


def _direct(c, dtype):
    """Case `c` with direct addresses (col * 256 + code, then two sentinel
    columns) against [LUT | 5 entries | 0] tables."""
    p, m = c["luts"].shape[0], c["codes"].shape[1]
    dev = c["codes"].device
    off = torch.arange(m, device=dev, dtype=torch.int32) * 256
    sentinel = m * 256 + 5
    addr = torch.cat([c["codes"].int() + off,
                      torch.full((c["codes"].shape[0], 2), sentinel, dtype=torch.int32,
                                 device=dev)], 1)
    tables = torch.cat([c["luts"].reshape(p, -1), torch.rand(p, 5, device=dev),
                        torch.zeros(p, 1, device=dev)], 1)
    return dict(c, codes=addr.to(dtype).contiguous(), luts=tables.contiguous())


def _run_windows(c, bounds, plain):
    p = c["n_valid"].shape[0]
    dev = c["luts"].device
    lut_row = torch.arange(p, dtype=torch.int32, device=dev)
    if not plain:
        kw = {}
        if bounds:
            kw = dict(pair_q=c["pair_q"], pair_lb=c["pair_lb"], bound=c["bound"])
        return ops.adc_topk_windows(
            c["luts"], c["codes"], c["starts"], c["n_valid"], c["k"], lut_row=lut_row,
            block_n=c["block_n"], **kw,
        )
    return adc_topk.adc_topk_windows_plain(
        c["luts"], lut_row, c["codes"][None], c["starts"].int(), c["n_valid"].int(),
        lut_row, torch.full((p,), -torch.inf, device=dev),
        torch.full((p,), torch.inf, device=dev), c["k"], c["block_n"],
    )


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16])
@pytest.mark.parametrize("k", [1, 64, 4096])
@pytest.mark.parametrize("w", [8, 16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_windows_kernel_matches_plain(cuda, seed, w, k, dtype):
    c = _tile_case(cuda, seed, m=w, dsub=4, k=k)
    if dtype != torch.uint8:
        c = _direct(c, dtype)
    ops.reset_launches()
    kv, ki, ks = _run_windows(c, bounds=False, plain=False)
    pv, pi, _ = _run_windows(c, bounds=False, plain=True)
    torch.cuda.synchronize()
    assert ops.launches["adc_topk_windows"] == 1
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert int(ks.sum()) == 0
    bv, bi, bs = _run_windows(c, bounds=True, plain=False)
    tv, ti, _ = _run_tiles(c, bounds=True, plain=False)
    n_tiles = (c["n_valid"] + c["block_n"] - 1) // c["block_n"]
    assert bool((bs[:, 0] <= n_tiles).all()) and bool((bs[:, 1] <= c["n_valid"]).all())
    want = _merge(kv, ki, c["pair_q"], c["q"], c["k"])
    for got in (_merge(bv, bi, c["pair_q"], c["q"], c["k"]),
                _merge(tv, ti, c["pair_q"], c["q"], c["k"])):
        for (d1, i1), (d2, i2) in zip(got, want):
            np.testing.assert_array_equal(d1, d2)
            np.testing.assert_array_equal(i1, i2)


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int32])
def test_direct_tiles_kernel_matches_plain(cuda, dtype):
    raw = _tile_case(cuda, 5)
    c = _direct(raw, dtype)
    kv, ki, _ = _run_tiles(c, bounds=False, plain=False)
    pv, pi, _ = _run_tiles(c, bounds=False, plain=True)
    rv, ri, _ = _run_tiles(raw, bounds=False, plain=False)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    assert torch.equal(kv, rv) and torch.equal(ki, ri)  # sentinel columns add 0.0


def test_cooc_engine_on_card_matches_cpu(cuda, clustered_data):
    from repro_torch.retrieval.engine import MemANNSEngine

    xs, _, qs, hist = clustered_data
    kw = dict(block_n=256, rerank="exact", use_cooc=True, n_combos=32, path="flat")
    eng = MemANNSEngine.build(xs, 32, 8, ndev=8, history_queries=hist, kmeans_iters=8,
                              pq_iters=6, device="cpu", **kw)
    gpu = MemANNSEngine.from_reference(eng.index, eng.placement, xs, device=cuda, **kw)
    np.testing.assert_array_equal(np.asarray(eng.shards.codes),
                                  gpu.shards.codes.cpu().numpy())
    np.testing.assert_array_equal(eng.shards.combo_addrs, gpu.shards.combo_addrs)
    for scan in ("tiles", "windows"):
        for prune in (True, False):
            eng.scan = gpu.scan = scan
            eng.prune = gpu.prune = prune
            d1, i1 = eng.search(qs, 8, 10)
            d2, i2 = gpu.search(qs, 8, 10)
            np.testing.assert_array_equal(d1, d2)
            np.testing.assert_array_equal(i1, i2)


def _delta_case(dev, seed, c=64, d=32, m=8, n=3000, n_del=500):
    """A delta buffer of `n` inserts (encoded on `dev`), `n_del` of them
    tombstoned, over random centroids and codebook; and 100 queries."""
    from repro_torch.core.delta import DeltaIndex

    rng = np.random.default_rng(seed)
    cent = rng.normal(0, 5, (c, d)).astype(np.float32)
    cb = rng.normal(size=(m, 256, d // m)).astype(np.float32)
    vecs = (cent[rng.integers(0, c, n)] + rng.normal(0, 1, (n, d))).astype(np.float32)
    delta = DeltaIndex.create(m, 4096)
    delta.insert(cent, cb, np.arange(n), vecs, device=dev)
    delta.delete(rng.choice(n, n_del, replace=False))
    qs = (cent[rng.integers(0, c, 100)] + rng.normal(0, 1, (100, d))).astype(np.float32)
    return delta, cent, cb, qs


@pytest.mark.parametrize("k", [1, 10, 64, 2048])
@pytest.mark.parametrize("bounded", [False, True])
def test_delta_scan_on_card_matches_plain(cuda, k, bounded):
    """The delta scan on the card (one B1 and one B5 launch over the
    cluster-sorted view) is bit-equal to `delta_topk_plain`, the
    reference's formula in plain PyTorch, with and without a bound, and to
    the same route on the CPU."""
    from repro_torch.core.delta import delta_topk, delta_topk_plain

    delta, cent, cb, qs = _delta_case(cuda, k)
    bound = None
    if bounded:  # halfway between two rows' distances: no row sits on it
        u, _ = delta_topk_plain(delta, cent, cb, qs, 8, 64, device=cuda)
        j = max(0, k // 2 - 1) if k < 64 else 10
        bound = ((u[:, j] + u[:, j + 1]) / 2).astype(np.float32)
    ops.reset_launches()
    got = delta_topk(delta, cent, cb, qs, 8, k, bound=bound, device=cuda)
    torch.cuda.synchronize()
    assert ops.launches["build_luts"] == 1 and ops.launches["adc_topk_windows"] == 1
    want = delta_topk_plain(delta, cent, cb, qs, 8, k, bound=bound, device=cuda)
    cpu = delta_topk(delta, cent, cb, qs, 8, k, bound=bound, device="cpu")
    for a, b, c in zip(got, want, cpu):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_mutable_engine_on_card_matches_cpu(cuda, clustered_data):
    """A mutable engine on the card: inserts encode as on the CPU, and the
    searches (tiles / windows, pruned / not, exact re-rank) and the
    compaction give the CPU engine's answers."""
    from repro_torch.retrieval.engine import MemANNSEngine

    xs, centers, qs, hist = clustered_data
    eng = MemANNSEngine.build(
        xs, 32, 8, ndev=8, history_queries=hist, block_n=256, kmeans_iters=8,
        pq_iters=6, rerank="exact", mutable=True, device="cpu",
    )
    gpu = MemANNSEngine.from_reference(
        eng.index, eng.placement, xs, block_n=256, rerank="exact", mutable=True,
        freqs=eng.freqs, device=cuda,
    )
    rng = np.random.default_rng(1)
    ids = np.arange(12000, 12300)
    vecs = (centers[rng.integers(0, 32, 300)] + rng.normal(0, 1, (300, 32))).astype(np.float32)
    dels = np.concatenate([rng.choice(12000, 80, replace=False), ids[:20]])
    for e in (eng, gpu):
        e.insert(ids, vecs)
        e.delete(dels)
    np.testing.assert_array_equal(eng.delta.codes, gpu.delta.codes)
    np.testing.assert_array_equal(eng.delta.assign, gpu.delta.assign)
    ops.reset_launches()
    for scan in ("tiles", "windows"):
        for prune in (True, False):
            eng.scan = gpu.scan = scan
            eng.prune = gpu.prune = prune
            for a, b in zip(eng.search(qs, 8, 10), gpu.search(qs, 8, 10)):
                np.testing.assert_array_equal(a, b)
    assert ops.launches["adc_topk_windows"] >= 4 and ops.launches["rerank_dists"] >= 8
    eng.compact()
    gpu.compact()
    for f in ("codes", "vec_ids", "offsets"):
        np.testing.assert_array_equal(getattr(eng.index, f), getattr(gpu.index, f))
    for a, b in zip(eng.search(qs, 8, 10), gpu.search(qs, 8, 10)):
        np.testing.assert_array_equal(a, b)


def _api_case(dev, seed, n, w, dtype, q=3):
    """Tables and codes for the kernel-level API: raw uint8 codes with (Q,
    w, 256) tables, or uint16 / int32 direct addresses into (Q, w * 256 +
    40) tables."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = w * 256 + (0 if dtype == torch.uint8 else 40)
    tables = torch.rand(q, a, device=dev, generator=g)
    hi = 256 if dtype == torch.uint8 else a
    codes = torch.randint(0, hi, (n, w), device=dev, generator=g).to(dtype)
    return tables, codes


@pytest.mark.parametrize("dtype,w", [(torch.uint8, 16), (torch.uint8, 20),
                                     (torch.uint16, 16), (torch.int32, 12)])
def test_adc_scan_kernel_bit_equal(cuda, dtype, w):
    tables, codes = _api_case(cuda, 1, 100_003, w, dtype)
    ops.reset_launches()
    if dtype == torch.uint8:
        got = ops.adc_scan(tables[0].reshape(w, 256), codes)
    else:
        got = ops.adc_scan_flat(tables[0], codes)
    torch.cuda.synchronize()
    assert ops.launches["adc_scan"] == 1
    assert torch.equal(got, adc_scan.adc_scan_plain(tables[0], codes))


# B6 / B7 code formats: raw uint8 at compiled and runtime widths, uint16 and
# int32 direct addresses
TOPK_FORMATS = [(torch.uint8, 16), (torch.uint16, 16), (torch.int32, 8), (torch.uint8, 12)]


def _tile_bound(tables, codes, block_n, q):
    """Per-table bounds: +inf but for table 0, midway between two of its
    tile minima (so some tiles are dropped)."""
    inf = torch.full((q,), torch.inf, device=tables.device)
    addr = adc_topk.table_addresses(adc_topk.gatherable(codes), adc_topk.code_format(codes))
    d = adc_topk.sum_columns(tables[0][addr])
    n_t = -(-d.shape[0] // block_n)
    pad = torch.full((n_t * block_n - d.shape[0],), torch.inf, device=tables.device)
    tmin = torch.sort(torch.cat([d, pad]).reshape(n_t, block_n).amin(1)).values
    bound = inf.clone()
    bound[0] = (tmin[n_t // 3] + tmin[n_t // 3 + 1]) / 2
    return bound


@pytest.mark.parametrize("dtype,w", TOPK_FORMATS)
@pytest.mark.parametrize("q", [1, 3, 4, 5, 16])
@pytest.mark.parametrize("k", [1, 100, 257, 4096])
def test_adc_topk_kernel_bit_equal(cuda, dtype, w, q, k):
    """B6 at Q = 1, 3, G (4), G + 1 and 16 tables, every code format, with and
    without a finite bound, at two tile heights: bit-equal to the plain
    version (distances and rows), one launch per call."""
    tables, codes = _api_case(cuda, k + q, 100_003, w, dtype, q=q)
    inf = torch.full((q,), torch.inf, device=cuda)
    fn = ops.adc_topk if dtype == torch.uint8 else ops.adc_topk_flat
    for block_n in (256, 1024):
        for bound in (None, _tile_bound(tables, codes, block_n, q)):
            ops.reset_launches()
            got = fn(tables, codes, k, block_n=block_n, bound=bound)
            torch.cuda.synchronize()
            assert ops.launches["adc_topk"] == 1
            want = adc_topk.adc_topk_plain(tables, codes, inf if bound is None else bound, k,
                                           block_n)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype,w", TOPK_FORMATS)
@pytest.mark.parametrize("k", [10, 300])
def test_adc_topk_grouped_kernel_equals_single_calls(cuda, dtype, w, k):
    """Grouped B6 in one launch equals one `adc_topk` / `adc_topk_flat` call
    per group (and the grouped plain version): empty groups, groups smaller
    than k, groups of one table and of many."""
    sizes = [40_000, 0, 7, 5000, 123_457, 1, 2048]
    n_tab = [5, 3, 2, 1, 9, 4, 0]
    tables, codes = _api_case(cuda, k, sum(sizes), w, dtype, q=sum(n_tab))
    r_off = np.concatenate([[0], np.cumsum(sizes)])
    t_off = np.concatenate([[0], np.cumsum(n_tab)])
    ops.reset_launches()
    got = ops.adc_topk_grouped(tables, codes, k, r_off, t_off)
    torch.cuda.synchronize()
    assert ops.launches["adc_topk"] == 1
    fn = ops.adc_topk if dtype == torch.uint8 else ops.adc_topk_flat
    for i in range(len(sizes)):
        t0, t1, r0, r1 = t_off[i], t_off[i + 1], r_off[i], r_off[i + 1]
        if t1 == t0:
            continue
        if r1 == r0:
            assert bool(torch.isinf(got[0][t0:t1]).all()) and bool((got[1][t0:t1] == -1).all())
            continue
        one = fn(tables[t0:t1].contiguous(), codes[r0:r1], k)
        assert torch.equal(got[0][t0:t1], one[0]) and torch.equal(got[1][t0:t1], one[1])
    inf = torch.full((sum(n_tab),), torch.inf, device=cuda)
    want = adc_topk.adc_topk_grouped_plain(tables, codes, inf, k, 1024, r_off, t_off)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int32])
@pytest.mark.parametrize("k", [10, 100, 4096])
def test_adc_topk_pairs_kernel_bit_equal(cuda, dtype, k):
    """B7: one giant window (all 131,072 rows valid) beside empty, 7-row and
    partly filled ones, in one launch, bit-equal to the plain version."""
    g = torch.Generator(device=cuda).manual_seed(k)
    p, win, w = 6, 131_072, 16
    a = w * 256 + 40
    tables = torch.rand(p, a, device=cuda, generator=g)
    addrs = torch.randint(0, a, (p, win, w), device=cuda, generator=g).to(dtype)
    n_valid = torch.tensor([0, 7, win, 3000, 0, 1025], dtype=torch.int32, device=cuda)
    ops.reset_launches()
    got = ops.adc_topk_pairs(tables, addrs, n_valid, k, block_n=512)
    torch.cuda.synchronize()
    assert ops.launches["adc_topk_pairs"] == 1
    want = adc_topk.adc_topk_pairs_plain(tables, addrs, n_valid, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((got[1][0] == -1).all()) and bool((got[1][1, 7:] == -1).all())


@pytest.mark.parametrize("call", ["adc_topk_flat", "adc_topk_grouped", "adc_topk_pairs"])
def test_topk_table_too_wide_refused_on_card(cuda, call):
    """A 65,536-entry uint16 direct-address table cannot sit in a block's
    shared memory: the card refuses it with the CPU's ValueError, before
    any launch."""
    tables = torch.zeros(2, 65_536, device=cuda)
    addrs = torch.zeros(128, 4, dtype=torch.int32, device=cuda).to(torch.uint16)
    ops.reset_launches()
    with pytest.raises(ValueError, match="a table of 65536 floats and k=10 need .* B of "
                                         "shared memory"):
        if call == "adc_topk_flat":
            ops.adc_topk_flat(tables, addrs, 10)
        elif call == "adc_topk_grouped":
            ops.adc_topk_grouped(tables, addrs, 10, [0, 64, 128], [0, 1, 2])
        else:
            ops.adc_topk_pairs(tables, addrs.reshape(2, 64, 4),
                               torch.tensor([64, 3], device=cuda), 10, block_n=64)
    assert ops.launches["adc_topk"] == ops.launches["adc_topk_pairs"] == 0


def test_flat_search_on_card_matches_cpu(cuda, clustered_data):
    from repro_torch.core.index import build_index, search

    xs, _, qs, _ = clustered_data
    index = build_index(xs, 32, 8, kmeans_iters=8, pq_iters=6, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    sizes = index.cluster_sizes()
    for nprobe, k in ((8, 10), (3, int(sizes.min()) + 5)):
        ops.reset_launches()
        d_gpu, i_gpu = search(index, qs, nprobe, k, device=cuda)
        assert ops.launches["build_luts"] == 1 and ops.launches["adc_topk"] == 1
        d_cpu, i_cpu = search(index, qs, nprobe, k, device="cpu")
        np.testing.assert_array_equal(d_gpu, d_cpu)
        np.testing.assert_array_equal(i_gpu, i_cpu)


FLASH_F32_TOL = dict(rtol=1e-4, atol=1e-5)  # the reference's own (test_flash_attn.py)


@pytest.mark.parametrize("b,sq,sk,h,kvh,hd,off", [
    (2, 128, 128, 4, 2, 16, 0),       # the reference's four cases
    (1, 64, 256, 8, 8, 32, 0),
    (2, 128, 256, 4, 2, 16, 64),
    (1, 64, 64, 4, 1, 16, 0),
    (1, 100, 150, 8, 2, 96, 30),      # ragged against the kernel's 64-row tiles
    (2, 512, 1024, 8, 2, 128, 0),     # qwen3's head geometry, cache longer than q
    (1, 256, 256, 4, 4, 64, 0),
])
def test_flash_kernel_f32_matches_plain(cuda, b, sq, sk, h, kvh, hd, off):
    g = torch.Generator(device=cuda).manual_seed(sq + hd)
    q = torch.randn(b, sq, h, hd, device=cuda, generator=g)
    k = torch.randn(b, sk, kvh, hd, device=cuda, generator=g)
    v = torch.randn(b, sk, kvh, hd, device=cuda, generator=g)
    kv_valid = min(sk, off + sq)
    ops.reset_launches()
    got = ops.flash_attention_fwd(q, k, v, scale=hd**-0.5, q_offset=off, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_fwd"] == 1
    want = flash_attn.flash_attention_fwd_plain(q, k, v, hd**-0.5, off, kv_valid)
    torch.testing.assert_close(got, want, **FLASH_F32_TOL)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_bf16_q_matches_plain(cuda, kv_dtype):
    """bf16 q against an f32 (the serving path) or bf16 cache: bf16 outputs
    of f32 results that differ by reassociation agree to one bf16 ulp."""
    g = torch.Generator(device=cuda).manual_seed(1)
    b, sq, sk, h, kvh, hd = 2, 512, 640, 32, 8, 128
    q = torch.randn(b, sq, h, hd, device=cuda, generator=g).bfloat16()
    k = torch.zeros(b, sk, kvh, hd, device=cuda, dtype=kv_dtype)
    v = torch.zeros_like(k)
    k[:, :sq] = torch.randn(b, sq, kvh, hd, device=cuda, generator=g).to(kv_dtype)
    v[:, :sq] = torch.randn(b, sq, kvh, hd, device=cuda, generator=g).to(kv_dtype)
    got = ops.flash_attention_fwd(q, k, v, scale=hd**-0.5, kv_valid=sq, bk=128)
    want = flash_attn.flash_attention_fwd_plain(q, k, v, hd**-0.5, 0, sq, 512, 128)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-5)


FLASH_BF16_TOL = dict(rtol=2**-7, atol=1e-5)  # one bf16 ulp
FLASH_DTYPES = [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.float32), (torch.float32, torch.bfloat16)]


def _flash_inputs(dev, seed, b, sq, sk, h, kvh, hd, q_dtype, kv_dtype, off, kv_valid,
                  peak=None):
    """Random q / k / v; keys from kv_valid on hold a large finite value (not
    NaN), as a cache's dead slots may; `peak`: q scaled so that its largest
    live logit is `peak`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, sq, h, hd, device=dev, generator=g)
    k = torch.randn(b, sk, kvh, hd, device=dev, generator=g)
    v = torch.randn(b, sk, kvh, hd, device=dev, generator=g)
    k[:, kv_valid:] = 1e30
    v[:, kv_valid:] = -1e30
    if peak is not None:
        qg = q.reshape(b, sq, kvh, h // kvh, hd)
        lg = torch.einsum("bqkgd,bckd->bqkgc", qg, k[:, :kv_valid]) * hd**-0.5
        pos = off + torch.arange(sq, device=dev)
        live = torch.arange(kv_valid, device=dev)[None, :] <= pos[:, None]
        q = q * (peak / lg.masked_fill(~live[None, :, None, None, :], -torch.inf).max())
    return q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype)


def _flash_f64(q, k, v, off, kv_valid):
    """B10's function in float64, in q's dtype: the reference of the peaked
    case, where the f32 plain version's own rounding exceeds the f32
    tolerance (`chip_smoke.py` measures both at the prefill's shape)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.double().reshape(b, sq, kvh, h // kvh, hd)
    lg = torch.einsum("bqkgd,bckd->bqkgc", qg, k[:, :kv_valid].double()) * hd**-0.5
    pos = off + torch.arange(sq, device=q.device)
    live = torch.arange(kv_valid, device=q.device)[None, :] <= pos[:, None]
    p = torch.softmax(lg.masked_fill(~live[None, :, None, None, :], -torch.inf), -1)
    o = torch.einsum("bqkgc,bckd->bqkgd", p, v[:, :kv_valid].double())
    return o.reshape(q.shape).to(q.dtype)


def _flash_check(q, k, v, off, kv_valid, f64=False):
    """The kernel within the f32 (f32 q) or one-bf16-ulp (bf16 q) tolerance
    of its plain version, or with `f64` of the float64 result."""
    hd = q.shape[-1]
    ops.reset_launches()
    got = ops.flash_attention_fwd(q, k, v, scale=hd**-0.5, q_offset=off, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_fwd"] == 1 and got.dtype == q.dtype
    if f64:
        want = _flash_f64(q, k, v, off, kv_valid)
    else:
        want = flash_attn.flash_attention_fwd_plain(q, k, v, hd**-0.5, off, kv_valid)
    assert torch.isfinite(got).all()
    tol = FLASH_F32_TOL if q.dtype == torch.float32 else FLASH_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("q_dtype,kv_dtype", FLASH_DTYPES)
@pytest.mark.parametrize("groups", [1, 4, 8])
@pytest.mark.parametrize("hd", flash_attn.HEAD_DIMS)
def test_flash_kernel_domain_matches_plain(cuda, hd, groups, q_dtype, kv_dtype):
    """Every head dim, GQA 1 / 4 / 8 and dtype pair the wrapper accepts:
    q_offset > 0, kv_valid below both Sk and the last row's position (large
    finite values in the dead keys), 77 x groups rows (no multiple of the
    kernel's 128-row tile)."""
    q, k, v = _flash_inputs(cuda, hd + groups, 2, 77, 200, 2 * groups, 2, hd, q_dtype,
                            kv_dtype, 30, 90)
    _flash_check(q, k, v, 30, 90)


@pytest.mark.parametrize("q_dtype,kv_dtype", FLASH_DTYPES)
@pytest.mark.parametrize("groups", [1, 4, 8])
def test_flash_kernel_peaked_scores_match_plain(cuda, groups, q_dtype, kv_dtype):
    """q scaled so that the largest live logit is 30: a score error costs
    most in exp here, so this holds the split-TF32 products to the f32
    tolerance where it is tightest, against the float64 result."""
    q, k, v = _flash_inputs(cuda, 7 * groups, 2, 300, 384, 8 * groups, 8, 128, q_dtype,
                            kv_dtype, 0, 300, peak=30.0)
    _flash_check(q, k, v, 0, 300, f64=True)


def test_flash_kernel_attributes(cuda):
    """Every instance fits a block's shared memory and the register file
    (printed: registers, spilled bytes, shared memory per instance)."""
    for hd in flash_attn.HEAD_DIMS:
        for q_dtype, kv_dtype in FLASH_DTYPES:
            a = flash_attn.kernel_attributes(hd, q_dtype, kv_dtype)
            print(hd, q_dtype, kv_dtype, a)
            assert 0 < a["registers"] <= 255 and a["smem_bytes"] <= 232448


def test_flash_kernel_no_live_key_is_zero(cuda):
    q = torch.randn(1, 64, 4, 32, device=cuda)
    k = torch.randn(1, 64, 2, 32, device=cuda)
    got = ops.flash_attention_fwd(q, k, k.clone(), scale=0.2, kv_valid=0)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))


def test_lm_prefill_on_card_flash_vs_chunked(cuda):
    """A reduced qwen3 (GQA) in f32 on the card: prefill through B10 equals
    prefill through the chunked scan, and equals the same model on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import init_params, prefill

    cfg = reduced_config(get_config("qwen3-8b"), n_kv_heads=2)
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tok = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda)
    ops.reset_launches()
    on, _ = prefill(model, dataclasses.replace(cfg, use_flash_kernel=True), tok, max_len=192,
                    cache_dtype=torch.float32)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention_fwd"] == cfg.n_layers
    off, _ = prefill(model, cfg, tok, max_len=192, cache_dtype=torch.float32)
    torch.testing.assert_close(on, off, rtol=1e-4, atol=1e-4)
    cpu, _ = prefill(model.cpu(), cfg, tok.cpu(), max_len=192, cache_dtype=torch.float32)
    torch.testing.assert_close(on.cpu(), cpu, rtol=1e-4, atol=1e-4)


# -- the onehot path (PR 21): every scan's onehot instantiation ------------


def _mid_row(codes, width, seed):
    """Direct addresses with a combo address (>= the sentinel's column
    block) written into a random middle column of most rows, as §4.3's
    re-encoding writes a combo at its anchor column: the address order then
    differs from the column order."""
    g = torch.Generator(device=codes.device).manual_seed(seed)
    n, w = codes.shape
    a = codes.int().clone()
    hit = torch.rand(n, device=codes.device, generator=g) < 0.7
    col = torch.randint(0, max(w - 2, 1), (n,), device=codes.device, generator=g)
    extra = torch.randint((w - 2) * 256, width - 1, (n,), device=codes.device, generator=g)
    rows = torch.nonzero(hit).flatten()
    a[rows, col[rows]] = extra[rows].int()
    return a.to(codes.dtype).contiguous()


@pytest.mark.parametrize("dtype,w", [(torch.uint16, 16), (torch.uint16, 8), (torch.int32, 16),
                                     (torch.uint16, 12), (torch.int32, 5)])
def test_onehot_scan_and_topk_kernels_bit_equal(cuda, dtype, w):
    """B8, B6 and B7 on onehot at compiled widths (the sorting network) and
    runtime widths (the selection scan): bit-equal to the plain onehot
    versions, one launch each, and equal to the gather over each row's
    sorted addresses; addresses spread over a 40,000-entry table (uint16
    ones of 32,768 and up) for B8."""
    g = torch.Generator(device=cuda).manual_seed(w)
    wide = 40_000
    table = torch.rand(wide, device=cuda, generator=g)
    codes = torch.randint(0, wide, (100_003, w), device=cuda, generator=g).to(dtype)
    ops.reset_launches()
    got = ops.adc_scan_flat(table, codes, path="onehot")
    torch.cuda.synchronize()
    assert ops.launches["adc_scan"] == 1
    assert torch.equal(got, adc_scan.adc_scan_plain(table, codes, "onehot"))
    addr = adc_topk.table_addresses(adc_topk.gatherable(codes), adc_topk.code_format(codes))
    srt = torch.sort(addr, 1).values.to(dtype).contiguous()
    assert torch.equal(got, ops.adc_scan_flat(table, srt))
    tables, codes = _api_case(cuda, w + 1, 60_001, w, dtype, q=5)
    codes = _mid_row(codes, tables.shape[1], w)
    inf = torch.full((5,), torch.inf, device=cuda)
    for k in (10, 300):
        got = ops.adc_topk_flat(tables, codes, k, path="onehot")
        want = adc_topk.adc_topk_plain(tables, codes, inf, k, 1024, "onehot")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    win = codes[: 4 * 8192].reshape(4, 8192, w).contiguous()
    nv = torch.tensor([8192, 0, 77, 5000], dtype=torch.int32, device=cuda)
    got = ops.adc_topk_pairs(tables[:4].contiguous(), win, nv, 64, path="onehot")
    want = adc_topk.adc_topk_pairs_plain(tables[:4].contiguous(), win, nv, 64, "onehot")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("w", [8, 16, 32])
def test_onehot_raw_codes_launch_the_gather_bits(cuda, w):
    """On raw uint8 codes the onehot path's sums are the gather's: B8, B6,
    B2 and B5 on onehot equal their gather runs bit for bit."""
    tables, codes = _api_case(cuda, 3, 50_001, w, torch.uint8, q=4)
    lut = tables.reshape(4, w, 256)
    assert torch.equal(ops.adc_scan(lut[0], codes, path="onehot"), ops.adc_scan(lut[0], codes))
    a, b = ops.adc_topk(lut, codes, 20, path="onehot"), ops.adc_topk(lut, codes, 20)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = _tile_case(cuda, 3, m=w, dsub=4, k=64)
    p = c["n_valid"].shape[0]
    lut_row = torch.arange(p, dtype=torch.int32, device=cuda)
    for fn, args in ((ops.adc_topk_tiles, (c["tile_pair"], c["tile_block"], c["tile_row0"])),
                     (ops.adc_topk_windows, (c["starts"],))):
        x = fn(c["luts"], c["codes"], *args, c["n_valid"], 64, lut_row=lut_row,
               block_n=c["block_n"], path="onehot")
        y = fn(c["luts"], c["codes"], *args, c["n_valid"], 64, lut_row=lut_row,
               block_n=c["block_n"])
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


@pytest.mark.parametrize("dtype", [torch.uint16, torch.int32])
def test_onehot_direct_pruned_scans_bit_equal(cuda, dtype):
    """B2 and B5 on onehot over direct addresses with mid-row combos:
    bit-equal to their plain onehot versions per pair, and per query the
    pruned tiles and windows scans equal the unpruned one."""
    c = _direct(_tile_case(cuda, 4, m=16, dsub=4, k=64), dtype)
    c = dict(c, codes=_mid_row(c["codes"], c["luts"].shape[1], 4))
    p = c["n_valid"].shape[0]
    dev = c["luts"].device
    lut_row = torch.arange(p, dtype=torch.int32, device=dev)
    t0, t1, _ = adc_topk.pair_runs(c["tile_pair"][None], p)
    no_lb = torch.full((p,), -torch.inf, device=dev)
    no_b = torch.full((p,), torch.inf, device=dev)
    runs = {}
    for bounds in (False, True):
        kw = dict(pair_q=c["pair_q"], pair_lb=c["pair_lb"], bound=c["bound"]) if bounds else {}
        runs["tiles", bounds] = ops.adc_topk_tiles(
            c["luts"], c["codes"], c["tile_pair"], c["tile_block"], c["tile_row0"],
            c["n_valid"], c["k"], lut_row=lut_row, block_n=c["block_n"], path="onehot", **kw)
        runs["windows", bounds] = ops.adc_topk_windows(
            c["luts"], c["codes"], c["starts"], c["n_valid"], c["k"], lut_row=lut_row,
            block_n=c["block_n"], path="onehot", **kw)
    pv, pi, _ = adc_topk.adc_topk_tiles_plain(
        c["luts"], lut_row, c["codes"][None], c["tile_block"].int(), c["tile_row0"].int(),
        c["n_valid"].int(), lut_row, no_lb, no_b, t0, t1, c["k"], c["block_n"], "onehot")
    wv, wi, _ = adc_topk.adc_topk_windows_plain(
        c["luts"], lut_row, c["codes"][None], c["starts"].int(), c["n_valid"].int(), lut_row,
        no_lb, no_b, c["k"], c["block_n"], "onehot")
    torch.cuda.synchronize()
    for scan, (v, i) in (("tiles", (pv, pi)), ("windows", (wv, wi))):
        assert torch.equal(runs[scan, False][0], v) and torch.equal(runs[scan, False][1], i)
    want = _merge(*runs["tiles", False][:2], c["pair_q"], c["q"], c["k"])
    for key in (("tiles", True), ("windows", True), ("windows", False)):
        for (d1, i1), (d2, i2) in zip(_merge(*runs[key][:2], c["pair_q"], c["q"], c["k"]),
                                      want):
            np.testing.assert_array_equal(d1, d2)
            np.testing.assert_array_equal(i1, i2)


@pytest.mark.parametrize("cooc", [False, True])
def test_onehot_engine_and_serving_on_card_match_cpu(cuda, clustered_data, cooc):
    """A whole onehot engine (plain or co-occurrence shards, both scans) on
    the card equals the engine on the CPU bit for bit, and so does a
    ServingEngine over it at pipeline depths 0 and 1 (its own CUDA stream),
    with no build after warmup."""
    from repro_torch.retrieval.engine import MemANNSEngine
    from repro_torch.retrieval.serving import ServingEngine

    xs, _, qs, hist = clustered_data
    kw = dict(block_n=256, rerank="exact", use_cooc=cooc, n_combos=32, path="onehot")
    eng = MemANNSEngine.build(xs, 32, 8, ndev=8, history_queries=hist, kmeans_iters=8,
                              pq_iters=6, device="cpu", **kw)
    gpu = MemANNSEngine.from_reference(eng.index, eng.placement, xs, device=cuda, **kw)
    for scan in ("tiles", "windows"):
        eng.scan = gpu.scan = scan
        for a, b in zip(eng.search(qs, 8, 10), gpu.search(qs, 8, 10)):
            np.testing.assert_array_equal(a, b)
    stream = np.concatenate([qs] * 5)
    want = ServingEngine(eng, nprobe=8, k=10, micro_batch=16).search(stream)
    for depth in (0, 1):
        srv = ServingEngine(gpu, nprobe=8, k=10, micro_batch=16, pipeline_depth=depth)
        srv.warmup()
        got = srv.search(stream)
        assert srv.stats.compiles == 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _churn_run(eng, centers, qs, depth, faults=None):
    """A small churn stream (three rounds of 60 inserts, 12 deletes and a
    72-query search, compacting at 0.5 of 256 rows) through a mutable
    ServingEngine; returns every search, the stats and the launch counts."""
    from repro_torch.retrieval.serving import ServingEngine

    srv = ServingEngine(eng, nprobe=8, k=10, micro_batch=16, pipeline_depth=depth,
                        mutable=True, compact_occupancy=0.5, delta_capacity=256,
                        faults=faults)
    srv.warmup()
    rng = np.random.default_rng(4)
    outs = []
    ops.reset_launches()
    for r in range(3):
        ids = np.arange(12000 + 60 * r, 12060 + 60 * r)
        vecs = (centers[rng.integers(0, 32, 60)] + rng.normal(0, 1, (60, 32))).astype(np.float32)
        srv.insert(ids, vecs)
        srv.delete(np.concatenate([rng.choice(12000, 10, replace=False), ids[:2]]))
        outs.append(srv.search(np.concatenate([qs] * 3)))
    return outs, srv.stats, dict(ops.launches)


@pytest.mark.parametrize("rerank", ["off", "exact"])
def test_mutable_serving_on_card_matches_cpu(cuda, clustered_data, rerank):
    """Mutable serving on the card (the delta scan on B1 + B5 and its
    re-rank on B3 on the default stream, the main step on the server's
    stream, the merge after the event) equals the CPU run bit for bit at
    depths 0 and 1, with the same compactions and no build after warmup."""
    from repro_torch.retrieval.engine import MemANNSEngine

    xs, centers, qs, hist = clustered_data
    kw = dict(block_n=256, rerank=rerank, k_overfetch=64, mutable=True, delta_capacity=256)
    eng = MemANNSEngine.build(xs, 32, 8, ndev=8, history_queries=hist, kmeans_iters=8,
                              pq_iters=6, device="cpu", **kw)
    index, placement = eng.index, eng.placement  # the stream compacts `eng`
    want, wst, _ = _churn_run(eng, centers, qs, 1)
    for depth in (0, 1):
        gpu = MemANNSEngine.from_reference(index, placement, xs, freqs=eng.freqs,
                                           device=cuda, **kw)
        got, st, launches = _churn_run(gpu, centers, qs, depth)
        assert st.compiles == 0 and st.compactions == wst.compactions >= 1
        assert launches["adc_topk_windows"] >= 3 and launches["build_luts"] >= 6
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_failover_serving_on_card_matches_cpu(cuda, clustered_data):
    """The failover twin on the card: a device dead from batch 1 gives the
    CPU run's answers, flags and coverage."""
    from repro_torch.retrieval.engine import MemANNSEngine
    from repro_torch.retrieval.faults import FaultPlan
    from repro_torch.retrieval.serving import ServingEngine

    xs, _, qs, hist = clustered_data
    eng = MemANNSEngine.build(xs, 32, 8, ndev=8, history_queries=hist, block_n=256,
                              kmeans_iters=8, pq_iters=6, device="cpu")
    gpu = MemANNSEngine.from_reference(eng.index, eng.placement, block_n=256, device=cuda)
    stream = np.concatenate([qs] * 4)
    res = []
    for e in (eng, gpu):
        srv = ServingEngine(e, nprobe=8, k=10, micro_batch=16, collect_timeout_s=30.0,
                            faults=FaultPlan(device_death={3: 1}, hang_collect={2: 5}))
        srv.warmup()
        res.append((srv.search_result(stream), srv.stats))
    (a, sa), (b, sb) = res
    assert sb.compiles == 0 and sa.failovers == sb.failovers == 2
    for f in ("dists", "ids", "degraded", "coverage_lost"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_opq_engine_on_card_matches_cpu(cuda, clustered_data):
    """An OPQ-rotated index on the card (queries rotated on entry, inserts
    rotated by `rotate_rows` before encoding) answers as on the CPU, every
    scan x prune cell under the exact re-rank, with a live delta."""
    from repro_torch.retrieval.engine import MemANNSEngine

    xs, centers, qs, hist = clustered_data
    eng = MemANNSEngine.build(
        xs, 32, 8, ndev=8, history_queries=hist, block_n=256, kmeans_iters=6,
        pq_iters=4, opq_iters=2, rerank="exact", mutable=True, device="cpu",
    )
    gpu = MemANNSEngine.from_reference(
        eng.index, eng.placement, xs, block_n=256, rerank="exact", mutable=True,
        freqs=eng.freqs, device=cuda,
    )
    assert gpu.index.rotation is not None
    for scan in ("tiles", "windows"):
        for prune in (True, False):
            eng.scan = gpu.scan = scan
            eng.prune = gpu.prune = prune
            for a, b in zip(eng.search(qs, 8, 10), gpu.search(qs, 8, 10)):
                np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    ids = np.arange(12000, 12200)
    vecs = (centers[rng.integers(0, 32, 200)] + rng.normal(0, 1, (200, 32))).astype(np.float32)
    for e in (eng, gpu):
        e.insert(ids, vecs)
        e.delete(ids[:10])
    np.testing.assert_array_equal(eng.delta.codes, gpu.delta.codes)
    for a, b in zip(eng.search(vecs, 8, 10), gpu.search(vecs, 8, 10)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gpu.search(vecs[10:], 8, 10)[1][:, 0], ids[10:])


@pytest.mark.parametrize("use_cooc", [False, True])
def test_retile_and_rerank_block_on_card(cuda, clustered_data, tmp_path, use_cooc):
    """`retile` and `rerank_block` change no bit on the card, in every scan x
    prune x rerank cell; a sweep on the card times its grid with CUDA
    events, and its pick serves the same answers."""
    import dataclasses

    from repro_torch.core.autotune import KernelGeometry, autotune_engine
    from repro_torch.retrieval.engine import MemANNSEngine

    xs, _, qs, hist = clustered_data
    eng = MemANNSEngine.build(
        xs, 32, 8, ndev=8, history_queries=hist, block_n=256, kmeans_iters=6,
        pq_iters=4, rerank="exact", k_overfetch=64, use_cooc=use_cooc, n_combos=32,
        device=cuda,
    )

    def cells():
        return {(s, p, r): dataclasses.replace(eng, scan=s, prune=p, rerank=r).search(qs, 8, 10)
                for s in ("tiles", "windows") for p in (True, False) for r in ("off", "exact")}

    want = cells()
    for geo in (KernelGeometry(block_n=128, rerank_block=16, tile_floor=64),
                KernelGeometry(block_n=512, rerank_block=32)):
        assert eng.apply_geometry(geo) and eng.shards.block_n == geo.block_n
        for key, got in cells().items():
            for a, b in zip(got, want[key]):
                np.testing.assert_array_equal(a, b, err_msg=f"{geo} {key}")
    geo, rep = autotune_engine(eng, 10, mode="sweep", cache_dir=str(tmp_path))
    assert rep["source"] == "sweep" and rep["backend"] == cuda.type and rep["swept"] >= 6
    assert all(t > 0 for t in rep["timings"]["batch_s"].values())
    eng.apply_geometry(geo)
    for key, got in cells().items():
        for a, b in zip(got, want[key]):
            np.testing.assert_array_equal(a, b, err_msg=f"swept {geo} {key}")


def test_engine_saved_on_card_loads_on_cpu(cuda, clustered_data, tmp_path):
    """A mutable engine with a live delta and a bf16 store, saved from the
    card, loads on the CPU and serves the card's answers."""
    from repro_torch.checkpoint import load_engine, save_engine
    from repro_torch.retrieval.engine import MemANNSEngine

    xs, centers, qs, hist = clustered_data
    gpu = MemANNSEngine.build(
        xs, 32, 8, ndev=8, history_queries=hist, block_n=256, kmeans_iters=6,
        pq_iters=4, rerank="exact", raw_dtype="bfloat16", mutable=True, use_cooc=True,
        n_combos=32, device=cuda,
    )
    rng = np.random.default_rng(3)
    ids = np.arange(12000, 12100)
    gpu.insert(ids, (centers[rng.integers(0, 32, 100)]
                     + rng.normal(0, 1, (100, 32))).astype(np.float32))
    gpu.delete(np.concatenate([ids[:5], rng.choice(12000, 40, replace=False)]))
    cpu = load_engine(save_engine(str(tmp_path / "eng"), gpu), device="cpu")
    assert cpu.raw.dtype == "bfloat16" and cpu.delta.n == gpu.delta.n
    for a, b in zip(cpu.search(qs, 8, 10), gpu.search(qs, 8, 10)):
        np.testing.assert_array_equal(a, b)
    back = load_engine(str(tmp_path / "eng"), device=cuda)
    for a, b in zip(back.search(qs, 8, 10), gpu.search(qs, 8, 10)):
        np.testing.assert_array_equal(a, b)
