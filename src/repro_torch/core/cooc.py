"""§4.3 co-occurrence-aware encoding: mine frequent positioned code
combinations, cache their partial sums after the LUT build, and re-encode
rows as *direct addresses* into the flat [LUT | combo sums | 0] table.

A positioned item is (column m, codeword j); a combo only matches a row
when all its items sit at their exact columns (the paper's positional
constraint).

Offline:
  mine_combos()     greedy miner: positioned-pair counting -> best third item
  mine_clusters()   the same, for many row sets at once (one per cluster)
  reencode()        (N, M) uint8 codes -> (N, W) direct addresses; a
                    matched length-3 combo shrinks 3 entries to 1
  reencode_rows()   the same for rows of many clusters, each its own combos
Online:
  build_ext_lut()   LUT(s) -> [LUT (M*256) | combo sums | 0] (kernel B9)

The functions compute what the reference's numpy versions compute, combo
order and tie order included, but batched in torch on the caller's device:
the reference's per-cluster host loops take tens of minutes at 100M rows.
Pair counting is one sort (`torch.unique`) over the keys of a group of
clusters, offset by cluster; the third-item histograms of every candidate
pair of the group are one `scatter_add_`; the de-duplication is a sort over
combo signatures.  Only the row subsample (`default_rng(seed).choice`)
stays on the host: it is a list of indices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

NCODES = 256

# pair keys per mining group: bounds the (keys,) int64 array and the
# temporaries of the sort behind `torch.unique` (about 4x the keys' bytes,
# so roughly 1 GB per group at this size)
MINE_KEYS_BUDGET = 1 << 25
# bytes of third-item histograms per mining group: each row set brings up
# to top_pairs candidates of M * 256 int32 bins, twice (counts and keys),
# 32 MB per set at M = 16 and top_pairs = 1024
MINE_HIST_BUDGET = 1 << 30
# rows per re-encoding chunk: bounds the (chunk, M) int32 / bool temporaries
REENCODE_CHUNK = 1 << 22


@dataclasses.dataclass
class ComboSet:
    """Mined co-occurrence combinations (one set per cluster or global).

    Attributes:
      cols: (m, L) int32 columns of each combo (ascending within a combo).
      codes: (m, L) int32 codeword ids at those columns.
      support: (m,) int64 number of mined rows matching each combo.
    """

    cols: np.ndarray
    codes: np.ndarray
    support: np.ndarray

    @property
    def n_combos(self) -> int:
        return self.cols.shape[0]

    @property
    def combo_len(self) -> int:
        return self.cols.shape[1]


@dataclasses.dataclass
class CoocCodes:
    """Re-encoded (direct-address) code matrix for one set of rows.

    `addrs[n, :lengths[n]]` are flat indices into the extended table; the
    rest is the zero-sentinel address.  The table holds
    A = M*256 + n_combos + 1 entries (< 2^16 at the paper's M = 16,
    n_combos = 256, so the addresses are stored as uint16).
    """

    addrs: np.ndarray    # (N, W) uint16
    lengths: np.ndarray  # (N,) int32
    m_subspaces: int
    n_combos: int

    @property
    def table_size(self) -> int:
        return self.m_subspaces * NCODES + self.n_combos + 1

    @property
    def sentinel(self) -> int:
        return self.table_size - 1

    @property
    def width(self) -> int:
        return self.addrs.shape[1]

    def length_reduction(self) -> float:
        """Average code length reduction (paper Table 1's x-axis)."""
        return 1.0 - float(self.lengths.mean()) / self.m_subspaces


def sample_rows(n: int, max_rows: int, seed: int) -> np.ndarray | None:
    """The mining subsample of an n-row set: None (all rows) when n <=
    max_rows, else `default_rng(seed).choice(n, max_rows, replace=False)`,
    the reference's own draw."""
    if n <= max_rows:
        return None
    return np.random.default_rng(seed).choice(n, max_rows, replace=False)


def _empty(combo_len: int) -> ComboSet:
    z = np.zeros((0, combo_len), np.int32)
    return ComboSet(cols=z, codes=z.copy(), support=np.zeros(0, np.int64))


def _mine_group(
    codes: torch.Tensor, rows: torch.Tensor, seg: torch.Tensor, n_sets: int,
    n_combos: int, combo_len: int, top_pairs: int, min_support: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mine n_sets row sets at once: set g is `codes[rows[seg == g]]`.

    Returns (cols (G, n_combos, L), codes (G, n_combos, L), support
    (G, n_combos) int64, found (G,) int64); entries past `found[g]` are 0.
    """
    dev = codes.device
    m = codes.shape[1]
    ma = m * NCODES
    k2 = ma * ma
    lo = 2 if combo_len == 2 else 3
    out_c = torch.zeros((n_sets, n_combos, lo), dtype=torch.int64, device=dev)
    out_j = torch.zeros_like(out_c)
    out_s = torch.zeros((n_sets, n_combos), dtype=torch.int64, device=dev)
    found = torch.zeros(n_sets, dtype=torch.int64, device=dev)
    if rows.numel() == 0 or m < 2:
        return out_c, out_j, out_s, found

    # --- 1. count positioned pairs of every column pair, per set ---------
    pid = codes[rows].long() + torch.arange(m, device=dev) * NCODES     # (R, M)
    c1, c2 = torch.triu_indices(m, m, offset=1, device=dev)  # combinations order
    gkeys = (seg[:, None] * k2 + pid[:, c1] * ma + pid[:, c2]).reshape(-1)
    uniq, counts = torch.unique(gkeys, sorted=True, return_counts=True)
    # top_pairs per set by count, descending; ties by key (np.unique order)
    useg = uniq // k2
    o1 = torch.sort(-counts, stable=True).indices
    order = o1[torch.sort(useg[o1], stable=True).indices]
    s_sorted = useg[order]
    first = torch.searchsorted(s_sorted, torch.arange(n_sets, device=dev))
    rank = torch.arange(order.numel(), device=dev) - first[s_sorted]
    # candidates below min_support end the reference's loop (counts only fall)
    keep = (rank < top_pairs) & (counts[order] >= min_support)
    cand = order[keep]
    ck, cn, cs = uniq[cand], counts[cand], s_sorted[keep]
    n_cand = ck.numel()
    if n_cand == 0:
        return out_c, out_j, out_s, found
    key = ck % k2
    p1, p2 = key // ma, key % ma
    ca, ja, cb, jb = p1 // NCODES, p1 % NCODES, p2 // NCODES, p2 % NCODES

    if combo_len == 2:
        cols = torch.stack([ca, cb], 1)
        cods = torch.stack([ja, jb], 1)
        sup = cn
        ok = torch.ones(n_cand, dtype=torch.bool, device=dev)
    else:
        # --- 2. third-item histograms of all candidates at once ----------
        ck_sorted, perm = torch.sort(ck)
        hist = torch.zeros(n_cand * ma, dtype=torch.int32, device=dev)
        step = 1 << 21  # keys per lookup chunk: bounds the (hits, M) index
        for s0 in range(0, gkeys.numel(), step):
            gk = gkeys[s0 : s0 + step]
            pos = torch.searchsorted(ck_sorted, gk).clamp_max(n_cand - 1)
            hit = torch.nonzero(ck_sorted[pos] == gk).flatten()
            r = (hit + s0) // c1.numel()
            idx = perm[pos[hit]][:, None] * ma + pid[r]                 # (H, M)
            hist.scatter_add_(
                0, idx.reshape(-1),
                torch.ones(idx.numel(), dtype=torch.int32, device=dev),
            )
        hist = hist.reshape(n_cand, m, NCODES)
        # best code per column, ties to the first code (bincount.argmax);
        # counts <= rows of a set, so the keys stay within int32
        code_key = hist * NCODES + (NCODES - 1 - torch.arange(
            NCODES, device=dev, dtype=torch.int32))
        del hist
        best_key = code_key.max(dim=2).values.long()                    # (n, M)
        del code_key
        best_sup, best_code = best_key // NCODES, NCODES - 1 - best_key % NCODES
        colr = torch.arange(m, device=dev)
        other = (colr[None] != ca[:, None]) & (colr[None] != cb[:, None])
        # best column, ties to the first column (strict `>`); the pair's
        # own columns never compete
        col_key = torch.where(other, best_sup * m + (m - 1 - colr), -1)
        top = col_key.max(dim=1).values
        cc = torch.where(top >= 0, m - 1 - top % m, 0)
        sup = torch.where(top >= 0, best_sup.gather(1, cc[:, None])[:, 0], -1)
        jc = best_code.gather(1, cc[:, None])[:, 0]
        cols = torch.stack([ca, cb, cc], 1)
        cods = torch.stack([ja, jb, jc], 1)
        srt, how = torch.sort(cols, dim=1)                # distinct columns
        cols, cods = srt, cods.gather(1, how)
        ok = sup >= min_support

    # --- 3. greedy de-duplication, in candidate order --------------------
    pos_items = cols * NCODES + cods
    sig = cs
    for i in range(lo):
        sig = sig * ma + pos_items[:, i]
    cand_pos = torch.arange(n_cand, device=dev)
    big = torch.iinfo(torch.int64).max
    sig_ok = torch.where(ok, sig, big)
    by_sig = torch.sort(sig_ok, stable=True).indices
    s_sig = sig_ok[by_sig]
    first_of = torch.ones(n_cand, dtype=torch.bool, device=dev)
    first_of[1:] = s_sig[1:] != s_sig[:-1]
    accepted = torch.zeros(n_cand, dtype=torch.bool, device=dev)
    accepted[by_sig] = first_of & (s_sig != big)
    # the n_combos cap: the first n_combos accepted of each set
    acc = accepted.long()
    csum = torch.cumsum(acc, 0)
    seg_first = torch.searchsorted(cs, torch.arange(n_sets, device=dev))
    before = torch.where(seg_first > 0, csum[(seg_first - 1).clamp_min(0)], 0)
    rank_acc = csum - 1 - before[cs]
    accepted &= rank_acc < n_combos
    # final order per set: support descending, ties in candidate order
    a_idx = cand_pos[accepted]
    a_seg, a_sup = cs[a_idx], sup[a_idx]
    o1 = torch.sort(-a_sup, stable=True).indices
    o2 = o1[torch.sort(a_seg[o1], stable=True).indices]
    a_idx, a_seg = a_idx[o2], a_seg[o2]
    found = torch.bincount(a_seg, minlength=n_sets)
    a_first = torch.searchsorted(a_seg, torch.arange(n_sets, device=dev))
    slot = torch.arange(a_idx.numel(), device=dev) - a_first[a_seg]
    out_c[a_seg, slot] = cols[a_idx]
    out_j[a_seg, slot] = cods[a_idx]
    out_s[a_seg, slot] = sup[a_idx]
    return out_c, out_j, out_s, found


def mine_clusters(
    codes: torch.Tensor,
    offsets: np.ndarray,
    clusters,
    n_combos: int = 256,
    combo_len: int = 3,
    max_rows: int = 200_000,
    min_support: int = 2,
    seeds=None,
    top_pairs: int | None = None,
    keys_budget: int = MINE_KEYS_BUDGET,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`mine_combos` for many CSR row sets at once, on `codes.device`.

    Set i is `codes[offsets[c] : offsets[c + 1]]` for `c = clusters[i]`,
    subsampled with `seeds[i]` (default: the cluster id) as `mine_combos`
    does.  Sets are mined in groups whose pair keys stay within
    `keys_budget` and whose third-item histograms stay within
    `MINE_HIST_BUDGET` bytes (a set larger than a budget is a group of its
    own).

    Returns padded tensors (cols (C, n_combos, L), codes (C, n_combos, L),
    support (C, n_combos) int64, found (C,) int64), L = 2 for
    combo_len == 2 and 3 otherwise; entries past `found[i]` are 0.
    """
    if combo_len not in (2, 3):
        raise ValueError(f"combo_len={combo_len}: the miner builds pairs or triples")
    dev = codes.device
    m = codes.shape[1]
    clusters = np.asarray(clusters, np.int64)
    seeds = clusters if seeds is None else np.asarray(seeds, np.int64)
    top_pairs = 4 * n_combos if top_pairs is None else top_pairs
    npairs = max(m * (m - 1) // 2, 1)
    max_sets = max(1, MINE_HIST_BUDGET // (top_pairs * m * NCODES * 8))
    lo = 2 if combo_len == 2 else 3
    out_c = torch.zeros((len(clusters), n_combos, lo), dtype=torch.int64, device=dev)
    out_j = torch.zeros_like(out_c)
    out_s = torch.zeros((len(clusters), n_combos), dtype=torch.int64, device=dev)
    found = torch.zeros(len(clusters), dtype=torch.int64, device=dev)

    def flush(group, parts):
        if not group:
            return
        rows = torch.as_tensor(np.concatenate(parts), device=dev)
        lens = torch.as_tensor([len(p) for p in parts], device=dev)
        seg = torch.repeat_interleave(torch.arange(len(group), device=dev), lens)
        c, j, s, f = _mine_group(codes, rows, seg, len(group), n_combos, combo_len,
                                 top_pairs, min_support)
        gi = torch.as_tensor(group, device=dev)
        out_c[gi], out_j[gi], out_s[gi], found[gi] = c, j, s, f

    group, parts, n_keys = [], [], 0
    for i, c in enumerate(clusters.tolist()):
        lo_r, hi_r = int(offsets[c]), int(offsets[c + 1])
        sel = sample_rows(hi_r - lo_r, max_rows, int(seeds[i]))
        r = np.arange(lo_r, hi_r) if sel is None else lo_r + sel
        if group and (n_keys + len(r) * npairs > keys_budget or len(group) >= max_sets):
            flush(group, parts)
            group, parts, n_keys = [], [], 0
        group.append(i)
        parts.append(r.astype(np.int64))
        n_keys += len(r) * npairs
    flush(group, parts)
    return out_c, out_j, out_s, found


def mine_combos(
    codes,
    n_combos: int = 256,
    combo_len: int = 3,
    top_pairs: int | None = None,
    max_rows: int = 200_000,
    min_support: int = 2,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> ComboSet:
    """Greedy miner over one row set: positioned-pair counting, then the
    best third item of each of the `top_pairs` (default 4 * n_combos) most
    frequent pairs; combos are kept in support order, de-duplicated, at
    most `n_combos`, each with support >= `min_support`.

    `codes` is an (N, M) uint8 array or tensor; more than `max_rows` rows
    are subsampled with `default_rng(seed)`.  Runs on `device` (default
    cuda; a tensor's own device when it is one).
    """
    dev = codes.device if isinstance(codes, torch.Tensor) else resolve_device(device)
    t = torch.as_tensor(codes, device=dev)
    n = t.shape[0]
    if n == 0:
        return _empty(combo_len)
    c, j, s, f = mine_clusters(
        t, np.array([0, n]), [0], n_combos=n_combos, combo_len=combo_len,
        max_rows=max_rows, min_support=min_support, seeds=[seed],
        top_pairs=top_pairs,
    )
    k = int(f[0])
    if k == 0:
        return _empty(combo_len)
    return ComboSet(
        cols=c[0, :k].cpu().numpy().astype(np.int32),
        codes=j[0, :k].cpu().numpy().astype(np.int32),
        support=s[0, :k].cpu().numpy().astype(np.int64),
    )


def reencode_rows(
    codes: torch.Tensor,
    row_set: torch.Tensor,
    combo_cols: torch.Tensor,
    combo_codes: torch.Tensor,
    chunk: int = REENCODE_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-encode rows, each against the combo set `row_set[n]` selects.

    codes (N, M) uint8; row_set (N,) int64 into the (S, n_combos, L)
    combo tables.  Combos apply greedily in index order, non-overlapping
    (a column consumed by one combo joins no other); a combo with a
    repeated column (padding) never matches.  The first column of a
    matched combo carries the address M*256 + s, the others are elided.

    Returns (addrs (N, M) int32, kept entries first in column order, the
    rest the sentinel M*256 + n_combos; lengths (N,) int32).
    """
    dev = codes.device
    n, m = codes.shape
    n_combos = combo_cols.shape[1]
    sentinel = m * NCODES + n_combos
    addrs = torch.empty((n, m), dtype=torch.int32, device=dev)
    lengths = torch.empty(n, dtype=torch.int32, device=dev)
    combo_cols = combo_cols.long()
    combo_codes = combo_codes.long()
    if n_combos and combo_cols.shape[2] > 1:
        srt = torch.sort(combo_cols, dim=2).values
        live = (srt[..., 1:] != srt[..., :-1]).all(dim=2)             # (S, nc)
    else:
        live = torch.ones(combo_cols.shape[:2], dtype=torch.bool, device=dev)
    col_off = torch.arange(m, device=dev, dtype=torch.int32) * NCODES
    for s0 in range(0, n, chunk):
        x = codes[s0 : s0 + chunk].long()
        rs = row_set[s0 : s0 + chunk]
        a = x.int() + col_off
        removed = torch.zeros(x.shape, dtype=torch.bool, device=dev)
        used = torch.zeros(x.shape, dtype=torch.bool, device=dev)
        for s in range(n_combos):
            cc = combo_cols[rs, s]                                       # (n, L)
            hit = (x.gather(1, cc) == combo_codes[rs, s]).all(dim=1)
            hit &= live[rs, s] & ~used.gather(1, cc).any(dim=1)
            a.scatter_(1, cc[:, :1], torch.where(
                hit[:, None], m * NCODES + s, a.gather(1, cc[:, :1])).int())
            removed.scatter_(1, cc[:, 1:], removed.gather(1, cc[:, 1:]) | hit[:, None])
            used.scatter_(1, cc, used.gather(1, cc) | hit[:, None])
        keep = ~removed
        pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, m)
        packed = torch.full((x.shape[0], m + 1), sentinel, dtype=torch.int32, device=dev)
        packed.scatter_(1, pos, a)
        addrs[s0 : s0 + chunk] = packed[:, :m]
        lengths[s0 : s0 + chunk] = keep.sum(dim=1, dtype=torch.int32)
    return addrs, lengths


def reencode(
    codes,
    combos: ComboSet,
    width: int | None = None,
    device: torch.device | str | None = None,
) -> CoocCodes:
    """Rewrite (N, M) uint8 codes as direct addresses, substituting matched
    combos (greedy, support-ordered, non-overlapping), packed to `width`
    columns (default M) and sentinel-padded; addresses stored as uint16."""
    dev = codes.device if isinstance(codes, torch.Tensor) else resolve_device(device)
    t = torch.as_tensor(codes, device=dev)
    n, m = t.shape
    n_combos = combos.n_combos
    if m * NCODES + n_combos + 1 > 65536:
        raise ValueError("direct addresses must fit uint16 (paper §4.3)")
    cols = torch.as_tensor(np.asarray(combos.cols, np.int64), device=dev)
    cods = torch.as_tensor(np.asarray(combos.codes, np.int64), device=dev)
    addrs, lengths = reencode_rows(
        t, torch.zeros(n, dtype=torch.int64, device=dev), cols[None], cods[None]
    )
    w = m if width is None else int(width)
    max_len = int(lengths.max()) if n else 0
    if w < max_len:
        raise ValueError(f"width {w} too small for re-encoded length {max_len}")
    if w > m:
        pad = torch.full((n, w - m), m * NCODES + n_combos, dtype=torch.int32, device=dev)
        addrs = torch.cat([addrs, pad], dim=1)
    return CoocCodes(
        addrs=addrs[:, :w].cpu().numpy().astype(np.uint16),
        lengths=lengths.cpu().numpy(),
        m_subspaces=m,
        n_combos=n_combos,
    )


def plain_to_flat(codes: np.ndarray, n_combos: int = 0) -> np.ndarray:
    """Direct-address form of plain codes (no combos): col * 256 + code,
    uint16."""
    codes = np.asarray(codes)
    m = codes.shape[1]
    return (np.arange(m)[None, :] * NCODES + codes.astype(np.int32)).astype(np.uint16)


def build_ext_lut(
    lut: torch.Tensor, combo_cols, combo_codes
) -> torch.Tensor:
    """Online: flat [LUT row-major | combo partial sums | zero sentinel].

    `lut` is one (M, 256) table or a (Q, M, 256) batch sharing one combo
    set (cols / codes (n_combos, L)); returns (A,) or (Q, A),
    A = M*256 + n_combos + 1, through kernel B9 (`ops.build_ext_luts`).
    Combo s lives at flat address M*256 + s.
    """
    single = lut.dim() == 2
    luts = lut[None] if single else lut
    dev = luts.device
    cols = torch.as_tensor(np.asarray(combo_cols), device=dev).to(torch.int32)
    cods = torch.as_tensor(np.asarray(combo_codes), device=dev).to(torch.int32)
    out = ops.build_ext_luts(luts.float().contiguous(), cols.contiguous(), cods.contiguous())
    return out[0] if single else out


def max_combo_frequency(
    codes, lengths: tuple[int, ...] = (3, 4, 5), max_rows: int = 100_000,
    device: torch.device | str | None = None,
) -> dict[int, float]:
    """Paper Fig. 10: max co-occurrence frequency of combos per length.

    Returns length -> max fraction of rows sharing one positioned
    combination over contiguous column windows (a lower bound on the true
    max), on a `default_rng(0)` subsample of at most `max_rows` rows.
    """
    codes = np.asarray(codes)
    n, m = codes.shape
    if n == 0:
        return {ln: 0.0 for ln in lengths}
    if n > max_rows:
        codes = codes[np.random.default_rng(0).choice(n, max_rows, replace=False)]
        n = max_rows
    t = torch.as_tensor(codes, device=resolve_device(device)).long()
    out: dict[int, float] = {}
    for ln in lengths:
        best = 0
        for c0 in range(0, m - ln + 1):
            key = torch.zeros(n, dtype=torch.int64, device=t.device)
            for i in range(ln):
                key = key * NCODES + t[:, c0 + i]
            best = max(best, int(torch.unique(key, return_counts=True)[1].max()))
        out[ln] = best / n
    return out
