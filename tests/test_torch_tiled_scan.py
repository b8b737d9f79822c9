"""The tile algebra of the port's tiled CUDA kernels, modelled in numpy
and held against the port's plain versions.

csrc/chunked.cu cuts a row into tiles, one block each: keep_marks_kernel
and keep_resolve_kernel (and_keep, and_keep_compact, variants_keep) and
locate_runs_kernel. Here each row is cut into tiles of 1-64 lanes at
random. A tile reads its lanes and one lane on either side, folds them
into a summary with the kernels' combines (SegSum, CountSum, RunSum)
over random runs of lanes (the threads), takes its exclusive prefix as
decoupled look-back finds it (the nearest tile whose inclusive prefix is
published, then the aggregates after it, reduced in windows of 32
farthest first), and walks its lanes from that state. The results must
equal the plain versions exactly; tests/test_torch_chunked.py and
tests/test_torch_wide.py hold those against the JAX package's Pallas
kernels. The model is not part of the package: the kernels run only on
a card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.ops.seqops import INF32

INF = INF32
MAX_TILE = 64

# ---------------------------------------------------------------------------
# the summaries and their combines, as in csrc/chunked.cu
# ---------------------------------------------------------------------------

GAP, PRE, SEEN = 1, 2, 4  # SegSum's bits
SEG_ID = (0, 0, 0, 0)     # (word-A marks, word-B marks, starts, bits)


def seg_lane(isa, isb, gap_start, ordered):
    a_mark = ordered and isa
    if gap_start:
        return (int(isa), int(isb), 1, GAP | (SEEN if a_mark else 0))
    return (int(isa), int(isb), 0, (PRE | SEEN) if a_mark else 0)


def seg_combine(l, r):
    cut = bool(l[3] & GAP) and not l[3] & SEEN and bool(r[3] & PRE)
    pre = l[3] & PRE if l[3] & GAP else (l[3] | r[3]) & PRE
    seen = (r[3] & SEEN if r[3] & GAP
            else (l[3] & SEEN) | (SEEN if r[3] & PRE else 0))
    return (l[0] + r[0], l[1] + r[1], l[2] + r[2] + int(cut),
            ((l[3] | r[3]) & GAP) | pre | seen)


RUN_ID = (0, 0, 0, 0, -1, 0, -1)  # (hits, runs, bonus, fv, fp, lv, lp)


def gap_bonus(gap):
    return 30 // max(gap, 5)


def run_combine(l, r):
    if r[0] == 0:
        return l
    if l[0] == 0:
        return r
    same = r[4] == l[6]
    return (l[0] + r[0], l[1] + r[1] + (0 if same else 1),
            l[2] + r[2] + (gap_bonus(r[3] - l[5]) if same else 0),
            l[3], l[4], r[5], r[6])


def count_combine(l, r):
    return l + r


def fold(items, combine, identity, rng):
    """The block's summary: items cut into random runs (a thread's lanes),
    each folded left to right, then the runs' summaries folded."""
    parts, i = [], 0
    while i < len(items):
        k = int(rng.integers(1, 17))
        acc = identity
        for x in items[i: i + k]:
            acc = combine(acc, x)
        parts.append(acc)
        i += k
    acc = identity
    for p in parts:
        acc = combine(acc, p)
    return acc


def warp_reduce(xs, combine, identity):
    """tile_scan.cuh's window reduction: xs[i] is the (i + 1)-th
    predecessor; lane 0 ends with xs[-1] + ... + xs[0] by shfl_down."""
    x = list(xs) + [identity] * (32 - len(xs))
    d = 1
    while d < 32:
        x = [combine(x[i + d], x[i]) if i + d < 32 else x[i]
             for i in range(32)]
        d *= 2
    return x[0]


def look_back(aggs, combine, identity, rng):
    """Each tile's exclusive prefix as decoupled look-back finds it: the
    nearest tile j < t with a published inclusive prefix (tile 0's
    always is; j at random here), then the aggregates of tiles
    j + 1 .. t - 1, in windows of 32. Checked against the left fold."""
    incl, acc = [], identity
    for a in aggs:
        acc = combine(acc, a)
        incl.append(acc)
    out = [identity]
    for t in range(1, len(aggs)):
        j = int(rng.integers(0, t))
        excl, top = identity, t - 1
        while True:  # windows of 32 predecessors, the nearest first
            last = max(top - 31, j)
            xs = [aggs[p] for p in range(top, last, -1)]
            xs.append(incl[j] if last == j else aggs[last])
            excl = combine(warp_reduce(xs, combine, identity), excl)
            if last == j:
                break
            top -= 32
        assert excl == incl[t - 1]
        out.append(excl)
    return out


def random_tiles(rng, n):
    """[start, end) of tiles of 1..MAX_TILE lanes covering n lanes, half
    of them of at most 8 lanes."""
    cuts, s = [], 0
    while s < n:
        most = 8 if rng.random() < 0.5 else MAX_TILE
        e = min(n, s + int(rng.integers(1, most + 1)))
        cuts.append((s, e))
        s = e
    return cuts


def warp_upper_bound(s, v):
    """chunked.cu's 32-way warp search for #{j: s[j] <= v}; returns it
    and the rounds taken."""
    lo, hi, rounds = 0, len(s), 0
    while lo < hi:
        rounds += 1
        ln = hi - lo
        step = (ln + 31) // 32
        c = sum(int(s[lo + min(ln, (i + 1) * step) - 1] <= v)
                for i in range(32))
        if c == 32:
            return hi, rounds
        hi = lo + min(ln, (c + 1) * step) - 1
        lo += c * step
    return lo, rounds


# ---------------------------------------------------------------------------
# the keep kernels (pass 1 marks and segments, pass 2 resolve / compact)
# ---------------------------------------------------------------------------

def tile_marks(vals, tag, s, e, abs_r, variants):
    """(isa, isb, eligible, gap start) of lanes s..e-1, from those lanes
    and one lane on either side."""
    n = len(vals)
    lo = max(s - 1, 0)
    v = [int(x) for x in vals[lo: e + 1]]
    t = [int(x) for x in tag[lo: e + 1]]
    out = []
    for l in range(s, e):
        i = l - lo
        x = v[i]
        pv = v[i - 1] if l > 0 else 0
        nv = v[i + 1] if l + 1 < n else INF
        nt = t[i + 1] if l + 1 < n else 2
        valid = x < INF
        dup_prev = valid and l > 0 and x == pv
        if variants:
            isa = valid and not dup_prev and t[i] == 0
            isb = valid and t[i] == 1 and x != nv
        else:
            dup_next = valid and x == nv
            isa = ((valid and t[i] == 0)
                   or (dup_next and nv < INF and nt == 0)) and not dup_prev
            isb = ((valid and t[i] == 1)
                   or (dup_next and nv < INF and nt == 1)) and not dup_prev
        gap = x - (0 if l == 0 else pv)
        gap_start = l == 0 or (abs_r != 0 and gap > abs_r and valid)
        out.append((isa, isb, valid and not dup_prev, gap_start))
    return out


def keep_row(vals, tag, ra, rb, bpad, pg, variants, compact, rng, stats):
    """One row through both keep passes over random tiles: the kept
    stream, or with `compact` (values, pages, count)."""
    n = len(vals)
    abs_r, ordered = max(abs(ra), abs(rb)), ra < 0 and rb < 0
    cuts = random_tiles(rng, n)
    marks = [tile_marks(vals, tag, s, e, abs_r, variants) for s, e in cuts]
    aggs = [fold([seg_lane(a, b, g, ordered) for a, b, _, g in m],
                 seg_combine, SEG_ID, rng) for m in marks]
    pres = look_back(aggs, seg_combine, SEG_ID, rng)
    code = np.zeros(n, np.int64)
    seg = {}
    gap_tile = 0
    for t, ((s, e), m, pre) in enumerate(zip(cuts, marks, pres)):
        c_a, c_b, c_s, bits = pre
        seen = bool(bits & SEEN)
        for l, (isa, isb, eff, gap_start) in zip(range(s, e), m):
            start = gap_start
            if gap_start:
                gap_tile = t
            if ordered:
                if gap_start:
                    seen = isa
                elif isa and not seen:
                    start = seen = True
                    stats["cuts"] += 1
                    stats["cuts_across"] += t > gap_tile
                    stats["cuts_2_tiles_on"] += t >= gap_tile + 2
            if start:
                seg[c_s] = (c_a, c_b)
                c_s += 1
            c_a += isa
            c_b += isb
            code[l] = (c_s << 1) | int(eff)
    tot = seg_combine(pres[-1], aggs[-1])
    seg[tot[2]] = (tot[0], tot[1])
    assert sorted(seg) == list(range(tot[2] + 1))

    keep = np.zeros(n, bool)
    for l in range(n):
        s = code[l] >> 1
        lo, hi = seg[s - 1], seg[s]
        keep[l] = bool(code[l] & 1) and (bpad or (hi[0] > lo[0]
                                                  and hi[1] > lo[1]))
    if not compact:
        return np.where(keep, vals, INF)
    counts = [int(keep[s:e].sum()) for s, e in cuts]
    before = look_back(counts, count_combine, 0, rng)
    cv = np.full(n, -1, np.int64)
    cp = np.full(n, -1, np.int64)
    for (s, e), kept in zip(cuts, before):
        for l in range(s, e):
            if keep[l]:
                cv[kept] = vals[l]
                cp[kept] = pg[l] if pg is not None else 0
                kept += 1
            else:  # dropped ordinal l - kept, from the row's end
                cv[n - 1 - (l - kept)] = INF
                cp[n - 1 - (l - kept)] = INF
    assert (cv >= 0).all()
    return cv, (cp if pg is not None else None), int(keep.sum())


def _pool(rng, rows, size):
    """Ascending coordinates per row (steps of 1-5, a jump of 40-99 at
    about one step in 70) and where word A may sit: not in five
    stretches per row that a jump opens, so gap segments there open on
    word-B lanes and meet word A several tiles on."""
    steps = rng.integers(1, 6, size=(rows, size))
    steps += ((rng.random((rows, size)) < 0.015)
              * rng.integers(40, 100, size=(rows, size)))
    free = np.ones((rows, size), bool)
    for i in range(rows):
        for _ in range(5):
            s = int(rng.integers(0, size))
            e = s + int(rng.integers(30, 120))
            free[i, s:e] = False
            steps[i, s:e] = rng.integers(1, 4, size=steps[i, s:e].shape)
            steps[i, s] += 60
    pool = np.cumsum(steps, axis=1) + rng.integers(0, 1000, size=(rows, 1))
    return pool, free


def _windows(rows):
    """Ordered windows on every second row, a zero window on row 1."""
    ra = np.where(np.arange(rows) % 2 == 0, -25, 25).astype(np.int32)
    rb = np.where(np.arange(rows) % 2 == 0, -30, 30).astype(np.int32)
    ra[1] = rb[1] = 0
    return ra, rb


def _bounds(top, page):
    return np.arange(page, top + page, page, dtype=np.int64).astype(np.int32)


def _pages(x, bounds):
    return np.minimum(np.searchsorted(bounds, x, side="right"),
                      bounds.size - 1).astype(np.int32)


def and_inputs(seed, rows=8, cap=320):
    """A merged W = 2 stream per row (merge_tagged_plain of two ragged
    blocks from one pool, so the words share coordinates) and its pages."""
    rng = np.random.default_rng(seed)
    pool, free = _pool(rng, rows, 3 * cap)
    a = np.full((rows, cap), INF, np.int64)
    b = np.full((rows, cap), INF, np.int64)
    na = rng.integers(cap // 2, cap + 1, rows)
    nb = rng.integers(3 * cap // 4, cap + 1, rows)
    na[3], nb[3] = 0, cap  # one row with no word A
    for i in range(rows):
        cand = np.flatnonzero(free[i])
        na[i] = min(na[i], cand.size)
        a[i, : na[i]] = pool[i, np.sort(rng.choice(cand, na[i],
                                                   replace=False))]
        b[i, : nb[i]] = pool[i, np.sort(rng.choice(3 * cap, nb[i],
                                                   replace=False))]
    bounds = _bounds(int(pool.max()) + 1, 40)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32))
    vals, tag, pg = qk.merge_tagged_plain(
        t(a), t(na), t(b), t(nb), t(_pages(a, bounds)), t(_pages(b, bounds)))
    ra, rb = _windows(rows)
    return vals, tag, pg, t(ra), t(rb), t(bounds), rng


def variant_inputs(seed, rows=8, va=3, vb=2, cap=160):
    """A merged stream of two words' variant blocks per row, all from one
    pool (runs of equal coordinates up to va + vb lanes), word B empty
    and flagged bpad on every fourth row."""
    rng = np.random.default_rng(seed)
    pool, free = _pool(rng, rows, 2 * cap)

    def blocks(v, holed):
        x = np.full((rows, v, cap), INF, np.int64)
        n = rng.integers(cap // 3, cap + 1, (rows, v))
        for i in range(rows):
            cand = np.flatnonzero(free[i] if holed else np.ones(2 * cap))
            for j in range(v):
                k = n[i, j] = min(int(n[i, j]), cand.size)
                x[i, j, :k] = pool[i, np.sort(rng.choice(cand, k,
                                                         replace=False))]
        return x, n

    a, na = blocks(va, True)  # word A avoids a few stretches
    b, nb = blocks(vb, False)
    bpad = np.arange(rows) % 4 == 2
    nb[bpad] = 0
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, dtype=np.int32))
    vals, tag, _ = qk.merge_tagged_plain(t(a), t(na), t(b), t(nb))
    ra, rb = _windows(rows)
    return vals, tag, t(ra), t(rb), t(bpad), rng


def _stats():
    return dict(cuts=0, cuts_across=0, cuts_2_tiles_on=0)


def _runs_across(vals, rng_tiles):
    """Equal-coordinate runs that cross a tile edge."""
    n = vals.shape[0]
    return sum(int(vals[s] < INF and s > 0 and vals[s] == vals[s - 1])
               for s, _ in rng_tiles if s < n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_and_keep_tiles_equal_plain(seed):
    vals, tag, pg, ra, rb, _, rng = and_inputs(seed)
    stats = _stats()
    got = np.stack([keep_row(vals[i].numpy(), tag[i].numpy(), int(ra[i]),
                             int(rb[i]), False, None, False, False, rng,
                             stats) for i in range(vals.shape[0])])
    want = qk.and_keep_plain(vals, tag, ra, rb).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want < INF).sum() > 0 and stats["cuts_2_tiles_on"] > 0


@pytest.mark.parametrize("seed,paged", [(3, True), (4, False)])
def test_and_keep_compact_tiles_equal_plain(seed, paged):
    vals, tag, pg, ra, rb, _, rng = and_inputs(seed)
    pg = pg if paged else None
    stats = _stats()
    rows = [keep_row(vals[i].numpy(), tag[i].numpy(), int(ra[i]), int(rb[i]),
                     False, None if pg is None else pg[i].numpy(), False,
                     True, rng, stats) for i in range(vals.shape[0])]
    cvals, cpg, count = qk.and_keep_compact_plain(vals, tag, ra, rb, pg)
    np.testing.assert_array_equal(np.stack([r[0] for r in rows]), cvals)
    if paged:
        np.testing.assert_array_equal(np.stack([r[1] for r in rows]), cpg)
    np.testing.assert_array_equal([r[2] for r in rows], count)
    assert int(count.max()) > 0 and stats["cuts_across"] > 0


@pytest.mark.parametrize("seed,va,vb", [(5, 3, 2), (6, 4, 4), (7, 2, 1)])
def test_variants_keep_tiles_equal_plain(seed, va, vb):
    vals, tag, ra, rb, bpad, rng = variant_inputs(seed, va=va, vb=vb)
    stats = _stats()
    crossing = 0
    got = []
    for i in range(vals.shape[0]):
        row_rng = np.random.default_rng([seed, i])
        crossing += _runs_across(vals[i].numpy(),
                                 random_tiles(row_rng, vals.shape[1]))
        got.append(keep_row(vals[i].numpy(), tag[i].numpy(), int(ra[i]),
                            int(rb[i]), bool(bpad[i]), None, True, False,
                            np.random.default_rng([seed, i]), stats))
    want = qk.variants_keep_plain(vals, tag, ra, rb, bpad).numpy()
    np.testing.assert_array_equal(np.stack(got), want)
    assert crossing > 0 and stats["cuts_across"] > 0 and bool(bpad.any())


# ---------------------------------------------------------------------------
# locate_runs
# ---------------------------------------------------------------------------

def tile_pages(v, pg, bounds):
    """A tile's pages: carried, or looked up in the window of bounds
    between its first and last kept value (-1 at dropped lanes)."""
    keep = v < INF
    if pg is not None:
        return np.where(keep, pg, -1)
    page = np.full(v.shape, -1, np.int64)
    if keep.any():
        lo, r1 = warp_upper_bound(bounds, int(v[keep].min()))
        hi, r2 = warp_upper_bound(bounds, int(v[keep].max()))
        assert max(r1, r2) <= 3
        win = bounds[lo:hi]
        p = lo + np.searchsorted(win, v[keep], side="right")
        page[keep] = np.minimum(p, bounds.size - 1)
    return page


def locate_row(hv, pg, bounds, kpad, hpad, rng, stats):
    """One row through locate_runs_kernel's algebra over random tiles:
    (pages, bonus sums, counts) of its first kpad runs, the run and hit
    totals and its first hpad hits."""
    n = len(hv)
    cuts = random_tiles(rng, n)
    pages = [tile_pages(hv[s:e], None if pg is None else pg[s:e], bounds)
             for s, e in cuts]
    aggs = [fold([(1, 0, 0, int(x), int(p), int(x), int(p))
                  for x, p in zip(hv[s:e], pp) if x < INF],
                 run_combine, RUN_ID, rng)
            for (s, e), pp in zip(cuts, pages)]
    pres = look_back(aggs, run_combine, RUN_ID, rng)
    hits = np.full(hpad, INF, np.int64)
    table = {}
    last_tile = {}
    for t, ((s, e), pp, pre) in enumerate(zip(cuts, pages, pres)):
        c_hits, _, c_bon = pre[:3]
        c_runs = pre[1] + 1 if pre[0] else 0
        c_pv, c_pp = (pre[5], pre[6]) if pre[0] else (-1, -1)
        for l, p in zip(range(s, e), pp):
            x = int(hv[l])
            if x == INF:
                continue
            if c_hits < hpad:
                hits[c_hits] = x
            if c_hits == hpad and l > s and (hv[s:l] < INF).any():
                stats["hpad_mid_tile"] += 1
            if p != c_pp:
                if c_runs <= kpad:
                    table[c_runs] = (c_hits, c_bon, int(p))
                if c_runs == kpad and l > s and (hv[s:l] < INF).any():
                    stats["kpad_mid_tile"] += 1
                c_runs += 1
            else:
                c_bon += gap_bonus(x - c_pv)
                if last_tile.get(c_runs) is not None and last_tile[c_runs] < t:
                    stats["runs_across"] += 1
                    # the tiles between hold no kept lane
                    stats["empty_between"] += last_tile[c_runs] < t - 1
            last_tile[c_runs] = t
            c_hits += 1
            c_pv, c_pp = x, int(p)
    tot = run_combine(pres[-1], aggs[-1])
    n_runs = tot[1] + 1 if tot[0] else 0
    pg_c = np.full(kpad, -1, np.int64)
    bon = np.zeros(kpad, np.int64)
    cnt = np.zeros(kpad, np.int64)
    for r in range(min(kpad, n_runs)):
        a = table[r]
        b = table[r + 1] if r + 1 < n_runs else (tot[0], tot[2])
        pg_c[r], bon[r], cnt[r] = a[2], b[1] - a[1], b[0] - a[0]
    return pg_c, bon, cnt, n_runs, tot[0], hits


def check_locate(hv, pg, bounds, kpad, hpad, seed):
    stats = dict(runs_across=0, empty_between=0, kpad_mid_tile=0,
                 hpad_mid_tile=0)
    rows = [locate_row(hv[i].numpy(), None if pg is None else pg[i].numpy(),
                       bounds.numpy(), kpad, hpad,
                       np.random.default_rng([seed, i]), stats)
            for i in range(hv.shape[0])]
    pg_c, bon, cnt, n_pages, n_hits, hits = (np.stack(f) for f in zip(*rows))
    # the kernel's run_rank; page_runs computes the same f32 expression
    cnt_t = torch.as_tensor(cnt, dtype=torch.float32)
    rk = (1.0 + torch.as_tensor(bon, dtype=torch.float32)) + torch.log(
        cnt_t.clamp_min(1.0))
    live = torch.arange(kpad)[None, :] < torch.as_tensor(n_pages)[:, None]
    want = qk._locate_runs_plain(hv, pg, bounds, kpad, hpad)
    got = (pg_c, torch.where(live, rk, 0.0), cnt, n_pages, n_hits, hits)
    for name, g, w in zip(("pg_c", "rk_c", "ct_c", "n_pages", "n_hits",
                           "hits"), got, want):
        g = torch.as_tensor(np.asarray(g)).to(w.dtype)
        assert torch.equal(g, w), name
    return stats


def kept_stream(seed, rows=6, n=900):
    """Kept streams: ascending values, dropped lanes INF32, with long
    dropped stretches, pages of 100 coordinates."""
    rng = np.random.default_rng(seed)
    vals = np.cumsum(rng.integers(1, 4, size=(rows, n)), axis=1)
    keep = rng.random((rows, n)) < 0.4
    for i in range(rows):
        for _ in range(3):
            s = int(rng.integers(0, n))
            keep[i, s: s + int(rng.integers(70, 200))] = False
    keep[0] = False  # a row with no hit
    hv = np.where(keep, vals, INF).astype(np.int32)
    bounds = _bounds(int(vals.max()) + 1, 100)
    return (torch.as_tensor(hv), torch.as_tensor(_pages(vals, bounds)),
            torch.as_tensor(bounds))


@pytest.mark.parametrize("carried", [True, False])
@pytest.mark.parametrize("budgets", ["mid", "all"])
def test_locate_runs_tiles_equal_plain(carried, budgets):
    hv, pg, bounds = kept_stream(8)
    n = hv.shape[1]
    kpad, hpad = (7, 53) if budgets == "mid" else (n, n)
    stats = check_locate(hv, pg if carried else None, bounds, kpad, hpad, 8)
    assert stats["runs_across"] > 0 and stats["empty_between"] > 0
    if budgets == "mid":
        assert stats["kpad_mid_tile"] > 0 and stats["hpad_mid_tile"] > 0


@pytest.mark.parametrize("carried", [True, False])
def test_locate_runs_tiles_on_and_keep_stream(carried):
    vals, tag, pg, ra, rb, bounds, _ = and_inputs(9)
    hv = qk.and_keep_plain(vals, tag, ra, rb)
    stats = check_locate(hv, pg if carried else None, bounds, 16, 100, 9)
    assert stats["runs_across"] > 0


def test_locate_runs_tiles_on_posting_block():
    """The W = 1 form: a posting block, INF32 after its length."""
    rng = np.random.default_rng(10)
    rows, cap = 6, 700
    pool, _ = _pool(rng, rows, cap)
    na = rng.integers(0, cap + 1, rows)
    na[1], na[2] = 0, cap
    lane = np.arange(cap)[None, :]
    block = np.where(lane < na[:, None], pool, INF).astype(np.int32)
    bounds = _bounds(int(pool.max()) + 1, 90)
    pg = _pages(pool, bounds)
    for carried in (True, False):
        stats = check_locate(torch.as_tensor(block),
                             torch.as_tensor(pg) if carried else None,
                             torch.as_tensor(bounds), 64, 300, 10)
        assert stats["runs_across"] > 0


# ---------------------------------------------------------------------------
# the pieces on their own
# ---------------------------------------------------------------------------

def test_warp_upper_bound_matches_searchsorted():
    rng = np.random.default_rng(11)
    for m in (0, 1, 5, 31, 32, 33, 1000, 21971, 32768):
        s = np.sort(rng.integers(0, 4 * max(m, 1), m))
        probes = np.concatenate([rng.integers(-2, 4 * max(m, 1) + 2, 40),
                                 s[:: max(1, m // 20)]])
        for v in probes:
            got, rounds = warp_upper_bound(s, int(v))
            assert got == int(np.searchsorted(s, v, side="right"))
            assert rounds <= 3


_seg_lane = st.tuples(st.booleans(), st.booleans(), st.booleans(),
                      st.booleans()).map(lambda x: seg_lane(*x))
_run_lane = st.tuples(st.integers(0, 50), st.integers(0, 3)).map(
    lambda x: (1, 0, 0, x[0], x[1], x[0], x[1]))


@settings(max_examples=200, deadline=None)
@given(st.lists(_seg_lane, min_size=3, max_size=12), st.data())
def test_seg_combine_is_associative(lanes, data):
    """Any two cut points of a stretch of lanes summarise it alike."""
    i = data.draw(st.integers(1, len(lanes) - 2))
    j = data.draw(st.integers(i + 1, len(lanes) - 1))

    def run(xs):
        acc = SEG_ID
        for x in xs:
            acc = seg_combine(acc, x)
        return acc

    a, b, c = run(lanes[:i]), run(lanes[i:j]), run(lanes[j:])
    assert seg_combine(seg_combine(a, b), c) == seg_combine(
        a, seg_combine(b, c)) == run(lanes)


@settings(max_examples=200, deadline=None)
@given(st.lists(_run_lane, min_size=3, max_size=12), st.data())
def test_run_combine_is_associative(lanes, data):
    lanes = sorted(lanes, key=lambda x: (x[3], x[4]))  # values ascend
    i = data.draw(st.integers(1, len(lanes) - 2))
    j = data.draw(st.integers(i + 1, len(lanes) - 1))

    def run(xs):
        acc = RUN_ID
        for x in xs:
            acc = run_combine(acc, x)
        return acc

    a, b, c = run(lanes[:i]), run(lanes[i:j]), run(lanes[j:])
    assert run_combine(run_combine(a, b), c) == run_combine(
        a, run_combine(b, c)) == run(lanes)
