"""Smoke run of docodo_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels from the checkout, holds each against its plain PyTorch version,
builds a seeded 64 MB Zipf corpus index with the port's host build,
serves the standard 10k query mix through the kernel route and the plain
route, times every kernel on the calls that batch makes, and checks
sampled results against an independent numpy oracle.

    python3 chip_smoke.py [--corpus-mb 64] [--seed 0]

Prints one line per phase, a JSON line with every kernel's launches,
error, times and bound, the card's name and power limit, and as its last
line {"ok": true, "device": {...}}. Exits non-zero, without that line,
when there is no CUDA device or any phase fails. Imports no jax and
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

TOPK = 64
HIT_CAP = 1024
N_QUERIES = 10_000  # the standard mix's batch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, at 700 W
INT_OPS_PER_S = 67e12      # H100 SXM non-tensor 32-bit rate, at 700 W
OPS_PER_LANE = 32          # integer operations per lane that holds data

LOCATE_FULL = "docodo_tpu_torch/csrc/locate_full.cu"
CHUNKED = "docodo_tpu_torch/csrc/chunked.cu"
PQ = "docodo_tpu/ops/pallas_query.py"
# name -> (source, TPU kernel replaced, kernel core, plain core); the
# cores are the query_kernels functions a wrapper hands its inputs to
KERNELS = {
    "sorted_and_locate_full": (LOCATE_FULL, f"{PQ}:617",
                               "_sorted_and_kernel", "_sorted_and_plain"),
    "single_locate_full": (LOCATE_FULL, f"{PQ}:723", "_single_kernel",
                           "_single_plain"),
    "union_locate_full": (LOCATE_FULL, f"{PQ}:660", "_union_kernel",
                          "_union_plain"),
    "merge_and_locate_topk": (LOCATE_FULL, f"{PQ}:2623",
                              "_merge_and_locate_kernel",
                              "_sorted_and_plain"),
    "merge_tagged": (CHUNKED, f"{PQ}:2290", "_merge_tagged_kernel",
                     "_merge_tagged_plain"),
    "and_keep": (CHUNKED, f"{PQ}:1935", "_and_keep_kernel",
                 "_and_keep_plain"),
    "locate_runs": (CHUNKED, f"{PQ}:1480", "_locate_runs_kernel",
                    "_locate_runs_plain"),
}
SLOT_CAPS = {
    "sorted_and_locate_full": (64, 128, 256, 512),
    "single_locate_full": (64, 128),
    "union_locate_full": (256, 512, 1024),
}
SLOT_ROWS = 4096
FIELDS = ("pg_c", "rk_c", "ct_c", "n_pages", "n_hits", "hits")


def say(*parts) -> None:
    print(*parts, flush=True)


def require(ok, what: str) -> None:
    """A check of the run (kept under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units of the last place between two
    non-negative f32 tensors."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max()) if a.numel() else 0


def same_outputs(got, want, what: str) -> float:
    """Six-field full-result outputs: ints exact, ranks within 1 ulp.
    Returns the largest absolute rank difference."""
    for field, g, w in zip(FIELDS, got, want):
        if field == "rk_c":
            u = ulps(g, w)
            require(u <= 1, f"{what}: ranks {u} ulp apart")
        else:
            bad = (g != w).nonzero()
            require(bad.numel() == 0, f"{what}: {field} differs at "
                    f"{bad[:4].tolist()}")
    return float((got[1] - want[1]).abs().max()) if got[1].numel() else 0.0


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    say(f"device: {name}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return name, smi


def phase_build() -> None:
    from docodo_tpu_torch.ops import _cuda

    secs = _cuda.build()
    _cuda.library()
    report = [ln.strip() for ln in _cuda.build_log.splitlines()
              if "registers" in ln or "spill" in ln]
    say(f"build: nvcc {secs:.1f} s ({len(_cuda.SOURCES)} sources in "
        f"parallel) -> {_cuda.library_path().name}")
    for ln in report:
        say(f"  ptxas {ln}")


def _parity_inputs(rng, rows: int, cap: int, dev):
    """Seeded posting blocks at a bucket's shape: two ascending subsets
    of one per-row pool (so the operands share coordinates), lengths
    0..cap with empty and full rows, both window signs, and the pages of
    256-char pages, so that long rows hold more runs than topk."""
    pool = np.cumsum(rng.integers(1, 40, size=(rows, 2 * cap)), axis=1)
    pool += rng.integers(0, 1 << 20, size=(rows, 1))

    def subset():
        pick = np.sort(np.argsort(rng.random((rows, 2 * cap)), axis=1)[:, :cap],
                       axis=1)
        return np.take_along_axis(pool, pick, axis=1).astype(np.int32)

    a, b = subset(), subset()
    na = rng.integers(0, cap + 1, size=rows).astype(np.int32)
    nb = rng.integers(0, cap + 1, size=rows).astype(np.int32)
    na[0::7], nb[1::7] = 0, 0
    na[2::5], nb[2::5] = cap, cap
    ra = np.where(np.arange(rows) % 2 == 0, 260, -12).astype(np.int32)
    rb = np.where(np.arange(rows) % 2 == 0, 263, -10).astype(np.int32)
    top = int(pool.max()) + 1
    bounds = np.arange(256, top + 256, 256, dtype=np.int64).astype(np.int32)

    def pages(x):
        return np.minimum(np.searchsorted(bounds, x, side="right"),
                          bounds.size - 1).astype(np.int32)

    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    return dict(a=t(a), na=t(na), ra=t(ra), b=t(b), nb=t(nb), rb=t(rb),
                bounds=t(bounds), a_pg=t(pages(a)), b_pg=t(pages(b)))


def phase_parity(rng) -> dict:
    """Each kernel against its plain version on seeded inputs at the
    main path's shapes and wider: ints exact, ranks within 1 ulp.
    Returns the largest rank difference per kernel."""
    from docodo_tpu_torch.ops import query_kernels as qk
    from docodo_tpu_torch.ops.seqops import INF32

    dev = torch.device("cuda")
    err = {name: 0.0 for name in KERNELS}

    def check(name, what, kern, plain, *args, **kw):
        got = getattr(qk, kern)(*args, **kw)
        torch.cuda.synchronize()
        want = getattr(qk, plain)(*args, **kw)
        err[name] = max(err[name], same_outputs(got, want, what))
        say(f"parity: {what}: equal")
        return got

    for name, caps in SLOT_CAPS.items():
        for cap in caps:
            x = _parity_inputs(rng, SLOT_ROWS, cap, dev)
            kw = dict(topk=TOPK, hit_cap=HIT_CAP, tail=False)
            if name == "sorted_and_locate_full":
                args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"],
                        x["bounds"])
                kw.update(a_pg=x["a_pg"], b_pg=x["b_pg"])
            elif name == "single_locate_full":
                args = (x["a"], x["na"], x["bounds"])
                kw.update(a_pg=x["a_pg"])
            else:
                args = (x["a"][:, None], x["na"][:, None], x["bounds"])
                kw.update(a_pg=x["a_pg"][:, None])
            check(name, f"{name} cap {cap} B {SLOT_ROWS}", name,
                  name + "_plain", *args, **kw)

    for cap in (1024, 2048):
        x = _parity_inputs(rng, 1024, cap, dev)
        for topk in (TOPK, 2048):
            check("merge_and_locate_topk",
                  f"merge_and_locate_topk cap {cap} topk {topk} B 1024",
                  "merge_and_locate_topk", "merge_and_locate_topk_plain",
                  x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"],
                  x["a_pg"], x["b_pg"], topk=topk, hit_cap=HIT_CAP)

    for cap, rows in ((1024, 1024), (2048, 1024), (4096, 1024),
                      (32768, 256)):
        x = _parity_inputs(rng, rows, cap, dev)
        n = 2 * cap
        for paged in (True, False):
            pgs = (x["a_pg"], x["b_pg"]) if paged else (None, None)
            vals, tag, pg = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"],
                                            *pgs)
            torch.cuda.synchronize()
            wv, wt, wp = qk.merge_tagged_plain(x["a"], x["na"], x["b"],
                                               x["nb"], *pgs)
            live = wv < INF32
            require(torch.equal(vals, wv) and torch.equal(tag, wt)
                    and (not paged or torch.equal(pg[live], wp[live])),
                    f"merge_tagged n {n} paged {paged} differs")
            say(f"parity: merge_tagged n {n} B {rows} paged {paged}: equal")
            if not paged:
                continue
            hv = qk.and_keep(vals, tag, x["ra"], x["rb"])
            torch.cuda.synchronize()
            require(torch.equal(hv, qk.and_keep_plain(vals, tag, x["ra"],
                                                      x["rb"])),
                    f"and_keep n {n} differs")
            kept = int((hv < INF32).sum())
            require(kept > 0, f"and_keep n {n} kept nothing")
            say(f"parity: and_keep n {n} B {rows}: equal ({kept} kept)")
            if n < 8192:
                continue
            for carried in (True, False):
                check("locate_runs",
                      f"locate_runs n {n} B {rows} "
                      f"{'carried' if carried else 'shared'} pages",
                      "locate_runs", "locate_runs_plain", hv, x["bounds"],
                      topk=TOPK, hit_cap=HIT_CAP,
                      pg=pg if carried else None)
    return err


def phase_index(corpus_mb: float, seed: int):
    from docodo_tpu_torch.lang import tokenizer
    from docodo_tpu_torch.ops.device_index import DeviceIndex, build_postings
    from docodo_tpu_torch.synthetic import build_index, zipf_documents

    t0 = time.perf_counter()
    docs = zipf_documents(int(corpus_mb * 1e6), seed=seed)
    t1 = time.perf_counter()
    ind = build_index(docs)
    t2 = time.perf_counter()
    dix = DeviceIndex.from_index(ind)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = np.diff(dix.offsets_np)
    say(f"index: {corpus_mb:g} MB seed {seed}: {len(docs)} docs, "
        f"{dix.bounds.numel()} pages, {len(dix.terms)} terms, "
        f"{dix.coords.numel()} postings, largest list {int(counts.max())}, "
        f"{dix.device_bytes() / 1e6:.1f} MB on device; corpus "
        f"{t1 - t0:.1f} s, host build {t2 - t1:.1f} s, staging "
        f"{t3 - t2:.1f} s")

    # the device build over the tokenizer's stream, against numpy
    text = " ".join(p.text for d in docs for p in d.pages[1:])
    words, starts = tokenizer.tokenize(text)
    ids: dict = {}
    tids = np.fromiter((ids.setdefault(w, len(ids)) for w in words),
                       np.int64, len(words))
    n_terms = len(ids)
    tt = torch.as_tensor(tids.astype(np.int32), device="cuda")
    tc = torch.as_tensor(starts.astype(np.int32), device="cuda")
    build_postings(tt, tc, n_terms)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    st, sc, off = build_postings(tt, tc, n_terms)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t4
    order = np.lexsort((starts, tids))
    want_off = np.concatenate(
        [[0], np.cumsum(np.bincount(tids, minlength=n_terms))])
    require(np.array_equal(sc.cpu().numpy(), starts[order].astype(np.int32))
            and np.array_equal(st.cpu().numpy(), tids[order].astype(np.int32))
            and np.array_equal(off.cpu().numpy(),
                               want_off.astype(np.int32)),
            "build_postings differs from numpy lexsort")
    say(f"build_postings: {tids.size} tokens, {n_terms} terms, "
        f"{t_build * 1e3:.2f} ms on the card; equals numpy lexsort")
    return dix


def _queries(dix, n: int):
    from docodo_tpu_torch.mix import standard_mix

    counts = np.diff(dix.offsets_np)
    terms, rs = standard_mix(counts, dix.terms, n)
    return [[(dix.terms[t[j]], int(r[j])) for j in range(2) if t[j] >= 0]
            for t, r in zip(terms, rs)]


def phase_main(dix, queries, card: str):
    """The main path: the 10k batch on the kernel route with every launch
    count zeroed just before and read just after, the bucket routes
    counted, then the plain route, field for field."""
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops import device_index as tdi

    def run(use_kernels: bool):
        return dix.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                     use_kernels=use_kernels)

    run(True)  # warm
    torch.cuda.synchronize()
    routes = {"slot": "_kernel_bucket_full", "chunked": "_chunked_bucket_full",
              "plain": "query_step_full"}
    served = dict.fromkeys(routes, 0)
    saved = {name: getattr(tdi, fn) for name, fn in routes.items()}

    def counted(name):
        def call(*a, **k):
            out = saved[name](*a, **k)
            served[name] += out is not None
            return out
        return call

    for name, fn in routes.items():
        setattr(tdi, fn, counted(name))
    for k in _cuda.KERNELS.values():
        k.launches = 0
    try:
        t0 = time.perf_counter()
        out = run(True)
        secs = time.perf_counter() - t0
    finally:
        for name, fn in routes.items():
            setattr(tdi, fn, saved[name])
    launches = {name: k.launches for name, k in _cuda.KERNELS.items()}
    say(f"main path: {len(queries)} queries, kernel route {secs * 1e3:.1f} "
        f"ms warm ({len(queries) / secs:.0f} QPS) on {card}; buckets per "
        f"route {served}; launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    require(served["plain"] == 0,
            f"{served['plain']} buckets took query_step_full")
    run(False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = run(False)
    psecs = time.perf_counter() - t0
    for f, v in out.items():
        if v.dtype == np.float32:
            u = ulps(torch.from_numpy(v), torch.from_numpy(plain[f]))
            require(u <= 1, f"{f}: kernel and plain routes {u} ulp apart")
        else:
            require(np.array_equal(v, plain[f]), f"{f}: routes differ")
    say(f"plain route: {psecs * 1e3:.1f} ms warm "
        f"({len(queries) / psecs:.0f} QPS); every field equal to the "
        f"kernel route (ranks within 1 ulp)")
    return out, launches


def _bytes_moved(name: str, args) -> int:
    """Bytes a kernel's function must move for these inputs: each input
    lane it needs read once (only the valid lanes of a posting block or
    stream), each output written once."""
    from docodo_tpu_torch.ops.seqops import INF32

    def valid(n, cap):
        return int(n.clamp(0, cap).sum())

    if name in ("sorted_and_locate_full", "merge_and_locate_topk"):
        a, _, na, _, b, _, nb, _, kpad, hpad = args
        rows, cap = a.shape
        return (8 * (valid(na, cap) + valid(nb, cap)) + 16 * rows
                + rows * (12 * kpad + 4 * hpad + 8))
    if name in ("single_locate_full", "union_locate_full"):
        a, _, na, kpad, hpad = args
        rows, cap = a.shape
        return 8 * valid(na, cap) + 4 * rows + rows * (12 * kpad + 4 * hpad
                                                       + 8)
    if name == "merge_tagged":
        a, a_pg, na, b, _, nb = args
        rows, cap = a.shape
        per = 4 if a_pg is None else 8
        return (per * (valid(na, cap) + valid(nb, cap)) + 8 * rows
                + rows * 2 * cap * (per + 4))
    if name == "and_keep":
        vals, _, _, _ = args
        return 8 * int((vals < INF32).sum()) + 8 * vals.shape[0] \
            + 4 * vals.numel()
    hv, pg, bounds, kpad, hpad = args  # locate_runs
    kept = int((hv < INF32).sum())
    read = 8 * kept if pg is not None else 4 * kept + 4 * bounds.numel()
    return read + hv.shape[0] * (12 * kpad + 4 * hpad + 8)


def _lanes(name: str, args) -> int:
    """Lanes that carry data in a call's input: the valid lanes of the
    posting blocks, or of the merged and kept streams."""
    from docodo_tpu_torch.ops.seqops import INF32

    if name in ("and_keep", "locate_runs"):
        return int((args[0] < INF32).sum())
    if len(args) == 5:     # (a, a_pg, na, kpad, hpad)
        lengths = (args[2],)
    elif len(args) == 6:   # (a, a_pg, na, b, b_pg, nb)
        lengths = (args[2], args[5])
    else:                  # (a, a_pg, na, ra, b, b_pg, nb, rb, kpad, hpad)
        lengths = (args[2], args[6])
    cap = args[0].shape[1]
    return sum(int(n.clamp(0, cap).sum()) for n in lengths)


def phase_kernel_times(dix, queries) -> dict:
    """Every kernel on the calls one kernel-route batch makes: the calls'
    inputs are recorded, then each kernel's launches for the batch and
    its plain version's run back to back between CUDA events (median of
    10), are checked equal, and give the bound and, for merge_tagged,
    the one PyTorch call that computes the same function (a stable sort
    of the packed coord << 2 | tag key)."""
    from docodo_tpu_torch.ops import query_kernels as qk

    calls = {name: [] for name in KERNELS}
    saved = {}
    for name, (_, _, core, _) in KERNELS.items():
        saved[core] = getattr(qk, core)

        def rec(*args, _fn=saved[core], _name=name):
            calls[_name].append(args)
            return _fn(*args)
        setattr(qk, core, rec)
    try:
        dix.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                              use_kernels=True)
    finally:
        for core, fn in saved.items():
            setattr(qk, core, fn)
    torch.cuda.synchronize()

    res = {}
    for name, (_, _, core, plain_core) in KERNELS.items():
        kern, plain = getattr(qk, core), getattr(qk, plain_core)
        cs = calls[name]
        err = 0.0
        for args in cs:
            got, want = kern(*args), plain(*args)
            if name == "merge_tagged":
                live = want[0] < 2**31 - 1
                require(torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])
                        and (got[2] is None
                             or torch.equal(got[2][live], want[2][live])),
                        "merge_tagged differs on the main path")
            elif name == "and_keep":
                require(torch.equal(got, want),
                        "and_keep differs on the main path")
            else:
                err = max(err, same_outputs(got, want,
                                            f"{name} on the main path"))
        ms = cuda_ms(lambda: [kern(*a) for a in cs])
        plain_ms = cuda_ms(lambda: [plain(*a) for a in cs])
        library_ms = None
        if name == "merge_tagged":
            keys = []
            for a, _, na, b, _, nb in cs:
                lane = torch.arange(a.shape[1], device=a.device)[None, :]
                ia, ib = lane < na[:, None], lane < nb[:, None]
                vals = torch.cat([torch.where(ia, a, 2**31 - 1),
                                  torch.where(ib, b, 2**31 - 1)], dim=1)
                tag = torch.cat([torch.where(ia, 0, 2),
                                 torch.where(ib, 1, 2)], dim=1)
                keys.append((vals.long() << 2) | tag)
            library_ms = cuda_ms(lambda: [torch.sort(k, dim=1, stable=True)
                                          for k in keys])
        nbytes = sum(_bytes_moved(name, a) for a in cs)
        ops = OPS_PER_LANE * sum(_lanes(name, a) for a in cs)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = ops / INT_OPS_PER_S * 1e3
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=max(byte_ms, op_ms),
                         bound_by="bytes" if byte_ms >= op_ms
                         else "operations",
                         library_ms=library_ms)
        shapes = sorted({tuple(a[0].shape) for a in cs})
        say(f"kernel time: {name}: {len(cs)} calls of the batch "
            f"(shapes {shapes[:3]}{'...' if len(shapes) > 3 else ''}), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{res[name]['bound_ms']:.4f} ms ({nbytes} bytes), library "
            f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}; "
            f"equal to the plain version")
    return res


def phase_oracle(dix, queries, out, rng, n: int = 512) -> None:
    """Served rows against numpy: group_and over the host postings, the
    page bounds and the rank formula (as benchmarks/common.py:306-338)."""
    from docodo_tpu_torch.oracle import group_and

    coords = dix.coords.cpu().numpy().astype(np.uint64)
    off = dix.offsets_np
    bounds = dix.bounds_np
    checked = mismatches = 0
    for qi in rng.choice(len(queries), size=min(n, len(queries)),
                         replace=False):
        npg, nht = int(out["n_pages"][qi]), int(out["n_hits"][qi])
        if npg > TOPK or nht > HIT_CAP:
            continue  # truncated: re-served on the host by the caller
        acc = r_acc = None
        for word, r in queries[qi]:
            t = dix.term_id(word)
            lst = coords[off[t]: off[t + 1]]
            if acc is None:
                acc, r_acc = lst, r
            else:
                acc, r_acc = group_and(acc, lst, r_acc, r)
        acc = np.asarray(acc, dtype=np.int64)
        page = np.minimum(np.searchsorted(bounds, acc, side="right"),
                          bounds.size - 1)
        first = np.concatenate([[True], page[1:] != page[:-1]])[:acc.size]
        run = np.cumsum(first) - 1
        gaps = np.diff(acc, prepend=0)
        bonus = np.where(~first, 30 // np.maximum(5, gaps), 0)
        cnt = np.bincount(run, minlength=run.max(initial=-1) + 1)
        rank = (1.0 + np.bincount(run, weights=bonus, minlength=cnt.size)
                + np.log(np.maximum(cnt, 1)))
        want = sorted(zip(page[first].tolist(), cnt.tolist()))
        got_pages = out["pages"][qi][: npg]
        got = sorted(zip(got_pages.tolist(),
                         out["counts"][qi][: npg].tolist()))
        got_rank = dict(zip(got_pages.tolist(),
                            out["ranks"][qi][: npg].tolist()))
        ok = (npg == int(first.sum()) and nht == acc.size
              and np.array_equal(out["hits"][qi][:nht], acc)
              and got == want
              and all(abs(got_rank[p] - rk) <= 1e-5 * rk
                      for p, rk in zip(page[first].tolist(), rank)))
        checked += 1
        mismatches += not ok
    say(f"oracle: {checked} served rows of {n} sampled checked against "
        f"numpy group_and + rank formula; mismatches {mismatches}")
    require(checked > 0 and mismatches == 0, "oracle mismatches")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus-mb", type=float, default=64.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    card, smi = phase_device()
    phase_build()
    rng = np.random.default_rng(args.seed)
    err = phase_parity(rng)
    dix = phase_index(args.corpus_mb, args.seed)
    queries = _queries(dix, N_QUERIES)
    out, launches = phase_main(dix, queries, f"{card} ({smi})")
    times = phase_kernel_times(dix, queries)
    phase_oracle(dix, queries, out, rng)
    say(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=replaces,
             launches=launches[name],
             **dict(times[name],
                    max_abs_err=max(err[name], times[name]["max_abs_err"])))
        for name, (src, replaces, _, _) in KERNELS.items()]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
