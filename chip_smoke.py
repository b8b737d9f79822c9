"""Smoke run of docodo_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels from the checkout, holds each against its plain PyTorch version,
builds a seeded 64 MB Zipf corpus index, serves the standard 10k query
mix through the kernel route and the plain route, and checks sampled
results against an independent numpy oracle.

    python3 chip_smoke.py [--corpus-mb 64] [--seed 0]

Prints one line per phase, a JSON line with every kernel's launches,
error and times, the card's name and power limit, and as its last line
{"ok": true, "device": {...}}. Exits non-zero, without that line, when
there is no CUDA device or any phase fails. Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

TOPK = 64
HIT_CAP = 1024
SOURCE = "docodo_tpu_torch/csrc/locate_full.cu"
REPLACES = {
    "sorted_and_locate_full": "docodo_tpu/ops/pallas_query.py:617",
    "single_locate_full": "docodo_tpu/ops/pallas_query.py:723",
    "union_locate_full": "docodo_tpu/ops/pallas_query.py:660",
}
PARITY_CAPS = {
    "sorted_and_locate_full": (64, 128, 256, 512),
    "single_locate_full": (64, 128),
    "union_locate_full": (256, 512, 1024),
}
PARITY_ROWS = 4096
N_QUERIES = 10_000  # the standard mix's batch


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


def cuda_ms(fn, reps: int = 20) -> float:
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
    say(f"build: nvcc {secs:.1f} s -> {_cuda.library_path().name}")
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
    """Each kernel against its plain version at the main path's shapes:
    int outputs exact, ranks within 1 ulp. Returns per-kernel
    {max_abs_err, ms, plain_ms} summed over the shapes."""
    from docodo_tpu_torch.ops import query_kernels as qk

    dev = torch.device("cuda")
    res = {}
    for name, caps in PARITY_CAPS.items():
        err, ms, plain_ms = 0.0, 0.0, 0.0
        for cap in caps:
            x = _parity_inputs(rng, PARITY_ROWS, cap, dev)
            kw = dict(topk=TOPK, hit_cap=HIT_CAP, tail=False)
            if name == "sorted_and_locate_full":
                args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"],
                        x["bounds"])
                kw.update(a_pg=x["a_pg"], b_pg=x["b_pg"])
                kern, plain = qk.sorted_and_locate_full, \
                    qk.sorted_and_locate_full_plain
            else:
                if name == "single_locate_full":
                    args = (x["a"], x["na"], x["bounds"])
                    kw.update(a_pg=x["a_pg"])
                else:
                    args = (x["a"][:, None], x["na"][:, None], x["bounds"])
                    kw.update(a_pg=x["a_pg"][:, None])
                kern = getattr(qk, name)
                plain = getattr(qk, name + "_plain")
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            for field, g, w in zip(("pg_c", "rk_c", "ct_c", "n_pages",
                                    "n_hits", "hits"), got, want):
                if field == "rk_c":
                    u = ulps(g, w)
                    require(u <= 1, f"{name} cap {cap}: ranks {u} ulp apart")
                    err = max(err, float((g - w).abs().max()))
                else:
                    bad = (g != w).nonzero()
                    require(bad.numel() == 0, f"{name} cap {cap}: {field} "
                            f"differs at {bad[:4].tolist()}")
            k_ms = cuda_ms(lambda: kern(*args, **kw))
            p_ms = cuda_ms(lambda: plain(*args, **kw))
            ms += k_ms
            plain_ms += p_ms
            say(f"parity: {name} cap {cap} B {PARITY_ROWS}: equal; "
                f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return res


def phase_index(corpus_mb: float, seed: int):
    from docodo_tpu.native import pipeline as npipe
    from docodo_tpu_torch.ops.device_index import DeviceIndex, build_postings
    from docodo_tpu_torch.synthetic import build_index, zipf_documents

    t0 = time.perf_counter()
    docs = zipf_documents(int(corpus_mb * 1e6), seed=seed)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="docodo_smoke_") as work:
        ind = build_index(docs, work)
    t2 = time.perf_counter()
    dix = DeviceIndex.from_index(ind, device="cuda")
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
    interner = npipe.make_interner()
    tids, starts = npipe.tokenize_intern(text, interner)
    n_terms = len(interner.terms())
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
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from benchmarks.common import standard_mix

    counts = np.diff(dix.offsets_np)
    terms, rs = standard_mix(counts, dix.terms, n)
    return [[(dix.terms[t[j]], int(r[j])) for j in range(2) if t[j] >= 0]
            for t, r in zip(terms, rs)]


def phase_main(dix, queries, card: str):
    from docodo_tpu_torch.ops import _cuda

    def run(use_kernels: bool):
        dix.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                              use_kernels=use_kernels)  # warm
        torch.cuda.synchronize()
        if use_kernels:
            for k in _cuda.KERNELS.values():
                k.launches = 0
        t0 = time.perf_counter()
        out = dix.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                    use_kernels=use_kernels)
        return out, time.perf_counter() - t0

    out, secs = run(True)
    launches = {name: k.launches for name, k in _cuda.KERNELS.items()}
    say(f"main path: {len(queries)} queries, kernel route {secs * 1e3:.1f} "
        f"ms warm ({len(queries) / secs:.0f} QPS) on {card}; launches "
        f"{launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    plain, psecs = run(False)
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


def phase_oracle(dix, queries, out, rng, n: int = 512) -> None:
    """Served rows against numpy: group_and over the host postings, the
    page bounds and the rank formula (as benchmarks/common.py:306-338)."""
    from docodo_tpu.core.postings import group_and

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
    kern = phase_parity(rng)
    dix = phase_index(args.corpus_mb, args.seed)
    queries = _queries(dix, N_QUERIES)
    out, launches = phase_main(dix, queries, f"{card} ({smi})")
    phase_oracle(dix, queries, out, rng)
    say(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
             launches=launches[name], **kern[name])
        for name in PARITY_CAPS]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
