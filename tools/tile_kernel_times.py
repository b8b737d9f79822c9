"""Device time of kernels at the main path's bucket shapes, and the host
time of a wrapper call, on seeded chip_smoke.py inputs:

- the tiled kernels (and_keep, its compacted form, locate_runs with
  carried and looked-up pages, variants_keep);
- merge_tagged at the W = 2 buckets (8, 262144) and (8, 32768), the
  V 4+4 buckets at caps 32768, 2048, 1024 and 256 (8, 16, 32 and 128
  rows) and a W = 3 fold step (a running stream of 65536 lanes and the
  next word's block of 32768), with the device time of torch.sort on
  the same inputs (merge_tagged's library call: a stable sort of the
  packed key coord << 2 | tag);
- the W = 2 slot kernel (sorted_and_locate_full, and its top-k-mode form
  sorted_and_locate_full_topk) and the page-level W = 2 kernel
  (sorted_and_locate, topk 16, with carried pages and with pages from
  bounds) at the page-level batch's W = 2 buckets, cap 64 x 8192,
  128 x 1024, 256 x 512 and 512 x 512 rows;
- merge_and_locate_topk and merge_and_locate at the fused batches'
  widest launches, cap 1024 x 128 and 2048 x 64 rows, with the inputs'
  pages and with one page a row (every kept lane of a row in one run);
- the variant slot kernels, union_merge_locate_full and
  variants_and_locate_full, each with the slots tail and the top-k one
  (union_locate_full_topk, variants_and_locate_full_topk), at the wide
  serving pass's launches (V 8 and V 4 + 4 at cap 128, 128 rows; V 8 at
  512 rows, topk 128, hit_cap 2048), at each stream width they are
  compiled for (n = 128, 256, 512) and at 16 and 32 blocks a row;
- the W = 1 kernel: single_locate_full (both tails: the slots tail and
  single_locate_full_topk) at caps 64 and 128, union_locate_full (V = 1)
  and its top-k form union_locate_full_topk at V = 1 at caps 256, 512
  and 1024, and the page-level batched_single_locate (topk 16, pages
  carried and looked up in the bounds) at caps 32, 64 and 128, each at
  128 rows (one wave of the serving launches) and 4096 rows (more than
  a wave);
- the host microseconds of one call of merge_tagged and of
  sorted_and_locate_full at 8 rows of cap 64, of
  variants_and_locate_full (V 4 + 4) and union_merge_locate_full (V 4)
  at the serving pass's 128 rows of cap 128, and of single_locate_full
  at 128 rows of cap 128, where the card waits on the host (the least
  of 9 means over 100 calls).

A device time is the mean of one call over 20, from torch.profiler's
device events (the larger of two profiled runs); beside the merge and
slot shapes, their bytes bound (chip_smoke.py's, at 3.35 TB/s). With
--batch, also the batches' own calls (chip_smoke.py's 64 MB corpus,
kernel route) replayed by shape: merge_tagged's in the wide fused batch
(the wide mix and its alternations), merge_and_locate_topk's in the
standard and the wide fused batch, and the page-level W = 2 kernel's in
the page-level batch (the standard mix through search_batch, topk 16),
also with its pages from bounds, the page-level W = 1 kernel's there
(its carried calls also from bounds), and the variant slot kernels' and the
W = 1 kernel's calls (both tails) in the fused batches and in one
standard and one wide serving pass per sort_topk mode
(tools/profile_batch.py's serve_pass: waves of 512 rows, the cap
ladder, deferred, then the escalated pass); for each shape the calls,
the device ms of all of them once and their bytes bound, and for
merge_and_locate_topk also the same calls through the kernels that give
a row several blocks (merge_tagged, and_keep, locate_runs).

    python3 tools/tile_kernel_times.py [--batch] [ROOT ...]

One ROOT (default: this checkout) is the tree whose docodo_tpu_torch and
chip_smoke.py are imported; prints one JSON line. With two or more, the
script runs itself on each ROOT in turns, first to last and back again
(A B B A), each run in a child process with its own tree's build, and
prints one JSON line holding every run: the way to compare trees that
differ in a kernel in one call on one card. A ROOT's query_kernels must
have as_variant_blocks. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
REPS = 20
WINDOWS = 2
HOST_CALLS = 100
HOST_REPS = 9
TILED = ("keep_marks_kernel", "keep_resolve_kernel", "locate_runs_kernel")
MERGE = ("merge_tagged_kernel", "merge_pass_kernel", "merge_row_kernel")
SLOT = ("sorted_and_locate_full_kernel",)
# the page-level W = 2 kernel: its own body in older trees, the W = 2
# slot template with the page-level tail since
PAGE = ("::and_locate_topk_kernel", "PageTopkTail")
FUSED = ("merge_and_locate_topk_kernel",)
STREAMS = ("merge_and_locate_kernel",)
VARIANTS = ("variants_and_locate_full_kernel",)
UNION = ("union_merge_locate_full_kernel",)
# the W = 1 kernel: a kernel a keep rule in older trees, one template on
# the keep rule since
SINGLE = ("single_locate_full_kernel<docodo::SlotsTail",
          "w1_locate_full_kernel<docodo::SingleKeep, docodo::SlotsTail")
SINGLE_TOPK = ("single_locate_full_kernel<docodo::TopkTail",
               "w1_locate_full_kernel<docodo::SingleKeep, docodo::TopkTail")
W1_UNION = ("::union_locate_full_kernel",
            "w1_locate_full_kernel<docodo::UnionKeep")
# the V = 1 union's top-k form: the variant body in older trees, the W = 1
# body with the top-k tail since
UNION_TOPK = UNION + ("w1_locate_full_kernel<docodo::UnionKeep, "
                      "docodo::TopkTail",)
# the page-level W = 1 kernel: its own body in older trees, the W = 1
# template with the page-level tail since
PAGE_W1 = ("single_locate_topk_kernel",
           "w1_locate_full_kernel<docodo::SingleKeep, docodo::PageTopkTail")
# (rows, cap) of W = 2 buckets: a wide bucket at the largest cap, a few
# rows at cap 32768, and many-row buckets within one tile
W2_SHAPES = ((8, 262144), (8, 32768), (64, 2048), (1024, 1024))
# (Va, Vb, cap, rows) of variant buckets
VARIANT_SHAPES = ((4, 4, 32768, 8), (4, 4, 512, 128))
# (cap, rows) of the W = 2 slot kernel's buckets
SLOT_SHAPES = ((64, 8192), (128, 1024), (256, 512), (512, 512))
# (cap, rows) of the fused kernels' widest launches in the fused batches
FUSED_SHAPES = ((1024, 128), (2048, 64))
# (va, vb, cap, rows, topk, hit_cap) of the variant slot kernels; vb = 0
# is union_merge_locate_full: the wide serving pass's launches, then each
# narrower stream width and 16 and 32 blocks a row
VARIANT_SLOT_SHAPES = ((8, 0, 128, 128, 64, 1024), (4, 4, 128, 128, 64, 1024),
                       (8, 0, 128, 512, 128, 2048), (2, 2, 128, 128, 64, 1024),
                       (4, 0, 32, 512, 64, 1024), (2, 2, 64, 512, 64, 1024),
                       (4, 0, 128, 512, 64, 1024), (8, 8, 64, 128, 64, 1024),
                       (32, 0, 32, 128, 64, 1024))
# caps of the W = 1 kernel (row 2: 64, 128; row 3 at V = 1: 256-1024; row
# 14: 32-128) and its rows: one wave of the serving launches, and more
# than a wave
W1_CAPS = {"single_locate_full": (64, 128),
           "union_locate_full": (256, 512, 1024),
           "single_locate_topk": (32, 64, 128)}
W1_ROWS = (128, 4096)


def device_ms(fn, names=None) -> float:
    """Device ms of one fn() in the kernels whose names contain one of
    `names` (every device event without), over REPS calls: the larger of
    WINDOWS profiled runs, since now and then a run's trace misses some
    of its device events (which only lowers it)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(WINDOWS):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        best = max(best, sum(
            float(getattr(e, "self_device_time_total", 0)
                  or getattr(e, "self_cuda_time_total", 0))
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and (names is None or any(k in e.key for k in names))))
    return best / 1e3 / REPS


def bound_ms(cs, name: str, core_args) -> float:
    """chip_smoke.py's bytes bound of a kernel core's call: each input lane
    it needs read once, each output written once, over HBM_BYTES_PER_S."""
    return cs._bytes_moved(name, core_args) / cs.HBM_BYTES_PER_S * 1e3


def host_us(fn) -> float:
    """Host microseconds of one fn(): the least mean over HOST_REPS runs
    of HOST_CALLS calls in a row (the host is shared; its least is the
    code's cost)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(HOST_REPS):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        best = min(best, (time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return best


# the cores --batch records: query_kernels function -> (chip_smoke.py's
# kernel name, the profiler names of its launches)
BATCH_CORES = {"_merge_tagged_kernel": ("merge_tagged", MERGE),
               "_merge_and_locate_kernel": ("merge_and_locate_topk", FUSED),
               "_and_topk_kernel": ("and_locate_topk", PAGE),
               "_union_merge_kernel": ("union_merge_locate_full", UNION),
               "_variants_and_kernel": ("variants_and_locate_full",
                                        VARIANTS),
               "_single_kernel": ("single_locate_full", SINGLE),
               "_single_topk_mode_kernel": ("single_locate_full_topk",
                                            SINGLE_TOPK),
               "_union_kernel": ("union_locate_full", W1_UNION),
               "_single_topk_kernel": ("single_locate_topk", PAGE_W1)}
# the variant cores' top-k twins go through the same cores with their
# kernel= argument (the W = 1 kernel's is a core of its own)
TWINS = {"union_merge_locate_full": "union_locate_full_topk",
         "variants_and_locate_full": "variants_and_locate_full_topk"}
W1_CORES = ("single_locate_full", "single_locate_full_topk",
            "union_locate_full")


def batch_calls(cs, qk) -> dict:
    """The batches' calls of BATCH_CORES replayed by shape: for each
    shape [calls, device ms of all of them once, bytes bound ms], and for
    merge_and_locate_topk a fourth, the device ms of the same calls
    through merge_tagged, and_keep and locate_runs (several blocks a
    row); the page-level kernel's calls also with pages from bounds."""
    import contextlib
    import io

    import numpy as np
    import torch

    from docodo_tpu_torch.mix import mix_queries, wide_mix

    with contextlib.redirect_stdout(io.StringIO()):
        dix = cs.phase_index(64.0, 0)
    std = cs._queries(dix, cs.N_QUERIES)
    wide = cs._wide_queries(dix, cs.N_QUERIES, cs.N_ALTERNATIONS)
    pb = cs._profile_batch()
    terms, rs, _ = wide_mix(np.diff(dix.offsets_np), dix.terms,
                            cs.N_QUERIES, seed=cs.WIDE_SEED)
    serve = mix_queries(terms, rs, dix.terms)
    batches = {
        "standard batch": lambda: dix.search_batch_full(
            std, topk=64, hit_cap=1024, use_kernels=True),
        "wide batch": lambda: dix.search_batch_full(
            wide, topk=64, hit_cap=1024, use_kernels=True),
        "page batch": lambda: dix.search_batch(std, topk=cs.PAGE_TOPK,
                                               use_kernels=True),
        "standard serve": lambda: pb.serve_pass(dix, std, True),
        "standard serve top-k mode": lambda: pb.serve_pass(dix, std, False),
        "wide serve": lambda: pb.serve_pass(dix, serve, True),
        "wide serve top-k mode": lambda: pb.serve_pass(dix, serve, False),
    }
    groups = {}
    saved = {core: getattr(qk, core) for core in BATCH_CORES}
    label = [""]

    def recorder(core):
        name = BATCH_CORES[core][0]

        def rec(*args, **kw):
            a = args[0]
            if name in TWINS:
                twin = "kernel" in kw
                shape = (f"B{a.shape[0]} V{a.shape[1]}"
                         + (f"+{args[4].shape[1]}"
                            if name == "variants_and_locate_full" else "")
                         + f" cap{a.shape[2]} kpad{args[-2]} hpad{args[-1]}")
                key = (TWINS[name] if twin else name, label[0], shape)
                groups.setdefault(key, []).append((args, kw))
                return saved[core](*args, **kw)
            if name == "merge_tagged":
                b = args[3]
                shape = (f"B{a.shape[0]} a{tuple(a.shape[1:])} "
                         f"b{tuple(b.shape[1:])} paged {args[1] is not None}")
            elif name == "merge_and_locate_topk":
                shape = (f"B{a.shape[0]} cap{a.shape[1]} kpad{args[8]} "
                         f"hpad{args[9]}")
            elif name in W1_CORES:
                shape = (f"B{a.shape[0]} cap{a.shape[1]} kpad{args[3]} "
                         f"hpad{args[4]}")
            elif name == "single_locate_topk":
                shape = (f"B{a.shape[0]} cap{a.shape[1]} topk{args[4]} "
                         f"{'carried' if args[1] is not None else 'bounds'}")
            else:
                shape = f"B{a.shape[0]} cap{a.shape[1]} topk{args[9]}"
            groups.setdefault((name, label[0], shape), []).append((args, {}))
            return saved[core](*args)
        return rec

    for core in BATCH_CORES:
        setattr(qk, core, recorder(core))
    try:
        for label[0], run in batches.items():
            run()
    finally:
        for core, fn in saved.items():
            setattr(qk, core, fn)
    torch.cuda.synchronize()
    out = {}
    cores = {name: (saved[core], names)
             for core, (name, names) in BATCH_CORES.items()}
    cores.update({twin: cores[name] for name, twin in TWINS.items()})
    cores["union_locate_full_topk"] = (cores["union_locate_full_topk"][0],
                                       UNION_TOPK)
    for (name, where, shape), calls in sorted(groups.items()):
        core, names = cores[name]
        key = f"{name} {where} {shape}"
        out[key] = [len(calls), device_ms(
            lambda: [core(*a, **kw) for a, kw in calls], names),
            sum(bound_ms(cs, name, a) for a, _ in calls)]
        calls = [a for a, _ in calls]
        if name == "merge_and_locate_topk":
            def chunked(calls=calls):
                for a, a_pg, na, ra, b, b_pg, nb, rb, kpad, hpad in calls:
                    vals, tag, pg = qk.merge_tagged(a, na, b, nb, a_pg, b_pg)
                    hv = qk.and_keep(vals, tag, ra, rb)
                    qk.locate_runs(hv, dix.bounds, topk=kpad, hit_cap=hpad,
                                   pg=pg)
            out[key].append(device_ms(chunked, MERGE + TILED))
        other = None
        if name == "and_locate_topk":
            other = [(a[0], None, a[2], a[3], a[4], None) + tuple(a[6:])
                     for a in calls]
        elif name == "single_locate_topk" and calls[0][1] is not None:
            other = [(a[0], None) + tuple(a[2:]) for a in calls]
        if other:
            out[key + " from bounds"] = [len(other), device_ms(
                lambda: [core(*a) for a in other], names),
                sum(bound_ms(cs, name, a) for a in other)]
    return out


def measure(root: Path, batch: bool = False) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from docodo_tpu_torch.ops import _cuda
    from docodo_tpu_torch.ops import query_kernels as qk

    if not torch.cuda.is_available():
        raise SystemExit("tile_kernel_times: no CUDA device")
    if not Path(qk.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {qk.__file__}, not from {root}")
    _cuda.build()
    _cuda.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    out = {"root": str(root), "card": smi.splitlines()[0],
           "ptxas": [ln.strip() for ln in _cuda.build_log.splitlines()
                     if "registers" in ln or "Compiling entry" in ln]}
    for rows, cap in W2_SHAPES:
        x = cs._parity_inputs(rng, rows, cap, dev, full_first=rows < 8)
        vals, tag, pg = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"],
                                        x["a_pg"], x["b_pg"])
        ra, rb, bounds = x["ra"], x["rb"], x["bounds"]
        hv = qk.and_keep(vals, tag, ra, rb)
        key = f"W2 B{rows} n{2 * cap}"
        out[key + " and_keep"] = device_ms(
            lambda: qk.and_keep(vals, tag, ra, rb), TILED)
        out[key + " and_keep_compact"] = device_ms(
            lambda: qk.and_keep_compact(vals, tag, ra, rb, pg), TILED)
        for label, p in (("carried", pg), ("bounds", None)):
            out[f"{key} locate_runs {label}"] = device_ms(
                lambda: qk.locate_runs(hv, bounds, topk=64, hit_cap=1024,
                                       pg=p), TILED)
    for va, vb, cap, rows in VARIANT_SHAPES:
        x = cs._variant_inputs(rng, rows, va, vb, cap, dev, spacing=4)
        vals, tag, _ = qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"])
        out[f"V{va}+{vb} B{rows} n{(va + vb) * cap} variants_keep"] = (
            device_ms(lambda: qk.variants_keep(vals, tag, x["ra"], x["rb"],
                                               x["bpad"]), TILED))

    merges = []
    for rows, cap in ((8, 262144), (8, 32768)):
        x = cs._parity_inputs(rng, rows, cap, dev, full_first=True)
        merges.append((f"W2 B{rows} n{2 * cap}", (
            x["a"], x["na"], x["b"], x["nb"], x["a_pg"], x["b_pg"])))
    for rows, cap in ((8, 32768), (16, 2048), (32, 1024), (128, 256)):
        x = cs._variant_inputs(rng, rows, 4, 4, cap, dev, spacing=4)
        merges.append((f"V4+4 B{rows} n{8 * cap}", (
            x["a"], x["na"], x["b"], x["nb"], x["a_pg"], x["b_pg"])))
    x = cs._parity_inputs(rng, 8, 65536, dev, full_first=True)
    merges.append(("W3 fold step B8 n65536+32768", (
        x["a"], x["na"], x["b"][:, :32768].contiguous(),
        x["nb"].clamp(max=32768), x["a_pg"],
        x["b_pg"][:, :32768].contiguous())))
    for key, args in merges:
        a, na, b, nb, a_pg, b_pg = args
        blocks = qk.as_variant_blocks(a, a_pg, na, b, b_pg, nb)
        out[f"{key} merge_tagged"] = device_ms(
            lambda: qk.merge_tagged(*args), MERGE)
        out[f"{key} merge_tagged bound"] = bound_ms(
            cs, "merge_tagged", blocks)
        sort = cs._library_call("merge_tagged", [blocks])
        out[f"{key} torch.sort"] = device_ms(sort)

    for cap, rows in SLOT_SHAPES:
        x = cs._parity_inputs(rng, rows, cap, dev)
        args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"],
                x["bounds"])
        pgs = dict(a_pg=x["a_pg"], b_pg=x["b_pg"])
        out[f"slot cap{cap} B{rows} bound"] = bound_ms(
            cs, "sorted_and_locate_full",
            (x["a"], x["a_pg"], x["na"], x["ra"], x["b"], x["b_pg"], x["nb"],
             x["rb"], min(64, 2 * cap), min(1024, 2 * cap)))
        out[f"slot cap{cap} B{rows} sorted_and_locate_full"] = device_ms(
            lambda: qk.sorted_and_locate_full(*args, topk=64, hit_cap=1024,
                                              tail=False, **pgs), SLOT)
        out[f"slot cap{cap} B{rows} sorted_and_locate_full_topk"] = (
            device_ms(lambda: qk.sorted_and_locate_full(
                *args, topk=64, hit_cap=1024, sort_topk=False, **pgs),
                SLOT))
        for label, p in (("carried", pgs), ("bounds", {})):
            out[f"page cap{cap} B{rows} sorted_and_locate {label}"] = (
                device_ms(lambda p=p: qk.sorted_and_locate(
                    *args, topk=cs.PAGE_TOPK, **p), PAGE))
            out[f"page cap{cap} B{rows} sorted_and_locate {label} "
                "bound"] = bound_ms(cs, "and_locate_topk", (
                    x["a"], p.get("a_pg"), x["na"], x["ra"], x["b"],
                    p.get("b_pg"), x["nb"], x["rb"], x["bounds"],
                    cs.PAGE_TOPK))

    # the fused kernels with the inputs' pages and with one page a row
    # (a row's kept lanes all in one run: the longest runs the run sums
    # meet)
    for cap, rows in FUSED_SHAPES:
        x = cs._parity_inputs(rng, rows, cap, dev)
        one = torch.zeros_like(x["a_pg"])
        for label, pgs in (("pages", (x["a_pg"], x["b_pg"])),
                           ("one page", (one, one))):
            args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"]) + pgs
            key = f"fused cap{cap} B{rows} {label}"
            out[key + " merge_and_locate_topk"] = device_ms(
                lambda: qk.merge_and_locate_topk(*args, topk=64,
                                                 hit_cap=1024), FUSED)
            out[key + " merge_and_locate"] = device_ms(
                lambda: qk.merge_and_locate(*args), STREAMS)

    # the variant slot kernels, both tails, with the inputs' pages
    for va, vb, cap, rows, topk, hit_cap in VARIANT_SLOT_SHAPES:
        x = cs._variant_inputs(rng, rows, va, max(vb, 1), cap, dev,
                               spacing=120)
        n = (va + vb) * cap
        if vb:
            name, names = "variants_and_locate_full", VARIANTS
            args = (x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"],
                    x["bpad"], x["bounds"])
            pgs = dict(a_pg=x["a_pg"], b_pg=x["b_pg"])
            core = (x["a"], x["a_pg"], x["na"], x["ra"], x["b"], x["b_pg"],
                    x["nb"], x["rb"], x["bpad"])
        else:
            name, names = "union_merge_locate_full", UNION
            args = (x["a"], x["na"], x["bounds"])
            pgs = dict(a_pg=x["a_pg"])
            core = (x["a"], x["a_pg"], x["na"])
        fn = getattr(qk, name)
        key = f"var V{va}+{vb} cap{cap} B{rows} topk{topk} hit_cap{hit_cap}"
        out[f"{key} {name}"] = device_ms(
            lambda: fn(*args, topk=topk, hit_cap=hit_cap, tail=False,
                       **pgs), names)
        out[f"{key} {name} bound"] = bound_ms(
            cs, name, core + (min(topk, n), min(hit_cap, n)))
        out[f"{key} {TWINS[name]}"] = device_ms(
            lambda: fn(*args, topk=topk, hit_cap=hit_cap, sort_topk=False,
                       **pgs), names)

    # the W = 1 kernel, both launch shapes, in each of its forms: rows 2
    # and 15d (both tails), row 3 and its top-k form 15c at V = 1, and
    # row 14 (the page-level tail, pages carried and looked up)
    for name, caps in W1_CAPS.items():
        for cap, rows in [(c, r) for c in caps for r in W1_ROWS]:
            x = cs._parity_inputs(rng, rows, cap, dev)
            a, na, a_pg = x["a"], x["na"], x["a_pg"]
            key = f"w1 cap{cap} B{rows}"
            if name == "single_locate_topk":
                for label, p in (("carried", a_pg), ("bounds", None)):
                    out[f"{key} {name} {label}"] = device_ms(
                        lambda p=p: qk.batched_single_locate(
                            a, na, x["bounds"], topk=cs.PAGE_TOPK, a_pg=p),
                        PAGE_W1)
                    out[f"{key} {name} {label} bound"] = bound_ms(
                        cs, name, (a, p, na, x["bounds"], cs.PAGE_TOPK))
                continue
            v1 = (a[:, None], na[:, None], x["bounds"])
            args = (a, na, x["bounds"]) if name == "single_locate_full" else v1
            pgs = dict(a_pg=a_pg if name == "single_locate_full"
                       else a_pg[:, None])
            names = SINGLE if name == "single_locate_full" else W1_UNION
            kpad, hpad = min(64, cap), min(1024, cap)
            out[f"{key} {name}"] = device_ms(
                lambda: getattr(qk, name)(*args, topk=64, hit_cap=1024,
                                          tail=False, **pgs), names)
            out[f"{key} {name} bound"] = bound_ms(
                cs, name, (a, a_pg, na, kpad, hpad))
            topk_form = ("single_locate_full_topk"
                         if name == "single_locate_full"
                         else "union_locate_full_topk V1")
            out[f"{key} {topk_form}"] = device_ms(
                lambda: getattr(qk, name)(*args, topk=64, hit_cap=1024,
                                          sort_topk=False, **pgs),
                SINGLE_TOPK if name == "single_locate_full" else UNION_TOPK)

    if batch:
        out.update(batch_calls(cs, qk))
    x = cs._parity_inputs(rng, 8, 64, dev)
    out["host us merge_tagged B8 cap64"] = host_us(
        lambda: qk.merge_tagged(x["a"], x["na"], x["b"], x["nb"], x["a_pg"],
                                x["b_pg"]))
    out["host us sorted_and_locate_full B8 cap64"] = host_us(
        lambda: qk.sorted_and_locate_full(
            x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"], x["bounds"],
            topk=64, hit_cap=1024, tail=False, a_pg=x["a_pg"],
            b_pg=x["b_pg"]))
    x = cs._variant_inputs(rng, 128, 4, 4, 128, dev)
    out["host us variants_and_locate_full B128 V4+4 cap128"] = host_us(
        lambda: qk.variants_and_locate_full(
            x["a"], x["na"], x["ra"], x["b"], x["nb"], x["rb"], x["bpad"],
            x["bounds"], topk=64, hit_cap=1024, tail=False, a_pg=x["a_pg"],
            b_pg=x["b_pg"]))
    out["host us union_merge_locate_full B128 V4 cap128"] = host_us(
        lambda: qk.union_merge_locate_full(
            x["a"], x["na"], x["bounds"], topk=64, hit_cap=1024, tail=False,
            a_pg=x["a_pg"]))
    x = cs._parity_inputs(rng, 128, 128, dev)
    out["host us single_locate_full B128 cap128"] = host_us(
        lambda: qk.single_locate_full(
            x["a"], x["na"], x["bounds"], topk=64, hit_cap=1024, tail=False,
            a_pg=x["a_pg"]))
    return out


def main() -> None:
    args = sys.argv[1:]
    batch = "--batch" in args
    roots = ([Path(r).resolve() for r in args if r != "--batch"]
             or [HERE.parents[1]])
    if len(roots) == 1:
        print(json.dumps(measure(roots[0], batch)), flush=True)
        return
    runs = []
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, str(HERE), str(root)]
                              + ["--batch"] * batch,
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"tile_kernel_times on {root} failed:\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(json.dumps({"turns": [r["root"] for r in runs], "runs": runs}),
          flush=True)


if __name__ == "__main__":
    main()
