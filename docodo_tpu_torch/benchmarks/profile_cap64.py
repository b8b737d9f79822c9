"""Stage-by-stage timing of the dominant full-result bucket (cap 64,
W = 2, hit tier 128 of the standard 10k mix) through the port's route:
the counterpart of benchmarks/profile_cap64.py on the card, which has no
kernel of its own and runs row 1's slot kernel.

Each stage is a prefix of the bucket's route, timed whole (CUDA events,
median of 10; torch.profiler's device ms), and the differences between
successive prefixes give each stage's cost:

  gather          both words' postings and pages (gather_term_paged, or
                  the small tables' row gather)
  +row-1 kernel   docodo_sorted_and_locate_full (query_kernels.
                  sorted_and_locate_full, tail=False): it merges the two
                  blocks by rank inside, so the TPU route's separate
                  tagged sort has no stage of its own
  +top-k          the rank top-k of the first runs (streams_topk_tail)
  +hits           the bucket's LocateFull; the kernel compacts the first
                  hit_cap hits itself, so this adds only their packing
  full (no docs)  device_index._bucket_full, with_docs=False
  full (+docs)    the same with doc grouping (doc_group_topk)

The original reads the Pickwick corpus, which is not in the repository:
this one runs on the 64 MB synthetic index (synthetic.py, seed 0).

    python -m docodo_tpu_torch.benchmarks.profile_cap64 [--corpus-mb 64]
"""

from __future__ import annotations

import argparse
import json

import torch

from docodo_tpu_torch.benchmarks import common as bc
from docodo_tpu_torch.ops import device_index as di
from docodo_tpu_torch.ops import query_kernels as qk

FULL_TOPK = 64
HIT_CAP = 128
CAP = 64


def stages(dix, tq, rq):
    """The stage prefixes of the bucket's route, each a callable that
    returns its outputs."""
    carried = di._tab_serves(dix.small, CAP)
    fetch = di._fetcher(dix.coords, dix.term_offsets, dix.page_of, CAP,
                        carried)
    ra, rb = rq[:, 0].contiguous(), rq[:, 1].contiguous()

    def gather():
        return fetch(tq[:, 0]), fetch(tq[:, 1])

    def kernel(tail=False):
        (a, apg, na), (b, bpg, nb) = gather()
        return qk.sorted_and_locate_full(a, na, ra, b, nb, rb, dix.bounds,
                                         topk=FULL_TOPK, hit_cap=HIT_CAP,
                                         a_pg=apg, b_pg=bpg, tail=tail)

    def full(with_docs):
        return di._bucket_full(
            dix.term_offsets, dix.coords, dix.bounds, dix.page_doc,
            dix.is_header, tq, rq, cap=CAP, topk=FULL_TOPK, hit_cap=HIT_CAP,
            with_docs=with_docs, use_kernels=True, small=dix.small,
            page_of=dix.page_of)

    return {
        "gather": gather,
        "+row-1 kernel": kernel,
        "+top-k": lambda: kernel(tail=True),
        "+hits": lambda: di._pack(kernel(tail=True), True),
        "full (no docs)": lambda: full(False),
        "full (+docs)": lambda: full(True),
    }


def run(device="cuda", *, corpus_mb: float = 64.0, seed: int = 0,
        dix=None) -> dict:
    """The stages on `device` (CUDA unless "cpu", where the plain versions
    run and nothing is timed) over `dix`, or over a `corpus_mb` MB
    synthetic index of `seed` built here. The last prefix's pages,
    ranks, counts and hits are held equal to the row-1 kernel's with the
    top-k tail, and to the bucket's plain route."""
    dev = bc.device_of(device)
    if dix is None:
        dix = bc.synthetic_index(corpus_mb, seed, dev)
    tq, rq = bc.cap_bucket(dix, cap=CAP, hit=HIT_CAP)
    fns = stages(dix, tq, rq)
    out = {"device": str(dev), "rows": tq.shape[0], "stages": {}}
    prev = None
    for name, fn in fns.items():
        t = bc.timings(dev, fn)
        if t["ms"] is not None:
            t["delta_ms"] = t["ms"] - (prev["ms"] if prev else 0.0)
            t["delta_profiler_ms"] = t["profiler_ms"] - (
                prev["profiler_ms"] if prev else 0.0)
            prev = t
        out["stages"][name] = t
    got = fns["full (no docs)"]()
    top = fns["+top-k"]()
    plain = di.query_step_full(
        dix.term_offsets, dix.coords, dix.bounds, dix.page_doc, dix.is_header,
        tq, rq, cap=CAP, topk=FULL_TOPK, hit_cap=HIT_CAP, with_docs=False,
        small=dix.small)
    for field, k in (("pages", 0), ("counts", 2), ("n_pages", 3),
                     ("n_hits", 4), ("hits", 5)):
        if not torch.equal(getattr(got, field), top[k]):
            raise AssertionError(f"the bucket's {field} differ from the "
                                 f"row-1 kernel's")
        if not torch.equal(getattr(got, field), getattr(plain, field)):
            raise AssertionError(f"the bucket's {field} differ from the "
                                 f"plain route's")
    out["ranks_max_abs_err"] = float((got.ranks - plain.ranks).abs().max())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus-mb", type=float, default=64.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(args.device, corpus_mb=args.corpus_mb)
    print(f"bucket cap {CAP} W=2 hit {HIT_CAP}: {res['rows']} rows")
    for name, t in res["stages"].items():
        if t["ms"] is None:
            print(f"{name:16s} not measured")
        else:
            print(f"{name:16s} {t['ms']:7.3f} ms ({t['delta_ms']:+7.3f}); "
                  f"profiler {t['profiler_ms']:.3f} ms "
                  f"({t['delta_profiler_ms']:+.3f})")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
