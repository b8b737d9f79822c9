"""Probe: what share of row 1's slot body is its page locate, and does a
two-level locate beat the binary search of every bound? The counterpart
of benchmarks/probe_locate.py on the card.

The three page locates of docodo_probe_locate (ops/probe_kernels.py
POLICIES), each over the same merged (coord, tag) streams:

  bounds     the binary search of the bounds, the port's production
             locate (page_of_coord)
  arith      min(v // page_len, P - 1): exact on pages of one length, a
             lower bound on the locate's cost otherwise
  two_level  a search of every 128th bound (staged in shared memory),
             then of the 128 bounds of the block it names

first at the TPU probe's shape (B = 5952 rows of cap 64, n = 128 lanes,
P = 578 pages of 3000 characters, seeded streams as the original makes
them), then on the real page table and the standard mix's cap-64 W = 2
hit-128 bucket of the 64 MB synthetic index (seed 0). Each policy's ms
(CUDA events, median of 10; and torch.profiler's device ms), its device
time over `bounds`' (share; 1 - arith's share is the locate's share of
row 1's body), the rows whose outputs differ from `bounds`' (two_level
must have none; arith has none on uniform pages), and each kernel's
largest difference from its plain version.

    python -m docodo_tpu_torch.benchmarks.probe_locate [--corpus-mb 64]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from docodo_tpu_torch.benchmarks import common as bc
from docodo_tpu_torch.ops import probe_kernels as pk
from docodo_tpu_torch.ops.seqops import INF32, sort_tagged

ROWS, CAP, PAGES, PAGE_LEN = 5952, 64, 578, 3000


def probe_streams(rng, rows: int, cap: int, corpus_len: int, dev):
    """The TPU probe's streams (probe_locate.py:46-56): each row 8 to
    2 cap - 1 ascending coordinates drawn over the corpus, word tags at
    random, INF32 / tag 2 after them; windows of 10."""
    n = 2 * cap
    lens = rng.integers(8, n, size=rows)
    vals = np.full((rows, n), INF32, dtype=np.int32)
    tag = np.full((rows, n), 2, dtype=np.int32)
    for i in range(rows):
        m = lens[i]
        vals[i, :m] = np.sort(rng.integers(0, corpus_len, size=m))
        tag[i, :m] = rng.integers(0, 2, size=m)
    ra = np.full(rows, 10, dtype=np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (vals, tag, ra, ra))


def bucket_streams(dix, cap: int = CAP):
    """The cap-64 W = 2 hit-128 bucket of the standard mix on `dix`, its
    two words' postings merged into one (coord, tag) stream a row."""
    from docodo_tpu_torch.ops.device_index import gather_term

    tq, rq = bc.cap_bucket(dix, cap=cap)
    a, _ = gather_term(dix.coords, dix.term_offsets, tq[:, 0], cap)
    b, _ = gather_term(dix.coords, dix.term_offsets, tq[:, 1], cap)
    vals = torch.cat([a, b], dim=1)
    tag = torch.cat([torch.where(a < INF32, 0, 2),
                     torch.where(b < INF32, 1, 2)], dim=1).to(torch.int32)
    vals, tag, _ = sort_tagged(vals, tag)
    return (vals.contiguous(), tag.contiguous(), rq[:, 0].contiguous(),
            rq[:, 1].contiguous())


def locate_bound(vals, bounds) -> dict:
    """Bytes: the streams and windows read once, the four [B, n] outputs
    and two [B] counts written once, the bounds read once; operations:
    a row body's per lane and a search of the bounds a lane."""
    rows, n = vals.shape
    nbytes = 8 * rows * n + 8 * rows + 4 * bounds.numel() + 16 * rows * n \
        + 8 * rows
    steps = int(np.ceil(np.log2(bounds.numel() + 1)))
    return bc.bound(nbytes,
                    rows * n * (bc.OPS_PER_LANE + bc.OPS_PER_STEP * steps))


def _differs(got, want) -> np.ndarray:
    """Rows on which any output of `got` differs from `want`'s."""
    bad = torch.zeros(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    for g, w in zip(got, want):
        d = g != w
        bad |= d if d.dim() == 1 else d.any(dim=1)
    return bad


def run_shape(label: str, streams, bounds, dev, page_len: int = PAGE_LEN):
    """The three policies on one set of streams: outputs against
    `bounds`' and against each kernel's plain version, and times."""
    vals, tag, ra, rb = streams
    out = {"shape": label, "rows": vals.shape[0], "lanes": vals.shape[1],
           "pages": bounds.numel(), **locate_bound(vals, bounds)}
    base = None
    for policy in pk.POLICIES:
        def call(policy=policy):
            return pk.probe_locate(vals, tag, ra, rb, bounds, policy=policy,
                                   page_len=page_len)
        got = call()
        plain = pk.probe_locate_plain(vals, tag, ra, rb, bounds,
                                      policy=policy, page_len=page_len)
        if base is None:
            base = got
        differs = _differs(got, base)
        out[policy] = {
            **bc.timings(dev, call),
            "max_abs_err": bc.max_abs_err(got, plain),
            "mismatch_rows": int(differs.sum()),
            "page_lanes_differ": int((got[0] != base[0]).sum()),
            "nhits": int(got[4].sum()), "npages": int(got[3].sum()),
        }
    if dev.type == "cuda":
        # on the profiler's device clock: a call's CUDA-event time is
        # mostly the host's launch (outputs allocated, arguments checked)
        dev_ms = {p: out[p]["profiler_ms"] for p in pk.POLICIES}
        for policy in pk.POLICIES:
            out[policy]["share"] = dev_ms[policy] / dev_ms["bounds"]
        out["locate_share"] = 1.0 - dev_ms["arith"] / dev_ms["bounds"]
        out["plain_ms"] = bc.timings(dev, lambda: pk.probe_locate_plain(
            vals, tag, ra, rb, bounds, policy="bounds"))["ms"]
    return out


def run(device="cuda", *, rows: int = ROWS, cap: int = CAP,
        pages: int = PAGES, corpus_mb: float = 64.0, seed: int = 0,
        dix=None) -> dict:
    """Both shapes of the probe on `device` (CUDA unless "cpu", where the
    plain versions run and nothing is timed): the TPU probe's seeded
    streams over `pages` uniform pages, then the cap-`cap` W = 2 bucket
    of `dix` (or of a `corpus_mb` MB synthetic index of `seed` built
    here) over its real page table. Returns {"probe": ..., "index": ...},
    each with a policy's results under its name."""
    dev = bc.device_of(device)
    rng = np.random.default_rng(0)
    bounds = torch.arange(1, pages + 1, dtype=torch.int32,
                          device=dev) * PAGE_LEN
    probe = run_shape(f"probe B={rows} n={2 * cap} P={pages}",
                      probe_streams(rng, rows, cap, pages * PAGE_LEN, dev),
                      bounds, dev)
    if dix is None:
        dix = bc.synthetic_index(corpus_mb, seed, dev)
    streams = bucket_streams(dix, cap)
    index = run_shape(f"index cap {cap} W=2 hit 128 bucket, "
                      f"B={streams[0].shape[0]}", streams, dix.bounds, dev)
    for res in (probe, index):
        if res["two_level"]["mismatch_rows"]:
            raise AssertionError(f"{res['shape']}: two_level differs from "
                                 f"bounds on {res['two_level']['mismatch_rows']}"
                                 f" rows")
        for policy in pk.POLICIES:
            if res[policy]["max_abs_err"]:
                raise AssertionError(f"{res['shape']}: {policy} differs from "
                                     f"its plain version")
    if probe["arith"]["mismatch_rows"]:
        raise AssertionError("arith differs from bounds on uniform pages")
    return {"device": str(dev), "probe": probe, "index": index}


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus-mb", type=float, default=64.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = run(args.device, corpus_mb=args.corpus_mb)
    for key in ("probe", "index"):
        r = res[key]
        print(f"{r['shape']}: bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']}); the locate's share of the body "
              f"{r.get('locate_share', 'not measured')}")
        for policy in pk.POLICIES:
            p = r[policy]
            print(f"  {policy:10s} {_ms(p['ms'])} (profiler "
                  f"{_ms(p['profiler_ms'])}), device time over bounds' "
                  f"{p.get('share', 'not measured')}, rows differing from "
                  f"bounds {p['mismatch_rows']}, kernel vs plain "
                  f"{p['max_abs_err']}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
