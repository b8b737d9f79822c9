"""Probe: can a kernel that copies each table row on its own (a bulk copy
a row into shared memory, completed on an mbarrier) beat PyTorch's row
gather? The counterpart of benchmarks/probe_dma_fetch.py on the card.

At the TPU probe's shape (R = 16384 rows of n = 2048 int32, B = 10,000
row ids drawn with seed 5, q = 32 rows in flight a block at most), six
legs, each held equal to tab[ids]:

  index_select   torch.index_select(tab, 0, ids), the library's gather
  tab[ids]       advanced indexing
  gather_term    the plain posting fetch (ops/device_index.py) of the
                 same rows as lists of n postings
  fetch_postings the port's posting fetch (ops/query_kernels.py, one
                 docodo_fetch_postings launch) of the same lists
  kernel copy    docodo_row_gather, mode copy (also at q = 64 and 128)
  kernel sum128  docodo_row_gather, each row summed over its 128-lane
                 chunks, held equal to that formula (also at q = 64 and
                 128)

Each leg's ms (CUDA events, median of 10; torch.profiler's device ms),
GB/s of rows read, and the bytes bound at 3.35 TB/s.

    python -m docodo_tpu_torch.benchmarks.probe_dma_fetch
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from docodo_tpu_torch.benchmarks import common as bc
from docodo_tpu_torch.ops import _cuda
from docodo_tpu_torch.ops import probe_kernels as pk
from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.ops.device_index import gather_term

R, N, B, Q = 16384, 2048, 10_000, 32


def gather_bound(ids, n: int, mode: str) -> dict:
    """The ids and each distinct row read once (a repeated id reads its
    row again from L2, not from device memory), the output written
    once."""
    rows = ids.numel()
    distinct = ids.unique().numel()
    out = rows * (n if mode == "copy" else 128) * 4
    return bc.bound(4 * rows + distinct * n * 4 + out)


def _check(name: str, got, ref) -> float:
    """The largest |got - ref|; raises unless got equals ref."""
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, want "
                             f"{tuple(ref.shape)}")
    err = bc.max_abs_err((got,), (ref,))
    if not torch.equal(got, ref):
        raise AssertionError(f"{name} differs from the row gather (max abs "
                             f"err {err})")
    return err


def run(device="cuda", *, r: int = R, n: int = N, b: int = B,
        q: int = Q, seed: int = 5) -> dict:
    """The six legs on `device` (CUDA unless "cpu", where the plain
    versions run and nothing is timed) at a table of r rows of n lanes
    and b ids. row_gather itself, in both modes at every q, is held
    against its plain version (its largest difference is the result's
    max_abs_err) and must launch its kernel on the card; every leg is
    checked against tab[ids] (sum128 against its formula). A leg that
    differs raises."""
    dev = bc.device_of(device)
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(
        rng.integers(0, 1 << 20, (r, n)).astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, r, b).astype(np.int32)).to(dev)
    ids64 = ids.long()
    want = tab[ids64]
    want_sum = want.reshape(b, n // 128, 128).sum(dim=1).to(torch.int32)
    flat = tab.reshape(-1)
    offsets = torch.arange(r + 1, dtype=torch.int32, device=dev) * n
    plain = {m: pk.row_gather_plain(tab, ids, mode=m)
             for m in pk.GATHER_MODES}
    refs = {"copy": want, "sum128": want_sum}
    for m in pk.GATHER_MODES:
        _check(f"plain {m}", plain[m], refs[m])
    # the wrapper itself, every mode and q, held against the plain
    # version; on the card each call must launch the kernel
    qs = tuple(dict.fromkeys((q,) + pk.GATHER_Q))
    gather = pk.row_gather if dev.type == "cuda" else pk.row_gather_plain
    launched = _cuda.ROW_GATHER.launches
    wrapper_err = {(m, qq): _check(f"row_gather {m} q={qq}",
                                   gather(tab, ids, mode=m, q=qq), plain[m])
                   for m in pk.GATHER_MODES for qq in qs}
    if (dev.type == "cuda"
            and _cuda.ROW_GATHER.launches - launched != len(wrapper_err)):
        raise AssertionError("row_gather did not launch its kernel once a "
                             "call on the card")
    # the legs time the launches alone: the wrapper's host check of the
    # ids stays out of the time
    core = pk._gather_kernel if dev.type == "cuda" else pk._gather_plain
    legs = {
        "index_select": (lambda: torch.index_select(tab, 0, ids64), "copy",
                         None),
        "tab[ids]": (lambda: tab[ids64], "copy", None),
        "gather_term": (lambda: gather_term(flat, offsets, ids, n)[0],
                        "copy", None),
        "fetch_postings": (lambda: qk.fetch_postings(flat, offsets, ids,
                                                     n)[0], "copy", None),
    }
    for m in pk.GATHER_MODES:
        for qq in qs:
            legs[f"kernel {m} q={qq}"] = (
                lambda m=m, qq=qq: core(tab, ids, m, qq), m, qq)
    out = {"device": str(dev), "rows": r, "lanes": n, "ids": b, "q": q,
           "max_abs_err": max(wrapper_err.values())}
    for name, (fn, mode, qq) in legs.items():
        err = _check(name, fn(), refs[mode])
        if qq is not None:
            err = max(err, wrapper_err[mode, qq])
        res = {**bc.timings(dev, fn), **gather_bound(ids, n, mode),
               "max_abs_err": err}
        if res["ms"] is not None:
            res["gb_s"] = b * n * 4 / res["ms"] * 1e-6
        out[name] = res
    for mode in pk.GATHER_MODES:
        out[f"plain_{mode}_ms"] = bc.timings(
            dev, lambda mode=mode: pk._gather_plain(tab, ids, mode, q))["ms"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--q", type=int, default=Q)
    args = ap.parse_args()
    res = run(args.device, q=args.q)
    for name, leg in res.items():
        if isinstance(leg, dict):
            ms = leg["ms"]
            print(f"{name:22s} "
                  + (f"{ms:7.3f} ms ({leg['gb_s']:6.1f} GB/s)"
                     if ms is not None else "not measured")
                  + f"  bound {leg['bound_ms'] * 1e3:.1f} us")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
