"""What the port's probe scripts take from benchmarks/common.py (a copy,
importing nothing of the JAX package): the hit-buffer tiers and the
(posting cap, W, hit tier) bucketing of a query mix, the serving fused
layout. The mixes themselves are docodo_tpu_torch/mix.py's."""

from __future__ import annotations

import numpy as np
import torch

from docodo_tpu_torch.ops.device_index import _bucket, _bucket_sort_key

HIT_TIERS = (128, 512, 1024)


def tier_of(min_need: int, hit_cap: int) -> int:
    """Hit-buffer readback tier from the smallest operand's volume
    (benchmarks/common.py:212)."""
    want = 4 * min_need + 16
    for t in HIT_TIERS:
        if t <= hit_cap and want <= t:
            return t
    return hit_cap


def full_buckets(terms: np.ndarray, rs: np.ndarray, counts: np.ndarray,
                 hit_cap: int, device):
    """Group the mix's rows (terms, rs int32 [N, 2], -1 past a row's
    words) into (posting cap, W, hit tier) buckets in bucket order
    (benchmarks/common.py:221, without its asymmetric caps and wide
    merging, both off by default there). Returns (terms_t, rs_t, caps_t,
    hcaps_t): int32 tensors [B, W] on `device` and ints, a bucket each."""
    buckets: dict = {}
    for i in range(terms.shape[0]):
        w = int((terms[i] >= 0).sum()) or 1
        need = int(counts[terms[i, :w]].max())
        min_need = int(counts[terms[i, :w]].min())
        buckets.setdefault((_bucket(need), w, tier_of(min_need, hit_cap)),
                           []).append(i)
    terms_t, rs_t, caps_t, hcaps_t = [], [], [], []
    for (qcap, w, hb), idxs in sorted(buckets.items(), key=_bucket_sort_key):
        terms_t.append(torch.as_tensor(terms[idxs, :w], device=device))
        rs_t.append(torch.as_tensor(rs[idxs, :w], device=device))
        caps_t.append(qcap)
        hcaps_t.append(hb)
    return tuple(terms_t), tuple(rs_t), tuple(caps_t), tuple(hcaps_t)


# the card's peak rates and the operation counts the bounds take, for
# every script of the port that writes a bound (chip_smoke.py, tools/)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, at 700 W
INT_OPS_PER_S = 67e12      # H100 SXM non-tensor 32-bit rate, at 700 W
OPS_PER_LANE = 32          # integer operations per lane that holds data
OPS_PER_STEP = 4           # integer operations per binary-search step
REPS = 10


def device_of(device) -> torch.device:
    """The probe's device: CUDA unless the caller asks for the CPU, where
    the plain versions run and nothing is timed."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probe runs on a CUDA device, and CUDA is not "
                           "available; pass device=\"cpu\" to run the plain "
                           "versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no probe for device {dev}")
    return dev


def cuda_ms(fn, reps: int = REPS) -> float:
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


def profiled_ms(fn, reps: int = REPS) -> float:
    """Device ms a call of fn(), by torch.profiler: the device events of
    `reps` calls after a warm-up, summed, over reps (a host event carries
    the device time of what it launched, so those are left out)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(float(getattr(e, "self_device_time_total", 0)
                     or getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU) / 1e3 / reps


def timings(dev: torch.device, fn) -> dict:
    """{"ms", "profiler_ms"} of fn() on the card; None on the CPU, where
    nothing is a device time."""
    if dev.type != "cuda":
        return {"ms": None, "profiler_ms": None}
    return {"ms": cuda_ms(fn), "profiler_ms": profiled_ms(fn)}


def max_abs_err(got, want) -> float:
    """The largest |g - w| over paired tensors of `got` and `want`."""
    return max((float((g.double() - w.double()).abs().max()) if g.numel()
                else 0.0 for g, w in zip(got, want)), default=0.0)


def bound(nbytes: int, ops: int = 0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the integer operations over the 32-bit rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def cap_bucket(dix, cap: int = 64, words: int = 2, hit: int = 128,
               n_queries: int = 10_000, hit_cap: int = 1024):
    """The standard mix's (cap, W, hit tier) bucket on a DeviceIndex, as
    benchmarks/profile_cap64.py picks it: (terms int32 [B, W], rs int32
    [B, W]) on the index's device."""
    from docodo_tpu_torch.mix import standard_mix

    counts = np.diff(dix.offsets_np)
    terms, rs = standard_mix(counts, dix.terms, n_queries)
    for t, r, c, h in zip(*full_buckets(terms, rs, counts, hit_cap,
                                        device=dix.device)):
        if c == cap and t.shape[1] == words and h == hit:
            return t, r
    raise ValueError(f"the mix has no (cap {cap}, W {words}, hit {hit}) "
                     f"bucket on this index")


def synthetic_index(corpus_mb: float, seed: int, dev: torch.device):
    """The seeded Zipf corpus of `corpus_mb` MB (synthetic.py), built and
    staged on `dev`."""
    from docodo_tpu_torch.ops.device_index import DeviceIndex
    from docodo_tpu_torch.synthetic import build_index, zipf_documents

    ind = build_index(zipf_documents(int(corpus_mb * 1e6), seed=seed),
                      device=dev)
    return DeviceIndex.from_index(ind, device=dev)
