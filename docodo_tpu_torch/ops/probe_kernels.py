"""The probe kernels (csrc/probes.cu): the counterparts of the TPU kernels
the JAX package keeps in benchmarks/, each with its plain PyTorch version
beside it.

  probe_locate  benchmarks/probe_locate.py, mk_kernel's kern (:129-130,
                pallas_call :95): row 1's slot body over an already
                merged (coord, tag) stream, its page locate one of
                POLICIES
  row_gather    benchmarks/probe_dma_fetch.py fetch_kernel (:80,
                pallas_call :114): table rows by id, copied whole or
                summed to 128 lanes

probe_locate's kernel gives a row of n <= 128 lanes one warp (n / 128
warps past that), four lanes a thread in registers; row_gather's is a
persistent grid, each block with a contiguous share of the ids and a
ring of at most q row slots in GATHER_SMEM bytes (a row of up to
GATHER_SMEM bytes) fed by bulk copies (csrc/probes.cu says how and
why).

A wrapper launches its kernel for CUDA tensors and takes the plain
version for CPU tensors only; any other device raises. The plain
versions run on any device, so a run on the card can hold each kernel
against its plain version on the same inputs.
"""

from __future__ import annotations

import torch

from docodo_tpu_torch.ops import _cuda
from docodo_tpu_torch.ops.query_kernels import _and_keep_plain, _on_device
from docodo_tpu_torch.ops.seqops import INF32, page_runs, run_starts

# the page locates probe_locate takes, in the kernel's policy numbering:
# a binary search of the bounds (production), v // page_len (exact only on
# pages of one length), and a search of every PAGE_BLOCK-th bound, then of
# the block it names
POLICIES = ("bounds", "arith", "two_level")
PAGE_BLOCK = 128
MAX_TWO_LEVEL_PAGES = 1024 * PAGE_BLOCK  # csrc kMaxCoarse blocks staged
MAX_LANES = 1024
GATHER_MODES = ("copy", "sum128")
GATHER_Q = (32, 64, 128)
GATHER_SMEM = 96 * 1024  # csrc kGatherSmem: the ring's bytes, past one slot


# ---------------------------------------------------------------------------
# probe_locate
# ---------------------------------------------------------------------------

def _two_level_pages(vals, bounds):
    """#bounds <= v clamped to the last page, found as the kernel finds
    it: the last bound of every PAGE_BLOCK-bound block names the block,
    then a binary search inside it (8 halvings of at most 128 bounds)."""
    p = bounds.numel()
    blocks = (p + PAGE_BLOCK - 1) // PAGE_BLOCK
    last = (torch.arange(blocks, device=bounds.device) * PAGE_BLOCK
            + PAGE_BLOCK - 1).clamp_max(p - 1)
    c = torch.searchsorted(bounds[last], vals, right=True)
    lo = c * PAGE_BLOCK
    hi = torch.minimum(lo + PAGE_BLOCK, torch.full_like(lo, p))
    hi = torch.where(c < blocks, hi, lo)
    for _ in range(8):
        live = lo < hi
        mid = (lo + hi) // 2
        le = bounds[mid.clamp_max(p - 1)] <= vals
        lo = torch.where(live & le, mid + 1, lo)
        hi = torch.where(live & ~le, mid, hi)
    page = torch.where(c < blocks, lo, p - 1)
    return page.clamp_max(p - 1).to(torch.int32)


def lane_pages(vals, bounds, policy: str, page_len: int):
    """Every lane's page under a POLICIES locate; INF32 lanes land on the
    last page under each."""
    p = bounds.numel()
    if policy == "bounds":
        pg = torch.searchsorted(bounds, vals, right=True)
        return pg.clamp_max(p - 1).to(torch.int32)
    if policy == "arith":
        return (vals // page_len).clamp_max(p - 1).to(torch.int32)
    if policy == "two_level":
        return _two_level_pages(vals, bounds)
    raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")


def _probe_plain(vals, tag, ra, rb, bounds, policy, page_len):
    """Plain version of docodo_probe_locate: the lanes' pages, the plain
    AND keep over the merged stream, every page run's rank and count
    written at its first lane."""
    page = lane_pages(vals, bounds, policy, page_len)
    keep = _and_keep_plain(vals, tag, ra, rb) < INF32
    first, _ = run_starts(vals, keep, page)
    _, rk, ct, n_pages = page_runs(vals, keep, page, vals.shape[1])
    run = (torch.cumsum(first, dim=1) - 1).clamp_min(0)
    rank = torch.where(first, torch.gather(rk, 1, run), 0.0)
    cnt = torch.where(first, torch.gather(ct, 1, run).to(torch.float32), 0.0)
    return (page, rank, cnt, n_pages, keep.sum(dim=1, dtype=torch.int32),
            torch.where(keep, vals, INF32))


def _probe_kernel(vals, tag, ra, rb, bounds, policy, page_len):
    rows, n = vals.shape
    p = bounds.numel()
    _cuda.check(vals, "vals", torch.int32, (rows, n))
    _cuda.check(tag, "tag", torch.int32, (rows, n))
    _cuda.check(ra, "ra", torch.int32, (rows,))
    _cuda.check(rb, "rb", torch.int32, (rows,))
    _cuda.check(bounds, "bounds", torch.int32, (p,))
    dev = vals.device
    outs = (torch.empty((rows, n), dtype=torch.int32, device=dev),
            torch.empty((rows, n), dtype=torch.float32, device=dev),
            torch.empty((rows, n), dtype=torch.float32, device=dev),
            torch.empty((rows,), dtype=torch.int32, device=dev),
            torch.empty((rows,), dtype=torch.int32, device=dev),
            torch.empty((rows, n), dtype=torch.int32, device=dev))
    if rows:  # no rows, no launch
        _cuda.PROBE_LOCATE.launch(dev, vals, tag, ra, rb, bounds, p,
                                  page_len, POLICIES.index(policy), rows, n,
                                  *outs)
    return outs


def _probe_args(vals, bounds, policy, page_len):
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    if not 0 < vals.shape[1] <= MAX_LANES:
        raise ValueError(f"rows of 1-{MAX_LANES} lanes, got {vals.shape[1]}")
    if bounds.numel() == 0:
        raise ValueError("no page bounds")
    if policy == "arith" and page_len <= 0:
        raise ValueError(f"page_len must be positive, got {page_len}")
    if policy == "two_level" and bounds.numel() > MAX_TWO_LEVEL_PAGES:
        raise ValueError(f"two_level takes at most {MAX_TWO_LEVEL_PAGES} "
                         f"pages, got {bounds.numel()}")


def probe_locate(vals, tag, ra, rb, bounds, *, policy: str = "bounds",
                 page_len: int = 3000):
    """Row 1's slot body over merged streams vals [B, n] (ascending, INF32
    padding) and tag [B, n] (0 word A, 1 word B, 2 padding), windows
    ra / rb [B], page bounds [P] (all int32), with its page locate
    `policy` (POLICIES; page_len for "arith"). Returns (page int32
    [B, n] every lane's, rank f32 [B, n] and cnt f32 [B, n] at each
    page run's first kept lane and 0 elsewhere, npages int32 [B], nhits
    int32 [B], hits int32 [B, n]: the kept values, INF32 elsewhere)."""
    _probe_args(vals, bounds, policy, page_len)
    return _on_device(_probe_kernel, _probe_plain, vals, tag, ra, rb, bounds,
                      policy, page_len)


def probe_locate_plain(vals, tag, ra, rb, bounds, *, policy: str = "bounds",
                       page_len: int = 3000):
    """probe_locate through its plain version, on any device."""
    _probe_args(vals, bounds, policy, page_len)
    return _probe_plain(vals, tag, ra, rb, bounds, policy, page_len)


# ---------------------------------------------------------------------------
# row_gather
# ---------------------------------------------------------------------------

def _gather_plain(tab, ids, mode, q):
    """Plain version of docodo_row_gather: tab[ids], or each row summed
    over its 128-lane chunks (int32, wrapping)."""
    rows = tab[ids.long()]
    if mode == "copy":
        return rows
    return rows.reshape(ids.shape[0], tab.shape[1] // 128, 128).sum(
        dim=1).to(torch.int32)


def _gather_kernel(tab, ids, mode, q):
    """Launch docodo_row_gather; the ids must lie in [0, R)."""
    r, n = tab.shape
    _cuda.check(tab, "tab", torch.int32, (r, n))
    _cuda.check(ids, "ids", torch.int32, (ids.shape[0],))
    width = n if mode == "copy" else 128
    out = torch.empty((ids.shape[0], width), dtype=torch.int32,
                      device=tab.device)
    if ids.shape[0]:  # no ids, no launch
        _cuda.ROW_GATHER.launch(tab.device, tab, ids, n, ids.shape[0], q,
                                GATHER_MODES.index(mode), out)
    return out


def _gather_args(tab, ids, mode, q):
    if mode not in GATHER_MODES:
        raise ValueError(f"mode must be one of {GATHER_MODES}, got {mode!r}")
    if q not in GATHER_Q:
        raise ValueError(f"q must be one of {GATHER_Q}, got {q}")
    if tab.dim() != 2 or ids.dim() != 1:
        raise ValueError("a table [R, n] and ids [B]")
    n = tab.shape[1]
    if n % (4 if mode == "copy" else 128) or not 0 < 4 * n <= GATHER_SMEM:
        raise ValueError(f"rows of {n} lanes: {mode} takes a multiple of "
                         f"{4 if mode == 'copy' else 128} up to "
                         f"{GATHER_SMEM // 4}")


def _check_ids(tab, ids):
    if ids.numel():
        lo, hi = torch.aminmax(ids)
        if int(lo) < 0 or int(hi) >= tab.shape[0]:
            raise ValueError(f"ids outside [0, {tab.shape[0]})")


def row_gather(tab, ids, *, mode: str = "copy", q: int = 32):
    """Rows tab[ids] of an int32 table [R, n] for ids int32 [B] in
    [0, R): [B, n] (mode "copy"), or [B, 128] with out[b, l] = the sum
    over k of tab[ids[b], 128 k + l] (mode "sum128", int32 wrapping). On
    the card q (GATHER_Q) is the most rows a block of the kernel keeps in
    flight, its ring's depth. The ids are checked on the host first (one
    synchronisation)."""
    _gather_args(tab, ids, mode, q)
    _check_ids(tab, ids)
    return _on_device(_gather_kernel, _gather_plain, tab, ids, mode, q)


def row_gather_plain(tab, ids, *, mode: str = "copy", q: int = 32):
    """row_gather through its plain version, on any device."""
    _gather_args(tab, ids, mode, q)
    _check_ids(tab, ids)
    return _gather_plain(tab, ids, mode, q)

