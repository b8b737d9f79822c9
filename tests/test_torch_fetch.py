"""The posting fetch of the kernel buckets (query_kernels.fetch_postings,
csrc/fetch.cu docodo_fetch_postings) against its plain version
(seqops.gather_term / gather_term_paged) and a numpy slice of the
CSR.

CPU cases: the wrapper takes the plain gather for CPU tensors, and its
outputs are the CSR's spans padded with INF32, equal to the plain gather
with and without the small tables, over caps 64 to 2^16, terms of -1,
empty lists and lists longer than the cap, [B] and strided [B, V] terms;
the two counters count the rows each version fetched. Cases marked
`cuda` hold the kernel bit for bit against the plain version on the card
(caps 64 to 2^21, unaligned starts and bases, with and without pages,
caps that are not a multiple of 4, more rows than one grid dimension
holds) and count its launches on the chunked route. The module imports
no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_fetch.py -q

Tolerance: exact (integer copies)."""

import functools

import numpy as np
import pytest
import torch

from docodo_tpu_torch.ops import _cuda
from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.utils import profiling

INF32 = 2**31 - 1
V = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@functools.cache
def _csr(cap: int):
    """A CSR whose lists are 0-7 postings, about cap / 2, cap - 1, cap,
    cap + 1 and 2 cap + 3 long, and a few random lengths (so list starts
    fall on every residue mod 4); coords ascending, pages coord // 997.
    Returns (offsets int32 [T+1], coords, pages, counts)."""
    rng = np.random.default_rng(cap)
    counts = np.array([0, 1, 2, 3, 5, 7, 0, cap // 2 + 1, cap - 1, cap,
                       cap + 1, 2 * cap + 3, 6]
                      + list(rng.integers(0, cap + 2, 6)), dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    coords = np.cumsum(rng.integers(1, 40, int(offsets[-1]))).astype(np.int32)
    return offsets, coords, (coords // 997).astype(np.int32), counts


def _terms(counts, cap: int, shape: str, short_only: bool):
    """Every term id (those with count <= cap with `short_only`) and -1s,
    shuffled: [B] int32, or [B, V] as the strided slice [:, 1] of a
    [B, 2, V] tensor."""
    ids = np.flatnonzero(counts <= cap) if short_only else np.arange(
        counts.size)
    ids = np.concatenate([ids, [-1, -1, -1]]).astype(np.int32)
    ids = np.random.default_rng(7).permutation(ids)
    if shape == "B":
        return torch.from_numpy(ids)
    pad = -len(ids) % V
    ids = np.concatenate([ids, np.full(pad, -1, np.int32)]).reshape(-1, V)
    both = np.stack([np.full_like(ids, -1), ids], axis=1)
    return torch.from_numpy(both)[:, 1]


def _want(offsets, arr, terms, cap: int):
    """The numpy fetch: each term's first min(count, cap) entries of arr,
    INF32 after; lengths 0 for -1."""
    flat = terms.reshape(-1).numpy()
    out = np.full((flat.size, cap), INF32, np.int32)
    ln = np.zeros(flat.size, np.int32)
    for r, t in enumerate(flat):
        if t >= 0:
            n = min(int(offsets[t + 1] - offsets[t]), cap)
            out[r, :n] = arr[offsets[t]: offsets[t] + n]
            ln[r] = n
    return out, ln


def _small(offsets, coords, pages, paged: bool):
    tabs = tdi.build_small_tables(offsets.astype(np.int64), coords,
                                  pages_np=pages if paged else None)
    return tuple(st.to("cpu") for st in tabs)


def _deltas(before: dict) -> tuple:
    now = profiling.counters()
    return tuple(now.get(k, 0) - before.get(k, 0)
                 for k in ("fetch.kernel_rows", "fetch.plain_rows"))


@pytest.mark.parametrize("shape", ["B", "BV"])
@pytest.mark.parametrize("with_small", [False, True],
                         ids=["csr", "small"])
@pytest.mark.parametrize("paged", [False, True], ids=["coords", "pages"])
@pytest.mark.parametrize("cap", [64, 128, 512, 4096, 1 << 16])
def test_fetch_equals_the_csr_spans_on_the_cpu(cap, paged, with_small,
                                               shape):
    """fetch_postings on CPU tensors: the plain gather (no launch, the
    plain counter), equal to gather_term / gather_term_paged and to the
    CSR's spans. With the small tables only terms of count <= cap are
    asked (their contract), and the plain gather over the tables' rows
    gives the same spans."""
    offsets, coords, pages, counts = _csr(cap)
    terms = _terms(counts, cap, shape, with_small)
    small = _small(offsets, coords, pages, paged) if with_small else None
    if with_small and cap <= tdi.SMALL_TAB_BAND_MAX:
        assert tdi.fetch_tables(small, cap) is not None
    off_t, co_t, pg_t = map(torch.from_numpy, (offsets, coords, pages))
    launched = _cuda.FETCH.launches
    before = profiling.counters()
    vals, pgs, ln = qk.fetch_postings(co_t, off_t, terms, cap,
                                      page_of=pg_t if paged else None)
    rows = terms.numel()
    assert _cuda.FETCH.launches == launched
    assert _deltas(before) == (0, rows)
    want, want_ln = _want(offsets, coords, terms, cap)
    np.testing.assert_array_equal(vals.numpy(), want)
    np.testing.assert_array_equal(ln.numpy(), want_ln)
    assert (ln.numpy() == cap).any() and (ln.numpy() == 0).any()
    flat = terms.reshape(-1)
    if paged:
        np.testing.assert_array_equal(
            pgs.numpy(), _want(offsets, pages, terms, cap)[0])
        ref = tdi.gather_term_paged(co_t, pg_t, off_t, flat, cap, small)
        got = (vals, pgs, ln)
    else:
        assert pgs is None
        ref = tdi.gather_term(co_t, off_t, flat, cap, small)
        got = (vals, ln)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("carried", [False, True])
def test_fetcher_keeps_the_bucket_shapes(carried):
    """_fetcher over [B] and [B, V] terms (the [B, W, V] bucket's word
    slice): vals and pages [B, (V,) cap], lengths [B, (V)], pages only
    when carried, and the rows counted once each."""
    cap = 512
    offsets, coords, pages, counts = _csr(cap)
    off_t, co_t, pg_t = map(torch.from_numpy, (offsets, coords, pages))
    fetch = tdi._fetcher(co_t, off_t, pg_t, cap, carried)
    for shape in ("B", "BV"):
        terms = _terms(counts, cap, shape, False)
        before = profiling.counters()
        vals, pgs, ln = fetch(terms)
        assert _deltas(before) == (0, terms.numel())
        assert vals.shape == tuple(terms.shape) + (cap,)
        assert ln.shape == tuple(terms.shape)
        assert (pgs is not None) == carried
        want, want_ln = _want(offsets, coords, terms, cap)
        np.testing.assert_array_equal(vals.reshape(-1, cap).numpy(), want)
        np.testing.assert_array_equal(ln.reshape(-1).numpy(), want_ln)
        if carried:
            assert pgs.shape == vals.shape
            np.testing.assert_array_equal(
                pgs.reshape(-1, cap).numpy(),
                _want(offsets, pages, terms, cap)[0])


def test_fetch_counters_add_the_rows_of_each_version(monkeypatch):
    """fetch.plain_rows adds each CPU call's rows and fetch.kernel_rows
    none. The kernel's wrapper, its launch replaced by a recorder (its
    tensor checks off, so it runs on CPU tensors), adds to
    fetch.kernel_rows alone and hands the kernel B V rows of V ids, the
    strided terms' own strides and the cap."""
    cap = 64
    offsets, coords, pages, counts = _csr(cap)
    off_t, co_t, pg_t = map(torch.from_numpy, (offsets, coords, pages))
    terms = _terms(counts, cap, "BV", False)
    before = profiling.counters()
    qk.fetch_postings(co_t, off_t, terms, cap)
    qk.fetch_postings(co_t, off_t, terms[:3], cap, page_of=pg_t)
    assert _deltas(before) == (0, terms.numel() + 3 * V)

    class Recorder:
        launches = []

        def launch(self, dev, *args):
            self.launches.append(args)

    monkeypatch.setattr(_cuda, "check", lambda *a: None)
    monkeypatch.setattr(_cuda, "FETCH", Recorder())
    before = profiling.counters()
    vals, pgs, ln = qk._fetch_kernel(co_t, off_t, terms, cap, pg_t)
    monkeypatch.undo()
    assert _deltas(before) == (terms.numel(), 0)
    (args,) = Recorder.launches
    assert args[0] is co_t and args[1] is pg_t and args[2] is off_t
    assert args[3].data_ptr() == terms.data_ptr()
    assert args[4:9] == (terms.numel(), V, 2 * V, 1, cap)
    assert args[9] is vals and args[10] is pgs and args[11] is ln
    assert vals.shape == pgs.shape == (terms.numel(), cap)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _on_card(dev, arr, shift: int):
    """arr on the card as a view `shift` int32 past a 16-byte aligned
    allocation, so the kernel sees unaligned bases too."""
    buf = torch.empty(arr.size + shift, dtype=torch.int32, device=dev)
    view = buf[shift:]
    view.copy_(torch.from_numpy(arr))
    return view


def _held(dev, cap, terms, paged, shift=0, small=None):
    """The kernel's and the plain version's outputs on the card, equal
    bit for bit; the kernel launched once and counted its rows. With
    `small`, the plain version is gather_term(_paged) over the tables."""
    offsets, coords, pages, _ = _csr(cap)
    off_t = torch.from_numpy(offsets).to(dev)
    co_t = _on_card(dev, coords, shift)
    pg_t = _on_card(dev, pages, shift) if paged else None
    terms = terms.to(dev)
    launched = _cuda.FETCH.launches
    before = profiling.counters()
    got = qk.fetch_postings(co_t, off_t, terms, cap, page_of=pg_t)
    torch.cuda.synchronize()
    assert _cuda.FETCH.launches == launched + 1
    assert _deltas(before) == (terms.numel(), 0)
    flat = terms.reshape(-1)
    if small is None:
        want = qk._fetch_plain(co_t, off_t, terms, cap, pg_t)
    elif paged:
        want = tdi.gather_term_paged(co_t, pg_t, off_t, flat, cap, small)
    else:
        vals, ln = tdi.gather_term(co_t, off_t, flat, cap, small)
        want = (vals, None, ln)
    assert got[0].shape == (terms.numel(), cap)
    assert (got[1] is None) == (not paged)
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("paged", [False, True], ids=["coords", "pages"])
@pytest.mark.parametrize("cap", [64, 128, 1024, 4096, 1 << 16, 1 << 21])
def test_fetch_kernel_is_the_plain_gather(cuda_device, cap, paged, shift):
    """Caps 64 to 2^21 over lists of every length class, starts on every
    residue mod 4 and bases shifted off 16 bytes, [B] and strided [B, V]
    terms, with and without pages."""
    counts = _csr(cap)[3]
    for shape in ("B", "BV"):
        _held(cuda_device, cap, _terms(counts, cap, shape, False), paged,
              shift)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["coords", "pages"])
@pytest.mark.parametrize("cap", [64, 128, 1024, 4096])
def test_fetch_kernel_is_the_table_route(cuda_device, cap, paged):
    """Where the small tables serve the cap, the plain version reads their
    rows and the kernel the CSR: the same outputs."""
    offsets, coords, pages, counts = _csr(cap)
    small = tuple(st.to(cuda_device) for st in tdi.build_small_tables(
        offsets.astype(np.int64), coords, pages_np=pages if paged else None))
    assert tdi.fetch_tables(small, cap) is not None
    _held(cuda_device, cap, _terms(counts, cap, "BV", True), paged,
          small=small)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["coords", "pages"])
@pytest.mark.parametrize("cap", [1, 36, 100, 1000, 1030, 2052])
def test_fetch_kernel_at_caps_off_the_vector_width(cuda_device, cap, paged):
    """Caps that are not a multiple of 4 (4-byte loads and stores) or of a
    task's 1024 lanes (a part-filled last task), and an empty batch."""
    counts = _csr(cap)[3]
    _held(cuda_device, cap, _terms(counts, cap, "B", False), paged, 1)
    vals, _, ln = _held(cuda_device, cap,
                        torch.zeros((0,), dtype=torch.int32), paged)
    assert vals.shape == (0, cap) and ln.shape == (0,)


@pytest.mark.cuda
def test_fetch_kernel_past_one_grid_dimension(cuda_device):
    """70,000 rows (more than a grid's y or z dimension holds) of strided
    [B, V] terms at cap 64, with pages."""
    cap = 64
    counts = _csr(cap)[3]
    ids = np.random.default_rng(3).integers(-1, counts.size, (17_500, 2, V))
    terms = torch.from_numpy(ids.astype(np.int32))[:, 1]
    vals, pgs, ln = _held(cuda_device, cap, terms, True, 2)
    assert vals.shape == (70_000, cap) and int(ln.max()) == cap


@pytest.mark.cuda
def test_fetch_kernel_launches_once_a_fetch_on_the_chunked_route(
        cuda_device, monkeypatch):
    """A W = 2 bucket past slot admission through _chunked_bucket_full:
    one fetch launch for each word, every row counted as the kernel's, and
    the bucket's outputs equal to the same route with the plain fetch."""
    from docodo_tpu_torch.synthetic import build_index, zipf_documents

    dix = tdi.DeviceIndex.from_index(
        build_index(zipf_documents(2_000_000, seed=3), device="cpu"),
        device=cuda_device)
    counts = np.diff(dix.offsets_np)
    ids = np.flatnonzero((counts > 600) & (counts <= 1024))[:16]
    assert ids.size >= 4
    tq = torch.from_numpy(np.stack([ids, ids[::-1]], axis=1).astype(
        np.int32)).to(cuda_device)
    rq = torch.full(tq.shape, 8, dtype=torch.int32, device=cuda_device)
    kw = dict(cap=1024, topk=16, hit_cap=256, small=dix.small,
              page_of=dix.page_of, tail=True)
    args = (dix.term_offsets, dix.coords, dix.bounds, tq, rq)
    launched = _cuda.FETCH.launches
    before = profiling.counters()
    got = tdi._chunked_bucket_full(*args, **kw)
    torch.cuda.synchronize()
    assert _cuda.FETCH.launches == launched + 2
    assert _deltas(before) == (2 * ids.size, 0)
    monkeypatch.setattr(qk, "_fetch_kernel", qk._fetch_plain)
    want = tdi._chunked_bucket_full(*args, **kw)
    assert _cuda.FETCH.launches == launched + 2
    for name in ("pages", "ranks", "counts", "n_pages", "n_hits", "hits"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(got.n_hits.max()) > 0
