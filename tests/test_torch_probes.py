"""The port's probe kernels' plain versions against the JAX package's TPU
kernels of benchmarks/ (in Pallas interpret mode on the CPU), the port's
copy of benchmarks/common.full_buckets against the original, and each
probe's run(device="cpu") at a small size.

  probe_locate (PERF.md row 18)  against _sorted_and_locate_full_slots_
      kernel(cap=64, paged=False), whose compare-all page locate the
      three page policies stand in for: bounds and two_level on every
      table, arith on pages of one length (and shown to differ on an
      uneven table)
  row_gather (row 19)  against numpy tab[ids] and the sum formula of
      benchmarks/probe_dma_fetch.py:142, and against that file's
      fetch_kernel (copied here: it is defined inside its main())

Tolerance: exact, but ranks within 2 ulp (torch.log against XLA's log on
the CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks import common as jax_bc
from docodo_tpu.ops import pallas_query as pq
from docodo_tpu_torch.benchmarks import common as bc
from docodo_tpu_torch.benchmarks import (probe_dma_fetch, probe_locate,
                                         profile_cap64)
from docodo_tpu_torch.mix import standard_mix
from docodo_tpu_torch.ops import probe_kernels as pk
from docodo_tpu_torch.synthetic import build_index, zipf_documents

INF32 = 2**31 - 1
CAP = 64


def _jax_locate(vals, tag, ra, rb, bounds, q=8):
    """_sorted_and_locate_full_slots_kernel(cap=64, paged=False) over the
    merged stream, as benchmarks/probe_locate.py calls its kernel: its
    compare-all locate against every bound."""
    rows, n = vals.shape
    kernel = functools.partial(pq._sorted_and_locate_full_slots_kernel,
                               cap=CAP, paged=False)
    row = lambda i: (i, 0)  # noqa: E731
    wide = pl.BlockSpec((q, n), row)
    one = pl.BlockSpec((q, 1), row)
    f = pl.pallas_call(
        kernel, grid=(rows // q,),
        in_specs=[wide, wide, one, one,
                  pl.BlockSpec((1, bounds.size), lambda i: (0, 0))],
        out_specs=[wide, wide, wide, one, one, wide],
        out_shape=[jax.ShapeDtypeStruct((rows, n), jnp.int32),
                   jax.ShapeDtypeStruct((rows, n), jnp.float32),
                   jax.ShapeDtypeStruct((rows, n), jnp.float32),
                   jax.ShapeDtypeStruct((rows, 1), jnp.int32),
                   jax.ShapeDtypeStruct((rows, 1), jnp.int32),
                   jax.ShapeDtypeStruct((rows, n), jnp.int32)],
        interpret=True)
    out = f(jnp.asarray(vals), jnp.asarray(tag), jnp.asarray(ra[:, None]),
            jnp.asarray(rb[:, None]), jnp.asarray(bounds[None, :]))
    return [np.asarray(x) for x in out]


def _streams(rng, rows, bounds):
    """Merged rows of n = 128 lanes: word-A coordinates over the pages,
    word-B ones near them (rows keep hits), lengths 8..127, a duplicate
    across the words now and then, both window signs."""
    n = 2 * CAP
    end = int(bounds[-1])
    vals = np.full((rows, n), INF32, np.int32)
    tag = np.full((rows, n), 2, np.int32)
    for i in range(rows):
        m = int(rng.integers(8, n))
        a = np.unique(rng.integers(0, end, size=(m + 1) // 2))
        b = np.unique(rng.choice(a, size=m // 2) + rng.integers(0, 30,
                                                               m // 2))
        v = np.concatenate([a, b])
        t = np.concatenate([np.zeros(a.size), np.ones(b.size)])
        order = np.lexsort((t, v))
        vals[i, :v.size], tag[i, :v.size] = v[order], t[order]
    ra = np.where(np.arange(rows) % 3 == 0, -12, 40).astype(np.int32)
    rb = np.where(np.arange(rows) % 3 == 0, -9, 262).astype(np.int32)
    return vals, tag, ra, rb


def _ulps(a, b):
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32).astype(np.int64))


UNIFORM = np.arange(1, 301, dtype=np.int32) * 3000
UNEVEN = np.cumsum(np.random.default_rng(7).integers(500, 6000, size=300)
                   ).astype(np.int32)


@pytest.mark.parametrize("policy,bounds,rows", [
    ("bounds", UNIFORM, 32), ("bounds", UNEVEN, 64), ("arith", UNIFORM, 48),
    ("two_level", UNIFORM, 16), ("two_level", UNEVEN, 64),
    ("two_level", UNEVEN[:128], 24), ("two_level", UNEVEN[:100], 16)])
def test_probe_locate_plain_matches_the_tpu_kernel(policy, bounds, rows):
    rng = np.random.default_rng(rows + bounds.size)
    args = _streams(rng, rows, bounds)
    want = _jax_locate(*args, bounds)
    got = [x.numpy() for x in pk.probe_locate(
        *(torch.from_numpy(a) for a in args + (bounds,)), policy=policy)]
    for k, (g, w) in enumerate(zip(got, want)):
        w = w.reshape(g.shape)
        if g.dtype == np.float32:
            assert _ulps(g, w).max() <= 2, k
            np.testing.assert_array_equal(g == 0, w == 0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(k))
    assert got[4].sum() > rows  # rows keep hits


def test_probe_locate_arith_differs_on_an_uneven_table():
    """v // page_len is a lower bound of the locate's cost, not a locate:
    on pages of uneven length its pages and runs are wrong."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a) for a in _streams(rng, 32, UNEVEN)]
    bounds = torch.from_numpy(UNEVEN)
    arith = pk.probe_locate(*args, bounds, policy="arith")
    exact = pk.probe_locate(*args, bounds, policy="bounds")
    assert not torch.equal(arith[0], exact[0])
    assert not torch.equal(arith[1], exact[1])
    two = pk.probe_locate(*args, bounds, policy="two_level")
    assert all(torch.equal(a, b) for a, b in zip(two, exact))


def test_two_level_pages_match_a_search_of_every_bound():
    """The plain two-level locate against searchsorted over tables of 1 to
    1,000 pages (blocks of 128 bounds, a last block part-filled, repeated
    bounds), values before, on and past the bounds."""
    rng = np.random.default_rng(11)
    for p in (1, 2, 127, 128, 129, 256, 1000):
        bounds = np.sort(rng.integers(1, 10 ** 6, size=p)).astype(np.int32)
        bounds[p // 2:p // 2 + 3] = bounds[p // 2]
        vals = np.concatenate([bounds, bounds - 1, bounds + 1,
                               rng.integers(0, 2 * 10 ** 6, size=500),
                               [0, INF32]]).astype(np.int32)[None, :]
        want = np.minimum(np.searchsorted(bounds, vals, side="right"), p - 1)
        got = pk.lane_pages(torch.from_numpy(vals), torch.from_numpy(bounds),
                            "two_level", 3000)
        np.testing.assert_array_equal(got.numpy(), want)


def test_probe_kernels_reject_what_they_cannot_take():
    vals = torch.zeros((2, 128), dtype=torch.int32)
    bounds = torch.ones(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.probe_locate(vals, vals, vals[:, 0], vals[:, 0], bounds,
                        policy="compare_all")
    with pytest.raises(ValueError):
        pk.probe_locate(vals, vals, vals[:, 0], vals[:, 0], bounds[:0])
    tab = torch.zeros((8, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.row_gather(tab, torch.tensor([8], dtype=torch.int32))
    with pytest.raises(ValueError):
        pk.row_gather(tab, torch.tensor([0], dtype=torch.int32), q=16)
    with pytest.raises(ValueError):
        pk.row_gather(tab[:, :200].contiguous(),
                      torch.tensor([0], dtype=torch.int32), mode="sum128")


def _jax_fetch(tab, ids, mode, q=8):
    """benchmarks/probe_dma_fetch.py's fetch_kernel (:80-100, a copy: it is
    defined inside main()) over the [R, 8, n / 8] table, interpreted."""
    r, n = tab.shape
    sub = n // 8

    def fetch_kernel(ids_ref, tab_ref, out_ref, scratch, sems):
        i = pl.program_id(0)
        for j in range(q):
            pltpu.make_async_copy(tab_ref.at[ids_ref[i * q + j]],
                                  scratch.at[j], sems.at[j]).start()
        for j in range(q):
            pltpu.make_async_copy(tab_ref.at[ids_ref[i * q + j]],
                                  scratch.at[j], sems.at[j]).wait()
        if mode == "sum":
            s = scratch[...].reshape(q * 8, sub)
            acc = jnp.sum(s.reshape(q * 8, sub // 128, 128), axis=1)
            out_ref[...] = jnp.sum(acc.reshape(q, 8, 128), axis=1)
        else:
            out_ref[...] = scratch[...].reshape(q, n)

    b = ids.size
    pad = (-b) % q
    width = 128 if mode == "sum" else n
    f = pl.pallas_call(
        fetch_kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=((b + pad) // q,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((q, width), lambda i, *_: (i, 0)),
            scratch_shapes=[pltpu.VMEM((q, 8, sub), jnp.int32),
                            pltpu.SemaphoreType.DMA((q,))]),
        out_shape=jax.ShapeDtypeStruct((b + pad, width), jnp.int32),
        interpret=True)
    ids_p = np.concatenate([ids, np.zeros(pad, np.int32)])
    return np.asarray(f(jnp.asarray(ids_p),
                        jnp.asarray(tab.reshape(r, 8, sub))))[:b]


@pytest.mark.parametrize("r,n,b", [(512, 256, 100), (1, 128, 7),
                                   (300, 2048, 33)])
def test_row_gather_plain_matches_numpy(r, n, b):
    rng = np.random.default_rng(r + n)
    tab = rng.integers(-(1 << 30), 1 << 30, (r, n)).astype(np.int32)
    ids = rng.integers(0, r, b).astype(np.int32)
    ids[::4] = ids[0]
    got = pk.row_gather(torch.from_numpy(tab), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), tab[ids])
    got = pk.row_gather(torch.from_numpy(tab), torch.from_numpy(ids),
                        mode="sum128")
    want = tab[ids].astype(np.int64).reshape(b, n // 128, 128).sum(axis=1)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("mode,width", [("copy", 256), ("sum128", 128)])
def test_row_gather_plain_takes_no_ids(mode, width):
    """No ids: an empty [0, n] (or [0, 128]) result in both modes."""
    tab = torch.arange(4 * 256, dtype=torch.int32).reshape(4, 256)
    got = pk.row_gather(tab, torch.zeros(0, dtype=torch.int32), mode=mode)
    assert got.shape == (0, width) and got.dtype == torch.int32


def _arith_magic(page_len):
    """csrc/probes.cu Arith::of, which the host computes for the kernel:
    mul = ceil(2^shift / page_len), shift = 31 + ceil(log2 page_len)."""
    shift = 31 + (page_len - 1).bit_length()
    return -(-(1 << shift) // page_len), shift


@pytest.mark.parametrize("lens", [range(lo, lo + 512)
                                  for lo in range(1, 4097, 512)]
                         + [(3000, 65535, 2**20 + 1, 2**31 - 1)])
def test_arith_multiply_shift_divides_exactly(lens):
    """Arith's page, (v * mul) >> shift, is v // page_len for every
    0 <= v < 2^31: checked over page lengths 1-4096 and some larger, at
    the values most likely to round wrong and some drawn at random."""
    rng = np.random.default_rng(lens[0])
    for d in lens:
        mul, shift = _arith_magic(d)
        assert mul <= 2**32  # the product of a 31-bit v fits 64 bits
        top = (2**31 - 1) // d * d
        vs = [0, 1, d - 1, d, d + 1, 2**31 - 2, 2**31 - 1, top, top - 1,
              *(int(x) for x in rng.integers(0, 2**31, 8))]
        for v in vs:
            if 0 <= v < 2**31:
                assert (v * mul) >> shift == v // d, (d, v)


@pytest.mark.parametrize("mode,width", [("copy", 2048), ("sum128", 128)])
def test_gather_bound_reads_each_distinct_row_once(mode, width):
    """Row 19's bound: the ids read, each distinct row read once (a
    repeat comes from L2), every output row written."""
    ids = torch.tensor([3, 3, 3, 7, 7, 1] * 100, dtype=torch.int32)
    got = probe_dma_fetch.gather_bound(ids, 2048, mode)
    nbytes = 4 * 600 + 3 * 2048 * 4 + 600 * width * 4
    assert got == bc.bound(nbytes)


@pytest.mark.parametrize("mode", ["copy", "sum128"])
def test_row_gather_plain_matches_the_tpu_kernel(mode):
    """Against fetch_kernel in interpret mode (n = 1024: the TPU's sum
    reduces rows of at least 8 x 128 lanes)."""
    rng = np.random.default_rng(5)
    tab = rng.integers(0, 1 << 20, (512, 1024)).astype(np.int32)
    ids = rng.integers(0, 512, 100).astype(np.int32)
    want = _jax_fetch(tab, ids, "sum" if mode == "sum128" else "reshape")
    got = pk.row_gather(torch.from_numpy(tab), torch.from_numpy(ids),
                        mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_buckets_matches_the_original():
    """benchmarks/common.full_buckets of the port against the original on
    the standard mix of a 2 MB synthetic index; tier_of likewise."""
    ind = build_index(zipf_documents(2_000_000, seed=0), device="cpu")
    counts = np.diff(ind.arr.offsets)
    terms, rs = standard_mix(counts, ind.arr.terms, 10_000)
    got = bc.full_buckets(terms, rs, counts, 1024, device="cpu")
    want = jax_bc.full_buckets(terms, rs, counts, 1024)
    assert got[2] == want[2] and got[3] == want[3]
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bc.HIT_TIERS == jax_bc.HIT_TIERS
    for need in (0, 1, 27, 28, 100, 125, 126, 250, 251, 10 ** 6):
        for cap in (128, 512, 1024, 2048):
            assert bc.tier_of(need, cap) == jax_bc.tier_of(need, cap)


@pytest.fixture(scope="module")
def small_dix():
    from docodo_tpu_torch.ops.device_index import DeviceIndex

    return DeviceIndex.from_index(
        build_index(zipf_documents(2_000_000, seed=0), device="cpu"),
        device="cpu")


def test_probe_locate_runs_on_the_cpu(small_dix):
    res = probe_locate.run("cpu", rows=64, pages=40, dix=small_dix)
    for key in ("probe", "index"):
        r = res[key]
        assert r["two_level"]["mismatch_rows"] == 0
        assert all(r[p]["ms"] is None and r[p]["max_abs_err"] == 0
                   for p in pk.POLICIES)
    assert res["probe"]["arith"]["mismatch_rows"] == 0
    assert res["index"]["arith"]["mismatch_rows"] > 0
    assert res["index"]["pages"] == small_dix.bounds.numel()
    with pytest.raises(RuntimeError if not torch.cuda.is_available()
                       else ValueError):
        probe_locate.run("cuda" if not torch.cuda.is_available() else "meta")


def test_probe_dma_fetch_runs_on_the_cpu():
    res = probe_dma_fetch.run("cpu", r=512, n=256, b=100)
    legs = [v for v in res.values() if isinstance(v, dict)]
    # index_select, tab[ids], gather_term, fetch_postings, both modes at
    # q 32 / 64 / 128
    assert len(legs) == 10 and all(leg["ms"] is None for leg in legs)
    assert res["kernel copy q=32"]["bound_by"] == "bytes"
    assert res["kernel sum128 q=128"]["bound_ms"] < res[
        "kernel copy q=128"]["bound_ms"]
    assert res["max_abs_err"] == 0
    assert all(leg["max_abs_err"] == 0 for leg in legs)


def test_probe_dma_fetch_holds_the_wrapper_at_every_q(monkeypatch):
    """run() holds row_gather itself, in each mode at each q, against the
    plain version: a wrapper wrong only for sum128 at q 64 makes it
    raise."""
    real = pk.row_gather_plain

    def wrong(tab, ids, *, mode="copy", q=32):
        out = real(tab, ids, mode=mode, q=q)
        if mode == "sum128" and q == 64:
            out[0, 0] += 1
        return out

    monkeypatch.setattr(pk, "row_gather_plain", wrong)
    with pytest.raises(AssertionError, match="row_gather sum128 q=64"):
        probe_dma_fetch.run("cpu", r=64, n=256, b=20)


def test_profile_cap64_runs_on_the_cpu(small_dix):
    res = profile_cap64.run("cpu", dix=small_dix)
    assert list(res["stages"]) == ["gather", "+row-1 kernel", "+top-k",
                                   "+hits", "full (no docs)", "full (+docs)"]
    assert res["rows"] > 0 and res["ranks_max_abs_err"] == 0
