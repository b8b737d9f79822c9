"""The full-result slice end to end: docodo_tpu_torch's search_batch_full
against the JAX package's on one seeded Zipf corpus (about 60k tokens),
with the JAX Pallas kernels in interpret mode. The mix is the standard
one plus the corpus's most frequent words, so the W=2 kernel (caps <= 512),
both W=1 kernels (caps <= 128 and 256-1024) and the plain route (wider
caps) all serve rows.

Tolerances: ranks and doc_ranks within 2 ulp (torch.log and XLA's log
differ by 1 ulp on about 1% of counts on the CPU); every other field
exact."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from benchmarks.common import standard_mix
from docodo_tpu.ops.device_index import DeviceIndex as JaxDeviceIndex
from docodo_tpu_torch.ops import device_index as tdi
from docodo_tpu_torch.ops import query_kernels as qk
from docodo_tpu_torch.synthetic import build_index, zipf_documents

TOPK = 64
HIT_CAP = 512
RANK_ULPS = 2
REPO = Path(__file__).resolve().parent.parent


def mixed_queries(dix, n_standard: int = 24):
    """The standard mix, plus the most frequent words alone, paired and
    ordered (the plain route at the widest caps), words of 512-1024
    postings (the union kernel at cap 1024, the plain route for W=2), a
    pair of 256-512 postings (the W=2 kernel at cap 512, with hits) and
    a query with an unknown word."""
    counts = np.diff(dix.offsets_np)
    terms, rs = standard_mix(counts, dix.terms, n_standard)
    queries = [[(dix.terms[t[j]], int(r[j])) for j in range(2) if t[j] >= 0]
               for t, r in zip(terms, rs)]
    top = [dix.terms[t] for t in np.argsort(-counts, kind="stable")[:3]]
    mid = [dix.terms[t] for t in
           np.flatnonzero((counts > 512) & (counts <= 1024))[:2]]
    low = [dix.terms[t] for t in
           np.flatnonzero((counts > 256) & (counts <= 512))[:2]]
    queries += [
        [(top[0], 260)], [(top[0], -12), (top[1], -10)],
        [(top[0], 262), (top[2], 258)],
        [(mid[0], 261)], [(mid[0], 259), (mid[1], 263)],
        [(low[0], 260), (low[1], 262)],
        [("nosuchword", 260), (dix.terms[0], 260)],
    ]
    return queries


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    ind = build_index(zipf_documents(480_000, seed=7, vocab=5000,
                                     doc_chars=40_000),
                      str(tmp_path_factory.mktemp("index")))
    jdx = JaxDeviceIndex.from_index(ind)
    tdx = tdi.DeviceIndex.from_index(ind)
    queries = mixed_queries(tdx)
    want = jdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                 use_pallas=True)
    return tdx, queries, want


def f32_ulps(a, b) -> int:
    a = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    b = np.ascontiguousarray(b, dtype=np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b).max()) if a.size else 0


def assert_results_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if k in ("ranks", "doc_ranks"):
            assert f32_ulps(got[k], w) <= RANK_ULPS, k
        else:
            bad = np.argwhere(got[k] != w)
            assert bad.size == 0, f"{k} differs at rows {bad[:5, 0]}"


def test_kernel_route_equals_jax(corpus, monkeypatch):
    tdx, queries, want = corpus
    routes = {}

    def counting(name, fn):
        def wrapped(*a, **k):
            routes[name] = routes.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(qk if hasattr(qk, name) else tdi, name, wrapped)

    for name in ("sorted_and_locate_full", "single_locate_full",
                 "union_locate_full"):
        counting(name, getattr(qk, name))
    counting("query_step_full", tdi.query_step_full)
    got = tdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                use_kernels=True)
    assert_results_equal(got, want)
    assert set(routes) == {"sorted_and_locate_full", "single_locate_full",
                           "union_locate_full", "query_step_full"}, routes
    pairs = np.array([len(q) == 2 for q in queries])
    assert (got["n_hits"][pairs] > 0).sum() >= 5


def test_plain_route_equals_jax(corpus):
    tdx, queries, want = corpus
    got = tdx.search_batch_full(queries, topk=TOPK, hit_cap=HIT_CAP,
                                use_kernels=False)
    assert_results_equal(got, want)


def test_port_imports_no_jax():
    """The port and the host modules it shares run the slice without
    loading jax."""
    code = textwrap.dedent("""
        import sys, tempfile
        from docodo_tpu_torch import DeviceIndex
        from docodo_tpu_torch.synthetic import build_index, zipf_documents
        with tempfile.TemporaryDirectory() as work:
            ind = build_index(zipf_documents(60_000, seed=1, vocab=800), work)
        dix = DeviceIndex.from_index(ind)
        words = dix.terms[10:12]
        out = dix.search_batch_full(
            [[(words[0], 260)], [(words[0], 260), (words[1], 260)]],
            use_kernels=True)
        assert out["pages"].shape == (2, 64)
        assert "jax" not in sys.modules, "jax was imported"
        print("no jax")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout
