"""docodo_tpu_torch: the docodo engine on PyTorch and CUDA.

The JAX package (docodo_tpu) is the reference this port is held against;
the port imports torch, never jax, and nothing of docodo_tpu: it keeps
its own copies of the host modules it needs. The TPU kernels of the
full-result and page-level query paths, and of the probes of the JAX
package's benchmarks/, are CUDA kernels for Hopper (csrc/*.cu).

  cli.py               the console app: python -m docodo_tpu_torch.cli
  index.py             index build over paged documents (native
                       tokenizer, CSR sorted on the card; with a folder
                       spilled past max_tmp_index_items, on build
                       threads, and merged), the standalone IndexBuilder,
                       the host engine Index (in memory, or in a folder
                       whose files Index(path) loads) with SearchOptions,
                       and the query side's word -> (variant keys, R)
                       rule
  core/                postings algebra (postings.py), the .index file
                       and its varint codec (storage.py, varint.py), the
                       page table and its .index.list file (pagetable.py)
  sources/             text / pdf / html folders, XML manifests, SQLite,
                       entities, the web crawl, the zip page cache
  native/              the C++ tokenizer, interner, bulk stemmers and
                       varint codec (g++ at first use + ctypes binding)
  lang/, constants.py  tokenizer, stemmers, vocabularies (.voc), stop
                       words, word coder
  utils/profiling.py   build phase timings, torch.profiler traces
  mix.py, oracle.py    the standard and wide query mixes, the numpy oracle
  synthetic.py         seeded Zipf corpora
  ops/seqops.py        posting algebra on batched tensors
  ops/device_index.py  the device index, the packed build stream and its
                       sort, and the routing of both query paths
                       (search_batch_full, search_batch)
  ops/query_kernels.py the kernel wrappers and their plain versions
  ops/probe_kernels.py the probe kernels' wrappers (csrc/probes.cu) and
                       their plain versions
  ops/_cuda.py         nvcc build at first use + ctypes binding
  benchmarks/          the probes of the JAX package's benchmarks/ that
                       hold a TPU kernel, run on the card
  query/, server.py    the host query engine, the micro-batching
                       BatchExecutor and the HTTP server
  parallel/            document-sharded build and serving over several
                       devices (sharding.py, serving.py
                       ShardedDeviceIndex) and processes
                       (distributed.py, torch.distributed)
"""

__version__ = "0.2.0"


def __getattr__(name):
    # lazy exports, as in docodo_tpu/__init__.py: core/ imports without
    # the whole stack
    if name in ("Index", "IndexBuilder", "SearchOptions"):
        from docodo_tpu_torch import index as _index

        return getattr(_index, name)
    if name == "Vocab":
        from docodo_tpu_torch.lang.vocab import Vocab

        return Vocab
    if name == "DeviceIndex":
        from docodo_tpu_torch.ops.device_index import DeviceIndex

        return DeviceIndex
    if name == "BatchExecutor":
        from docodo_tpu_torch.query.batcher import BatchExecutor

        return BatchExecutor
    if name == "DocodoServer":
        from docodo_tpu_torch.server import DocodoServer

        return DocodoServer
    if name == "ShardedDeviceIndex":
        from docodo_tpu_torch.parallel.serving import ShardedDeviceIndex

        return ShardedDeviceIndex
    raise AttributeError(name)
