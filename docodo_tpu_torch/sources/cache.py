"""Text cache data source.

The port's copy of docodo_tpu/sources/cache.py.

Transparent wrapper that tees every page seen during indexing into a zip
archive (`<source>.cache.zip`, entry `Name{id}`) and serves page text back
at result time for snippets/highlighting (ref
Docodo.NET/DataSources/DataSources.cs:492-712). Rebuilds write to a `_`
suffixed file that is atomically swapped in when the index publishes
(ref Index.cs:456-462, 493-510).
"""

from __future__ import annotations

import os
import threading
import time
import zipfile
from collections import OrderedDict
from typing import Optional

from docodo_tpu_torch.sources.base import IndexPage
from docodo_tpu_torch.utils import profiling


class _CachedDoc:
    """Wraps a live document, writing each page into the parent zip."""

    def __init__(self, doc, parent: "IndexTextCacheDataSource"):
        self._doc = doc
        self._parent = parent
        self.name = doc.name

    def __iter__(self):
        for page in self._doc:
            self._parent._write_page(self.name, page)
            yield page

    def close(self):
        close = getattr(self._doc, "close", None)
        if close:
            close()


class _DirectCachedDoc:
    """Read-side view: serves pages from the zip by `Name{id}` entry."""

    def __init__(self, name: str, parent: "IndexTextCacheDataSource"):
        self.name = name
        self._parent = parent

    def __getitem__(self, page_id: str) -> IndexPage:
        text = self._parent._read_page(self.name, page_id)
        return IndexPage(page_id, text)

    def close(self):
        pass


class IndexTextCacheDataSource:
    # decoded-page LRU shared per cache file: result materialization
    # re-reads the same hot pages across queries, and inflating a zip
    # entry per snippet dominates serving (measured 4 ms/read on a big
    # page vs ~0 for a dict hit)
    PAGE_CACHE_SIZE = 256

    def __init__(self, source, filename: str):
        self.source = source
        self.filename = filename
        self._lock = threading.RLock()
        self._zip: Optional[zipfile.ZipFile] = None
        self._mode: Optional[str] = None
        self._page_cache: "OrderedDict[str, str]" = OrderedDict()

    @property
    def name(self):
        return self.source.name

    @property
    def path(self):
        return getattr(self.source, "path", "")

    def estimate(self) -> float:
        return self.source.estimate() if hasattr(self.source, "estimate") else 0.0

    # ---- write side -----------------------------------------------------------
    def reset(self) -> None:
        if self.source is not None:
            self.source.reset()
        with self._lock:
            self._close_zip()
            if os.path.exists(self.filename):
                os.remove(self.filename)
            os.makedirs(os.path.dirname(self.filename) or ".", exist_ok=True)
            self._zip = zipfile.ZipFile(
                self.filename, "w", zipfile.ZIP_DEFLATED,
                # level 1: the cache is read back for snippets, not
                # archived — deflate-6 was ~20% of the whole facade
                # build wall time for ~8% smaller files
                compresslevel=1,
            )
            self._mode = "w"

    def next_document(self, wait: bool = True):
        doc = self.source.next_document(wait)
        if doc is None:
            return None
        return _CachedDoc(doc, self)

    def _write_page(self, doc_name: str, page: IndexPage) -> None:
        # a build's spans: the wait for this source's lock (build threads
        # of one source take turns here) and the zip write under it
        t0 = time.perf_counter()
        with self._lock:
            if self._zip is None or self._mode != "w":
                return
            t1 = time.perf_counter()
            self._zip.writestr(doc_name + "{" + page.id + "}", page.text)
            t2 = time.perf_counter()
        profiling.record("build.page-cache-wait", t1 - t0)
        profiling.record("build.page-cache", t2 - t1)

    # ---- read side ------------------------------------------------------------
    def __getitem__(self, doc_name: str):
        with self._lock:
            if self._mode == "w":
                self._close_zip()
            if self._zip is None and os.path.exists(self.filename):
                try:
                    self._zip = zipfile.ZipFile(self.filename, "r")
                    self._mode = "r"
                except Exception:
                    self._zip = None
            if self._zip is None:
                return None
            return _DirectCachedDoc(doc_name, self)

    def _read_page(self, doc_name: str, page_id: str) -> str:
        key = doc_name + "{" + page_id + "}"
        with self._lock:
            cached = self._page_cache.get(key)
            if cached is not None:
                self._page_cache.move_to_end(key)
                return cached
            if self._zip is None:
                return ""
            try:
                raw = self._zip.read(key)
            except KeyError:
                return ""
            text = raw.decode("utf-8")
            self._page_cache[key] = text
            if len(self._page_cache) > self.PAGE_CACHE_SIZE:
                self._page_cache.popitem(last=False)
            return text

    # ---- lifecycle ------------------------------------------------------------
    def _close_zip(self) -> None:
        if self._zip is not None:
            try:
                self._zip.close()
            except Exception:
                pass
        self._zip = None
        self._mode = None
        self._page_cache.clear()  # rebuilds swap the archive content

    def close(self) -> None:
        with self._lock:
            self._close_zip()
