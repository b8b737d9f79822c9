"""Data source interfaces and helpers.

The port's copy of docodo_tpu/sources/base.py.

Mirrors the reference contracts (ref Docodo.NET/DataSources/DataSources.cs):

* a *document* is an iterable of IndexPage(id, text); page id "0" is the
  header page carrying 'name=value' lines;
* a *data source* yields documents via reset() + next_document(); direct
  sources can also serve a document/page by name at result time;
* QueuedDataSource runs navigation on a background thread feeding a queue.

Python sources duck-type these; only `name`, `path`, `reset`, and
`next_document` are required by the index builder.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional


@dataclass
class IndexPage:
    id: str
    text: str


class IndexPagedTextFile:
    """A simple pre-paged text document: header page "0" + body page(s)
    (ref DataSources.cs:99-126)."""

    def __init__(self, name: str, text: str, headers: str):
        self.name = name
        self.pages: List[IndexPage] = [IndexPage("0", headers), IndexPage("1", text)]

    def set_headers(self, headers: str) -> None:
        self.pages[0] = IndexPage("0", headers)

    def __iter__(self) -> Iterator[IndexPage]:
        return iter(self.pages)

    def close(self) -> None:
        pass


class DataSource:
    """Minimal base: fixed document list (useful for tests and adapters)."""

    def __init__(self, name: str, path: str = ""):
        self.name = name
        self.path = path

    def reset(self) -> None:
        pass

    def estimate(self) -> float:
        return 0.0

    def next_document(self, wait: bool = True):
        raise NotImplementedError

    def close(self) -> None:
        pass


class QueuedDataSource(DataSource):
    """Producer/consumer source: `navigate` fills a queue from a background
    thread; `next_document` drains it (ref DataSources.cs:130-228)."""

    _SENTINEL = object()

    def __init__(self, name: str, path: str = ""):
        super().__init__(name, path)
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._cancel = threading.Event()
        self.datasize = 0
        self.datadone = 0

    # override: enumerate items into the queue
    def navigate(self, put, cancelled) -> None:
        raise NotImplementedError

    # override: item -> document
    def document_from_item(self, item):
        return item

    @property
    def is_navigating(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def estimate(self) -> float:
        return self.datadone / self.datasize if self.datasize > 0 else 0.0

    def reset(self) -> None:
        self._cancel.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._cancel = threading.Event()
        self._q = queue.Queue()

        # bind: a thread outliving a later reset() must post its sentinel
        # into ITS OWN queue (not the replacement) and keep observing ITS
        # OWN cancel flag
        q = self._q
        cancel = self._cancel

        def run():
            try:
                self.navigate(q.put, cancel.is_set)
            finally:
                q.put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def next_document(self, wait: bool = True):
        while True:
            try:
                item = self._q.get(block=wait, timeout=None if wait else 0.01)
            except queue.Empty:
                return None
            if item is self._SENTINEL:
                self._q.put(self._SENTINEL)  # let sibling workers see the end
                return None
            doc = self.document_from_item(item)
            if doc is not None:
                return doc

    def close(self) -> None:
        self._cancel.set()


class ListDataSource(DataSource):
    """Serve a fixed list of documents (test fixture / adapter)."""

    def __init__(self, name: str, docs: Iterable):
        super().__init__(name, name)
        self._docs = list(docs)
        self._lock = threading.Lock()
        self._pos = 0

    def reset(self) -> None:
        self._pos = 0

    def next_document(self, wait: bool = True):
        with self._lock:
            if self._pos >= len(self._docs):
                return None
            doc = self._docs[self._pos]
            self._pos += 1
            return doc
