"""The page table: page END coordinates (exclusive, ascending), each
page's document ordinal and id, and the document names (a copy of
docodo_tpu/core/pagetable.py); and its `.index.list` file.

A hit coordinate resolves to its page by a binary search of the page
ends (the reference's GetPage, ref Docodo.NET/Build.cs:41-148). The
file is the reference's, and so the JAX package's, byte for byte (ref
Build.cs:99-148): a record a page, [page end: u64-LE], after a page
that opens a document first [document name: 7-bit length + UTF-8]
[page end: u64-LE], then [':' + page id: 7-bit length + UTF-8].
Documents without a page are not written.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from docodo_tpu_torch.constants import DOC_SEP
from docodo_tpu_torch.lang.vocab import _read_7bit_len, _write_7bit_len


def _read_str(f) -> Optional[str]:
    n = _read_7bit_len(f)
    if n is None:
        return None
    raw = f.read(n)
    if len(raw) < n:
        return None
    return raw.decode("utf-8")


def _write_str(f, s: str) -> None:
    data = s.encode("utf-8")
    _write_7bit_len(f, len(data))
    f.write(data)


@dataclass
class PageTable:
    bounds: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.uint64))
    page_doc: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    page_ids: List[str] = field(default_factory=list)
    doc_names: List[str] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.page_ids)

    @classmethod
    def from_marks(cls, marks, shift: int = 0) -> "PageTable":
        """The table of a builder's marks (pagetable.py:55):
        ('source:docname', coord) opens a document, (':pageid', coord)
        ends a page at coord + shift (ref Build.cs:53-72, 348-367)."""
        t = cls()
        t.extend_from_marks(marks, shift)
        return t

    def extend_from_marks(self, marks, shift: int = 0) -> None:
        """Append a builder's marks, their page ends moved by `shift`
        (pagetable.py:63)."""
        bounds = self.bounds.tolist()
        page_doc = self.page_doc.tolist()
        for key, coord in marks:
            if not key.startswith(DOC_SEP):
                self.doc_names.append(key)
            else:
                bounds.append(int(coord) + shift)
                page_doc.append(len(self.doc_names) - 1)
                self.page_ids.append(key[1:])
        self.bounds = np.array(bounds, dtype=np.uint64)
        self.page_doc = np.array(page_doc, dtype=np.int64)

    def locate(self, coords: np.ndarray):
        """For each coordinate its (page index, position in the page), by
        binary search of the page ends (pagetable.py:77); a coordinate
        past the last bound maps to the last page."""
        coords = np.asarray(coords, dtype=np.uint64)
        page = np.searchsorted(self.bounds, coords, side="right")
        page = np.minimum(page, len(self.bounds) - 1)
        base = np.where(page > 0, self.bounds[np.maximum(page - 1, 0)], 0)
        pos = (coords - base).astype(np.int64)
        return page.astype(np.int64), pos

    def page_base(self, page_idx: int) -> int:
        return int(self.bounds[page_idx - 1]) if page_idx > 0 else 0

    def save(self, f) -> None:
        """The `.index.list` records to the binary stream `f`."""
        prev_doc = -1
        for p in range(len(self.page_ids)):
            end = int(self.bounds[p]).to_bytes(8, "little")
            f.write(end)
            d = int(self.page_doc[p])
            if d != prev_doc:
                _write_str(f, self.doc_names[d])
                f.write(end)
                prev_doc = d
            _write_str(f, DOC_SEP + self.page_ids[p])

    @classmethod
    def load(cls, f) -> "PageTable":
        """The table of a `.index.list` stream; reading stops at the first
        record the stream does not hold whole."""
        t = cls()
        bounds: List[int] = []
        page_doc: List[int] = []
        while True:
            raw = f.read(8)
            if len(raw) < 8:
                break
            coord = int.from_bytes(raw, "little")
            s = _read_str(f)
            if s is None:
                break
            if not s.startswith(DOC_SEP):
                t.doc_names.append(s)
            else:
                bounds.append(coord)
                page_doc.append(len(t.doc_names) - 1)
                t.page_ids.append(s[1:])
        t.bounds = np.array(bounds, dtype=np.uint64)
        t.page_doc = np.array(page_doc, dtype=np.int64)
        return t
