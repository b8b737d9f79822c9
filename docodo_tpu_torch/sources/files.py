"""File system data sources: text files and mixed documents.

The port's copy of docodo_tpu/sources/files.py.

Behavioral match of the reference sources (ref
Docodo.NET/DataSources/DataSources.cs:235-487,
DocumentDataSource.cs:119-145):

* recursive directory walk — files of a folder first (matching any glob
  in the ';'-separated `mod`), then subfolders;
* text documents stream in 3000-char pages, ids "1".., after a header
  page "0" built from `.dscr` sidecar files: `<file>.dscr` then every
  ancestor directory's `.dscr`, first key wins, seeded with
  Name=<relative path> and Source=<source name>;
* charset is auto-detected (sources/charset.py stands in for Ude);
* DocumentsDataSource dispatches by extension: .pdf -> pure-Python PDF
  extractor (one page per PDF page), .txt -> paged text,
  .html/.htm -> web HTML-to-text document.
"""

from __future__ import annotations

import fnmatch
import os
from typing import Dict, Iterator, List, Optional

from docodo_tpu_torch.constants import PAGE_SIZE
from docodo_tpu_torch.sources.base import IndexPage, QueuedDataSource
from docodo_tpu_torch.sources.charset import decode_bytes
from docodo_tpu_torch.sources.pdftext import PdfDocument


# ---------------------------------------------------------------------------
# .dscr headers
# ---------------------------------------------------------------------------

def _add_dscr(path: str, headers: Dict[str, str]) -> None:
    if not os.path.isfile(path):
        return
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.lstrip(" ").startswith(";") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                headers.setdefault(k, v.rstrip("\r\n"))
    except OSError:
        pass


def headers_from_dscr(filename: str, base_headers: str) -> str:
    """Header inheritance chain (ref DataSources.cs:398-429)."""
    headers: Dict[str, str] = {}
    for line in base_headers.splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            headers.setdefault(k, v)
    _add_dscr(filename + ".dscr", headers)
    d = os.path.dirname(os.path.abspath(filename))
    while True:
        _add_dscr(os.path.join(d, ".dscr"), headers)
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return "".join(f"{k}={v}\n" for k, v in headers.items())


# ---------------------------------------------------------------------------
# documents
# ---------------------------------------------------------------------------

class IndexedTextFile:
    """Paged text file document: header page "0", 3000-char body pages.

    Also serves random page access for snippets: doc[page_id] with a
    1-based page number (ref DataSources.cs:329-355) — by CHARACTER
    offset, where the reference seeks bytes then reads chars (a quirk
    that diverges on multi-byte files; the character interpretation is
    the one its own enumerator produces, so we match the enumerator).
    """

    def __init__(self, fname: str, parent=None, headers: Optional[str] = None):
        self.fname = fname
        parent_path = getattr(parent, "path", "") or ""
        self.name = fname[len(parent_path):] if fname.startswith(parent_path) else fname
        self.parent = parent
        self._headers_override = headers
        self._text: Optional[str] = None

    def _load(self) -> str:
        if self._text is None:
            try:
                with open(self.fname, "rb") as f:
                    self._text = decode_bytes(f.read())
            except OSError:
                self._text = ""
        return self._text

    def get_headers(self) -> str:
        if self._headers_override is not None:
            return self._headers_override
        source = getattr(self.parent, "name", "")
        return headers_from_dscr(
            self.fname, f"Name={self.name}\nSource={source}\n"
        )

    def __iter__(self) -> Iterator[IndexPage]:
        yield IndexPage("0", self.get_headers())
        text = self._load()
        for q in range(0, max(len(text), 1), PAGE_SIZE):
            chunk = text[q: q + PAGE_SIZE]
            if not chunk and q > 0:
                break
            yield IndexPage(str(q // PAGE_SIZE + 1), chunk)

    def __getitem__(self, page_id: str) -> IndexPage:
        npage = int(page_id) - 1
        if npage < 0:
            raise IndexError("Page number is out of range")
        text = self._load()
        if npage * PAGE_SIZE > len(text):
            raise IndexError("Page number is out of range")
        return IndexPage(page_id, text[npage * PAGE_SIZE: (npage + 1) * PAGE_SIZE])

    def close(self) -> None:
        self._text = None


class IndexPDFDocument:
    """PDF document: header page "0" with Title/Author metadata, then one
    page per PDF page (ref DocumentDataSource.cs:27-117)."""

    def __init__(self, fname: str, parent=None, data: Optional[bytes] = None):
        self.fname = fname
        parent_path = getattr(parent, "path", "") or ""
        self.name = fname[len(parent_path):] if fname.startswith(parent_path) else fname
        self.parent = parent
        self._doc: Optional[PdfDocument] = None
        try:
            if data is None:
                with open(fname, "rb") as f:
                    data = f.read()
            self._doc = PdfDocument(data)
        except Exception:
            print(f"Error open pdf: {fname}")

    def get_headers(self) -> str:
        out = []
        info = self._doc.info if self._doc else {}
        if info.get("Title"):
            out.append(f"Title={info['Title']}")
        out.append(f"Name={self.name}")
        if info.get("Author"):
            out.append(f"Author={info['Author']}")
        out.append(f"Source={getattr(self.parent, 'name', '')}")
        return headers_from_dscr(self.fname, "\n".join(out) + "\n")

    def __iter__(self) -> Iterator[IndexPage]:
        if self._doc is None:
            return
        yield IndexPage("0", self.get_headers())
        for q in range(self._doc.page_count):
            yield IndexPage(str(q + 1), self._doc.extract_page_text(q))

    def __getitem__(self, page_id: str) -> IndexPage:
        npage = int(page_id) - 1
        if self._doc is None or not 0 <= npage < self._doc.page_count:
            raise IndexError("Page number is out of range")
        return IndexPage(page_id, self._doc.extract_page_text(npage))

    def close(self) -> None:
        self._doc = None


def from_file(path: str, parent=None):
    """Extension dispatch (ref DocumentDataSource.cs:119-145)."""
    s = path.lower()
    if s.endswith(".pdf"):
        return IndexPDFDocument(path, parent)
    if s.endswith(".txt"):
        return IndexedTextFile(path, parent)
    if s.endswith(".html") or s.endswith(".htm"):
        from docodo_tpu_torch.sources.web import from_html

        try:
            with open(path, "rb") as f:
                return from_html(f.read(), path, getattr(parent, "name", ""))
        except OSError:
            return None
    return None


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

class IndexTextFilesDataSource(QueuedDataSource):
    """Recursive folder walk of text files (ref DataSources.cs:235-302)."""

    def __init__(self, name: str, path: str, mod: str = "*.txt",
                 max_items: int = 1_000_000_000):
        super().__init__(name, path)
        self.mod = mod
        self.max_items = max_items
        self._count = 0

    def navigate(self, put, cancelled) -> None:
        self._count = 0
        self._walk(put, cancelled, self.path)

    def _walk(self, put, cancelled, folder: str) -> None:
        if cancelled():
            return
        try:
            entries = sorted(os.scandir(folder), key=lambda e: e.name)
        except OSError as e:
            print("Error:", e)
            return
        files = [e for e in entries if e.is_file()]
        patterns = self.mod.split(";")
        for pat in patterns:
            for e in files:
                if fnmatch.fnmatch(e.name, pat) and self._count < self.max_items:
                    self.datasize += 1
                    put(e.path)
                    self._count += 1
        for e in entries:
            if e.is_dir():
                self._walk(put, cancelled, e.path)

    def document_from_item(self, item):
        self.datadone += 1
        return IndexedTextFile(item, self)

    # direct access at result time (ref DataSources.cs:250-258)
    def __getitem__(self, doc_name: str):
        return IndexedTextFile(os.path.join(self.path, doc_name.lstrip("\\/")), self)


class DocumentsDataSource(IndexTextFilesDataSource):
    """Mixed pdf/txt/html folder source (ref DocumentDataSource.cs:20-170)."""

    def __init__(self, name: str, path: str, mod: str = "*.pdf;*.txt"):
        super().__init__(name, path, mod)

    def document_from_item(self, item):
        self.datadone += 1
        return from_file(item, self)

    def __getitem__(self, doc_name: str):
        return from_file(os.path.join(self.path, doc_name.lstrip("\\/")), self)
