"""Web crawler data source.

The port's copy of docodo_tpu/sources/web.py.

Behavioral match of the reference crawler (ref
Docodo.NET/DataSources/WebDataSource.cs:17-271) using only the standard
library (html.parser + urllib instead of HtmlAgilityPack):

* depth-first crawl from a base URL, following <a href> links and
  <meta http-equiv=refresh> redirects, restricted to the base host;
* image extensions skipped, urls >1024 chars dropped, dedup set,
  optional `indextypes` regex filter, MaxItems cap, 100 ms politeness
  delay between fetches;
* documents dispatch on Content-Type: application/pdf -> PDF extractor,
  text/plain -> paged text, else HTML -> text with script/style dropped
  and <img alt> text kept; Title / meta Author become header fields.

The fetcher is injectable (`fetch(url) -> (content_type, bytes)`), so
tests and offline environments run against fakes; the default uses
urllib with the reference's DOCODO user agent.
"""

from __future__ import annotations

import html as html_mod
import re
import time
from html.parser import HTMLParser
from typing import Callable, Optional, Tuple
from urllib.parse import urljoin, urlsplit

from docodo_tpu_torch.sources.base import IndexPagedTextFile, QueuedDataSource
from docodo_tpu_torch.sources.charset import decode_bytes

_IMAGE_EXTS = (".png", ".svg", ".jpg", ".bmp", ".gif")
Fetcher = Callable[[str], Tuple[str, bytes]]


def default_fetcher(url: str) -> Tuple[str, bytes]:
    import urllib.request

    req = urllib.request.Request(
        url,
        headers={"User-Agent": "DOCODO", "Accept": "text/html, text/plain, application/pdf"},
    )
    with urllib.request.urlopen(req, timeout=30) as res:
        ctype = res.headers.get("Content-Type", "text/html").split(";")[0].strip()
        return ctype, res.read()


# ---------------------------------------------------------------------------
# HTML -> text
# ---------------------------------------------------------------------------

class _TextExtractor(HTMLParser):
    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.chunks = []
        self.links = []
        self.refresh: Optional[str] = None
        self.title = ""
        self.author = ""
        self._skip_depth = 0
        self._in_title = False

    def handle_starttag(self, tag, attrs):
        a = dict(attrs)
        if tag in ("script", "style"):
            self._skip_depth += 1
        elif tag == "img":
            if a.get("alt"):
                self.chunks.append(a["alt"] + " ")
        elif tag == "a":
            if a.get("href"):
                self.links.append(a["href"])
        elif tag == "meta":
            if a.get("http-equiv", "").lower() == "refresh":
                m = re.search(r"url=([\w.\\_+?&/%-]+)", a.get("content", ""), re.I)
                if m:
                    self.refresh = m.group(1)
            for k, v in attrs:
                if k.lower() in ("author", "name") and (
                    k.lower() == "author" or (v or "").lower() == "author"
                ):
                    if k.lower() == "author":
                        self.author = v or ""
                    else:
                        self.author = a.get("content", "")
        elif tag == "title":
            self._in_title = True

    def handle_endtag(self, tag):
        if tag in ("script", "style"):
            self._skip_depth = max(0, self._skip_depth - 1)
        elif tag == "title":
            self._in_title = False

    def handle_data(self, data):
        if self._in_title:
            self.title += data
        if self._skip_depth == 0 and data:
            self.chunks.append(data + " ")


def from_html(data: bytes, url: str, source_name: str) -> Optional[IndexPagedTextFile]:
    """HTML bytes -> paged text document (ref WebDataSource.cs:213-269)."""
    p = _TextExtractor()
    try:
        p.feed(decode_bytes(data))
    except Exception:
        return None
    text = "".join(p.chunks).strip("\r\n ")
    text = re.sub(r"([ ]*[\n\r]+[ ]*)+", "\r\n", text)
    if not text:
        return None
    headers = [f"Name={url}", f"Source={source_name}"]
    if p.title:
        headers.append(
            "Title=" + html_mod.escape(p.title).replace("\n", " ").replace("=", " ")
        )
    if p.author:
        headers.append(
            "Author=" + html_mod.escape(p.author).replace("\n", " ").replace("=", " ")
        )
    return IndexPagedTextFile(url, text, "\n".join(headers) + "\n")


def from_url(url: str, parent, fetcher: Fetcher = default_fetcher):
    """Fetch and dispatch on Content-Type (ref WebDataSource.cs:174-210)."""
    try:
        ctype, data = fetcher(url)
    except Exception:
        return None
    parent_path = getattr(parent, "path", "") or ""
    rel = url[len(parent_path):] if url.startswith(parent_path) else url
    if ctype.lower() == "application/pdf":
        from docodo_tpu_torch.sources.files import IndexPDFDocument

        return IndexPDFDocument(url, parent, data=data)
    if ctype.lower() == "text/plain":
        return IndexPagedTextFile(
            rel, decode_bytes(data), f"Source={getattr(parent, 'name', '')}"
        )
    return from_html(data, rel, getattr(parent, "name", ""))


# ---------------------------------------------------------------------------
# crawler source
# ---------------------------------------------------------------------------

class WebDataSource(QueuedDataSource):
    def __init__(self, name: str, url: str, indextypes: str = "",
                 fetcher: Fetcher = default_fetcher,
                 politeness_s: float = 0.1, max_items: int = 1_000_000):
        if not url.endswith("/"):
            url += "/"
        super().__init__(name, url.lower())
        self.host = urlsplit(self.path).hostname or ""
        self.indextypes = indextypes
        self.fetcher = fetcher
        self.politeness_s = politeness_s
        self.max_items = max_items
        self._seen = set()
        self._count = 0

    def reset(self) -> None:
        self._seen = set()
        self._count = 0
        super().reset()

    def navigate(self, put, cancelled) -> None:
        # explicit work stack preserving the depth-first order — a long
        # pagination chain must not exceed the Python recursion limit
        stack = [self.path]
        while stack and not cancelled():
            url = stack.pop()
            children = self._parse_page(put, cancelled, url)
            stack.extend(reversed(children))
            if children and self.politeness_s:
                time.sleep(self.politeness_s)

    def _try_add(self, put, url: str) -> Optional[str]:
        s = url.lower()
        if not s or s.startswith("#"):
            return None
        if "://" not in s:
            s = urljoin(self.path, s)
        try:
            parts = urlsplit(s)
        except ValueError:
            return None
        ext = ""
        path = parts.path
        if "." in path:
            ext = path[path.rfind("."):]
        if ext in _IMAGE_EXTS:
            return None
        if len(s) > 1024 or parts.hostname != self.host:
            return None
        if s in self._seen:
            return None
        self._seen.add(s)
        if not self.indextypes or re.search(self.indextypes, s):
            if self._count < self.max_items:
                self.datasize += 1
                put(s)
                self._count += 1
        return s

    def _parse_page(self, put, cancelled, url: str):
        """Fetch one page, enqueue its new urls, return them for the
        crawl stack (ref WebDataSource.cs:42-95)."""
        if cancelled():
            return []
        try:
            ctype, data = self.fetcher(url)
        except Exception as e:
            print("Error parsing url:", url, e)
            return []
        if not ctype.lower().startswith("text/html"):
            return []
        p = _TextExtractor()
        try:
            p.feed(decode_bytes(data))
        except Exception:
            return []
        children = []
        if p.refresh:
            s = self._try_add(put, p.refresh)
            if s is not None:
                children.append(s)
        for href in p.links:
            s = self._try_add(put, href)
            if s is not None:
                children.append(s)
        return children

    def document_from_item(self, item):
        self.datadone += 1
        return from_url(item, self, self.fetcher)
