"""The port's data sources (docodo_tpu_torch/sources/) against the JAX
package's on the same inputs: charset detection, text folders with
`.dscr` headers, mixed pdf / txt / html folders, the PDF extractor
(filters, object streams, RC4 / AES-128 / AES-256, CID fonts, damaged
and stale xrefs), the XML manifest, SQLite text and blob records, the
entity source and the web crawl with a fake fetcher. The PDFs come from
the builders of tests/test_sources.py.

Tolerance: exact; every document's name and every page's id and text
are compared."""

import os
import re
import sqlite3
import zlib

import pytest

from docodo_tpu import sources as jax_sources
from docodo_tpu.sources import charset as jax_charset
from docodo_tpu.sources import files as jax_files
from docodo_tpu.sources import pdftext as jax_pdftext
from docodo_tpu_torch import sources
from docodo_tpu_torch.sources import charset, files, pdftext
from test_sources import (
    SITE,
    _encrypt_pdf_aes128,
    _encrypt_pdf_rc4,
    _make_cid_pdf,
    _make_objstm_pdf,
    _make_pdf,
    _xref_pdf,
    fake_fetch,
)


def _drain(src):
    """Every document of a source: (name, [(page id, text)])."""
    src.reset()
    out = []
    while (d := src.next_document()) is not None:
        out.append((d.name, [(p.id, p.text) for p in d]))
    return out


def _both(make):
    """make(package's sources module) drained for each package."""
    got, want = _drain(make(sources)), _drain(make(jax_sources))
    assert got == want
    return got


TEXTS = {
    "ascii": b"hello plain ascii",
    "utf-8": "привет мир".encode("utf-8"),
    "cp1251": "Война и мир, том первый. Москва!".encode("cp1251"),
    "cp1252": "caffè città".encode("cp1252"),
    "utf-8 bom": "﻿bom".encode("utf-8"),
    "utf-16-le": "текст".encode("utf-16-le"),
    "utf-16-be": "texte latin".encode("utf-16-be"),
    "utf-32 bom": "wide".encode("utf-32"),
    "empty": b"",
    "binary": bytes(range(256)) * 3,
    "clipped utf-8": ("ы" * 40000).encode("utf-8")[:65537],
}


@pytest.mark.parametrize("name", list(TEXTS))
def test_charset_detection_equals_the_jax_packages(name):
    data = TEXTS[name]
    assert charset.detect_encoding(data) == jax_charset.detect_encoding(data)
    assert charset.decode_bytes(data) == jax_charset.decode_bytes(data)


def _folder(root):
    sub = root / "sub"
    sub.mkdir(parents=True)
    (root / "a.txt").write_text("alpha beta " * 5)
    (sub / "b.txt").write_text("x" * 3000 + "tail page two")
    (sub / "c.txt").write_bytes("Война и мир ".encode("cp1251") * 400)
    (root / ".dscr").write_text("Category=root\nName=ignored\n; note\n")
    (sub / "b.txt.dscr").write_text("Author=Dickens\n")
    (root / "skip.bin").write_text("nope")
    (root / "d.pdf").write_bytes(_make_pdf(["pdf body text", "page two"]))
    (sub / "e.pdf").write_bytes(_make_objstm_pdf())
    (root / "f.html").write_bytes(SITE["http://test.local/"][1])
    (root / "empty.txt").write_text("")


def test_text_folder_equals_the_jax_packages(tmp_path):
    """The text folder walk: files before subfolders, 3000-character
    pages, the .dscr header chain, direct page access for snippets."""
    _folder(tmp_path)
    base = str(tmp_path) + os.sep
    docs = _both(lambda m: m.IndexTextFilesDataSource("files", base))
    assert [n for n, _ in docs] == ["a.txt", "empty.txt",
                                    os.path.join("sub", "b.txt"),
                                    os.path.join("sub", "c.txt")]
    for name, pages in docs:
        got = sources.IndexTextFilesDataSource("files", base)[name]
        want = jax_sources.IndexTextFilesDataSource("files", base)[name]
        for pid, text in pages[1:]:
            assert got[pid].text == want[pid].text == text
    for f in ("a.txt", "sub/b.txt"):
        assert files.headers_from_dscr(str(tmp_path / f), "K=base\n") \
            == jax_files.headers_from_dscr(str(tmp_path / f), "K=base\n")


def test_mixed_folder_equals_the_jax_packages(tmp_path):
    """The mixed folder (pdf and txt by the walk, html by extension)."""
    _folder(tmp_path)
    base = str(tmp_path) + os.sep
    docs = _both(lambda m: m.DocumentsDataSource("doc", base))
    assert {os.path.splitext(n)[1] for n, _ in docs} == {".txt", ".pdf"}
    for name in ("d.pdf", "f.html", "a.txt"):
        got = sources.from_file(str(tmp_path / name))
        want = jax_sources.from_file(str(tmp_path / name))
        assert [(p.id, p.text) for p in got] \
            == [(p.id, p.text) for p in want]


def _aes256_pdf():
    """An AES-256 (R6) document, the construction of
    tests/test_sources.py::test_pdf_aes256_r6_encrypted with a fixed IV."""
    px = jax_pdftext
    file_key = bytes(range(11, 43))
    vsalt, ksalt = bytes(range(8)), bytes(range(8, 16))
    u_entry = px._hash_r6(b"", vsalt, b"") + vsalt + ksalt
    ue = px._aes_cbc_encrypt_nopad(px._hash_r6(b"", ksalt, b""), file_key,
                                   b"\0" * 16)
    content = b"BT (aes256 hardened) Tj ET"
    iv = bytes(range(100, 116))
    padn = 16 - len(content) % 16
    enc = iv + px._aes_cbc_encrypt_nopad(
        file_key, content + bytes([padn]) * padn, iv)
    return (
        b"%PDF-2.0\n"
        b"1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n"
        b"2 0 obj\n<< /Type /Pages /Kids [3 0 R] /Count 1 >>\nendobj\n"
        b"3 0 obj\n<< /Type /Page /Parent 2 0 R /Contents 4 0 R >>\nendobj\n"
        + b"4 0 obj\n<< /Length " + str(len(enc)).encode()
        + b" >>\nstream\n" + enc + b"\nendstream\nendobj\n"
        + b"9 0 obj\n<< /Filter /Standard /V 5 /R 6 /Length 256 /P -4"
        b" /O <" + bytes(48).hex().encode() + b"> /U <"
        + u_entry.hex().encode() + b"> /UE <" + ue.hex().encode()
        + b"> /OE <" + bytes(32).hex().encode() + b"> >>\nendobj\n"
        + b"trailer\n<< /Root 1 0 R /Encrypt 9 0 R /ID [<"
        + bytes(16).hex().encode() + b">] >>\n%%EOF\n")


def _filter_chain_pdf():
    import base64

    text = b"BT (chained filter text) Tj ET"
    chained = base64.a85encode(zlib.compress(text)) + b"~>"
    return (b"%PDF-1.5\n"
            b"1 0 obj\n<< /Type /Catalog /Pages 2 0 R >>\nendobj\n"
            b"2 0 obj\n<< /Type /Pages /Kids [3 0 R] /Count 1 >>\nendobj\n"
            b"3 0 obj\n<< /Type /Page /Parent 2 0 R /Contents 4 0 R >>\n"
            b"endobj\n"
            + b"4 0 obj\n<< /Length " + str(len(chained)).encode()
            + b" /Filter [/ASCII85Decode /FlateDecode] >>\nstream\n"
            + chained + b"\nendstream\nendobj\n"
            b"trailer\n<< /Root 1 0 R >>\n%%EOF\n")


def _locked_pdf():
    data = _encrypt_pdf_rc4(["locked body"])
    m = re.search(rb"/U <([0-9a-f]{64})>", data)
    return data[: m.start(1)] + b"ff" * 32 + data[m.end(1):]


PDFS = {
    "plain": lambda: _make_pdf(["Hello first page", "Second (page) words"]),
    "flate": lambda: _make_pdf(["Hello compressed", "more"], compress=True),
    "filter chain": _filter_chain_pdf,
    "object stream": _make_objstm_pdf,
    "rc4": lambda: _encrypt_pdf_rc4(["rc4 secret page", "two"]),
    "aes-128": lambda: _encrypt_pdf_aes128(b"aes secret words"),
    "aes-256": _aes256_pdf,
    "cid font": lambda: _make_cid_pdf("Composite CID Text"),
    "stale xref": _xref_pdf,
    "damaged xref": lambda: _xref_pdf().replace(b"startxref\n",
                                                b"startxref\n9", 1),
    "password": _locked_pdf,
    "not a pdf": lambda: b"not a pdf at all",
    "truncated": lambda: b"%PDF-1.4\n1 0 obj\n<< /Type /Page",
}


@pytest.mark.parametrize("name", list(PDFS))
def test_pdf_text_equals_the_jax_packages(name):
    """Page count, each page's text and the info dictionary."""
    data = PDFS[name]()
    assert pdftext.extract_pdf_text(data) \
        == jax_pdftext.extract_pdf_text(data)
    try:
        want = jax_pdftext.PdfDocument(data)
    except Exception as e:  # noqa: BLE001 — both must refuse alike
        with pytest.raises(type(e)):
            pdftext.PdfDocument(data)
        return
    got = pdftext.PdfDocument(data)
    assert got.page_count == want.page_count
    assert got.info == want.info
    assert [got.extract_page_text(i) for i in range(got.page_count)] \
        == [want.extract_page_text(i) for i in range(want.page_count)]
    if name in ("plain", "aes-256", "cid font", "stale xref"):
        assert got.extract_text().strip()


def test_xml_manifest_equals_the_jax_packages(tmp_path):
    base = tmp_path / "files"
    base.mkdir()
    (base / "one.txt").write_text("manifest doc one")
    (base / "two.pdf").write_bytes(_make_pdf(["manifest pdf"]))
    man = tmp_path / "test.xml"
    man.write_text(
        "<root><basepath>files/</basepath>"
        "<document><file>one.txt</file><type>txt</type></document>"
        "<document><file>two.pdf</file></document>"
        "<document><type>broken-no-file</type></document></root>")
    docs = _both(lambda m: m.XmlDataSource(
        "xml", str(man).replace(os.sep, "/")))
    assert len(docs) == 2


def _db(path):
    con = sqlite3.connect(path)
    con.execute("create table docs (name text, body text, author text)")
    con.execute("insert into docs values ('d1', 'sqlite body words', 'Boz')")
    con.execute("insert into docs values ('d2', 'second record', NULL)")
    con.execute("create table blobs (name text, data blob)")
    con.execute("insert into blobs values ('p1', ?)",
                (_make_pdf(["blob pdf text"]),))
    con.execute("insert into blobs values ('h1', ?)",
                (b"<html><body>blob html text</body></html>",))
    con.execute("insert into blobs values ('t1', ?)",
                ("blob plain текст".encode("cp1251"),))
    con.commit()
    con.close()


@pytest.mark.parametrize("mode", ["text", "blob"])
def test_sqlite_source_equals_the_jax_packages(tmp_path, mode):
    db = tmp_path / "t.db"
    _db(db)
    if mode == "text":
        docs = _both(lambda m: m.SqliteDataSource(
            "db", "", str(db), "select name, body, author from docs",
            m.IndexType.TEXT, "body"))
    else:
        docs = _both(lambda m: m.SqliteDataSource(
            "db", "", str(db), "select name, data from blobs",
            m.IndexType.BLOB))
    assert len(docs) in (2, 3) and all(pages for _, pages in docs)


class _Book:
    def __init__(self, key, title, body):
        self.key = key
        self.title = title
        self.body = body
        self.tags = ["skipped"]


def test_entity_source_equals_the_jax_packages():
    books = [_Book(1, "First", "entity body one"),
             _Book(2, "Second", "entity body two"),
             _Book(3, None, "")]
    docs = _both(lambda m: m.EntityDataSource(
        "ent", lambda: books, indextype=m.IndexType.TEXT,
        datafieldname="body", key="key"))
    assert len(docs) == 2


def test_web_crawl_equals_the_jax_packages():
    """The crawl from a base URL over a fake site (links, a meta refresh,
    a plain-text page; images and other hosts skipped) and from_html."""
    docs = _both(lambda m: m.WebDataSource(
        "web", "http://test.local", fetcher=fake_fetch, politeness_s=0.0))
    assert len(docs) == 2
    for url, (_, body) in SITE.items():
        got = sources.from_html(body, url, "websrc")
        want = jax_sources.from_html(body, url, "websrc")
        assert (got is None) == (want is None)
        if got is not None:
            assert [(p.id, p.text) for p in got] \
                == [(p.id, p.text) for p in want]
