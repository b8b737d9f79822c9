"""Database / entity data sources.

The port's copy of docodo_tpu/sources/db.py.

Behavioral match of the reference DB layer (ref
Docodo.NET/DataSources/DBDataSource.cs:16-219):

* `DBDataSourceBase` — abstract queued source with three index modes:
  File (field holds a path relative to base path), Blob (bytes sniffed:
  %PDF magic -> PDF, '<html' -> HTML, else charset-detected text), and
  Text (field holds the text). Records always get a Source= header.
* `EntityDataSource` — reflects an iterable of Python objects into
  header fields (every public non-callable attribute), choosing the doc
  name by a key selector and the file/text payload by a field selector.
* `SqliteDataSource` — a concrete runnable implementation over the
  stdlib sqlite3 (the reference's MySqlDBDocSource is commented out in
  its own repo, ref DBDataSource.cs:221-311; the base-class contract is
  the spec).
"""

from __future__ import annotations

import io
import os
from enum import Enum
from typing import Callable, Iterable, Optional

from docodo_tpu_torch.sources.base import IndexPagedTextFile, QueuedDataSource
from docodo_tpu_torch.sources.charset import decode_bytes


class IndexType(Enum):
    FILE = "file"
    BLOB = "blob"
    TEXT = "text"


class DBDataSourceBase(QueuedDataSource):
    def __init__(self, name: str, basepath: str, connect: str, select: str,
                 indextype: IndexType, datafieldname: Optional[str] = None):
        super().__init__(name, basepath)
        self.connect_string = connect
        self.select_string = select
        self.index_type = indextype
        self.field_name = datafieldname or ""

    # ---- record adders (ref DBDataSource.cs:43-137) -----------------------
    def _base_fields(self, fields: Optional[str]) -> str:
        fields = fields or ""
        if "Source=" not in fields:
            fields += f"Source={self.name}\n"
        return fields

    def add_text_record(self, put, name: str, text: str,
                        fields: Optional[str] = None) -> None:
        fields = self._base_fields(fields)
        put(IndexPagedTextFile(name, text, fields))

    def add_blob_record(self, put, name: str, data: bytes,
                        fields: Optional[str] = None) -> None:
        if self.index_type not in (IndexType.BLOB, IndexType.TEXT):
            raise ValueError("Adding record of wrong IndexType")
        fields = self._base_fields(fields)
        head = data[:4000]
        if head.startswith(b"%PDF"):
            from docodo_tpu_torch.sources.files import IndexPDFDocument

            doc = IndexPDFDocument(name, self, data=data)
            doc.get_headers = lambda: fields  # type: ignore[method-assign]
            put(doc)
            return
        if b"<html" in head.lower():
            from docodo_tpu_torch.sources.web import from_html

            doc = from_html(data, name, self.name)
            if doc is not None:
                doc.set_headers(fields)
                put(doc)
            return
        put(IndexPagedTextFile(name, decode_bytes(data), fields))

    def add_file_record(self, put, name: str, fname: str,
                        fields: Optional[str] = None) -> None:
        if self.index_type != IndexType.FILE:
            raise ValueError("Adding record of wrong IndexType")
        fields = self._base_fields(fields)
        full = os.path.join(self.path, fname)
        if fname.lower().endswith(".pdf"):
            from docodo_tpu_torch.sources.files import IndexPDFDocument

            doc = IndexPDFDocument(full, self)
        else:
            from docodo_tpu_torch.sources.files import IndexedTextFile

            doc = IndexedTextFile(full, self)
        doc.name = name
        doc.get_headers = lambda: fields  # type: ignore[method-assign]
        put(doc)


class EntityDataSource(DBDataSourceBase):
    """Reflects entity objects into indexable documents
    (ref DBDataSource.cs:147-219)."""

    def __init__(self, name: str, entities: Callable[[], Iterable],
                 basepath: str = "", indextype: IndexType = IndexType.TEXT,
                 datafieldname: Optional[str] = None,
                 key: Optional[str] = None,
                 filename_func: Optional[Callable] = None,
                 select_key: Optional[Callable] = None):
        if indextype == IndexType.BLOB:
            raise ValueError("Not supported")
        super().__init__(name, basepath, "", "", indextype, datafieldname)
        self._set = entities
        self._select_key = select_key or (
            (lambda item: getattr(item, key)) if key else None
        )
        self._payload = filename_func or (
            (lambda item: str(getattr(item, datafieldname)))
            if datafieldname else None
        )

    @staticmethod
    def _public_fields(item):
        for fname in dir(item):
            if fname.startswith("_"):
                continue
            val = getattr(item, fname)
            if callable(val) or isinstance(val, (list, tuple, dict, set)):
                continue
            yield fname, val

    def navigate(self, put, cancelled) -> None:
        nid = 1
        for item in self._set():
            if cancelled():
                return
            name = str(self._select_key(item)) if self._select_key else str(nid)
            nid += 1
            payload = self._payload(item) if self._payload else ""
            lines = [
                f"{fname}={val}" for fname, val in self._public_fields(item)
                if val is not None
            ]
            fields = "\n".join(lines + [f"Name={name}"]) + "\n"
            self.datasize += 1
            if self.index_type == IndexType.FILE:
                if payload:
                    self.add_file_record(put, name, payload, fields)
            elif self.index_type == IndexType.TEXT:
                if payload:
                    self.add_text_record(put, name, payload, fields)

    def document_from_item(self, item):
        self.datadone += 1
        return item


class SqliteDataSource(DBDataSourceBase):
    """Concrete DB source over stdlib sqlite3.

    The select query's first column is the document name; the payload
    column is `datafieldname` (or the second column). Mode semantics
    follow DBDataSourceBase.
    """

    def navigate(self, put, cancelled) -> None:
        import sqlite3

        con = sqlite3.connect(self.connect_string)
        try:
            cur = con.execute(self.select_string)
            cols = [d[0] for d in cur.description]
            payload_col = (
                cols.index(self.field_name) if self.field_name in cols else 1
            )
            for row in cur:
                if cancelled():
                    return
                name = str(row[0])
                payload = row[payload_col]
                fields = "".join(
                    f"{c}={v}\n" for c, v in zip(cols, row)
                    if v is not None and not isinstance(v, bytes)
                )
                self.datasize += 1
                if self.index_type == IndexType.FILE:
                    self.add_file_record(put, name, str(payload), fields)
                elif self.index_type == IndexType.BLOB:
                    data = payload if isinstance(payload, bytes) else str(payload).encode()
                    self.add_blob_record(put, name, data, fields)
                else:
                    self.add_text_record(put, name, str(payload or ""), fields)
        finally:
            con.close()

    def document_from_item(self, item):
        self.datadone += 1
        return item
