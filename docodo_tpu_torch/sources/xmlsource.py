"""XML manifest data source.

The port's copy of docodo_tpu/sources/xmlsource.py.

Reads `<root><basepath>…</basepath><document><file>…</file>…</document>…`
manifests and dispatches each file entry to the file-type dispatcher or
the web URL dispatcher (ref Docodo.NET/DataSources/XmlDataSource.cs:14-117;
manifest example ref /test.xml:1-14).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from docodo_tpu_torch.sources.base import QueuedDataSource


class XmlDataSource(QueuedDataSource):
    def __init__(self, name: str, path: str, fetcher=None):
        super().__init__(name, path)
        self.xmlpath = path
        self.fetcher = fetcher
        # default base path: the manifest's directory (ref XmlDataSource.cs:19-22)
        self.path = os.path.dirname(path) + os.sep if os.sep in path or "/" in path else ""
        head, _, _ = path.rpartition("/")
        if head:
            self.path = head + "/"

    def navigate(self, put, cancelled) -> None:
        try:
            tree = ET.parse(self.xmlpath)
        except (ET.ParseError, OSError) as e:
            print("Error in xml:", e)
            return
        root = tree.getroot()
        base = root.findtext("basepath")
        if base is not None:
            base = base.strip()
            if ":" in base:  # absolute (drive or scheme)
                self.path = base
            else:
                head, _, _ = self.xmlpath.replace("\\", "/").rpartition("/")
                self.path = (head + "/" if head else "") + base
        for doc in root.iter("document"):
            if cancelled():
                return
            item = {child.tag: (child.text or "").strip() for child in doc}
            if "file" in item:
                print("Add file:", item["file"])
                self.datasize += 1
                put(item)
            else:
                print("Error xml: no file field in document")

    def document_from_item(self, item):
        self.datadone += 1
        url = self.path + item["file"]
        if "://" not in url:
            from docodo_tpu_torch.sources.files import from_file

            return from_file(url, self)
        from docodo_tpu_torch.sources.web import default_fetcher, from_url

        return from_url(url, self, self.fetcher or default_fetcher)
