"""The data sources a build reads documents from (a copy of
docodo_tpu/sources/): a fixed list, text and mixed pdf / txt / html
folders, XML manifests, SQLite tables, entity objects and a web crawl,
and the zip cache of page text an index on disk serves snippets from."""

from docodo_tpu_torch.sources.base import (  # noqa: F401
    DataSource,
    IndexPage,
    IndexPagedTextFile,
    ListDataSource,
    QueuedDataSource,
)
from docodo_tpu_torch.sources.cache import IndexTextCacheDataSource  # noqa: F401
from docodo_tpu_torch.sources.db import (  # noqa: F401
    DBDataSourceBase,
    EntityDataSource,
    IndexType,
    SqliteDataSource,
)
from docodo_tpu_torch.sources.files import (  # noqa: F401
    DocumentsDataSource,
    IndexedTextFile,
    IndexPDFDocument,
    IndexTextFilesDataSource,
    from_file,
)
from docodo_tpu_torch.sources.web import WebDataSource, from_html, from_url  # noqa: F401
from docodo_tpu_torch.sources.xmlsource import XmlDataSource  # noqa: F401
