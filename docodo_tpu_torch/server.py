"""REST search server: a copy of docodo_tpu/server.py bound to the
port's host Index and BatchExecutor.

Same surface as the reference's hand-rolled TCP server (ref /server.cs:
14-121): `GET /search?req=<query>` returns JSON
`{"found": <n docs>, "result": [<doc>...]}`; any other path returns the
banner. Concurrency is capped at 4 x CPU worker threads
(ref server.cs:16). Extensions beyond the reference, on separate paths:
`/suggest?req=` (prefix autocomplete) and `/status`.

The server batches on the card by default and raises without CUDA. A
CPU index is served with device="cpu": through the executor, or, with
device_batching=False, by the host engine alone; the host engine alone
is never taken unless the CPU is asked for. With `mesh`
(parallel/sharding.make_mesh) the executor serves a document-sharded
index over the mesh's devices.

    srv = DocodoServer(index, port=0, host="127.0.0.1")  # the card
    srv.start()
    ...
    srv.stop()
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

import torch

BANNER = "DOCODO-TPU Search Engine\n"


def result_to_json(result) -> dict:
    """Serialize a SearchResult like the reference's Newtonsoft dump of
    foundDocs (ref server.cs:85-97)."""
    docs = []
    for d in result.found_docs:
        docs.append({
            "Name": d.name,
            "rank": d.rank,
            "summary": d.summary,
            "headers": d.headers,
            "foundWords": d.found_words,
            "pages": [
                {"id": p.id, "pos": list(p.pos), "text": p.text or ""}
                for p in d.pages
            ],
        })
    return {"found": len(result.found_docs), "result": docs}


class DocodoServer:
    """Threaded HTTP server bound to an Index."""

    def __init__(self, index, port: int = 9001, host: str = "0.0.0.0",
                 device_batching: bool = True,
                 max_threads: Optional[int] = None,
                 materialize: bool = True, pipeline: bool = True,
                 device="cuda", mesh=None):
        self.index = index
        if not device_batching and torch.device(device).type != "cpu":
            raise ValueError("device_batching=False serves from the CPU's "
                             "host engine; pass device=\"cpu\" to ask "
                             "for it")
        if max_threads is None:
            # host path: 4 x CPU (ref server.cs:16). Device batching:
            # requests park on batcher events (no CPU) — a low cap
            # starves the micro-batcher of batch fodder (4 threads on a
            # 1-core host = 4-query device batches), so admit enough
            # concurrency to fill a device batch
            max_threads = (
                1024 if device_batching else (os.cpu_count() or 1) * 4
            )
        self.max_threads = max_threads
        self._sem = threading.BoundedSemaphore(self.max_threads)
        self.batcher = None
        if device_batching:
            from docodo_tpu_torch.query.batcher import BatchExecutor

            # materialize=False serves rank/position results without the
            # per-doc snippet text IO (clients that only need hit lists);
            # without a CUDA card a "cuda" executor raises
            self.batcher = BatchExecutor(
                index, materialize=materialize, pipeline=pipeline,
                device=device, mesh=mesh,
            )
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "text/html; charset=utf-8"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                with outer._sem:
                    try:
                        self._route()
                    except BrokenPipeError:
                        pass
                    except Exception as e:  # noqa: BLE001 — 502 like the
                        # reference's error response (ref server.cs:96-99)
                        try:
                            self._send(
                                502, f"502 Bad Gateway\n{e}".encode(),
                                "text/plain; charset=utf-8",
                            )
                        except Exception:
                            pass

            def _route(self):
                parts = urlsplit(self.path)
                qs = parse_qs(parts.query)
                if parts.path == "/search":
                    req = (qs.get("req") or [""])[0]
                    if outer.batcher is not None:
                        result = outer.batcher.search(req)
                    else:
                        result = outer.index.search(req)
                    # compact dump like the reference's Newtonsoft default
                    # (ref server.cs:93)
                    body = json.dumps(
                        result_to_json(result), ensure_ascii=False
                    ).encode("utf-8")
                    self._send(200, body, "application/json; charset=utf-8")
                elif parts.path == "/suggest":
                    req = (qs.get("req") or [""])[0]
                    n = int((qs.get("n") or ["10"])[0])
                    words = outer.index.get_suggestions(req, n)
                    self._send(
                        200, json.dumps(words, ensure_ascii=False).encode(),
                        "application/json; charset=utf-8",
                    )
                elif parts.path == "/status":
                    st = {
                        "status": outer.index.status,
                        "words": outer.index.count,
                        "maxCoord": outer.index.max_coord,
                        "canSearch": outer.index.can_search,
                    }
                    if outer.batcher is not None:
                        st["batcher"] = dict(outer.batcher.stats)
                    self._send(
                        200, json.dumps(st).encode(),
                        "application/json; charset=utf-8",
                    )
                else:
                    self._send(200, ("<pre>" + BANNER + "</pre>").encode())

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self, background: bool = True) -> None:
        print(f"Http server listening on port {self.port}...")
        if background:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True
            )
            self._thread.start()
        else:
            self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.batcher is not None:
            self.batcher.close()
