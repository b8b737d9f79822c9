"""Console application (a copy of docodo_tpu/cli.py on the port).

Same surface as the reference console app (ref /Program.cs:31-320):

  flags   -p:<port>  server  -cv:<lang>  -i:<path>
          -source:<type>,<path>[,<extra>]  -stops:<file>  -dict:<dir>
          -mem (resident index)  -batch (device-batched serving)
          -mesh:<N> (serve from an N-device document-sharded mesh)
  keys    I index · S search · O info/histogram · V build vocabs · E exit

Sources: doc (mixed pdf/txt folder), files (txt folder), web (crawler),
xml (manifest), db (sqlite config file — the reference's mysql source is
dead code in its own repo, ref DBDataSource.cs:221-311; the config-file
contract Connect/Query/BasePath/IndexType is kept, ref Program.cs:115-130).
Vocabularies: every Dict/<lang>.voc is auto-loaded (ref Program.cs:66-73).

The index builds its CSR on the card, and `server -batch` (which needs
-mem) serves requests through the micro-batching BatchExecutor and the
hand kernels on the card; `-mesh:N` serves from N document shards,
round robin over the host's cards. Without CUDA main() raises, as Index
does; main(argv, device="cpu") runs it all on the CPU (the tests do).
`server` without -batch serves from the host engine.

    python -m docodo_tpu_torch.cli -i:./idx -source:doc,./corpus/ -mem \
        server -p:9001 -batch
"""

from __future__ import annotations

import glob
import os
import sys

from docodo_tpu_torch.index import Index
from docodo_tpu_torch.lang.vocab import (
    Vocab,
    build_freelib_voc,
    build_opencorpora_voc,
)


def create_voc(dict_dir: str, name: str) -> None:
    """Build Dict/<name>.voc (ref Program.cs:39-50)."""
    out = os.path.join(dict_dir, f"{name}.voc")
    if name.lower() == "ru":
        print("Creating russian voc (wait a minute)...")
        build_opencorpora_voc(
            os.path.join(dict_dir, "ru", "dict.opcorpora.xml"), out
        )
    else:
        print(f"Creating {name} voc (wait a minute)...")
        build_freelib_voc(os.path.join(dict_dir, name), out)


def _parse_db_config(path: str) -> dict:
    cfg = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if "=" in line:
                k, v = line.split("=", 1)
                cfg[k.strip()] = v.strip()
    for key in ("Connect", "Query", "BasePath", "IndexType"):
        if key not in cfg:
            raise ValueError(f"No {key} key")
    return cfg


def add_source(ind: Index, spec: str) -> None:
    spl = spec.split(",")
    kind = spl[0]
    if kind == "doc":
        from docodo_tpu_torch.sources import DocumentsDataSource

        ind.add_data_source(DocumentsDataSource("doc", spl[1]))
    elif kind == "files":
        from docodo_tpu_torch.sources import IndexTextFilesDataSource

        ind.add_data_source(IndexTextFilesDataSource("files", spl[1]))
    elif kind == "web":
        from docodo_tpu_torch.sources import WebDataSource

        ind.add_data_source(
            WebDataSource("web", spl[1], spl[2] if len(spl) > 2 else "")
        )
    elif kind == "xml":
        from docodo_tpu_torch.sources import XmlDataSource

        ind.add_data_source(XmlDataSource("xml", spl[1]))
    elif kind in ("db", "sqlite", "mysql"):
        from docodo_tpu_torch.sources import IndexType, SqliteDataSource

        try:
            cfg = _parse_db_config(spl[1])
            ind.add_data_source(SqliteDataSource(
                f"db_{spl[1]}", cfg["BasePath"], cfg["Connect"], cfg["Query"],
                IndexType.FILE, cfg["IndexType"],
            ))
        except (OSError, ValueError) as e:
            print("Error adding db source:", e)
    else:
        print("Unknown source type:", kind)


def show_info(ind: Index, numb: int = 20) -> None:
    print(f"Index contains: {ind.count} words")
    hist = Index.calc_histogram(ind)
    print("Histogram:")
    for key, value in list(hist.items())[:numb]:
        print(f"{key}: {100.0 * value / max(ind.max_coord, 1):.2f}%")
    from docodo_tpu_torch.utils import profiling

    phases = profiling.format_report()
    if phases:
        print("Phase timings:")
        print(phases)


def read_search_request(ind: Index, getch=None, write=None,
                        is_tty: bool | None = None) -> str:
    """Interactive request line with LIVE suggestions rendered under the
    cursor on every keystroke (ref Program.cs:268-307 ReadSearchRequest):
    the current prefix's completions appear dimmed on the line below;
    Tab accepts the first one; Enter submits; Backspace edits.

    getch/write are injectable for tests; without a TTY this degrades to
    a plain input() prompt (suggestions after submit, like round 1).
    """
    if is_tty is None:
        is_tty = sys.stdin.isatty() and sys.stdout.isatty()
    if not is_tty and getch is None:
        sys.stdout.write("req:")
        sys.stdout.flush()
        req = input()
        sugg = ind.get_suggestions(req, 12)
        if sugg:
            print("  suggestions:", " ".join(req + s for s in sugg))
        return req

    if getch is None or write is None:
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        tty.setcbreak(fd)

        def _restore():
            termios.tcsetattr(fd, termios.TCSADRAIN, old)

        getch = getch or (lambda: sys.stdin.read(1))
        write = write or (lambda s: (sys.stdout.write(s),
                                     sys.stdout.flush()))
    else:
        def _restore():
            return None

    buf: list = []
    sugg: list = []
    try:
        while True:
            text = "".join(buf)
            sugg = ind.get_suggestions(text, 12) if len(text) >= 2 else []
            # render: input line, then a dimmed suggestion line below,
            # cursor restored to the end of the input
            line = "\r\x1b[Kreq:" + text
            below = " ".join(
                (text.rsplit(None, 1)[-1] if text.split() else text) + s
                for s in sugg[:8]
            )
            write(line + "\n\x1b[K\x1b[2m" + below[:120] + "\x1b[0m"
                  + "\x1b[A" + "\r\x1b[" + str(4 + len(text)) + "C")
            ch = getch()
            if ch in ("\n", "\r", ""):
                break
            if ch in ("\x7f", "\x08"):
                if buf:
                    buf.pop()
            elif ch == "\t":
                if sugg:  # accept the first completion
                    buf.extend(sugg[0])
            elif ch == "\x03":
                raise KeyboardInterrupt
            elif ch == "\x1b":  # swallow a full escape sequence: CSI
                # parameters run until a final byte in 0x40-0x7e, so
                # multi-byte sequences (Delete \x1b[3~, PgUp, F-keys)
                # must not leak their tail into the query buffer
                nxt = getch()
                if nxt == "[":
                    while True:
                        c2 = getch()
                        if c2 == "" or "\x40" <= c2 <= "\x7e":
                            break
                elif nxt == "O":  # SS3 (F1-F4): one final byte
                    getch()
            elif ch.isprintable():
                buf.append(ch)
    finally:
        _restore()
        write("\n\x1b[K\x1b[A\r\x1b[" + str(4 + len(buf)) + "C\n")
    return "".join(buf)


def interactive(ind: Index, dict_dir: str) -> None:
    while True:
        opts = []
        if ind.can_index:
            opts.append("I to index")
        if ind.can_search:
            opts.append("S to search, O for info")
        opts.append("V to manage vocs, E to exit...")
        print("Press " + ", ".join(opts))
        c = (input().strip() or " ").upper()[0]
        if c == "E":
            break
        if c == "V":
            while True:
                print("-----------\nCreate vocabs\nType voc name from list "
                      "below or e to exit:")
                print(",".join(
                    os.path.basename(d)
                    for d in glob.glob(os.path.join(dict_dir, "*"))
                    if os.path.isdir(d)
                ))
                line = input().strip()
                if line == "e":
                    break
                create_voc(dict_dir, line)
        elif c == "O":
            show_info(ind)
        elif c == "S":
            print("Type text to search, e - exit")
            while True:
                req = read_search_request(ind)
                if req == "e":
                    break
                result = ind.search(req)
                print(f"Found {len(result.found_pages)} pages in "
                      f"{len(result.found_docs)} docs:")
                for d in result.found_docs:
                    print(f"Doc: {d.name}, Found {len(d.pages)} pages")
                    for p in d.pages:
                        print(f"  Page {p.id} ({len(p.pos)} times)")
                        print("    Text: " + (p.text or ""))
        elif c == "I":
            print("Start Indexing ...")
            try:
                ind.create()
            except KeyboardInterrupt:
                ind.cancel()
                print("Indexing was interrupted by user.")
            except Exception as e:
                print("Error creating index:", e)
            print("Indexing completed.")


def main(argv=None, device="cuda") -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    print("DOCODO-TPU Search Engine")
    port = 9001
    for a in args:
        if a.startswith("-p:"):
            port = int(a[3:])
    dict_dir = "Dict"
    for a in args:
        if a.startswith("-dict:"):
            dict_dir = a[6:]

    vocs = []
    print("Loaded vocs: ", end="")
    for f in sorted(glob.glob(os.path.join(dict_dir, "*.voc"))):
        vocs.append(Vocab(f))
        print(os.path.basename(f).split(".")[0], end=" ")
    if not vocs:
        print("No!", end="")
    print()

    for a in args:
        if a.startswith("-cv:"):
            create_voc(dict_dir, a[4:])

    basepath = "."
    for a in args:
        if a.startswith("-i:"):
            basepath = a[3:]
    # -mem: fully-resident index (required for device-batched / mesh
    # serving; the default lazy mode reads postings per lookup like the
    # reference's !InMemory stubs, ref Index.cs:346-348)
    in_memory = "-mem" in args
    ind = Index(basepath, in_memory=in_memory, vocs=vocs, device=device)

    for a in args:
        if a.startswith("-source:"):
            add_source(ind, a[8:])

    stops = os.path.join(dict_dir, "stop.txt")
    if os.path.exists(stops):
        ind.load_stop_words(stops)
    for a in args:
        if a.startswith("-stops:"):
            ind.load_stop_words(a[7:])

    if ind.can_search:
        print(f"Index loaded, contains {ind.count} words")

    server = None
    if "server" in args:
        from docodo_tpu_torch.server import DocodoServer

        # -batch enables micro-batched device serving; -mesh:<N> serves
        # from a document-sharded mesh of N shards (requires an
        # in-memory index, so -i: indexes load lazily and stay
        # host-served unless -mem is also given)
        device_batching = any(
            a == "-batch" or a.startswith("-mesh:") for a in args
        ) and ind.in_memory
        mesh = None
        for a in args:
            if a.startswith("-mesh:") and ind.in_memory:
                from docodo_tpu_torch.parallel.sharding import make_mesh

                n = int(a[6:])
                mesh = make_mesh(n, devices=None if ind.device.type == "cuda"
                                 else [ind.device] * n)
        # the host engine alone runs on the CPU, and is asked for so
        server = DocodoServer(
            ind, port, device_batching=device_batching, mesh=mesh,
            device=ind.device if device_batching else "cpu",
        )
        server.start(background=True)

    try:
        interactive(ind, dict_dir)
    except (EOFError, KeyboardInterrupt):
        pass
    finally:
        if server is not None:
            server.stop()
        ind.dispose()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
