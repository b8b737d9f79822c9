"""The port's console app (docodo_tpu_torch/cli.py) against the JAX
package's (docodo_tpu/cli.py): the same scripted session prints the
same lines, the banner's timings apart, and writes the same index files;
the live suggestion line keystroke by keystroke; and `server -batch
-mem` / `-mesh:2` on the CPU answering /search as the host engine does.

Tolerance: exact. The JAX package builds on one thread
(max_degree_of_parallelism = 1)."""

import builtins
import json
import os
import re
import shutil
import threading
import urllib.parse
import urllib.request

import pytest

import docodo_tpu
import docodo_tpu.index as jax_index
from docodo_tpu import cli as jax_cli
from docodo_tpu.native import pipeline as npipe
from docodo_tpu_torch import cli
from docodo_tpu_torch import server as port_server
from docodo_tpu_torch.index import Index
from docodo_tpu_torch.server import result_to_json
from docodo_tpu_torch.sources import IndexTextFilesDataSource

npipe._tables()

REQUESTS = ["pickwick", '"pickwick club"', "club {author=dickens}",
            "{author=dickens}", "noon | dinner", "pick?", "zzzz"]


@pytest.fixture
def corpus(tmp_path):
    root = tmp_path / "corpus"
    (root / "sub").mkdir(parents=True)
    (root / "a.txt").write_text("interactive pickwick text and words " * 40)
    (root / "sub" / "b.txt").write_text(
        "the pickwick club met at noon for dinner " * 300)
    (root / "sub" / ".dscr").write_text("author=dickens\n")
    return root


@pytest.fixture
def one_jax_thread(monkeypatch):
    """docodo_tpu.Index builds on one thread, as the port does."""
    init = jax_index.Index.__init__

    def init_one(self, *a, **k):
        init(self, *a, **k)
        self.max_degree_of_parallelism = 1

    monkeypatch.setattr(jax_index.Index, "__init__", init_one)


def _session(main, argv, keys, capsys, **kw):
    """main(argv) with `keys` as the lines typed; its printed lines, the
    seconds of the build and the phase timings blanked."""
    it = iter(keys)
    old = builtins.input
    builtins.input = lambda: next(it)
    try:
        assert main(argv, **kw) == 0
    finally:
        builtins.input = old
    out = capsys.readouterr().out
    out = re.sub(r"Time elapsed: [0-9.]+ s", "Time elapsed: s", out)
    # the phase report lists each package's own phases and times
    return re.sub(r"Phase timings:\n(.*\n)*?(?=Press )", "", out)


@pytest.mark.parametrize("mem", [True, False], ids=["-mem", "lazy"])
def test_cli_session_equals_the_jax_clis(tmp_path, corpus, capsys,
                                         one_jax_thread, mem):
    """Index, search, info, exit; then a second session that loads the
    index from its folder: the same lines as the JAX CLI's, and the same
    .index / .index.list bytes."""
    keys = ["I", "S"] + REQUESTS + ["e", "O", "E"]
    outs = {}
    for name, main, kw in (("jax", jax_cli.main, {}),
                           ("port", cli.main, {"device": "cpu"})):
        argv = [f"-i:{tmp_path / name}", f"-source:files,{corpus}/",
                f"-dict:{tmp_path / 'nodict'}"] + (["-mem"] if mem else [])
        first = _session(main, argv, keys, capsys, **kw)
        again = _session(main, argv, ["S", REQUESTS[1], "e", "E"], capsys,
                         **kw)
        outs[name] = (first, again)
    assert outs["port"] == outs["jax"]
    first, again = outs["port"]
    assert re.search(r"Found \d+ pages in 2 docs", first)
    assert "Index loaded, contains" in again and "Doc: files:" in again
    for f in (".index", ".index.list"):
        assert (tmp_path / "port" / f).read_bytes() \
            == (tmp_path / "jax" / f).read_bytes()


@pytest.fixture
def small_pair(tmp_path):
    """The same two documents indexed by both packages."""
    from docodo_tpu.sources.base import IndexPagedTextFile as JaxPaged
    from docodo_tpu.sources.base import ListDataSource as JaxList
    from docodo_tpu_torch.index import IndexPagedTextFile, ListDataSource

    texts = [("alpha", "the pickwick club met at noon", "Name=alpha\n"),
             ("beta", "the club adjourned after dinner", "Name=beta\n")]
    ref = docodo_tpu.Index(path=str(tmp_path / "jax"), in_memory=True)
    ref.max_degree_of_parallelism = 1
    ref.add_data_source(JaxList("docs", [JaxPaged(*t) for t in texts]))
    ref.create()
    mine = Index(str(tmp_path / "port"), device="cpu")
    mine.add_data_source(ListDataSource(
        "docs", [IndexPagedTextFile(*t) for t in texts]))
    mine.create()
    yield mine, ref
    mine.dispose()
    ref.dispose()


KEYSTROKES = {
    "tab accepts": (list("pick") + ["\t", "\n"], "pickwick"),
    "backspace": (["c", "l", "x", "\x7f", "u", "b", "\n"], "club"),
    "empty": (["\r"], ""),
    "escape sequences": (["c", "\x1b", "[", "3", "~", "l", "\x1b", "O", "P",
                          "u", "\x08", "\t", "\n"], "club"),
    "two words": (list("the cl") + ["\t", "\n"], "the club"),
}


@pytest.mark.parametrize("case", list(KEYSTROKES))
def test_live_suggestions_per_keystroke(small_pair, case):
    """read_search_request renders the completions under the input line
    on every keystroke: each frame equal to the JAX CLI's, and the
    request it returns (tests/test_server_cli.py's two cases and more)."""
    mine, ref = small_pair
    keys, want = KEYSTROKES[case]
    frames = {}
    for name, mod, ind in (("port", cli, mine), ("jax", jax_cli, ref)):
        it = iter(keys)
        got_frames = []
        req = mod.read_search_request(ind, getch=lambda: next(it),
                                      write=got_frames.append, is_tty=True)
        assert req == want
        frames[name] = got_frames
    assert frames["port"] == frames["jax"]
    if case == "tab accepts":
        live = [f for f in frames["port"] if "req:pick\n" in f]
        assert live and any("pickwick" in f for f in live)
        assert all("\x1b[2m" in f and "\x1b[A" in f for f in live)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read().decode("utf-8"))


@pytest.mark.parametrize("mode", ["-batch", "-mesh:2"])
def test_server_serves_a_loaded_index(tmp_path, corpus, capsys,
                                      monkeypatch, mode):
    """`-i: -source: -mem server -p:0 -batch` (or -mesh:2, two CPU
    shards) over an index built by an earlier session: every /search body
    equals result_to_json of the host engine on the same folder, the
    batcher served them, and main returns when its input ends."""
    argv = [f"-i:{tmp_path / 'idx'}", f"-source:files,{corpus}/",
            f"-dict:{tmp_path / 'nodict'}", "-mem"]
    _session(cli.main, argv, ["I", "E"], capsys, device="cpu")
    host = Index(str(tmp_path / "idx"), device="cpu")
    host.add_data_source(IndexTextFilesDataSource("files", f"{corpus}/"))
    servers = []
    init = port_server.DocodoServer.__init__

    def recorded(self, *a, **k):
        init(self, *a, **k)
        servers.append(self)

    monkeypatch.setattr(port_server.DocodoServer, "__init__", recorded)
    started, done = threading.Event(), threading.Event()

    def typed():
        started.set()
        assert done.wait(60)
        raise EOFError

    monkeypatch.setattr(builtins, "input", typed)
    rc = []
    t = threading.Thread(target=lambda: rc.append(cli.main(
        argv + ["server", "-p:0", mode], device="cpu")))
    t.start()
    try:
        assert started.wait(60)
        srv = servers[0]
        assert srv.batcher is not None
        assert (srv.batcher.mesh is not None) == (mode != "-batch")
        for req in REQUESTS:
            body = _get(srv.port, "/search?req=" + urllib.parse.quote(req))
            assert body == json.loads(json.dumps(
                result_to_json(host.search(req)), ensure_ascii=False)), req
        status = _get(srv.port, "/status")
        assert status["canSearch"]
        assert status["batcher"]["device_queries"] > 0
    finally:
        done.set()
        t.join(timeout=60)
    assert not t.is_alive() and rc == [0]
    host.dispose()


def test_main_without_cuda_raises(tmp_path, monkeypatch):
    """The console app runs on the card unless the CPU is asked for."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([f"-i:{tmp_path}", f"-dict:{tmp_path / 'nodict'}"])


@pytest.mark.parametrize("lang,how", [("ru", "-cv:"), ("en", "V")])
def test_vocabulary_builds_equal_the_jax_clis(tmp_path, capsys, lang, how):
    """`-cv:<lang>` and the V key build Dict/<lang>.voc from an
    OpenCorpora dump (ru) or FreeLing lists (en): the JAX CLI's bytes,
    and the session's lines."""
    src = os.path.join(os.path.dirname(__file__), "..", "Dict", "ru",
                       "dict.opcorpora.xml")
    outs = {}
    for name, main, kw in (("jax", jax_cli.main, {}),
                           ("port", cli.main, {"device": "cpu"})):
        d = tmp_path / name / "Dict"
        (d / "ru").mkdir(parents=True)
        shutil.copy(src, d / "ru" / "dict.opcorpora.xml")
        (d / "en").mkdir()
        (d / "en" / "dicc.src").write_text(
            "walked walk VBD\nwalking walk VBG\nwalks walk VBZ\n"
            "houses house NNS\nhousing house VBG\nran run VBD\n")
        argv = [f"-i:{tmp_path / name / 'idx'}", f"-dict:{d}"]
        if how == "-cv:":
            out = _session(main, argv + [f"-cv:{lang}"], ["E"], capsys, **kw)
        else:
            out = _session(main, argv, ["V", lang, "e", "E"], capsys, **kw)
        outs[name] = (out.replace(str(tmp_path / name), ""),
                      (d / f"{lang}.voc").read_bytes())
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][1]) > 20
