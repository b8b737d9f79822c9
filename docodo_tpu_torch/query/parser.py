"""Search request parsing: a copy of docodo_tpu/query/parser.py.

Replicates the reference's request sanitation pipeline (ref
Docodo.NET/Search.cs:319-363) regex by regex, then parses the resulting
operator expression with a small recursive-descent parser instead of the
DynamicExpresso interpreter: `*` (proximity-AND, binds tighter) over `+`
(OR), parentheses, leaves are word thunks.

Pipeline (order matters, quirks preserved):
  1. strip chars outside [\\w(){}=~?|"] and underscore runs;
  2. pull out {field=value} sub-queries (parsed with the field search
     function, short words kept);
  3. drop any remaining {...}; map '?' wildcards to '_';
  4. drop 1-2 letter words (main query only) and stop words;
  5. uppercase "quoted" parts -> exact-mode words (greedy across the
     request, as in the reference);
  6. '|' -> '+', inter-word whitespace -> '*';
  7. every remaining word becomes a sequentially-named thunk (A, B, ...).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from docodo_tpu_torch.core.postings import PostingSeq
from docodo_tpu_torch.query.search import WordInfo


class QuerySyntaxError(Exception):
    pass


@dataclass
class WordThunk:
    """A deferred word lookup (ref SearchSequence, Search.cs:280-317).

    `field` is set on thunks created inside a {field=value} sub-parse —
    their lookup is search_field(field, word) rather than
    search_word(word); the device compiler keys on it."""

    name: str
    word: str
    func: Callable[[str], PostingSeq]
    dist: int = 0
    field_name: Optional[str] = None
    _result: Optional[PostingSeq] = None
    info: WordInfo = field(default_factory=WordInfo)

    def __post_init__(self):
        self.info.word = self.word
        self.info.original_word = self.word

    def d(self) -> PostingSeq:
        if self._result is None:
            res = self.func(self.word)
            self.info.n_found = len(res)
            res.R = (
                -len(self.word) - 4 if res.R < 0 else self.dist + len(self.word)
            )
            self._result = res
        return self._result


# AST: ("and", l, r) | ("or", l, r) | WordThunk


def eval_ast(node):
    if isinstance(node, WordThunk):
        return node.d()
    op, l, r = node
    lv, rv = eval_ast(l), eval_ast(r)
    return lv * rv if op == "and" else lv + rv


_TOKEN_RE = re.compile(r"\s*(?:(\w+)\.d\(\)|([*+()]))")


def _parse_expr(tokens: List, pos: int, thunks_by_name) -> Tuple[object, int]:
    node, pos = _parse_term(tokens, pos, thunks_by_name)
    while pos < len(tokens) and tokens[pos] == "+":
        rhs, pos = _parse_term(tokens, pos + 1, thunks_by_name)
        node = ("or", node, rhs)
    return node, pos


def _parse_term(tokens, pos, thunks_by_name):
    node, pos = _parse_factor(tokens, pos, thunks_by_name)
    while pos < len(tokens) and tokens[pos] == "*":
        rhs, pos = _parse_factor(tokens, pos + 1, thunks_by_name)
        node = ("and", node, rhs)
    return node, pos


def _parse_factor(tokens, pos, thunks_by_name):
    if pos >= len(tokens):
        raise QuerySyntaxError("unexpected end of expression")
    tok = tokens[pos]
    if tok == "(":
        node, pos = _parse_expr(tokens, pos + 1, thunks_by_name)
        if pos >= len(tokens) or tokens[pos] != ")":
            raise QuerySyntaxError("missing )")
        return node, pos + 1
    if isinstance(tok, tuple) and tok[0] == "var":
        name = tok[1]
        if name not in thunks_by_name:
            raise QuerySyntaxError(f"unknown variable {name}")
        return thunks_by_name[name], pos + 1
    raise QuerySyntaxError(f"unexpected token {tok!r}")


def parse_expression(expr: str, thunks: List[WordThunk]):
    """Parse the transformed operator string into an AST (None if empty)."""
    tokens: List = []
    pos = 0
    while pos < len(expr):
        m = _TOKEN_RE.match(expr, pos)
        if m is None:
            rest = expr[pos:].strip()
            if not rest:
                break
            raise QuerySyntaxError(f"bad token at {rest[:10]!r}")
        if m.group(1):
            tokens.append(("var", m.group(1)))
        elif m.group(2):
            tokens.append(m.group(2))
        pos = m.end()
    if not tokens:
        return None
    by_name = {t.name: t for t in thunks}
    node, pos = _parse_expr(tokens, 0, by_name)
    if pos != len(tokens):
        raise QuerySyntaxError("trailing tokens")
    return node


def _next_name(n: int) -> str:
    # 'A' + count, exactly like the reference (27th word gives '[' and a
    # syntax error there too)
    return chr(ord("A") + n)


def prepare_search_request(
    req: str,
    thunks: List[WordThunk],
    search_word: Callable[[str], PostingSeq],
    search_field: Optional[Callable[[str, str], PostingSeq]],
    stop_words,
    keep_short: bool = False,
) -> Tuple[str, str]:
    """Sanitize `req`; returns (main expression, fields expression).

    `thunks` accumulates WordThunk entries (shared across the field
    sub-parses, preserving the reference's variable numbering).
    """
    req = re.sub(r'[^\w(){}=~?|"]|_+', " ", req)

    fields_expr_parts: List[str] = []

    def field_repl(m):
        fname = m.group(1)
        start = len(thunks)
        sub_expr, _ = prepare_search_request(
            m.group(2),
            thunks,
            search_word=lambda s, fn=fname: search_field(fn, s),
            search_field=None,
            stop_words=stop_words,
            keep_short=True,
        )
        for t in thunks[start:]:
            t.field_name = fname
        fields_expr_parts.append("(" + sub_expr + ")")
        return ""

    if search_field is not None:
        req = re.sub(r"\{*(\w+)[ ]*=([\w|() ]+)\}", field_repl, req)
    fields_expr = "*".join(fields_expr_parts)

    req = re.sub(r"\{.*\}", "", req)
    req = req.replace("?", "_")

    if not keep_short:
        req = re.sub(r"\b\w{1,2}\b", " ", req)
    for st in stop_words:
        req = re.sub(rf"\b{re.escape(st)}\b", "", req)

    req = re.sub(r'"(.*)"', lambda m: "(" + m.group(1).upper() + ")", req)
    req = re.sub(r"\|", "+", req)
    req = re.sub(
        r"(\b|\))(\s+)(\b|\()",
        lambda m: m.group(0).replace(m.group(2), "*"),
        req,
    )

    def word_repl(m):
        name = _next_name(len(thunks))
        thunks.append(WordThunk(name=name, word=m.group(1), func=search_word))
        return name + ".d()"

    req = re.sub(r"\b(\w+)\b", word_repl, req)
    return req, fields_expr
