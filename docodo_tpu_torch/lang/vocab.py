"""Morphological vocabularies (.voc files), their builders and stop-word
lists (a copy of docodo_tpu/lang/vocab.py: Vocab :48-145, VocBuilder
:147-221, build_freelib_voc / build_opencorpora_voc :223-258,
load_stop_words :260).

A .voc file is a flat sequence of records (ref Docodo.NET/Dict.cs:71-95):
a .NET BinaryWriter string (7-bit-varint byte length, then UTF-8 bytes)
followed by an int32-LE morphological group id. A group id's low 24 bits
are the group number; GROUP_NOT_EXACT_WORD_MASK flags a stem that is no
word of its own.

A Vocab maps stem -> group id. Word coding stems the word first, then
looks the stem up (ref Build.cs:195-198, Search.cs:226-233); the build
stems its new words in bulk first (prime_stems).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

from docodo_tpu_torch.constants import (
    GROUP_NOT_EXACT_WORD_MASK,
    GROUP_NUMBER_MASK,
)
from docodo_tpu_torch.lang import stemmers


def _read_7bit_len(f) -> Optional[int]:
    shift = 0
    value = 0
    while True:
        b = f.read(1)
        if not b:
            return None
        byte = b[0]
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value
        shift += 7


def _write_7bit_len(f, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            f.write(bytes([b | 0x80]))
        else:
            f.write(bytes([b]))
            return


class Vocab:
    """A loaded morphological dictionary: stem -> 24-bit group id (plus
    flags). `source` is a path (the language is the file name up to its
    first dot) or a binary stream with `name` given."""

    GROUP_NOT_EXACT_WORD_MASK = GROUP_NOT_EXACT_WORD_MASK
    GROUP_NUMBER_MASK = GROUP_NUMBER_MASK

    def __init__(self, source=None, name: Optional[str] = None):
        self.words: Dict[str, int] = {}
        self.range = ("\0", "\0")  # first letters this vocabulary covers
        self.name = name
        self.stemmer = None
        # stems of words primed in bulk (prime_stems), read before the
        # per-word stemmer
        self._stem_cache: Dict[str, str] = {}
        if source is None:
            return
        if isinstance(source, (str, os.PathLike)):
            fname = os.fspath(source)
            self.name = name or os.path.basename(fname).split(".")[0]
            self.stemmer = stemmers.get_stemmer(self.name)
            with open(fname, "rb") as f:
                self.load(f)
        else:
            if self.name is None:
                raise ValueError("name required when loading from stream")
            self.stemmer = stemmers.get_stemmer(self.name.split(".")[0])
            self.load(source)

    def __contains__(self, w):
        return w in self.words

    def __getitem__(self, w):
        return self.words[w]

    def __len__(self):
        return len(self.words)

    def add(self, word: str, group: int) -> None:
        self.words[word] = group

    def stem(self, word: str) -> str:
        if self.stemmer is None:
            return word
        s = self._stem_cache.get(word)
        return s if s is not None else self.stemmer(word)

    def prime_stems(self, words) -> None:
        """Stem the new words this vocabulary covers in one native call,
        where its language has a bulk stemmer (stemmers.BULK_STEMMERS),
        and keep the stems for stem() (docodo_tpu/lang/vocab.py:114)."""
        bulk = stemmers.BULK_STEMMERS.get(self.stemmer)
        if bulk is None:
            return
        lo, hi = self.range
        todo = [w for w in words
                if w and lo <= w[0] <= hi and w not in self._stem_cache]
        if todo:
            self._stem_cache.update(zip(todo, bulk(todo)))

    def search(self, word: str) -> int:
        """Group id of `word`, or 0 if absent (ref Dict.cs:97-103)."""
        return self.words.get(word, 0)

    def load(self, f) -> None:
        self.words.clear()
        while True:
            n = _read_7bit_len(f)
            if n is None:
                break
            raw = f.read(n)
            if len(raw) < n:
                break
            grp = f.read(4)
            if len(grp) < 4:
                break
            self.words[raw.decode("utf-8")] = int.from_bytes(
                grp, "little", signed=True)
        # first-letter range: the first key >= 'a' through the last key,
        # in ordinal key order (ref Dict.cs:92-94)
        keys = sorted(self.words)
        lo = next((k[0] for k in keys if k[0] >= "a"), "\0")
        hi = keys[-1][0] if keys else "\0"
        self.range = (lo, hi)

    def save(self, f) -> None:
        for word in sorted(self.words):
            data = word.encode("utf-8")
            _write_7bit_len(f, len(data))
            f.write(data)
            f.write(int(self.words[word]).to_bytes(4, "little", signed=True))


class VocBuilder:
    """Build a .voc from morphologically grouped word lists.

    Words of one lemma group share one group id; groups whose stems collide
    are unioned through a replacement map (ref Dict.cs:109-210).
    """

    def __init__(self, stemmer=None):
        self.stemmer = stemmer
        self.words: Dict[str, int] = {}
        self.replaces: Dict[int, int] = {}
        self._next_group = 1

    def _stem(self, w: str) -> str:
        return self.stemmer(w) if self.stemmer else w

    def add_words_group(self, grouplist: Iterable[str]) -> None:
        grouplist = list(grouplist)
        curr = self._next_group
        has_match = False  # some word in the group equals its own stem
        found = False
        replace_groups = set()

        for word in grouplist:
            stemme = self._stem(word)
            if not has_match and stemme in grouplist:
                has_match = True
            if stemme in self.words:
                new_curr = self.words[stemme]
                new_curr = self.replaces.get(new_curr, new_curr)
                if (curr & GROUP_NUMBER_MASK) != (new_curr & GROUP_NUMBER_MASK):
                    if found:
                        replace_groups.add(new_curr & GROUP_NUMBER_MASK)
                    else:
                        curr = new_curr
                    found = True

        if (curr & GROUP_NOT_EXACT_WORD_MASK) == 0:
            has_match = True
        if has_match:
            curr &= ~GROUP_NOT_EXACT_WORD_MASK

        for gr in replace_groups:
            if gr in self.replaces:
                if self.replaces[gr] != curr:
                    raise ValueError("duplicate replaces")
            else:
                self.replaces[gr] = curr

        for word in grouplist:
            stemme = self._stem(word)
            if stemme not in self.words:
                self.words[stemme] = curr
            elif has_match and (self.words[stemme] & GROUP_NOT_EXACT_WORD_MASK):
                self.words[stemme] = curr & ~GROUP_NOT_EXACT_WORD_MASK

        self._next_group += 1

    def build(self, outfile) -> None:
        close = False
        if isinstance(outfile, (str, os.PathLike)):
            outfile = open(outfile, "wb")
            close = True
        try:
            for word in sorted(self.words):
                data = word.encode("utf-8")
                _write_7bit_len(outfile, len(data))
                outfile.write(data)
                grp = self.words[word]
                grp = self.replaces.get(grp, grp)
                outfile.write(int(grp).to_bytes(4, "little", signed=True))
        finally:
            if close:
                outfile.close()


def build_freelib_voc(folder: str, outfile: str) -> None:
    """Build an English voc from FreeLing 'word lemma TAG' dictionaries
    (ref Dict.cs:260-296; source files live in Dict/en of the reference)."""
    builder = VocBuilder(stemmer=stemmers.stem_en)
    for fname in sorted(os.listdir(folder)):
        path = os.path.join(folder, fname)
        if not os.path.isfile(path):
            continue
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) >= 2 and parts[0] and parts[1]:
                    builder.add_words_group(parts[:2])
    builder.build(outfile)


def build_opencorpora_voc(xml_file: str, outfile: str) -> None:
    """Build the Russian voc from an OpenCorpora XML dump
    (ref Dict.cs:214-258)."""
    import xml.etree.ElementTree as ET

    builder = VocBuilder(stemmer=stemmers.stem_ru)
    group: list[str] = []
    for event, elem in ET.iterparse(xml_file, events=("start", "end")):
        if event == "start" and elem.tag == "lemma":
            group = []
        elif event == "end":
            if elem.tag == "lemma":
                builder.add_words_group(group)
                elem.clear()
            elif elem.tag in ("l", "f"):
                t = elem.get("t")
                if t:
                    group.append(t)
    builder.build(outfile)


def load_stop_words(path: str) -> set:
    """Stop-word list: the non-empty lines that hold no ';' (ref
    Index.cs:227-230)."""
    out = set()
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            s = line.strip("\r\n")
            if s.strip(" ") and ";" not in s:
                out.add(s)
    return out
