"""Word -> index-key coding: docodo_tpu/lang/wordcodes.py's WordCoder
(ref Docodo.NET/Build.cs:175-247), with its quirks:

* a word starting with an ASCII digit maps to itself only;
* stop words map to no keys at all;
* the full form is always a key; every vocabulary whose first-letter
  range covers the word and knows its stem adds a '#HEX' group key (hex
  of (vocabulary index << 24) | (group & 0xFFFFFF), uppercase, unpadded);
* the last evaluated vocabulary lookup decides whether the word is
  known: if a later vocabulary's range matches but its lookup misses,
  the word gets the '$stem' fallback key, with the stem of the FIRST
  vocabulary iteration;
* the stemmer table is consulted only when NO vocabularies are loaded:
  the first stemmer whose character range covers the whole word adds a
  '$stem' key when the stem differs from the word.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from docodo_tpu_torch.constants import (
    GROUP_NUMBER_MASK,
    KNOWN_WORD_CHAR,
    WORD_STEM_CHAR,
)
from docodo_tpu_torch.lang import stemmers


def from_int(i: int) -> str:
    """'#' + uppercase hex, no leading zeros (ref Index.cs:196)."""
    return KNOWN_WORD_CHAR + format(i, "X")


class WordCoder:
    """Codes of words under a list of vocabularies (a None entry keeps
    its index and matches nothing) and a set of stop words, cached per
    word."""

    def __init__(self, vocs: Sequence = (),
                 stop_words: Optional[set] = None):
        self.vocs = list(vocs)
        self.stop_words = stop_words if stop_words is not None else set()
        self._stemmers = [(fn, re.compile(f"[^{rng}]"))
                          for _lang, fn, rng in stemmers.KNOWN_STEMMERS]
        self._cache: dict = {}

    def codes(self, word: str) -> Tuple[str, ...]:
        """Index keys for a (lowercase) word; () for a stop word."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        out = self._codes_uncached(word)
        if len(self._cache) < 1_000_000:
            self._cache[word] = out
        return out

    def _codes_uncached(self, word: str) -> Tuple[str, ...]:
        if not word:
            return ()
        if "0" <= word[0] <= "9":
            return (word,)
        if word in self.stop_words:
            return ()
        keys: List[str] = [word]
        stemmed = word
        first_stemmed = ""
        n_g = 0
        for n_voc, voc in enumerate(self.vocs):
            if voc is not None and voc.range[0] <= word[0] <= voc.range[1]:
                stemmed = voc.stem(word)
                n_g = voc.search(stemmed)
                if n_g != 0:
                    keys.append(from_int((n_voc << 24)
                                         | (n_g & GROUP_NUMBER_MASK)))
            if not first_stemmed:
                first_stemmed = stemmed
        if n_g == 0:
            stemmed = first_stemmed
            if not self.vocs:
                for fn, neg_re in self._stemmers:
                    if not neg_re.search(word):
                        if fn is not None:
                            stemmed = fn(word)
                        break
            if stemmed and stemmed != word:
                keys.append(WORD_STEM_CHAR + stemmed)
        return tuple(keys)


_PLAIN = WordCoder()


def codes(word: str) -> Tuple[str, ...]:
    """Index keys for a (lowercase) word without vocabularies or stop
    words."""
    return _PLAIN.codes(word)
