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

The build primes the cache with each batch of new words (prime), which
stems them in one native call.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Tuple

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

    def clear_cache(self) -> None:
        self._cache.clear()

    def codes(self, word: str) -> Tuple[str, ...]:
        """Index keys for a (lowercase) word; () for a stop word."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        out = self._codes_uncached(word)
        if len(self._cache) < 1_000_000:
            self._cache[word] = out
        return out

    def prime(self, words: Iterable[str]) -> None:
        """Fill the cache for new words, their stems in one native call
        (wordcodes.py:68): with vocabularies each one's bulk stemmer
        (Vocab.prime_stems) and the rest per word; without, the English
        and Russian stems in bulk. A word of ASCII letters can match only
        the "en" range of the stemmer table (digit-led words are left to
        codes(), "ru" needs Cyrillic, "de" and "fr" come after "en"), and
        any other ASCII word none, so those skip the range regexes."""
        todo = [w for w in words
                if w and w not in self._cache
                and not ("0" <= w[0] <= "9") and w not in self.stop_words]
        if not todo:
            return
        if self.vocs:
            for voc in self.vocs:
                if voc is not None:
                    voc.prime_stems(todo)
            return
        fns = []
        for w in todo:
            if w.isascii():
                fn = stemmers.stem_en if w.isalpha() and w.islower() else None
            else:
                fn = next((f for f, neg_re in self._stemmers
                           if not neg_re.search(w)), None)
            fns.append(fn)
        stems = {}
        for fn in (stemmers.stem_en, stemmers.stem_ru):
            group = [w for w, f in zip(todo, fns) if f is fn]
            stems.update(zip(group, stemmers.BULK_STEMMERS[fn](group)))
        if len(self._cache) + len(todo) > 1_000_000:
            return
        for w, fn in zip(todo, fns):
            stemmed = stems[w] if w in stems else fn(w) if fn else w
            self._cache[w] = ((w, WORD_STEM_CHAR + stemmed)
                              if stemmed and stemmed != w else (w,))

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
