"""Word -> index-key coding without vocabularies or stop words: the
no-vocabulary branch of docodo_tpu/lang/wordcodes.py's WordCoder (ref
Docodo.NET/Build.cs:175-247).

* a word starting with an ASCII digit maps to itself only;
* the full form is always a key; the first stemmer of the table whose
  character range covers the whole word adds a '$stem' key when the stem
  differs from the word.
"""

from __future__ import annotations

import re
from typing import Tuple

from docodo_tpu_torch.constants import WORD_STEM_CHAR
from docodo_tpu_torch.lang import stemmers

_STEMMERS = [(fn, re.compile(f"[^{rng}]"))
             for _lang, fn, rng in stemmers.KNOWN_STEMMERS]


def codes(word: str) -> Tuple[str, ...]:
    """Index keys for a (lowercase) word."""
    if not word:
        return ()
    if "0" <= word[0] <= "9":
        return (word,)
    stemmed = ""
    for fn, neg_re in _STEMMERS:
        if not neg_re.search(word):
            if fn is not None:
                stemmed = fn(word)
            break
    if stemmed and stemmed != word:
        return (word, WORD_STEM_CHAR + stemmed)
    return (word,)
