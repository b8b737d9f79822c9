"""Snowball stemmers (English/Porter2, Russian, German, French): the
pure-Python stemmers of docodo_tpu/lang/stemmers.py, copied for the port's
own host build, the per-word English stemmer of its native library
(stem_en takes it for the words it covers) and its bulk English and
Russian stemmers (stem_en_bulk, stem_ru_bulk: one C call for many words,
each result equal to the per-word Python stemmer's).

Pure-Python implementations of the published Snowball algorithms, matching
the stemmer family the reference links via the Iveonik.Stemmers NuGet
package (ref: Docodo.NET/Index.cs:175-183). The English implementation is
validated in tests against the shipped Dict/en.voc artifact: its key set is
exactly {stem(w)} over the FreeLing dictionaries, so any divergence from the
reference stemmer shows up as a key-set diff.

Stemmers here are plain functions (str -> str), assumed lowercase input —
thread-safe by construction, no locking needed (the reference wraps its
stemmers in a lock, ref Index.cs:158-173).
"""

from __future__ import annotations

import ctypes
import threading

__all__ = ["stem_en", "stem_ru", "stem_de", "stem_fr", "stem_en_bulk",
           "stem_ru_bulk", "KNOWN_STEMMERS", "BULK_STEMMERS"]


# =========================================================================
# English (Porter2)
# =========================================================================

_EN_VOWELS = frozenset("aeiouy")
_EN_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_EN_LI_ENDING = frozenset("cdeghkmnrt")

_EN_EXCEPTIONS = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
}
_EN_INVARIANTS = frozenset(
    ["sky", "news", "howe", "atlas", "cosmos", "bias", "andes"]
)
_EN_EXCEPTIONS2 = frozenset(
    ["inning", "outing", "canning", "herring", "earring",
     "proceed", "exceed", "succeed"]
)


def _en_is_vowel(word, i):
    return word[i] in "aeiouy"  # NB: 'Y' marker is a consonant


def _en_r1(word):
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            return len(prefix)
    return _region_after_vc(word, 0, _EN_VOWELS)


def _region_after_vc(word, start, vowels):
    """Position after the first non-vowel following a vowel, from `start`."""
    n = len(word)
    i = start
    while i < n and word[i] not in vowels:
        i += 1
    while i < n and word[i] in vowels:
        i += 1
    return min(i + 1, n) if i < n else n


def _en_short_syllable_at_end(word):
    n = len(word)
    if n >= 3:
        a, b, c = word[n - 3], word[n - 2], word[n - 1]
        if (b in "aeiouy" and c not in "aeiouy" and c not in "wxY"
                and a not in "aeiouy"):
            return True
    if n == 2 and word[0] in "aeiouy" and word[1] not in "aeiouy":
        return True
    return False


_tls = threading.local()


def _native_stem_en(word: str):
    """The native library's Porter2 (docodo_stem_en) for a word it
    covers, ASCII of at most 60 characters; None for any other word. A
    thread keeps one output buffer."""
    try:
        raw = word.encode("ascii")
    except UnicodeEncodeError:
        return None
    from docodo_tpu_torch.native import get_lib

    buf = getattr(_tls, "buf", None)
    if buf is None:
        buf = _tls.buf = ctypes.create_string_buffer(96)
    n = get_lib().docodo_stem_en(raw, len(raw), buf)
    if n < 0:
        return None
    return buf.raw[:n].decode("ascii")


def stem_en(word: str) -> str:
    """Porter2 / Snowball English stemmer: the native one where it covers
    the word (ASCII, at most 60 characters), else the Python one; both
    give the same stem."""
    ns = _native_stem_en(word)
    if ns is not None:
        return ns
    return _stem_en_py(word)


def _stem_en_py(word: str) -> str:
    """Pure-Python Porter2."""
    if len(word) <= 2:
        return word
    if word in _EN_EXCEPTIONS:
        return _EN_EXCEPTIONS[word]
    if word in _EN_INVARIANTS:
        return word

    if word.startswith("'"):
        word = word[1:]
    # mark consonant-y
    if word.startswith("y"):
        word = "Y" + word[1:]
    chars = list(word)
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in "aeiouy":
            chars[i] = "Y"
    word = "".join(chars)

    r1 = _en_r1(word)
    r2 = _region_after_vc(word, r1, _EN_VOWELS)

    # step 0: longest of ' 's 's'
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word = word[: -len(suf)]
            break

    # step 1a
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith(("ied", "ies")):
        word = word[:-3] + ("i" if len(word) > 4 else "ie")
    elif word.endswith(("us", "ss")):
        pass
    elif word.endswith("s"):
        if any(ch in "aeiouy" for ch in word[:-2]):
            word = word[:-1]

    if word in _EN_EXCEPTIONS2:
        return word.replace("Y", "y")

    # step 1b
    suf = next(
        (s for s in ("eedly", "ingly", "edly", "eed", "ing", "ed")
         if word.endswith(s)),
        None,
    )
    if suf in ("eed", "eedly"):
        if len(word) - len(suf) >= r1:
            word = word[: -len(suf)] + "ee"
    elif suf is not None:
        stem = word[: -len(suf)]
        if any(ch in "aeiouy" for ch in stem):
            word = stem
            if word.endswith(("at", "bl", "iz")):
                word += "e"
            elif word.endswith(_EN_DOUBLES):
                word = word[:-1]
            elif r1 >= len(word) and _en_short_syllable_at_end(word):
                word += "e"

    # step 1c
    if (len(word) > 2 and word[-1] in "yY"
            and word[-2] not in "aeiouy"):
        word = word[:-1] + "i"

    # step 2 (suffix must lie in R1)
    step2 = (
        ("ization", "ize"), ("ational", "ate"), ("fulness", "ful"),
        ("ousness", "ous"), ("iveness", "ive"), ("tional", "tion"),
        ("biliti", "ble"), ("lessli", "less"), ("entli", "ent"),
        ("ation", "ate"), ("alism", "al"), ("aliti", "al"),
        ("ousli", "ous"), ("iviti", "ive"), ("fulli", "ful"),
        ("enci", "ence"), ("anci", "ance"), ("abli", "able"),
        ("izer", "ize"), ("ator", "ate"), ("alli", "al"),
        ("bli", "ble"), ("ogi", None), ("li", None),
    )
    for suf, rep in step2:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                if suf == "ogi":
                    if word.endswith("logi"):
                        word = word[:-1]
                elif suf == "li":
                    if len(word) >= 3 and word[-3] in _EN_LI_ENDING:
                        word = word[:-2]
                else:
                    word = word[: -len(suf)] + rep
            break

    # step 3 (suffix in R1; 'ative' needs R2)
    step3 = (
        ("ational", "ate"), ("tional", "tion"), ("alize", "al"),
        ("icate", "ic"), ("iciti", "ic"), ("ative", ""),
        ("ical", "ic"), ("ness", ""), ("ful", ""),
    )
    for suf, rep in step3:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                if suf == "ative":
                    if len(word) - len(suf) >= r2:
                        word = word[: -len(suf)]
                else:
                    word = word[: -len(suf)] + rep
            break

    # step 4 (suffix in R2)
    step4 = (
        "ement", "ance", "ence", "able", "ible", "ment",
        "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
        "ion", "al", "er", "ic",
    )
    for suf in step4:
        if word.endswith(suf):
            if len(word) - len(suf) >= r2:
                if suf == "ion":
                    if len(word) >= 4 and word[-4] in "st":
                        word = word[:-3]
                else:
                    word = word[: -len(suf)]
            break

    # step 5
    if word.endswith("e"):
        if len(word) - 1 >= r2 or (
            len(word) - 1 >= r1
            and not _en_short_syllable_at_end(word[:-1])
        ):
            word = word[:-1]
    elif word.endswith("l"):
        if len(word) - 1 >= r2 and len(word) >= 2 and word[-2] == "l":
            word = word[:-1]

    return word.replace("Y", "y")


# =========================================================================
# Russian (Snowball)
# =========================================================================

_RU_VOWELS = frozenset("аеиоуыэюя")

_RU_PERFECTIVE_GERUND_1 = ("вшись", "вши", "в")          # preceded by а/я
_RU_PERFECTIVE_GERUND_2 = ("ившись", "ывшись", "ивши", "ывши", "ив", "ыв")
_RU_ADJECTIVE = (
    "ими", "ыми", "его", "ого", "ему", "ому",
    "ее", "ие", "ые", "ое", "ей", "ий", "ый", "ой", "ем", "им",
    "ым", "ом", "их", "ых", "ую", "юю", "ая", "яя", "ою", "ею",
)
_RU_PARTICIPLE_1 = ("ем", "нн", "вш", "ющ", "щ")          # preceded by а/я
_RU_PARTICIPLE_2 = ("ивш", "ывш", "ующ")
_RU_REFLEXIVE = ("ся", "сь")
_RU_VERB_1 = (  # preceded by а/я
    "ешь", "нно", "ете", "йте", "ла", "на", "ли", "ем", "ло", "но",
    "ет", "ют", "ны", "ть", "й", "л", "н",
)
_RU_VERB_2 = (
    "ейте", "уйте", "ила", "ыла", "ена", "ите", "или", "ыли", "ило",
    "ыло", "ено", "ует", "уют", "ены", "ить", "ыть", "ишь",
    "ей", "уй", "ил", "ыл", "им", "ым", "ен", "ят", "ит", "ыт",
    "ую", "ю",
)
_RU_NOUN = (
    "иями", "ями", "ами", "ией", "иям", "ием", "иях",
    "ев", "ов", "ие", "ье", "еи", "ии", "ей", "ой", "ий",
    "ям", "ем", "ам", "ом", "ах", "ях", "ию", "ью", "ия", "ья",
    "а", "е", "и", "й", "о", "у", "ы", "ь", "ю", "я",
)
_RU_SUPERLATIVE = ("ейше", "ейш")


def _ru_rv_r2(word):
    n = len(word)
    rv = n
    for i, ch in enumerate(word):
        if ch in _RU_VOWELS:
            rv = i + 1
            break
    r1 = _region_after_vc(word, 0, _RU_VOWELS)
    r2 = _region_after_vc(word, r1, _RU_VOWELS)
    return rv, r2


def _ru_ends(word, rv, suffixes, preceded_ay=False):
    """Longest suffix from `suffixes` lying fully inside RV; with
    preceded_ay the char before the suffix must be а/я (and inside RV)."""
    for suf in suffixes:
        if word.endswith(suf) and len(word) - len(suf) >= rv:
            if preceded_ay:
                i = len(word) - len(suf) - 1
                if i >= rv and word[i] in "ая":
                    return suf
            else:
                return suf
    return None


def stem_ru(word: str) -> str:
    """Snowball Russian stemmer (assumes lowercase; ё folded to е)."""
    word = word.replace("ё", "е")
    rv, r2 = _ru_rv_r2(word)
    if rv >= len(word):
        return word

    # step 1: perfective gerund, else [reflexive] + adjectival|verb|noun
    suf = _ru_ends(word, rv, _RU_PERFECTIVE_GERUND_2)
    if suf is None:
        suf = _ru_ends(word, rv, _RU_PERFECTIVE_GERUND_1, preceded_ay=True)
    if suf is not None:
        word = word[: -len(suf)]
    else:
        rsuf = _ru_ends(word, rv, _RU_REFLEXIVE)
        if rsuf is not None:
            word = word[: -len(rsuf)]
        asuf = _ru_ends(word, rv, _RU_ADJECTIVE)
        if asuf is not None:
            word = word[: -len(asuf)]
            psuf = _ru_ends(word, rv, _RU_PARTICIPLE_2)
            if psuf is None:
                psuf = _ru_ends(word, rv, _RU_PARTICIPLE_1, preceded_ay=True)
            if psuf is not None:
                word = word[: -len(psuf)]
        else:
            vsuf = _ru_ends(word, rv, _RU_VERB_2)
            if vsuf is None:
                vsuf = _ru_ends(word, rv, _RU_VERB_1, preceded_ay=True)
            if vsuf is not None:
                word = word[: -len(vsuf)]
            else:
                nsuf = _ru_ends(word, rv, _RU_NOUN)
                if nsuf is not None:
                    word = word[: -len(nsuf)]

    # step 2: trailing и
    if word.endswith("и") and len(word) - 1 >= rv:
        word = word[:-1]

    # step 3: derivational (ость/ост) in R2
    for dsuf in ("ость", "ост"):
        if word.endswith(dsuf) and len(word) - len(dsuf) >= r2:
            word = word[: -len(dsuf)]
            break

    # step 4: нн | superlative [нн] | ь
    if word.endswith("нн") and len(word) - 1 >= rv:
        word = word[:-1]
    else:
        ssuf = _ru_ends(word, rv, _RU_SUPERLATIVE)
        if ssuf is not None:
            word = word[: -len(ssuf)]
            if word.endswith("нн") and len(word) - 1 >= rv:
                word = word[:-1]
        elif word.endswith("ь") and len(word) - 1 >= rv:
            word = word[:-1]
    return word


# =========================================================================
# bulk stemming through the native library
# =========================================================================

def _bulk(entry: str, words, encoding: str, grow: int, fallback):
    """Stem `words` in one call of the native `entry`, on their bytes in
    a one-byte `encoding` (so byte offsets are character offsets). A word
    the encoding lacks, or that the C stemmer declines (length -1), takes
    `fallback`. `grow` bounds how many bytes a stem may add to its word."""
    import ctypes

    import numpy as np

    from docodo_tpu_torch.native import get_lib

    words = list(words)
    try:
        blob = "".join(words).encode(encoding)
        covered = list(range(len(words)))
        lens = np.fromiter((len(w) for w in words), np.int32, len(words))
    except UnicodeEncodeError:
        raws = []
        for w in words:
            try:
                raws.append(w.encode(encoding))
            except UnicodeEncodeError:
                raws.append(None)
        covered = [i for i, r in enumerate(raws) if r is not None]
        lens = np.fromiter((len(raws[i]) for i in covered), np.int32,
                           len(covered))
        blob = b"".join(raws[i] for i in covered)
    out_blob = ctypes.create_string_buffer(len(blob) + grow * len(covered)
                                           + 8)
    out_lens = np.empty(max(len(covered), 1), dtype=np.int32)
    total = getattr(get_lib(), entry)(
        blob, lens.ctypes.data_as(ctypes.c_void_p), len(covered), out_blob,
        out_lens.ctypes.data_as(ctypes.c_void_p))
    stems = out_blob.raw[:total].decode(encoding)
    out = [None] * len(words)
    pos = 0
    for i, n in zip(covered, out_lens[:len(covered)].tolist()):
        if n >= 0:
            out[i] = stems[pos: pos + n]
            pos += n
    return [fallback(w) if o is None else o for w, o in zip(words, out)]


def stem_en_bulk(words):
    """stem_en of many words in one native call; non-ASCII words and
    words over 60 characters take the Python stemmer."""
    return _bulk("docodo_stem_en_bulk", words, "ascii", 2, _stem_en_py)


def stem_ru_bulk(words):
    """stem_ru of many words in one native call on their cp1251 bytes;
    words outside cp1251 take the Python stemmer."""
    return _bulk("docodo_stem_ru_bulk", words, "cp1251", 0, stem_ru)


# =========================================================================
# German (Snowball)
# =========================================================================

_DE_VOWELS = frozenset("aeiouyäöü")
_DE_S_ENDING = frozenset("bdfghklmnrt")
_DE_ST_ENDING = frozenset("bdfghklmnt")


def stem_de(word: str) -> str:
    """Snowball German stemmer (assumes lowercase)."""
    word = word.replace("ß", "ss")
    chars = list(word)
    n = len(chars)
    for i in range(1, n - 1):
        if chars[i] == "u" and chars[i - 1] in _DE_VOWELS and chars[i + 1] in _DE_VOWELS:
            chars[i] = "U"
        if chars[i] == "y" and chars[i - 1] in _DE_VOWELS and chars[i + 1] in _DE_VOWELS:
            chars[i] = "Y"
    word = "".join(chars)

    r1_raw = _region_after_vc(word, 0, _DE_VOWELS)
    # R1 is adjusted so at least 3 letters precede it (snowball german spec)
    r1 = max(r1_raw, 3)
    r2 = _region_after_vc(word, r1_raw, _DE_VOWELS)

    def in_r1(pos):
        return pos >= r1

    def in_r2(pos):
        return pos >= r2

    # step 1
    done = False
    for suf in ("ern", "em", "er"):
        if word.endswith(suf):
            if in_r1(len(word) - len(suf)):
                word = word[: -len(suf)]
            done = True
            break
    if not done:
        for suf in ("en", "es", "e"):
            if word.endswith(suf):
                if in_r1(len(word) - len(suf)):
                    word = word[: -len(suf)]
                    if word.endswith("niss"):
                        word = word[:-1]
                done = True
                break
    if not done and word.endswith("s"):
        if in_r1(len(word) - 1) and len(word) >= 2 and word[-2] in _DE_S_ENDING:
            word = word[:-1]

    # step 2
    done = False
    for suf in ("est", "en", "er"):
        if word.endswith(suf):
            if in_r1(len(word) - len(suf)):
                word = word[: -len(suf)]
            done = True
            break
    if not done and word.endswith("st"):
        if (in_r1(len(word) - 2) and len(word) >= 6
                and word[-3] in _DE_ST_ENDING):
            word = word[:-2]

    # step 3: d-suffixes
    if word.endswith(("end", "ung")):
        pos = len(word) - 3
        if in_r2(pos):
            word = word[:pos]
            if word.endswith("ig") and in_r2(len(word) - 2) and (
                len(word) < 3 or word[-3] != "e"
            ):
                word = word[:-2]
    elif word.endswith(("isch",)):
        pos = len(word) - 4
        if in_r2(pos) and (pos == 0 or word[pos - 1] != "e"):
            word = word[:pos]
    elif word.endswith(("ig", "ik")):
        pos = len(word) - 2
        if in_r2(pos) and (pos == 0 or word[pos - 1] != "e"):
            word = word[:pos]
    elif word.endswith(("lich", "heit")):
        pos = len(word) - 4
        if in_r2(pos):
            word = word[:pos]
            for s2 in ("er", "en"):
                if word.endswith(s2) and in_r1(len(word) - 2):
                    word = word[:-2]
                    break
    elif word.endswith("keit"):
        pos = len(word) - 4
        if in_r2(pos):
            word = word[:pos]
            if word.endswith("lich") and in_r2(len(word) - 4):
                word = word[:-4]
            elif word.endswith("ig") and in_r2(len(word) - 2):
                word = word[:-2]

    word = word.replace("U", "u").replace("Y", "y")
    word = (
        word.replace("ä", "a").replace("ö", "o").replace("ü", "u")
    )
    return word


# =========================================================================
# French (Snowball)
# =========================================================================

_FR_VOWELS = frozenset("aeiouyâàëéêèïîôûù")


def _fr_mark_regions(word):
    n = len(word)
    # RV
    if n >= 3 and word[0] in _FR_VOWELS and word[1] in _FR_VOWELS:
        rv = 3
    elif word[:3] in ("par", "col", "tap"):
        rv = 3
    else:
        rv = n
        for i in range(1, n):
            if word[i] in _FR_VOWELS:
                rv = i + 1
                break
    r1 = _region_after_vc(word, 0, _FR_VOWELS)
    r2 = _region_after_vc(word, r1, _FR_VOWELS)
    return rv, r1, r2


def stem_fr(word: str) -> str:  # noqa: C901 — faithful rendering of the spec
    """Snowball French stemmer (assumes lowercase)."""
    chars = list(word)
    n = len(chars)
    for i in range(n):
        c = chars[i]
        prev_v = i > 0 and chars[i - 1].lower() in _FR_VOWELS
        next_v = i + 1 < n and chars[i + 1] in _FR_VOWELS
        if c in "ui" and prev_v and next_v:
            chars[i] = c.upper()
        elif c == "y" and (prev_v or next_v):
            chars[i] = "Y"
        elif c == "u" and i > 0 and chars[i - 1] == "q":
            chars[i] = "U"
    word = "".join(chars)
    rv, r1, r2 = _fr_mark_regions(word)

    def in_rv(pos):
        return pos >= rv

    def in_r1(pos):
        return pos >= r1

    def in_r2(pos):
        return pos >= r2

    step1_done = False
    rm_step1_mandatory_2a = False  # amment/emment/ment(s) removed

    w = word
    # ---- step 1: standard suffix removal (longest match governs) ----------
    sufs = sorted(
        [
            "ance", "iqUe", "isme", "able", "iste", "eux", "ances", "iqUes",
            "ismes", "ables", "istes",
            "atrice", "ateur", "ation", "atrices", "ateurs", "ations",
            "logie", "logies", "usion", "ution", "usions", "utions",
            "ence", "ences", "ement", "ements", "ité", "ités",
            "if", "ive", "ifs", "ives", "eaux", "aux", "euse", "euses",
            "issement", "issements", "amment", "emment", "ment", "ments",
        ],
        key=len,
        reverse=True,
    )
    match = next((s for s in sufs if w.endswith(s)), None)
    if match:
        pos = len(w) - len(match)
        if match in ("ance", "iqUe", "isme", "able", "iste", "eux",
                     "ances", "iqUes", "ismes", "ables", "istes"):
            if in_r2(pos):
                w = w[:pos]
                step1_done = True
        elif match in ("atrice", "ateur", "ation", "atrices", "ateurs",
                       "ations"):
            if in_r2(pos):
                w = w[:pos]
                step1_done = True
                if w.endswith("ic"):
                    if in_r2(len(w) - 2):
                        w = w[:-2]
                    else:
                        w = w[:-2] + "iqU"
        elif match in ("logie", "logies"):
            if in_r2(pos):
                w = w[: pos + 3]  # keep "log"
                step1_done = True
        elif match in ("usion", "ution", "usions", "utions"):
            if in_r2(pos):
                w = w[: pos + 1]  # keep "u"
                step1_done = True
        elif match in ("ence", "ences"):
            if in_r2(pos):
                w = w[:pos] + "ent"
                step1_done = True
        elif match in ("ement", "ements"):
            if in_rv(pos):
                w = w[:pos]
                step1_done = True
            if step1_done:
                if w.endswith("iv") and in_r2(len(w) - 2):
                    w = w[:-2]
                    if w.endswith("at") and in_r2(len(w) - 2):
                        w = w[:-2]
                elif w.endswith("eus"):
                    p = len(w) - 3
                    if in_r2(p):
                        w = w[:p]
                    elif in_r1(p):
                        w = w[:p] + "eux"
                elif w.endswith(("abl", "iqU")):
                    if in_r2(len(w) - 3):
                        w = w[:-3]
                elif w.endswith(("ièr", "Ièr")):
                    if in_rv(len(w) - 3):
                        w = w[:-3] + "i"
        elif match in ("ité", "ités"):
            if in_r2(pos):
                w = w[:pos]
                step1_done = True
                if w.endswith("abil"):
                    p = len(w) - 4
                    w = w[:p] if in_r2(p) else w[:p] + "abl"
                elif w.endswith("ic"):
                    p = len(w) - 2
                    w = w[:p] if in_r2(p) else w[:p] + "iqU"
                elif w.endswith("iv") and in_r2(len(w) - 2):
                    w = w[:-2]
        elif match in ("if", "ive", "ifs", "ives"):
            if in_r2(pos):
                w = w[:pos]
                step1_done = True
                if w.endswith("at") and in_r2(len(w) - 2):
                    w = w[:-2]
                    if w.endswith("ic"):
                        p = len(w) - 2
                        w = w[:p] if in_r2(p) else w[:p] + "iqU"
        elif match == "eaux":
            w = w[:-1]  # -> eau
            step1_done = True
        elif match == "aux":
            if in_r1(pos):
                w = w[:pos] + "al"
                step1_done = True
        elif match in ("euse", "euses"):
            if in_r2(pos):
                w = w[:pos]
                step1_done = True
            elif in_r1(pos):
                w = w[:pos] + "eux"
                step1_done = True
        elif match in ("issement", "issements"):
            if in_r1(pos) and pos > 0 and w[pos - 1] not in _FR_VOWELS:
                w = w[:pos]
                step1_done = True
        elif match == "amment":
            if in_rv(pos):
                w = w[:pos] + "ant"
                step1_done = True
                rm_step1_mandatory_2a = True
        elif match == "emment":
            if in_rv(pos):
                w = w[:pos] + "ent"
                step1_done = True
                rm_step1_mandatory_2a = True
        elif match in ("ment", "ments"):
            if pos > 0 and in_rv(pos - 1) and w[pos - 1] in _FR_VOWELS and in_rv(pos):
                w = w[:pos]
                step1_done = True
                rm_step1_mandatory_2a = True

    # ---- step 2a: verb suffixes beginning i --------------------------------
    do_2a = (not step1_done) or rm_step1_mandatory_2a
    step2_done = False
    if do_2a:
        sufs2a = sorted(
            ["îmes", "ît", "îtes", "i", "ie", "ies", "ir", "ira", "irai",
             "iraIent", "irais", "irait", "iras", "irent", "irez", "iriez",
             "irions", "irons", "iront", "is", "issaIent", "issais",
             "issait", "issant", "issante", "issantes", "issants", "isse",
             "issent", "isses", "issez", "issiez", "issions", "issons",
             "it"],
            key=len, reverse=True,
        )
        m2 = next((s for s in sufs2a if w.endswith(s)), None)
        if m2:
            pos = len(w) - len(m2)
            if (in_rv(pos) and pos > 0 and in_rv(pos - 1)
                    and w[pos - 1] not in _FR_VOWELS):
                w = w[:pos]
                step2_done = True
        # ---- step 2b --------------------------------------------------------
        if not step2_done:
            sufs2b = sorted(
                ["ions", "é", "ée", "ées", "és", "èrent", "er", "era",
                 "erai", "eraIent", "erais", "erait", "eras", "erez",
                 "eriez", "erions", "erons", "eront", "ez", "iez",
                 "â", "ât", "ants", "ante", "antes", "ant", "as", "asse",
                 "assent", "asses", "assiez", "assions", "a", "ai",
                 "aIent", "ais", "ait", "âmes", "âtes"],
                key=len, reverse=True,
            )
            m2 = next((s for s in sufs2b if w.endswith(s)), None)
            if m2:
                pos = len(w) - len(m2)
                if m2 == "ions":
                    if in_r2(pos):
                        w = w[:pos]
                        step2_done = True
                elif m2 in ("é", "ée", "ées", "és", "èrent", "er", "era",
                            "erai", "eraIent", "erais", "erait", "eras",
                            "erez", "eriez", "erions", "erons", "eront",
                            "ez", "iez"):
                    if in_rv(pos):
                        w = w[:pos]
                        step2_done = True
                else:
                    if in_rv(pos):
                        w = w[:pos]
                        step2_done = True
                        if w.endswith("e") and in_rv(len(w) - 1):
                            w = w[:-1]

    if step1_done or step2_done:
        # ---- step 3 --------------------------------------------------------
        if w.endswith("Y"):
            w = w[:-1] + "i"
        elif w.endswith("ç"):
            w = w[:-1] + "c"
    else:
        # ---- step 4: s-removal, then longest ONE of ion/ier|ière/e/guë -----
        if (w.endswith("s") and len(w) >= 2 and w[-2] not in "aiouès"):
            w = w[:-1]
        cands = []
        if w.endswith("ion") and in_r2(len(w) - 3):
            p = len(w) - 4
            if p >= 0 and w[p] in "st" and in_rv(p):
                cands.append(("ion", ""))
        for suf in ("ière", "Ière", "ier", "Ier"):
            if w.endswith(suf) and in_rv(len(w) - len(suf)):
                cands.append((suf, "i"))
                break
        if w.endswith("e") and in_rv(len(w) - 1):
            cands.append(("e", ""))
        if w.endswith("guë") and in_rv(len(w) - 1):
            cands.append(("ë", ""))
        if cands:
            suf, rep = max(cands, key=lambda c: len(c[0]))
            w = w[: -len(suf)] + rep

    # ---- step 5: undouble ---------------------------------------------------
    for suf in ("enn", "onn", "ett", "ell", "eill"):
        if w.endswith(suf):
            w = w[:-1]
            break

    # ---- step 6: un-accent --------------------------------------------------
    i = len(w) - 1
    seen_nonvowel = 0
    while i >= 0:
        if w[i] in _FR_VOWELS:
            break
        seen_nonvowel += 1
        i -= 1
    if i >= 0 and seen_nonvowel >= 1 and w[i] in "éè":
        w = w[:i] + "e" + w[i + 1:]

    return w.replace("I", "i").replace("U", "u").replace("Y", "y")


# =========================================================================
# stemmer table (ref Index.cs:175-183): (lang, stemmer, fullmatch range)
# =========================================================================

KNOWN_STEMMERS = [
    ("digit", None, "0-9"),
    ("ru", stem_ru, "а-яё"),
    ("en", stem_en, "a-z"),
    ("de", stem_de, "a-zẞäüö"),
    ("fr", stem_fr, "a-zéâàêèëçîïôûùüÿ"),
]

# per-word stemmer -> its bulk twin (the build stems new words in bulk)
BULK_STEMMERS = {stem_en: stem_en_bulk, stem_ru: stem_ru_bulk}


def get_stemmer(lang: str):
    for name, fn, _ in KNOWN_STEMMERS:
        if name == lang:
            return fn
    raise KeyError(f"no stemmer for language {lang!r}")
