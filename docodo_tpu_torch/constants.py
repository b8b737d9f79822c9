"""The engine constants the port's host build and query engine read
(copied from docodo_tpu/constants.py, which mirrors the reference's
Index.cs:96-115)."""

MAX_WORD_LENGTH = 32          # maximum word length indexed (ref Index.cs:97)
MIN_WORD_LENGTH = 3           # minimum word length indexed (ref Index.cs:113)
MAX_LIKE_WORDS = 100          # wildcard expansion cap (ref Search.cs:158)
DEFAULT_DIST = 255            # a plain word's window is DEFAULT_DIST + its length
MAX_FOUND_PAGES = 30_000      # maximum output found pages (ref Index.cs:101)
MAX_FOUND_DOCS = 500          # maximum output found docs (ref Index.cs:102)
MAX_FOUND_PAGE_TEXT = 320     # snippet display length (ref Index.cs:103)
DOC_RANK_MULTIPLY = 10.0      # rank boost when found in header page "0" (ref Index.cs:115)

# key prefixes in the term dictionary (ref Index.cs:105-112)
WORD_STEM_CHAR = "$"          # prefix of stem-fallback keys
KNOWN_WORD_CHAR = "#"         # prefix of vocab-group keys (#HEX)
DOC_SEP = ":"                 # document-name-from-source separator in the page list
FIELD_NAME_CHAR = "&"         # prefix of header-field-name keys

# snippet highlight markers (ref Search.cs:26-27)
BEGIN_MATCHED_SYMBOL = "\u02cb"  # ˋ
END_MATCHED_SYMBOL = "\u02ca"    # ˊ

# morphological group ids of a vocabulary (ref Dict.cs)
GROUP_NOT_EXACT_WORD_MASK = 0x01000000
GROUP_NUMBER_MASK = 0x00FFFFFF
PAGE_SIZE = 3000              # text-file pagination (ref DataSources.cs:308)
MAX_TMP_INDEX_ITEMS = 1_000_001  # postings a builder holds before it spills (ref Index.cs:96)
