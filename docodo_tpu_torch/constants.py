"""The engine constants the port's host build reads (copied from
docodo_tpu/constants.py, which mirrors the reference's Index.cs:96-115)."""

MAX_WORD_LENGTH = 32          # maximum word length indexed (ref Index.cs:97)
MIN_WORD_LENGTH = 3           # minimum word length indexed (ref Index.cs:113)

# key prefixes in the term dictionary (ref Index.cs:105-112)
WORD_STEM_CHAR = "$"          # prefix of stem-fallback keys
DOC_SEP = ":"                 # document-name-from-source separator in the page list
FIELD_NAME_CHAR = "&"         # prefix of header-field-name keys
