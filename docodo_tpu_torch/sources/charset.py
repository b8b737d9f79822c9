"""Charset detection for text ingestion.

The port's copy of docodo_tpu/sources/charset.py.

The reference uses the Ude (Mozilla universal charset detector) NuGet
package plus Portable.Text.Encoding (ref
Docodo.NET/DataSources/DataSources.cs:357-379). This module
uses no detector library: it is a small self-contained detector covering the
encodings that actually occur in the supported corpora: BOM variants,
UTF-8 (validated), windows-1251 (Cyrillic heuristic), windows-1252 /
latin-1 fallback.
"""

from __future__ import annotations

_BOMS = [
    (b"\xef\xbb\xbf", "utf-8-sig"),
    (b"\xff\xfe\x00\x00", "utf-32-le"),
    (b"\x00\x00\xfe\xff", "utf-32-be"),
    (b"\xff\xfe", "utf-16-le"),
    (b"\xfe\xff", "utf-16-be"),
]


def _is_valid_utf8(data: bytes) -> bool:
    try:
        data.decode("utf-8", "strict")
        return True
    except UnicodeDecodeError:
        return False


def detect_encoding(data: bytes) -> str:
    """Best-effort encoding name for a byte buffer (first ~64 KB used)."""
    head = data[:65536]
    for bom, enc in _BOMS:
        if head.startswith(bom):
            return enc
    if not head:
        return "utf-8"
    # UTF-16 without BOM: the high byte of each code unit is 0x00 for
    # Latin text or a small constant (e.g. 0x04 for Cyrillic) — count
    # control-ish bytes per offset parity
    def _ctl(chunk: bytes) -> int:
        return sum(1 for b in chunk if b == 0 or 0x01 <= b <= 0x08)

    even_ctl, odd_ctl = _ctl(head[0::2]), _ctl(head[1::2])
    half = max(len(head) // 2, 1)
    if max(even_ctl, odd_ctl) > half // 2:
        return "utf-16-be" if even_ctl > odd_ctl else "utf-16-le"
    hi = [b for b in head if b >= 0x80]
    if not hi:
        return "ascii"
    # trailing bytes of a multi-byte char may be clipped; pad check window
    if _is_valid_utf8(head[: len(head) - 4] if len(head) == 65536 else head):
        return "utf-8"
    # windows-1251 vs -1252: both map 0xC0-0xFF to letters, so range alone
    # can't separate them. Cyrillic text is WHOLE words of high bytes
    # (runs), while western European text has isolated accents inside
    # ASCII words — classify by the fraction of high bytes whose neighbor
    # is also high.
    cyr = sum(1 for b in hi if 0xC0 <= b <= 0xFF or b in (0xA8, 0xB8))
    if cyr / len(hi) > 0.8:
        adjacent = sum(
            1 for i, b in enumerate(head)
            if b >= 0x80 and (
                (i > 0 and head[i - 1] >= 0x80)
                or (i + 1 < len(head) and head[i + 1] >= 0x80)
            )
        )
        if adjacent / len(hi) > 0.6:
            return "windows-1251"
    return "windows-1252"


def decode_bytes(data: bytes) -> str:
    """Decode with detection; never raises."""
    enc = detect_encoding(data)
    try:
        return data.decode(enc, "replace")
    except LookupError:
        return data.decode("utf-8", "replace")
