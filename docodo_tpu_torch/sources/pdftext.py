"""Pure-Python PDF text extraction.

The port's copy of docodo_tpu/sources/pdftext.py.

The reference delegates to PdfSharp + the PdfSharpTextExtractor submodule
(ref Docodo.NET/DataSources/DocumentDataSource.cs:27-117). This module uses
no PDF library: it implements the subset of
ISO 32000 a text indexer needs:

* a real COS object parser (dicts, arrays, names, refs, strings);
* stream filter chains: FlateDecode (+ PNG predictors), LZWDecode,
  ASCIIHexDecode, ASCII85Decode, RunLengthDecode;
* object streams (/ObjStm) — where modern writers put page dicts;
* encrypted documents via the Standard security handler: RC4 (R2/R3/R4)
  and AES-128 (/AESV2) with the empty user password, plus AES-256
  (R5/R6, /AESV3) including the revision-6 key-hardening hash;
* CID/Type0 composite fonts through their /ToUnicode CMaps (bfchar +
  bfrange, multi-byte code spaces), with per-page font resolution and
  inherited /Resources.

Anything unsupported degrades to empty text for that page rather than
failing the ingestion pipeline (parity with the reference's
catch-log-continue, ref Build.cs:537-540).
"""

from __future__ import annotations

import hashlib
import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b", re.S)
_STARTXREF_RE = re.compile(rb"startxref\s+(\d+)")
_STREAM_RE = re.compile(rb"stream\r?\n")


# ---------------------------------------------------------------------------
# COS object parser
# ---------------------------------------------------------------------------

class Ref:
    __slots__ = ("num", "gen")

    def __init__(self, num: int, gen: int = 0):
        self.num = num
        self.gen = gen

    def __repr__(self):
        return f"Ref({self.num},{self.gen})"

    def __eq__(self, other):
        return isinstance(other, Ref) and (self.num, self.gen) == (
            other.num, other.gen
        )

    def __hash__(self):
        return hash((self.num, self.gen))


class Name(str):
    """A /Name token (distinct from a text string)."""


_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


def _skip_ws(data: bytes, pos: int) -> int:
    n = len(data)
    while pos < n:
        c = data[pos]
        if c in _WS:
            pos += 1
        elif c == 0x25:  # % comment
            e = data.find(b"\n", pos)
            pos = len(data) if e < 0 else e + 1
        else:
            break
    return pos


def _parse_value(data: bytes, pos: int):
    """Parse one COS value at `pos`; returns (value, next_pos).
    Strings parse to raw BYTES (decoding is a font/encoding decision)."""
    pos = _skip_ws(data, pos)
    if pos >= len(data):
        raise ValueError("eof")
    c = data[pos]
    if c == 0x2F:  # /Name
        m = re.match(rb"/([^\s()<>\[\]{}/%]*)", data[pos:])
        raw = m.group(1)
        # #xx escapes in names
        raw = re.sub(
            rb"#([0-9A-Fa-f]{2})",
            lambda mm: bytes([int(mm.group(1), 16)]), raw,
        )
        return Name(raw.decode("latin-1")), pos + m.end()
    if data.startswith(b"<<", pos):
        pos += 2
        out = {}
        while True:
            pos = _skip_ws(data, pos)
            if data.startswith(b">>", pos):
                return out, pos + 2
            key, pos = _parse_value(data, pos)
            if not isinstance(key, Name):
                raise ValueError("dict key is not a name")
            val, pos = _parse_value(data, pos)
            out[str(key)] = val
    if c == 0x3C:  # <hex string>
        e = data.find(b">", pos)
        if e < 0:
            raise ValueError("unterminated hex string")
        hx = re.sub(rb"[^0-9A-Fa-f]", b"", data[pos + 1: e])
        if len(hx) % 2:
            hx += b"0"
        return bytes.fromhex(hx.decode("ascii")), e + 1
    if c == 0x5B:  # [ array ]
        pos += 1
        out = []
        while True:
            pos = _skip_ws(data, pos)
            if pos < len(data) and data[pos] == 0x5D:
                return out, pos + 1
            val, pos = _parse_value(data, pos)
            out.append(val)
    if c == 0x28:  # ( literal string )
        return _parse_literal_string(data, pos)
    m = re.match(rb"(\d+)\s+(\d+)\s+R\b", data[pos:])
    if m:
        return Ref(int(m.group(1)), int(m.group(2))), pos + m.end()
    m = re.match(rb"[+-]?(?:\d+\.?\d*|\.\d+)", data[pos:])
    if m:
        tok = m.group(0)
        val = float(tok) if b"." in tok else int(tok)
        return val, pos + m.end()
    m = re.match(rb"true|false|null", data[pos:])
    if m:
        return {b"true": True, b"false": False, b"null": None}[m.group(0)], \
            pos + m.end()
    raise ValueError(f"bad token at {pos}: {data[pos:pos+12]!r}")


def _parse_literal_string(data: bytes, pos: int) -> Tuple[bytes, int]:
    """( ... ) with nesting and backslash escapes -> raw bytes."""
    assert data[pos] == 0x28
    out = bytearray()
    depth = 1
    i = pos + 1
    n = len(data)
    esc = {0x6E: 10, 0x72: 13, 0x74: 9, 0x62: 8, 0x66: 12,
           0x28: 40, 0x29: 41, 0x5C: 92}
    while i < n:
        c = data[i]
        if c == 0x5C and i + 1 < n:
            nxt = data[i + 1]
            if nxt in esc:
                out.append(esc[nxt])
                i += 2
                continue
            if 0x30 <= nxt <= 0x37:  # octal, 1-3 digits
                j = i + 1
                while j < n and j < i + 4 and 0x30 <= data[j] <= 0x37:
                    j += 1
                out.append(int(data[i + 1: j], 8) & 0xFF)
                i = j
                continue
            if nxt in (10, 13):  # line continuation
                i += 2
                if nxt == 13 and i < n and data[i] == 10:
                    i += 1
                continue
            out.append(nxt)
            i += 2
            continue
        if c == 0x28:
            depth += 1
        elif c == 0x29:
            depth -= 1
            if depth == 0:
                return bytes(out), i + 1
        out.append(c)
        i += 1
    raise ValueError("unterminated string")


# ---------------------------------------------------------------------------
# stream filters
# ---------------------------------------------------------------------------

def _png_predict(data: bytes, colors: int, bpc: int, columns: int) -> bytes:
    rowlen = (colors * bpc * columns + 7) // 8
    bpp = max(1, (colors * bpc + 7) // 8)
    out = bytearray()
    prev = bytearray(rowlen)
    pos = 0
    while pos + 1 <= len(data):
        ft = data[pos]
        row = bytearray(data[pos + 1: pos + 1 + rowlen])
        pos += 1 + rowlen
        if ft == 1:
            for i in range(bpp, len(row)):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ft == 2:
            for i in range(len(row)):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ft == 3:
            for i in range(len(row)):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:
            for i in range(len(row)):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                cc = prev[i - bpp] if i >= bpp else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                row[i] = (row[i] + pr) & 0xFF
        out.extend(row)
        prev = row
    return bytes(out)


def _lzw_decode(data: bytes) -> bytes:
    """LZWDecode (TIFF-style with EarlyChange=1, the PDF default)."""
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    bitbuf = bitcnt = 0
    width = 9
    prev: Optional[bytes] = None
    for byte in data:
        bitbuf = (bitbuf << 8) | byte
        bitcnt += 8
        while bitcnt >= width:
            code = (bitbuf >> (bitcnt - width)) & ((1 << width) - 1)
            bitcnt -= width
            if code == 256:
                table = [bytes([i]) for i in range(256)] + [b"", b""]
                width = 9
                prev = None
                continue
            if code == 257:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out.extend(entry)
            prev = entry
            if len(table) + 1 >= (1 << width) and width < 12:
                width += 1
    return bytes(out)


def _rl_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        l = data[i]
        if l == 128:
            break
        if l < 128:
            out.extend(data[i + 1: i + 2 + l])
            i += 2 + l
        else:
            out.extend(data[i + 1: i + 2] * (257 - l))
            i += 2
    return bytes(out)


def _a85_decode(data: bytes) -> bytes:
    import base64

    data = re.sub(rb"\s", b"", data)
    if data.endswith(b"~>"):
        data = data[:-2]
    return base64.a85decode(data)


def _apply_filters(sdict: dict, raw: bytes) -> bytes:
    filters = sdict.get("Filter")
    if filters is None:
        return raw
    if not isinstance(filters, list):
        filters = [filters]
    parms = sdict.get("DecodeParms") or sdict.get("DP")
    if not isinstance(parms, list):
        parms = [parms] * len(filters)
    for f, pm in zip(filters, parms):
        f = str(f)
        if f in ("FlateDecode", "Fl"):
            raw = zlib.decompress(raw)
        elif f in ("LZWDecode", "LZW"):
            raw = _lzw_decode(raw)
        elif f in ("ASCIIHexDecode", "AHx"):
            hx = re.sub(rb"[^0-9A-Fa-f]", b"", raw.split(b">")[0])
            if len(hx) % 2:
                hx += b"0"
            raw = bytes.fromhex(hx.decode("ascii"))
        elif f in ("ASCII85Decode", "A85"):
            raw = _a85_decode(raw)
        elif f in ("RunLengthDecode", "RL"):
            raw = _rl_decode(raw)
        elif f == "Crypt":
            continue  # handled by the encryption layer
        else:
            raise ValueError(f"unsupported filter {f}")
        if isinstance(pm, dict):
            pred = pm.get("Predictor", 1)
            if isinstance(pred, (int, float)) and pred >= 10:
                raw = _png_predict(
                    raw, int(pm.get("Colors", 1)),
                    int(pm.get("BitsPerComponent", 8)),
                    int(pm.get("Columns", 1)),
                )
    return raw


# ---------------------------------------------------------------------------
# encryption (Standard security handler)
# ---------------------------------------------------------------------------

_PAD = bytes([
    0x28, 0xBF, 0x4E, 0x5E, 0x4E, 0x75, 0x8A, 0x41, 0x64, 0x00, 0x4E, 0x56,
    0xFF, 0xFA, 0x01, 0x08, 0x2E, 0x2E, 0x00, 0xB6, 0xD0, 0x68, 0x3E, 0x80,
    0x2F, 0x0C, 0xA9, 0xFE, 0x64, 0x53, 0x69, 0x7A,
])


def _rc4(key: bytes, data: bytes) -> bytes:
    S = list(range(256))
    j = 0
    for i in range(256):
        j = (j + S[i] + key[i % len(key)]) & 0xFF
        S[i], S[j] = S[j], S[i]
    out = bytearray(len(data))
    i = j = 0
    for k, c in enumerate(data):
        i = (i + 1) & 0xFF
        j = (j + S[i]) & 0xFF
        S[i], S[j] = S[j], S[i]
        out[k] = c ^ S[(S[i] + S[j]) & 0xFF]
    return bytes(out)


def _aes_cbc_decrypt(key: bytes, data: bytes, iv: Optional[bytes] = None,
                     unpad: bool = True) -> bytes:
    from cryptography.hazmat.primitives.ciphers import (
        Cipher, algorithms, modes,
    )

    if iv is None:
        iv, data = data[:16], data[16:]
    if not data or len(data) % 16:
        return b""
    dec = Cipher(algorithms.AES(key), modes.CBC(iv)).decryptor()
    out = dec.update(data) + dec.finalize()
    if unpad and out:
        n = out[-1]
        if 1 <= n <= 16:
            out = out[:-n]
    return out


def _aes_cbc_encrypt_nopad(key: bytes, data: bytes, iv: bytes) -> bytes:
    from cryptography.hazmat.primitives.ciphers import (
        Cipher, algorithms, modes,
    )

    enc = Cipher(algorithms.AES(key), modes.CBC(iv)).encryptor()
    return enc.update(data) + enc.finalize()


def _hash_r6(password: bytes, salt: bytes, udata: bytes = b"") -> bytes:
    """ISO 32000-2 Algorithm 2.B (revision 6 key hardening)."""
    k = hashlib.sha256(password + salt + udata).digest()
    i = 0
    while True:
        k1 = (password + k + udata) * 64
        e = _aes_cbc_encrypt_nopad(k[:16], k1, k[16:32])
        mod = sum(e[:16]) % 3
        k = (hashlib.sha256, hashlib.sha384, hashlib.sha512)[mod](e).digest()
        i += 1
        if i >= 64 and e[-1] <= i - 32:
            return k[:32]


class _Encryption:
    """Per-document decryption state (Standard handler, empty user pw)."""

    def __init__(self, key: bytes, v: int, aes: bool):
        self.key = key
        self.v = v
        self.aes = aes

    @classmethod
    def create(cls, enc: dict, id0: bytes,
               password: bytes = b"") -> Optional["_Encryption"]:
        if str(enc.get("Filter", "")) != "Standard":
            return None
        v = int(enc.get("V", 0))
        r = int(enc.get("R", 2))
        o = _as_bytes(enc.get("O", b""))
        u = _as_bytes(enc.get("U", b""))
        p = int(enc.get("P", -1)) & 0xFFFFFFFF
        length = int(enc.get("Length", 40))
        if v >= 5:  # AES-256, R5/R6
            vsalt, ksalt = u[32:40], u[40:48]
            if r == 6:
                h = _hash_r6(password, vsalt, b"")
            else:
                h = hashlib.sha256(password + vsalt).digest()
            if h != u[:32]:
                # try the owner password slot with the same (empty) pw
                ovsalt, oksalt = o[32:40], o[40:48]
                oh = (_hash_r6(password, ovsalt, u[:48]) if r == 6 else
                      hashlib.sha256(password + ovsalt + u[:48]).digest())
                if oh != o[:32]:
                    return None  # password required
                ik = (_hash_r6(password, oksalt, u[:48]) if r == 6 else
                      hashlib.sha256(password + oksalt + u[:48]).digest())
                key = _aes_cbc_decrypt(
                    ik, _as_bytes(enc.get("OE", b"")), iv=b"\0" * 16,
                    unpad=False,
                )
            else:
                ik = (_hash_r6(password, ksalt, b"") if r == 6 else
                      hashlib.sha256(password + ksalt).digest())
                key = _aes_cbc_decrypt(
                    ik, _as_bytes(enc.get("UE", b"")), iv=b"\0" * 16,
                    unpad=False,
                )
            if len(key) < 32:  # truncated /UE//OE: AES(b"") would raise
                return None    # out of stream() — treat as undecryptable
            return cls(key[:32], v, aes=True)
        # V <= 4: RC4 / AES-128 file key (Algorithm 2)
        pw = (password + _PAD)[:32]
        h = hashlib.md5(pw + o[:32] + struct.pack("<I", p) + id0)
        if r >= 4 and enc.get("EncryptMetadata") is False:
            h.update(b"\xff\xff\xff\xff")
        key = h.digest()
        n = length // 8 if r >= 3 else 5
        if r >= 3:
            for _ in range(50):
                key = hashlib.md5(key[:n]).digest()
        key = key[:n]
        # Algorithm 4/5: validate the (empty-password) key against /U —
        # otherwise a genuinely password-protected document "decrypts"
        # to garbage and gets indexed instead of being skipped
        if r == 2:
            if _rc4(key, _PAD) != u[:32]:
                return None  # password required
        else:
            x = _rc4(key, hashlib.md5(_PAD + id0).digest())
            for i in range(1, 20):
                x = _rc4(bytes(b ^ i for b in key), x)
            if x[:16] != u[:16]:
                return None  # password required
        aes = False
        if v == 4:
            cf = enc.get("CF", {})
            stmf = str(enc.get("StmF", "Identity"))
            cfm = ""
            if isinstance(cf, dict) and stmf in cf and isinstance(
                cf[stmf], dict
            ):
                cfm = str(cf[stmf].get("CFM", ""))
            aes = cfm == "AESV2"
        return cls(key, v, aes)

    def decrypt(self, data: bytes, num: int, gen: int) -> bytes:
        if self.v >= 5:
            return _aes_cbc_decrypt(self.key, data)
        k = self.key + struct.pack("<I", num)[:3] + struct.pack("<I", gen)[:2]
        if self.aes:
            k += b"sAlT"
        ok = hashlib.md5(k).digest()[: min(len(self.key) + 5, 16)]
        return _aes_cbc_decrypt(ok, data) if self.aes else _rc4(ok, data)


def _as_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode("latin-1")
    return b""


# ---------------------------------------------------------------------------
# ToUnicode CMaps (CID/Type0 and simple fonts)
# ---------------------------------------------------------------------------

class _FontMap:
    __slots__ = ("cmap", "nbytes")

    def __init__(self, cmap: Dict[int, str], nbytes: int):
        self.cmap = cmap
        self.nbytes = nbytes

    def decode(self, raw: bytes) -> str:
        n = self.nbytes
        out = []
        for i in range(0, len(raw) - n + 1, n):
            code = int.from_bytes(raw[i: i + n], "big")
            s = self.cmap.get(code)
            if s is None:
                # unmapped code: keep 1-byte codes readable, drop wide ones
                s = chr(code) if n == 1 and 32 <= code < 127 else ""
            out.append(s)
        return "".join(out)


_CMAP_HEX = re.compile(rb"<([0-9A-Fa-f]+)>")


def _parse_tounicode(data: bytes) -> _FontMap:
    cmap: Dict[int, str] = {}
    nbytes = 0
    for m in re.finditer(
        rb"begincodespacerange(.*?)endcodespacerange", data, re.S
    ):
        for hx in _CMAP_HEX.finditer(m.group(1)):
            nbytes = max(nbytes, len(hx.group(1)) // 2)

    def uni(hx: bytes) -> str:
        b = bytes.fromhex(hx.decode("ascii"))
        if len(b) % 2:
            b = b"\0" + b
        return b.decode("utf-16-be", "replace")

    for m in re.finditer(rb"beginbfchar(.*?)endbfchar", data, re.S):
        toks = _CMAP_HEX.findall(m.group(1))
        for i in range(0, len(toks) - 1, 2):
            cmap[int(toks[i], 16)] = uni(toks[i + 1])
            nbytes = nbytes or len(toks[i]) // 2
    for m in re.finditer(rb"beginbfrange(.*?)endbfrange", data, re.S):
        body = m.group(1)
        pos = 0
        while True:
            mm = re.match(
                rb"\s*<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*", body[pos:]
            )
            if not mm:
                break
            lo, hi = int(mm.group(1), 16), int(mm.group(2), 16)
            nbytes = nbytes or len(mm.group(1)) // 2
            pos += mm.end()
            if body[pos: pos + 1] == b"[":
                end = body.find(b"]", pos)
                if end < 0:  # truncated array: find() returning -1 would
                    break    # reset the scan to 0 and loop forever
                dsts = _CMAP_HEX.findall(body[pos:end])
                for k, d in enumerate(dsts):
                    cmap[lo + k] = uni(d)
                pos = end + 1
            else:
                mm = re.match(rb"<([0-9A-Fa-f]+)>\s*", body[pos:])
                if not mm:
                    break
                base = uni(mm.group(1))
                pos += mm.end()
                for k in range(hi - lo + 1):
                    if base:
                        cmap[lo + k] = base[:-1] + chr(
                            ord(base[-1]) + k
                        )
    return _FontMap(cmap, nbytes or 1)


# ---------------------------------------------------------------------------
# document
# ---------------------------------------------------------------------------

class PdfDocument:
    def __init__(self, data: bytes, password: bytes = b""):
        self.data = data
        self.objects: Dict[int, bytes] = {}       # raw body bytes
        self._gens: Dict[int, int] = {}
        self._raw_streams: Dict[int, bytes] = {}
        self._parsed: Dict[int, object] = {}
        self._from_objstm: set = set()
        self._scan_objects()
        self._load_xref()
        self._crypt = self._setup_encryption(password)
        self._expand_object_streams()
        self.info = self._info()
        self.pages, self._page_resources = self._page_objects()

    # ---- object scan -----------------------------------------------------
    def _body_at(self, start: int):
        """Object body starting right after `N G obj`: returns
        (dict/body bytes, raw stream bytes or None)."""
        data = self.data
        end = data.find(b"endobj", start)
        if end < 0:
            end = len(data)
        body = data[start:end]
        sm = _STREAM_RE.search(body)
        if sm:
            raw = body[sm.end():]
            es = raw.rfind(b"endstream")
            if es >= 0:
                raw = raw[:es]
            # Keep raw bytes intact: binary stream data (e.g. AES
            # ciphertext) may legitimately end in 0x0a/0x0d. The EOL
            # before `endstream` is trimmed in stream() — by /Length
            # when present, by rstrip only as a fallback.
            return body[: sm.start()], raw
        return body, None

    def _scan_objects(self) -> None:
        data = self.data
        for m in _OBJ_RE.finditer(data):
            num = int(m.group(1))
            body, raw = self._body_at(m.end())
            self.objects[num] = body
            if raw is not None:
                self._raw_streams[num] = raw
            self._gens[num] = int(m.group(2))

    # ---- xref resolution -------------------------------------------------
    # The linear scavenger above handles damaged files and most real
    # incremental updates (last definition wins). When the file carries
    # a VALID xref chain, prefer it: an update can roll an object BACK
    # to an earlier offset, or reuse a freed object number with a
    # bumped generation — cases where "last definition in the file" is
    # the wrong object (ref DocumentDataSource.cs:27-117: PdfSharp
    # resolves objects through the xref machinery). Any parse hiccup
    # leaves the scavenger's result standing.
    def _load_xref(self) -> None:
        ms = list(_STARTXREF_RE.finditer(self.data))
        if not ms:
            return
        entries: Dict[int, Tuple[int, int]] = {}  # num -> (offset, gen)
        free: set = set()
        seen = set()
        off = int(ms[-1].group(1))
        for _ in range(64):  # bounded /Prev chain walk
            if off in seen or off <= 0 or off >= len(self.data):
                break
            seen.add(off)
            try:
                nxt = self._parse_xref_section(off, entries, free)
            except Exception:  # noqa: BLE001 — damaged xref: scavenger wins
                return
            if nxt is None:
                break
            off = nxt
        for num, (pos, gen) in entries.items():
            if num in free:
                continue
            try:
                self._load_obj_at(num, gen, pos)
            except Exception:  # noqa: BLE001
                continue

    def _parse_xref_section(self, off: int, entries, free):
        """Parse one xref table or xref stream at `off`; fills entries
        (first-seen wins — the chain walks newest-first) and the free
        set. Returns the /Prev offset or None."""
        data = self.data
        pos = _skip_ws(data, off)
        if data[pos: pos + 4] == b"xref":
            pos += 4
            while True:
                pos = _skip_ws(data, pos)
                m = re.match(rb"(\d+)\s+(\d+)", data[pos: pos + 40])
                if m is None:
                    break
                start, count = int(m.group(1)), int(m.group(2))
                pos += m.end()
                for i in range(count):
                    pos = _skip_ws(data, pos)
                    em = re.match(
                        rb"(\d{10})\s+(\d{5})\s+([nf])",
                        data[pos: pos + 20],
                    )
                    if em is None:
                        raise ValueError("bad xref entry")
                    pos += em.end()
                    num = start + i
                    if em.group(3) == b"n":
                        entries.setdefault(
                            num, (int(em.group(1)), int(em.group(2)))
                        )
                    elif num not in entries:
                        free.add(num)
            tpos = data.find(b"trailer", pos)
            if tpos < 0:
                return None
            tdict, _ = _parse_value(data, _skip_ws(data, tpos + 7))
            if not isinstance(tdict, dict):
                return None
            # hybrid-reference files: /XRefStm points at a stream with
            # entries for objects the classic table marks free
            if "XRefStm" in tdict:
                try:
                    self._parse_xref_section(
                        int(tdict["XRefStm"]), entries, free
                    )
                except Exception:  # noqa: BLE001
                    pass
            prev = tdict.get("Prev")
            return int(prev) if prev is not None else None
        # xref STREAM (PDF 1.5+): an object whose stream encodes entries
        m = _OBJ_RE.match(data, pos)
        if m is None:
            raise ValueError("no xref at offset")
        body, raw = self._body_at(m.end())
        sdict, _ = _parse_value(body, 0)
        if not (isinstance(sdict, dict) and raw is not None):
            raise ValueError("xref stream malformed")
        ln = sdict.get("Length")
        if isinstance(ln, int) and 0 <= ln <= len(raw):
            raw = raw[:ln]
        else:
            raw = raw.rstrip(b"\r\n")
        stream = _apply_filters(sdict, raw)
        w = [int(x) for x in sdict.get("W", [])]
        if len(w) != 3:
            raise ValueError("bad /W")
        size = int(sdict.get("Size", 0))
        index = sdict.get("Index", [0, size])
        rowlen = sum(w)
        rpos = 0

        def field(row, k, default):
            a = sum(w[:k])
            b = a + w[k]
            if w[k] == 0:
                return default
            return int.from_bytes(row[a:b], "big")

        pairs = [
            (int(index[i]), int(index[i + 1]))
            for i in range(0, len(index) - 1, 2)
        ]
        for start, count in pairs:
            for i in range(count):
                row = stream[rpos: rpos + rowlen]
                rpos += rowlen
                if len(row) < rowlen:
                    break
                typ = field(row, 0, 1)
                f2 = field(row, 1, 0)
                f3 = field(row, 2, 0)
                num = start + i
                if typ == 1:
                    entries.setdefault(num, (f2, f3))
                elif typ == 0 and num not in entries:
                    free.add(num)
                # typ == 2 (in an object stream): the objstm expansion
                # pass resolves those (file-level copies win there)
        prev = sdict.get("Prev")
        return int(prev) if prev is not None else None

    def _load_obj_at(self, num: int, gen: int, pos: int) -> None:
        """Re-read one object from its xref-designated offset and
        OVERRIDE the scavenger's pick (which keeps the last definition
        in the file — wrong when an update rolled the object back or
        reused its number with a bumped generation)."""
        data = self.data
        pos = _skip_ws(data, pos)
        m = _OBJ_RE.match(data, pos)
        if m is None or int(m.group(1)) != num:
            return  # damaged offset: keep the scavenger's pick
        body, raw = self._body_at(m.end())
        self.objects[num] = body
        if raw is not None:
            self._raw_streams[num] = raw
        elif num in self._raw_streams:
            del self._raw_streams[num]
        self._gens[num] = int(m.group(2))
        self._parsed.pop(num, None)
        self._from_objstm.discard(num)

    def obj(self, num: int):
        """Parsed object value (dict for dictionaries), cached."""
        if num in self._parsed:
            return self._parsed[num]
        body = self.objects.get(num)
        val = None
        if body is not None:
            try:
                val, _ = _parse_value(body, 0)
            except Exception:
                val = None
        self._parsed[num] = val
        return val

    def deref(self, v):
        seen = 0
        while isinstance(v, Ref) and seen < 32:
            v = self.obj(v.num)
            seen += 1
        return v

    # ---- encryption --------------------------------------------------------
    def _setup_encryption(self, password: bytes) -> Optional[_Encryption]:
        m = None
        for m in re.finditer(rb"/Encrypt\s+(\d+)\s+(\d+)\s+R", self.data):
            pass  # last trailer wins
        if m is None:
            return None
        enc = self.obj(int(m.group(1)))
        if not isinstance(enc, dict):
            return None
        id0 = b""
        mid = None
        for mid in re.finditer(rb"/ID\s*\[", self.data):
            pass
        if mid is not None:
            try:
                arr, _ = _parse_value(self.data, mid.end() - 1)
                if isinstance(arr, list) and arr:
                    id0 = _as_bytes(arr[0])
            except Exception:
                pass
        return _Encryption.create(enc, id0, password)

    def stream(self, num: int) -> Optional[bytes]:
        """Decoded (decrypted + defiltered) stream of object `num`."""
        raw = self._raw_streams.get(num)
        if raw is None:
            return None
        sdict = self.obj(num)
        if not isinstance(sdict, dict):
            sdict = {}
        length = self.deref(sdict.get("Length"))
        if isinstance(length, (int, float)) and 0 < int(length) <= len(raw):
            raw = raw[: int(length)]
        else:
            raw = raw.rstrip(b"\r\n")
        if self._crypt is not None and num not in self._from_objstm:
            raw = self._crypt.decrypt(raw, num, self._gens.get(num, 0))
        try:
            return _apply_filters(sdict, raw)
        except Exception:
            return None

    # ---- object streams ----------------------------------------------------
    def _expand_object_streams(self) -> None:
        for num in list(self.objects):
            d = self.obj(num)
            if not (isinstance(d, dict) and str(d.get("Type", "")) == "ObjStm"):
                continue
            data = self.stream(num)
            if data is None:
                continue
            try:
                n = int(self.deref(d.get("N", 0)))
                first = int(self.deref(d.get("First", 0)))
            except (TypeError, ValueError):
                continue
            header = data[:first].split()
            offsets = []
            for i in range(0, min(len(header), 2 * n) - 1, 2):
                offsets.append((int(header[i]), int(header[i + 1])))
            for k, (onum, off) in enumerate(offsets):
                end = (
                    first + offsets[k + 1][1]
                    if k + 1 < len(offsets) else len(data)
                )
                if onum not in self.objects:  # file-level copy wins
                    self.objects[onum] = data[first + off: end]
                    self._gens[onum] = 0
                    self._from_objstm.add(onum)

    # ---- page tree -----------------------------------------------------------
    def _page_objects(self) -> Tuple[List[int], Dict[int, dict]]:
        root_pages: Optional[int] = None
        for m in re.finditer(rb"/Root\s+(\d+)\s+\d+\s+R", self.data):
            cat = self.obj(int(m.group(1)))
            if isinstance(cat, dict) and isinstance(cat.get("Pages"), Ref):
                root_pages = cat["Pages"].num
        if root_pages is None:  # catalog may live in an ObjStm
            for num in self.objects:
                d = self.obj(num)
                if isinstance(d, dict) and str(d.get("Type", "")) == \
                        "Catalog" and isinstance(d.get("Pages"), Ref):
                    root_pages = d["Pages"].num
                    break
        pages: List[int] = []
        resources: Dict[int, dict] = {}
        seen = set()

        def walk(num: int, inherited_res) -> None:
            if num in seen:
                return
            seen.add(num)
            d = self.obj(num)
            if not isinstance(d, dict):
                return
            res = d.get("Resources", inherited_res)
            if str(d.get("Type", "")) == "Page":
                pages.append(num)
                r = self.deref(res)
                resources[num] = r if isinstance(r, dict) else {}
                return
            kids = self.deref(d.get("Kids"))
            if isinstance(kids, list):
                for k in kids:
                    if isinstance(k, Ref):
                        walk(k.num, res)

        if root_pages is not None:
            walk(root_pages, None)
        if not pages:  # fallback: every /Type /Page object in file order
            for num in sorted(self.objects):
                d = self.obj(num)
                if isinstance(d, dict) and str(d.get("Type", "")) == "Page":
                    pages.append(num)
                    r = self.deref(d.get("Resources"))
                    resources[num] = r if isinstance(r, dict) else {}
        return pages, resources

    # ---- metadata ------------------------------------------------------------
    def _info(self) -> Dict[str, str]:
        info: Dict[str, str] = {}
        m = None
        for m in re.finditer(rb"/Info\s+(\d+)\s+\d+\s+R", self.data):
            pass
        if m is None:
            return info
        num = int(m.group(1))
        d = self.obj(num)
        if not isinstance(d, dict):
            return info
        for key in ("Title", "Author", "Subject"):
            v = self.deref(d.get(key))
            if isinstance(v, bytes):
                if self._crypt is not None and num not in self._from_objstm:
                    v = self._crypt.decrypt(v, num, self._gens.get(num, 0))
                info[key] = _decode_text_string(v)
        return info

    @property
    def page_count(self) -> int:
        return len(self.pages)

    # ---- content ----------------------------------------------------------
    def _content_bytes(self, page_num: int) -> bytes:
        d = self.obj(page_num)
        if not isinstance(d, dict):
            return b""
        contents = d.get("Contents")
        refs: List[Ref] = []
        if isinstance(contents, Ref):
            inner = self.obj(contents.num)
            if isinstance(inner, list):
                refs = [r for r in inner if isinstance(r, Ref)]
            else:
                refs = [contents]
        elif isinstance(contents, list):
            refs = [r for r in contents if isinstance(r, Ref)]
        out = []
        for r in refs:
            data = self.stream(r.num)
            if data is not None:
                out.append(data)
        return b"\n".join(out)

    def _page_fonts(self, page_num: int) -> Dict[str, _FontMap]:
        res = self._page_resources.get(page_num) or {}
        fonts = self.deref(res.get("Font"))
        out: Dict[str, _FontMap] = {}
        if not isinstance(fonts, dict):
            return out
        for name, fref in fonts.items():
            fd = self.deref(fref)
            if not isinstance(fd, dict):
                continue
            tu = fd.get("ToUnicode")
            if isinstance(tu, Ref):
                data = self.stream(tu.num)
                if data:
                    try:
                        fm = _parse_tounicode(data)
                        if str(fd.get("Subtype", "")) == "Type0":
                            fm.nbytes = max(fm.nbytes, 2)
                        out[name] = fm
                        continue
                    except Exception:
                        pass
            if str(fd.get("Subtype", "")) == "Type0":
                # identity CID mapping: 2-byte codes, often Identity-H
                # over a Unicode-ordered CIDFont — decode as UTF-16BE
                out[name] = _FontMap({}, 2)
        return out

    def extract_page_text(self, index: int) -> str:
        if not 0 <= index < len(self.pages):
            return ""
        num = self.pages[index]
        return extract_text_operators(
            self._content_bytes(num), self._page_fonts(num)
        )

    def extract_text(self) -> str:
        return "\n".join(
            self.extract_page_text(i) for i in range(self.page_count)
        )


def _decode_text_string(raw: bytes) -> str:
    if raw.startswith(b"\xfe\xff"):
        return raw.decode("utf-16-be", "replace")[1:]
    return raw.decode("latin-1")


# ---------------------------------------------------------------------------
# content stream interpretation
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    rb"\((?:\\.|[^()\\])*\)"      # literal string
    rb"|<<|>>"
    rb"|<[0-9A-Fa-f\s]*>"         # hex string
    rb"|\[|\]"
    rb"|/[^\s/<>\[\]()]*"
    rb"|[^\s/<>\[\]()]+",
    re.S,
)


class _Str(bytes):
    """A string operand (raw bytes, undecoded)."""


def extract_text_operators(content: bytes,
                           fonts: Optional[Dict[str, _FontMap]] = None) -> str:
    """Walk a content stream, emitting string operands at text-showing
    operators. TD/Td/T*/ET insert line breaks; TJ number offsets below
    -100/1000 em insert a space (word gap heuristic). With `fonts`, Tf
    switches the active ToUnicode map and strings decode through it
    (CID/Type0 2-byte codes included); otherwise bytes decode latin-1.
    """
    fonts = fonts or {}
    out: List[str] = []
    stack: List[object] = []
    in_array: List[object] = []
    array_depth = 0
    cur_font: Optional[_FontMap] = None

    def dec(raw: bytes) -> str:
        if cur_font is not None:
            if cur_font.cmap:
                return cur_font.decode(raw)
            if cur_font.nbytes == 2:
                return raw.decode("utf-16-be", "replace")
        return raw.decode("latin-1")

    for m in _TOKEN_RE.finditer(content):
        tok = m.group(0)
        if tok == b"[":
            array_depth += 1
            in_array = []
            continue
        if tok == b"]":
            array_depth = max(0, array_depth - 1)
            stack.append(list(in_array))
            in_array = []
            continue
        if tok in (b"<<", b">>"):
            continue
        target = in_array if array_depth else stack
        if tok.startswith(b"("):
            raw, _ = _parse_literal_string(tok, 0)
            target.append(_Str(raw))
        elif tok.startswith(b"<"):
            hx = re.sub(rb"\s", b"", tok[1:-1])
            if len(hx) % 2:
                hx += b"0"
            target.append(_Str(bytes.fromhex(hx.decode("ascii"))))
        elif tok.startswith(b"/"):
            target.append(tok)
        else:
            try:
                target.append(float(tok))
                continue
            except ValueError:
                pass
            op = tok
            if op == b"Tf":
                name = next(
                    (t for t in reversed(stack) if isinstance(t, bytes)
                     and t.startswith(b"/")), None,
                )
                if name is not None:
                    cur_font = fonts.get(name[1:].decode("latin-1"))
            elif op == b"Tj" and stack and isinstance(stack[-1], _Str):
                out.append(dec(stack[-1]))
            elif op in (b"'", b'"'):
                strs = [x for x in stack if isinstance(x, _Str)]
                if strs:
                    out.append("\n" + dec(strs[-1]))
            elif op == b"TJ" and stack and isinstance(stack[-1], list):
                for item in stack[-1]:
                    if isinstance(item, _Str):
                        out.append(dec(item))
                    elif isinstance(item, float) and item < -100:
                        out.append(" ")
            elif op in (b"Td", b"TD", b"T*", b"ET"):
                if out and not out[-1].endswith("\n"):
                    out.append("\n")
            stack = []
    return "".join(out).rstrip("\n")


def extract_pdf_text(data: bytes) -> str:
    """One-shot helper: full document text (empty string on failure)."""
    try:
        return PdfDocument(data).extract_text()
    except Exception:
        return ""
