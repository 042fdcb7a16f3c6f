"""PDF reader/writer.

The port's copy of ``coherence_tpu.io.pdf``, whole.

Replaces the reference's camlpdf object layer (Pdfread/Pdfwrite/Pdf/Pdfpage)
for what the renderer needs: classic cross-reference tables AND xref-stream /
object-stream (ObjStm) files, the stream codecs camlpdf's Pdfcodec supports
that appear in page content (Flate incl. PNG/TIFF predictors, ASCIIHex,
ASCII85, RunLength, LZW, CCITTFax G3/G4), the page tree with inheritable
attributes, and a
small writer for debug output.

Object model: Python natives —
  dict          -> PDF dictionary (keys without the leading '/')
  list          -> PDF array
  Name("X")     -> /X
  Ref(n, g)     -> indirect reference
  bytes         -> PDF string
  int/float/bool/None
  Stream(d, raw)-> stream (lazily decoded)
"""

from __future__ import annotations

import hashlib
import re
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union


@dataclass(frozen=True)
class Name:
    v: str

    def __repr__(self):
        return f"/{self.v}"


@dataclass(frozen=True)
class Ref:
    num: int
    gen: int = 0


def _ascii85_decode(data: bytes) -> bytes:
    """ASCII85Decode (PDF 7.4.3): whitespace ignored, `z` = four zero
    bytes, terminated by `~>` (optional)."""
    end = data.find(b"~>")
    if end != -1:
        data = data[:end]
    out = bytearray()
    group = []
    for c in data:
        if c in _WS:
            continue
        if c == 0x7A:  # 'z'
            if group:
                raise ValueError("ASCII85: z inside group")
            out += b"\x00\x00\x00\x00"
            continue
        if not (0x21 <= c <= 0x75):
            raise ValueError(f"ASCII85: bad byte {c}")
        group.append(c - 0x21)
        if len(group) == 5:
            v = 0
            for g in group:
                v = v * 85 + g
            out += v.to_bytes(4, "big")
            group = []
    if group:
        n = len(group)
        group += [84] * (5 - n)
        v = 0
        for g in group:
            v = v * 85 + g
        out += v.to_bytes(4, "big")[: n - 1]
    return bytes(out)


def _runlength_decode(data: bytes) -> bytes:
    """RunLengthDecode (PDF 7.4.5)."""
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        if n == 128:
            break
        if n < 128:
            out += data[i + 1 : i + 2 + n]
            i += 2 + n
        else:
            out += data[i + 1 : i + 2] * (257 - n)
            i += 2
    return bytes(out)


def _lzw_decode(data: bytes, early_change: int = 1) -> bytes:
    """LZWDecode (PDF 7.4.4; TIFF-style LZW with 9..12-bit variable codes,
    clear code 256, EOD 257, EarlyChange per /DecodeParms)."""
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width = 9
    prev: Optional[bytes] = None
    acc = 0
    nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (acc >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            if code == 256:
                table = table[:258]
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
            out += entry
            prev = entry
            # The encoder bumps its code width as soon as the NEXT code it
            # could emit (== next table index, i.e. len(table); one earlier
            # with EarlyChange=1) no longer fits — the decoder must follow
            # at exactly the same point (verified against a TIFF-LZW
            # encoder: bumping one entry late diverges at the first 9->10
            # transition).
            if len(table) + early_change >= (1 << width) and width < 12:
                width += 1
    return bytes(out)


def _apply_predictor(data: bytes, parms: dict) -> bytes:
    """PNG (10-15) and TIFF (2) predictors per /DecodeParms (PDF 7.4.4.4)."""
    pred = parms.get("Predictor", 1)
    if not isinstance(pred, int) or pred <= 1:
        return data
    colors = int(parms.get("Colors", 1))
    bpc = int(parms.get("BitsPerComponent", 8))
    columns = int(parms.get("Columns", 1))
    bpp = max(1, (colors * bpc + 7) // 8)  # bytes per pixel
    rowlen = (columns * colors * bpc + 7) // 8
    if pred == 2:  # TIFF horizontal differencing (8-bit components only)
        if bpc != 8:
            raise ValueError("TIFF predictor with bpc != 8 unsupported")
        out = bytearray(data)
        for r in range(0, len(out) - rowlen + 1, rowlen):
            for i in range(bpp, rowlen):
                out[r + i] = (out[r + i] + out[r + i - bpp]) & 0xFF
        return bytes(out)
    # PNG predictors: each row prefixed with a filter-type byte.
    out = bytearray()
    prev_row = bytearray(rowlen)
    pos = 0
    while pos + 1 <= len(data):
        ft = data[pos]
        row = bytearray(data[pos + 1 : pos + 1 + rowlen])
        pos += 1 + rowlen
        if ft == 1:  # Sub
            for i in range(bpp, len(row)):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ft == 2:  # Up
            for i in range(len(row)):
                row[i] = (row[i] + prev_row[i]) & 0xFF
        elif ft == 3:  # Average
            for i in range(len(row)):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev_row[i]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for i in range(len(row)):
                a = row[i - bpp] if i >= bpp else 0
                b = prev_row[i]
                c = prev_row[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pr) & 0xFF
        elif ft != 0:
            raise ValueError(f"bad PNG filter type {ft}")
        out += row
        prev_row = row
    return bytes(out)


class Stream:
    def __init__(self, d: dict, raw: bytes, pdf: "Pdf" = None):
        self.dict = d
        self.raw = raw
        self._pdf = pdf
        self._decoded: Optional[bytes] = None

    def decode(self) -> bytes:
        if self._decoded is None:
            res = self._pdf.resolve if self._pdf is not None else (lambda o: o)
            filt = res(self.dict.get("Filter"))
            parms = res(self.dict.get("DecodeParms", self.dict.get("DP")))
            data = self.raw
            filters: List[str] = []
            if isinstance(filt, Name):
                filters = [filt.v]
            elif isinstance(filt, list):
                filters = [res(f).v for f in filt]
            if isinstance(parms, dict) or parms is None:
                parms_list = [parms] * max(1, len(filters))
            else:
                parms_list = [res(p) for p in parms]
                parms_list += [None] * (len(filters) - len(parms_list))
            for f, p in zip(filters, parms_list):
                p = p if isinstance(p, dict) else {}
                p = {k: res(v) for k, v in p.items()}
                if f in ("FlateDecode", "Fl"):
                    data = zlib.decompress(data)
                    data = _apply_predictor(data, p)
                elif f in ("LZWDecode", "LZW"):
                    data = _lzw_decode(data, int(p.get("EarlyChange", 1)))
                    data = _apply_predictor(data, p)
                elif f in ("ASCIIHexDecode", "AHx"):
                    hexstr = re.sub(rb"[^0-9A-Fa-f]", b"", data.split(b">")[0])
                    if len(hexstr) % 2:
                        hexstr += b"0"
                    data = bytes.fromhex(hexstr.decode())
                elif f in ("ASCII85Decode", "A85"):
                    data = _ascii85_decode(data)
                elif f in ("RunLengthDecode", "RL"):
                    data = _runlength_decode(data)
                elif f in ("CCITTFaxDecode", "CCF"):
                    from .ccitt import ccitt_decode

                    data = ccitt_decode(
                        data,
                        k=int(p.get("K", 0)),
                        columns=int(p.get("Columns", 1728)),
                        rows=int(p.get("Rows", 0)),
                        black_is_1=p.get("BlackIs1", False) is True,
                        byte_align=p.get("EncodedByteAlign", False) is True,
                    )
                else:
                    raise ValueError(f"unsupported stream filter {f}")
            self._decoded = data
        return self._decoded


PdfObj = Union[dict, list, Name, Ref, bytes, int, float, bool, None, Stream]

_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


class _Lexer:
    def __init__(self, data: bytes, pos: int = 0):
        self.d = data
        self.p = pos

    def skip_ws(self):
        d, n = self.d, len(self.d)
        while self.p < n:
            c = self.d[self.p]
            if c in _WS:
                self.p += 1
            elif c == 0x25:  # '%' comment
                while self.p < n and self.d[self.p] not in b"\r\n":
                    self.p += 1
            else:
                return

    def peek_token(self) -> bytes:
        save = self.p
        t = self.next_token()
        self.p = save
        return t

    def next_token(self) -> bytes:
        self.skip_ws()
        d, n = self.d, len(self.d)
        if self.p >= n:
            return b""
        c = d[self.p]
        if c == 0x3C and self.p + 1 < n and d[self.p + 1] == 0x3C:
            self.p += 2
            return b"<<"
        if c == 0x3E and self.p + 1 < n and d[self.p + 1] == 0x3E:
            self.p += 2
            return b">>"
        if c in b"[]{}":
            self.p += 1
            return bytes([c])
        if c == 0x2F:  # name
            start = self.p
            self.p += 1
            while self.p < n and d[self.p] not in _WS and d[self.p] not in _DELIM:
                self.p += 1
            return d[start : self.p]
        if c == 0x28:  # ( string
            return self._lex_string()
        if c == 0x3C:  # <hex string
            start = self.p
            self.p = d.index(b">", self.p) + 1
            return d[start : self.p]
        start = self.p
        while self.p < n and d[self.p] not in _WS and d[self.p] not in _DELIM:
            self.p += 1
        if self.p == start:
            self.p += 1
        return d[start : self.p]

    def _lex_string(self) -> bytes:
        d, n = self.d, len(self.d)
        start = self.p
        depth = 0
        while self.p < n:
            c = d[self.p]
            if c == 0x5C:
                self.p += 2
                continue
            if c == 0x28:
                depth += 1
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    self.p += 1
                    return d[start : self.p]
            self.p += 1
        raise ValueError("unterminated string")


_NUM_RE = re.compile(rb"^[+-]?(\d+\.?\d*|\.\d+)$")


def _unescape_string(tok: bytes) -> bytes:
    body = tok[1:-1]
    out = bytearray()
    i = 0
    esc = {b"n"[0]: 10, b"r"[0]: 13, b"t"[0]: 9, b"b"[0]: 8, b"f"[0]: 12}
    while i < len(body):
        c = body[i]
        if c == 0x5C and i + 1 < len(body):
            nxt = body[i + 1]
            if nxt in esc:
                out.append(esc[nxt])
                i += 2
            elif 0x30 <= nxt <= 0x37:
                j = i + 1
                oct_ = 0
                while j < len(body) and j < i + 4 and 0x30 <= body[j] <= 0x37:
                    oct_ = oct_ * 8 + (body[j] - 0x30)
                    j += 1
                out.append(oct_ & 0xFF)
                i = j
            else:
                out.append(nxt)
                i += 2
        else:
            out.append(c)
            i += 1
    return bytes(out)


class _Parser:
    def __init__(self, data: bytes, pos: int = 0):
        self.lex = _Lexer(data, pos)

    def parse(self) -> PdfObj:
        tok = self.lex.next_token()
        return self._obj(tok)

    def _obj(self, tok: bytes) -> PdfObj:
        if tok == b"<<":
            d = {}
            while True:
                k = self.lex.next_token()
                if k == b">>":
                    return d
                if not k.startswith(b"/"):
                    raise ValueError(f"bad dict key {k!r}")
                d[k[1:].decode("latin1")] = self.parse()
        if tok == b"[":
            arr = []
            while True:
                t = self.lex.peek_token()
                if t == b"]":
                    self.lex.next_token()
                    return arr
                arr.append(self.parse())
        if tok.startswith(b"/"):
            return Name(tok[1:].decode("latin1"))
        if tok == b"true":
            return True
        if tok == b"false":
            return False
        if tok == b"null":
            return None
        if tok.startswith(b"("):
            return _unescape_string(tok)
        if tok.startswith(b"<"):
            hexstr = re.sub(rb"[^0-9A-Fa-f]", b"", tok[1:-1])
            if len(hexstr) % 2:
                hexstr += b"0"
            return bytes.fromhex(hexstr.decode())
        if _NUM_RE.match(tok):
            # Could be "N G R" reference.
            save = self.lex.p
            t2 = self.lex.next_token()
            if _NUM_RE.match(t2) and b"." not in tok and b"." not in t2:
                t3 = self.lex.next_token()
                if t3 == b"R":
                    return Ref(int(tok), int(t2))
            self.lex.p = save
            if b"." in tok:
                return float(tok)
            return int(tok)
        raise ValueError(f"unexpected token {tok!r}")


_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b")


class Pdf:
    """An in-memory PDF document."""

    def __init__(self, objects: Dict[int, PdfObj], trailer: dict):
        self.objects = objects
        self.trailer = trailer

    # --- resolution -------------------------------------------------------

    def resolve(self, o: PdfObj) -> PdfObj:
        seen = 0
        while isinstance(o, Ref):
            o = self.objects.get(o.num)
            seen += 1
            if seen > 64:
                raise ValueError("reference cycle")
        return o

    def get(self, d: dict, key: str, default=None) -> PdfObj:
        return self.resolve(d.get(key, default)) if isinstance(d, dict) else default

    # --- page tree --------------------------------------------------------

    def catalog(self) -> dict:
        return self.resolve(self.trailer["Root"])

    def pages(self) -> List[dict]:
        """Flattened page list with inherited attributes (Pdfpage parity)."""
        root = self.resolve(self.catalog()["Pages"])
        out: List[dict] = []
        inheritable = ("Resources", "MediaBox", "CropBox", "Rotate")

        def walk(node: dict, inherited: dict):
            node = self.resolve(node)
            inh = dict(inherited)
            for k in inheritable:
                if k in node:
                    inh[k] = node[k]
            t = self.get(node, "Type")
            if isinstance(t, Name) and t.v == "Pages" or "Kids" in node:
                for kid in self.resolve(node.get("Kids", [])):
                    walk(kid, inh)
            else:
                page = dict(node)
                for k, v in inh.items():
                    page.setdefault(k, v)
                out.append(page)

        walk(root, {})
        return out

    def page_content(self, page: dict) -> bytes:
        """Concatenated decoded content streams of a page."""
        contents = self.resolve(page.get("Contents"))
        if contents is None:
            return b""
        if isinstance(contents, Stream):
            return contents.decode()
        return b"\n".join(self.resolve(c).decode() for c in contents)


def _decrypt_objects(objects: Dict[int, PdfObj], gens: Dict[int, int], data: bytes):
    """Decrypt every string and stream in place when the file carries a
    standard /Encrypt dictionary (PDF 7.6) — camlpdf `Pdfcrypt` parity.
    XRef streams are never encrypted; /Metadata honours EncryptMetadata;
    strings inside object streams are covered by the ObjStm's own stream
    decryption (they are not re-encrypted individually)."""
    enc_ref = None
    id0 = b""
    dicts: list = []
    for m in re.finditer(rb"trailer", data):
        try:
            t = _Parser(data, m.end()).parse()
            if isinstance(t, dict):
                dicts.append(t)
        except Exception:
            pass
    for obj in objects.values():
        if isinstance(obj, Stream):
            t = obj.dict.get("Type")
            if isinstance(t, Name) and t.v == "XRef":
                dicts.append(obj.dict)
    for t in dicts:
        if enc_ref is None and "Encrypt" in t:
            enc_ref = t["Encrypt"]
        ids = t.get("ID")
        if not id0 and isinstance(ids, list) and ids and isinstance(ids[0], bytes):
            id0 = ids[0]
    if enc_ref is None:
        return
    enc_num = enc_ref.num if isinstance(enc_ref, Ref) else None
    enc = objects.get(enc_num) if enc_num is not None else enc_ref
    if not isinstance(enc, dict):
        return
    filt = enc.get("Filter")
    if isinstance(filt, Name) and filt.v != "Standard":
        return  # unsupported security handler: leave bytes as-is
    try:
        from .pdfcrypt import StandardSecurityHandler

        handler = StandardSecurityHandler(enc, id0)
    except Exception:
        return

    def walk_strings(o, num, gen):
        if isinstance(o, dict):
            for k, v in o.items():
                if isinstance(v, bytes):
                    o[k] = handler.decrypt_string(v, num, gen)
                else:
                    walk_strings(v, num, gen)
        elif isinstance(o, list):
            for i, v in enumerate(o):
                if isinstance(v, bytes):
                    o[i] = handler.decrypt_string(v, num, gen)
                else:
                    walk_strings(v, num, gen)

    for num, obj in objects.items():
        if num == enc_num:
            continue
        gen = gens.get(num, 0)
        if isinstance(obj, Stream):
            t = obj.dict.get("Type")
            tname = t.v if isinstance(t, Name) else ""
            skip = tname == "XRef" or (
                tname == "Metadata" and not handler.encrypt_metadata
            )
            if not skip:
                obj.raw = handler.decrypt_stream(obj.raw, num, gen)
            if tname == "XRef":
                # The xref stream doubles as the trailer; its /ID strings
                # are never encrypted (PDF 7.5.8.2).
                saved_id = obj.dict.pop("ID", None)
                walk_strings(obj.dict, num, gen)
                if saved_id is not None:
                    obj.dict["ID"] = saved_id
            else:
                walk_strings(obj.dict, num, gen)
        else:
            walk_strings(obj, num, gen)
            if isinstance(obj, bytes):
                objects[num] = handler.decrypt_string(obj, num, gen)


def pdf_of_bytes(data: bytes) -> Pdf:
    """Parse by scanning every `N G obj` (robust to broken/linearized xref),
    then unpack object streams (ObjStm) and read xref-stream trailers.

    Classic and modern (PDF 1.5+ cross-reference-stream) files both load;
    the byte-offset xref table itself is never needed because the scan
    discovers every direct object and ObjStm unpacking the compressed ones.
    """
    objects: Dict[int, PdfObj] = {}
    gens: Dict[int, int] = {}
    # File offset of each object number's winning definition: incremental
    # updates append, so LATER byte offset = newer definition, whether the
    # definition is a direct `N G obj` or lives inside a later ObjStm.
    obj_off: Dict[int, int] = {}
    for m in _OBJ_RE.finditer(data):
        # Reject matches inside streams by attempting a parse; later
        # definitions override earlier ones (incremental updates).
        num = int(m.group(1))
        gens[num] = int(m.group(2))
        p = _Parser(data, m.end())
        try:
            obj = p.parse()
        except Exception:
            continue
        # stream?
        lex = p.lex
        save = lex.p
        tok = lex.next_token()
        if tok == b"stream" and isinstance(obj, dict):
            q = lex.p
            if data[q : q + 2] == b"\r\n":
                q += 2
            elif data[q : q + 1] == b"\n":
                q += 1
            length = obj.get("Length")
            if isinstance(length, Ref):
                # Resolve later: find the int object inline (common case:
                # defined after the stream).  Fall back to endstream scan.
                length = None
            if isinstance(length, int):
                raw = data[q : q + length]
            else:
                end = data.find(b"endstream", q)
                raw = data[q:end]
                # Strip the trailing EOL before `endstream`.
                while raw[-1:] in (b"\r", b"\n"):
                    raw = raw[:-1]
            obj = Stream(obj, raw)
        else:
            lex.p = save
        objects[num] = obj
        obj_off[num] = m.start()
    # Resolve Ref lengths now that all objects are known.
    for obj in objects.values():
        if isinstance(obj, Stream):
            length = obj.dict.get("Length")
            if isinstance(length, Ref) and isinstance(objects.get(length.num), int):
                obj.raw = obj.raw[: objects[length.num]]
    _decrypt_objects(objects, gens, data)
    # Unpack object streams (PDF 7.5.7): decode each /Type /ObjStm, parse
    # the (objnum, offset) header pairs, then each contained object.
    # Precedence is by FILE OFFSET of the defining container: a compressed
    # copy wins iff its ObjStm's `N G obj` appears later in the file than
    # the current winning definition (direct or another ObjStm's) — so an
    # Acrobat full save with object streams correctly overrides stale
    # direct objects from earlier revisions, and vice versa.
    proto = Pdf(objects, {})
    for obj in objects.values():
        if isinstance(obj, Stream):
            obj._pdf = proto
    objstms = sorted(
        (obj_off.get(num, -1), num)
        for num, obj in objects.items()
        if isinstance(obj, Stream)
        and isinstance(obj.dict.get("Type"), Name)
        and obj.dict["Type"].v == "ObjStm"
    )
    for stm_off, stm_num in objstms:
        obj = objects[stm_num]
        try:
            body = obj.decode()
            n = proto.resolve(obj.dict.get("N", 0))
            first = proto.resolve(obj.dict.get("First", 0))
            head = _Lexer(body[:first])
            pairs = []
            for _ in range(int(n)):
                num = int(head.next_token())
                off = int(head.next_token())
                pairs.append((num, off))
            for num, off in pairs:
                if obj_off.get(num, -1) < stm_off:
                    objects[num] = _Parser(body, first + off).parse()
                    obj_off[num] = stm_off
        except Exception:
            continue
    # Trailer(s): scan for `trailer` dicts; merge (later wins for Root).
    # Xref-stream files have no `trailer` keyword — their /Type /XRef
    # stream dict IS the trailer (PDF 7.5.8.2), so merge those too.
    trailer: dict = {}
    for num in sorted(objects):
        obj = objects[num]
        if isinstance(obj, Stream):
            t = obj.dict.get("Type")
            if isinstance(t, Name) and t.v == "XRef":
                for k in ("Root", "Info", "ID", "Size", "Encrypt"):
                    if k in obj.dict:
                        trailer[k] = obj.dict[k]
    for m in re.finditer(rb"trailer", data):
        try:
            t = _Parser(data, m.end()).parse()
            if isinstance(t, dict):
                trailer.update(t)
        except Exception:
            pass
    if "Root" not in trailer:
        # Some linearized files only have the Root in an xref-stream dict;
        # fall back: find an object with /Type /Catalog.
        for num, obj in objects.items():
            if isinstance(obj, dict):
                t = obj.get("Type")
                if isinstance(t, Name) and t.v == "Catalog":
                    trailer["Root"] = Ref(num)
                    break
    pdf = Pdf(objects, trailer)
    for obj in objects.values():
        if isinstance(obj, Stream):
            obj._pdf = pdf
    return pdf


def pdf_of_file(path: str) -> Pdf:
    with open(path, "rb") as f:
        return pdf_of_bytes(f.read())


# ---------------------------------------------------------------------------
# Writer (for debug PDFs and page_of_graphic round-trips)
# ---------------------------------------------------------------------------


def _ser(o: PdfObj) -> bytes:
    if isinstance(o, Stream):
        d = dict(o.dict)
        d["Length"] = len(o.raw)
        return _ser(d) + b"\nstream\n" + o.raw + b"\nendstream"
    if isinstance(o, dict):
        inner = b" ".join(b"/" + k.encode("latin1") + b" " + _ser(v) for k, v in o.items())
        return b"<< " + inner + b" >>"
    if isinstance(o, list):
        return b"[ " + b" ".join(_ser(v) for v in o) + b" ]"
    if isinstance(o, Name):
        return b"/" + o.v.encode("latin1")
    if isinstance(o, Ref):
        return f"{o.num} {o.gen} R".encode()
    if isinstance(o, bool):
        return b"true" if o else b"false"
    if o is None:
        return b"null"
    if isinstance(o, bytes):
        return b"(" + o.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(b")", b"\\)") + b")"
    if isinstance(o, float):
        return f"{o:.6f}".rstrip("0").rstrip(".").encode() or b"0"
    return str(o).encode()


def pdf_to_bytes(pdf: Pdf, modern: bool = False, encrypt: Optional[dict] = None) -> bytes:
    """Serialize.  ``modern=False`` writes a classic PDF 1.4 file with an
    uncompressed xref table; ``modern=True`` writes PDF 1.5 compressed
    cross-reference: non-stream objects packed into /Type /ObjStm object
    streams and a /Type /XRef cross-reference stream instead of a trailer
    (camlpdf Pdfwrite parity via the reference's Makefile:20; PDF 7.5.7,
    7.5.8).

    ``encrypt`` turns on the standard security handler (camlpdf Pdfwrite
    encryption parity): a kwargs dict for `pdfcrypt.build_encryption`,
    e.g. ``{"revision": 4, "user_pw": b"", "owner_pw": b"secret"}``.
    Every string and stream is encrypted per PDF 7.6.2 (streams inside
    object streams via the ObjStm's own key; the /Encrypt dictionary,
    /ID strings and the xref stream stay clear)."""
    # Streams are only legal as indirect objects: hoist any Stream nested
    # inside a dict/list (e.g. a tiling-pattern stream placed directly in a
    # page's /Resources by page_of_graphic) into its own object.
    objects = dict(pdf.objects)
    next_num = [max(objects) + 1 if objects else 1]

    def hoist(o, top=False):
        if isinstance(o, Stream) and not top:
            num = next_num[0]
            next_num[0] += 1
            objects[num] = Stream(hoist(o.dict), o.raw, o._pdf)
            return Ref(num)
        if isinstance(o, Stream):
            return Stream(hoist(o.dict), o.raw, o._pdf)
        if isinstance(o, dict):
            return {k: hoist(v) for k, v in o.items()}
        if isinstance(o, list):
            return [hoist(v) for v in o]
        return o

    for num in sorted(list(objects)):
        objects[num] = hoist(objects[num], top=True)
    trailer_src = dict(pdf.trailer)
    # In-memory objects are plaintext (the reader decrypts on load): a stale
    # /Encrypt from a previously-read encrypted file must not survive a
    # re-write, or readers would "decrypt" the plaintext.  Drop the orphaned
    # encryption dictionary too.
    stale_enc = trailer_src.pop("Encrypt", None)
    if isinstance(stale_enc, Ref):
        objects.pop(stale_enc.num, None)

    handler = None
    enc_num = None
    if encrypt is not None:
        from .pdfcrypt import build_encryption

        ids = trailer_src.get("ID")
        if isinstance(ids, list) and ids and isinstance(ids[0], bytes):
            id0 = ids[0]
        else:
            digest = hashlib.md5()
            for num in sorted(objects):
                digest.update(_ser(objects[num]))
            id0 = digest.digest()
            trailer_src["ID"] = [id0, id0]
        enc_dict, handler = build_encryption(id0=id0, **encrypt)
        enc_num = (max(objects) + 1) if objects else 1
        objects[enc_num] = enc_dict
        trailer_src["Encrypt"] = Ref(enc_num)
    pdf = Pdf(objects, trailer_src)

    if modern:
        return _pdf_to_bytes_modern(pdf, handler, enc_num)
    if handler is not None:
        for num in sorted(objects):
            if num != enc_num:
                objects[num] = _encrypt_object(objects[num], num, 0, handler)
    out = bytearray(b"%PDF-1.4\n")
    offsets = {}
    for num in sorted(pdf.objects):
        offsets[num] = len(out)
        out += f"{num} 0 obj\n".encode()
        out += _ser(pdf.objects[num])
        out += b"\nendobj\n"
    xref_pos = len(out)
    maxnum = max(pdf.objects) if pdf.objects else 0
    out += f"xref\n0 {maxnum + 1}\n".encode()
    out += b"0000000000 65535 f \n"
    for num in range(1, maxnum + 1):
        if num in offsets:
            out += f"{offsets[num]:010d} 00000 n \n".encode()
        else:
            out += b"0000000000 65535 f \n"
    trailer = dict(pdf.trailer)
    trailer["Size"] = maxnum + 1
    out += b"trailer\n" + _ser(trailer) + b"\n"
    out += f"startxref\n{xref_pos}\n%%EOF\n".encode()
    return bytes(out)


def _encrypt_object(o: PdfObj, num: int, gen: int, handler) -> PdfObj:
    """Writer-side counterpart of `_decrypt_objects`' walk: encrypt every
    string (and a Stream's raw bytes) with the object's key.  XRef streams
    and (when /EncryptMetadata is false) /Metadata streams stay clear, per
    PDF 7.5.8.2 / 7.6.2."""
    if isinstance(o, Stream):
        t = o.dict.get("Type")
        tname = t.v if isinstance(t, Name) else ""
        skip = tname == "XRef" or (
            tname == "Metadata" and not handler.encrypt_metadata
        )
        raw = o.raw if skip else handler.encrypt_stream(o.raw, num, gen)
        return Stream(_encrypt_object(o.dict, num, gen, handler), raw, o._pdf)
    if isinstance(o, dict):
        return {k: _encrypt_object(v, num, gen, handler) for k, v in o.items()}
    if isinstance(o, list):
        return [_encrypt_object(v, num, gen, handler) for v in o]
    if isinstance(o, bytes):
        return handler.encrypt_string(o, num, gen)
    return o


_OBJSTM_CHUNK = 100  # objects per object stream (Acrobat uses ~200)


def _pdf_to_bytes_modern(pdf: Pdf, handler=None, enc_num: Optional[int] = None) -> bytes:
    """PDF 1.5 output: object streams + an xref stream.  Objects must
    already be hoisted (every Stream is a top-level object).

    Layout: all non-stream objects are packed into /Type /ObjStm streams
    (their xref entries are type 2: stream number + index); stream objects
    and the ObjStms themselves are written directly (type 1: byte offset);
    the file ends with a /Type /XRef stream carrying the trailer entries
    and the packed [type, field2, field3] table (PDF 7.5.8.2), and a
    plain ``startxref`` pointing at it."""
    nums = sorted(pdf.objects)
    # The /Encrypt dictionary must stay directly accessible (and clear) —
    # it cannot live in an ObjStm whose decryption needs it.
    packable = [
        n for n in nums if not isinstance(pdf.objects[n], Stream) and n != enc_num
    ]
    direct = [n for n in nums if isinstance(pdf.objects[n], Stream)]
    next_num = max(nums) + 1 if nums else 1

    in_stm: Dict[int, Tuple[int, int]] = {}  # num -> (objstm num, index)
    objstms: List[Tuple[int, "Stream"]] = []
    for start in range(0, len(packable), _OBJSTM_CHUNK):
        chunk = packable[start : start + _OBJSTM_CHUNK]
        header = bytearray()
        body = bytearray()
        for i, n in enumerate(chunk):
            header += f"{n} {len(body)} ".encode()
            # Strings inside an ObjStm are covered by the stream's own
            # encryption — never re-encrypted individually (PDF 7.5.7).
            body += _ser(pdf.objects[n]) + b"\n"
            in_stm[n] = (next_num, i)
        raw = zlib.compress(bytes(header) + bytes(body))
        if handler is not None:
            raw = handler.encrypt_stream(raw, next_num, 0)
        stm = Stream(
            {
                "Type": Name("ObjStm"),
                "N": len(chunk),
                "First": len(header),
                "Filter": Name("FlateDecode"),
            },
            raw,
        )
        objstms.append((next_num, stm))
        next_num += 1

    out = bytearray(b"%PDF-1.5\n%\xe2\xe3\xcf\xd3\n")
    offsets: Dict[int, int] = {}
    if enc_num is not None:
        offsets[enc_num] = len(out)
        out += f"{enc_num} 0 obj\n".encode() + _ser(pdf.objects[enc_num]) + b"\nendobj\n"
    for n in direct:
        offsets[n] = len(out)
        obj = pdf.objects[n]
        if handler is not None:
            obj = _encrypt_object(obj, n, 0, handler)
        out += f"{n} 0 obj\n".encode() + _ser(obj) + b"\nendobj\n"
    for n, stm in objstms:
        offsets[n] = len(out)
        out += f"{n} 0 obj\n".encode() + _ser(stm) + b"\nendobj\n"

    xref_num = next_num
    xref_pos = len(out)
    offsets[xref_num] = xref_pos
    size = xref_num + 1
    # W = [1 4 2]: 1-byte type, 4-byte offset/stream-number, 2-byte
    # gen/index.  Entry 0 is the head of the (empty) free list.
    rows = bytearray()
    for num in range(size):
        if num in offsets:
            rows += struct.pack(">BIH", 1, offsets[num], 0)
        elif num in in_stm:
            s, i = in_stm[num]
            rows += struct.pack(">BIH", 2, s, i)
        else:
            rows += struct.pack(">BIH", 0, 0, 0xFFFF)
    xd: dict = {
        "Type": Name("XRef"),
        "Size": size,
        "W": [1, 4, 2],
        "Filter": Name("FlateDecode"),
    }
    for k in ("Root", "Info", "ID", "Encrypt"):
        if k in pdf.trailer:
            xd[k] = pdf.trailer[k]
    out += f"{xref_num} 0 obj\n".encode()
    out += _ser(Stream(xd, zlib.compress(bytes(rows))))
    out += b"\nendobj\n"
    out += f"startxref\n{xref_pos}\n%%EOF\n".encode()
    return bytes(out)


def pdf_to_file(pdf: Pdf, path: str, modern: bool = False):
    with open(path, "wb") as f:
        f.write(pdf_to_bytes(pdf, modern=modern))


def mkpage(content: bytes, mediabox=(0, 0, 612, 792), resources=None) -> Pdf:
    """A one-page PDF around a content stream."""
    stream = Stream({}, zlib.compress(content))
    stream.dict["Filter"] = Name("FlateDecode")
    objects = {
        1: {"Type": Name("Catalog"), "Pages": Ref(2)},
        2: {"Type": Name("Pages"), "Kids": [Ref(3)], "Count": 1},
        3: {
            "Type": Name("Page"),
            "Parent": Ref(2),
            "MediaBox": list(mediabox),
            "Resources": resources or {},
            "Contents": Ref(4),
        },
        4: stream,
    }
    return Pdf(objects, {"Root": Ref(1)})
