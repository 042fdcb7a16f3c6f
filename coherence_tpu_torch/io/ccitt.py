"""CCITTFaxDecode (PDF 7.4.6): ITU-T T.4 (Group 3) and T.6 (Group 4).

The port's copy of ``coherence_tpu.io.ccitt``, whole.

Parity with camlpdf's Pdfcodec CCITT support (the reference's stream
decoder stack, the reference's Makefile:20).  Decodes MH (K=0), mixed
MH/MR (K>0) and MMR (K<0) into packed 1-bpc rows, byte-aligned per row,
with the PDF output convention (0 bits = black unless /BlackIs1).

A Group-4 encoder is included for writer symmetry and round-trip tests;
tests cross-validate decode against libtiff via PIL's group4 TIFF writer.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["ccitt_decode", "ccitt_encode_g4"]

# T.4 terminating + makeup run-length codes, as (bitstring, run) pairs.
_WHITE_CODES = [
    ("00110101", 0), ("000111", 1), ("0111", 2), ("1000", 3), ("1011", 4),
    ("1100", 5), ("1110", 6), ("1111", 7), ("10011", 8), ("10100", 9),
    ("00111", 10), ("01000", 11), ("001000", 12), ("000011", 13),
    ("110100", 14), ("110101", 15), ("101010", 16), ("101011", 17),
    ("0100111", 18), ("0001100", 19), ("0001000", 20), ("0010111", 21),
    ("0000011", 22), ("0000100", 23), ("0101000", 24), ("0101011", 25),
    ("0010011", 26), ("0100100", 27), ("0011000", 28), ("00000010", 29),
    ("00000011", 30), ("00011010", 31), ("00011011", 32), ("00010010", 33),
    ("00010011", 34), ("00010100", 35), ("00010101", 36), ("00010110", 37),
    ("00010111", 38), ("00101000", 39), ("00101001", 40), ("00101010", 41),
    ("00101011", 42), ("00101100", 43), ("00101101", 44), ("00000100", 45),
    ("00000101", 46), ("00001010", 47), ("00001011", 48), ("01010010", 49),
    ("01010011", 50), ("01010100", 51), ("01010101", 52), ("00100100", 53),
    ("00100101", 54), ("01011000", 55), ("01011001", 56), ("01011010", 57),
    ("01011011", 58), ("01001010", 59), ("01001011", 60), ("00110010", 61),
    ("00110011", 62), ("00110100", 63),
    # makeup
    ("11011", 64), ("10010", 128), ("010111", 192), ("0110111", 256),
    ("00110110", 320), ("00110111", 384), ("01100100", 448),
    ("01100101", 512), ("01101000", 576), ("01100111", 640),
    ("011001100", 704), ("011001101", 768), ("011010010", 832),
    ("011010011", 896), ("011010100", 960), ("011010101", 1024),
    ("011010110", 1088), ("011010111", 1152), ("011011000", 1216),
    ("011011001", 1280), ("011011010", 1344), ("011011011", 1408),
    ("010011000", 1472), ("010011001", 1536), ("010011010", 1600),
    ("011000", 1664), ("010011011", 1728),
]

_BLACK_CODES = [
    ("0000110111", 0), ("010", 1), ("11", 2), ("10", 3), ("011", 4),
    ("0011", 5), ("0010", 6), ("00011", 7), ("000101", 8), ("000100", 9),
    ("0000100", 10), ("0000101", 11), ("0000111", 12), ("00000100", 13),
    ("00000111", 14), ("000011000", 15), ("0000010111", 16),
    ("0000011000", 17), ("0000001000", 18), ("00001100111", 19),
    ("00001101000", 20), ("00001101100", 21), ("00000110111", 22),
    ("00000101000", 23), ("00000010111", 24), ("00000011000", 25),
    ("000011001010", 26), ("000011001011", 27), ("000011001100", 28),
    ("000011001101", 29), ("000001101000", 30), ("000001101001", 31),
    ("000001101010", 32), ("000001101011", 33), ("000011010010", 34),
    ("000011010011", 35), ("000011010100", 36), ("000011010101", 37),
    ("000011010110", 38), ("000011010111", 39), ("000001101100", 40),
    ("000001101101", 41), ("000011011010", 42), ("000011011011", 43),
    ("000001010100", 44), ("000001010101", 45), ("000001010110", 46),
    ("000001010111", 47), ("000001100100", 48), ("000001100101", 49),
    ("000001010010", 50), ("000001010011", 51), ("000000100100", 52),
    ("000000110111", 53), ("000000111000", 54), ("000000100111", 55),
    ("000000101000", 56), ("000001011000", 57), ("000001011001", 58),
    ("000000101011", 59), ("000000101100", 60), ("000001011010", 61),
    ("000001100110", 62), ("000001100111", 63),
    # makeup
    ("0000001111", 64), ("000011001000", 128), ("000011001001", 192),
    ("000001011011", 256), ("000000110011", 320), ("000000110100", 384),
    ("000000110101", 448), ("0000001101100", 512), ("0000001101101", 576),
    ("0000001001010", 640), ("0000001001011", 704), ("0000001001100", 768),
    ("0000001001101", 832), ("0000001110010", 896), ("0000001110011", 960),
    ("0000001110100", 1024), ("0000001110101", 1088),
    ("0000001110110", 1152), ("0000001110111", 1216),
    ("0000001010010", 1280), ("0000001010011", 1344),
    ("0000001010100", 1408), ("0000001010101", 1472),
    ("0000001011010", 1536), ("0000001011011", 1600),
    ("0000001100100", 1664), ("0000001100101", 1728),
]

# Extended makeup codes, shared by both colours (T.4 table 3).
_EXT_CODES = [
    ("00000001000", 1792), ("00000001100", 1856), ("00000001101", 1920),
    ("000000010010", 1984), ("000000010011", 2048), ("000000010100", 2112),
    ("000000010101", 2176), ("000000010110", 2240), ("000000010111", 2304),
    ("000000011100", 2368), ("000000011101", 2432), ("000000011110", 2496),
    ("000000011111", 2560),
]

_EOL = "000000000001"


def _tree_of(codes) -> Dict:
    """Prefix-code dict tree: node = {0: child, 1: child, 'run': n}."""
    root: Dict = {}
    for bits, run in codes:
        node = root
        for ch in bits:
            node = node.setdefault(int(ch), {})
        node["run"] = run
    return root


_WHITE_TREE = _tree_of(_WHITE_CODES + _EXT_CODES)
_BLACK_TREE = _tree_of(_BLACK_CODES + _EXT_CODES)

# 2-D mode codes (T.4 table 4): value identifies the mode.
_MODE_CODES = [
    ("1", "V0"), ("011", "VR1"), ("000011", "VR2"), ("0000011", "VR3"),
    ("010", "VL1"), ("000010", "VL2"), ("0000010", "VL3"),
    ("001", "H"), ("0001", "P"),
    # 0000000... prefixes: EOL/EOFB territory, handled by the caller.
]
_MODE_TREE = _tree_of([(b, m) for b, m in _MODE_CODES])


class _Bits:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0  # bit position

    def at_end(self) -> bool:
        return self.pos >= 8 * len(self.d)

    def read(self) -> int:
        p = self.pos
        if p >= 8 * len(self.d):
            raise EOFError("CCITT: out of data")
        self.pos = p + 1
        return (self.d[p >> 3] >> (7 - (p & 7))) & 1

    def peek_bits(self, n: int) -> str:
        save = self.pos
        out = []
        try:
            for _ in range(n):
                out.append(str(self.read()))
        except EOFError:
            pass
        self.pos = save
        return "".join(out)

    def byte_align(self):
        self.pos = (self.pos + 7) & ~7

    def skip_eols(self) -> int:
        """Consume any number of EOL codes (with optional fill 0s before
        each); returns how many were consumed."""
        n = 0
        while True:
            save = self.pos
            zeros = 0
            try:
                b = self.read()
                while b == 0:
                    zeros += 1
                    b = self.read()
            except EOFError:
                self.pos = save
                return n
            if zeros >= 11:  # fill + EOL terminates in a 1
                n += 1
            else:
                self.pos = save
                return n


def _read_tree(bits: _Bits, tree: Dict):
    node = tree
    while "run" not in node:
        node = node.get(bits.read())
        if node is None:
            raise ValueError("CCITT: invalid code")
    return node["run"]


def _read_run(bits: _Bits, white: bool) -> int:
    """Total run length: makeup codes (>=64, multiples of 64) chain until
    a terminating code (<64)."""
    total = 0
    while True:
        r = _read_tree(bits, _WHITE_TREE if white else _BLACK_TREE)
        total += r
        if r < 64:
            return total


def _decode_1d_row(bits: _Bits, columns: int) -> List[int]:
    """One MH-coded row -> changing positions (transitions' x coords)."""
    changes: List[int] = []
    a0 = 0
    white = True
    while a0 < columns:
        run = _read_run(bits, white)
        a0 += run
        if a0 > columns:
            a0 = columns
        changes.append(a0)
        white = not white
    return changes


def _decode_2d_row(bits: _Bits, ref: List[int], columns: int) -> List[int]:
    """One 2-D coded row against reference changing positions `ref`."""
    changes: List[int] = []
    a0 = -1
    white = True
    while a0 < columns:
        # b1: first change on ref > a0 with colour opposite to the colour
        # of a0 (i.e. ref transition to the current colour's opposite);
        # transitions alternate starting with white->black at even index.
        i = 0
        while i < len(ref) and ref[i] <= (a0 if a0 >= 0 else -1):
            i += 1
        # parity: ref[j] for even j are white->black transitions.  b1 must
        # be a transition of the same "sense" as the one we expect next:
        if (i & 1) != (0 if white else 1):
            i += 1
        b1 = ref[i] if i < len(ref) else columns
        b2 = ref[i + 1] if i + 1 < len(ref) else columns
        mode = _read_tree(bits, _MODE_TREE)
        if mode == "P":
            a0 = b2
        elif mode == "H":
            start = a0 if a0 > 0 else 0
            r1 = _read_run(bits, white)
            r2 = _read_run(bits, not white)
            a1 = min(start + r1, columns)
            a2 = min(a1 + r2, columns)
            changes.append(a1)
            changes.append(a2)
            a0 = a2
        else:  # vertical
            delta = {"V0": 0, "VR1": 1, "VR2": 2, "VR3": 3,
                     "VL1": -1, "VL2": -2, "VL3": -3}[mode]
            a1 = min(max(b1 + delta, 0), columns)
            changes.append(a1)
            a0 = a1
            white = not white
    return changes


def _pack_row(changes: List[int], columns: int, black_is_1: bool) -> bytearray:
    """Changing positions -> packed bits for one row.  Internally runs
    start white; PDF output default (BlackIs1 false) writes black as 0,
    i.e. white pixels set their bit."""
    row = bytearray((columns + 7) // 8)
    # paint black spans [changes[2k], changes[2k+1])
    if black_is_1:
        for k in range(0, len(changes), 2):
            s = changes[k]
            e = changes[k + 1] if k + 1 < len(changes) else columns
            for x in range(s, min(e, columns)):
                row[x >> 3] |= 0x80 >> (x & 7)
    else:
        # white = 1: start with all 1s then clear black spans
        for i in range(len(row)):
            row[i] = 0xFF
        for k in range(0, len(changes), 2):
            s = changes[k]
            e = changes[k + 1] if k + 1 < len(changes) else columns
            for x in range(s, min(e, columns)):
                row[x >> 3] &= ~(0x80 >> (x & 7)) & 0xFF
        # zero the padding bits beyond `columns` for determinism
        if columns % 8:
            row[-1] &= (0xFF << (8 - columns % 8)) & 0xFF
    return row


def ccitt_decode(
    data: bytes,
    k: int = 0,
    columns: int = 1728,
    rows: int = 0,
    black_is_1: bool = False,
    byte_align: bool = False,
    end_of_block: bool = True,
) -> bytes:
    """CCITTFaxDecode -> packed 1-bpc rows, each row byte-aligned."""
    bits = _Bits(data)
    out = bytearray()
    ref: List[int] = [columns, columns]  # imaginary all-white row
    nrows = 0
    while rows <= 0 or nrows < rows:
        if byte_align and k <= 0:
            bits.byte_align()
        if bits.at_end():
            break
        try:
            if k < 0:
                # G4: rows are 2-D; EOFB = two EOLs.
                if bits.peek_bits(24) == _EOL + _EOL:
                    break
                changes = _decode_2d_row(bits, ref, columns)
            elif k == 0:
                bits.skip_eols()
                if byte_align:
                    bits.byte_align()
                if bits.at_end():
                    break
                changes = _decode_1d_row(bits, columns)
            else:
                # K>0: every row preceded by EOL + 1 tag bit (1=1-D, 2-D=0)
                got = bits.skip_eols()
                if byte_align:
                    bits.byte_align()
                if bits.at_end():
                    break
                if got:
                    one_d = bits.read() == 1
                else:
                    one_d = nrows == 0  # tolerate missing EOLs: first row 1-D
                changes = (
                    _decode_1d_row(bits, columns)
                    if one_d
                    else _decode_2d_row(bits, ref, columns)
                )
        except EOFError:
            break
        except ValueError:
            break  # damaged tail: keep the rows decoded so far
        out += _pack_row(changes, columns, black_is_1)
        ref = changes if changes else [columns, columns]
        if not ref or ref[-1] < columns:
            ref = ref + [columns, columns]
        nrows += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# Group-4 encoder (writer symmetry + round-trip tests)

_ENC_WHITE: Dict[int, str] = {run: bits for bits, run in _WHITE_CODES}
_ENC_BLACK: Dict[int, str] = {run: bits for bits, run in _BLACK_CODES}
for _b, _r in _EXT_CODES:
    _ENC_WHITE[_r] = _b
    _ENC_BLACK[_r] = _b


def _enc_run(run: int, white: bool) -> str:
    table = _ENC_WHITE if white else _ENC_BLACK
    out = []
    while run >= 64:
        m = min(run // 64 * 64, 2560)
        out.append(table[m])
        run -= m
    out.append(table[run])
    return "".join(out)


def _changes_of_row(row_bits: List[int], columns: int) -> List[int]:
    changes = []
    prev = 0  # white
    for x in range(columns):
        if row_bits[x] != prev:
            changes.append(x)
            prev = row_bits[x]
    return changes


def ccitt_encode_g4(bitmap: List[List[int]], columns: int) -> bytes:
    """Rows of 0/1 ints (1 = black) -> T.6 MMR stream ending in EOFB."""
    bits: List[str] = []
    ref = [columns, columns]
    for row in bitmap:
        changes = _changes_of_row(row, columns)
        cc = changes + [columns, columns]
        a0 = -1
        white = True
        ci = 0
        while a0 < columns:
            i = 0
            while i < len(ref) and ref[i] <= (a0 if a0 >= 0 else -1):
                i += 1
            if (i & 1) != (0 if white else 1):
                i += 1
            b1 = ref[i] if i < len(ref) else columns
            b2 = ref[i + 1] if i + 1 < len(ref) else columns
            a1 = cc[ci] if ci < len(cc) else columns
            if b2 < a1:
                bits.append("0001")  # pass
                a0 = b2
            elif abs(a1 - b1) <= 3:
                bits.append(
                    {0: "1", 1: "011", 2: "000011", 3: "0000011",
                     -1: "010", -2: "000010", -3: "0000010"}[a1 - b1]
                )
                a0 = a1
                white = not white
                ci += 1
            else:
                a2 = cc[ci + 1] if ci + 1 < len(cc) else columns
                start = a0 if a0 > 0 else 0
                bits.append("001")
                bits.append(_enc_run(a1 - start, white))
                bits.append(_enc_run(a2 - a1, not white))
                a0 = a2
                ci += 2
        ref = changes + [columns, columns]
    bits.append(_EOL + _EOL)  # EOFB
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return bytes(int(s[i : i + 8], 2) for i in range(0, len(s), 8))
