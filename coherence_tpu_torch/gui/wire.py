"""Wire format for GUI traffic (parity: reference ``camlpy.ml`` /
``pycaml.py``).

A frame is a 4-byte big-endian payload length followed by one tagged value:

  tag 0 Tuple  : 4-byte BE byte-length of contents, then the elements
  tag 1 Unit   : nothing
  tag 2 Int    : 4-byte BE
  tag 3 String : 4-byte BE length + raw bytes
  tag 4 Bool   : 1 byte

Python mapping (as the reference's Python peer uses): list <-> Tuple,
None <-> Unit, int, bool, str/bytes <-> String.

The port's copy of ``coherence_tpu.gui.wire``, unchanged: both packages
write the same bytes for the same value.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple, Union

TAG_TUPLE = 0
TAG_UNIT = 1
TAG_INT = 2
TAG_STRING = 3
TAG_BOOL = 4

Value = Union[list, None, int, bool, bytes, str]


def _marshall_inner(out: bytearray, v: Value) -> None:
    if isinstance(v, bool):  # before int: bool is an int subclass
        out.append(TAG_BOOL)
        out.append(1 if v else 0)
    elif isinstance(v, int):
        out.append(TAG_INT)
        out += struct.pack(">i", v)
    elif v is None:
        out.append(TAG_UNIT)
    elif isinstance(v, (bytes, str)):
        b = v.encode("latin1") if isinstance(v, str) else v
        out.append(TAG_STRING)
        out += struct.pack(">I", len(b))
        out += b
    elif isinstance(v, (list, tuple)):
        out.append(TAG_TUPLE)
        lenpos = len(out)
        out += b"\x00\x00\x00\x00"
        start = len(out)
        for x in v:
            _marshall_inner(out, x)
        out[lenpos : lenpos + 4] = struct.pack(">I", len(out) - start)
    else:
        raise TypeError(f"not marshallable: {v!r}")


def marshall(v: Value) -> bytes:
    """Serialize one value to a length-prefixed frame."""
    out = bytearray(b"\x00\x00\x00\x00")
    _marshall_inner(out, v)
    out[0:4] = struct.pack(">I", len(out) - 4)
    return bytes(out)


class InvalidData(Exception):
    pass


def _unmarshall_seq(data: bytes, pos: int, end: int) -> List[Value]:
    vals: List[Value] = []
    while pos < end:
        tag = data[pos]
        pos += 1
        if tag == TAG_INT:
            vals.append(struct.unpack(">i", data[pos : pos + 4])[0])
            pos += 4
        elif tag == TAG_UNIT:
            vals.append(None)
        elif tag == TAG_BOOL:
            vals.append(data[pos] != 0)
            pos += 1
        elif tag == TAG_STRING:
            (n,) = struct.unpack(">I", data[pos : pos + 4])
            pos += 4
            vals.append(data[pos : pos + n])
            pos += n
        elif tag == TAG_TUPLE:
            (n,) = struct.unpack(">I", data[pos : pos + 4])
            pos += 4
            vals.append(_unmarshall_seq(data, pos, pos + n))
            pos += n
        else:
            raise InvalidData(f"bad tag {tag}")
    if pos != end:
        raise InvalidData("overrun")
    return vals


def unmarshall(buf: bytes) -> Optional[Tuple[int, Value]]:
    """First complete frame of `buf` -> (bytes consumed, value), or None if
    incomplete (camlpy.ml:110-124)."""
    if len(buf) < 4:
        return None
    (n,) = struct.unpack(">I", buf[0:4])
    if len(buf) < 4 + n:
        return None
    vals = _unmarshall_seq(buf, 4, 4 + n)
    if len(vals) != 1:
        raise InvalidData("frame must hold exactly one value")
    return 4 + n, vals[0]
