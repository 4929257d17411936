"""Minimal protobuf wire-format codec (encoder + decoder), the port's own
copy of ``tpu_mx/contrib/_protobuf.py`` (a stdlib-only module; the port
imports nothing of the reference).

The port depends on neither the ``onnx`` nor the ``protobuf`` package,
so ``contrib.onnx`` writes and reads the ONNX protobuf wire format
directly
(the stable public protobuf encoding:
https://protobuf.dev/programming-guides/encoding/).

Only what ONNX needs: varint (wire 0), 64-bit (wire 1, unused), and
length-delimited (wire 2) fields; float scalars ride as fixed32 (wire 5).
Messages are built bottom-up as bytes; the decoder returns a
{field_number: [values]} multimap with raw bytes for nested messages.
"""
from __future__ import annotations

import struct

__all__ = ["Msg", "decode", "varint", "zigzag_ok"]


def varint(n: int) -> bytes:
    """Unsigned LEB128 (negative ints are 10-byte two's-complement, as
    protobuf encodes int32/int64)."""
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class Msg:
    """Append-only protobuf message writer."""

    def __init__(self):
        self._parts = []

    def _tag(self, field, wire):
        self._parts.append(varint((field << 3) | wire))

    def int(self, field, value):
        """varint field (int32/int64/uint64/bool/enum)."""
        self._tag(field, 0)
        self._parts.append(varint(int(value)))
        return self

    def float(self, field, value):
        """float field (fixed 32-bit)."""
        self._tag(field, 5)
        self._parts.append(struct.pack("<f", float(value)))
        return self

    def bytes(self, field, value):
        """length-delimited field: bytes, str, or a nested Msg."""
        if isinstance(value, Msg):
            value = value.tobytes()
        elif isinstance(value, str):
            value = value.encode("utf-8")
        self._tag(field, 2)
        self._parts.append(varint(len(value)))
        self._parts.append(value)
        return self

    def ints(self, field, values):
        """repeated int64, packed encoding."""
        payload = b"".join(varint(int(v)) for v in values)
        return self.bytes(field, payload)

    def tobytes(self) -> bytes:
        return b"".join(self._parts)


def _read_varint(buf, i):
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def decode(buf) -> dict:
    """Parse one message into {field_number: [raw values]}.  Varints come
    back as ints, length-delimited fields as bytes (decode nested messages
    recursively; decode packed int64 lists with decode_packed_ints)."""
    fields = {}
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val = struct.unpack("<q", buf[i:i + 8])[0]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = bytes(buf[i:i + ln])
            i += ln
        elif wire == 5:
            val = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def decode_packed_ints(raw) -> list:
    """Packed repeated int64 payload -> [int] (also accepts a list of
    already-unpacked varints, the non-packed encoding)."""
    if isinstance(raw, list):
        out = []
        for r in raw:
            out.extend(decode_packed_ints(r) if isinstance(r, (bytes,
                       bytearray)) else [r])
        return out
    out, i = [], 0
    while i < len(raw):
        v, i = _read_varint(raw, i)
        if v >= 1 << 63:
            v -= 1 << 64
        out.append(v)
    return out


def zigzag_ok():  # pragma: no cover - marker for API completeness
    """ONNX uses no sint fields; zigzag is deliberately unimplemented."""
    return False
