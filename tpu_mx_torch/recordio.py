"""RecordIO, from ``tpu_mx/recordio.py``: the packed dataset format of
the reference, byte for byte.

A seekable stream of length-prefixed records with a magic word per
record (:class:`MXRecordIO`), an indexed variant for random access
(:class:`MXIndexedRecordIO`, a ``key\toffset`` text index beside the
file), and the image-record header (``IRHeader``) that ``im2rec`` and
``ImageRecordIter`` use.  ``pack_img``/``unpack_img`` encode and decode
with OpenCV, imported when called, as the reference does.

Format (little-endian), identical to dmlc recordio so .rec files made by the
reference's tools remain readable and vice versa:

    [uint32 kMagic=0xced7230a][uint32 lrec][data][0-3 pad bytes]

``lrec``: upper 3 bits = continuation flag (0 whole, 1 begin / 2 middle /
3 end of a split record), lower 29 bits = payload length.  Records whose
payload contains the magic word are split by the writer in the C++ impl; we
write whole records (payloads < 2**29) and *read* both forms.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "RecordIO", "IndexedRecordIO",
           "IRHeader", "pack", "unpack", "pack_img", "unpack_img"]

_kMagic = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", _kMagic)
_LEN_MASK = (1 << 29) - 1


def _check(cond, msg):
    if not cond:
        raise MXNetError(msg)


class MXRecordIO:
    """Sequential RecordIO reader (``flag="r"``) or writer (``"w"``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        _check(flag in ("r", "w"), f"invalid flag {flag!r}; use 'r' or 'w'")
        self.open()

    def open(self):
        self.record = open(self.uri, "rb" if self.flag == "r" else "wb")
        self.is_open = True

    def close(self):
        if getattr(self, "is_open", False):
            self.record.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def tell(self):
        return self.record.tell()

    def write(self, buf):
        _check(self.flag == "w", "not opened for writing")
        _check(len(buf) <= _LEN_MASK, "record too large (>512MB)")
        data = bytes(buf)
        # whole records (flag 0), as the reference writes them; both
        # readers also take split ones
        self.record.write(_MAGIC_BYTES)
        self.record.write(struct.pack("<I", len(data)))
        self.record.write(data)
        pad = (4 - len(data) % 4) % 4
        if pad:
            self.record.write(b"\x00" * pad)

    def read(self):
        """Next record's payload as bytes, or None at EOF."""
        _check(self.flag == "r", "not opened for reading")
        parts = []
        while True:
            head = self.record.read(8)
            if len(head) < 8:
                if parts:
                    raise MXNetError("truncated record at EOF")
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _kMagic:
                raise MXNetError(
                    f"invalid record magic {magic:#x} at "
                    f"{self.record.tell() - 8}")
            cflag, length = lrec >> 29, lrec & _LEN_MASK
            data = self.record.read(length)
            if len(data) != length:
                raise MXNetError("truncated record payload")
            pad = (4 - length % 4) % 4
            if pad:
                self.record.read(pad)
            if cflag == 0:
                _check(not parts, "unexpected whole record inside split")
                return data
            parts.append(data)
            if cflag == 3:  # end of split record: joined by magic bytes
                return _MAGIC_BYTES.join(parts)


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a ``.idx`` text file of ``key\\toffset`` lines for
    random access."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        if self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if getattr(self, "is_open", False) and self.flag == "w":
            self.fidx.close()
        super().close()

    def seek(self, idx):
        _check(self.flag == "r", "not opened for reading")
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


# -- image record header ------------------------------------------------------
# struct IRHeader {uint32 flag; float label; uint64 id, id2;}: 'IfQQ'.
# flag > 0 means `flag` float32 labels follow the header (multi-label and
# detection records).
IRHeader = collections.namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack ``IRHeader`` + byte payload into one record payload."""
    header = IRHeader(*header)
    label = header.label
    if isinstance(label, (np.ndarray, list, tuple)):
        label = np.asarray(label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """Inverse of :func:`pack` → (IRHeader, payload bytes)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32).copy()
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode ``img`` (HWC uint8 ndarray) and pack it with ``header``."""
    import cv2
    _check(img_fmt.lower() in (".jpg", ".jpeg", ".png"),
          f"unsupported image format {img_fmt}")
    if img_fmt.lower() in (".jpg", ".jpeg"):
        params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    else:
        params = [cv2.IMWRITE_PNG_COMPRESSION, quality // 10]
    ok, buf = cv2.imencode(img_fmt, img, params)
    _check(ok, "cv2.imencode failed")
    return pack(header, buf.tobytes())


# the short names gluon.data uses
RecordIO = MXRecordIO
IndexedRecordIO = MXIndexedRecordIO


def unpack_img(s, iscolor=1):
    """Inverse of :func:`pack_img` → (IRHeader, decoded HWC ndarray)."""
    import cv2
    header, img_bytes = unpack(s)
    img = cv2.imdecode(np.frombuffer(img_bytes, dtype=np.uint8), iscolor)
    return header, img
