"""``mx.recordio`` of the port against the reference's, on the CPU.

Files written by either package from the same records are byte-equal
(the ``.rec`` and the ``.idx``), and each package reads the other's:
whole records, records split at the magic word, image records with
one label and with many, ``pack_img`` JPEG and PNG.
"""
import struct

import numpy as np
import pytest

from tpu_mx import recordio as jrec

from tpu_mx_torch import recordio as trec
from tpu_mx_torch.base import MXNetError

cv2 = pytest.importorskip("cv2")


def _payloads():
    rng = np.random.RandomState(0)
    out = [b"", b"a", b"abc", b"abcd", b"x" * 1001]
    out += [rng.bytes(rng.randint(1, 300)) for _ in range(20)]
    # a payload holding the magic word
    out.append(b"head" + struct.pack("<I", 0xCED7230A) + b"tail")
    return out


def _write(mod, path, payloads, indexed):
    if indexed:
        w = mod.MXIndexedRecordIO(path + ".idx", path, "w")
        for i, p in enumerate(payloads):
            w.write_idx(i, p)
    else:
        w = mod.MXRecordIO(path, "w")
        for p in payloads:
            w.write(p)
    w.close()


@pytest.mark.parametrize("indexed", [False, True], ids=["plain", "indexed"])
def test_files_are_byte_equal(tmp_path, indexed):
    payloads = _payloads()
    a, b = str(tmp_path / "ref.rec"), str(tmp_path / "port.rec")
    _write(jrec, a, payloads, indexed)
    _write(trec, b, payloads, indexed)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    if indexed:
        with open(a + ".idx") as fa, open(b + ".idx") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["reference_to_port", "port_to_reference"])
def test_each_reads_the_others(tmp_path, writer, reader):
    payloads = _payloads()
    path = str(tmp_path / "x.rec")
    _write(writer, path, payloads, indexed=True)
    r = reader.MXRecordIO(path, "r")
    got = []
    while True:
        p = r.read()
        if p is None:
            break
        got.append(p)
    r.close()
    assert got == payloads
    r = reader.MXIndexedRecordIO(path + ".idx", path, "r")
    assert r.keys == list(range(len(payloads)))
    for k in (7, 0, len(payloads) - 1, 3):
        assert r.read_idx(k) == payloads[k]
    r.close()


def test_split_records_read_alike(tmp_path):
    """A record split in three at the magic word (continuation flags 1,
    2, 3), as the reference's C++ writer makes them."""
    magic = struct.pack("<I", 0xCED7230A)
    parts = [b"first", b"mid", b"last!"]
    path = str(tmp_path / "split.rec")
    with open(path, "wb") as f:
        for flag, part in zip((1, 2, 3), parts):
            f.write(magic + struct.pack("<I", (flag << 29) | len(part)))
            f.write(part + b"\0" * ((4 - len(part) % 4) % 4))
        f.write(magic + struct.pack("<I", 3) + b"end\0")
    for mod in (jrec, trec):
        r = mod.MXRecordIO(path, "r")
        assert r.read() == magic.join(parts)
        assert r.read() == b"end"
        assert r.read() is None
        r.close()


def test_truncated_and_bad_magic_raise(tmp_path):
    path = str(tmp_path / "bad.rec")
    with open(path, "wb") as f:
        f.write(struct.pack("<II", 0x12345678, 4) + b"abcd")
    r = trec.MXRecordIO(path, "r")
    with pytest.raises(MXNetError, match="magic"):
        r.read()
    r.close()
    with open(path, "wb") as f:
        f.write(struct.pack("<II", 0xCED7230A, 40) + b"abcd")
    r = trec.MXRecordIO(path, "r")
    with pytest.raises(MXNetError, match="truncated"):
        r.read()
    r.close()
    with pytest.raises(MXNetError, match="flag"):
        trec.MXRecordIO(path, "a")


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -1.0, 0.25, 7.0]],
                         ids=["scalar", "vector"])
def test_pack_unpack_headers(label):
    header = (0, label, 17, 4)
    s = trec.pack(header, b"payload")
    assert s == jrec.pack(header, b"payload")
    h, body = trec.unpack(s)
    rh, rbody = jrec.unpack(s)
    assert body == rbody == b"payload"
    np.testing.assert_array_equal(np.asarray(h.label), np.asarray(rh.label))
    assert (h.flag, h.id, h.id2) == (rh.flag, rh.id, rh.id2)


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_and_unpack_img(fmt):
    rng = np.random.RandomState(1)
    img = (rng.rand(24, 40, 3) * 255).astype(np.uint8)
    header = trec.IRHeader(0, 5.0, 1, 0)
    s = trec.pack_img(header, img, quality=80, img_fmt=fmt)
    assert s == jrec.pack_img(header, img, quality=80, img_fmt=fmt)
    h, got = trec.unpack_img(s)
    _, want = jrec.unpack_img(s)
    np.testing.assert_array_equal(got, want)
    assert h.label == 5.0
    with pytest.raises(MXNetError, match="format"):
        trec.pack_img(header, img, img_fmt=".bmp")


def test_aliases_and_context_manager(tmp_path):
    assert trec.RecordIO is trec.MXRecordIO
    assert trec.IndexedRecordIO is trec.MXIndexedRecordIO
    path = str(tmp_path / "c.rec")
    with trec.MXRecordIO(path, "w") as w:
        w.write(b"abc")
        assert w.tell() == 12
    r = trec.MXRecordIO(path, "r")
    assert r.read() == b"abc"
    r.reset()
    assert r.read() == b"abc"
    r.close()
