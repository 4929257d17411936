"""The port's native data pipeline (``tpu_mx_torch.lib``) against the
reference's, on the CPU.

Both build the unchanged ``native/tpumx_io.cpp``: the port into
``build/tpu_mx_torch/``, the reference next to its package.  From the
same records and seed the two pipes give bit-equal batches, float32
NCHW with mean/std and uint8 NHWC, with random crop, mirror and
shuffle; the detection pipe too; ``native_im2rec`` writes the same
files; ``ImageRecordIter`` and ``ImageDetRecordIter`` take the native
arm by default and give the reference's batches.
"""
import os

import numpy as np
import pytest

import tpu_mx as jmx
from tpu_mx.lib import recordio_cpp as jcpp

import tpu_mx_torch as mx
from tpu_mx_torch import lib as tlib
from tpu_mx_torch import recordio as trec
from tpu_mx_torch.lib import recordio_cpp as tcpp

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _smooth(rng, h, w):
    """A smooth RGB field with noise (compresses like a photograph)."""
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(6 * x + c) * np.cos(4 * y - c) for c in
                     rng.uniform(0, 3, 3)], -1)
    img = (base + 1) * 110 + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """30 JPEG records of 40-64 px; labels are the index."""
    d = tmp_path_factory.mktemp("native")
    path = str(d / "cls.rec")
    rng = np.random.RandomState(0)
    w = trec.MXRecordIO(path, "w")
    for i in range(30):
        img = _smooth(rng, rng.randint(40, 64), rng.randint(40, 64))
        w.write(trec.pack_img(trec.IRHeader(0, float(i), i, 0), img,
                              quality=90))
    w.close()
    return path


@pytest.fixture(scope="module")
def det_records(tmp_path_factory):
    """20 JPEG records with 1-4 boxes each ([cls, x1, y1, x2, y2])."""
    d = tmp_path_factory.mktemp("det")
    path = str(d / "det.rec")
    rng = np.random.RandomState(1)
    w = trec.MXRecordIO(path, "w")
    for i in range(20):
        img = _smooth(rng, 48, 56)
        m = rng.randint(1, 5)
        lo = rng.uniform(0, 0.5, (m, 2))
        boxes = np.concatenate([rng.randint(0, 20, (m, 1)), lo,
                                lo + rng.uniform(0.2, 0.5, (m, 2))], 1)
        w.write(trec.pack_img(trec.IRHeader(0, boxes.ravel().tolist(), i, 0),
                              img, quality=90))
    w.close()
    return path


def _epoch(pipe):
    out = []
    while True:
        b = pipe.next_batch()
        if b is None:
            return out
        out.append(b)


def test_the_build_goes_to_build_never_to_the_reference():
    so = tlib.ensure_built()
    assert os.path.dirname(so) == os.path.join(ROOT, "build", "tpu_mx_torch")
    assert tlib._BUILD == os.path.dirname(so)
    assert not os.path.relpath(so, ROOT).startswith("tpu_mx" + os.sep)
    assert os.path.basename(so).startswith("libtpumx_io-")
    assert tlib.ensure_built() == so                  # built once
    assert tcpp._load()._name == so
    what, flags = tlib.jpeg_link()
    assert what == "system" or "-I" in flags


@pytest.mark.parametrize("fmt", [("float32", "NCHW"), ("uint8", "NHWC")],
                         ids=["f32_nchw", "u8_nhwc"])
def test_image_pipe_bit_equal_to_the_references(records, fmt):
    kw = dict(batch_size=8, data_shape=(3, 32, 32), resize=40,
              rand_crop=True, rand_mirror=True, shuffle=True, seed=5,
              preprocess_threads=3, output_dtype=fmt[0],
              output_layout=fmt[1])
    if fmt[0] == "float32":
        kw.update(mean=(123.0, 117.0, 104.0), std=(58.0, 57.0, 57.5))
    got = _epoch(tcpp.NativeImagePipe(records, **kw))
    want = _epoch(jcpp.NativeImagePipe(records, **kw))
    assert len(got) == len(want) == 4
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd.dtype == wd.dtype and gd.shape == wd.shape
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_image_pipe_seeded_runs_equal_and_reset(records):
    kw = dict(batch_size=10, data_shape=(3, 24, 24), rand_crop=True,
              rand_mirror=True, shuffle=True, seed=9, preprocess_threads=4)
    a, b = tcpp.NativeImagePipe(records, **kw), \
        tcpp.NativeImagePipe(records, **kw)
    ea, eb = _epoch(a), _epoch(b)
    for (da, la), (db, lb) in zip(ea, eb):
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)
    a.reset()
    again = _epoch(a)
    assert sorted(np.concatenate([l for _, l in again]).tolist()) == \
        list(map(float, range(30)))
    assert len(a) == 30
    a.close()
    b.close()


def test_det_pipe_bit_equal_to_the_references(det_records):
    kw = dict(batch_size=6, data_shape=(3, 40, 40), max_objects=4,
              rand_crop=True, rand_mirror=True, shuffle=True, seed=3,
              preprocess_threads=2)
    got = _epoch(tcpp.NativeDetPipe(det_records, **kw))
    want = _epoch(jcpp.NativeDetPipe(det_records, **kw))
    assert len(got) == len(want) == 4
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gl.shape == (6, 4, 5)


def test_bad_arguments_and_files_raise(tmp_path, records):
    with pytest.raises(ValueError, match="output_dtype"):
        tcpp.NativeImagePipe(records, 2, (3, 8, 8), output_dtype="f16")
    with pytest.raises(ValueError, match="output_layout"):
        tcpp.NativeDetPipe(records, 2, (3, 8, 8), 2, output_layout="CHW")
    bad = tmp_path / "bad.rec"
    bad.write_bytes(b"not a recordio file at all")
    with pytest.raises(IOError):
        tcpp.NativeImagePipe(str(bad), batch_size=2, data_shape=(3, 8, 8))


@pytest.mark.parametrize("resize", [0, 32], ids=["bytes", "resized"])
def test_native_im2rec_round_trip_and_reference_files(tmp_path, resize):
    rng = np.random.RandomState(2)
    root = tmp_path / "img"
    root.mkdir()
    lines, imgs = [], []
    for i in range(12):
        img = _smooth(rng, 40 + i, 50)
        cv2.imwrite(str(root / f"{i}.jpg"), img)
        imgs.append(img)
        lines.append(f"{i}\t{i % 3}.0\t{i}.jpg")
    lst = tmp_path / "set.lst"
    lst.write_text("\n".join(lines) + "\n")
    outs = {}
    for name, fn in (("port", tcpp.native_im2rec),
                     ("ref", jcpp.native_im2rec)):
        prefix = str(tmp_path / name)
        assert fn(str(lst), str(root), prefix, resize=resize, quality=90,
                  num_thread=3) == 12
        with open(prefix + ".rec", "rb") as f:
            outs[name] = f.read()
    assert outs["port"] == outs["ref"]
    r = trec.MXIndexedRecordIO(str(tmp_path / "port.idx"),
                               str(tmp_path / "port.rec"), "r")
    for i in range(12):
        header, img = trec.unpack_img(r.read_idx(i))
        assert header.label == float(i % 3)
        if resize == 0:
            with open(root / f"{i}.jpg", "rb") as f:
                assert trec.unpack(r.read_idx(i))[1] == f.read()
        else:
            assert min(img.shape[:2]) == 32
    r.close()


@pytest.mark.parametrize("fmt", [("float32", "NCHW"), ("uint8", "NHWC")],
                         ids=["f32_nchw", "u8_nhwc"])
def test_image_record_iter_native_arm_equals_the_references(records, fmt):
    kw = dict(path_imgrec=records, data_shape=(3, 28, 28), batch_size=8,
              shuffle=True, rand_crop=True, rand_mirror=True, resize=36,
              seed=4, preprocess_threads=2, output_dtype=fmt[0],
              output_layout=fmt[1], mean_r=120.0, std_g=50.0)
    it = mx.io.ImageRecordIter(**kw)
    ref = jmx.io.ImageRecordIter(**kw)
    assert it.uses_native and ref._native is not None
    got, want = list(it), list(ref)
    assert [b.pad for b in got] == [b.pad for b in want] == [0, 0, 0, 2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data[0].asnumpy(),
                                      w.data[0].asnumpy())
        np.testing.assert_array_equal(g.label[0].asnumpy(),
                                      w.label[0].asnumpy())
    assert it.provide_data[0].shape == ref.provide_data[0].shape
    with pytest.raises(NotImplementedError):
        it.state_dict()


def test_image_det_record_iter_native_arm_equals_the_references(det_records):
    kw = dict(shuffle=True, rand_crop=1, rand_mirror=True, seed=2,
              preprocess_threads=2, output_dtype="uint8")
    it = mx.io.ImageDetRecordIter(det_records, (3, 32, 32), 5, **kw)
    ref = jmx.io.ImageDetRecordIter(det_records, (3, 32, 32), 5, **kw)
    assert it.uses_native and it.max_objects == ref.max_objects == 4
    for g, w in zip(list(it), list(ref)):
        np.testing.assert_array_equal(g.data[0].asnumpy(),
                                      w.data[0].asnumpy())
        np.testing.assert_array_equal(g.label[0].asnumpy(),
                                      w.label[0].asnumpy())
        assert g.pad == w.pad
    assert it.provide_label[0].shape == (5, 4, 5)
