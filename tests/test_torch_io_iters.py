"""The file and record iterators of the port's ``mx.io`` against the
reference's, on the CPU: ``ResizeIter``, ``MNISTIter``, ``CSVIter``, the
Python arm of ``ImageRecordIter`` (exact on uint8) and of
``ImageDetRecordIter``, and ``NDArrayIter``'s elastic sharding (the
global sequence the same at world sizes 1, 2 and 4, ``set_shard`` mid
epoch, a sharded state restored at another world size), and
``LibSVMIter`` (once refused by name, now the reference's batches).
"""
import gzip
import struct

import numpy as np
import pytest

import tpu_mx as jmx

import tpu_mx_torch as mx
from tpu_mx_torch import recordio as trec
from tpu_mx_torch.base import MXNetError

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _batches(it):
    return [(tuple(a.asnumpy() for a in b.data),
             tuple(a.asnumpy() for a in b.label), b.pad) for b in it]


def _assert_same(got, want, exact=True):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.shape == w.shape and g.dtype == w.dtype
            if exact:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)


def _both(name, *args, **kw):
    return getattr(mx.io, name)(*args, **kw), \
        getattr(jmx.io, name)(*args, **kw)


@pytest.mark.parametrize("size", [2, 7], ids=["cut", "extended"])
def test_resize_iter(size):
    data = np.arange(40, dtype=np.float32).reshape(10, 4)
    got = mx.io.ResizeIter(mx.io.NDArrayIter(data, batch_size=3), size)
    want = jmx.io.ResizeIter(jmx.io.NDArrayIter(data, batch_size=3), size)
    for _ in range(2):
        _assert_same(_batches(got), _batches(want))
        got.reset()
        want.reset()
    state = got.state_dict()
    got.next()
    got.load_state_dict(state)
    assert got.cur == 0
    assert got.provide_data[0].shape == (3, 4)


def _idx_file(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(b"".join(struct.pack(">I", n) for n in arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("flat", [False, True], ids=["nchw", "flat"])
def test_mnist_iter(tmp_path, flat):
    rng = np.random.RandomState(0)
    img, lab = str(tmp_path / "img.gz"), str(tmp_path / "lab.gz")
    _idx_file(img, rng.randint(0, 256, (50, 28, 28)))
    _idx_file(lab, rng.randint(0, 10, 50))
    got, want = _both("MNISTIter", image=img, label=lab, batch_size=16,
                      flat=flat)
    _assert_same(_batches(got), _batches(want))
    assert len(_batches(got)) == 0           # the epoch was consumed
    got.reset()
    want.reset()
    _assert_same(_batches(got), _batches(want))
    assert got.provide_data[0].shape == ((16, 784) if flat
                                         else (16, 1, 28, 28))


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter(tmp_path, round_batch):
    rng = np.random.RandomState(1)
    data, label = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(data, rng.rand(11, 6), delimiter=",")
    np.savetxt(label, rng.randint(0, 3, (11, 1)), delimiter=",")
    for kw in ({"label_csv": label}, {}):
        got, want = _both("CSVIter", data_csv=data, data_shape=(2, 3),
                          batch_size=4, round_batch=round_batch, **kw)
        _assert_same(_batches(got), _batches(want))


def _smooth(rng, h, w):
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([np.sin(5 * x + c) * np.cos(3 * y - c) for c in
                     rng.uniform(0, 3, 3)], -1)
    return np.clip((base + 1) * 110 + rng.normal(0, 10, (h, w, 3)), 0,
                   255).astype(np.uint8)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("iters")
    path = str(d / "x.rec")
    w = trec.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    rng = np.random.RandomState(3)
    for i in range(21):
        img = _smooth(rng, rng.randint(36, 60), rng.randint(36, 60))
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i % 5), i, 0),
                                     img, quality=90))
    w.close()
    return path


@pytest.mark.parametrize("fmt", [("uint8", "NHWC"), ("uint8", "NCHW"),
                                 ("float32", "NCHW")],
                         ids=["u8_nhwc", "u8_nchw", "f32_nchw"])
@pytest.mark.parametrize("indexed", [False, True], ids=["scan", "idx"])
def test_image_record_iter_python_arm(records, fmt, indexed):
    kw = dict(path_imgrec=records, data_shape=(3, 24, 24), batch_size=6,
              shuffle=True, rand_crop=True, rand_mirror=True, resize=30,
              seed=7, preprocess_threads=3, use_native=False,
              output_dtype=fmt[0], output_layout=fmt[1], mean_r=100.0,
              std_b=40.0)
    if indexed:
        kw["path_imgidx"] = records[:-4] + ".idx"
    got, want = _both("ImageRecordIter", **kw)
    assert not got.uses_native
    _assert_same(_batches(got), _batches(want), exact=fmt[0] == "uint8")
    assert [b.pad for b in (got.reset() or got)] == [0, 0, 0, 3]
    got.reset()
    got.next()
    state = got.state_dict()
    rest = _batches(got)
    again = mx.io.ImageRecordIter(**kw)
    again.load_state_dict(state)
    _assert_same(_batches(again), rest)
    got.close()


def test_image_record_iter_no_round_batch_and_png(tmp_path, records):
    got, want = _both("ImageRecordIter", path_imgrec=records,
                      data_shape=(3, 20, 20), batch_size=8,
                      round_batch=False, use_native=None)
    assert not got.uses_native                    # round_batch=False
    _assert_same(_batches(got), _batches(want))
    png = str(tmp_path / "png.rec")
    w = trec.MXRecordIO(png, "w")
    w.write(trec.pack_img(trec.IRHeader(0, 1.0, 0, 0),
                          np.zeros((20, 20, 3), np.uint8), img_fmt=".png"))
    w.close()
    with pytest.raises(MXNetError, match="JPEG"):
        mx.io.ImageRecordIter(path_imgrec=png, data_shape=(3, 8, 8),
                              batch_size=1, use_native=True)


def test_unbuildable_library_warns_then_takes_the_python_arm(records,
                                                             monkeypatch):
    from tpu_mx_torch.lib import NativeBuildError, recordio_cpp

    def unbuildable():
        raise NativeBuildError("no libjpeg on this host")

    monkeypatch.setattr(recordio_cpp, "_load", unbuildable)
    kw = dict(path_imgrec=records, data_shape=(3, 16, 16), batch_size=7)
    with pytest.warns(UserWarning, match="no libjpeg"):
        it = mx.io.ImageRecordIter(**kw)
    assert not it.uses_native
    _assert_same(_batches(it), _batches(
        jmx.io.ImageRecordIter(use_native=False, **kw)))
    with pytest.raises(NativeBuildError):
        mx.io.ImageRecordIter(use_native=True, **kw)


@pytest.fixture(scope="module")
def det_records(tmp_path_factory):
    d = tmp_path_factory.mktemp("det_iters")
    path = str(d / "det.rec")
    w = trec.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    rng = np.random.RandomState(4)
    for i in range(10):
        m = rng.randint(1, 4)
        lo = rng.uniform(0, 0.5, (m, 2))
        boxes = np.concatenate([rng.randint(0, 5, (m, 1)), lo,
                                lo + rng.uniform(0.2, 0.5, (m, 2))], 1)
        w.write_idx(i, trec.pack_img(
            trec.IRHeader(0, boxes.ravel().tolist(), i, 0),
            _smooth(rng, 40, 48), quality=90))
    w.close()
    return path


def test_image_det_record_iter_python_arm(det_records):
    import random
    runs = []
    for io_ in (mx.io, jmx.io):
        random.seed(5)
        it = io_.ImageDetRecordIter(det_records, (3, 32, 32), 4,
                                    shuffle=True, rand_crop=1,
                                    rand_mirror=True, use_native=False,
                                    mean_r=10.0)
        runs.append(_batches(it))
    _assert_same(*runs, exact=False)
    with pytest.raises(MXNetError, match="native"):
        mx.io.ImageDetRecordIter(det_records, (3, 8, 8), 2,
                                 output_dtype="uint8", use_native=False)


def _global_sequence(io_, world, epochs=2, **kw):
    data = np.arange(26, dtype=np.float32).reshape(13, 2)
    its = [io_.NDArrayIter(data, batch_size=4, shuffle=True, seed=11,
                           num_workers=world, rank=r, **kw)
           for r in range(world)]
    seq = []
    for _ in range(epochs):
        for it in its:
            it.reset()
        while all([it.iter_next() for it in its]):
            ids = [it.global_batch_ids() for it in its]
            assert all((i == ids[0]).all() for i in ids)
            rows = np.concatenate([it.getdata()[0].asnumpy()[:, 0] / 2
                                   for it in its])
            np.testing.assert_array_equal(rows, ids[0])
            seq.append((ids[0].tolist(), [it.getpad() for it in its]))
    return seq


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_sharding_global_sequence_is_the_same_at_every_world_size(handle):
    ref = _global_sequence(jmx.io, 1, last_batch_handle=handle)
    for world in (1, 2, 4):
        got = _global_sequence(mx.io, world, last_batch_handle=handle)
        assert [ids for ids, _ in got] == [ids for ids, _ in ref]
        assert got == _global_sequence(jmx.io, world,
                                       last_batch_handle=handle)


def test_set_shard_mid_epoch_and_v2_state_at_another_world_size():
    data = np.arange(48, dtype=np.float32).reshape(24, 2)
    it = mx.io.NDArrayIter(data, batch_size=4, shuffle=True, seed=3,
                           num_workers=2, rank=1)
    ref = jmx.io.NDArrayIter(data, batch_size=4, shuffle=True, seed=3,
                             num_workers=2, rank=1)
    for x in (it, ref):
        x.next()
        x.set_shard(0, 4)
    np.testing.assert_array_equal(it.next().data[0].asnumpy(),
                                  ref.next().data[0].asnumpy())
    state = it.state_dict()
    assert state["version"] == 2 and state["shard"]["num_workers"] == 4
    rest = []
    while it.iter_next():
        rest.append(it.global_batch_ids())
    wide = mx.io.NDArrayIter(data, batch_size=4, shuffle=True, seed=3,
                             num_workers=1)
    wide.load_state_dict(state)
    again = []
    while wide.iter_next():
        again.append(wide.global_batch_ids())
    assert [a.tolist() for a in again] == [r.tolist() for r in rest]
    with pytest.raises(MXNetError, match="global batch"):
        mx.io.NDArrayIter(data, batch_size=8, num_workers=2).load_state_dict(
            state)
    v1 = mx.io.NDArrayIter(data, batch_size=4).state_dict()
    with pytest.raises(MXNetError, match="shard map"):
        mx.io.NDArrayIter(data, batch_size=4,
                          num_workers=2).load_state_dict(v1)
    with pytest.raises(MXNetError, match="divisible"):
        mx.io.NDArrayIter(data, batch_size=4, num_workers=3)
    with pytest.raises(MXNetError, match="out of range"):
        mx.io.NDArrayIter(data, batch_size=4, num_workers=2, rank=2)


def test_libsvm_iter_is_refused_by_name(tmp_path):
    # ported since: the iterator the reference's name gives, batch for
    # batch the reference's (tests/test_torch_sparse.py holds the rest)
    from tpu_mx_torch.io import io as tio
    assert mx.io.LibSVMIter is tio.LibSVMIter
    f = tmp_path / "d.libsvm"
    f.write_text("1 0:1.5 3:2.0\n0 1:1.0\n1 2:3.0 4:0.5\n")
    got = list(mx.io.LibSVMIter(data_libsvm=str(f), data_shape=(5,),
                                batch_size=2))
    want = list(jmx.io.LibSVMIter(data_libsvm=str(f), data_shape=(5,),
                                  batch_size=2))
    assert [b.pad for b in got] == [b.pad for b in want] == [0, 1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data[0].asnumpy(),
                                      w.data[0].asnumpy())
        np.testing.assert_array_equal(g.label[0].asnumpy(),
                                      w.label[0].asnumpy())
