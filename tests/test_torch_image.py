"""``mx.image`` of the port against the reference's, on the CPU: decode
(JPEG and PNG, colour and grey), resize (uint8 through Pillow, float
through OpenCV), the crop helpers, the 18 augmenters and
``CreateAugmenter`` on the same draws, ``ImageIter`` over a record file
and over an image list, the detection augmenters and ``ImageDetIter``.
"""
import random

import numpy as np
import pytest

import tpu_mx as jmx
from tpu_mx import image as jimg

import tpu_mx_torch as mx
from tpu_mx_torch import image as timg
from tpu_mx_torch import recordio as trec

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b, exact=True):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (a.shape, b.shape, a.dtype, b.dtype)
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3)


def _image(seed=0, hw=(30, 40)):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]] / max(hw)
    base = np.stack([np.sin(4 * x + c) for c in rng.uniform(0, 3, 3)], -1)
    return np.clip((base + 1) * 110 + rng.normal(0, 8, hw + (3,)), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
@pytest.mark.parametrize("kw", [{}, {"flag": 0}, {"to_rgb": False}],
                         ids=["rgb", "grey", "bgr"])
def test_imdecode_and_imread(tmp_path, fmt, kw):
    ok, buf = cv2.imencode(fmt, _image())
    assert ok
    _same(timg.imdecode(buf.tobytes(), **kw),
          jimg.imdecode(buf.tobytes(), **kw))
    path = str(tmp_path / f"a{fmt}")
    cv2.imwrite(path, _image(1))
    _same(timg.imread(path, **kw), jimg.imread(path, **kw))


@pytest.mark.parametrize("interp", [0, 1, 2, 3])
def test_imresize_uint8_and_float(interp):
    img = _image()
    _same(timg.imresize(img, 17, 23, interp),
          jimg.imresize(img, 17, 23, interp))
    f = img.astype(np.float32) / 3
    _same(timg.imresize(f, 25, 11, interp), jimg.imresize(f, 25, 11, interp),
          exact=False)
    grey = img[:, :, :1]
    _same(timg.imresize(grey, 9, 8), jimg.imresize(grey, 9, 8))


def test_crop_helpers_on_the_same_draws():
    img = _image()
    _same(timg.resize_short(img, 20), jimg.resize_short(img, 20))
    _same(timg.fixed_crop(img, 3, 4, 10, 12),
          jimg.fixed_crop(img, 3, 4, 10, 12))
    _same(timg.fixed_crop(img, 3, 4, 10, 12, size=(8, 8)),
          jimg.fixed_crop(img, 3, 4, 10, 12, size=(8, 8)))
    _same(timg.fixed_crop(img.astype(np.float32), 1, 1, 5, 5, size=(7, 7)),
          jimg.fixed_crop(img.astype(np.float32), 1, 1, 5, 5, size=(7, 7)),
          exact=False)
    for fn in ("random_crop", "center_crop"):
        outs = []
        for mod in (timg, jimg):
            random.seed(2)
            outs.append(getattr(mod, fn)(img, (16, 12)))
        _same(outs[0][0], outs[1][0])
        assert outs[0][1] == outs[1][1]
    outs = []
    for mod in (timg, jimg):
        random.seed(4)
        outs.append(mod.random_size_crop(img, (12, 12), 0.3, (0.75, 1.33)))
    _same(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    _same(timg.color_normalize(img, (1.0, 2.0, 3.0), (2.0, 2.0, 4.0)),
          jimg.color_normalize(img, (1.0, 2.0, 3.0), (2.0, 2.0, 4.0)),
          exact=False)


_EIG = (np.array([55.46, 4.794, 1.148], np.float32),
        np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]], np.float32))

_AUGS = [
    ("ResizeAug", (18,)), ("ForceResizeAug", ((20, 14),)),
    ("RandomCropAug", ((16, 16),)), ("CenterCropAug", ((16, 12),)),
    ("HorizontalFlipAug", (0.5,)), ("CastAug", ()),
    ("ColorNormalizeAug", ((120., 110., 100.), (50., 55., 60.))),
    ("BrightnessJitterAug", (0.3,)), ("ContrastJitterAug", (0.3,)),
    ("SaturationJitterAug", (0.3,)), ("ColorJitterAug", (0.2, 0.2, 0.2)),
    ("HueJitterAug", (0.2,)), ("LightingAug", (0.1,) + _EIG),
    ("RandomGrayAug", (0.5,)),
    ("RandomSizedCropAug", ((12, 12), (0.3, 1.0), (0.75, 1.33))),
    ("RandomOrderAug", "children"), ("SequentialAug", "children"),
    ("Augmenter", None),
]


def _aug(mod, name, args):
    if args == "children":
        return getattr(mod, name)([mod.CastAug(),
                                   mod.BrightnessJitterAug(0.2),
                                   mod.ContrastJitterAug(0.2)])
    return getattr(mod, name)(*args)


@pytest.mark.parametrize("name,args", _AUGS, ids=[n for n, _ in _AUGS])
def test_augmenters_equal_the_references_on_the_same_draws(name, args):
    if args is None:
        with pytest.raises(NotImplementedError):
            timg.Augmenter(x=1)(_image())
        assert timg.Augmenter(x=1).dumps() == jimg.Augmenter(x=1).dumps()
        return
    outs = []
    for mod in (timg, jimg):
        random.seed(7)
        np.random.seed(7)
        aug = _aug(mod, name, args)
        outs.append([aug(_image(s)) for s in range(4)])
    for g, w in zip(*outs):
        _same(g, w, exact=False)
    assert _aug(timg, name, args).dumps() == _aug(jimg, name, args).dumps()


@pytest.mark.parametrize("kw", [
    {}, {"resize": 24, "rand_crop": True, "rand_mirror": True},
    {"rand_crop": True, "rand_resize": True, "mean": True, "std": True},
    {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1, "hue": 0.1,
     "pca_noise": 0.05, "rand_gray": 0.3, "mean": np.ones(3)}],
    ids=["plain", "crop_mirror", "sized_norm", "jitter"])
def test_create_augmenter_equals_the_references(kw):
    got = timg.CreateAugmenter((3, 16, 16), **kw)
    want = jimg.CreateAugmenter((3, 16, 16), **kw)
    assert [type(a).__name__ for a in got] == [type(a).__name__ for a in want]
    outs = []
    for augs in (got, want):
        random.seed(1)
        np.random.seed(1)
        img = _image()
        for a in augs:
            img = a(img)
        outs.append(img)
    _same(outs[0], outs[1], exact=False)
    with pytest.raises(mx.MXNetError, match="rand_crop"):
        timg.CreateAugmenter((3, 8, 8), rand_resize=True)


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    d = tmp_path_factory.mktemp("image_iter")
    path = str(d / "i.rec")
    w = trec.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(11):
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, [float(i), 1.0], i, 0),
                                     _image(i, (24 + i, 30)), quality=90))
    w.close()
    return path, d


def _iter_batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


@pytest.mark.parametrize("handle", ["pad", "discard"])
def test_image_iter_over_records_and_lists(rec, handle):
    path, d = rec
    runs = []
    for mod in (timg, jimg):
        random.seed(3)
        it = mod.ImageIter(4, (3, 16, 16), label_width=2, path_imgrec=path,
                           shuffle=True, last_batch_handle=handle,
                           aug_list=mod.CreateAugmenter(
                               (3, 16, 16), rand_crop=True,
                               rand_mirror=True))
        runs.append(_iter_batches(it))
        it.reset()
        runs[-1] += _iter_batches(it)
    assert len(runs[0]) == len(runs[1]) == (6 if handle == "pad" else 4)
    for (gd, gl, gp), (wd, wl, wp) in zip(*runs):
        _same(gd, wd, exact=False)
        _same(gl, wl)
        assert gp == wp
    imgs = []
    for i in range(5):
        cv2.imwrite(str(d / f"l{i}.png"), _image(i))
        imgs.append((float(i), f"l{i}.png"))
    lst = d / "i.lst"
    lst.write_text("".join(f"{i}\t{lab}\t{f}\n"
                           for i, (lab, f) in enumerate(imgs)))
    for kw in ({"path_imglist": str(lst), "path_root": str(d)},
               {"imglist": [(lab, str(d / f)) for lab, f in imgs]}):
        got = _iter_batches(timg.ImageIter(2, (3, 12, 12), **kw))
        want = _iter_batches(jimg.ImageIter(2, (3, 12, 12), **kw))
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            _same(gd, wd, exact=False)
            _same(gl, wl)
            assert gp == wp == (1 if gp else 0)
    with pytest.raises(mx.MXNetError):
        timg.ImageIter(2, (3, 12, 12))
    with pytest.raises(mx.MXNetError, match="last_batch_handle"):
        timg.ImageIter(2, (3, 12, 12), path_imgrec=path,
                       last_batch_handle="roll_over")


def _boxes(rng, m):
    lo = rng.uniform(0.05, 0.5, (m, 2))
    full = -np.ones((4, 5), np.float32)
    full[:m] = np.concatenate([rng.randint(0, 3, (m, 1)), lo,
                               lo + rng.uniform(0.2, 0.45, (m, 2))], 1)
    return full


@pytest.mark.parametrize("name", ["DetHorizontalFlipAug", "DetRandomCropAug",
                                  "DetForceResizeAug", "DetBorrowAug"])
def test_det_augmenters_equal_the_references(name):
    outs = []
    for mod in (timg, jimg):
        random.seed(9)
        rng = np.random.RandomState(9)
        aug = {"DetHorizontalFlipAug": lambda: mod.DetHorizontalFlipAug(0.5),
               "DetRandomCropAug": lambda: mod.DetRandomCropAug(0.3),
               "DetForceResizeAug": lambda: mod.DetForceResizeAug((20, 16)),
               "DetBorrowAug": lambda: mod.DetBorrowAug(
                   mod.BrightnessJitterAug(0.3))}[name]()
        outs.append([aug(_image(s), _boxes(rng, 1 + s % 3))
                     for s in range(5)])
    for (gi, gl), (wi, wl) in zip(*outs):
        _same(gi, wi, exact=False)
        np.testing.assert_allclose(gl, wl, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        timg.DetAugmenter()(_image(), _boxes(np.random.RandomState(0), 1))


def test_image_det_iter_equals_the_references(tmp_path):
    path = str(tmp_path / "d.rec")
    w = trec.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    rng = np.random.RandomState(5)
    for i in range(9):
        boxes = _boxes(rng, 1 + i % 4)
        boxes = boxes[boxes[:, 0] >= 0]
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, boxes.ravel().tolist(),
                                                   i, 0),
                                     _image(i), quality=90))
    w.close()
    runs = []
    for mod in (timg, jimg):
        random.seed(6)
        it = mod.ImageDetIter(4, (3, 20, 20), path_imgrec=path,
                              shuffle=True, rand_crop=1, rand_mirror=True,
                              mean=True, std=True)
        assert it.max_objects == 4
        assert it.provide_label[0].shape == (4, 4, 5)
        runs.append(_iter_batches(it))
    for (gd, gl, gp), (wd, wl, wp) in zip(*runs):
        _same(gd, wd, exact=False)
        np.testing.assert_allclose(gl, wl, rtol=1e-6)
        assert gp == wp
    got = timg.CreateDetAugmenter((3, 20, 20), rand_crop=1, rand_mirror=True,
                                  brightness=0.1, mean=True)
    want = jimg.CreateDetAugmenter((3, 20, 20), rand_crop=1,
                                   rand_mirror=True, brightness=0.1,
                                   mean=True)
    assert [type(a).__name__ for a in got] == [type(a).__name__ for a in want]
    assert timg.ImageDetIter._reshape_label([1, .1, .1, .5, .5]).shape == \
        (1, 5)
    with pytest.raises(mx.MXNetError, match="multiple of 5"):
        timg.ImageDetIter._reshape_label([1, 2, 3])
    assert jmx.image.ImageDetIter is jimg.ImageDetIter
