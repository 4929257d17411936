"""``mx.image``, from ``tpu_mx/image/image.py``: ``imdecode``/``imread``
(Pillow), ``imresize`` (Pillow for uint8, OpenCV for float pixels), the
crop helpers, the augmenters, ``CreateAugmenter`` and ``ImageIter``.

Images are HWC arrays on the current context; the augmenters compute in
numpy on the host and draw from Python's ``random`` module (and
``LightingAug`` from numpy's global stream), as the reference's do, so
a run seeded in both packages augments alike.  ``ImageIter`` reads an
indexed RecordIO file or an image list into NCHW batches."""
from __future__ import annotations

import io as _io
import os
import random as _pyrandom

import numpy as np

from ..base import MXNetError
from ..random import host_rng as _host_rng
from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray import NDArray, array
from .. import recordio as _recordio

__all__ = ["random_size_crop", "HueJitterAug", "LightingAug",
           "RandomGrayAug", "RandomOrderAug", "SequentialAug",
           "RandomSizedCropAug",
           "imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize", "HorizontalFlipAug",
           "ResizeAug", "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "CastAug", "ColorNormalizeAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "ColorJitterAug",
           "CreateAugmenter", "Augmenter", "ImageIter"]


def _pil():
    try:
        from PIL import Image
        return Image
    except ImportError as e:  # pragma: no cover
        raise MXNetError("mx.image requires Pillow in this build") from e


# -- decode, resize, crop: numpy HWC in, arrays out ---------------------------

def imdecode(buf, to_rgb=True, flag=1, **kw):
    """An encoded image as an HWC uint8 array (RGB unless ``to_rgb`` is
    false; ``flag=0``: one grey channel)."""
    Image = _pil()
    img = Image.open(_io.BytesIO(buf if isinstance(buf, (bytes, bytearray))
                                 else bytes(buf)))
    if flag == 0:
        img = img.convert("L")
        arr = np.asarray(img)[:, :, None]
    else:
        img = img.convert("RGB")
        arr = np.asarray(img)
        if not to_rgb:
            arr = arr[:, :, ::-1]
    return array(arr.astype(np.uint8), dtype="uint8")


def imread(filename, to_rgb=True, flag=1, **kw):
    with open(filename, "rb") as f:
        return imdecode(f.read(), to_rgb=to_rgb, flag=flag)


def imresize(src, w, h, interp=1):
    arr = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    if arr.dtype != np.uint8:
        # float pixels (after a cast or normalisation) stay float
        try:
            import cv2
            flags = {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR,
                     2: cv2.INTER_CUBIC, 3: cv2.INTER_LANCZOS4}
            out = cv2.resize(arr.astype(np.float32), (int(w), int(h)),
                             interpolation=flags.get(interp,
                                                     cv2.INTER_LINEAR))
            if out.ndim == 2:
                out = out[:, :, None]
            return array(out.astype(np.float32))
        except ImportError:
            pass            # Pillow's uint8 resize below
    Image = _pil()
    squeeze = arr.shape[-1] == 1
    img = Image.fromarray(arr.squeeze(-1).astype(np.uint8) if squeeze
                          else arr.astype(np.uint8))
    resample = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                3: Image.LANCZOS}.get(interp, Image.BILINEAR)
    out = np.asarray(img.resize((int(w), int(h)), resample))
    if squeeze:
        out = out[:, :, None]
    return array(out.astype(np.uint8), dtype="uint8")


def resize_short(src, size, interp=1):
    h, w = (src.shape[0], src.shape[1])
    if h > w:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    arr = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    dtype = "uint8" if arr.dtype == np.uint8 else None  # preserve floats
    if size is not None and (w, h) != tuple(size):
        return imresize(array(out, dtype=dtype), size[0], size[1], interp)
    return array(out, dtype=dtype)


def random_crop(src, size, interp=1):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=1):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=1):
    """Inception's crop: ``area`` the (min, max) fraction of the image
    (a scalar is the min), ``ratio`` the (min, max) aspect; a centre crop
    when 10 draws find none that fits."""
    h, w = src.shape[0], src.shape[1]
    src_area = h * w
    if not isinstance(area, (list, tuple)):
        area = (area, 1.0)
    for _ in range(10):
        target = _pyrandom.uniform(area[0], area[1]) * src_area
        log_r = (np.log(ratio[0]), np.log(ratio[1]))
        ar = float(np.exp(_pyrandom.uniform(*log_r)))
        new_w = int(round(np.sqrt(target * ar)))
        new_h = int(round(np.sqrt(target / ar)))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    arr = (src.asnumpy() if isinstance(src, NDArray)
           else np.asarray(src)).astype(np.float32)
    arr = arr - np.asarray(mean, np.float32)
    if std is not None:
        arr = arr / np.asarray(std, np.float32)
    return array(arr)


# -- augmenters ---------------------------------------------------------------

class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError

    def dumps(self):
        import json
        return json.dumps([type(self).__name__, self._kwargs])


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            arr = src.asnumpy() if isinstance(src, NDArray) else src
            return array(np.ascontiguousarray(arr[:, ::-1]), dtype="uint8")
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        arr = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
        return array(arr.astype(self.typ))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean, self.std = mean, std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        arr = (src.asnumpy() if isinstance(src, NDArray)
               else np.asarray(src)).astype(np.float32)
        return array(arr * alpha)


class ContrastJitterAug(Augmenter):
    _coef = np.array([0.299, 0.587, 0.114], np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        arr = (src.asnumpy() if isinstance(src, NDArray)
               else np.asarray(src)).astype(np.float32)
        gray = (arr[..., :3] * self._coef).sum(axis=-1).mean()
        return array(arr * alpha + gray * (1 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = ContrastJitterAug._coef

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        arr = (src.asnumpy() if isinstance(src, NDArray)
               else np.asarray(src)).astype(np.float32)
        gray = (arr[..., :3] * self._coef).sum(axis=-1, keepdims=True)
        return array(arr * alpha + gray * (1 - alpha))


class ColorJitterAug(Augmenter):
    def __init__(self, brightness=0, contrast=0, saturation=0):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self._augs = []
        if brightness:
            self._augs.append(BrightnessJitterAug(brightness))
        if contrast:
            self._augs.append(ContrastJitterAug(contrast))
        if saturation:
            self._augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        augs = list(self._augs)
        _pyrandom.shuffle(augs)
        for a in augs:
            src = a(src)
        return src


class HueJitterAug(Augmenter):
    """Hue jitter: a rotation by a random angle in YIQ space."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], np.float32)
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]], np.float32)

    def __call__(self, src):
        arr = src.asnumpy() if isinstance(src, NDArray) else src
        return array(self.apply_numpy(arr))

    def apply_numpy(self, arr):
        """One draw applied to a numpy image, numpy out."""
        alpha = _pyrandom.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        wv = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -wv],
                       [0.0, wv, u]], np.float32)
        t = (self.ityiq @ bt @ self.tyiq).T
        return np.asarray(arr).astype(np.float32) @ t


class LightingAug(Augmenter):
    """AlexNet's PCA lighting noise (drawn from numpy's global stream)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = _host_rng().normal(0, self.alphastd, size=(3,)).astype(
            np.float32)
        rgb = self.eigvec @ (alpha * self.eigval)
        arr = (src.asnumpy() if isinstance(src, NDArray)
               else np.asarray(src)).astype(np.float32)
        return array(arr + rgb)


class RandomGrayAug(Augmenter):
    """Grey with probability ``p``."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self.mat = np.array([[0.21, 0.21, 0.21],
                             [0.72, 0.72, 0.72],
                             [0.07, 0.07, 0.07]], np.float32)

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            arr = (src.asnumpy() if isinstance(src, NDArray)
                   else np.asarray(src)).astype(np.float32)
            return array(arr @ self.mat)
        return src


class RandomOrderAug(Augmenter):
    """The children in a random order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def dumps(self):
        return [type(self).__name__, [t.dumps() for t in self.ts]]

    def __call__(self, src):
        ts = list(self.ts)
        _pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class SequentialAug(Augmenter):
    """The children in order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def dumps(self):
        return [type(self).__name__, [t.dumps() for t in self.ts]]

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomSizedCropAug(Augmenter):
    """:func:`random_size_crop` as an augmenter."""

    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The reference's augmenter list for these flags."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise MXNetError("rand_resize needs rand_crop")
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4.0, 4 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(
            pca_noise,
            np.array([55.46, 4.794, 1.148], np.float32),
            np.array([[-0.5675, 0.7192, 0.4009],
                      [-0.5808, -0.0045, -0.8140],
                      [-0.5836, -0.6948, 0.4203]], np.float32)))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(
            mean if mean is not None else np.zeros(3, np.float32), std))
    return auglist


# -- ImageIter ----------------------------------------------------------------
class ImageIter(DataIter):
    """NCHW batches from an indexed RecordIO file (``path_imgrec``), a
    ``.lst`` file (``path_imglist`` under ``path_root``) or ``imglist``
    ``[(label, path), ...]``, through ``aug_list`` (default:
    :func:`CreateAugmenter` of ``data_shape``); the last batch wraps to
    the head (``pad``) or is dropped (``discard``)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 last_batch_handle="pad", **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (C, H, W)")
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.dtype = dtype
        self._data_name = data_name
        self._label_name = label_name
        self.auglist = (aug_list if aug_list is not None
                        else CreateAugmenter(data_shape))
        self._record = None
        self.seq = []
        self.imglist = {}
        if path_imgrec:
            self._record = _recordio.MXIndexedRecordIO(
                path_imgrec[:-4] + ".idx" if path_imgrec.endswith(".rec")
                else path_imgrec + ".idx", path_imgrec, "r")
            self.seq = list(self._record.keys)
        elif path_imglist or imglist is not None:
            if path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        idx = int(parts[0])
                        label = np.array([float(v) for v in parts[1:-1]],
                                         np.float32)
                        self.imglist[idx] = (label, parts[-1])
            else:
                for i, (label, fname) in enumerate(imglist):
                    self.imglist[i] = (np.array(np.atleast_1d(label),
                                               np.float32), fname)
            self.path_root = path_root
            self.seq = list(self.imglist.keys())
        else:
            raise MXNetError("ImageIter needs path_imgrec, path_imglist or "
                             "imglist")
        if last_batch_handle not in ("pad", "discard"):
            raise MXNetError("ImageIter supports last_batch_handle 'pad' or "
                             f"'discard', got {last_batch_handle!r}")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        if self.shuffle:
            _pyrandom.shuffle(self.seq)
        self.cursor = 0

    def _read_sample(self, idx, want_img=True):
        if self._record is not None:
            header, img_bytes = _recordio.unpack(self._record.read_idx(idx))
            label = np.atleast_1d(np.asarray(header.label, np.float32))
            img = imdecode(img_bytes) if want_img else None
        else:
            label, fname = self.imglist[idx]
            img = (imread(os.path.join(self.path_root, fname))
                   if want_img else None)
        return label, img

    def _augment(self, img):
        for aug in self.auglist:
            img = aug(img)
        return img

    def next(self):
        if self.cursor >= len(self.seq):
            raise StopIteration
        n = self.batch_size
        C, H, W = self.data_shape
        data = np.zeros((n, C, H, W), self.dtype)
        lw = self.label_width
        label = np.zeros((n,) if lw == 1 else (n, lw), np.float32)
        pad = 0
        for i in range(n):
            if self.cursor >= len(self.seq):
                if self.last_batch_handle == "discard":
                    raise StopIteration
                src = self.seq[pad % len(self.seq)]
                pad += 1
            else:
                src = self.seq[self.cursor]
                self.cursor += 1
            lab, img = self._read_sample(src)
            img = self._augment(img)
            arr = (img.asnumpy() if isinstance(img, NDArray)
                   else np.asarray(img)).astype(self.dtype)
            data[i] = arr.transpose(2, 0, 1)
            label[i] = lab if lw > 1 else lab[0]
        return DataBatch([array(data)], [array(label)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
