"""``mx.image`` detection, from ``tpu_mx/image/detection.py``: the
box-aware augmenters, ``CreateDetAugmenter`` and ``ImageDetIter``.

Each sample's label is a ``(max_objects, 5)`` float block of ``[cls,
x1, y1, x2, y2]`` rows (corners normalised to [0, 1]) padded with -1:
the fixed shape ``MultiBoxTarget`` takes."""
from __future__ import annotations

import random as _pyrandom

import numpy as np

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc
from ..ndarray import NDArray, array
from .image import (CastAug, ColorJitterAug, ColorNormalizeAug,
                    ForceResizeAug, ImageIter)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetForceResizeAug", "CreateDetAugmenter",
           "ImageDetIter"]


class DetAugmenter:
    """Augmenter over (img, label) pairs; label rows [cls, x1, y1, x2, y2]."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """A plain image augmenter that moves no pixel, labels unchanged."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() < self.p:
            arr = src.asnumpy() if isinstance(src, NDArray) else src
            src = array(np.ascontiguousarray(arr[:, ::-1]), dtype="uint8")
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[:, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1[valid]
        return src, label


class DetRandomCropAug(DetAugmenter):
    """SSD's random crop: a box of the image that covers at least
    ``min_object_covered`` of some object; the kept boxes remapped."""

    def __init__(self, min_object_covered=0.3, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.3, 1.0), max_attempts=20):
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        h, w = src.shape[0], src.shape[1]
        valid = label[:, 0] >= 0
        if not valid.any():
            return src, label
        for _ in range(self.max_attempts):
            scale = _pyrandom.uniform(*self.area_range)
            ratio = _pyrandom.uniform(*self.aspect_ratio_range)
            cw = min(1.0, np.sqrt(scale * ratio))
            ch = min(1.0, np.sqrt(scale / ratio))
            cx0 = _pyrandom.uniform(0, 1 - cw)
            cy0 = _pyrandom.uniform(0, 1 - ch)
            crop = np.array([cx0, cy0, cx0 + cw, cy0 + ch])
            boxes = label[valid, 1:5]
            ix1 = np.maximum(boxes[:, 0], crop[0])
            iy1 = np.maximum(boxes[:, 1], crop[1])
            ix2 = np.minimum(boxes[:, 2], crop[2])
            iy2 = np.minimum(boxes[:, 3], crop[3])
            inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
            areas = ((boxes[:, 2] - boxes[:, 0]) *
                     (boxes[:, 3] - boxes[:, 1]))
            cover = np.where(areas > 0, inter / np.maximum(areas, 1e-12), 0)
            keep = cover >= self.min_object_covered
            if not keep.any():
                continue
            px0, py0 = int(crop[0] * w), int(crop[1] * h)
            px1, py1 = int(crop[2] * w), int(crop[3] * h)
            arr = (src.asnumpy() if isinstance(src, NDArray)
                   else np.asarray(src))[py0:py1, px0:px1]
            new_label = -np.ones_like(label)
            rows = label[valid][keep].copy()
            rows[:, 1] = np.clip((rows[:, 1] - crop[0]) / cw, 0, 1)
            rows[:, 2] = np.clip((rows[:, 2] - crop[1]) / ch, 0, 1)
            rows[:, 3] = np.clip((rows[:, 3] - crop[0]) / cw, 0, 1)
            rows[:, 4] = np.clip((rows[:, 4] - crop[1]) / ch, 0, 1)
            new_label[:rows.shape[0]] = rows
            return array(np.ascontiguousarray(arr), dtype="uint8"), new_label
        return src, label


class DetForceResizeAug(DetAugmenter):
    """Resize to exactly ``size`` (w, h); normalised boxes are
    unchanged."""

    def __init__(self, size, interp=1):
        self._resize = ForceResizeAug(size, interp)

    def __call__(self, src, label):
        return self._resize(src), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_mirror=False,
                       mean=None, std=None, brightness=0, contrast=0,
                       saturation=0, min_object_covered=0.3,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.3, 1.0), max_attempts=20,
                       inter_method=2, **kwargs):
    """The reference's detection augmenter list for these flags."""
    auglist = []
    if rand_crop > 0:
        auglist.append(DetRandomCropAug(min_object_covered,
                                        aspect_ratio_range, area_range,
                                        max_attempts))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetForceResizeAug((data_shape[2], data_shape[1]),
                                     inter_method))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(ColorJitterAug(brightness, contrast,
                                                   saturation)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(
            mean if mean is not None else np.zeros(3, np.float32), std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection batches: ``(data (B, C, H, W), label (B, max_objects,
    5))``.  Without ``max_objects`` the constructor reads every record's
    label once (no decode) for the widest; pass it to skip that."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", imglist=None, shuffle=False,
                 aug_list=None, max_objects=None, data_name="data",
                 label_name="label", last_batch_handle="pad", **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape, **kwargs)
        super().__init__(batch_size, data_shape, label_width=-1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, imglist=imglist,
                         shuffle=shuffle, aug_list=aug_list,
                         data_name=data_name, label_name=label_name,
                         last_batch_handle=last_batch_handle)
        self.max_objects = max_objects or self._scan_max_objects()

    def _scan_max_objects(self):
        mx_obj = 1
        for idx in self.seq:
            lab, _ = self._peek_label(idx)
            mx_obj = max(mx_obj, lab.shape[0])
        return mx_obj

    def _peek_label(self, idx):
        label, _img = self._read_sample(idx, want_img=False)
        return self._reshape_label(label), None

    @staticmethod
    def _reshape_label(label):
        """A flat ``[cls, x1, y1, x2, y2] * m`` label or an ``(m, 5)`` one
        as ``(m, 5)``."""
        lab = np.asarray(label, np.float32)
        if lab.ndim == 1:
            if lab.size % 5:
                raise MXNetError("det label width must be a multiple of 5")
            lab = lab.reshape(-1, 5)
        return lab

    @property
    def provide_label(self):
        return [DataDesc(self._label_name,
                         (self.batch_size, self.max_objects, 5))]

    def next(self):
        if self.cursor >= len(self.seq):
            raise StopIteration
        n = self.batch_size
        C, H, W = self.data_shape
        data = np.zeros((n, C, H, W), self.dtype)
        label = -np.ones((n, self.max_objects, 5), np.float32)
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
            raw_label, img = self._read_sample(src)
            lab = self._reshape_label(raw_label)
            full = -np.ones((self.max_objects, 5), np.float32)
            m = min(lab.shape[0], self.max_objects)
            full[:m] = lab[:m]
            for aug in self.auglist:
                img, full = aug(img, full) if isinstance(aug, DetAugmenter) \
                    else (aug(img), full)
            arr = (img.asnumpy() if isinstance(img, NDArray)
                   else np.asarray(img)).astype(self.dtype)
            data[i] = arr.transpose(2, 0, 1)
            label[i] = full
        return DataBatch([array(data)], [array(label)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
