"""Vision transforms, from ``tpu_mx/gluon/data/vision/transforms.py``:
``Compose``, ``Cast``, ``ToTensor``, ``Normalize``, ``Resize``,
``CenterCrop``, ``RandomResizedCrop``, the flips, the colour jitters and
``RandomLighting``.  They run on the host in numpy, as the reference's
do, and return numpy arrays (a process worker of ``DataLoader`` runs
them), drawing from :func:`tpu_mx_torch.random.host_rng`: a seeded run
draws what the reference's draws."""
from __future__ import annotations

import numpy as np
from ....random import host_rng as _host_rng

from ...block import Block
from ....ndarray import NDArray

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomLighting", "RandomHue", "RandomColorJitter"]


def _as_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


class _Transform(Block):
    def forward(self, x):
        raise NotImplementedError

    def __call__(self, x, *args):
        out = self.forward(x)
        if args:
            return (out,) + args
        return out


class Compose(_Transform):
    def __init__(self, transforms):
        super().__init__()
        self._transforms = transforms

    def forward(self, x):
        for t in self._transforms:
            x = t(x)
        return x


class Cast(_Transform):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _as_np(x).astype(self._dtype)


class ToTensor(_Transform):
    """HWC uint8 in [0, 255] to CHW float32 in [0, 1] (NHWC to NCHW for
    a batch)."""

    def forward(self, x):
        x = _as_np(x).astype(np.float32) / 255.0
        if x.ndim == 3:
            return x.transpose(2, 0, 1)
        return x.transpose(0, 3, 1, 2)


class Normalize(_Transform):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        return (_as_np(x) - self._mean) / self._std


def _resize(img, size):
    """Bilinear resize in numpy (corners aligned), float32 out."""
    h, w = img.shape[:2]
    if isinstance(size, int):
        size = (size, size)
    ow, oh = size
    ys = np.linspace(0, h - 1, oh)
    xs = np.linspace(0, w - 1, ow)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img.astype(np.float32)
    out = (img[y0][:, x0] * (1 - wy) * (1 - wx) +
           img[y1][:, x0] * wy * (1 - wx) +
           img[y0][:, x1] * (1 - wy) * wx +
           img[y1][:, x1] * wy * wx)
    return out


class Resize(_Transform):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size

    def forward(self, x):
        return _resize(_as_np(x), self._size)


class CenterCrop(_Transform):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        x = _as_np(x)
        h, w = x.shape[:2]
        cw, ch = self._size
        x0 = max((w - cw) // 2, 0)
        y0 = max((h - ch) // 2, 0)
        return x[y0:y0 + ch, x0:x0 + cw]


class RandomResizedCrop(_Transform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        x = _as_np(x)
        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = _host_rng().uniform(*self._scale) * area
            aspect = _host_rng().uniform(*self._ratio)
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                x0 = _host_rng().randint(0, w - cw + 1)
                y0 = _host_rng().randint(0, h - ch + 1)
                crop = x[y0:y0 + ch, x0:x0 + cw]
                return _resize(crop, self._size)
        return _resize(x, self._size)


class RandomFlipLeftRight(_Transform):
    def forward(self, x):
        x = _as_np(x)
        return x[:, ::-1].copy() if _host_rng().rand() < 0.5 else x


class RandomFlipTopBottom(_Transform):
    def forward(self, x):
        x = _as_np(x)
        return x[::-1].copy() if _host_rng().rand() < 0.5 else x


class RandomBrightness(_Transform):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + _host_rng().uniform(-self._b, self._b)
        return np.clip(_as_np(x).astype(np.float32) * alpha, 0, 255)


class RandomContrast(_Transform):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        x = _as_np(x).astype(np.float32)
        alpha = 1.0 + _host_rng().uniform(-self._c, self._c)
        gray = x.mean()
        return np.clip(gray + alpha * (x - gray), 0, 255)


class RandomSaturation(_Transform):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        x = _as_np(x).astype(np.float32)
        alpha = 1.0 + _host_rng().uniform(-self._s, self._s)
        gray = x.mean(axis=-1, keepdims=True)
        return np.clip(gray + alpha * (x - gray), 0, 255)


class RandomHue(_Transform):
    """Hue jitter by a rotation in YIQ space (the arithmetic of
    ``image.HueJitterAug``)."""

    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        from ....image.image import HueJitterAug
        out = HueJitterAug(self._h).apply_numpy(_as_np(x))
        return np.clip(out, 0, 255)


class RandomColorJitter(_Transform):
    """Brightness, contrast, saturation and hue jitter in one transform,
    applied in a random order each sample."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        ts = list(self._ts)
        _host_rng().shuffle(ts)
        for t in ts:
            x = t.forward(_as_np(x))
        return x


class RandomLighting(_Transform):
    """AlexNet's PCA lighting noise."""

    _eigval = np.array([55.46, 4.794, 1.148], np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        x = _as_np(x).astype(np.float32)
        alpha = _host_rng().normal(0, self._alpha, 3).astype(np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return np.clip(x + rgb, 0, 255)
