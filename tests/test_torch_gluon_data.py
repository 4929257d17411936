"""``gluon.data`` of the port against the reference's, on the CPU:
samplers (a seeded shuffle is the reference's), datasets, ``DataLoader``
with no workers, thread workers and forked process workers (equal
batches, worker errors raised, array samples refused by a forked
child), the vision datasets (files and the synthetic stand-ins) and the
15 transforms on the same draws.
"""
import gzip
import os
import random
import struct
import sys
import time

import numpy as np
import pytest

import tpu_mx as jmx
from tpu_mx.gluon import data as jdata

import tpu_mx_torch as mx
from tpu_mx_torch import recordio as trec
from tpu_mx_torch.gluon import data as tdata
from tpu_mx_torch.gluon.data.vision import transforms as T

jT = jdata.vision.transforms

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True)
def _host():
    with mx.cpu():
        yield


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b, exact=True):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, exact)
        return
    assert a.shape == b.shape, (a.shape, b.shape)
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_samplers_equal_the_references(last):
    runs = []
    for d in (tdata, jdata):
        np.random.seed(3)
        seq = list(d.SequentialSampler(7, start=2))
        rnd = [list(d.RandomSampler(10)) for _ in range(2)]
        bs = d.BatchSampler(d.RandomSampler(10), 3, last)
        runs.append((seq, rnd, [list(bs), list(bs)], len(bs)))
    assert runs[0] == runs[1]
    with pytest.raises(ValueError):
        list(tdata.BatchSampler(range(5), 2, "bogus"))


def test_datasets_equal_the_references(tmp_path):
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    y = np.arange(6)
    for d, nd in ((tdata, mx.nd), (jdata, jmx.nd)):
        a = d.ArrayDataset(nd.array(x), y)
        assert len(a) == 6
        _same(a[2], (x[2], y[2]))
    t = tdata.ArrayDataset(x, y)
    j = jdata.ArrayDataset(x, y)
    _same([t.filter(lambda s: s[1] % 2)[i] for i in range(3)],
          [j.filter(lambda s: s[1] % 2)[i] for i in range(3)])
    _same(t.shard(4, 1)[1], j.shard(4, 1)[1])
    assert len(t.take(4)) == len(j.take(4)) == 4
    f = t.transform_first(lambda v: v * 2)
    _same(f[3], (x[3] * 2, y[3]))
    assert tdata.SimpleDataset([1, 2])[1] == 2
    with pytest.raises(mx.MXNetError, match="same length"):
        tdata.ArrayDataset(x, y[:3])
    path = str(tmp_path / "r.rec")
    w = trec.MXIndexedRecordIO(path + ".idx", path, "w")
    for i in range(5):
        w.write_idx(i, bytes([i]) * (i + 1))
    w.close()
    r, jr = tdata.RecordFileDataset(path), jdata.RecordFileDataset(path)
    assert len(r) == 5 and [r[i] for i in range(5)] == \
        [jr[i] for i in range(5)]


class _Squares(tdata.Dataset):
    """numpy samples, as a forked worker needs."""

    def __len__(self):
        return 37

    def __getitem__(self, i):
        return (np.full((3, 2), i, np.float32), np.int64(i * i))


class _Broken(_Squares):
    def __getitem__(self, i):
        if i == 20:
            raise KeyError("sample 20")
        return super().__getitem__(i)


class _Arrays(_Squares):
    """Array samples, made in the parent: a forked child only hands them
    to the batchify, which refuses them before any torch operation."""

    def __init__(self):
        self._arrays = [mx.nd.array(np.full((2,), i, np.float32))
                        for i in range(len(self))]

    def __getitem__(self, i):
        return self._arrays[i]


def _load(loader):
    return [_np(b) for b in loader]


@pytest.mark.parametrize("workers", [(2, True), (3, False)],
                         ids=["threads", "processes"])
def test_dataloader_workers_equal_the_serial_and_the_reference(workers):
    n, threads = workers
    ds = _Squares()
    serial = _load(tdata.DataLoader(ds, batch_size=5, last_batch="keep"))
    got = _load(tdata.DataLoader(ds, batch_size=5, num_workers=n,
                                 thread_pool=threads, prefetch=3))
    ref = _load(jdata.DataLoader(ds, batch_size=5))
    assert len(serial) == len(got) == len(ref) == 8
    _same(got, serial)
    _same(got, ref)
    np.random.seed(1)
    a = _load(tdata.DataLoader(ds, batch_size=4, shuffle=True,
                               last_batch="discard", num_workers=n,
                               thread_pool=threads))
    np.random.seed(1)
    b = _load(jdata.DataLoader(ds, batch_size=4, shuffle=True,
                               last_batch="discard"))
    _same(a, b)
    assert len(tdata.DataLoader(ds, batch_size=4,
                                last_batch="discard")) == 9


@pytest.mark.parametrize("threads", [True, False],
                         ids=["threads", "processes"])
def test_dataloader_worker_failure_reaches_the_consumer(threads):
    loader = tdata.DataLoader(_Broken(), batch_size=5, num_workers=2,
                              thread_pool=threads)
    with pytest.raises((KeyError, RuntimeError), match="sample 20"):
        _load(loader)


def test_forked_workers_refuse_array_samples():
    loader = tdata.DataLoader(_Arrays(), batch_size=4, num_workers=2,
                              thread_pool=False)
    with pytest.raises(RuntimeError, match="numpy"):
        _load(loader)
    threaded = _load(tdata.DataLoader(_Arrays(), batch_size=4,
                                      num_workers=2))
    _same(threaded[1], np.repeat(np.arange(4, 8, dtype=np.float32)[:, None],
                                 2, 1))


class _Jitter(tdata.Dataset):
    """Samples that take a random few microseconds each, so the workers
    finish out of order."""

    def __len__(self):
        return 400

    def __getitem__(self, i):
        time.sleep(random.random() * 1e-4)
        return np.full((2,), i, np.float32)


def test_thread_workers_never_stall_on_the_window():
    """More workers than cores, a window of one batch a worker and a
    switch interval of a microsecond: the reference's thread workers
    (task first, then a slot in the window) stall here until their
    timeout; the port's take the slot first."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            out = _load(tdata.DataLoader(_Jitter(), batch_size=2,
                                         num_workers=16, prefetch=1,
                                         timeout=10))
            np.testing.assert_array_equal(
                np.concatenate([b[:, 0] for b in out]), np.arange(400))
    finally:
        sys.setswitchinterval(interval)


def test_dataloader_thread_workers_keep_the_callers_context():
    loader = tdata.DataLoader(_Squares(), batch_size=8, num_workers=2)
    for data, _ in loader:
        assert data._data.device.type == "cpu"
    with pytest.raises(ValueError):
        tdata.DataLoader(_Squares())
    with pytest.raises(ValueError):
        tdata.DataLoader(_Squares(), batch_size=2, shuffle=True,
                         sampler=tdata.SequentialSampler(3))


def _idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(b"".join(struct.pack(">I", n) for n in arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("name,kw", [
    ("MNIST", {}), ("MNIST", {"train": False}), ("FashionMNIST", {}),
    ("CIFAR10", {}), ("CIFAR100", {"fine_label": True}),
    ("CIFAR100", {"train": False})])
def test_vision_datasets_synthetic_stand_ins(tmp_path, name, kw):
    root = str(tmp_path / "none")
    got = getattr(tdata.vision, name)(root=root, **kw)
    want = getattr(jdata.vision, name)(root=root, **kw)
    assert len(got) == len(want)
    for i in (0, 7, len(got) - 1):
        _same(got[i], want[i])


def test_vision_mnist_files_and_cifar_files(tmp_path):
    rng = np.random.RandomState(0)
    _idx(str(tmp_path / "train-images-idx3-ubyte.gz"),
         rng.randint(0, 256, (30, 28, 28)))
    _idx(str(tmp_path / "train-labels-idx1-ubyte.gz"),
         rng.randint(0, 10, 30))
    tf = T.Compose([T.ToTensor(), T.Normalize(0.13, 0.31)])
    jtf = jT.Compose([jT.ToTensor(), jT.Normalize(0.13, 0.31)])
    got = tdata.vision.MNIST(root=str(tmp_path),
                             transform=lambda x, y: (tf(x), y))
    want = jdata.vision.MNIST(root=str(tmp_path),
                              transform=lambda x, y: (jtf(x), y))
    assert len(got) == 30
    _same(got[4], want[4], exact=False)
    cdir = tmp_path / "c" / "cifar-10-batches-bin"
    cdir.mkdir(parents=True)
    for f in [f"data_batch_{i}.bin" for i in range(1, 6)] + \
            ["test_batch.bin"]:
        rng.randint(0, 256, (4, 3073)).astype(np.uint8).tofile(cdir / f)
    got = tdata.vision.CIFAR10(root=str(tmp_path / "c"), train=True)
    want = jdata.vision.CIFAR10(root=str(tmp_path / "c"), train=True)
    assert len(got) == 20
    _same(got[13], want[13])


def test_image_record_and_folder_datasets(tmp_path):
    rng = np.random.RandomState(2)
    path = str(tmp_path / "i.rec")
    w = trec.MXIndexedRecordIO(path + ".idx", path, "w")
    for i in range(4):
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i), i, 0),
                                     (rng.rand(12, 10, 3) * 255).astype(
                                         np.uint8), quality=90))
    w.close()
    got, want = tdata.vision.ImageRecordDataset(path), \
        jdata.vision.ImageRecordDataset(path)
    assert len(got) == 4
    _same(got[2][0], want[2][0])
    assert got[2][1] == want[2][1] == 2.0
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / "tree" / c)
        for k in range(2):
            cv2.imwrite(str(tmp_path / "tree" / c / f"{k}.png"),
                        (rng.rand(8, 9, 3) * 255).astype(np.uint8))
    np.save(str(tmp_path / "tree" / "dog" / "z.npy"), np.ones((2, 2, 3)))
    with mx.cpu():
        got = tdata.vision.ImageFolderDataset(str(tmp_path / "tree"))
    want = jdata.vision.ImageFolderDataset(str(tmp_path / "tree"))
    assert got.synsets == want.synsets == ["cat", "dog"]
    assert len(got) == len(want) == 5
    for i in range(5):
        _same(got[i][0], want[i][0])
        assert got[i][1] == want[i][1]


def _image(seed=0, hw=(20, 24)):
    return (np.random.RandomState(seed).rand(*hw, 3) * 255).astype(np.uint8)


_TRANSFORMS = [
    ("Cast", ("float16",)), ("ToTensor", ()),
    ("Normalize", ((0.4, 0.5, 0.6), (0.2, 0.3, 0.25))),
    ("Resize", (16,)), ("Resize", ((12, 9),)), ("CenterCrop", (10,)),
    ("CenterCrop", ((8, 12),)), ("RandomResizedCrop", (12,)),
    ("RandomFlipLeftRight", ()), ("RandomFlipTopBottom", ()),
    ("RandomBrightness", (0.3,)), ("RandomContrast", (0.3,)),
    ("RandomSaturation", (0.3,)), ("RandomHue", (0.2,)),
    ("RandomLighting", (0.1,)),
    ("RandomColorJitter", (0.2, 0.2, 0.2, 0.1)),
]


@pytest.mark.parametrize("name,args", _TRANSFORMS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(_TRANSFORMS)])
def test_transforms_equal_the_references_on_the_same_draws(name, args):
    outs = []
    for mod in (T, jT):
        np.random.seed(5)
        random.seed(5)
        t = getattr(mod, name)(*args)
        chw = name == "Normalize"       # after ToTensor
        outs.append([t(_image(s).transpose(2, 0, 1) / 255. if chw
                       else _image(s)) for s in range(4)])
    _same(outs[0], outs[1], exact=False)
    assert all(isinstance(o, np.ndarray) for o in outs[0])


def test_compose_with_labels_and_batched_to_tensor():
    tf = T.Compose([T.RandomFlipLeftRight(), T.ToTensor()])
    x, y = tf(_image(), 3)
    assert x.shape == (3, 20, 24) and y == 3
    batch = np.stack([_image(s) for s in range(2)])
    _same(T.ToTensor()(batch), jT.ToTensor()(batch))
