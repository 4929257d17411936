"""``mx.npx``: the neural-network extensions of the numpy namespace, as
``tpu_mx/npx.py`` has them: the ``nd`` operators under their
numpy-era names (the same functions), the control-flow operators of
``nd.contrib``, ``load``/``save``/``waitall``/``seed``, and the
``set_np`` switch.  The port has one array type, as the reference has,
so ``set_np`` records the intent and changes nothing else."""
from __future__ import annotations

import torch

from .ndarray import contrib as _contrib
from .ndarray import ops as _ops

_np_active = False


def set_np(shape=True, array=True, dtype=False):
    """Record numpy-array mode (``is_np_array()``); the arrays are the
    same either way."""
    global _np_active
    _np_active = bool(array)


def reset_np():
    global _np_active
    _np_active = False


def is_np_array():
    return _np_active


def is_np_shape():
    return _np_active


activation = _ops.Activation
batch_norm = _ops.BatchNorm
convolution = _ops.Convolution
fully_connected = _ops.FullyConnected
pooling = _ops.Pooling
dropout = _ops.Dropout
embedding = _ops.Embedding
one_hot = _ops.one_hot
pick = _ops.pick
topk = _ops.topk
softmax = _ops.softmax
log_softmax = _ops.log_softmax
sigmoid = _ops.sigmoid
relu = _ops.relu
batch_dot = _ops.batch_dot
reshape_like = _ops.reshape_like
gather_nd = _ops.gather_nd
sequence_mask = _ops.SequenceMask
leaky_relu = _ops.LeakyReLU


def gelu(data, **kw):
    return _ops.gelu(data)


def load(fname):
    from .ndarray import load as _load
    return _load(fname)


def save(fname, data):
    from .ndarray import save as _save
    return _save(fname, data)


def waitall():
    from .ndarray import waitall as _waitall
    return _waitall()


def seed(s):
    from . import random as _random
    _random.seed(s)


def _arange_like(x, start, step, axis):
    n = x.numel() if axis is None else x.shape[axis]
    out = start + step * torch.arange(n, dtype=torch.float32,
                                      device=x.device)
    return out.reshape(x.shape) if axis is None else out


def arange_like(data, start=0.0, step=1.0, axis=None, **kw):
    """``start + step·i`` in float32, in ``data``'s shape (``axis`` None)
    or along ``axis``."""
    return _ops._apply(_arange_like, (data, start, step, axis), {})


batch_flatten = _ops.Flatten
broadcast_like = _ops.broadcast_like
ctc_loss = _ops.CTCLoss
deconvolution = _ops.Deconvolution
erf = _ops.erf
erfinv = _ops.erfinv
layer_norm = _ops.LayerNorm
multibox_detection = _contrib.MultiBoxDetection
multibox_prior = _contrib.MultiBoxPrior
multibox_target = _contrib.MultiBoxTarget
from .ndarray.rnn_op import RNN as rnn  # noqa: E402
roi_pooling = _ops.ROIPooling
scatter_nd = _ops.scatter_nd
shape_array = _ops.shape_array
slice = _ops.slice
smooth_l1 = _ops.smooth_l1
foreach = _contrib.foreach
while_loop = _contrib.while_loop
cond = _contrib.cond
