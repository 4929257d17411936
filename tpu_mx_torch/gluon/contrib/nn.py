"""``gluon.contrib.nn``, from ``tpu_mx/gluon/contrib/nn.py``: the
``Concurrent``/``HybridConcurrent`` containers, ``Identity``,
``SparseEmbedding``, ``SyncBatchNorm`` and ``PixelShuffle1D/2D/3D``.

``SyncBatchNorm`` is Gluon's ``BatchNorm`` with ``axis=1`` and the check
on ``num_devices``.  Inside a train step whose batch is split over ranks
(``CompiledTrainStep`` over a ``dp`` mesh) ``BatchNorm`` already sums
its statistics over the ranks (``collectives.batch_sum``), so the
statistics are the global batch's, which is what the reference's
``SyncBatchNorm`` gets from its mesh program; ``num_devices`` is taken
and the mesh decides the group.  ``SparseEmbedding``'s gradient is dense,
as the reference's is (``row_sparse`` gradients are not produced).
"""
from __future__ import annotations

from ...base import MXNetError
from ...ndarray import ops
from .. import nn as _nn
from ..block import HybridBlock

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class HybridConcurrent(_nn.HybridSequential):
    """Every child gets the same input; their outputs are concatenated
    along ``axis`` (the Inception branch container)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x, *args):
        return ops.concat(*[block(x) for block in self._modules.values()],
                          dim=self.axis)


class Concurrent(HybridConcurrent):
    """The reference's imperative twin, the same container here."""


class Identity(HybridBlock):
    """Returns its input (a branch of a ``Concurrent`` that passes
    through)."""

    def forward(self, x):
        return x


class SparseEmbedding(_nn.Embedding):
    """``Embedding`` under the reference's sparse-gradient name.  Its
    gradient is a dense ``(input_dim, output_dim)`` table, as the
    reference's is: neither package produces ``row_sparse`` gradients."""


class SyncBatchNorm(_nn.BatchNorm):
    """Batch normalization over the global batch of a ``dp`` split (see
    the module's docstring): ``BatchNorm(axis=1)``; a ``num_devices``
    that is not positive raises :class:`MXNetError`."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        if num_devices is not None and num_devices <= 0:
            raise MXNetError("num_devices must be positive")
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)


class _PixelShuffle(HybridBlock):
    """Sub-pixel upsampling by factors ``r``: ``(N, C·Πr, *S)`` →
    ``(N, C, *(S·r))``, a reshape and a permutation."""

    def __init__(self, factor, ndim, **kwargs):
        super().__init__(**kwargs)
        self._factors = (int(factor),) * ndim if isinstance(
            factor, (int, float)) else tuple(int(f) for f in factor)
        if len(self._factors) != ndim:
            raise MXNetError(f"factor must be int or length-{ndim} tuple")
        self._ndim = ndim

    def forward(self, x):
        f, n = self._factors, self._ndim
        c = x.shape[1]
        prod = 1
        for v in f:
            prod *= v
        if c % prod:
            raise MXNetError(
                f"PixelShuffle: channels {c} not divisible by {prod}")
        spatial = tuple(x.shape[2:])
        # (N, C, r1..rn, s1..sn) -> (N, C, s1, r1, ..., sn, rn)
        x = x.reshape((x.shape[0], c // prod) + f + spatial)
        perm = [0, 1]
        for i in range(n):
            perm.extend([2 + n + i, 2 + i])
        x = x.permute(perm)
        return x.reshape((x.shape[0], c // prod)
                         + tuple(s * r for s, r in zip(spatial, f)))


class PixelShuffle1D(_PixelShuffle):
    def __init__(self, factor, **kwargs):
        super().__init__(factor, 1, **kwargs)


class PixelShuffle2D(_PixelShuffle):
    def __init__(self, factor, **kwargs):
        super().__init__(factor, 2, **kwargs)


class PixelShuffle3D(_PixelShuffle):
    def __init__(self, factor, **kwargs):
        super().__init__(factor, 3, **kwargs)
