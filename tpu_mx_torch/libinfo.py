"""``mx.libinfo``, from ``tpu_mx/libinfo.py``: the features of
:mod:`~tpu_mx_torch.runtime` under the reference's names.  ``features``
is probed lazily, at its first read (a module ``__getattr__``), as in
the reference: importing the package probes nothing."""
from .runtime import Features, feature_list

__all__ = ["Features", "feature_list", "features", "__version__"]


def __getattr__(name):
    if name == "features":
        return feature_list()
    if name == "__version__":
        from . import __version__ as v
        return v
    raise AttributeError(name)
