"""Vision models of ``gluon/model_zoo/vision``: ResNet v1/v2
(:mod:`.resnet`), AlexNet, VGG, SqueezeNet, MobileNet v1/v2, DenseNet
and Inception v3, and ``get_model(name, **kwargs)`` over every factory
the reference registers (``resnet50_v1``, ``vgg16``, ``mobilenet1_0``,
``mobilenet_v2_1_0``, ``inception_v3``, ...).  ``pretrained=True``
raises :class:`~tpu_mx_torch.base.MXNetError`: no weights are
downloaded."""
from . import alexnet as _alexnet
from . import densenet as _densenet
from . import inception as _inception
from . import mobilenet as _mobilenet
from . import resnet
from . import squeezenet as _squeezenet
from . import vgg as _vgg
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403

_FAMILIES = (resnet, _alexnet, _vgg, _mobilenet, _squeezenet, _densenet,
             _inception)
_models = {name: getattr(mod, name) for mod in _FAMILIES
           for name in mod.__all__
           if name[0].islower() and callable(getattr(mod, name))}


def get_model(name, **kwargs):
    """The zoo's network ``name`` (case-insensitive) built with
    ``kwargs`` (``classes=``, ``device=``, ``dtype=``, ...)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"model {name!r} not in model zoo; available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)


__all__ = ["resnet", "get_model"] + [n for mod in _FAMILIES
                                     for n in mod.__all__]
