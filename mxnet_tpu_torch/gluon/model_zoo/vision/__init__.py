"""Vision models of the port (counterpart of
`mxnet_tpu.gluon.model_zoo.vision`): ResNet v1 and v2, AlexNet, VGG,
SqueezeNet, DenseNet, Inception V3, MobileNet v1 / v2 and the SSD family,
and `get_model` over the JAX package's name table. The space-to-depth stem
helpers are not ported yet (ROADMAP queue 1 item 9): `get_model` names
them and raises."""
import sys as _sys

from ....base import MXNetError
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .ssd import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403

_FAMILIES = ("resnet", "alexnet", "vgg", "squeezenet", "densenet",
             "inception", "mobilenet", "ssd")

# the JAX table's entries the port has not ported
_NOT_PORTED = ("stem_weight_to_s2d", "convert_stem_params")

# the factories by name, collected as the JAX package collects them: every
# lower-case callable of a family module's __all__ (via sys.modules: `from
# .alexnet import *` binds the function alexnet over the submodule name)
_models = {}
for _fam in _FAMILIES:
    _mod = _sys.modules[__name__ + "." + _fam]
    for _name in _mod.__all__:
        _obj = getattr(_mod, _name)
        if callable(_obj) and _name[0].islower():
            _models[_name] = _obj

__all__ = sorted({n for f in _FAMILIES
                  for n in _sys.modules[__name__ + "." + f].__all__}) \
    + ["get_model"]


def get_model(name, **kwargs):
    """The zoo model ``name`` built with ``kwargs`` (reference:
    model_zoo/vision/__init__.py get_model). Takes the reference's dotted
    names too ("mobilenet0.25", "squeezenet1.0", "inceptionv3",
    "mobilenetv2_1.0") beside the factory names; raises `MXNetError`
    naming the available models for any other."""
    name = name.lower()
    if name not in _models:
        alt = name.replace(".", "_")
        if alt == "inceptionv3":
            alt = "inception_v3"
        alt = alt.replace("mobilenetv2_", "mobilenet_v2_")
        if alt in _models or alt in _NOT_PORTED:
            name = alt
    if name in _NOT_PORTED:
        raise MXNetError("Model %s is not ported yet (the space-to-depth "
                         "stem: ROADMAP queue 1 item 9)" % name)
    if name not in _models:
        raise MXNetError("Model %s not supported. Available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
