"""Generate module-level op functions from the registry.

Counterpart of `mxnet_tpu/ndarray/register.py` (reference mechanism:
python/mxnet/ndarray/register.py:170 `_init_op_module`): each `OpDef` gets
a wrapper that splits NDArray arguments from attrs by the op function's
signature, then calls `ndarray.invoke`. Every registered name lands at the
top of ``mx.nd`` and in the flat ``mx.nd.op`` namespace, and the prefixed
ones also, without their prefix, in the JAX package's namespaces:
``_contrib_*`` in ``contrib``, ``_linalg_*`` in ``linalg``, ``_random_*``
in ``random`` and ``_sample_*`` in ``random`` as ``sample_*``, ``_image_*``
in ``image``.
"""
from __future__ import annotations

import inspect

from .. import ops as _ops
from .ndarray import NDArray, invoke


def _make_function(opdef):
    fn = opdef.fn
    try:
        sig = inspect.signature(fn)
        params = list(sig.parameters.values())
    except (TypeError, ValueError):
        params = []
    var_pos = any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params)
    pos_params = [p for p in params
                  if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    pos_names = [p.name for p in pos_params]

    def generated(*args, out=None, name=None, **kwargs):
        inputs = []
        attrs = {}
        ctx = kwargs.pop("ctx", None)
        if var_pos:
            for a in args:
                if isinstance(a, NDArray):
                    inputs.append(a)
                else:
                    raise TypeError("%s: positional args must be NDArray" % opdef.name)
            kwargs.pop("num_args", None)
            attrs.update(kwargs)
        else:
            # arrays-first convention: leading NDArray (or None, an optional
            # array left out) positionals bind by position; from the first
            # attr on, every argument binds by name, as do keyword
            # arguments (NDArrays included), so none shifts into another
            # parameter's slot
            by_name = False
            for i, a in enumerate(args):
                if i >= len(pos_names):
                    if isinstance(a, NDArray) and not by_name:
                        inputs.append(a)
                    elif a is not None:
                        raise TypeError("%s: unexpected extra positional %r"
                                        % (opdef.name, a))
                elif not by_name and (isinstance(a, NDArray) or a is None):
                    inputs.append(a)
                else:
                    by_name = True
                    attrs[pos_names[i]] = a
            while inputs and inputs[-1] is None:
                inputs.pop()  # trailing optional arrays take their default
            attrs.update(kwargs)
        return invoke(opdef.name, tuple(inputs), attrs, out=out, ctx=ctx)

    generated.__name__ = opdef.name
    sig_str = "(%s)" % ", ".join(
        [str(p) for p in params] + ["out=None", "name=None"]) \
        if params else "(...)"
    generated.__doc__ = "%s%s\n\n%s\n(auto-generated from op '%s')" % (
        opdef.name, sig_str, (fn.__doc__ or "").strip(), opdef.name)
    return generated


class _OpNamespace(object):
    pass


_NAMESPACES = (("_contrib_", "contrib", ""), ("_linalg_", "linalg", ""),
               ("_random_", "random", ""), ("_sample_", "random", "sample_"),
               ("_image_", "image", ""))


def populate(target_module_dict):
    """Install generated functions into the nd module namespace: each name
    at the top unless the module already defines it, all of them in
    ``op``, and the prefixed ones in their namespace (`_NAMESPACES`:
    ``mx.nd.random.uniform``, ``mx.nd.linalg.potrf``,
    ``mx.nd.contrib.CTCLoss``, ``mx.nd.image.to_tensor``)."""
    spaces = {ns: _OpNamespace() for _, ns, _ in _NAMESPACES}
    op_ns = _OpNamespace()
    for name in _ops.list_ops():
        f = _make_function(_ops.get(name))
        if name.isidentifier():
            setattr(op_ns, name, f)  # flat mx.nd.op.* (reference op.py)
        for prefix, ns, renamed in _NAMESPACES:
            if name.startswith(prefix):
                setattr(spaces[ns], renamed + name[len(prefix):], f)
        target_module_dict.setdefault(name, f)
    target_module_dict.setdefault("op", op_ns)
    for ns, space in spaces.items():
        target_module_dict.setdefault(ns, space)
