"""Generate module-level op functions from the registry.

Counterpart of `mxnet_tpu/ndarray/register.py` (reference mechanism:
python/mxnet/ndarray/register.py:170 `_init_op_module`): each `OpDef` gets
a wrapper that splits NDArray arguments from attrs by the op function's
signature, then calls `ndarray.invoke`. Every registered name lands at the
top of ``mx.nd`` and in the flat ``mx.nd.op`` namespace.
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
    # arrays-first convention: a param is an array slot iff it has no
    # default or its default is None (optional array); a non-None default
    # marks an attr. Used to avoid injecting placeholder Nones for
    # unsupplied attrs that happen to precede the last supplied array.
    arrayish = {p.name: (p.default is inspect.Parameter.empty
                         or p.default is None) for p in pos_params}

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
            # bind arguments to their declared parameter slot: a None in an
            # optional array slot rides as a positional placeholder, so a
            # later array keeps its declared position
            slot = {}
            extras = []  # NDArray positionals past the declared signature
            consumed = set()
            for i, a in enumerate(args):
                pname = pos_names[i] if i < len(pos_names) else None
                if pname is None:
                    if isinstance(a, NDArray):
                        extras.append(a)
                    elif a is not None:
                        raise TypeError(
                            "%s: unexpected extra positional %r"
                            % (opdef.name, a))
                elif isinstance(a, NDArray) or a is None:
                    slot[pname] = a
                    consumed.add(pname)
                else:
                    attrs[pname] = a
                    consumed.add(pname)
            # NDArray kwargs bind to their own declared slot too
            for pname in pos_names:
                if pname not in consumed and pname in kwargs \
                        and isinstance(kwargs[pname], NDArray):
                    slot[pname] = kwargs.pop(pname)
            attrs.update({k: v for k, v in kwargs.items()
                          if not isinstance(v, NDArray)})
            order = {p: i for i, p in enumerate(pos_names)}
            arr_idx = [order[p] for p, v in slot.items()
                       if v is not None and p in order]
            if arr_idx:
                last = max(arr_idx)
                # interior gaps (optional arrays not provided) ride as
                # None; trailing Nones are dropped (defaults apply), and
                # unsupplied attr params are skipped
                inputs = [slot.get(p) for p in pos_names[:last + 1]
                          if p in slot or (p not in attrs and arrayish[p])]
            inputs.extend(extras)
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


def populate(target_module_dict):
    """Install generated functions into the nd module namespace: each name
    at the top unless the module already defines it, and all of them in
    ``op``."""
    op_ns = _OpNamespace()
    for name in _ops.list_ops():
        f = _make_function(_ops.get(name))
        if name.isidentifier():
            setattr(op_ns, name, f)  # flat mx.nd.op.* (reference op.py)
        target_module_dict.setdefault(name, f)
    target_module_dict.setdefault("op", op_ns)
