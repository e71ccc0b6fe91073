"""Docstring-enhancement registry for generated NDArray functions
(counterpart of `mxnet_tpu/ndarray_doc.py`; reference:
python/mxnet/ndarray_doc.py). Subclass `NDArrayDoc` with a
class named `<op>Doc` whose docstring is appended to the generated op's
help(); `_build_doc` assembles the reference's docstring layout from the
registry metadata (here: the signature-derived arg lists the C ABI's
MXSymbolGetAtomicSymbolInfo reports)."""
from __future__ import annotations

__all__ = ["NDArrayDoc", "_build_doc"]


class NDArrayDoc:
    """Base class: subclasses named `<op>Doc` contribute extra doc."""


def _build_param_doc(arg_names, arg_types, arg_descs):
    lines = ["Parameters", "----------"]
    for n, t, d in zip(arg_names, arg_types, arg_descs):
        lines.append("%s : %s" % (n, t or "NDArray"))
        if d:
            lines.append("    %s" % d)
    return "\n".join(lines) + "\n"


def _build_doc(func_name, desc, arg_names, arg_types, arg_desc,
               key_var_num_args=None, ret_type=None):
    """reference: ndarray_doc.py:132 — assemble the standard doc layout
    plus any registered `<op>Doc` extension."""
    doc = "%s\n\n%s\nout : NDArray, optional\n" \
          "    The output NDArray to hold the result.\n\n" \
          "Returns\n-------\n" \
          "out : NDArray or list of NDArrays\n" \
          "    The output of this function.\n" \
          % (desc, _build_param_doc(arg_names, arg_types, arg_desc))
    extras = [cls.__doc__ for cls in type.__subclasses__(NDArrayDoc)
              if cls.__name__ == "%sDoc" % func_name and cls.__doc__]
    if extras:
        doc += "\n" + "\n".join(extras)
    return doc
