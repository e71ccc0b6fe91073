"""Docstring-enhancement registry for generated Symbol functions
(counterpart of `mxnet_tpu/symbol_doc.py`; reference:
python/mxnet/symbol_doc.py — same scheme as ndarray_doc with
a Symbol-flavored layout)."""
from __future__ import annotations

from .ndarray_doc import _build_param_doc

__all__ = ["SymbolDoc", "_build_doc"]


class SymbolDoc:
    """Base class: subclasses named `<op>Doc` contribute extra doc.

    reference symbol_doc.py also exposed get_output_shape for doctests:"""

    @staticmethod
    def get_output_shape(sym, **input_shapes):
        """Infer and return output shapes keyed by output name."""
        _, s_outputs, _ = sym.infer_shape(**input_shapes)
        return dict(zip(sym.list_outputs(), s_outputs))


def _build_doc(func_name, desc, arg_names, arg_types, arg_desc,
               key_var_num_args=None, ret_type=None):
    """reference: symbol_doc.py _build_doc."""
    doc = "%s\n\n%s\nname : string, optional.\n" \
          "    Name of the resulting symbol.\n\n" \
          "Returns\n-------\n" \
          "Symbol\n    The result symbol.\n" \
          % (desc, _build_param_doc(arg_names, arg_types, arg_desc))
    extras = [cls.__doc__ for cls in type.__subclasses__(SymbolDoc)
              if cls.__name__ == "%sDoc" % func_name and cls.__doc__]
    if extras:
        doc += "\n" + "\n".join(extras)
    return doc
