"""Jupyter-notebook training instrumentation (counterpart of
`mxnet_tpu/notebook/`; reference: python/mxnet/notebook/)."""
from . import callback  # noqa: F401
