"""Runtime kernel compilation (RTC): CUDA C++ source compiled at run time
with NVRTC for ``sm_90a`` and launched through the CUDA driver API on
NDArrays, which the kernel updates in place.

This is the reference's own contract (python/mxnet/rtc.py:42 `CudaModule`,
:173 `CudaKernel`, over src/common/rtc.cc:35-60), which the JAX package
could only imitate with Pallas source (`mxnet_tpu/rtc.py`: `PallasModule`,
whose `PallasKernel._build` (:198) wraps the user's kernel in
`pl.pallas_call` (:243); `CudaModule` is an alias there). On the card the
port compiles real CUDA C++; `PallasModule` is not ported (Pallas source
cannot run on the card).

- ``CudaModule(source, options=(), exports=())`` compiles ``source`` once
  with NVRTC (``--gpu-architecture=sm_90a -std=c++17``, the toolkit's
  include directory, then ``options``). ``exports`` names kernels by C++
  name expressions (``"axpy<float>"``); their lowered names are looked
  up after the compile. A failed compile raises `MXNetError` with NVRTC's
  log.
- ``get_kernel(name, signature)`` parses the C-style ``signature``
  (``"const float *x, float *y, float alpha"``; the grammar and type
  table of the reference, plus ``bfloat16`` / ``__nv_bfloat16``), loads
  the module on the current card (``cuModuleLoadData``, once a card) and
  returns a `CudaKernel` holding its ``CUfunction``.
- ``CudaKernel.launch(args, ctx, grid_dims, block_dims, shared_mem=0)``
  launches on ``ctx``'s current torch stream (``cuLaunchKernel``), so a
  torch op after it sees the result without a sync. Pointer parameters
  take NDArrays on ``ctx``, contiguous and of the signature's dtype
  (anything else raises); the kernel gets ``data_ptr()``.
  Scalars pass by value in their C type (``__half`` and the bfloat16
  types as their 16 bits). ``grid_dims`` / ``block_dims`` are CUDA's
  gridDim / blockDim (1 to 3 sizes); ``shared_mem`` is dynamic shared
  memory in bytes, above 48 KB after the function's attribute is raised.
  The non-const pointer arguments are the outputs: written in place and
  returned, in signature order, as the same objects.

Every check runs before any driver call. There is no CPU path: a CPU
``ctx``, an array off ``ctx``, or a machine without a card or NVRTC raises.
Errors in a running kernel are asynchronous, as for any CUDA launch; they
surface at the next synchronisation (`NDArray.wait_to_read`).

Example (the reference's axpy, python/mxnet/rtc.py:46-59)::

    source = r'''
    extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
        int i = threadIdx.x + blockIdx.x * blockDim.x;
        y[i] += alpha * x[i];
    }
    '''
    module = mx.rtc.CudaModule(source)
    func = module.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((10,), ctx=mx.gpu(0))
    y = mx.nd.zeros((10,), ctx=mx.gpu(0))
    func.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
"""
from __future__ import annotations

import ctypes
import glob
import os
import re
import threading
import time

import numpy as _np
import torch

from .base import MXNetError
from .context import resolve_device
from .ndarray import NDArray
from .ops import _build

__all__ = ["CudaModule", "CudaKernel"]

# reference: rtc.py:30 _DTYPE_CPP_TO_NP, plus the JAX package's bfloat16
# and CUDA's own name for it
_DTYPE_CPP_TO_NP = {
    "float": _np.float32,
    "double": _np.float64,
    "__half": _np.float16,
    "bfloat16": "bfloat16",
    "__nv_bfloat16": "bfloat16",
    "uint8_t": _np.uint8,
    "int": _np.int32,
    "int32_t": _np.int32,
    "int8_t": _np.int8,
    "char": _np.int8,
    "int64_t": _np.int64,
}

# dynamic shared memory a block may use before the function's limit must
# be raised (CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES)
_SMEM_DEFAULT = 48 * 1024
_ATTR_MAX_DYNAMIC_SMEM = 8
_CUDA_ERROR_NOT_FOUND = 500


def _dtype(ctype):
    d = _DTYPE_CPP_TO_NP[ctype]
    return d if d == "bfloat16" else _np.dtype(d)


def _parse_signature(signature):
    """reference: CudaModule.get_kernel rtc.py:112-171 — the C-style
    parameter grammar; returns [(name, dtype, is_ndarray, is_const)]."""
    pattern = re.compile(r"""^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)\s*$""")
    args = []
    for param in signature.split(","):
        match = pattern.match(param)
        if not match:
            raise MXNetError(
                "Invalid function prototype \"%s\". Must be in the form of "
                "\"(const) type (*) name\"" % param)
        is_const, ctype, is_ptr, name = match.groups()
        if ctype not in _DTYPE_CPP_TO_NP:
            raise MXNetError("Unsupported kernel argument type %s" % param)
        args.append((name, _dtype(ctype), bool(is_ptr), bool(is_const)))
    return args


def _scalar(value, dtype):
    """A kernel parameter's bytes: ``value`` in the C type of ``dtype``
    (bfloat16 rounded to nearest even, as the card converts)."""
    if dtype == "bfloat16":
        bits = torch.tensor([float(value)]).to(torch.bfloat16)
        raw = bits.view(torch.int16).numpy().tobytes()
    else:
        raw = _np.asarray(value, dtype=dtype).tobytes()
    return ctypes.create_string_buffer(raw, len(raw))


def _dims(dims, what):
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError("%s must be 1 to 3 positive sizes (CUDA's %s), "
                         "got %s" % (what, "gridDim" if what == "grid_dims"
                                     else "blockDim", dims))
    return dims + (1,) * (3 - len(dims))


def _cuda_device(ctx):
    """``ctx`` as a CUDA `torch.device`; a CPU context, or any context
    without a card, raises."""
    dev = torch.device(ctx)
    if dev.type != "cuda":
        raise MXNetError("mx.rtc launches CUDA kernels and has no CPU path; "
                         "ctx %s is not a CUDA device" % dev)
    return resolve_device(dev)


# --------------------------------------------------------------------------
# NVRTC and the CUDA driver, through ctypes
# --------------------------------------------------------------------------

def _toolkit_root():
    root = os.environ.get("CUDA_HOME")
    if root and os.path.isdir(root):
        return root
    try:
        return os.path.dirname(os.path.dirname(os.path.realpath(
            _build.cuda_tool("nvcc"))))
    except MXNetError:
        return None


def _load_nvrtc(root):
    names = []
    if root:
        for sub in ("lib64", "lib"):
            names.append(os.path.join(root, sub, "libnvrtc.so"))
            names.extend(sorted(glob.glob(os.path.join(root, sub,
                                                       "libnvrtc.so.*"))))
    major = (torch.version.cuda or "12").split(".")[0]
    names += ["libnvrtc.so.%s" % major, "libnvrtc.so"]
    for name in names:
        if os.sep in name and not os.path.exists(name):
            continue
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise MXNetError("NVRTC (libnvrtc.so) not found in the CUDA toolkit "
                     "(%s) or on the library path: mx.rtc compiles on a "
                     "machine with the CUDA toolkit" % (root,))


def _sig(fn, restype, *argtypes):
    fn.restype = restype
    fn.argtypes = list(argtypes)


class _Driver:
    """The NVRTC and CUDA driver calls `CudaModule` and `CudaKernel` make:
    one object a process (`_driver`)."""

    def __init__(self):
        root = _toolkit_root()
        self.include = os.path.join(root, "include") if root else None
        nv = self.nvrtc = _load_nvrtc(root)
        try:
            cu = self.cuda = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError("the CUDA driver (libcuda.so.1) did not load: "
                             "%s" % e) from None
        P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        PP, CP = ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p
        _sig(nv.nvrtcGetErrorString, CP, I)
        _sig(nv.nvrtcCreateProgram, I, PP, CP, CP, I, P, P)
        _sig(nv.nvrtcAddNameExpression, I, P, CP)
        _sig(nv.nvrtcCompileProgram, I, P, I, ctypes.POINTER(CP))
        _sig(nv.nvrtcGetProgramLogSize, I, P, ctypes.POINTER(S))
        _sig(nv.nvrtcGetProgramLog, I, P, CP)
        _sig(nv.nvrtcGetCUBINSize, I, P, ctypes.POINTER(S))
        _sig(nv.nvrtcGetCUBIN, I, P, CP)
        _sig(nv.nvrtcGetLoweredName, I, P, CP, ctypes.POINTER(CP))
        _sig(nv.nvrtcDestroyProgram, I, PP)
        _sig(cu.cuInit, I, ctypes.c_uint)
        _sig(cu.cuGetErrorName, I, I, ctypes.POINTER(CP))
        _sig(cu.cuGetErrorString, I, I, ctypes.POINTER(CP))
        _sig(cu.cuDeviceGet, I, ctypes.POINTER(I), I)
        _sig(cu.cuDevicePrimaryCtxRetain, I, PP, I)
        _sig(cu.cuCtxSetCurrent, I, P)
        _sig(cu.cuModuleLoadData, I, PP, P)
        _sig(cu.cuModuleUnload, I, P)
        _sig(cu.cuModuleGetFunction, I, PP, P, CP)
        _sig(cu.cuFuncSetAttribute, I, P, I, I)
        _sig(cu.cuLaunchKernel, I, P, *([ctypes.c_uint] * 7), P, PP, PP)
        self._lock = threading.Lock()
        self._contexts = {}   # card index -> its retained primary context
        self.compiles = 0
        self._check(cu.cuInit(0), "cuInit")

    def _check(self, rc, what):
        if rc != 0:
            name, text = ctypes.c_char_p(), ctypes.c_char_p()
            self.cuda.cuGetErrorName(rc, ctypes.byref(name))
            self.cuda.cuGetErrorString(rc, ctypes.byref(text))
            raise MXNetError("%s failed: %s (%s)" % (
                what, (name.value or b"CUDA error %d" % rc).decode(),
                (text.value or b"").decode()))

    def _nvrtc_check(self, rc, what):
        if rc != 0:
            raise MXNetError("%s failed: %s" % (
                what, self.nvrtc.nvrtcGetErrorString(rc).decode()))

    def compile(self, source, options, exports):
        """(cubin bytes, {export: lowered name}) of ``source``."""
        nv = self.nvrtc
        prog = ctypes.c_void_p()
        self._nvrtc_check(nv.nvrtcCreateProgram(
            ctypes.byref(prog), source.encode(), b"mx_rtc.cu", 0, None,
            None), "nvrtcCreateProgram")
        try:
            for name in exports:
                self._nvrtc_check(nv.nvrtcAddNameExpression(
                    prog, name.encode()), "nvrtcAddNameExpression")
            opts = ["--gpu-architecture=sm_90a", "-std=c++17"]
            if self.include:
                opts.append("--include-path=" + self.include)
            opts = [o.encode() for o in opts + list(options)]
            rc = nv.nvrtcCompileProgram(
                prog, len(opts), (ctypes.c_char_p * len(opts))(*opts))
            self.compiles += 1
            if rc != 0:
                size = ctypes.c_size_t()
                nv.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
                log = ctypes.create_string_buffer(size.value)
                nv.nvrtcGetProgramLog(prog, log)
                raise MXNetError("CudaModule source failed to compile (%s):\n"
                                 "%s" % (nv.nvrtcGetErrorString(rc).decode(),
                                         log.value.decode(errors="replace")))
            size = ctypes.c_size_t()
            self._nvrtc_check(nv.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                              "nvrtcGetCUBINSize")
            cubin = ctypes.create_string_buffer(size.value)
            self._nvrtc_check(nv.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
            lowered = {}
            for name in exports:
                out = ctypes.c_char_p()
                self._nvrtc_check(nv.nvrtcGetLoweredName(
                    prog, name.encode(), ctypes.byref(out)),
                    "nvrtcGetLoweredName")
                lowered[name] = out.value.decode()
            return cubin.raw, lowered
        finally:
            nv.nvrtcDestroyProgram(ctypes.byref(prog))

    def _current(self, index):
        """Make card ``index``'s primary context (the one PyTorch uses)
        current in the calling thread: a thread that never touched the card
        has none."""
        with self._lock:
            ctx = self._contexts.get(index)
            if ctx is None:
                dev = ctypes.c_int()
                self._check(self.cuda.cuDeviceGet(ctypes.byref(dev), index),
                            "cuDeviceGet")
                ctx = ctypes.c_void_p()
                self._check(self.cuda.cuDevicePrimaryCtxRetain(
                    ctypes.byref(ctx), dev), "cuDevicePrimaryCtxRetain")
                self._contexts[index] = ctx
        self._check(self.cuda.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")

    def load(self, index, image):
        self._current(index)
        module = ctypes.c_void_p()
        self._check(self.cuda.cuModuleLoadData(ctypes.byref(module), image),
                    "cuModuleLoadData")
        return module

    def unload(self, index, module):
        self._current(index)
        self.cuda.cuModuleUnload(module)

    def function(self, index, module, symbol):
        """The module's ``CUfunction`` named ``symbol``, or None."""
        self._current(index)
        fn = ctypes.c_void_p()
        rc = self.cuda.cuModuleGetFunction(ctypes.byref(fn), module,
                                           symbol.encode())
        if rc == _CUDA_ERROR_NOT_FOUND:
            return None
        self._check(rc, "cuModuleGetFunction")
        return fn

    def set_max_dynamic_smem(self, index, fn, nbytes):
        self._current(index)
        self._check(self.cuda.cuFuncSetAttribute(
            fn, _ATTR_MAX_DYNAMIC_SMEM, nbytes),
            "cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES=%d)" % nbytes)

    def launch(self, index, fn, grid, block, shared_mem, stream, params):
        self._current(index)
        self._check(self.cuda.cuLaunchKernel(
            fn, *grid, *block, shared_mem, stream, params, None),
            "cuLaunchKernel")


_driver_lock = threading.Lock()
_driver_obj = None


def _driver():
    """The process's `_Driver`, made at first use; raises `MXNetError`
    without a card, NVRTC or the CUDA driver."""
    global _driver_obj
    if not torch.cuda.is_available():
        raise MXNetError("mx.rtc needs a CUDA card: it compiles CUDA C++ "
                         "and launches it on the card, with no CPU path")
    with _driver_lock:
        if _driver_obj is None:
            _driver_obj = _Driver()
        return _driver_obj


# --------------------------------------------------------------------------
# the reference's surface
# --------------------------------------------------------------------------

class CudaModule:
    """CUDA C++ compiled at run time (reference: CudaModule rtc.py:42; the
    compile step of src/common/rtc.cc:35-60). ``compile_seconds`` is the
    NVRTC compile's wall time."""

    def __init__(self, source, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self._exports = tuple(exports)
        self._modules = {}   # card index -> CUmodule
        self._lock = threading.Lock()
        self._driver = _driver()
        t0 = time.perf_counter()
        self._image, self._lowered = self._driver.compile(
            source, tuple(options), self._exports)
        self.compile_seconds = time.perf_counter() - t0

    def get_kernel(self, name, signature):
        """reference: CudaModule.get_kernel rtc.py:112. ``name`` is an
        ``extern "C"`` kernel's name or one of ``exports``."""
        args = _parse_signature(signature)
        if self._exports and name not in self._exports:
            raise MXNetError("kernel '%s' is not exported (exports=%s)"
                             % (name, list(self._exports)))
        kernel = CudaKernel(self, name, self._lowered.get(name, name), args)
        kernel._function(torch.cuda.current_device())
        return kernel

    def _function(self, index, symbol, name):
        with self._lock:
            module = self._modules.get(index)
            if module is None:
                module = self._driver.load(index, self._image)
                self._modules[index] = module
        fn = self._driver.function(index, module, symbol)
        if fn is None:
            raise MXNetError(
                "kernel '%s' is not defined by the source (a kernel is found "
                "by its extern \"C\" name, or by a C++ name listed in "
                "exports)" % name)
        return fn

    def __del__(self):
        # a CudaKernel holds its module, so this runs after the last one
        # is gone; at interpreter exit the driver may already be down
        for index, module in getattr(self, "_modules", {}).items():
            try:
                self._driver.unload(index, module)
            except Exception:  # noqa: BLE001 — never raise from __del__
                pass


class CudaKernel:
    """A compiled kernel (reference: CudaKernel rtc.py:173): one
    ``CUfunction`` a card, found at first use there; launching compiles
    nothing. ``CudaKernel.launches`` counts successful launches of every
    kernel."""

    launches = 0

    def __init__(self, module, name, symbol, args):
        self._module = module
        self._name = name
        self._symbol = symbol
        self._args = args  # [(name, dtype, is_ndarray, is_const)]
        self._functions = {}   # card index -> [CUfunction, smem limit set]

    def _function(self, index):
        entry = self._functions.get(index)
        if entry is None:
            entry = [self._module._function(index, self._symbol, self._name),
                     _SMEM_DEFAULT]
            self._functions[index] = entry
        return entry

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """reference: CudaKernel.launch rtc.py:185. Non-const pointer args
        are written in place; returns them, in signature order."""
        if len(args) != len(self._args):
            raise MXNetError("kernel '%s' takes %d arguments, got %d"
                             % (self._name, len(self._args), len(args)))
        dev = _cuda_device(ctx)
        params, outs = [], []
        for val, (aname, dtype, is_nd, is_const) in zip(args, self._args):
            if not is_nd:
                params.append(_scalar(val, dtype))
                continue
            if not isinstance(val, NDArray):
                raise MXNetError("arg '%s' is a pointer and takes an "
                                 "NDArray on the launch's ctx, got %s"
                                 % (aname, type(val).__name__))
            if val.dtype != dtype and str(val.dtype) != str(dtype):
                raise MXNetError("arg '%s' expects dtype %s, got %s"
                                 % (aname, dtype, val.dtype))
            if val.context != dev:
                raise MXNetError("arg '%s' is on %s, not on the launch's "
                                 "ctx %s" % (aname, val.context, dev))
            if not val._data.is_contiguous():
                raise MXNetError("arg '%s' is not contiguous" % aname)
            params.append(ctypes.c_void_p(val._data.data_ptr()))
            if not is_const:
                outs.append(val)
        if not outs:
            raise MXNetError(
                "kernel '%s' has no output (a non-const pointer arg); "
                "CUDA kernels write through global pointers — declare at "
                "least one non-const pointer" % self._name)
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        shared_mem = int(shared_mem)
        if shared_mem < 0:
            raise MXNetError("shared_mem must be >= 0, got %d" % shared_mem)
        # params holds each argument's ctypes value, and args the arrays
        # behind the pointers, until the launch is queued
        packed = (ctypes.c_void_p * len(params))(
            *[ctypes.addressof(p) for p in params])
        entry = self._function(dev.index)
        drv = self._module._driver
        if shared_mem > entry[1]:
            drv.set_max_dynamic_smem(dev.index, entry[0], shared_mem)
            entry[1] = shared_mem
        drv.launch(dev.index, entry[0], grid, block, shared_mem,
                   torch.cuda.current_stream(dev).cuda_stream, packed)
        CudaKernel.launches += 1
        return outs
