"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under the
package's ``_build/`` directory (listed in ``.gitignore``) and loaded with
`ctypes`; no PyTorch headers are compiled, so a build takes seconds. The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is reused. Only sources in the
repository are built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..base import MXNetError

__all__ = ["NVCC_FLAGS", "build", "build_all", "cuda_tool", "load",
           "source_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs = {}       # name -> ctypes.CDLL
_build_info = {}  # name -> {"seconds": float or None, "log": str, "path": str}


def source_path(name):
    return os.path.join(_SRC_DIR, name + ".cu")


def cuda_tool(name):
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on the
    ``PATH``, or in ``/usr/local/cuda/bin``."""
    path = shutil.which(name)
    if path is None and os.path.exists("/usr/local/cuda/bin/" + name):
        path = "/usr/local/cuda/bin/" + name
    if path is None:
        raise MXNetError("%s not found: the CUDA kernels build only on a "
                         "machine with the CUDA toolkit" % name)
    return path


def _target(name):
    src = source_path(name)
    if not os.path.exists(src):
        raise MXNetError("no kernel source %s" % src)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(_BUILD_DIR, "%s-%s.so"
                             % (name, digest.hexdigest()[:16]))


def build_all(names):
    """Compile every named source that has no current library, one ``nvcc``
    process per source, all started together. Returns
    ``{name: {"seconds", "log", "path"}}`` (``seconds`` is None for a
    library that was already built). Raises `MXNetError` with the
    compiler's output when a build fails."""
    with _lock:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        procs = {}
        for name in names:
            src, out = _target(name)
            if os.path.exists(out):
                _build_info.setdefault(
                    name, {"seconds": None, "log": "", "path": out})
                continue
            tmp = "%s.tmp-%d" % (out, os.getpid())
            cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, src]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.monotonic())
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append("%s (rc %d):\n%s" % (name, proc.returncode, log))
                continue
            os.replace(tmp, out)  # atomic: a reader never sees half a file
            _build_info[name] = {"seconds": time.monotonic() - t0,
                                 "log": log, "path": out}
        if failed:
            raise MXNetError("nvcc failed for " + "\n".join(failed))
        return {name: dict(_build_info[name]) for name in names}


def build(name):
    """Build one kernel library (see `build_all`); returns its info."""
    return build_all([name])[name]


def load(name):
    """The loaded `ctypes.CDLL` of kernel ``name``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build(name)["path"]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(path)
                _libs[name] = lib
    return lib
