"""Runtime feature introspection, the card's peak rate and the bounded
device dial (counterpart of `mxnet_tpu/runtime.py`; reference:
python/mxnet/runtime.py over src/libinfo.cc).

`Features` answers the JAX package's feature names for the port: ``TPU``
and ``PALLAS`` are off (Pallas source cannot run on a CUDA card), ``GPU``
is whether `torch.cuda` has a card, ``NATIVE_IO`` is off (the port has
no C record library), and the rest hold as they do in the port. Where
the port has the thing, the reference's own names are answered too:
``CUDA``, ``CUDNN``, ``NCCL`` and ``CUDA_RTC`` (NVRTC behind `rtc`).

The peak table: `telemetry.observe_step` divides a step's FLOPs by its
seconds and by this peak to publish ``mxtpu_step_mfu``. The table holds
each card's dense bf16 tensor-core peak, keyed by the name
`torch.cuda.get_device_name` reports; a card the table does not know, or
the CPU, has no peak (None), and then no MFU is published, as the JAX
package publishes none for an unknown chip.

`dial_devices` enumerates the cards behind a deadline: the enumeration
runs on a daemon thread, a second call while it is still blocked waits on
the same thread, each dial is bracketed by flight-recorder events (the
JAX package's names, ``pjrt_dial_start`` / ``_ok`` / ``_timeout`` /
``_error``, since the telemetry schema is shared), and a dial that found a
card writes the ``MXTPU_TOPOLOGY_CACHE`` file, so a later failed dial can
still say what hardware went missing.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

import torch

from . import env as _env
from . import telemetry
from .base import MXNetError, atomic_writer

__all__ = ["Feature", "Features", "feature_list", "is_enabled",
           "PEAK_BF16_TFLOPS", "chip_peak_tflops", "dial_devices",
           "cached_topology"]

Feature = collections.namedtuple("Feature", ["name", "enabled"])


def _detect():
    feats = {}

    def add(name, fn):
        try:
            feats[name] = bool(fn())
        except Exception:  # noqa: BLE001 - a failed probe is a missing feature
            feats[name] = False

    cuda = torch.cuda.is_available()
    add("TPU", lambda: False)
    add("GPU", lambda: cuda)
    add("CPU", lambda: True)
    add("F16C", lambda: True)          # float16 compute through torch
    add("BF16", lambda: True)
    add("INT8", lambda: True)          # int8 products (contrib.quantization)
    add("PALLAS", lambda: False)       # Pallas source runs on no CUDA card
    add("DIST_KVSTORE", torch.distributed.is_available)
    add("OPENCV", _cv_available)       # image decode: cv2 or Pillow
    add("NATIVE_IO", lambda: False)    # no C record library in the port
    add("SIGNAL_HANDLER", lambda: True)
    add("PROFILER", lambda: True)
    # the reference's own names for what the port has on a card
    add("CUDA", lambda: cuda and torch.version.cuda is not None)
    add("CUDNN", lambda: cuda and torch.backends.cudnn.is_available())
    add("NCCL", lambda: cuda and torch.distributed.is_available()
        and torch.distributed.is_nccl_available())
    add("CUDA_RTC", _rtc_available)
    return feats


def _cv_available():
    try:
        import cv2  # noqa: F401

        return True
    except ImportError:
        from PIL import Image  # noqa: F401

        return True


def _rtc_available():
    from . import rtc

    rtc._driver()
    return True


class Features(collections.OrderedDict):
    """Mapping name -> Feature (reference: runtime.py:45 class Features)."""

    instance = None

    def __init__(self):
        super().__init__(
            (name, Feature(name, enabled)) for name, enabled in _detect().items())

    def __repr__(self):
        return "[%s]" % ", ".join(
            "%s%s" % ("\u2714 " if f.enabled else "\u2716 ", f.name)
            for f in self.values())

    def is_enabled(self, feature_name):
        """reference: runtime.py:78 Features.is_enabled."""
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError("feature '%s' is unknown" % feature_name)
        return self[feature_name].enabled


def feature_list():
    """List of Feature tuples (reference: runtime.py:95 feature_list)."""
    return list(Features().values())


def is_enabled(feature_name):
    """Whether ``feature_name`` is on (``Features().is_enabled``)."""
    return Features().is_enabled(feature_name)

# dense (not 2:4 sparse) bf16 tensor-core TFLOP/s a card, from NVIDIA's
# data sheets; the H100 SXM figure is the one PERF.md's hand MFU uses
PEAK_BF16_TFLOPS = {
    "H100 80GB HBM3": 989.0,   # H100 SXM5
    "H100 SXM": 989.0,
    "H100 NVL": 835.0,
    "H100 PCIe": 756.0,
    "H200": 989.0,
    "GH200": 989.0,
    "A100": 312.0,
}


def chip_peak_tflops(device=None):
    """Peak dense bf16 TFLOP/s of the CUDA card ``device`` (an index, a
    `torch.device` or its string; default the current card), or None for
    the CPU, a machine without a card, or a card the table lacks."""
    if device is not None and not isinstance(device, int):
        device = torch.device(device)
        if device.type != "cuda":
            return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    # longest key first, so "H100 NVL" is not read as another H100
    for key, peak in sorted(PEAK_BF16_TFLOPS.items(),
                            key=lambda kv: -len(kv[0])):
        if key.lower() in name.lower():
            return peak
    return None


# ---------------------------------------------------------------------------
# the bounded device dial
# ---------------------------------------------------------------------------

def _topology_cache_path():
    return _env.raw("MXTPU_TOPOLOGY_CACHE") or None


def cached_topology(path=None):
    """The last successfully dialed topology (platform, device kind, count,
    timestamp) from the ``MXTPU_TOPOLOGY_CACHE`` file, or None when no
    cache exists or the variable is unset."""
    path = path or _topology_cache_path()
    if not path:
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _write_topology(devices, path=None):
    path = path or _topology_cache_path()
    if not path:
        return
    try:
        with atomic_writer(path, "w") as f:
            json.dump({
                "platform": "gpu",
                "device_kind": torch.cuda.get_device_name(devices[0]),
                "device_count": len(devices),
                "time": time.time(),
            }, f, indent=1)
    except OSError:
        pass  # the cache is best-effort; never fail a successful dial


def _enumerate():
    """The cards as `torch.device`s, or the host's when there is none."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def dial_devices(timeout_s=None, cache=True):
    """The devices (`torch.device`s: every card, else the host) behind a
    deadline of ``timeout_s`` seconds (``MXTPU_DIAL_TIMEOUT_S``).

    The enumeration initializes CUDA, which a wedged driver can block. It
    runs on a daemon thread; on expiry an `MXNetError` names the last
    cached topology while the thread stays parked (a second call waits on
    the same dial; a failed one is dropped, so a retry dials anew). Every
    dial is bracketed by flight-recorder events (``pjrt_dial_start`` /
    ``_ok`` / ``_timeout`` / ``_error``), and a dial that found a card
    refreshes the ``MXTPU_TOPOLOGY_CACHE`` file.
    """
    if timeout_s is None:
        timeout_s = _env.get("MXTPU_DIAL_TIMEOUT_S")
    done = threading.Event()
    result, err = [], []

    def probe():
        try:
            result.extend(_enumerate())
        except Exception as e:  # noqa: BLE001 - reported to the caller
            err.append(e)
        done.set()

    telemetry.record_event("pjrt_dial_start", timeout_s=timeout_s,
                           pid=os.getpid())
    t0 = time.monotonic()
    with _DIAL_LOCK:
        if _DIAL_THREAD and _DIAL_THREAD[0][1].is_set() and _DIAL_THREAD[0][3]:
            _DIAL_THREAD.clear()
        if not _DIAL_THREAD:
            t = threading.Thread(target=probe, daemon=True,
                                 name="mxtpu-device-dial")
            _DIAL_THREAD.append((t, done, result, err))
            t.start()
        else:
            _, done, result, err = _DIAL_THREAD[0]
    if not done.wait(timeout_s):
        cached = cached_topology()
        telemetry.record_event("pjrt_dial_timeout", timeout_s=timeout_s,
                               cached_topology=cached)
        raise MXNetError(
            "device dial (torch.cuda) still blocked after %.0fs "
            "(MXTPU_DIAL_TIMEOUT_S; wedged driver?). Last known topology: "
            "%s" % (timeout_s, cached or "none cached"))
    if err:
        telemetry.record_event("pjrt_dial_error", error=str(err[0])[:500])
        raise MXNetError("device enumeration failed: %s" % err[0]) \
            from err[0]
    platform = "gpu" if result[0].type == "cuda" else "cpu"
    telemetry.record_event(
        "pjrt_dial_ok", seconds=round(time.monotonic() - t0, 3),
        platform=platform, device_count=len(result))
    if cache and platform != "cpu":
        _write_topology(result)
    return list(result)


_DIAL_LOCK = threading.Lock()
_DIAL_THREAD = []  # at most one parked dial thread a process
