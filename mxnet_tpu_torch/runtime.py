"""The card's peak rate (counterpart of `mxnet_tpu/runtime.py`'s chip
peak table, `chip_peak_tflops`; the rest of that module, the feature list
and the bounded accelerator dial, is not ported yet: ROADMAP queue 1,
order step 7).

`telemetry.observe_step` divides a step's FLOPs by its seconds and by
this peak to publish ``mxtpu_step_mfu``. The table holds each card's
dense bf16 tensor-core peak, keyed by the name
`torch.cuda.get_device_name` reports; a card the table does not know, or
the CPU, has no peak (None), and then no MFU is published, as the JAX
package publishes none for an unknown chip.
"""
from __future__ import annotations

import torch

__all__ = ["PEAK_BF16_TFLOPS", "chip_peak_tflops"]

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
