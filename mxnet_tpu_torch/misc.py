"""Deprecated learning-rate scheduler aliases (counterpart of
`mxnet_tpu/misc.py`; reference:
python/mxnet/misc.py — the pre-`lr_scheduler` module some 0.x-era scripts
import). The modern API is `mxnet_tpu_torch.lr_scheduler`."""
from __future__ import annotations

import math

__all__ = ["LearningRateScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LearningRateScheduler:
    """reference: misc.py:23 — legacy base; call with the iteration count."""

    def __init__(self):
        self.base_lr = 0.01

    def __call__(self, iteration):
        raise NotImplementedError("must override this")


class FactorScheduler(LearningRateScheduler):
    """reference: misc.py:40 — lr = base_lr * factor^(iteration // step)."""

    def __init__(self, step, factor=0.1):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than "
                             "1 round")
        if factor >= 1.0:
            raise ValueError("Factor must be less than 1 to make lr reduce")
        self.step = step
        self.factor = factor

    def __call__(self, iteration):
        return self.base_lr * math.pow(self.factor,
                                       int(iteration / self.step))


class MultiFactorScheduler(LearningRateScheduler):
    """Step-list variant mirroring lr_scheduler.MultiFactorScheduler under
    the legacy calling convention."""

    def __init__(self, step, factor=0.1):
        super().__init__()
        if not isinstance(step, (list, tuple)) or len(step) < 1:
            raise ValueError("step must be a non-empty list of iterations")
        self.step = list(step)
        self.factor = factor

    def __call__(self, iteration):
        lr = self.base_lr
        for s in self.step:
            if iteration >= s:
                lr *= self.factor
        return lr
