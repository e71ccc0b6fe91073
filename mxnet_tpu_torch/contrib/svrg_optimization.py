"""SVRG optimization (counterpart of `mxnet_tpu/contrib/svrg_optimization.py`;
reference: python/mxnet/contrib/svrg_optimization/ — SVRGModule +
_SVRGOptimizer: variance-reduced SGD where a full-batch gradient snapshot
is taken every `update_freq` epochs and each step uses
g_i - g_i(w_snapshot) + g_full).

A Gluon-level trainer wrapper instead of a Module subclass, as in the JAX
package: snapshot params/grads are plain arrays and the corrected update
runs as eager NDArray arithmetic on the parameters' device.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["SVRGTrainer"]


class SVRGTrainer:
    """Variance-reduced SGD trainer (reference: svrg_module.py semantics).

    usage per epoch:
        if epoch % update_freq == 0:
            trainer.take_snapshot(full_batch_grad_fn)   # MEAN grads, full set
        for batch:
            loss.backward()
            trainer.step(bs, batch_grad_fn)  # grads of THIS minibatch at the
                                             # snapshot params, same scale as
                                             # p.grad() (sum over batch)
    The update is (g_batch - g_batch@snapshot)/bs + g_full_mean — the SVRG
    variance-reduced direction (reference: svrg_optimizer.py _SVRGOptimizer).
    """

    def __init__(self, params, learning_rate=0.01, update_freq=2, wd=0.0):
        from ..gluon.parameter import ParameterDict

        if isinstance(params, ParameterDict):
            params = list(params.values())
        self._params = [p for p in params if p.grad_req != "null"]
        if not self._params:
            raise MXNetError("SVRGTrainer: no trainable parameters")
        self.learning_rate = learning_rate
        self.update_freq = update_freq
        self.wd = wd
        self._snapshot = None       # list of param value copies
        self._full_grads = None     # list of full-batch grads at snapshot

    def take_snapshot(self, full_grad_fn):
        """Record w_snapshot and the full-batch gradient at it (reference:
        SVRGModule.update_full_grads)."""
        self._snapshot = [p.data().copy() for p in self._params]
        self._full_grads = full_grad_fn(self._snapshot)
        if len(self._full_grads) != len(self._params):
            raise MXNetError("full_grad_fn must return one grad per param")

    def step(self, batch_size, snapshot_grad_fn=None):
        """SGD step with SVRG correction when a snapshot exists."""
        # capture live batch grads FIRST: snapshot_grad_fn runs its own
        # backward, which overwrites the parameters' grad buffers
        live_grads = [p.grad().copy() for p in self._params]
        corrections = None
        if self._snapshot is not None:
            if snapshot_grad_fn is None:
                raise MXNetError("snapshot_grad_fn required after take_snapshot")
            corrections = snapshot_grad_fn(self._snapshot)
        lr = self.learning_rate
        for i, p in enumerate(self._params):
            g = live_grads[i]
            if corrections is not None:
                upd = (g - corrections[i]) / batch_size + self._full_grads[i]
            else:
                upd = g / batch_size
            if self.wd:
                upd = upd + self.wd * p.data()
            p.data()._set_data((p.data() - lr * upd)._data)
            for d in p.list_data():
                d._fresh_grad = False
