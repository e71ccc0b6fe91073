"""Mixture-of-experts layers (counterpart of `mxnet_tpu/gluon/contrib/
moe.py`): expert parallelism over the ``ep`` mesh axis.

`MoEFFN` drops into a transformer cell where the position-wise FFN sits.
Under `parallel.DistributedTrainer` with an ``ep`` axis its expert tables
(names holding "expert") live on their ``ep`` rank, E/ep rows each, and
the routing runs over the global batch of the ``dp`` ranks
(`ops.contrib.topk_moe`).
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["MoEFFN"]


class MoEFFN(HybridBlock):
    """MoE feed-forward: x (..., units) -> (..., units).

    Default is Switch-style top-1 routing; `num_experts_per_token=k` (>=2)
    switches to GShard / Mixtral-style top-k dispatch (normalized gates,
    capacity `capacity_factor * k * T / E` shared across choices in
    priority order), and `z_loss_coef` (>0, ~1e-3) folds the ST-MoE router
    z-loss into the aux loss.

    Load-balancing aux loss (Switch Transformer, alpha~0.01): in eager
    training read `self.aux_loss` after the forward and add
    `moe.aux_loss * alpha` to the loss. Inside a `DistributedTrainer` step
    construct with `return_aux=True`: the forward then returns
    `(out, aux)` and the loss callable folds `aux` in (the attribute is
    not written there, as under the JAX package's trace)."""

    def __init__(self, units, hidden_size, num_experts,
                 capacity_factor=1.25, return_aux=False,
                 num_experts_per_token=1, z_loss_coef=0.0, **kwargs):
        super().__init__(**kwargs)
        if num_experts < 2:
            raise MXNetError("num_experts must be >= 2")
        if not 1 <= int(num_experts_per_token) <= num_experts:
            raise MXNetError("num_experts_per_token must be in [1, "
                             "num_experts]")
        self._cf = float(capacity_factor)
        self._return_aux = bool(return_aux)
        self._k = int(num_experts_per_token)
        self._z_coef = float(z_loss_coef)
        with self.name_scope():
            self.gate_weight = self.params.get(
                "gate_weight", shape=(num_experts, units))
            self.expert_w_in = self.params.get(
                "expert_w_in", shape=(num_experts, units, hidden_size))
            self.expert_w_out = self.params.get(
                "expert_w_out", shape=(num_experts, hidden_size, units))
        self.aux_loss = None

    def hybrid_forward(self, F, x, gate_weight, expert_w_in, expert_w_out):
        if self._k == 1 and self._z_coef == 0.0:
            out, aux = F.contrib.switch_moe(x, gate_weight, expert_w_in,
                                            expert_w_out,
                                            capacity_factor=self._cf)
        else:
            out, lb, z = F.contrib.topk_moe(x, gate_weight, expert_w_in,
                                            expert_w_out, k=self._k,
                                            capacity_factor=self._cf)
            aux = lb + self._z_coef * z
        if self._return_aux:
            return out, aux
        from ...parallel.mesh import step_mesh

        if step_mesh() is None:
            # an eager value only: a trainer step's would hold its graph
            self.aux_loss = aux
        return out
