"""``MoELayer`` — the expert-parallel mixture-of-experts module.

Port of ``paddle_tpu/incubate/moe/layer.py`` (reference:
``incubate/distributed/models/moe/moe_layer.py:263``: gate ->
global_scatter -> experts -> global_gather -> combine).

The experts are ``ExpertLayer`` modules (SwiGLU, ``XavierUniform``'s
bound from a ``torch.Generator``), stacked on a leading E axis at each
call; the gate is a module of ``gate.py``. Under a global ``HybridMesh``
with ep > 1 the layer computes its rank's expert slice: the input is
this rank's dp rows, replicated over ep; the gate runs on every ep rank
(global over dp); ``moe_expert_compute(ep_axis="ep")`` runs this rank's
``E / ep`` experts and all-reduces the partial combine. After
``backward`` every ep rank holds the whole gradient of the replicated
layer: the gate's, and every expert's (the stacked weights' gradient is
all-gathered over ep). Without such a mesh it runs on one device with
the same numerics. ``l_aux`` holds the last call's aux loss.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import functional as MF
from .gate import GShardGate, JaxStateMixin, NaiveGate, SwitchGate, \
    xavier_uniform

__all__ = ["ExpertLayer", "MoELayer"]


class ExpertLayer(JaxStateMixin, nn.Module):
    """A single expert FFN (moe_layer.py ExpertLayer): SwiGLU d->f->d."""

    def __init__(self, d_model: int, d_hidden: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.w_gate = xavier_uniform((d_model, d_hidden), generator, device)
        self.w_up = xavier_uniform((d_model, d_hidden), generator, device)
        self.w_down = xavier_uniform((d_hidden, d_model), generator, device)

    def forward(self, x):
        return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


class MoELayer(JaxStateMixin, nn.Module):
    """Mixture of experts over a list of ExpertLayers.

    Args mirror moe_layer.py: ``gate`` is a config dict
    ({"type": "gshard"|"switch"|"naive", "top_k": k}) or a gate module;
    ``experts`` a list of ExpertLayer (made from ``num_expert`` and
    ``d_hidden`` when None, then the gate, from ``generator``).
    ``moe_group`` / ``mp_group`` are accepted for API parity; placement
    comes from the global HybridMesh's ep axis. Parameter names are the
    JAX layer's (``expert_<i>.w_gate``, ``gate.weight``)."""

    def __init__(self, d_model: int, experts: Optional[List[nn.Module]] = None,
                 gate=None, moe_group=None, mp_group=None,
                 recompute_interval: int = 0,
                 num_expert: Optional[int] = None,
                 d_hidden: Optional[int] = None,
                 capacity_factor: float = 2.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if experts is None:
            if not (num_expert and d_hidden):
                raise ValueError("pass experts=[...] or num_expert+d_hidden")
            experts = [ExpertLayer(d_model, d_hidden, generator, device)
                       for _ in range(num_expert)]
        self.experts = list(experts)
        for i, e in enumerate(self.experts):
            self.add_module(f"expert_{i}", e)
        self.num_expert = len(self.experts)
        self.capacity_factor = capacity_factor
        if gate is None or isinstance(gate, dict):
            cfg = dict(gate or {})
            cls = {"gshard": GShardGate, "switch": SwitchGate,
                   "naive": NaiveGate}[cfg.get("type", "gshard")]
            gate = cls(d_model, self.num_expert, topk=cfg.get("top_k", 2),
                       generator=generator, device=device)
        self.gate = gate
        self.l_aux = None

    def _stacked(self, name: str) -> torch.Tensor:
        return torch.stack([getattr(e, name) for e in self.experts])

    def forward(self, x, key=None):
        from ...parallel.mesh import get_hybrid_mesh
        hm = get_hybrid_mesh()
        ep = hm is not None and hm.ep_degree > 1
        kw = {"dp_axis": hm.group("dp")} if ep and hm.dp_degree > 1 else {}
        # through the gate module, so its policy (GShard's random second
        # expert, Switch's jitter) applies
        dispatch, combine, aux = self.gate(
            x, capacity_factor=self.capacity_factor, key=key, **kw)
        xs = x.reshape(-1, x.shape[-1])
        y = MF.moe_expert_compute(
            xs, dispatch, combine, self._stacked("w_gate"),
            self._stacked("w_up"), self._stacked("w_down"),
            ep_axis="ep" if ep else None)
        self.l_aux = aux
        return y.reshape(x.shape)
