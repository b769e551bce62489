"""Port of ``paddle_tpu.incubate``: the MoE (``moe``: the functional
API, ``MoELayer`` and its gates)."""
