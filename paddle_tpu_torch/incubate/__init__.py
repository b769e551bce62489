"""Port of ``paddle_tpu.incubate``: the functional MoE (``moe``)."""
