"""Model summary: ``paddle_tpu/hapi/summary.py`` (reference:
python/paddle/hapi/model_summary.py); a parameter is trainable when it
requires a gradient."""
from __future__ import annotations

import numpy as np

__all__ = ["summary"]


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a per-layer parameter table; returns
    {'total_params': N, 'trainable_params': N}."""
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = int(np.prod(tuple(p.shape)))
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    w = max([len(r[0]) for r in rows], default=10) + 2
    print(f"{'Layer (param)':<{w}}{'Shape':<20}{'Param #':>12}")
    print("-" * (w + 32))
    for name, shape, n in rows:
        print(f"{name:<{w}}{str(shape):<20}{n:>12,}")
    print("-" * (w + 32))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    return {"total_params": total, "trainable_params": trainable}
