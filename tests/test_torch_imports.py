"""The PyTorch port stands alone: importing it (and chip_smoke.py) loads
neither JAX nor the JAX package, and its entry points refuse to fall
back to the CPU when no device was asked for and CUDA is absent."""
import subprocess
import sys

import pytest
import torch

_PROBE = """
import sys
import chip_smoke
import paddle_tpu_torch
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.ops.kernels import (
    _build, flash_attention, fused_norm_rope, ragged_paged_attention)
from paddle_tpu_torch.ops.fused import fused_softmax_cross_entropy
from paddle_tpu_torch.serving import ServingEngine
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))
print(','.join(bad))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE],
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "", out.stdout


def test_entry_points_raise_without_cuda_or_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the default device is the card")
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import ServingEngine
    cfg = llama.LlamaConfig.tiny()
    calls = [
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: llama.init_params(cfg, torch.Generator()),
        lambda: llama.params_from_jax({}),
        lambda: llama.init_serving_pages(cfg, 4, 4),
        lambda: llama.init_kv_cache(cfg, 1, 8),
        lambda: llama.make_train_step(cfg),
        lambda: llama.make_batch(cfg, 1, 8),
        lambda: ServingEngine({"embed": torch.zeros(1)}, cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
