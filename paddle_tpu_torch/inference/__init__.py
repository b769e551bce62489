"""Inference-side helpers of the PyTorch port: the paged KV cache
(``paged_kv``) and the offline batched-decode entry point
``GenerationPredictor`` (port of ``paddle_tpu.inference``'s)."""
from __future__ import annotations

import numpy as np

from .. import prng
from ..device import resolve_device

__all__ = ["GenerationPredictor"]


class GenerationPredictor:
    """Autoregressive decoder over Llama params.

        pred = GenerationPredictor(params, cfg, max_len=2048)
        pred.generate(prompt [B, T0], 16)          # dense KV cache
        pred.generate_ragged([p0, p1, ...], 16)    # paged KV cache

    params/cfg: Llama params (``models.llama``, dense or quantized with
    ``quantization.quantize_for_decode``) on ``device`` and their
    config. device: ``cuda`` by default; ``"cpu"`` only when asked.
    PyTorch runs eagerly, so there is no compile cache; prompts are
    still padded to a power-of-two bucket in ``generate_ragged``, as the
    JAX predictor does. ``temperature > 0`` samples (with ``top_p``)
    from ``prng.key(seed)``, the JAX predictor's ``PRNGKey(seed)``."""

    def __init__(self, params, cfg, max_len: int = 2048, device=None):
        from ..models import llama
        self._dev = resolve_device(device)
        if params["embed"].device != self._dev:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the predictor runs on {self._dev}")
        self._params = params
        self._cfg = cfg
        self._max_len = int(max_len)
        self._llama = llama

    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0) -> np.ndarray:
        """Dense-cache decode (``models.llama.generate``): int32 ``[B, T0
        + max_new_tokens]`` (prompt + continuation)."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        prompt = np.asarray(prompt, np.int32)
        if prompt.shape[1] + max_new_tokens > self._max_len:
            raise ValueError(
                f"prompt+continuation {prompt.shape[1] + max_new_tokens} "
                f"exceeds max_len {self._max_len}")
        out = self._llama.generate(self._params, prompt, self._cfg,
                                   max_new_tokens, temperature=temperature,
                                   top_p=top_p, key=prng.key(seed))
        return out.cpu().numpy()

    def generate_ragged(self, prompts, max_new_tokens: int, *,
                        temperature: float = 0.0, top_p: float = 1.0,
                        seed: int = 0, page_size: int = 16):
        """Mixed-length batched decode over the paged KV cache
        (``models.llama.generate_paged``): ``prompts`` is a list of 1-D
        token sequences, right-padded to one power-of-two bucket and
        decoded in one batch whose attention reads only each sequence's
        valid pages. Returns a list of ``[max_new_tokens]`` int32
        continuations."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        lens = [len(p) for p in prompts]
        t0 = max(lens)
        bucket = 1 << max(t0 - 1, 0).bit_length()
        if bucket + max_new_tokens > self._max_len:
            raise ValueError(
                f"prompt bucket {bucket} + continuation {max_new_tokens} "
                f"exceeds max_len {self._max_len}")
        B = len(prompts)
        padded = np.zeros((B, bucket), np.int32)
        for i, p in enumerate(prompts):
            padded[i, :lens[i]] = np.asarray(p, np.int32)
        out = self._llama.generate_paged(
            self._params, padded, np.asarray(lens, np.int32), self._cfg,
            max_new_tokens, page_size=page_size, temperature=temperature,
            top_p=top_p, key=prng.key(seed)).cpu().numpy()
        return [out[i] for i in range(B)]
