"""The inference front end of the PyTorch port.

Port of ``paddle_tpu/inference/__init__.py``: ``PlaceType`` (:22),
``Config`` (:29), ``Predictor`` (:68), ``IOHandle`` (:110),
``create_predictor`` (:232), ``get_version`` (:236) and
``GenerationPredictor``, with ``DynamicBatcher`` (``serving``), the
inference passes (``passes``) and the paged KV cache (``paged_kv``).

``Predictor`` runs a program written by ``jit.save`` (``jit.load``) with
named input and output handles, on the ``Config``'s device: ``cuda`` by
default (the JAX package's default is its TPU); ``enable_use_gpu(mb,
device_id)`` selects ``cuda:<device_id>`` and ``disable_gpu()`` the CPU.
A ``Config`` that asks for CUDA where there is none raises when the
predictor is built (``device.resolve_device``); it never runs on the CPU
instead. A program saved on another device is moved to the
``Config``'s, or loading raises. ``enable_memory_optim`` and
``switch_ir_optim`` are accepted and change nothing (the program is run
as it was saved; the passes are applied to the module before
``jit.save``); there is no TensorRT. ``run`` takes numpy arrays (or
tensors), casts each to its input spec's dtype on the device (numpy has
no bfloat16, so a bfloat16 program takes float32 arrays and rounds them
once), and returns numpy arrays, a bfloat16 output widened exactly to
float32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import prng
from ..device import resolve_device
from .serving import _numpy

__all__ = ["PlaceType", "Config", "Predictor", "IOHandle",
           "create_predictor", "get_version", "GenerationPredictor",
           "DynamicBatcher", "fold_batch_norms", "remove_dropouts",
           "fuse_linear_chains"]

class PlaceType:
    CPU = "cpu"
    GPU = "gpu"
    TPU = "tpu"
    XPU = "xpu"


class Config:
    """Reference ``AnalysisConfig`` surface (module docstring)."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        # jit.save writes one "<prefix>.pdmodel" file; either the prefix
        # or the full file name is accepted
        self.model_path = prog_file
        self._device = "cuda"

    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        self.model_path = prog_file

    def model_dir(self) -> Optional[str]:
        return self.model_path

    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0):
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def enable_memory_optim(self, x: bool = True):
        pass  # the caching allocator already reuses freed blocks

    def switch_ir_optim(self, x: bool = True):
        pass  # the passes run on the module before jit.save

    def enable_tensorrt_engine(self, *a, **kw):
        raise NotImplementedError(
            "no TensorRT here: the saved program runs as it is, its "
            "hand-written kernels included")

    def set_cpu_math_library_num_threads(self, n: int):
        torch.set_num_threads(int(n))


class Predictor:
    """Named-handle predictor over a ``jit.save``'d program."""

    def __init__(self, config: Config):
        from .. import jit as _jit
        if config.model_path is None:
            raise ValueError("Config.set_model(path) first")
        self.device = resolve_device(config._device)
        path = config.model_path
        if path.endswith(".pdmodel"):
            path = path[:-len(".pdmodel")]
        self._loaded = _jit.load(path, device=self.device)
        self._n_inputs = self._loaded.num_inputs
        self._dtypes = [_jit.torch_dtype(s.dtype)
                        for s in self._loaded.input_spec]
        self._inputs: Dict[str, np.ndarray] = {}
        self._outputs: List[np.ndarray] = []

    @property
    def program(self):
        """The loaded ``jit.TranslatedLayer``."""
        return self._loaded

    def get_input_names(self) -> List[str]:
        return [f"input_{i}" for i in range(self._n_inputs)]

    def get_input_handle(self, name: str) -> "IOHandle":
        return IOHandle(self._inputs, name)

    def get_output_names(self) -> List[str]:
        return [f"output_{i}" for i in range(len(self._outputs))]

    def get_output_handle(self, name: str) -> "IOHandle":
        idx = int(name.split("_")[-1])
        return IOHandle({"v": self._outputs[idx]}, "v")

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return t.to(device=self.device, dtype=dtype)

    def run(self, inputs: Optional[Sequence] = None) -> List[np.ndarray]:
        if inputs is None:
            inputs = [self._inputs[n] for n in self.get_input_names()]
        if len(inputs) != self._n_inputs:
            raise ValueError(f"the program takes {self._n_inputs} inputs, "
                             f"got {len(inputs)}")
        outs = self._loaded(*[self._tensor(a, d)
                              for a, d in zip(inputs, self._dtypes)])
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        self._outputs = [_numpy(o) for o in outs]
        return self._outputs

    # convenience eager API (paddle.inference's newer run signature)
    def __call__(self, *args):
        return self.run(list(args))


class IOHandle:
    """Input/output tensor handle (reference ``ZeroCopyTensor``)."""

    def __init__(self, store: Dict, key: str):
        self._store = store
        self._key = key

    def copy_from_cpu(self, arr: np.ndarray):
        self._store[self._key] = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        return np.asarray(self._store[self._key])

    def reshape(self, shape):
        self._store[self._key] = self._store[self._key].reshape(shape)

    def shape(self):
        return list(np.asarray(self._store[self._key]).shape)


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


from .passes import (fold_batch_norms, remove_dropouts,  # noqa: E402
                     fuse_linear_chains)
from .serving import DynamicBatcher  # noqa: E402


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def get_version() -> str:
    from .. import __version__
    return __version__
