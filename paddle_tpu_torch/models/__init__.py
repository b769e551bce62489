"""Models of the PyTorch port: Llama (serving, paged and int8 decode,
training), Qwen2-MoE (training, cached decode, serving) and ResNet
(inference)."""
from . import llama, qwen2_moe
from .llama import LlamaConfig
from .qwen2_moe import Qwen2MoeConfig

__all__ = ["llama", "qwen2_moe", "LlamaConfig", "Qwen2MoeConfig"]
