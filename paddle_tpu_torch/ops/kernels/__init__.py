"""Hand-written CUDA kernels (csrc/) with their wrappers and plain
PyTorch versions."""
