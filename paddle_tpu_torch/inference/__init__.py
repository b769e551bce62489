"""Inference-side helpers of the PyTorch port."""
