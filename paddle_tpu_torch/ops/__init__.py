"""Operators of the PyTorch port."""
