"""Vision models of the PyTorch port."""
