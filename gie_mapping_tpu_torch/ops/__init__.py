"""Per-frame operators of the PyTorch port."""
