"""Engine layers of the PyTorch port: the mapper and the per-frame merge."""
