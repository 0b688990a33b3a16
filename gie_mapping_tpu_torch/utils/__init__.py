"""Configuration, geometry and constants of the PyTorch port."""
