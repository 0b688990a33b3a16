"""Wrappers of the hand-written CUDA kernels (csrc/), each beside its plain
PyTorch version.  Importing these modules never builds or loads a kernel."""
