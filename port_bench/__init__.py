"""Benchmark of the PyTorch/CUDA port on one NVIDIA H100 (see README.md)."""
