"""Recurrences, norms and the CUDA kernels behind them."""
