"""Intrusive metrics in numpy and scipy (counterpart of ``metrics/``): PESQ,
STOI/ESTOI, SDR and the text utilities, driven by ``evaluation/intrusive.py``.
Each module is the JAX package's, line for line, with the port's resampler."""
