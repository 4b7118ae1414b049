"""Checkpoints, the parameter bridge and WAV I/O."""
