"""Losses and the training loop."""
