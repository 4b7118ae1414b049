"""Plain PyTorch references of the model families the benchmark runs; a
configuration file names its family's module under ``"reference"``."""
