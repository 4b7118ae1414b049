"""Models of the port: discriminative BSRNN and the long-form chunker."""
