"""Data pipeline: scp IO, the pre-simulated dataset, bucketed multi-rate
batching and a prefetching loader."""
