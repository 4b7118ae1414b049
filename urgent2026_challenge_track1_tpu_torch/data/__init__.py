"""Data pipeline: scp IO, the pre-simulated and dynamic-mixing datasets,
bucketed multi-rate batching and a prefetching loader."""
