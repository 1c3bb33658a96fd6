"""Microbenchmarks of the port's kernels (counterparts of the JAX package's
``benchmarks/`` probes)."""
