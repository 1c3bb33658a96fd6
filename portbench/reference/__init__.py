"""Plain PyTorch/NumPy reference of what the cells produce. Imports nothing
of the program and nothing of the JAX package."""
