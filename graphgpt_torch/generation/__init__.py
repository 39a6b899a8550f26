"""generation of the PyTorch port (see the JAX package's module of the same path)."""
