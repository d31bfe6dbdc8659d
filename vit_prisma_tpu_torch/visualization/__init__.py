"""SAE dashboards of the PyTorch port (numpy copies of the JAX package's)."""
