"""Data pipelines of the port (numpy; bit-equal to the JAX package's)."""
