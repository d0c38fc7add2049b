"""Port of the JAX package's ``data/`` (see the package docstring)."""
