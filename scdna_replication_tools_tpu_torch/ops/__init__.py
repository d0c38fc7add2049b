"""Port of the JAX package's ``ops/`` (see the package docstring)."""
