"""Port of the JAX package's ``utils/`` (see the package docstring)."""
