"""Port of the JAX package's ``pipeline/`` (see the package docstring)."""
