"""Port of the JAX package's ``infer/`` (see the package docstring)."""
