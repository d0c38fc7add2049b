"""Port of the JAX package's ``models/`` (see the package docstring)."""
