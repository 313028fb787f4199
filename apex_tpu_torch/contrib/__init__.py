"""Counterparts of the JAX package's ``contrib`` modules."""
