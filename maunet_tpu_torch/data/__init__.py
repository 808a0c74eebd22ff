"""Data contracts shared with the JAX package."""
