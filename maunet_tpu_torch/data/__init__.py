"""Datasets, batching and the host-to-device pipeline (numpy copies of the JAX package's)."""
