"""Tensor ops: align-corners resize and the kernel wrappers."""
