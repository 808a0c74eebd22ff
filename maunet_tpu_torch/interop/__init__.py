"""Checkpoint interop: reference .pth files and JAX variables."""
