"""Checkpoint loading for inference."""
